"""The OFDM backends: hand-written CUDA kernels for Hopper and their plain
PyTorch versions.

They replace dabmod_tpu/ops/ofdm_kernel.py::build_ofdm_backend with
carrier_map set, the Pallas kernel of the TPU package.  Carrier-order
symbol planes [B, S, C] go in; one composed static gather places each
carrier in its bin (the bin map of ops.ofdm.to_bins_slices composed with
the deferred frequency-interleave permutation) and zeroes the empty bins;
then the unnormalised backward DFT (FFTW_BACKWARD) of size N gives
natural-order time samples [B, S, N].

* `ofdm_backend` (enable_cfr=False; csrc/ofdm_ifft.cu): the transform.
* `ofdm_cfr_backend` (enable_cfr=True; csrc/ofdm_cfr.cu): the transform,
  one crest-factor-reduction iteration (ops.ofdm.cfr_correct) and the
  per-symbol statistics [B, S, 8] in the ST_* lanes of dabmod_tpu.

Each launches its kernel for CUDA tensors, counts the launch in its
`launches` attribute, and takes its plain version only for CPU tensors.
The CUDA sources' headers give each kernel's design and what bounds it on
the card; csrc/fft_core.cuh holds the register-resident FFT core both
kernels run on.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import build
from .fft import fft_planes, ifft_planes
from .ofdm import amp_clip, cfr_correct, f32_square

MAX_CARRIERS = 1536      # the kernel's shared-memory carrier buffer (TM I)
                         # (and at most 3/4 of the spacing, as every mode)
MAX_SPACING = 2048       # the kernel's shared-memory bin buffer (TM I)
MIN_SPACING = 256        # the FFT core's smallest transform (TM III)
THREADS_PER_BLOCK = 128  # csrc/fft_core.cuh kBlockThreads
POINTS = 16              # csrc/fft_core.cuh kPoints: points a thread holds

# per-symbol statistics lanes of ofdm_cfr_backend (dabmod_tpu's ST_*)
ST_NCLIP, ST_NERRCLIP, ST_POW_BEFORE, ST_PEAK_BEFORE, \
    ST_POW_AFTER, ST_PEAK_AFTER, ST_MER_DEN, ST_PAD = range(8)
STATS = 8


def symbols_per_block(n: int) -> int:
    """Symbols one block of the kernels carries at spacing n (the FFT core
    gives each symbol n / POINTS threads)."""
    return THREADS_PER_BLOCK * POINTS // n


def twiddle_angles(n: int) -> np.ndarray:
    """The FFT core's inter-pass twiddle angles in float64, in the order
    the passes read them (csrc/fft_core.cuh): part 1, [16, R0] with R0 =
    n / 256, 2*pi*r*k / (16*R0); then part 2, [16, n / 16], 2*pi*r*t / n."""
    r0, ts = n // 256, n // POINTS
    r = np.arange(POINTS)[:, None]
    part1 = r * np.arange(r0)[None, :] / (POINTS * r0)
    part2 = r * np.arange(ts)[None, :] / n
    return 2.0 * np.pi * np.concatenate([part1.ravel(), part2.ravel()])


@dataclasses.dataclass(frozen=True)
class OfdmTable:
    """The composed carrier->bin gather and the transform constants, on
    one device."""
    n: int                   # transform size (the mode's spacing)
    log2n: int
    n_carriers: int
    src: torch.Tensor        # int32 [n]: carrier feeding bin k (0 if empty)
    valid: torch.Tensor      # float32 [n]: 1 where bin k carries a carrier
    gather: torch.Tensor     # int32 [n]: src, or n_carriers (the kernels'
                             # zero slot) where bin k is empty
    twiddle: torch.Tensor    # float32 [16*n/256 + n, 2]: twiddle_angles(n)
                             # as (cos, sin)


def make_table(bin_src, bin_valid, device) -> OfdmTable:
    """Build the table from a carrier map: bin k takes carrier bin_src[k]
    where bin_valid[k] is set and is zero elsewhere (the modulator passes
    its _bin_src_pre and bin_valid)."""
    bin_src = np.asarray(bin_src)
    valid = np.asarray(bin_valid) != 0
    n = int(bin_src.shape[0])
    log2n = n.bit_length() - 1
    if n != 1 << log2n or not MIN_SPACING <= n <= MAX_SPACING:
        raise ValueError(f"spacing {n}: need a power of two in "
                         f"[{MIN_SPACING}, {MAX_SPACING}]")
    n_carriers = int(np.count_nonzero(valid))
    src = np.where(valid, bin_src, 0).astype(np.int32)
    if n_carriers > min(MAX_CARRIERS, 3 * n // 4) or np.any(src < 0) \
            or np.any(src >= n_carriers):
        raise ValueError("carrier map sources must lie in [0, carriers) "
                         f"with at most {MAX_CARRIERS} carriers and 3/4 "
                         "of the spacing (the DAB modes' share; the CFR "
                         "kernel's carrier buffer)")
    gather = np.where(valid, src, n_carriers).astype(np.int32)
    ang = twiddle_angles(n)
    twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return OfdmTable(
        n, log2n, n_carriers,
        torch.as_tensor(src, device=device),
        torch.as_tensor(valid.astype(np.float32), device=device),
        torch.as_tensor(gather, device=device),
        torch.as_tensor(twiddle, device=device))


def gather_bins(planes, table: OfdmTable):
    """Carrier-order planes [B, S, C] -> natural-order bins [B, S, N]
    (index_select x mask)."""
    return tuple(x.index_select(-1, table.src) * table.valid for x in planes)


def ofdm_backend_plain(planes, table: OfdmTable):
    """Plain PyTorch version: gather_bins, then torch.fft.ifft with
    norm="forward" (no 1/N: FFTW_BACKWARD)."""
    return ifft_planes(gather_bins(planes, table))


def _pabs2(x):
    return x[0] * x[0] + x[1] * x[1]


def ofdm_cfr_backend_plain(planes, table: OfdmTable, clip: float,
                           error_clip: float):
    """Plain PyTorch version of ofdm_cfr_backend: gather_bins, the
    transform, ops.ofdm.cfr_correct, and the ST_* reductions per symbol."""
    bins = gather_bins(planes, table)
    x = ifft_planes(bins)
    out, over, over_e = cfr_correct(x, bins, clip, error_clip)
    pow_before = _pabs2(x)
    pow_after = _pabs2(out)
    f32 = torch.float32
    stats = torch.stack([
        over.sum(dim=-1, dtype=f32),
        over_e.sum(dim=-1, dtype=f32),
        pow_before.sum(dim=-1),
        pow_before.amax(dim=-1),
        pow_after.sum(dim=-1),
        pow_after.amax(dim=-1),
        _pabs2((out[0] - x[0], out[1] - x[1])).sum(dim=-1),
        torch.zeros_like(pow_before[..., 0]),
    ], dim=-1)
    return out, stats


def cfr_threshold_margin(planes, table: OfdmTable, clip: float,
                         error_clip: float, rel: float = 1e-5):
    """How many samples of the plain CFR sit at a threshold: int32
    [B, S, 2], per symbol the samples whose |x|^2 lies within `rel`
    (relative) of clip^2 and the bins whose |e|^2 lies within `rel` of
    error_clip^2.  Two fp32 computations of the same symbol that sum in
    other orders may decide those samples differently, so their clip
    counts may differ by up to this many."""
    bins = gather_bins(planes, table)
    x = ifft_planes(bins)
    clipped, _ = amp_clip(x, clip)
    sr, si = fft_planes(clipped)
    n = table.n
    err = (bins[0] - sr * (1.0 / n), bins[1] - si * (1.0 / n))

    def near(v, limit):
        lim2 = f32_square(limit)
        return ((_pabs2(v) - lim2).abs() <= rel * lim2).sum(dim=-1)
    near_clip, near_err = near(x, clip), near(err, error_clip)
    return torch.stack([near_clip, near_err], dim=-1).to(torch.int32)


def _check_planes(planes, table: OfdmTable):
    """The checks both wrappers make; True when the planes lie on the
    CPU (take the plain version)."""
    re, im = planes
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"expected two [B, S, C] planes, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"expected float32 planes, got {re.dtype}, {im.dtype}")
    if re.shape[-1] != table.n_carriers:
        raise ValueError(f"{re.shape[-1]} carriers, table has "
                         f"{table.n_carriers}")
    if not (re.device == im.device == table.src.device):
        raise ValueError(f"planes on {re.device}/{im.device}, table on "
                         f"{table.src.device}")
    if re.device.type == "cpu":
        return True
    if re.device.type != "cuda":
        raise ValueError(f"unsupported device {re.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("planes must be contiguous")
    return False


@functools.cache
def _launcher():
    return build.launcher("ofdm_ifft", "dabmod_ofdm_ifft", 6,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int)


@functools.cache
def _cfr_launcher():
    return build.launcher("ofdm_cfr", "dabmod_ofdm_cfr", 7,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float)


def launch_shape(n: int, cfr: bool = False) -> dict:
    """The launch shape of K1's instance at spacing n (K2's with cfr) on
    the current CUDA device, as its source reports it: threads and symbols
    a block, and resident blocks an SM by the CUDA runtime's occupancy
    calculator.  Builds the kernel's library if needed."""
    name = "ofdm_cfr" if cfr else "ofdm_ifft"
    threads, spb, blocks = build.query(name, f"dabmod_{name}_shape", 3,
                                       n.bit_length() - 1)
    return {"threads_per_block": threads, "symbols_per_block": spb,
            "resident_blocks_per_sm": blocks}


def ofdm_backend(planes, table: OfdmTable):
    """Carrier-order planes [B, S, C] -> time-domain planes [B, S, N].

    CUDA tensors launch the kernel (and count the launch in
    `ofdm_backend.launches`); CPU tensors take ofdm_backend_plain."""
    if _check_planes(planes, table):
        return ofdm_backend_plain(planes, table)
    re, im = planes
    B, S, C = re.shape
    out_r = torch.empty((B, S, table.n), dtype=torch.float32,
                        device=re.device)
    out_i = torch.empty_like(out_r)
    if B * S == 0:
        return out_r, out_i
    launch = _launcher()
    with torch.cuda.device(re.device):
        err = launch(re.data_ptr(), im.data_ptr(), table.gather.data_ptr(),
                     table.twiddle.data_ptr(), out_r.data_ptr(),
                     out_i.data_ptr(), B * S, C,
                     table.log2n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ofdm_ifft kernel launch failed: CUDA error {err}")
    ofdm_backend.launches += 1
    return out_r, out_i


ofdm_backend.launches = 0


def ofdm_cfr_backend(planes, table: OfdmTable, clip: float,
                     error_clip: float):
    """Carrier-order planes [B, S, C] -> (time-domain planes [B, S, N]
    after one CFR iteration, statistics float32 [B, S, STATS]).

    CUDA tensors launch the kernel (and count the launch in
    `ofdm_cfr_backend.launches`); CPU tensors take ofdm_cfr_backend_plain.
    The thresholds reach the kernel as clip**2 and error_clip**2 rounded
    to float32, the values dabmod_tpu compares with."""
    if _check_planes(planes, table):
        return ofdm_cfr_backend_plain(planes, table, clip, error_clip)
    re, im = planes
    B, S, C = re.shape
    out_r = torch.empty((B, S, table.n), dtype=torch.float32,
                        device=re.device)
    out_i = torch.empty_like(out_r)
    stats = torch.empty((B, S, STATS), dtype=torch.float32, device=re.device)
    if B * S == 0:
        return (out_r, out_i), stats
    launch = _cfr_launcher()
    with torch.cuda.device(re.device):
        err = launch(re.data_ptr(), im.data_ptr(), table.gather.data_ptr(),
                     table.twiddle.data_ptr(), out_r.data_ptr(),
                     out_i.data_ptr(), stats.data_ptr(),
                     B * S, C, table.log2n, f32_square(clip),
                     f32_square(error_clip),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ofdm_cfr kernel launch failed: CUDA error {err}")
    ofdm_cfr_backend.launches += 1
    return (out_r, out_i), stats


ofdm_cfr_backend.launches = 0
