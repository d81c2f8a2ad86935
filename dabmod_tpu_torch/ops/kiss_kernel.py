"""The KISS fixed-point inverse transform: a hand-written CUDA kernel for
Hopper (K4, csrc/kiss_ifft.cu) and its plain PyTorch version.

fft_engine=kiss runs the reference's KISS FFT built with FIXED_POINT=16
(ops/kiss_fixed.py has its arithmetic).  The TPU package runs it as int32
XLA ops and has no Pallas kernel for it: K4 replaces a chain of some 1,400
int32 torch ops a step on the card.  Carrier planes [B, S, C] go in as the
step makes them (float32, interleaver-input order, NULL symbol first); one
composed static gather places each carrier in KISS's input order (K1's
carrier->bin table, ofdm_kernel.OfdmTable, composed with the permutation
of kf_work's recursion); each carrier becomes Q1.14, rint(x * 16384)
rounding half to even; then the butterfly stages in kf_work's order
(kiss_fixed.butterflies) give the exact int16 time samples.

* `kiss_ifft(planes, table, wire=True)`: the TF's packed s16 wire words
  [B, tf_samples], each symbol's cyclic prefix written by the kernel (the
  guard interval with no window overlap).
* `kiss_ifft(planes, table, wire=False)`: int32 planes [B, S, N] of the
  time samples, for the Q1.14 windowed guard interval
  (kiss_fixed.guard_interval_windowed_fixed).

CUDA tensors launch the kernel (and count the launch in
`kiss_ifft.launches`); CPU tensors take kiss_ifft_plain.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import build, kiss_fixed
from .ofdm import guard_interval_unwindowed
from .ofdm_kernel import OfdmTable

THREADS_PER_BLOCK = 256     # csrc/kiss_ifft.cu kThreads
POINTS = 8                  # csrc/kiss_ifft.cu kPoints: points a thread holds


def symbols_per_block(n: int) -> int:
    """Symbols one block of K4 carries at size n (n / POINTS threads a
    symbol)."""
    return THREADS_PER_BLOCK * POINTS // n


@dataclasses.dataclass(frozen=True)
class KissTable:
    """K4's composed gather, twiddles and guard-interval sizes, on one
    device."""
    n: int                   # transform size (the mode's spacing)
    log2n: int
    n_carriers: int
    null_size: int           # samples of the NULL symbol with its prefix
    sym_size: int            # samples of a data symbol with its prefix
    gather: torch.Tensor     # int32 [n]: the carrier feeding KISS input j,
                             # n_carriers (a zero) where its bin is empty
    twiddle: torch.Tensor    # int32 [n, 2]: kiss_fixed.twiddles(n, True)


def make_table(ofdm_table: OfdmTable, null_size: int,
               sym_size: int) -> KissTable:
    """K4's table from the modulator's K1 table, on its device: K1's
    carrier->bin gather composed with KISS's input permutation (entry j is
    the gather of bin perm[j])."""
    n = ofdm_table.n
    factors = kiss_fixed.kf_factor(n)
    if any(p not in (2, 4) for p, _ in factors):
        raise ValueError(f"size {n}: K4 takes radices 2 and 4 only")
    if ofdm_table.n_carriers % 4:
        raise ValueError(f"{ofdm_table.n_carriers} carriers: K4 loads them "
                         "four at a time")
    prefixes = (null_size - n, sym_size - n)
    if not all(0 <= x <= n for x in prefixes):
        raise ValueError(f"cyclic prefixes {prefixes}: need 0..{n}")
    dev = ofdm_table.gather.device
    perm = kiss_fixed._build_perm(n, factors)
    gather = ofdm_table.gather.cpu().numpy()[perm].astype(np.int32)
    return KissTable(
        n, ofdm_table.log2n, ofdm_table.n_carriers, null_size, sym_size,
        torch.as_tensor(gather, device=dev),
        torch.as_tensor(kiss_fixed.twiddles(n, True), device=dev))


def kiss_ifft_plain(planes, table: KissTable, wire: bool = True):
    """Plain PyTorch version of kiss_ifft: Q1.14 carriers, the composed
    gather (a zero appended for the empty bins), kiss_fixed.butterflies
    and, with wire, the cyclic prefix and the packed words."""
    def gathered(x):
        q = torch.round(x * 16384.0).to(torch.int32)
        q = torch.cat([q, q.new_zeros((*q.shape[:-1], 1))], dim=-1)
        return q.index_select(-1, table.gather)
    stages = kiss_fixed._plan(table.n, True, planes[0].device)[1]
    td = kiss_fixed.butterflies(*(gathered(x) for x in planes), stages)
    if not wire:
        return td
    return kiss_fixed.pack_words(*guard_interval_unwindowed(
        td, table.null_size, table.sym_size))


def _check_planes(planes, table: KissTable) -> bool:
    """True when the planes lie on the CPU (take the plain version)."""
    re, im = planes
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(f"expected two [B, S, C] planes, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"expected float32 planes, got {re.dtype}, {im.dtype}")
    if re.shape[-1] != table.n_carriers:
        raise ValueError(f"{re.shape[-1]} carriers, table has "
                         f"{table.n_carriers}")
    if not (re.device == im.device == table.gather.device):
        raise ValueError(f"planes on {re.device}/{im.device}, table on "
                         f"{table.gather.device}")
    if re.device.type == "cpu":
        return True
    if re.device.type != "cuda":
        raise ValueError(f"unsupported device {re.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("planes must be contiguous")
    return False


@functools.cache
def _launcher():
    return build.launcher("kiss_ifft", "dabmod_kiss_ifft", 7,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int)


def launch_shape(n: int) -> dict:
    """K4's launch shape at size n on the current CUDA device, as its source
    reports it: threads and symbols a block, and resident blocks an SM by
    the CUDA runtime's occupancy calculator.  Builds the library if
    needed."""
    threads, spb, blocks = build.query("kiss_ifft", "dabmod_kiss_ifft_shape",
                                       3, n.bit_length() - 1)
    return {"threads_per_block": threads, "symbols_per_block": spb,
            "resident_blocks_per_sm": blocks}


def kiss_ifft(planes, table: KissTable, wire: bool = True):
    """Carrier planes [B, S, C] -> packed s16 wire words [B, tf_samples]
    (wire) or int32 time-sample planes [B, S, N] (not wire).

    CUDA tensors launch K4 (and count the launch in `kiss_ifft.launches`);
    CPU tensors take kiss_ifft_plain."""
    if _check_planes(planes, table):
        return kiss_ifft_plain(planes, table, wire)
    re, im = planes
    B, S, C = re.shape
    if wire:
        words = torch.empty(
            (B, table.null_size + (S - 1) * table.sym_size if S else 0),
            dtype=torch.int32, device=re.device)
        out, ptrs = words, (words.data_ptr(), 0, 0)
    else:
        yr = torch.empty((B, S, table.n), dtype=torch.int32,
                         device=re.device)
        yi = torch.empty_like(yr)
        out, ptrs = (yr, yi), (0, yr.data_ptr(), yi.data_ptr())
    if B * S == 0:
        return out
    if B * S >= 2**31:
        raise ValueError(f"{B * S} symbols: K4 takes fewer than 2**31")
    launch = _launcher()
    with torch.cuda.device(re.device):
        err = launch(re.data_ptr(), im.data_ptr(), table.gather.data_ptr(),
                     table.twiddle.data_ptr(), *ptrs, B * S, C, S,
                     table.null_size, table.sym_size, table.log2n,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kiss_ifft kernel launch failed: CUDA error {err}")
    kiss_ifft.launches += 1
    return out


kiss_ifft.launches = 0
