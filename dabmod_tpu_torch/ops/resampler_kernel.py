"""The polyphase resampler backend: a hand-written CUDA kernel for Hopper
(csrc/resample_poly.cu) and its plain PyTorch version.

It replaces dabmod_tpu/ops/resampler_kernel.py::build_resampler_backend,
the Pallas kernel for a PolyphasePlan with 128-sample frames.  Flat (re, im)
sample planes [n] and a carry of the 2*half input samples before them go
in; the resampled planes [n*L/M] and the new carry come out.  The output
is the stream of ops.filters.resample_poly with the same plan (the plain
version), delayed by `half` input samples; dabmod_tpu's kernel returns the
same stream as [n/128, 128*L/M] rows.

The kernel computes each output from the band of the plan's operator
only: `make_table` extracts, for each output phase, the first non-zero row
of its column and the taps from there (`compact_taps`), and checks that
they rebuild every entry of plan.matrix bit for bit.  Its arithmetic is
fp32; dabmod_tpu's bf16 hi/lo split (an emulation of Precision.HIGH for
the TPU's matrix unit) is not carried over.

The source builds one kernel instance per (M, KP, R) of INSTANCES: M = 1
and 2 at compile time (every rate chip_smoke.py checks in phase 2), any
other M at run time.  `make_table` picks the instance (`pick_instance`),
pads the taps for it (`kernel_taps`) and cuts the stream into chunks with
a shared-memory carve-up whose accesses it checks against a model of the
32 banks (`choose_layout`); tests/resampler_model.py transcribes the
kernel's index arithmetic onto that layout.

`resample` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import build
from .filters import FRAME, PolyphasePlan, resample_poly

THREADS = 256               # a block: 8 warps
WARPS = THREADS // 32
BANKS = 32                  # shared-memory banks of 4 bytes
# The kernel's instances (compile-time M, or 0 for any M; KP, the band
# padded with zero taps; R, output groups a lane), in the order of
# kInstances in csrc/resample_poly.cu.
INSTANCES = ((1, 34, 8), (2, 35, 8), (2, 65, 4),
             (0, 40, 1), (0, 72, 1), (0, 132, 1))
RUNTIME_TILES = (4, 2, 1)   # tiles an item may take with run-time M
SMEM_TARGET = 75 * 1024     # a block's shared memory where choice is left:
                            # three blocks, and the 1 KB the runtime keeps
                            # for each, fit an SM's 228 KB
SMEM_LIMIT = 232448         # the most a block may have on sm_90 (227 KB)


def supports(plan: PolyphasePlan) -> bool:
    """True when `plan` has dabmod_tpu's kernel framing (128-sample frames,
    a carry no longer than a frame)."""
    return plan.block == FRAME and 2 * plan.half <= FRAME


def compact_taps(plan: PolyphasePlan):
    """The band of plan.matrix per output phase p < L: (row0 int32 [L],
    taps float32 [L, K]), where column q*L + p of the operator holds
    taps[p] from row q*M + row0[p] down.  Raises ValueError unless they
    rebuild plan.matrix exactly (expand_taps)."""
    T = plan.matrix
    spans = []
    for p in range(plan.L):
        nz = np.flatnonzero(T[:, p])
        if nz.size == 0:
            raise ValueError(f"operator column {p} is all zero")
        spans.append((int(nz[0]), int(nz[-1])))
    K = max(b - a + 1 for a, b in spans)
    row0 = np.array([a for a, _ in spans], np.int32)
    taps = np.zeros((plan.L, K), np.float32)
    for p, (a, b) in enumerate(spans):
        taps[p, :b - a + 1] = T[a:b + 1, p]
    if not np.array_equal(expand_taps(row0, taps, plan), T):
        raise ValueError("the per-phase taps do not rebuild plan.matrix")
    return row0, taps


def expand_taps(row0, taps, plan: PolyphasePlan) -> np.ndarray:
    """The dense operator [block + 2*half, out_block] that (row0, taps)
    describe; a non-zero tap beyond the frame raises ValueError."""
    F = plan.block + 2 * plan.half
    K = taps.shape[1]
    dense = np.zeros((F, plan.out_block), np.float32)
    for j in range(plan.out_block):
        q, p = divmod(j, plan.L)
        r = q * plan.M + int(row0[p])
        inside = min(K, F - r)
        if np.any(taps[p, inside:] != 0):
            raise ValueError(f"column {j}: taps reach beyond the frame")
        dense[r:r + inside, j] = taps[p, :inside]
    return dense


def pick_instance(M: int, K: int, row0_max: int) -> int:
    """The kernel instance for a band of K taps starting at rows up to
    row0_max, at input step M: the compile-time M, where one holds the
    band aligned to row 0 (row0_max + K taps), else run-time M."""
    for i, (mt, kp, _) in enumerate(INSTANCES):
        if mt == M and row0_max + K <= kp:
            return i
    for i, (mt, kp, _) in enumerate(INSTANCES):
        if mt == 0 and K <= kp:
            return i
    raise ValueError(f"no kernel instance holds {K} taps")


def bank_wavefronts(addr: np.ndarray) -> np.ndarray:
    """Shared-memory wavefronts of each warp access in `addr` ([n, 32]
    word addresses, -1 for an idle lane; the addresses of an access are
    distinct): the most lanes that hit one bank."""
    addr = np.asarray(addr)
    rows = np.broadcast_to(np.arange(addr.shape[0])[:, None], addr.shape)
    live = addr >= 0
    hits = np.bincount(rows[live] * BANKS + addr[live] % BANKS,
                       minlength=addr.shape[0] * BANKS)
    return hits.reshape(-1, BANKS).max(axis=1)


def swizzle(q):
    """The column of output group q in its phase's row of the staged
    output (swz in csrc/resample_poly.cu)."""
    return q ^ ((q >> 5) & 7)


def readout_addresses(L: int, q_per_chunk: int, out_row: int):
    """The staged-output words behind a block's 16-byte stores: for each
    run of 128 outputs (one warp) and each of the four floats a lane
    stores, output o = q*L + p is read at p*out_row + swizzle(q);
    [n, 32]."""
    n = q_per_chunk * L
    o = (np.arange(0, n, 128)[:, None, None] + 4 * np.arange(32)[None, None]
         + np.arange(4)[None, :, None]).reshape(-1, 32)
    q, p = o // L, o % L
    addr = p * out_row + swizzle(q)
    return np.where(o < n, addr, -1)


def staging_addresses(M: int, span: int, in_row: int):
    """Run-time M: where each warp's 32 consecutive run samples are staged,
    row t % M, column t // M; [n, 32]."""
    t = np.arange(0, span + 31, 32)[:, None] + np.arange(32)[None]
    t = t[: -(-span // 32)]
    return np.where(t < span, (t % M) * in_row + t // M, -1)


def _least_conflicts(lo: int, addresses) -> int:
    """The row length in [lo, lo + 32) whose accesses take the fewest
    wavefronts (the shortest of equals)."""
    costs = [int(bank_wavefronts(addresses(lo + d)).sum())
             for d in range(BANKS)]
    return lo + int(np.argmin(costs))


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """How the kernel cuts the stream for one plan into chunks, which one
    wave of persistent blocks walks over, and a block's shared memory (all
    sizes in floats unless named bytes)."""
    instance: int            # index into INSTANCES
    groups: int              # work items a phase: L * groups over 8 warps
    tiles: int               # tiles of 32 * R output groups an item
    q_per_chunk: int         # output groups of L a chunk: 32*R*tiles*groups
    span: int                # input samples a chunk stages
    in_row: int              # run-time M: row length of the staged run
    in_len: int              # staged floats a plane
    out_row: int             # staged outputs a phase (>= q_per_chunk)
    smem_bytes: int          # 4 * (4 * in_len + 2 * L * out_row): two
                             # buffers of the staged run, both planes


def block_layout(L: int, M: int, K: int, row0_max: int, instance: int,
                 groups: int, tiles: int) -> BlockLayout:
    mt, kp, R = INSTANCES[instance]
    qb = 32 * R * tiles * groups
    if mt:
        # the aligned window of every output; one pad word after each R*M
        span = qb * M - M + kp
        in_row = 0
        in_len = span + (span - 1) // (R * M)
    else:
        span = (qb - 1) * M + row0_max + K
        in_row = _least_conflicts(-(-span // M), lambda row: (
            staging_addresses(M, span, row)))
        in_len = M * in_row
    out_row = _least_conflicts(qb, lambda row: readout_addresses(L, qb, row))
    return BlockLayout(instance, groups, tiles, qb, span, in_row, in_len,
                       out_row, 4 * (4 * in_len + 2 * L * out_row))


def choose_layout(L: int, M: int, K: int, row0_max: int) -> BlockLayout:
    """The block layout for a plan: the kernel instance, then the work
    items that spread most evenly over the 8 warps within SMEM_TARGET
    (more tiles an item first: the taps are loaded once an item, then
    fewer groups: smaller blocks); if none fits, the smallest block."""
    inst = pick_instance(M, K, row0_max)
    tiles_options = RUNTIME_TILES if INSTANCES[inst][0] == 0 else (1,)

    def preference(shape):
        tiles, groups = shape
        items = L * groups
        return (items / (WARPS * -(-items // WARPS)), tiles, -groups)
    shapes = sorted(((t, g) for t in tiles_options
                     for g in range(1, WARPS + 1)), key=preference,
                    reverse=True)
    R = INSTANCES[inst][2]
    for tiles, groups in shapes:
        if 8 * L * 32 * R * tiles * groups > SMEM_TARGET:
            continue            # the staged outputs alone do not fit
        lay = block_layout(L, M, K, row0_max, inst, groups, tiles)
        if lay.smem_bytes <= SMEM_TARGET:
            return lay
    lay = block_layout(L, M, K, row0_max, inst, 1, min(tiles_options))
    if lay.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"L={L}, M={M}, K={K}: a block needs "
                         f"{lay.smem_bytes} bytes of shared memory, more "
                         f"than the {SMEM_LIMIT} a block may have")
    return lay


def kernel_taps(row0, taps, instance: int) -> np.ndarray:
    """The kernel's tap table [L, KP]: with compile-time M each band moved
    down by row0[p] (every phase then reads the same window), with
    run-time M the band as it is; zeros elsewhere."""
    mt, kp, _ = INSTANCES[instance]
    L, K = taps.shape
    out = np.zeros((L, kp), np.float32)
    for p in range(L):
        s = int(row0[p]) if mt else 0
        out[p, s:s + K] = taps[p]
    return out


@dataclasses.dataclass(frozen=True)
class ResamplerTable:
    """A plan and its kernel table, on one device."""
    plan: PolyphasePlan
    n_taps: int              # K, the band's width
    row0: torch.Tensor       # int32 [L]
    taps: torch.Tensor       # float32 [L, K], the band (compact_taps)
    kernel_taps: torch.Tensor  # float32 [L, KP] (kernel_taps)
    matrix: torch.Tensor     # float32 plan.matrix (the plain version's)
    layout: BlockLayout


def make_table(plan: PolyphasePlan, device) -> ResamplerTable:
    if not supports(plan):
        raise ValueError(f"plan with block {plan.block} and half "
                         f"{plan.half}: the kernel takes 128-sample frames "
                         f"and 2*half <= 128")
    row0, taps = compact_taps(plan)
    L, K = taps.shape
    layout = choose_layout(L, plan.M, K, int(row0.max()))
    return ResamplerTable(
        plan, K, torch.as_tensor(row0, device=device),
        torch.as_tensor(taps, device=device),
        torch.as_tensor(kernel_taps(row0, taps, layout.instance),
                        device=device),
        torch.as_tensor(plan.matrix, device=device), layout)


def resample_plain(planes, carry, table: ResamplerTable):
    """Plain PyTorch version: the framed product of
    ops.filters.resample_poly with the plan's dense operator."""
    return resample_poly(planes, table.plan, carry, matrix=table.matrix)


@functools.cache
def _launcher():
    return build.launcher("resample_poly", "dabmod_resample_poly", 8,
                          ctypes.c_longlong, *[ctypes.c_int] * 14)


def launch_shape(table: ResamplerTable) -> dict:
    """The kernel's launch shape for `table` on the current CUDA device, as
    its source reports it: the instance it builds at table.layout.instance
    (compile-time M or 0, KP, R), threads a block, the dynamic shared
    memory it launches with, and resident blocks an SM by the CUDA
    runtime's occupancy calculator.  Builds the kernel's library if
    needed."""
    lay = table.layout
    threads, mt, kp, r, blocks = build.query(
        "resample_poly", "dabmod_resample_poly_shape", 5, lay.instance,
        lay.smem_bytes)
    return {"instance": [mt, kp, r], "threads_per_block": threads,
            "dynamic_smem_bytes": lay.smem_bytes,
            "resident_blocks_per_sm": blocks}


def _launch(planes, carry, table: ResamplerTable, out_r, out_i):
    """Launch the kernel into out_r, out_i ([n*L/M] float32 on the planes'
    card): it stores four outputs at a time, so each must be 16-byte
    aligned."""
    if any(t.data_ptr() % 16 for t in (out_r, out_i)):
        raise ValueError("the kernel's outputs must be 16-byte aligned")
    plan, lay = table.plan, table.layout
    re, im = planes
    launch = _launcher()
    with torch.cuda.device(re.device):
        err = launch(re.data_ptr(), im.data_ptr(), carry[0].data_ptr(),
                     carry[1].data_ptr(), table.row0.data_ptr(),
                     table.kernel_taps.data_ptr(), out_r.data_ptr(),
                     out_i.data_ptr(), re.shape[0], lay.instance,
                     2 * plan.half, plan.L, plan.M,
                     plan.M.bit_length() - 1, table.n_taps, lay.q_per_chunk,
                     lay.groups, lay.tiles, lay.span, lay.in_row,
                     lay.in_len, lay.out_row, lay.smem_bytes,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"resample_poly kernel launch failed: CUDA error {err}")
    resample.launches += 1


def resample(planes, carry, table: ResamplerTable):
    """Flat planes [n] (n a multiple of 128) and carry planes [2*half] ->
    (resampled planes [n*L/M], new carry planes [2*half]).

    CUDA tensors launch the kernel (and count the launch in
    `resample.launches`); CPU tensors take resample_plain."""
    plan = table.plan
    h2 = 2 * plan.half
    tensors = (*planes, *carry)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("expected float32 planes and carry")
    re, im = planes
    if re.dim() != 1 or re.shape != im.shape or re.shape[0] % plan.block:
        raise ValueError(f"expected two flat planes of a multiple of "
                         f"{plan.block} samples, got {tuple(re.shape)} and "
                         f"{tuple(im.shape)}")
    if any(c.shape != (h2,) for c in carry):
        raise ValueError(f"expected two carry planes of {h2} samples")
    if any(t.device != table.taps.device for t in tensors):
        raise ValueError(f"planes and carry must lie on {table.taps.device}")
    if re.device.type == "cpu":
        return resample_plain(planes, carry, table)
    if re.device.type != "cuda":
        raise ValueError(f"unsupported device {re.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("planes and carry must be contiguous")

    n = re.shape[0]
    n_out = n * plan.L // plan.M
    out_r = torch.empty(n_out, dtype=torch.float32, device=re.device)
    out_i = torch.empty_like(out_r)
    if n == 0:
        return (out_r, out_i), carry
    _launch(planes, carry, table, out_r, out_i)
    # xp[-2*half:] of xp = concat(carry, x): n >= 128 >= 2*half here
    return (out_r, out_i), (re[-h2:].clone(), im[-h2:].clone())


resample.launches = 0
