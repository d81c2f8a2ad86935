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

OUT_PER_BLOCK = 1024        # outputs per thread block, about
SMEM_LIMIT = 48 * 1024      # static-size launch, no attribute needed


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


@dataclasses.dataclass(frozen=True)
class ResamplerTable:
    """A plan and its kernel table, on one device."""
    plan: PolyphasePlan
    n_taps: int              # K, the band's width
    row0: torch.Tensor       # int32 [L]
    taps: torch.Tensor       # float32 [L, K]
    matrix: torch.Tensor     # float32 plan.matrix (the plain version's)
    q_per_block: int         # output groups of L per thread block
    span: int                # input samples a block stages
    smem_bytes: int          # a block's dynamic shared memory: taps [L*K],
                             # row0 [L], the staged run [2, span], 4 B each


def make_table(plan: PolyphasePlan, device) -> ResamplerTable:
    if not supports(plan):
        raise ValueError(f"plan with block {plan.block} and half "
                         f"{plan.half}: the kernel takes 128-sample frames "
                         f"and 2*half <= 128")
    row0, taps = compact_taps(plan)
    L, K = taps.shape
    q_per_block = max(1, OUT_PER_BLOCK // L)
    span = (q_per_block - 1) * plan.M + int(row0.max()) + K
    smem_bytes = 4 * (L * K + L + 2 * span)
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(f"L={L}, K={K}: the kernel's tables exceed "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return ResamplerTable(
        plan, K, torch.as_tensor(row0, device=device),
        torch.as_tensor(taps, device=device),
        torch.as_tensor(plan.matrix, device=device), q_per_block, span,
        smem_bytes)


def resample_plain(planes, carry, table: ResamplerTable):
    """Plain PyTorch version: the framed product of
    ops.filters.resample_poly with the plan's dense operator."""
    return resample_poly(planes, table.plan, carry, matrix=table.matrix)


@functools.cache
def _launcher():
    return build.launcher("resample_poly", "dabmod_resample_poly", 8,
                          ctypes.c_longlong, *[ctypes.c_int] * 7)


def launch_shape(table: ResamplerTable) -> dict:
    """The kernel's launch shape for `table` on the current CUDA device, as
    its source reports it: threads a block, the dynamic shared memory it
    launches with, and resident blocks an SM by the CUDA runtime's
    occupancy calculator.  Builds the kernel's library if needed."""
    threads, blocks = build.query("resample_poly",
                                  "dabmod_resample_poly_shape", 2,
                                  table.smem_bytes)
    return {"threads_per_block": threads,
            "dynamic_smem_bytes": table.smem_bytes,
            "resident_blocks_per_sm": blocks}


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
    launch = _launcher()
    with torch.cuda.device(re.device):
        err = launch(re.data_ptr(), im.data_ptr(), carry[0].data_ptr(),
                     carry[1].data_ptr(), table.row0.data_ptr(),
                     table.taps.data_ptr(), out_r.data_ptr(),
                     out_i.data_ptr(), n, h2, plan.L, plan.M, table.n_taps,
                     table.q_per_block, table.span, table.smem_bytes,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"resample_poly kernel launch failed: CUDA error {err}")
    resample.launches += 1
    # xp[-2*half:] of xp = concat(carry, x): n >= 128 >= 2*half here
    return (out_r, out_i), (re[-h2:].clone(), im[-h2:].clone())


resample.launches = 0
