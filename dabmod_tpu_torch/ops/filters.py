"""Post-OFDM stages on tensors (port of parts of dabmod_tpu/ops/filters.py):
the polyphase resampler's plan and plain form, s16 wire-format conversion
and PAPR statistics.

The float->int conversion saturates to the int16 range, counts the samples
it clipped, and truncates toward zero like the reference's C casts
(`Tensor.to(torch.int32)` truncates, as `jnp.trunc(...).astype` does).
The u8/s8 formats, the FIR, DPD, the CIC equalizer and the frequency-domain
resampler are queued in ROADMAP.md (A7, A8).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Polyphase resampler (dabmod_tpu/ops/filters.py:220-313; the same role as
# the reference's src/Resampler.cpp).  A windowed-sinc polyphase
# interpolator as one banded operator on framed input:
#
#   frames [nb, block + 2*half] @ T [block + 2*half, block*L/M]
#
# where T[c, j] = h_up[j*M - (c - half)*L].  The only sequential state is a
# 2*half-sample input carry; output lags input by exactly `half` input
# samples.  The hand-written kernel (ops/resampler_kernel.py) computes the
# same stream from the operator's band.
# ---------------------------------------------------------------------------


ATTEN_DB = 120.0            # stopband attenuation of the prototype
FRAME = 128                 # input samples per frame (the kernel's framing)


@dataclasses.dataclass(frozen=True)
class PolyphasePlan:
    L: int
    M: int
    half: int               # half-support in input samples
    block: int              # input samples per frame
    out_block: int          # block * L // M
    matrix: np.ndarray      # banded operator [block + 2*half, out_block]

    @classmethod
    def create(cls, input_rate: int, output_rate: int):
        """The Kaiser-windowed design of dabmod_tpu's PolyphasePlan.create
        with 128-sample frames, step for step, so the operator is the same
        to the bit."""
        g =int(np.gcd(input_rate, output_rate))
        L = output_rate // g
        M = input_rate // g
        # make the block a multiple of M so out_block is integral (the
        # kernel refuses a plan whose block grew past FRAME)
        block = ((FRAME + M - 1) // M) * M
        cut = min(1.0, L / M)          # passband edge, input-Nyquist units
        # transition band +/- cut/4 around the cutoff: the DAB spectrum
        # stops at 0.75 of the input Nyquist
        d_omega = 0.5 * cut * np.pi / L   # transition width, upsampled domain
        n_total = int(np.ceil((ATTEN_DB - 7.95) / (2.285 * d_omega)))
        half = int(np.ceil(n_total / (2 * L)))
        beta = 0.1102 * (ATTEN_DB - 8.7)
        t = np.arange(-half * L, half * L + 1, dtype=np.float64)
        proto = cut * np.sinc(cut * t / L)
        proto *= np.i0(beta * np.sqrt(np.maximum(
            0.0, 1.0 - (t / (half * L)) ** 2))) / np.i0(beta)
        # passband gain: 1 for upsampling, L/M for downsampling
        gain = 1.0 if L >= M else L / M
        # normalise the per-phase DC response (removes periodic ripple)
        phase_sums = np.array([proto[(r + half * L) % L::L].sum()
                               for r in range(L)])
        proto = proto * (gain / phase_sums.mean())

        out_block = block * L // M
        F = block + 2 * half
        tt = (np.arange(out_block)[None, :] * M
              - (np.arange(F)[:, None] - half) * L)
        band = np.abs(tt) <= half * L
        T = np.zeros((F, out_block), dtype=np.float64)
        T[band] = proto[tt[band] + half * L]
        return cls(L, M, half, block, out_block, T.astype(np.float32))


def resample_poly(x, plan: PolyphasePlan, carry, matrix=None):
    """Polyphase L/M resampling of flat (re, im) sample planes.

    x: planes [N] with N a multiple of plan.block; carry: planes [2*half]
    of input history; matrix: plan.matrix as a tensor on x's device (made
    from the plan when None).  Returns (y planes [N*L/M], new_carry).  The
    output stream equals the resampled input stream delayed by `half`
    input samples."""
    h2 = 2 * plan.half
    T = (torch.as_tensor(plan.matrix, device=x[0].device)
         if matrix is None else matrix)

    def one(p, c):
        xp = torch.cat([c, p])                        # [N + 2h]
        nb = p.shape[0] // plan.block
        base = xp[:nb * plan.block].reshape(nb, plan.block)
        # halo: the 2h samples following each frame (the next frame's
        # head; the last frame's halo is the stream tail)
        halo = xp[plan.block:].unfold(0, h2, plan.block)[:nb]
        frames = torch.cat([base, halo], dim=1)       # [nb, block + 2h]
        return (frames @ T).reshape(-1), xp[-h2:]

    yr, cr = one(x[0], carry[0])
    yi, ci = one(x[1], carry[1])
    return (yr, yi), (cr, ci)


def _s16(x: torch.Tensor):
    clipped = torch.clamp(x, -32768.0, 32767.0)
    n = (x != clipped).sum(dtype=torch.int32)
    return clipped.to(torch.int32).to(torch.int16), n


def format_convert(x: torch.Tensor, fmt: str):
    """Wire-format conversion of [..., N, 2] pairs with saturation and clip
    counting.  Returns (converted, n_clipped)."""
    if fmt in ("complexf", "complexf_normalised", "f32", ""):
        return x, torch.zeros((), dtype=torch.int32, device=x.device)
    if fmt == "s16":
        return _s16(x)
    if fmt in ("u8", "s8"):
        raise NotImplementedError(
            f"output format {fmt}: not ported yet (ROADMAP A7)")
    raise ValueError(f"invalid output format {fmt}")


def pack_s16_planes(re: torch.Tensor, im: torch.Tensor):
    """s16 wire conversion of (re, im) planes into int32 words.

    The int16 pair (re, im) viewed as one little-endian int32 is
    (im << 16) | (re & 0xFFFF), byte-identical to interleaved s16 pairs;
    building the word by a dtype view keeps negative values exact (no
    signed shift).  Returns (words int32 [...], n_clipped int32 scalar)."""
    re16, n_re = _s16(re)
    im16, n_im = _s16(im)
    words = torch.stack([re16, im16], dim=-1).view(torch.int32).squeeze(-1)
    return words, n_re + n_im


def papr_db(x, dim=-1) -> torch.Tensor:
    """Peak-to-average power ratio in dB of (re, im) planes, reduced over
    `dim` (ref: src/PAPRStats.cpp:36-107)."""
    p = x[0] * x[0] + x[1] * x[1]
    return 10.0 * torch.log10(p.amax(dim=dim) / p.mean(dim=dim))
