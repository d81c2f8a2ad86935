"""Post-OFDM stages on tensors (port of dabmod_tpu/ops/filters.py): the
spectrum-mask FIR, the polyphase and frequency-domain resamplers, the
memoryless DPD (polynomial and LUT), the CIC equalizer's taps, wire-format
conversion (s16, u8, s8) and PAPR statistics.

Complex samples are (re, im) float32 planes (ops.cplx), except where
dabmod_tpu uses [..., N, 2] pairs (the frequency-domain resampler and
format_convert), which keep its layout.  Matrix products go through
torch.matmul, which computes in fp32 under torch's default flags
(torch.backends.cuda.matmul.allow_tf32 is False unless the caller sets it);
a convolution would run through cuDNN, whose TF32 default
(torch.backends.cudnn.allow_tf32 True) rounds inputs to 10 bits.

The float->int conversions saturate, count the samples they clipped, and
truncate toward zero like the reference's C casts (`Tensor.to(int)`
truncates, as `jnp.trunc(...).astype` does).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# FIR (ref: src/FIRFilter.cpp:144-228)
# out[n] = sum_j in[n+j] * taps[j], truncated at the end of each TF
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _band_index(ntaps: int, block: int, device: torch.device):
    """The banded operator's gather: for T[f, o] = taps[f - o], the index
    f - o clipped into the taps and the mask of 0 <= f - o < ntaps, both
    [block + ntaps, block] on `device` (made once: a host-to-device copy
    in every step would wait for the card)."""
    idx = np.arange(block + ntaps)[:, None] - np.arange(block)[None, :]
    inside = (idx >= 0) & (idx < ntaps)
    return (torch.as_tensor(np.clip(idx, 0, ntaps - 1), device=device),
            torch.as_tensor(inside, device=device))


def fir_operator(taps: torch.Tensor, block: int) -> torch.Tensor:
    """The banded operator T [block + ntaps, block], T[f, o] = taps[f - o]
    (0 outside the band), built on the taps' device from the taps tensor:
    a hot swap of the taps is a tensor swap."""
    idx, inside = _band_index(taps.shape[0], block, taps.device)
    return torch.where(inside, taps[idx], 0.0)


def fir_filter(x, taps: torch.Tensor, block: int = 128):
    """x: (re, im) planes [..., N]; taps: [ntaps] float32 tensor on x's
    device -> planes [..., N].

    Each plane is framed into `block`-sample rows and multiplied by the
    banded operator: with N a multiple of the block and ntaps <= block,

        y[i] = x2d[i] @ A + next[i] @ B

    where A = T[:block], B = T[block:] and next[i] is the head of row i+1,
    zero after the last row: the reference's truncation at the TF boundary
    (src/FIRFilter.cpp:218-226).  Otherwise the generic framed form: rows
    of block + ntaps samples of the zero-padded plane."""
    ntaps = taps.shape[0]
    n = x[0].shape[-1]
    lead = x[0].shape[:-1]
    T = fir_operator(taps, block)
    if n % block or ntaps > block:
        nb = -(-n // block)

        def generic(p):
            xp = torch.nn.functional.pad(p, (0, nb * block + ntaps - n))
            frames = xp.unfold(-1, block + ntaps, block)   # [..., nb, F]
            return (frames @ T).reshape(*lead, -1)[..., :n]
        return tuple(generic(p) for p in x)

    nb = n // block
    A, Bt = T[:block], T[block:]

    def banded(p):
        x2d = p.reshape(*lead, nb, block)
        nxt = torch.cat([x2d[..., 1:, :ntaps],
                         x2d.new_zeros((*lead, 1, ntaps))], dim=-2)
        return (x2d @ A + nxt @ Bt).reshape(*lead, n)
    return tuple(banded(p) for p in x)


# ---------------------------------------------------------------------------
# Frequency-domain resampler (ref: src/Resampler.cpp)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResamplerPlan:
    L: int
    M: int
    fft_in: int
    fft_out: int
    factor: float
    window: np.ndarray       # Hann window of length fft_in

    @classmethod
    def create(cls, input_rate: int, output_rate: int, resolution: int):
        g = np.gcd(input_rate, output_rate)
        L = output_rate // g
        M = input_rate // g
        factor = resolution * 2 // M
        if factor & 1:
            factor += 1
        fft_in = factor * M
        fft_out = factor * L
        if fft_in > fft_out:
            scale = 1.0 / fft_in * output_rate / input_rate
        else:
            scale = 1.0 / fft_out * output_rate / input_rate
        n = np.arange(fft_in)
        window = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / (fft_in - 1)))
                  ).astype(np.float32)
        return cls(int(L), int(M), int(fft_in), int(fft_out), float(scale),
                   window)


@functools.lru_cache(maxsize=32)
def _window(window_bytes: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(window_bytes, np.float32).copy(),
                           device=device)


def resample(x: torch.Tensor, plan: ResamplerPlan, in_tail: torch.Tensor,
             out_tail: torch.Tensor):
    """Frequency-domain L/M resampling of a flat pair stream: Hann frames
    with 50 % overlap, a forward transform, the spectrum cut or zero-padded
    to fft_out bins, `factor`, an inverse transform and overlap-add.

    x: [N, 2] (N a multiple of fft_in/2); in_tail: [fft_in/2, 2], the
    previous call's last half-frame; out_tail: [fft_out/2, 2], the
    overlap-add carry.  Returns (y [N*L/M, 2], new in_tail, new out_tail).
    The transforms are unnormalised both ways (FFTW's, as ops.fft)."""
    hi, ho = plan.fft_in // 2, plan.fft_out // 2
    n_blocks = x.shape[0] // hi
    xp = torch.cat([in_tail, x], dim=0)            # [(nb+1)*hi, 2]
    # 50 %-overlapped frames as two shifted reshapes
    frames = torch.cat([xp[:-hi].reshape(n_blocks, hi, 2),
                        xp[hi:].reshape(n_blocks, hi, 2)], dim=1)
    frames = frames * _window(plan.window.tobytes(), x.device)[None, :, None]
    spec = torch.fft.fft(torch.view_as_complex(frames), norm="backward")
    if plan.fft_out > plan.fft_in:
        mid = spec.new_zeros((n_blocks, plan.fft_out - plan.fft_in - 1))
        # the bin at fft_in/2 is duplicated into both halves
        out_spec = torch.cat([spec[:, :hi + 1], mid, spec[:, hi:]], dim=1)
    elif plan.fft_out < plan.fft_in:
        lo_edge = plan.fft_in - ho
        centre = 0.5 * (spec[:, ho:ho + 1] + spec[:, lo_edge:lo_edge + 1])
        out_spec = torch.cat([spec[:, :ho], centre, spec[:, lo_edge + 1:]],
                             dim=1)
    else:
        out_spec = spec
    out_spec = out_spec * plan.factor
    blocks = torch.view_as_real(torch.fft.ifft(out_spec, norm="forward"))
    first, second = blocks[:, :ho], blocks[:, ho:]
    # overlap-add: block b's second half adds onto block b+1's first half
    prev = torch.cat([out_tail[None], second[:-1]], dim=0)
    y = (first + prev).reshape(-1, 2)
    return y, xp[-hi:].clone(), second[-1].clone()


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
# same stream from the operator's band, for plans with 128-sample frames.
# ---------------------------------------------------------------------------


ATTEN_DB = 120.0            # stopband attenuation of the prototype
FRAME = 128                 # input samples per frame (the kernel's framing)
PLAIN_BLOCK = 32            # dabmod_tpu's frame for its XLA form


@dataclasses.dataclass(frozen=True)
class PolyphasePlan:
    L: int
    M: int
    half: int               # half-support in input samples
    block: int              # input samples per frame
    out_block: int          # block * L // M
    matrix: np.ndarray      # banded operator [block + 2*half, out_block]

    @classmethod
    def create(cls, input_rate: int, output_rate: int, block: int = FRAME):
        """The Kaiser-windowed design of dabmod_tpu's PolyphasePlan.create,
        step for step, so the operator is the same to the bit; `block` is
        rounded up to a multiple of M, as there (the kernel takes only
        plans whose block stays FRAME)."""
        g = int(np.gcd(input_rate, output_rate))
        L = output_rate // g
        M = input_rate // g
        # make the block a multiple of M so out_block is integral
        block = ((block + M - 1) // M) * M
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


# ---------------------------------------------------------------------------
# Memoryless DPD (ref: src/MemlessPoly.cpp:237-309)
# ---------------------------------------------------------------------------


def _pmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def memless_poly(x, coefs_am: torch.Tensor, coefs_pm: torch.Tensor):
    """Odd-order AM/AM + AM/PM predistortion with the reference's sin/cos
    series approximations (coefficients as written there, for output
    parity).  x: (re, im) planes; coefs: float32 [5] tensors on x's
    device."""
    m = x[0] * x[0] + x[1] * x[1]
    a, p = coefs_am, coefs_pm
    am = a[0] + m * (a[1] + m * (a[2] + m * (a[3] + m * a[4])))
    pm = -(p[0] + m * (p[1] + m * (p[2] + m * (p[3] + m * p[4]))))
    p2 = pm * pm
    rot_r = 1.0 - p2 * (-0.5 + p2 * (0.486666 + p2 * (-0.00138888)))
    rot_i = pm * (1.0 + p2 * (0.166666 + p2 * 0.00833333))
    return _pmul((x[0] * am, x[1] * am), (rot_r, rot_i))


LUT_BIN = float(1 << 27)    # the top 5 bits of a 32-bit magnitude


def lut_index(x, scalefactor: torch.Tensor) -> torch.Tensor:
    """The LUT entry of each sample: round(|x| * scale) (half to even, as
    jnp.round), clipped to [0, 2**32 - 1] in float32, over 2**27, truncated
    and clipped to [0, 31].  scalefactor: a float32 scalar tensor."""
    mag = torch.sqrt(x[0] * x[0] + x[1] * x[1])
    scaled = torch.clamp(torch.round(mag * scalefactor), 0.0, 2.0 ** 32 - 1)
    return torch.clamp((scaled / LUT_BIN).to(torch.int32), 0, 31)


def lut_edge_samples(x, scalefactor: torch.Tensor, rel: float = 1e-6):
    """Samples whose |x| * scale lies within `rel` (relative) of a bin edge
    of the LUT (a multiple of 2**27): a magnitude that rounds differently
    in another summation order may take the neighbouring entry there."""
    t = torch.sqrt(x[0] * x[0] + x[1] * x[1]) * scalefactor / LUT_BIN
    return ((t - torch.round(t)).abs() <= rel * t) & (t >= 0.5)


def memless_lut(x, lut: torch.Tensor, scalefactor: torch.Tensor):
    """32-entry magnitude-binned LUT predistorter
    (ref: src/MemlessPoly.cpp:278-309).  lut: [32, 2] float32 (re, im)
    pairs and scalefactor a float32 scalar, tensors on x's device."""
    ix = lut_index(x, scalefactor)
    return _pmul(x, (lut[:, 0][ix], lut[:, 1][ix]))


# ---------------------------------------------------------------------------
# CIC equalizer (ref: src/CicEqualizer.cpp:29-92)
# ---------------------------------------------------------------------------


def cic_equalizer_taps(carriers: int, fft_size_over: float,
                       ratio: int) -> np.ndarray:
    """Per-carrier droop compensation, replicating the reference loop."""
    out = np.zeros(carriers, dtype=np.float32)
    R = float(ratio)
    M = 1.0
    for i in range(carriers):
        if i == carriers // 2:
            out[i] = 1.0
            continue
        theta = np.pi * (i - carriers / 2.0) / fft_size_over
        num = np.sin(theta / R) * R * M
        den = np.sin(theta * M)
        h = (num / den) ** 4 if den != 0 else 1.0
        out[i] = h
    return out


# ---------------------------------------------------------------------------
# Format conversion (ref: src/FormatConverter.cpp:62-206)
# ---------------------------------------------------------------------------


def _saturate(x: torch.Tensor, lo: float, hi: float):
    clipped = torch.clamp(x, lo, hi)
    return clipped, (x != clipped).sum(dtype=torch.int32)


def _s16(x: torch.Tensor):
    clipped, n = _saturate(x, -32768.0, 32767.0)
    return clipped.to(torch.int32).to(torch.int16), n


def format_convert(x: torch.Tensor, fmt: str):
    """Wire-format conversion of [..., N, 2] pairs with saturation and clip
    counting; keeps the pair shape.  u8 is x + 128 clipped to [0, 255]; s8
    goes through int32 so the narrowing cast is defined.  Returns
    (converted, n_clipped)."""
    if fmt in ("complexf", "complexf_normalised", "f32", ""):
        return x, torch.zeros((), dtype=torch.int32, device=x.device)
    if fmt == "s16":
        return _s16(x)
    if fmt == "u8":
        clipped, n = _saturate(x + 128.0, 0.0, 255.0)
        return clipped.to(torch.uint8), n
    if fmt == "s8":
        clipped, n = _saturate(x, -128.0, 127.0)
        return clipped.to(torch.int32).to(torch.int8), n
    raise ValueError(f"invalid output format {fmt}")


def pack_bytes(x: torch.Tensor) -> torch.Tensor:
    """A u8 or s8 pair stream [B, N, 2] as int32 words [B, N/2], each four
    consecutive bytes in little-endian order: the same bytes, as
    dabmod_tpu's modulator.py:725-737 packs them."""
    return x.reshape(x.shape[0], -1).view(torch.int32)


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
