"""OFDM-side ops on tensors (port of dabmod_tpu/ops/ofdm.py, the float
chain): QPSK mapping, frequency interleaving, pi/4-DQPSK, bin mapping, crest
factor reduction, gain control and guard-interval insertion, plain and
windowed.

Every constellation point entering the differential modulator is an
eighth-turn phasor exp(i*pi/4*q), so the reference's complex product chain
(src/DifferentialModulator.cpp:45-76) becomes an exact integer cumulative
sum mod 8.  Complex samples are (re, im) float32 planes (see ops.cplx).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import GAIN_FIX, GAIN_MAX, GAIN_VAR
from .fft import fft_planes, ifft_planes

# sqrt(1/2) as float32: the value of the odd (diagonal) constellation points
_HALF = float(np.float32(np.sqrt(0.5)))


def qpsk_phase_indices(tf_bits: torch.Tensor, carriers: int) -> torch.Tensor:
    """[B, n_bits] TF bit stream -> [B, L, carriers] phase indices (pi/4
    units, int32).

    Per symbol the first `carriers` bits are I, the next `carriers` are Q
    (ref: src/QpskSymbolMapper.cpp:39-213); q = [1,7,3,5][2*bI+bQ], computed
    arithmetically as q = 1 + 2i + 6q - 4iq.
    """
    B, nbits = tf_bits.shape
    L = nbits // (2 * carriers)
    biq = tf_bits.reshape(B, L, 2, carriers).to(torch.int32)
    bi, bq = biq[:, :, 0], biq[:, :, 1]
    return 1 + 2 * bi + 6 * bq - 4 * bi * bq


def freq_interleave(x: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """Apply the frequency interleaver as a gather (out[k] = in[inv[k]])."""
    return x.index_select(-1, inv_perm)


def diff_modulate(sym_q: torch.Tensor, ref_q: torch.Tensor) -> torch.Tensor:
    """pi/4-DQPSK as an exact integer phase cumsum.

    sym_q: [B, L, C] data-symbol phase indices; ref_q: [C] phase reference.
    Returns [B, L+1, C] int32 (symbol 0 = phase reference).  Partial sums
    stay below 8*(L+1), far inside int32.
    """
    B, _, C = sym_q.shape
    ref = ref_q.to(torch.int32).expand(B, 1, C)
    phases = torch.cat([ref, sym_q.to(torch.int32)], dim=1)
    return torch.cumsum(phases, dim=1, dtype=torch.int32) & 7


def phases_to_carriers(phases: torch.Tensor):
    """Phase indices -> (re, im) float32 carrier planes.

    Bit arithmetic on the eighth-turn index q (b2 b1 b0):

        odd q  (b0=1):  re = sqrt(1/2) * (1 - 2*(b1^b2))
                        im = sqrt(1/2) * (1 - 2*b2)
        even q (b0=0):  re = (1 - b1) * (1 - 2*b2)
                        im = b1       * (1 - 2*b2)
    """
    q = phases.to(torch.int32)
    b0 = q & 1
    b1 = (q >> 1) & 1
    b2 = (q >> 2) & 1
    sb2 = (1 - 2 * b2).to(torch.float32)
    odd = b0 == 1
    re = torch.where(odd, _HALF * (1 - 2 * (b1 ^ b2)).to(torch.float32),
                     (1 - b1).to(torch.float32) * sb2)
    im = torch.where(odd, _HALF * sb2, b1.to(torch.float32) * sb2)
    return re, im


def to_bins_slices(carriers_planes, carriers: int, spacing: int):
    """Bin mapping on (re, im) planes [..., C] -> [..., spacing]: the
    carrier->bin map is two contiguous block copies plus zero stripes
    (ref: src/OfdmGenerator.cpp:77-103)."""
    pos_dst = 0 if (carriers & 1) else 1
    pos_size = (carriers + 1) // 2
    neg_size = carriers // 2
    mid = spacing - neg_size - pos_dst - pos_size

    def one(x):
        lead = x.shape[:-1]

        def z(n):
            return torch.zeros((*lead, n), dtype=x.dtype, device=x.device)
        return torch.cat(
            [z(pos_dst), x[..., :pos_size], z(mid), x[..., pos_size:]],
            dim=-1)
    return tuple(one(x) for x in carriers_planes)


def ofdm_ifft(bins):
    """Unnormalised backward transform matching FFTW_BACKWARD
    (ref: src/OfdmGenerator.cpp:109-111, 228)."""
    return ifft_planes(bins)


def f32_square(limit: float) -> float:
    """limit**2 as dabmod_tpu's comparisons see it: the Python double
    product rounded to float32 (a weakly typed scalar against a float32
    array).  Exactly representable in float32, so every comparison and
    division below gives the same result in float32 or float64."""
    return float(np.float32(limit * limit))


def amp_clip(symbols, limit: float):
    """Scale (re, im) samples whose magnitude exceeds `limit` back onto it;
    returns (clipped planes, over mask).  All-zero samples keep scale 1."""
    lim2 = f32_square(limit)
    mag_sq = symbols[0] * symbols[0] + symbols[1] * symbols[1]
    over = mag_sq > lim2
    # a true division: `float / tensor` would multiply by the reciprocal
    num = torch.tensor(lim2, dtype=mag_sq.dtype, device=mag_sq.device)
    scale = torch.where(
        over, torch.sqrt(num / torch.where(mag_sq > 0, mag_sq, 1.0)), 1.0)
    return tuple(x * scale for x in symbols), over


def cfr_clip(symbols, clip: float):
    """Clip plane samples to amplitude `clip`; returns (clipped, n_clipped)
    with the count summed over the last two axes."""
    clipped, over = amp_clip(symbols, clip)
    return clipped, over.sum(dim=(-2, -1), dtype=torch.int32)


def cfr_correct(symbols, reference_bins, clip: float, error_clip: float):
    """One crest-factor-reduction iteration over [..., S, spacing] planes
    (ref: src/OfdmGenerator.cpp:310-373): clip, forward transform scaled by
    1/N, the error against the reference bins clipped to `error_clip`,
    inverse transform.  Returns (out planes, clip mask, error-clip mask)."""
    n = symbols[0].shape[-1]
    clipped, over = amp_clip(symbols, clip)
    sr, si = fft_planes(clipped)
    sr, si = sr * (1.0 / n), si * (1.0 / n)
    err = (reference_bins[0] - sr, reference_bins[1] - si)
    err_clipped, over_e = amp_clip(err, error_clip)
    return ifft_planes((sr + err_clipped[0], si + err_clipped[1])), over, over_e


def cfr_one_iteration(symbols, reference_bins, clip: float,
                      error_clip: float):
    """cfr_correct with the clip counts summed over the last two axes, as
    dabmod_tpu.ops.ofdm.cfr_one_iteration returns them."""
    out, over, over_e = cfr_correct(symbols, reference_bins, clip, error_clip)
    return (out, over.sum(dim=(-2, -1), dtype=torch.int32),
            over_e.sum(dim=(-2, -1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Gain control (ref: src/GainControl.cpp, scalar paths :344-502)
# ---------------------------------------------------------------------------


def compute_gain(symbols, mode: int, var_k: float) -> torch.Tensor:
    """Per-symbol gain for [..., S, spacing] planes -> [..., S] float32.

    The NULL symbol (index 0) takes the gain computed from symbol 1 for
    consistent TII power (ref: src/GainControl.cpp:135-144)."""
    factor = 32767.0
    re, im = symbols
    if mode == GAIN_FIX:
        g = torch.full(re.shape[:-1], 512.0, dtype=torch.float32,
                       device=re.device)
    elif mode == GAIN_MAX:
        mx = torch.maximum(re.abs().amax(dim=-1), im.abs().amax(dim=-1))
        g = torch.where(torch.floor(mx) == 0, 1.0, factor / mx)
    elif mode == GAIN_VAR:
        dr = re - re.mean(dim=-1, keepdim=True)
        di = im - im.mean(dim=-1, keepdim=True)
        # component-wise variance split across even/odd samples exactly as
        # the reference's SSE-emulating scalar code does
        var_re = ((dr[..., 0::2] ** 2).mean(dim=-1)
                  + (dr[..., 1::2] ** 2).mean(dim=-1)) * 0.5
        var_im = ((di[..., 0::2] ** 2).mean(dim=-1)
                  + (di[..., 1::2] ** 2).mean(dim=-1)) * 0.5
        sig = torch.maximum(torch.sqrt(var_re), torch.sqrt(var_im)) * var_k
        g = torch.where(torch.floor(sig) == 0, 1.0, factor / sig)
    else:
        raise ValueError(f"invalid gain mode {mode}")
    # NULL symbol borrows the next symbol's gain
    return torch.cat([g[..., 1:2], g[..., 1:]], dim=-1)


# ---------------------------------------------------------------------------
# Guard interval insertion, window_overlap == 0
# ---------------------------------------------------------------------------


def guard_interval_unwindowed(symbols, null_size: int, sym_size: int,
                              gains=None):
    """Cyclic-prefix insertion for window_overlap == 0
    (ref: src/GuardIntervalInserter.cpp:301-318): each output symbol is
    [tail of symbol, full symbol].
    symbols: (re, im) planes [B, S, spacing] -> [B, tf_samples].

    `gains` ([B, S], already including the constant gain) multiplies each
    symbol before assembly: the reference's GainControl ahead of the
    inserter, with the same float32 product per sample."""
    spacing = symbols[0].shape[-1]
    null_pre = null_size - spacing
    sym_pre = sym_size - spacing

    def one(x):
        if gains is not None:
            x = x * gains[..., None]
        lead = x.shape[:-2]
        null = torch.cat([x[..., 0, spacing - null_pre:], x[..., 0, :]],
                         dim=-1)
        data = torch.cat([x[..., 1:, spacing - sym_pre:], x[..., 1:, :]],
                         dim=-1)
        return torch.cat([null, data.reshape(*lead, -1)], dim=-1)
    return tuple(one(x) for x in symbols)


# ---------------------------------------------------------------------------
# Guard interval insertion with raised-cosine windowing, window_overlap > 0
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def guard_window(ov: int, device: torch.device):
    """The window's four edges, float32 tensors on `device` (rise1 0 -> 0.5,
    rise2 0.5 -> 1, fall1 1 -> 0.5, fall2 0.5 -> 0): the rising half-window
    computed in float64 and rounded to float32
    (ref: src/GuardIntervalInserter.cpp:107).  Made once for each device:
    a host-to-device copy in every step would wait for the card."""
    win = 0.5 * (1.0 - np.cos(np.pi * np.arange(2 * ov) / (2 * ov - 1)))
    win = win.astype(np.float32)
    return tuple(torch.as_tensor(w.copy(), device=device) for w in (
        win[:ov], win[ov:2 * ov], win[2 * ov - 1:ov - 1:-1], win[ov - 1::-1]))


def guard_interval_windowed(symbols, null_size: int, sym_size: int,
                            ov: int, gains=None):
    """Raised-cosine windowed guard-interval insertion
    (ref: src/GuardIntervalInserter.cpp:96-299), as slices over the symbol
    axis.  symbols: (re, im) planes [B, S, spacing] with S = nb_symbols + 1
    (NULL first) -> planes [B, tf_samples].

    Each data symbol's block is, in order: the head, its rising edge's
    second half (rise2) over the first ov prefix samples plus the previous
    symbol's first ov samples on the falling edge's second half (fall2);
    the rest of the prefix; the body; and the tail, its own last ov samples
    on fall1 plus the next symbol's rise1 (the last symbol keeps its
    unwindowed tail).  The NULL block carries its own falling edge.
    `gains` ([B, S], already including the constant gain) folds into each
    window operand, so every overlap sample takes the gain of the symbol
    it came from, as gain-before-GI does in the reference chain."""
    B, S, sp = symbols[0].shape
    if not 0 < ov <= sym_size - sp:
        raise ValueError(f"window overlap {ov} outside 1..{sym_size - sp}, "
                         f"the guard interval")
    npre = null_size - sp
    rise1, rise2, fall1, fall2 = guard_window(ov, symbols[0].device)
    pre0 = 2 * sp - sym_size          # where a data symbol's prefix starts

    # per-symbol gains [B, S, 1]: g(a, b) is symbols a:b's, g(a) symbol a's
    g_all = None if gains is None else gains[..., None]

    def g(a, b=None):
        if g_all is None:
            return None
        return g_all[:, a] if b is None else g_all[:, a:b]

    def edge(x, win, gs):
        """x on a window edge: the edge times the gain, then the sample."""
        return x * (win if gs is None else win * gs)

    def gain(x, gs):
        return x if gs is None else x * gs

    def one(x):
        data = x[:, 1:]                            # [B, S-1, sp]
        head = (edge(data[:, :, pre0:pre0 + ov], rise2, g(1, S))
                # the previous symbol's cyclic suffix (NULL for s = 1)
                + edge(x[:, :-1, :ov], fall2, g(0, S - 1)))
        mid_prefix = gain(data[:, :, pre0 + ov:sp], g(1, S))
        body = gain(data[:, :, :sp - ov], g(1, S))
        tails = torch.cat([
            edge(data[:, :-1, sp - ov:], fall1, g(1, S - 1))
            + edge(data[:, 1:, pre0 - ov:pre0], rise1, g(2, S)),
            gain(data[:, -1:, sp - ov:], g(S - 1, S))], dim=1)
        blocks = torch.cat([head, mid_prefix, body, tails], dim=2)

        # NULL block: plain prefix + body, its own falling edge plus the
        # first data symbol's rise1 on the last ov samples
        null = x[:, 0]
        null_tail = (edge(null[:, sp - ov:], fall1, g(0))
                     + edge(data[:, 0, pre0 - ov:pre0], rise1, g(1)))
        null_pre_body = gain(torch.cat([null[:, sp - npre:],
                                        null[:, :sp - ov]], dim=1), g(0))
        null_block = torch.cat([null_pre_body, null_tail], dim=1)
        return torch.cat([null_block, blocks.reshape(B, -1)], dim=1)
    return tuple(one(x) for x in symbols)


def guard_interval(symbols, gi_tables):
    """The gather form of the guard-interval inserter: (re, im) planes
    [..., S, spacing] -> [..., tf_samples] through the static overlap-add
    tables of tables.guard_interval_tables (kept to check the slice forms
    above)."""
    idx_a, w_a, idx_b, w_b = (np.asarray(a) for a in gi_tables)
    dev = symbols[0].device
    ia, ib = (torch.as_tensor(i.astype(np.int64), device=dev)
              for i in (idx_a, idx_b))
    wa, wb = (torch.as_tensor(v, device=dev) for v in (w_a, w_b))

    def one(x):
        flat = x.reshape(*x.shape[:-2], -1)
        flat = torch.cat([flat, flat.new_zeros((*flat.shape[:-1], 1))], -1)
        out = flat[..., ia] * wa
        if np.any(w_b != 0):
            out = out + flat[..., ib] * wb
        return out
    return tuple(one(x) for x in symbols)
