"""Bit-exact KISS fixed-point (int16) FFT and the Q1.14 windowed guard
interval: the port of dabmod_tpu/ops/kiss_fixed.py as int32 torch ops.

The reference's fft_engine=kiss configuration runs the vendored KISS FFT
compiled with FIXED_POINT=16 (Makefile.am:38): every butterfly stage
scales its inputs by 1/radix and rounds every multiply back to int16
(kiss/_kiss_fft_guts.h sround/C_MUL/C_FIXDIV), so the s16 wire samples
carry the per-stage quantisation pattern.  This module reproduces that
arithmetic exactly -- the same mixed-radix factorisation (kf_factor), the
same recursion order (kf_work), the same butterflies (kf_bfly2/kf_bfly4
with the inverse branch), the same twiddle quantisation
(floor(.5 + 32767*cos)), the same int16 wraparound on every store -- over
a batch of symbols, as dabmod_tpu does.

Integers ride in int32 tensors holding int16 values.  The int16
wraparound is explicit masking (_wrap16), never int32 overflow: every
operand is wrapped to int16 before a multiply, so the largest sum, a
C_MUL component, is at most 2 * 32768 * 32767 = 2,147,418,112 < 2**31 on
the CPU and on the card alike.  `>>` on a signed int32 tensor is an
arithmetic shift, as sround needs.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def kf_factor(n: int) -> list[tuple[int, int]]:
    """KISS mixed-radix factorisation (kiss/kiss_fft.c:307-330):
    powers of 4 first, then 2, 3, higher primes; returns (p, m) pairs."""
    out = []
    p = 4
    floor_sqrt = int(np.floor(np.sqrt(n)))
    while True:
        while n % p:
            p = {4: 2, 2: 3}.get(p, p + 2)
            if p > floor_sqrt:
                p = n
        n //= p
        out.append((p, n))
        if n <= 1:
            return out


def _build_perm(n: int, factors: list[tuple[int, int]]) -> np.ndarray:
    """Input-gather permutation implied by kf_work's recursion
    (kiss/kiss_fft.c:236-301): out[j] = in[perm[j]] at the leaves."""
    perm = np.zeros(n, np.int64)

    def rec(out_off: int, in_off: int, fstride: int, fi: int):
        p, m = factors[fi]
        if m == 1:
            for q in range(p):
                perm[out_off + q] = in_off + q * fstride
        else:
            for k in range(p):
                rec(out_off + k * m, in_off + fstride * k,
                    fstride * p, fi + 1)

    rec(0, 0, 1, 0)
    return perm


@functools.lru_cache(maxsize=32)
def _plan(n: int, inverse: bool, device: torch.device):
    """(perm, stages) on `device`: the input permutation (int64) and, per
    butterfly stage in the order it runs (deepest first), (p, m, twiddle
    planes): (t1r, t1i) for radix 2, t1..t3 for radix 4, int32 [m].  Made
    once for each (n, inverse, device): a host-to-device copy in every
    step would wait for the card."""
    factors = kf_factor(n)
    for p, _ in factors:
        if p not in (2, 4):
            raise NotImplementedError(
                f"kiss emulation implements radix 2/4 only (n={n})")
    perm = _build_perm(n, factors)
    i = np.arange(n, dtype=np.float64)
    phase = -2.0 * np.pi * i / n
    if inverse:
        phase = -phase
    tw_r = np.floor(0.5 + 32767.0 * np.cos(phase)).astype(np.int32)
    tw_i = np.floor(0.5 + 32767.0 * np.sin(phase)).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)
    # at depth d there are fstride_d = prod(p_0..p_{d-1}) blocks of p*m;
    # the recursion is post-order, so the deepest stage runs first
    stages = []
    fstride = 1
    for p, m in factors:
        k = np.arange(m)
        tw = tuple((t(tw_r[j * k * fstride]), t(tw_i[j * k * fstride]))
                   for j in range(1, p))
        stages.append((p, m, tw))
        fstride *= p
    return t(perm), tuple(reversed(stages))


def _wrap16(x):
    """int16 store semantics (kiss_fft_cpx fields are int16_t)."""
    return ((x + 32768) & 65535) - 32768


def _sround(x):
    """sround: (x + 2^14) >> 15, arithmetic (kiss/_kiss_fft_guts.h:66)."""
    return (x + (1 << 14)) >> 15


def _fixdiv(r, i, div: int):
    """C_FIXDIV: multiply by SAMP_MAX/div and round (DIVSCALAR)."""
    k = 32767 // div
    return _wrap16(_sround(r * k)), _wrap16(_sround(i * k))


def _cmul(ar, ai, br, bi):
    """C_MUL: rounds the *summed* 32-bit products once per component."""
    return (_wrap16(_sround(ar * br - ai * bi)),
            _wrap16(_sround(ar * bi + ai * br)))


def _bfly2(x, tw):
    """kf_bfly2 over [..., 2, m] planes."""
    (t1r, t1i), = tw
    f0r, f0i = _fixdiv(x[0][..., 0, :], x[1][..., 0, :], 2)
    f1r, f1i = _fixdiv(x[0][..., 1, :], x[1][..., 1, :], 2)
    tr, ti = _cmul(f1r, f1i, t1r, t1i)
    return ((_wrap16(f0r + tr), _wrap16(f0r - tr)),
            (_wrap16(f0i + ti), _wrap16(f0i - ti)))


def _bfly4(x, tw, inverse: bool):
    """kf_bfly4 over [..., 4, m] planes."""
    f = [_fixdiv(x[0][..., q, :], x[1][..., q, :], 4) for q in range(4)]
    (f0r, f0i), (f1r, f1i), (f2r, f2i), (f3r, f3i) = f
    s0r, s0i = _cmul(f1r, f1i, *tw[0])
    s1r, s1i = _cmul(f2r, f2i, *tw[1])
    s2r, s2i = _cmul(f3r, f3i, *tw[2])
    s5r = _wrap16(f0r - s1r)
    s5i = _wrap16(f0i - s1i)
    f0r = _wrap16(f0r + s1r)
    f0i = _wrap16(f0i + s1i)
    s3r = _wrap16(s0r + s2r)
    s3i = _wrap16(s0i + s2i)
    s4r = _wrap16(s0r - s2r)
    s4i = _wrap16(s0i - s2i)
    o2r = _wrap16(f0r - s3r)
    o2i = _wrap16(f0i - s3i)
    o0r = _wrap16(f0r + s3r)
    o0i = _wrap16(f0i + s3i)
    if inverse:
        o1r, o1i = _wrap16(s5r - s4i), _wrap16(s5i + s4r)
        o3r, o3i = _wrap16(s5r + s4i), _wrap16(s5i - s4r)
    else:
        o1r, o1i = _wrap16(s5r + s4i), _wrap16(s5i - s4r)
        o3r, o3i = _wrap16(s5r - s4i), _wrap16(s5i + s4r)
    return (o0r, o1r, o2r, o3r), (o0i, o1i, o2i, o3i)


def kiss_fft_fixed(re, im, inverse: bool = True):
    """KISS FIXED_POINT=16 transform of int32 planes [..., n] holding
    int16 values; returns int32 planes holding the exact int16 results."""
    n = re.shape[-1]
    perm, stages = _plan(n, inverse, re.device)
    xr = re.to(torch.int32).index_select(-1, perm)
    xi = im.to(torch.int32).index_select(-1, perm)
    lead = xr.shape[:-1]
    for p, m, tw in stages:
        nb = n // (p * m)
        x = (xr.reshape(*lead, nb, p, m), xi.reshape(*lead, nb, p, m))
        outr, outi = (_bfly2(x, tw) if p == 2
                      else _bfly4(x, tw, inverse))
        xr = torch.stack(outr, dim=-2).reshape(*lead, n)
        xi = torch.stack(outi, dim=-2).reshape(*lead, n)
    return xr, xi


# ---------------------------------------------------------------------------
# fpm Q1.14 arithmetic (fpm/fixed.hpp, EnableRounding=true), used by the
# reference's fixed-point windowed guard-interval inserter
# (src/GuardIntervalInserter.cpp:96-299 complexfix branches)
# ---------------------------------------------------------------------------


def window_q14(values: np.ndarray) -> np.ndarray:
    """fpm fixed(double) construction: round half away from zero
    (fpm/fixed.hpp:48-52); window values are in [0, 1]."""
    return np.floor(values * 16384.0 + 0.5).astype(np.int32)


def fpm_mul_q14(x, w):
    """fpm fixed*fixed with EnableRounding: v = (x*w)/(2^13) with C
    truncating division, result v/2 + v%2 (fpm/fixed.hpp:156-167).
    `x` holds int16 values and `w` must be in [0, 16384] (window
    coefficients are), so |x*w| <= 2**29."""
    prod = x * w
    v_abs = prod.abs() >> 13
    v = (v_abs >> 1) + (v_abs & 1)
    return _wrap16(torch.where(prod < 0, -v, v))


@functools.lru_cache(maxsize=32)
def window_edges_q14(ov: int, device: torch.device):
    """The Q1.14 window's four edges (rise1, rise2, fall1, fall2), int32
    tensors on `device`, made once for each (ov, device)."""
    win = 0.5 * (1.0 - np.cos(np.pi * np.arange(2 * ov) / (2 * ov - 1)))
    wq = window_q14(win)
    return tuple(torch.as_tensor(w.copy(), device=device) for w in (
        wq[:ov], wq[ov:2 * ov], wq[2 * ov - 1:ov - 1:-1], wq[ov - 1::-1]))


def guard_interval_windowed_fixed(symbols, null_size: int, sym_size: int,
                                  ov: int):
    """Raised-cosine windowed GI in exact Q1.14 arithmetic, mirroring
    ops.ofdm.guard_interval_windowed's decomposition but with fpm multiply
    semantics and int16-wrapping adds, for bit-exact parity with the
    reference's complexfix path.  symbols: (re, im) int32 planes
    [B, S, spacing] -> int32 planes [B, tf_samples]."""
    B, S, sp = symbols[0].shape
    npre = null_size - sp
    rise1, rise2, fall1, fall2 = window_edges_q14(ov, symbols[0].device)
    a = 2 * sp - sym_size                 # where a symbol's prefix starts

    def one(x):
        data = x[:, 1:]
        head = _wrap16(fpm_mul_q14(data[:, :, a:a + ov], rise2)
                       + fpm_mul_q14(x[:, :-1, :ov], fall2))
        mid_prefix = data[:, :, a + ov:sp]
        body = data[:, :, :sp - ov]
        tails = torch.cat(
            [_wrap16(fpm_mul_q14(data[:, :-1, sp - ov:], fall1)
                     + fpm_mul_q14(data[:, 1:, a - ov:a], rise1)),
             data[:, -1:, sp - ov:]], dim=1)
        blocks = torch.cat([head, mid_prefix, body, tails], dim=2)
        null = x[:, 0]
        null_tail = _wrap16(fpm_mul_q14(null[:, sp - ov:], fall1)
                            + fpm_mul_q14(data[:, 0, a - ov:a], rise1))
        null_block = torch.cat(
            [null[:, sp - npre:], null[:, :sp - ov], null_tail], dim=1)
        return torch.cat([null_block, blocks.reshape(B, -1)], dim=1)
    return one(symbols[0]), one(symbols[1])
