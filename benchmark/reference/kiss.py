"""The plain reference of ODR-DabMod's fixed-point chain, fft_engine=kiss
(src/DabModulator.cpp:144-241): ETI frames in, complexfix wire samples of
whole transmission frames out.

The front end (FEC, time interleaving, QPSK, frequency interleaving,
pi/4-DQPSK, the NULL symbol with TII) is chain.py's.  From there the chain
is upstream's fixed-point one, with no GainControl, no FormatConverter and
no clip:

  Q1.14    each carrier as rint(x * 16384) (complexfix, src/Buffer.h:41-43)
  bins     the carriers in the 2048 bins, DC empty, as OfdmGeneratorFixed
           places them (src/OfdmGenerator.cpp:467-579)
  IFFT     KISS FFT built with FIXED_POINT=16 (kiss/kiss_fft.c,
           kiss/_kiss_fft_guts.h), inverse: kf_factor's radices, kf_work's
           recursion order, kf_bfly4 and kf_bfly2, every input of a
           butterfly divided by its radix through C_FIXDIV, every product
           through sround, every store an int16
  GI       the cyclic prefix; with an overlap, each symbol's cyclic
           extension shaped by the Q1.14 raised-cosine window through fpm's
           Q1.14 multiply (fpm/fixed.hpp) and added over its neighbours
           (src/GuardIntervalInserter.cpp, its complexfix branch)
  wire     the int16 (re, im) pairs

Integers are carried in int64 tensors, on any device, one butterfly stage
at a time over a batch of symbols; `_wrap16` is the store into an int16.

`precision="f64"` is the exact integer answer.  The control,
`precision="float"`, does the transform in float64 (an unnormalised
inverse DFT, scaled by 1/N) and rounds once to int16: the shortcut of a
float engine followed by one quantisation, which departs from the
per-stage rounding by at least one LSB.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import chain, dab

I64 = torch.int64
CONTROL_PRECISION = "float"

# kiss_fft_scalar is int16_t; FRACBITS 15, SAMP_MAX 32767 (_kiss_fft_guts.h)
FRACBITS = 15
SAMP_MAX = 32767
# fpm::fixed<int16_t, int32_t, 14>
Q14 = 14


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """A store into an int16: the low 16 bits, two's complement."""
    return ((x + 32768) & 0xFFFF) - 32768


def sround(x: torch.Tensor) -> torch.Tensor:
    """sround(x) = (kiss_fft_scalar)((x + (1 << (FRACBITS-1))) >> FRACBITS)."""
    return _wrap16((x + (1 << (FRACBITS - 1))) >> FRACBITS)


def c_fixdiv(re, im, div: int):
    """C_FIXDIV(c, div): DIVSCALAR on each part, sround(x * (SAMP_MAX/div))
    with C's integer division of SAMP_MAX."""
    k = SAMP_MAX // div
    return sround(re * k), sround(im * k)


def c_mul(ar, ai, br, bi):
    """C_MUL(m, a, b): each part's products summed in SAMPPROD, then
    sround."""
    return sround(ar * br - ai * bi), sround(ar * bi + ai * br)


def kf_factor(n: int) -> list:
    """kf_factor: factor out powers of 4, then powers of 2, then odd
    primes; the (radix p, sub-transform length m) of each stage, outermost
    first."""
    facs = []
    p = 4
    floor_sqrt = math.floor(math.sqrt(n))
    while True:
        while n % p:
            p = {4: 2, 2: 3}.get(p, p + 2)
            if p > floor_sqrt:
                p = n
        n //= p
        facs.append((p, n))
        if n <= 1:
            return facs


def kf_work_order(n: int, factors: list) -> np.ndarray:
    """The input index that kf_work copies into each output position where
    its recursion reaches m == 1 (in_stride 1)."""
    order = np.empty(n, np.int64)

    def work(pos: int, f: int, fstride: int, depth: int):
        p, m = factors[depth]
        if m == 1:
            for j in range(p):
                order[pos + j] = f + j * fstride
        else:
            for j in range(p):
                work(pos + j * m, f + j * fstride, fstride * p, depth + 1)
    work(0, 0, 1, 0)
    return order


def kf_twiddles_inverse(n: int) -> np.ndarray:
    """kiss_fft_alloc's table for the inverse: phase = -2 pi i / nfft,
    negated; KISS_FFT_COS/SIN = floor(.5 + SAMP_MAX * cos/sin(phase)).
    [n, 2] int64 (r, i)."""
    pi = 3.14159265358979323846264338327
    tw = np.empty((n, 2), np.int64)
    for i in range(n):
        phase = -2 * pi * i / n
        phase *= -1
        tw[i] = (math.floor(.5 + SAMP_MAX * math.cos(phase)),
                 math.floor(.5 + SAMP_MAX * math.sin(phase)))
    return tw


class KissIFFT:
    """The inverse kiss_fft with FIXED_POINT=16 over the last axis of int64
    (re, im) tensors [R, n], every row a transform; n a power of 2, so
    that kf_factor gives radices 4 and a last 2."""

    def __init__(self, n: int, device):
        self.n = n
        self.factors = kf_factor(n)
        dev = torch.device(device)
        self.order = torch.as_tensor(kf_work_order(n, self.factors),
                                     device=dev)
        self.tw = torch.as_tensor(kf_twiddles_inverse(n), device=dev)

    def _stage_twiddles(self, p: int, m: int, fstride: int):
        """tw[q * k * fstride] for the butterfly's inputs q = 1..p-1 and
        k = 0..m-1 (kf_bfly*'s tw1, tw2, tw3 stepping by fstride, 2 fstride,
        3 fstride): [p-1, m] each part."""
        q = torch.arange(1, p, device=self.tw.device)[:, None]
        k = torch.arange(m, device=self.tw.device)[None]
        t = self.tw[q * k * fstride]
        return t[..., 0], t[..., 1]

    def __call__(self, re: torch.Tensor, im: torch.Tensor):
        n, R = self.n, re.shape[0]
        re, im = re[:, self.order], im[:, self.order]
        # kf_work recombines the innermost stage first; every block of one
        # stage is independent of the others
        fstrides = [1]
        for p, _m in self.factors[:-1]:
            fstrides.append(fstrides[-1] * p)
        for (p, m), fstride in reversed(list(zip(self.factors, fstrides))):
            # Fout[b p m + q m + k] is the butterfly's input q at k
            fr = list(re.reshape(R, fstride, p, m).unbind(2))
            fi = list(im.reshape(R, fstride, p, m).unbind(2))
            twr, twi = self._stage_twiddles(p, m, fstride)
            if p == 4:
                fr, fi = self._bfly4(fr, fi, twr, twi)
            else:
                fr, fi = self._bfly2(fr, fi, twr, twi)
            re = torch.stack(fr, 2).reshape(R, n)
            im = torch.stack(fi, 2).reshape(R, n)
        return re, im

    @staticmethod
    def _bfly2(fr, fi, twr, twi):
        """kf_bfly2."""
        f0r, f0i = c_fixdiv(fr[0], fi[0], 2)
        f1r, f1i = c_fixdiv(fr[1], fi[1], 2)
        tr, ti = c_mul(f1r, f1i, twr[0], twi[0])
        return ([_wrap16(f0r + tr), _wrap16(f0r - tr)],
                [_wrap16(f0i + ti), _wrap16(f0i - ti)])

    @staticmethod
    def _bfly4(fr, fi, twr, twi):
        """kf_bfly4, its st->inverse branch."""
        f = [c_fixdiv(fr[q], fi[q], 4) for q in range(4)]
        s0 = c_mul(*f[1], twr[0], twi[0])
        s1 = c_mul(*f[2], twr[1], twi[1])
        s2 = c_mul(*f[3], twr[2], twi[2])
        s5 = (_wrap16(f[0][0] - s1[0]), _wrap16(f[0][1] - s1[1]))
        f0 = (_wrap16(f[0][0] + s1[0]), _wrap16(f[0][1] + s1[1]))
        s3 = (_wrap16(s0[0] + s2[0]), _wrap16(s0[1] + s2[1]))
        s4 = (_wrap16(s0[0] - s2[0]), _wrap16(s0[1] - s2[1]))
        f2 = (_wrap16(f0[0] - s3[0]), _wrap16(f0[1] - s3[1]))
        f0 = (_wrap16(f0[0] + s3[0]), _wrap16(f0[1] + s3[1]))
        f1 = (_wrap16(s5[0] - s4[1]), _wrap16(s5[1] + s4[0]))
        f3 = (_wrap16(s5[0] + s4[1]), _wrap16(s5[1] - s4[0]))
        return ([f0[0], f1[0], f2[0], f3[0]], [f0[1], f1[1], f2[1], f3[1]])


def fpm_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fixed<int16_t, int32_t, 14>::operator*= with rounding:
    value = (a * b) / 2^13 and then value / 2 + value % 2, C's division
    and remainder (toward zero), stored into an int16."""
    v = torch.div(a * b, 1 << (Q14 - 1), rounding_mode="trunc")
    return _wrap16(torch.div(v, 2, rounding_mode="trunc") + torch.fmod(v, 2))


def fpm_from_float(x: np.ndarray) -> np.ndarray:
    """fixed<int16_t, int32_t, 14>(float) with rounding: the value times
    2^14, plus 0.5 (less 0.5 below zero), truncated."""
    x = np.asarray(x, np.float32).astype(np.float64) * (1 << Q14)
    return np.trunc(np.where(x >= 0, x + 0.5, x - 0.5)).astype(np.int64)


class Chain:
    """The reference for a fixed-point configuration's settings: mode (1),
    window (guard-interval overlap, 0 for none), tii (None or (comb,
    pattern)), wire ("s16").  A setting that upstream's fixed-point chain
    rejects (src/DabModulator.cpp:246-263) raises."""

    # what upstream's fixed-point chain has no stage for
    REJECTED = {"gain_mode": "a gain mode",
                "normalise_variance": "a gain mode",
                "normalise": "an output scale", "cfr": "CFR",
                "fir": "a FIR filter", "poly": "predistortion"}

    def __init__(self, settings: dict, device="cpu", precision="f64"):
        if precision not in ("f64", CONTROL_PRECISION):
            raise ValueError(precision)
        s = settings
        for key, what in self.REJECTED.items():
            if s.get(key) is not None:
                raise ValueError(f"fixed point doesn't support {what}")
        if s.get("rate", 2_048_000) != 2_048_000:
            raise ValueError("fixed point doesn't support the resampler")
        unknown = set(s) - {"mode", "window", "tii", "wire", "rate",
                            *self.REJECTED}
        if unknown:
            raise ValueError(f"kiss reference: unknown settings {unknown}")
        if s.get("mode", 1) != 1:
            raise ValueError("the kiss reference renders TM I")
        if s.get("wire", "s16") != "s16":
            raise ValueError("the fixed-point chain's wire is complexfix")
        self.s = s
        self.dev = torch.device(device)
        self.exact = precision == "f64"
        self.m = m = dab.MODES[1]
        self.front = chain.Chain({"mode": 1, "tii": s.get("tii"),
                                  "wire": "s16"}, device, "f64")
        self.ifft = KissIFFT(m.spacing, device)
        ov = s.get("window", 0)
        # GuardIntervalInserter's float window, then fixed_1_14 of it
        win = (0.5 * (1 - np.cos(np.pi * np.arange(2 * ov)
                                 / max(2 * ov - 1, 1)))).astype(np.float32)
        self.win = torch.as_tensor(fpm_from_float(win), device=self.dev)

    def q14_bins(self, frames: np.ndarray, first_tf: int, keep: int):
        """The Q1.14 bins [keep * 77, N] (re, im) of the last `keep` TFs:
        the NULL symbol and the 76 others in each."""
        m = self.m
        z, null = self.front.carriers(frames, first_tf)
        sym = torch.cat([null[:, None], z], 1)[-keep:]      # [keep, 77, C]
        sym = sym.reshape(-1, m.nb_carriers)
        C, N = m.nb_carriers, m.spacing
        out = []
        for part in (sym.real, sym.imag):
            q = torch.round(part * 16384.0).to(I64)
            bins = torch.zeros((q.shape[0], N), dtype=I64, device=self.dev)
            bins[:, 1:C // 2 + 1] = q[:, :C // 2]
            bins[:, N - C // 2:] = q[:, C // 2:]
            out.append(bins)
        return out

    def transform(self, re: torch.Tensor, im: torch.Tensor):
        """The inverse transform of the Q1.14 bins: the fixed-point KISS
        FFT, or in the control a float64 inverse DFT rounded once."""
        if self.exact:
            return self.ifft(re, im)
        x = torch.fft.ifft(torch.complex(re.to(torch.float64),
                                         im.to(torch.float64)))
        return tuple(torch.round(p).clamp(-32768, 32767).to(I64)
                     for p in (x.real, x.imag))

    def guard_interval(self, re: torch.Tensor, im: torch.Tensor):
        """[B, S, N] int16 symbols -> [B, tf_samples]: cyclic prefix; with
        an overlap ov, the prefix starts ov samples earlier and a suffix of
        ov samples follows the body, their 2 ov edge samples multiplied by
        the rising and the falling window and added over the neighbour (the
        NULL symbol has no rising edge, the last symbol no falling one)."""
        m = self.m
        B, S, N = re.shape
        ov = self.s.get("window", 0)
        outs = []
        for x in (re, im):
            out = torch.zeros((B, m.tf_samples + ov), dtype=I64,
                              device=self.dev)
            for s in range(S):
                size = m.null_size if s == 0 else m.sym_size
                start = 0 if s == 0 else m.null_size + (s - 1) * m.sym_size
                pre = size - N
                lead = ov if (ov and s > 0) else 0
                tail = ov if (ov and s < S - 1) else 0
                idx = torch.arange(-pre - lead, N + tail, device=self.dev) % N
                seg = x[:, s, idx]
                if lead:
                    seg[:, :2 * ov] = fpm_mul(seg[:, :2 * ov], self.win)
                if tail:
                    seg[:, -2 * ov:] = fpm_mul(seg[:, -2 * ov:],
                                               self.win.flip(0))
                out[:, start - lead:start + size + tail] += seg
            outs.append(_wrap16(out[:, :m.tf_samples]))
        return outs

    def render(self, frames: np.ndarray, first_tf: int, keep: int = 1):
        """Wire samples [keep, n, 2] int16 of the last `keep` TFs of
        `frames` (whole TFs, the first being TF `first_tf` of the
        stream)."""
        with torch.no_grad():
            re, im = self.q14_bins(frames, first_tf, keep)
            re, im = self.transform(re, im)
            shape = (keep, self.m.nb_symbols + 1, self.m.spacing)
            re, im = self.guard_interval(re.reshape(shape),
                                         im.reshape(shape))
            return torch.stack([re, im], -1).to(torch.int16)
