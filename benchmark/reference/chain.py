"""The plain reference of the DAB transmit chain: ETI frames in, the wire
samples of whole transmission frames out.

A straightforward rendering of EN 300 401 and of the choices ODR-DabMod
makes where the standard leaves them open (gain, guard-interval windowing,
FIR framing, the polynomial predistorter, the wire formats), in plain
PyTorch on any device and in float64: ETI parse; per ETI frame the FIC and
each sub-channel through energy dispersal, the K=7 convolutional code and
puncturing; the sub-channels through the 16-CIF time interleaver into the
CIF; block partition, QPSK, frequency interleaving and pi/4-DQPSK; the
NULL symbol with TII; the inverse transform, with one CFR iteration;
per-symbol gain; guard interval, plain or windowed; FIR; the polyphase
resampler; the polynomial DPD; s16 or f32 wire samples.

`Chain.render(frames, first_tf)` renders whole TFs from a run of raw ETI
frames that starts at TF `first_tf` of a stream, as a modulator that was
started at the stream's TF 0 renders them: the interleaver history and
the resampler's input history are rebuilt from the frames given, so a run
that starts five TFs before the TF of interest reproduces it exactly.

`precision="tf32"` is the control: every product of the linear stages
(the transforms, as products with the DFT matrix, the FIR, the resampler)
takes its operands rounded to TF32 (10-bit mantissa) and every stage's
output is rounded to float32: the next precision below the float32 with
TF32 off that the configurations state.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dab

F64, C128 = torch.float64, torch.complex128


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 mantissa rounded to 10 bits (nearest, ties
    away), as TF32 operands are; complex parts apart."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real), round_tf32(x.imag))
    bits = x.to(torch.float32).view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(x.dtype)


def round_f32(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x.to(torch.complex64).to(x.dtype)
    return x.to(torch.float32).to(x.dtype)


def parse_eti(frames: np.ndarray):
    """[F, 6144] raw ETI(NI) frames -> (fct [F], fp [F], mid, fic [F, n],
    sub-channels: list of (start CU, bytes [F, n], tpl)).  The stream
    table must be the same in every frame (EN 300 799 clause 5)."""
    f = np.asarray(frames, np.uint8)
    fct, nst = f[:, 4].astype(int), f[:, 5] & 0x7F
    mid, fp = (f[:, 6] >> 3) & 0x3, f[:, 6] >> 5
    if not (np.all(f[:, 5] >> 7 == 1) and np.all(nst == nst[0])
            and np.all(mid == mid[0])):
        raise ValueError("ETI: FIC flag, NST or MID not constant")
    n_st, mid = int(nst[0]), int(mid[0])
    stc = f[0, 8:8 + 4 * n_st].reshape(n_st, 4).astype(int)
    if not np.all(f[:, 8:8 + 4 * n_st] == f[0, 8:8 + 4 * n_st]):
        raise ValueError("ETI: stream table changes")
    off = 8 + 4 * n_st + 4                      # STC, then EOH
    fic_len = 128 if mid == 3 else 96
    fic = f[:, off:off + fic_len]
    off += fic_len
    subs = []
    for b0, b1, b2, b3 in stc:
        sad = ((b0 & 0x3) << 8) | b1
        tpl, stl = b2 >> 2, ((b2 & 0x3) << 8) | b3
        subs.append((sad, f[:, off:off + 8 * stl], tpl))
        off += 8 * stl
    return fct, fp.astype(int), mid, fic, subs


class Chain:
    """The reference for one configuration's settings:

    mode (1), gain_mode ("var"), normalise_variance, normalise (the
    sink's output scale), cfr (None or (clip, error clip)), tii (None or
    (comb, pattern)), window (guard-interval overlap, 0 for none),
    fir (None or taps), rate (output sample rate), poly (None or
    (am[5], pm[5])), wire ("s16" or "f32")."""

    def __init__(self, settings: dict, device="cpu", precision="f64"):
        if precision not in ("f64", "tf32"):
            raise ValueError(precision)
        self.s = s = settings
        self.dev = torch.device(device)
        self.tf32 = precision == "tf32"
        self.m = m = dab.MODES[s.get("mode", 1)]
        if s.get("gain_mode", "var") != "var":
            raise ValueError("the reference renders gainmode=var")
        self.perm = torch.as_tensor(dab.freq_interleaver(1), device=device)
        self.phase_ref = torch.as_tensor(dab.phase_reference(1), dtype=C128,
                                         device=device)
        self.tii = None
        if s.get("tii"):
            self.tii = torch.as_tensor(dab.tii_null_symbol(1, *s["tii"]),
                                       dtype=C128, device=device)
        self.res = None
        if s.get("rate", 2_048_000) != 2_048_000:
            L, M, half, h = dab.polyphase_prototype(2_048_000, s["rate"])
            self.res = (L, M, half,
                        torch.as_tensor(h, dtype=F64, device=device))
        self.fir = (None if s.get("fir") is None else
                    torch.as_tensor(np.asarray(s["fir"], np.float32),
                                    dtype=F64, device=device))
        self._fec_cache = {}
        self._dft_cache = {}

    # -- helpers ---------------------------------------------------------
    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.dev)

    def _operand(self, x):
        """A linear stage's operand: TF32 in the control, else as is."""
        return round_tf32(x) if self.tf32 else x

    def _stage(self, x):
        """A stage's output: float32 in the control, else as is."""
        return round_f32(x) if self.tf32 else x

    @staticmethod
    def _bits(b: torch.Tensor) -> torch.Tensor:
        shifts = torch.arange(7, -1, -1, device=b.device)
        return ((b.to(torch.int64)[..., None] >> shifts) & 1).reshape(
            *b.shape[:-1], -1).to(torch.uint8)

    def _fec(self, key, data: torch.Tensor, rules, out_bits: int):
        """Energy dispersal, convolutional code and puncturing of frames
        [F, n] bytes -> [F, out_bits] bits (zero-padded)."""
        n = data.shape[1]
        if key not in self._fec_cache:
            mask = dab.puncture_mask(rules, n * 8)
            self._fec_cache[key] = (
                self._t(dab.prbs(n)),
                self._t(np.nonzero(mask)[0], torch.int64))
        prbs, keep = self._fec_cache[key]
        u = self._bits(data) ^ prbs
        F = u.shape[0]
        pad = torch.zeros((F, 6), dtype=torch.uint8, device=self.dev)
        up = torch.cat([pad, u, pad], 1)                  # u[i - d] at 6+i-d
        steps = n * 8 + 6
        streams = []
        for delays in dab.CONV_DELAYS:
            acc = torch.zeros((F, steps), dtype=torch.uint8, device=self.dev)
            for d in delays:
                acc ^= up[:, 6 - d:6 - d + steps]
            streams.append(acc)
        mother = torch.stack(streams, -1).reshape(F, -1)
        kept = mother[:, keep]
        out = torch.zeros((F, out_bits), dtype=torch.uint8, device=self.dev)
        out[:, :kept.shape[1]] = kept
        return out

    # -- the chain -------------------------------------------------------
    def carriers(self, frames: np.ndarray, first_tf: int):
        """DQPSK carrier symbols [B, 76, K] (carrier vector order,
        complex128) and the NULL symbol of each TF [B, K], from whole TFs
        of raw ETI frames; the first TF is TF `first_tf` of the stream,
        and the interleaver history before it is zero."""
        m = self.m
        _fct, _fp, mid, fic, subs = parse_eti(frames)
        F = fic.shape[0]
        if F % m.cif_count:
            raise ValueError("whole transmission frames only")
        fic_bits = self._fec(("fic", mid), self._t(fic), dab.fic_rules(mid),
                             m.fic_bytes_out * 8)
        cif = self._t(dab.prbs(dab.CIF_BITS // 8)).repeat(F, 1)
        for sad, data, tpl in subs:
            rules, cu = dab.subchannel_rules(data.shape[1] // 3, tpl)
            bits = self._fec(("sub", data.shape[1], tpl), self._t(data),
                             rules, cu * 64)
            # time interleaving: bit b of CIF c comes from CIF
            # c - TI_DELAYS[b mod 16], zero before the stream's start
            nb = bits.shape[1]
            delay = self._t(dab.TI_DELAYS[np.arange(nb) % 16], torch.int64)
            src = torch.arange(F, device=self.dev)[:, None] - delay[None]
            cols = torch.arange(nb, device=self.dev).expand(F, nb)
            ti = torch.where(src >= 0, bits[src.clamp(min=0), cols], 0)
            cif[:, sad * 64:sad * 64 + nb] = ti
        B, C = F // m.cif_count, m.nb_carriers
        tf_bits = torch.cat([fic_bits.reshape(B, -1), cif.reshape(B, -1)], 1)
        iq = tf_bits.reshape(B, m.nb_symbols - 1, 2, C).to(F64)
        y = torch.complex(1 - 2 * iq[:, :, 0], 1 - 2 * iq[:, :, 1]) \
            / np.sqrt(2.0)
        z = torch.zeros_like(y)
        z[..., self.perm] = y                            # freq interleave
        z = torch.cat([self.phase_ref.expand(B, 1, C), z], 1)
        z = torch.cumprod(z, dim=1)                      # pi/4-DQPSK
        z = z / z.abs()         # each carrier a unit phasor, exactly
        null = torch.zeros((B, C), dtype=C128, device=self.dev)
        if self.tii is not None:
            even = (first_tf + torch.arange(B, device=self.dev)) % 2 == 0
            null[even] = self.tii
        return z, null

    def _dft(self, x, sign: int):
        """Unnormalised DFT over the last axis, exp(sign 2 pi i k n / N):
        a transform in float64, or in the control a product with the DFT
        matrix, both operands in TF32."""
        n = x.shape[-1]
        if not self.tf32:
            return (torch.fft.ifft(x) * n if sign > 0 else torch.fft.fft(x))
        key = (n, sign)
        if key not in self._dft_cache:
            k = torch.arange(n, dtype=F64, device=self.dev)
            self._dft_cache[key] = round_tf32(torch.exp(
                sign * 2j * np.pi * torch.outer(k, k) / n))
        return self._stage(round_tf32(x) @ self._dft_cache[key])

    def _ifft(self, bins):
        """Unnormalised inverse DFT over the last axis."""
        return self._dft(bins, +1)

    def _fft(self, x):
        return self._dft(x, -1)

    @staticmethod
    def _clip(x, limit):
        mag = x.abs()
        return torch.where(mag > limit, x * (limit / mag.clamp(min=1e-300)),
                           x)

    def ofdm(self, z, null):
        """Symbols [B, S=77, N] in time, after CFR where configured."""
        m = self.m
        C, N = m.nb_carriers, m.spacing
        sym = torch.cat([null[:, None], z], 1)           # [B, 77, C]
        bins = torch.zeros((*sym.shape[:2], N), dtype=C128, device=self.dev)
        bins[..., 1:C // 2 + 1] = sym[..., :C // 2]
        bins[..., N - C // 2:] = sym[..., C // 2:]
        x = self._ifft(bins)
        if self.s.get("cfr"):
            clip, err_clip = self.s["cfr"]
            # one iteration (ODR-DabMod src/OfdmGenerator.cpp:310-373)
            y = self._fft(self._clip(x, clip)) / N
            e = self._clip(bins - y, err_clip)
            x = self._ifft(y + e)
        return x

    def gain(self, x):
        """Per-symbol gain, gainmode=var (ODR-DabMod src/GainControl.cpp):
        32767 / (normalise_variance * the larger of the I and Q standard
        deviations), 1 where that is below 1; the NULL symbol takes
        symbol 1's; times the sink's output scale."""
        var_k = self.s.get("normalise_variance", 4.0)
        sd = torch.maximum(x.real.std(-1, unbiased=False),
                           x.imag.std(-1, unbiased=False)) * var_k
        g = torch.where(torch.floor(sd) == 0, 1.0, 32767.0 / sd)
        g = torch.cat([g[:, 1:2], g[:, 1:]], 1)
        return g * self.s["normalise"]

    def guard_interval(self, x, g):
        """[B, S, N] symbols and [B, S] gains -> [B, tf_samples]: cyclic
        prefix; with an overlap ov, each symbol's cyclic extension (the
        prefix, ov samples earlier, and a suffix of ov samples) is shaped
        by a raised-cosine edge of 2 ov samples and added over its
        neighbours (ODR-DabMod src/GuardIntervalInserter.cpp:96-318; the
        NULL symbol has no rising edge, the last symbol no falling one)."""
        m = self.m
        B, S, N = x.shape
        x = x * g[..., None]
        ov = self.s.get("window", 0)
        out = torch.zeros((B, m.tf_samples + ov), dtype=C128, device=self.dev)
        win = torch.as_tensor(0.5 * (1 - np.cos(
            np.pi * np.arange(2 * ov) / (2 * ov - 1))).astype(np.float32),
            dtype=F64, device=self.dev)
        for s in range(S):
            size = m.null_size if s == 0 else m.sym_size
            start = 0 if s == 0 else m.null_size + (s - 1) * m.sym_size
            pre = size - N
            lead = ov if (ov and s > 0) else 0
            tail = ov if (ov and s < S - 1) else 0
            # cyclic extension: indices pre + lead before the body starts,
            # tail after its end
            idx = (torch.arange(-pre - lead, N + tail, device=self.dev)) % N
            seg = x[:, s, idx]
            w = torch.ones(seg.shape[-1], dtype=F64, device=self.dev)
            if ov:
                if lead:
                    w[:2 * ov] = win
                if tail:
                    w[-2 * ov:] = win.flip(0)
            out[:, start - lead:start + size + tail] += seg * w
        return out[:, :m.tf_samples]

    def fir_filter(self, x):
        """out[n] = sum_j x[n + j] taps[j], zero past the TF's end
        (ODR-DabMod src/FIRFilter.cpp)."""
        taps = self.fir
        n = x.shape[-1]
        xp = torch.cat([x, x.new_zeros((*x.shape[:-1], taps.numel()))], -1)
        w = self._operand(taps)
        xp = self._operand(xp)
        y = torch.zeros_like(x)
        for j in range(taps.numel()):
            y = y + xp[..., j:j + n] * w[j]
        return self._stage(y)

    def resample(self, x, hist):
        """Polyphase L/M interpolation of one TF's samples [n] with the
        2*half input samples before them: y[j] = sum_i xp[i] h[jM - (i -
        half) L + half L], xp = [hist, x] (the output lags by half input
        samples)."""
        L, M, half, h = self.res
        xp = self._operand(torch.cat([hist, x]))
        n_out = x.numel() * L // M
        j = torch.arange(n_out, device=self.dev)
        q, phi = (j * M) // L, (j * M) % L
        taps = torch.arange(2 * half + 1, device=self.dev)
        t = phi[:, None] + (2 * half - taps[None]) * L      # [n_out, 2h+1]
        hp = torch.cat([self._operand(h), h.new_zeros(L)])
        w = hp[t]
        y = (xp[q[:, None] + taps[None]] * w).sum(-1)
        return self._stage(y)

    def dpd(self, x):
        """ODR-DabMod's polynomial predistorter (src/MemlessPoly.cpp):
        AM/AM and AM/PM odd polynomials of |x|^2, the rotation by its own
        series of the phase."""
        am, pm = (torch.as_tensor(np.asarray(c, np.float32), dtype=F64,
                                  device=self.dev) for c in self.s["poly"])
        mag = x.real ** 2 + x.imag ** 2
        a = am[0] + mag * (am[1] + mag * (am[2] + mag * (am[3]
                                                          + mag * am[4])))
        p = -(pm[0] + mag * (pm[1] + mag * (pm[2] + mag * (pm[3]
                                                            + mag * pm[4]))))
        p2 = p * p
        rot = torch.complex(
            1.0 - p2 * (-0.5 + p2 * (0.486666 + p2 * (-0.00138888))),
            p * (1.0 + p2 * (0.166666 + p2 * 0.00833333)))
        return self._stage(x * a * rot)

    def wire(self, x):
        """[n] complex -> wire samples [n, 2]: int16 saturated and
        truncated toward zero (src/FormatConverter.cpp), or float32."""
        pairs = torch.stack([x.real, x.imag], -1)
        if self.s["wire"] == "s16":
            return torch.trunc(pairs.clamp(-32768.0, 32767.0)).to(torch.int16)
        return pairs.to(torch.float32)

    def render(self, frames: np.ndarray, first_tf: int, keep: int = 1):
        """Wire samples [keep, n, 2] of the last `keep` TFs of `frames`
        (whole TFs, the first being TF `first_tf` of the stream)."""
        with torch.no_grad():
            z, null = self.carriers(frames, first_tf)
            B = z.shape[0]
            # the resampler's history needs the TF before the first kept
            lo = max(0, B - keep - (1 if self.res is not None else 0))
            x = self.ofdm(z[lo:], null[lo:])
            sig = self.guard_interval(x, self.gain(x))
            if self.fir is not None:
                sig = torch.complex(self.fir_filter(sig.real),
                                    self.fir_filter(sig.imag))
            outs = []
            for b in range(sig.shape[0] - keep, sig.shape[0]):
                s = sig[b]
                if self.res is not None:
                    half = self.res[2]
                    if b > 0:
                        hist = sig[b - 1, -2 * half:]
                    else:
                        # TF 0 of the stream starts from zeros; a run that
                        # starts later starts one TF earlier than kept
                        assert first_tf + lo == 0
                        hist = s.new_zeros(2 * half)
                    s = torch.complex(self.resample(s.real, hist.real),
                                      self.resample(s.imag, hist.imag))
                if self.s.get("poly") is not None:
                    s = self.dpd(s)
                outs.append(self.wire(s))
            return torch.stack(outs)
