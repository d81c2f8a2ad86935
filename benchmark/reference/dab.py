"""Constants and tables of the EN 300 401 transmit chain for the plain
reference, built with NumPy from the standard's definitions (and, where the
upstream modulator ODR-DabMod fixes a choice, from its sources, named at
each table).  Nothing here reads the program under test."""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from .uep_rules import UEP_RULES, UEP_SUBCH_CU

ETI_FRAME = 6144


@dataclasses.dataclass(frozen=True)
class Mode:
    nb_symbols: int      # symbols a TF after the NULL symbol (phase ref incl.)
    nb_carriers: int
    spacing: int         # transform size
    null_size: int
    sym_size: int
    fic_bytes_out: int   # punctured FIC bytes a CIF
    cif_count: int       # CIFs (ETI frames) a transmission frame
    fic_bytes_in: int    # FIC bytes an ETI frame
    beta: int            # frequency interleaver's increment

    @property
    def tf_samples(self) -> int:
        return self.null_size + self.nb_symbols * self.sym_size


# EN 300 401 Tables 38 and 39 (ODR-DabMod src/DabModulator.cpp:84-122)
MODES = {1: Mode(76, 1536, 2048, 2656, 2552, 288, 4, 96, 511),
         2: Mode(76, 384, 512, 664, 638, 288, 1, 96, 127),
         3: Mode(153, 192, 256, 345, 319, 384, 1, 128, 63),
         4: Mode(76, 768, 1024, 1328, 1276, 288, 2, 96, 255)}

CIF_BITS = 864 * 64

# the output scale of each sink (ODR-DabMod src/DabMod.cpp:68-83, 250-363)
NORMALISE_SDR = 50000.0


def prbs(n_bytes: int) -> np.ndarray:
    """Energy-dispersal PRBS x^9 + x^5 + 1 from the all-ones state, as bits
    (EN 300 401 clause 10.2)."""
    reg = [1] * 9
    out = np.empty(n_bytes * 8, np.uint8)
    for i in range(out.size):
        b = reg[8] ^ reg[4]
        out[i] = b
        reg = [b] + reg[:8]
    return out


# K=7 convolutional code, generators 133, 171, 145, 133 (octal): the input
# delays each output bit XORs (EN 300 401 clause 11.1.1)
CONV_DELAYS = ((0, 2, 3, 5, 6), (0, 1, 2, 3, 6), (0, 1, 4, 6), (0, 2, 3, 5, 6))

# the 16 CIF delays of the time interleaver, by bit index mod 16
# (EN 300 401 Table 21)
TI_DELAYS = np.array([0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15])

TAIL_PATTERN = 0xCCCCCC      # 24 tail bits, puncturing vector V_T


def fic_rules(mid: int):
    """FIC puncturing (EN 300 401 clause 11.2; src/FicSource.cpp:38-61)."""
    if mid == 3:
        return [(29 * 16, 0xEEEEEEEE), (3 * 16, 0xEEEEEEEC)]
    return [(21 * 16, 0xEEEEEEEE), (3 * 16, 0xEEEEEEEC)]


def subchannel_rules(bitrate: int, tpl: int):
    """Puncturing rules and size in CUs of a sub-channel from its TPL field
    (EN 300 401 clauses 11.3.1-11.3.2; src/SubchannelSource.cpp)."""
    if (tpl >> 5) & 1:                               # long form, EEP
        option, lvl = (tpl >> 2) & 0x7, (tpl & 0x3) + 1
        br = bitrate
        if option == 0:                              # EEP-A
            cu = (br // 8) * (12, 8, 6, 4)[lvl - 1]
            if lvl == 1:
                rules = [((6 * br // 8 - 3) * 16, 0xFFFFFFFF),
                         (3 * 16, 0xFFFFFFFE)]
            elif lvl == 2 and br == 8:
                rules = [(5 * 16, 0xEEECECEC), (1 * 16, 0xECECECEC)]
            elif lvl == 2:
                rules = [((2 * br // 8 - 3) * 16, 0xEEECEEEC),
                         ((4 * br // 8 + 3) * 16, 0xEEECECEC)]
            elif lvl == 3:
                rules = [((6 * br // 8 - 3) * 16, 0xCCCCCCCC),
                         (3 * 16, 0xCCCCCCC8)]
            else:
                rules = [((4 * br // 8 - 3) * 16, 0xC8C8C888),
                         ((2 * br // 8 + 3) * 16, 0xC888C888)]
        else:                                        # EEP-B
            cu = (br // 32) * (27, 21, 18, 15)[lvl - 1]
            a, b = {1: (0xECCCECCC, 0xECCCCCCC), 2: (0xCCC8CCC8, 0xCCC8C8C8),
                    3: (0xC8C8C8C8, 0xC8C8C888),
                    4: (0xC888C888, 0xC8888888)}[lvl]
            rules = [((24 * br // 32 - 3) * 16, a), (3 * 16, b)]
        return rules, cu
    key = (bitrate, (tpl & 0x7) + 1)                 # short form, UEP
    return UEP_RULES[key], UEP_SUBCH_CU[key]


def puncture_mask(rules, n_bits_in: int) -> np.ndarray:
    """Which of the 4 * (n_bits_in + 6) mother-code bits survive: each rule
    (length, pattern) applies its 32-bit pattern to length / 4 words of
    32 bits in turn, cycling through the rules; the 24 tail bits take the
    tail pattern (EN 300 401 clause 11.1.2)."""
    body = 4 * n_bits_in
    mask = np.zeros(body + 24, bool)
    pos, ri = 0, 0
    while pos < body:
        length, pattern = rules[ri % len(rules)]
        word = [(pattern >> (31 - i)) & 1 for i in range(32)]
        for _ in range(length // 4):
            mask[pos:pos + 32] = word
            pos += 32
        ri += 1
    mask[body:] = [(TAIL_PATTERN >> (23 - i)) & 1 for i in range(24)]
    return mask


@lru_cache(maxsize=None)
def freq_interleaver(mode: int) -> np.ndarray:
    """perm[n] = the carrier (0..K-1, positive frequencies first, as the
    carrier vector is laid out) that the n-th QPSK symbol of a symbol goes
    to (EN 300 401 clause 14.6)."""
    m = MODES[mode]
    n_fft, k = m.spacing, m.nb_carriers
    out, pi = [], 0
    for _ in range(1, n_fft):
        pi = (13 * pi + m.beta) % n_fft
        if (n_fft - k) // 2 <= pi <= n_fft - (n_fft - k) // 2 \
                and pi != n_fft // 2:
            # frequency index pi - N/2 in -K/2..K/2; carrier vector slot:
            # k = 1..K/2 -> k - 1, k = -K/2..-1 -> K + k
            f = pi - n_fft // 2
            out.append(f - 1 if f > 0 else k + f)
    assert len(out) == k
    return np.array(out)


# Phase reference symbol (EN 300 401 clause 14.3.2, Tables 43-47)
_H = np.array([
    [0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1] * 2,
    [0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0] * 2,
    [0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3] * 2,
    [0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2] * 2])
_PHASE_GROUPS = {
    1: [(0, 3), (3, 1), (2, 1), (1, 1), (0, 2), (3, 2), (2, 1), (1, 0),
        (0, 2), (3, 2), (2, 3), (1, 3), (0, 0), (3, 2), (2, 1), (1, 3),
        (0, 3), (3, 3), (2, 3), (1, 0), (0, 3), (3, 0), (2, 1), (1, 1),
        (0, 1), (1, 2), (2, 0), (3, 1), (0, 3), (1, 2), (2, 2), (3, 3),
        (0, 2), (1, 1), (2, 2), (3, 3), (0, 1), (1, 2), (2, 3), (3, 3),
        (0, 2), (1, 2), (2, 2), (3, 1), (0, 1), (1, 3), (2, 1), (3, 2)],
}


def phase_reference(mode: int) -> np.ndarray:
    """z_{l=1} on the carrier vector (positive frequencies 1..K/2, then
    -K/2..-1), complex128: exp(i pi/2 (h + n)) per 32-carrier group."""
    groups = _PHASE_GROUPS[mode]
    q = np.concatenate([(_H[i] + n) % 4 for i, n in groups])
    return np.exp(0.5j * np.pi * q)


def tii_null_symbol(mode: int, comb: int, pattern: int) -> np.ndarray:
    """The NULL symbol's carrier vector with TII (EN 300 401 clause 14.8,
    TM I), as ODR-DabMod's src/TII.cpp builds it in its standard variant:
    for carrier k of comb c and pattern p, index ix = K/2 + k (- 1 for
    k > 0) of the vector and the one after it both take the phase
    reference's value at ix (the index is taken as is into the carrier
    vector that the OFDM generator reads)."""
    assert mode == 1
    k_car = MODES[mode].nb_carriers
    pats = sorted(v for v in range(256) if bin(v).count("1") == 4)
    bits = [(pats[pattern] >> (7 - b)) & 1 for b in range(8)]
    ref = phase_reference(mode)
    out = np.zeros(k_car, complex)
    for base in (-768, -384, 1, 385):
        for b in range(8):
            k = base + 2 * comb + 48 * b
            if base <= k < base + 384 and bits[b]:
                ix = k_car // 2 + k + (-1 if k >= 0 else 0)
                out[ix] = ref[ix]
                out[ix + 1] = ref[ix]
    return out


# ODR-DabMod's default FIR (src/FIRFilter.cpp:50-71): low-pass, gain 1,
# fs 2.048 MHz, cutoff 810 kHz, transition 250 kHz
DEFAULT_FIR_TAPS = np.array([
    -0.00110450468492, 0.00120703084394, -0.000840645749122,
    -0.000187368263141, 0.00184351124335, -0.00355578539893,
    0.00419321097434, -0.00254214904271, -0.00183473504148,
    0.00781436730176, -0.0125957569107, 0.0126200336963, -0.00537294941023,
    -0.00866683479398, 0.0249746385962, -0.0356550291181, 0.0319730602205,
    -0.00795613788068, -0.0363943465054, 0.0938014090061, -0.151176810265,
    0.193567320704, 0.791776955128, 0.193567320704, -0.151176810265,
    0.0938014090061, -0.0363943465054, -0.00795613788068, 0.0319730602205,
    -0.0356550291181, 0.0249746385962, -0.00866683479398, -0.00537294941023,
    0.0126200336963, -0.0125957569107, 0.00781436730176, -0.00183473504148,
    -0.00254214904271, 0.00419321097434, -0.00355578539893, 0.00184351124335,
    -0.000187368263141, -0.000840645749122, 0.00120703084394,
    -0.00110450468492], dtype=np.float32)


def polyphase_prototype(rate_in: int, rate_out: int, atten_db: float = 120.0):
    """(L, M, half, h) of the Kaiser-windowed sinc interpolator the port's
    configuration names for rate conversion (a design of its own: the
    upstream modulator resamples in the frequency domain):
    cutoff min(1, L/M) of the input Nyquist, transition half of it,
    `atten_db` of stopband, each phase's DC gain normalised to the mean.
    h has 2 * half * L + 1 taps, centred."""
    g = int(np.gcd(rate_in, rate_out))
    L, M = rate_out // g, rate_in // g
    cut = min(1.0, L / M)
    d_omega = 0.5 * cut * np.pi / L
    n_total = int(np.ceil((atten_db - 7.95) / (2.285 * d_omega)))
    half = int(np.ceil(n_total / (2 * L)))
    beta = 0.1102 * (atten_db - 8.7)
    t = np.arange(-half * L, half * L + 1, dtype=np.float64)
    h = cut * np.sinc(cut * t / L) * np.i0(beta * np.sqrt(np.maximum(
        0.0, 1.0 - (t / (half * L)) ** 2))) / np.i0(beta)
    gain = 1.0 if L >= M else L / M
    phase_dc = [h[(r + half * L) % L::L].sum() for r in range(L)]
    h = h * (gain / np.mean(phase_dc))
    # the program holds the taps in float32
    return L, M, half, h.astype(np.float32).astype(np.float64)
