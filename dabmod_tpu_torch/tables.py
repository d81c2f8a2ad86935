"""Static tables of the ETSI EN 300 401 transmit chain (host-side NumPy).

The port's own copy of the parts of dabmod_tpu/tables.py that the modulator
reads; tests/test_torch_tables.py holds every function here equal to the
original.  Everything runs once per configuration; the modulator turns the
results into tensors on its device.  Conventions, as in the reference
modulator (ODR-DabMod):

* byte streams are unpacked MSB-first into {0,1} bit arrays;
* the FEC chain (PRBS -> convolutional code -> puncturing -> time
  interleaving -> CIF multiplexing) is linear over GF(2), so every stage is
  a static slice / XOR table computed here;
* the OFDM chain works in phase-index domain: every constellation point is
  an eighth-turn phasor exp(i*pi/4*q), so pi/4-DQPSK is an exact integer
  cumulative sum.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from .uep_tables import UEP_RULES, UEP_SUBCH_CU

# ---------------------------------------------------------------------------
# Transmission mode constants (ref: src/DabModulator.cpp:84-122,
# src/BlockPartitioner.cpp:44-73, src/FrequencyInterleaver.cpp:41-66)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModeParams:
    mode: int
    nb_symbols: int      # data symbols per TF, incl. phase reference
    nb_carriers: int
    spacing: int         # IFFT size
    null_size: int
    sym_size: int
    fic_size_out: int    # punctured FIC bytes per CIF
    cif_count: int       # CIFs per transmission frame
    fic_size_in: int     # FIC input bytes per ETI frame

    @property
    def data_symbols(self) -> int:
        """Symbols carrying MSC/FIC data (excludes phase reference)."""
        return self.nb_symbols - 1

    @property
    def tf_samples(self) -> int:
        """Baseband samples per transmission frame at native rate."""
        return self.null_size + self.nb_symbols * self.sym_size


MODES = {
    1: ModeParams(1, 76, 1536, 2048, 2656, 2552, 288, 4, 96),
    2: ModeParams(2, 76, 384, 512, 664, 638, 288, 1, 96),
    3: ModeParams(3, 153, 192, 256, 345, 319, 384, 1, 128),
    4: ModeParams(4, 76, 768, 1024, 1328, 1276, 288, 2, 96),
}

CIF_BYTES = 864 * 8          # one CIF = 864 capacity units of 64 bits
CIF_BITS = CIF_BYTES * 8


def mode_params(mode: int) -> ModeParams:
    if mode == 0:
        mode = 4
    return MODES[mode]


# ---------------------------------------------------------------------------
# PRBS energy dispersal (ref: src/PrbsGenerator.cpp:109-170)
# polynomial x^9 + x^5 + 1 (0x110), all-ones init
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def prbs_bytes(length: int, polynomial: int = 0x110) -> np.ndarray:
    """The energy-dispersal PRBS byte sequence of a given frame length."""
    # init: smallest all-ones word >= polynomial (9 ones for 0x110)
    accum = 0
    while accum < polynomial:
        accum = (accum << 1) | 1
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        for _ in range(8):
            bit = bin(accum & polynomial).count("1") & 1
            accum = ((accum << 1) & 0xFFFFFFFF) ^ bit
        out[i] = accum & 0xFF
    return out


@lru_cache(maxsize=None)
def prbs_bits(length_bytes: int) -> np.ndarray:
    return np.unpackbits(prbs_bytes(length_bytes))


# ---------------------------------------------------------------------------
# Convolutional encoder, K=7 rate 1/4 (ref: src/ConvEncoder.cpp:59-150)
# Generators 133,171,145,133 (octal); MSB-first bit streams; 6 zero tail bits.
# ---------------------------------------------------------------------------

# tap delay sets per output stream p (delay 0 = current input bit)
CONV_TAPS = (
    (0, 2, 3, 5, 6),     # 0o133
    (0, 1, 2, 3, 6),     # 0o171
    (0, 1, 4, 6),        # 0o145
    (0, 2, 3, 5, 6),     # 0o133
)


# ---------------------------------------------------------------------------
# Puncturing (ref: src/PuncturingEncoder.cpp:102-210)
# ---------------------------------------------------------------------------

TAIL_RULE = (3, 0xCCCCCC)    # 24-bit pattern over the 3 tail bytes


def _pattern_bits(pattern: int, width: int) -> np.ndarray:
    return np.array([(pattern >> (width - 1 - i)) & 1 for i in range(width)],
                    dtype=bool)


def puncture_plan(rules, in_bytes: int,
                  out_bytes_expected: int | None = None):
    """Region-structured puncturing plan: (regions, pad_bits, out_bytes).

    Each region is (bit_start, n_words, width, cols): within the region the
    same `width`-bit pattern applies to every word, keeping the columns in
    `cols`.  Consecutive same-pattern rule applications are merged.  The
    kept bits are packed MSB-first, then zero-padded to whole bytes (and to
    the UEP +1 padding byte, EN 300 401 Table 31 / ref
    src/PuncturingEncoder.cpp:118-131).
    """
    body_bits = (in_bytes - TAIL_RULE[0]) * 8
    regions = []            # [bit_start, n_words, width, cols]
    kept_total = 0
    pos = 0
    ri = 0
    while pos < body_bits:
        length, pattern = rules[ri % len(rules)]
        cols = tuple(np.nonzero(_pattern_bits(pattern, 32))[0].tolist())
        n_words = length // 4
        if pos + n_words * 32 > body_bits:
            raise ValueError("puncturing rules do not tile the frame")
        if regions and regions[-1][3] == cols \
                and regions[-1][0] + regions[-1][1] * 32 == pos:
            regions[-1][1] += n_words
        else:
            regions.append([pos, n_words, 32, cols])
        kept_total += n_words * len(cols)
        pos += n_words * 32
        ri += 1
    tail_cols = tuple(np.nonzero(_pattern_bits(TAIL_RULE[1], 24))[0].tolist())
    regions.append([body_bits, 1, 24, tail_cols])
    kept_total += len(tail_cols)

    out_bytes = (kept_total + 7) // 8
    if out_bytes_expected is not None:
        if out_bytes_expected == out_bytes + 1:
            out_bytes = out_bytes_expected    # UEP padding byte
        if out_bytes_expected != out_bytes:
            raise ValueError(
                f"puncturing mismatch: expected {out_bytes_expected} bytes, "
                f"got {out_bytes}")
    pad_bits = out_bytes * 8 - kept_total
    return tuple(tuple(r[:3]) + (r[3],) for r in regions), pad_bits, out_bytes


# ---------------------------------------------------------------------------
# FIC and sub-channel protection profiles
# (ref: src/FicSource.cpp:38-61, src/SubchannelSource.cpp)
# ---------------------------------------------------------------------------


def fic_rules(mid: int):
    if mid == 3:
        return [(29 * 16, 0xEEEEEEEE), (3 * 16, 0xEEEEEEEC)]
    return [(21 * 16, 0xEEEEEEEE), (3 * 16, 0xEEEEEEEC)]


@dataclasses.dataclass(frozen=True)
class SubchannelParams:
    start_address: int       # in capacity units
    framesize: int           # input bytes per ETI frame (= STL * 8)
    tpl: int

    @property
    def bitrate(self) -> int:
        return self.framesize // 3

    @property
    def protection_form(self) -> int:
        return (self.tpl >> 5) & 1

    @property
    def protection_level(self) -> int:
        if self.protection_form:
            return (self.tpl & 0x3) + 1
        return (self.tpl & 0x7) + 1

    @property
    def protection_option(self) -> int:
        if self.protection_form:
            return (self.tpl >> 2) & 0x7
        return 0

    def rules(self):
        """Puncturing rule list (ref: src/SubchannelSource.cpp:84-163 EEP,
        :165-958 UEP)."""
        br = self.bitrate
        if self.protection_form:  # long form (EEP)
            lvl = self.protection_level
            if self.protection_option == 0:  # EEP-A
                if lvl == 1:
                    return [((6 * br // 8 - 3) * 16, 0xFFFFFFFF),
                            (3 * 16, 0xFFFFFFFE)]
                if lvl == 2:
                    if br == 8:
                        return [(5 * 16, 0xEEECECEC), (1 * 16, 0xECECECEC)]
                    return [((2 * br // 8 - 3) * 16, 0xEEECEEEC),
                            ((4 * br // 8 + 3) * 16, 0xEEECECEC)]
                if lvl == 3:
                    return [((6 * br // 8 - 3) * 16, 0xCCCCCCCC),
                            (3 * 16, 0xCCCCCCC8)]
                if lvl == 4:
                    return [((4 * br // 8 - 3) * 16, 0xC8C8C888),
                            ((2 * br // 8 + 3) * 16, 0xC888C888)]
            elif self.protection_option == 1:  # EEP-B
                pats = {1: (0xECCCECCC, 0xECCCCCCC),
                        2: (0xCCC8CCC8, 0xCCC8C8C8),
                        3: (0xC8C8C8C8, 0xC8C8C888),
                        4: (0xC888C888, 0xC8888888)}
                if lvl in pats:
                    a, b = pats[lvl]
                    return [((24 * br // 32 - 3) * 16, a), (3 * 16, b)]
            raise ValueError(f"unsupported EEP profile tpl=0x{self.tpl:x}")
        # short form (UEP)
        key = (br, self.protection_level)
        if key not in UEP_RULES:
            raise ValueError(f"unsupported UEP profile {key}")
        return UEP_RULES[key]

    @property
    def framesize_cu(self) -> int:
        """Sub-channel size in capacity units (EN 300 401 Table 7/8;
        ref: src/SubchannelSource.cpp:657-1010)."""
        br = self.bitrate
        if self.protection_form:
            lvl_idx = self.tpl & 0x3
            if self.protection_option == 0:
                cu = (br // 8) * (12, 8, 6, 4)[lvl_idx]
            else:
                cu = (br // 32) * (27, 21, 18, 15)[lvl_idx]
            if cu == 0:
                # EEP-B below 32 kbit/s computes zero CUs; the reference
                # rejects it ("protection not yet coded",
                # src/SubchannelSource.cpp framesizeCu)
                raise ValueError(
                    f"unsupported EEP profile tpl=0x{self.tpl:x} "
                    f"at {br} kbit/s")
            return cu
        key = (br, self.protection_level)
        if key not in UEP_SUBCH_CU:
            raise ValueError(f"unsupported UEP profile {key}")
        return UEP_SUBCH_CU[key]


# ---------------------------------------------------------------------------
# Time interleaving (ref: src/TimeInterleaver.cpp:66-92)
# bit b of byte j is taken from the CIF `delay` frames ago, where delay
# depends on (bit position, byte parity).
# ---------------------------------------------------------------------------

TI_DELAYS_EVEN = np.array([0, 8, 4, 12, 2, 10, 6, 14], dtype=np.int32)


def time_interleave_delays(n_bits: int) -> np.ndarray:
    """Per-bit CIF delay vector for a sub-channel frame of n_bits bits."""
    b = np.arange(n_bits, dtype=np.int32)
    byte = b // 8
    return TI_DELAYS_EVEN[b % 8] + (byte & 1)


def time_interleave_masks(n_bits: int) -> np.ndarray:
    """[16, n_bits] one-hot delay masks (int32).  The modulator reads only
    the shape: ops.fec.time_interleave applies the delay rule directly."""
    delays = time_interleave_delays(n_bits)
    masks = np.zeros((16, n_bits), np.int32)
    masks[delays, np.arange(n_bits)] = 1
    return masks


# ---------------------------------------------------------------------------
# Frequency interleaving (ref: src/FrequencyInterleaver.cpp:31-93)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def freq_interleave_indices(mode: int) -> np.ndarray:
    """indices[j] = output carrier position of input element j (scatter)."""
    p = mode_params(mode)
    num = p.spacing
    carriers = p.nb_carriers
    beta = {1: 511, 2: 127, 3: 63, 4: 255, 0: 255}[mode]
    indices = np.empty(carriers, dtype=np.int32)
    perm = 0
    n = 0
    for _ in range(1, num):
        perm = (13 * perm + beta) & (num - 1)
        if (perm >= (num - carriers) // 2 and perm <= num - (num - carriers) // 2
                and perm != num // 2):
            indices[n] = perm - (1 + num // 2) if perm > num // 2 \
                else perm + (carriers - num // 2)
            n += 1
    assert n == carriers
    return indices


@lru_cache(maxsize=None)
def freq_interleave_inverse(mode: int) -> np.ndarray:
    """inv[k] such that out[k] = in[inv[k]] implements the scatter."""
    idx = freq_interleave_indices(mode)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(idx.size, dtype=np.int32)
    return inv


# ---------------------------------------------------------------------------
# Phase reference symbol (ref: src/PhaseReference.cpp:35-171,
# EN 300 401 Tables 43-47).  Values are quarter-turn phasors i^h; we store
# eighth-turn phase indices (2*h mod 8) for the phase-domain pipeline.
# ---------------------------------------------------------------------------

_PHASE_H = np.array([
    [0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1,
     0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1],
    [0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0,
     0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0],
    [0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3,
     0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3],
    [0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2,
     0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2],
], dtype=np.int32)

# (i, n) per 32-carrier group, EN 300 401 Tables 44-47, positive-frequency
# groups first, then negative (the reference's carrier ordering)
_PHASE_TABLE = {
    0: [(0, 0), (3, 1), (2, 0), (1, 2), (0, 0), (3, 1),
        (2, 2), (1, 2), (0, 2), (3, 1), (2, 3), (1, 0),
        (0, 0), (1, 1), (2, 1), (3, 2), (0, 2), (1, 2),
        (2, 0), (3, 3), (0, 3), (1, 1), (2, 3), (3, 2)],
    1: [(0, 3), (3, 1), (2, 1), (1, 1), (0, 2), (3, 2),
        (2, 1), (1, 0), (0, 2), (3, 2), (2, 3), (1, 3),
        (0, 0), (3, 2), (2, 1), (1, 3), (0, 3), (3, 3),
        (2, 3), (1, 0), (0, 3), (3, 0), (2, 1), (1, 1),
        (0, 1), (1, 2), (2, 0), (3, 1), (0, 3), (1, 2),
        (2, 2), (3, 3), (0, 2), (1, 1), (2, 2), (3, 3),
        (0, 1), (1, 2), (2, 3), (3, 3), (0, 2), (1, 2),
        (2, 2), (3, 1), (0, 1), (1, 3), (2, 1), (3, 2)],
    2: [(2, 0), (1, 2), (0, 2), (3, 1), (2, 0), (1, 3),
        (0, 2), (1, 3), (2, 2), (3, 2), (0, 1), (1, 2)],
    3: [(3, 2), (2, 2), (1, 2), (0, 2), (1, 3), (2, 0)],
}


@lru_cache(maxsize=None)
def phase_ref_quarters(mode: int) -> np.ndarray:
    """Phase reference as quarter-turn indices (value = i^q), length carriers.

    Index 0..C/2-1 hold positive frequencies k=1..C/2 and C/2..C-1 hold
    negative k=-C/2..-1 in the reference's carrier ordering
    (src/PhaseReference.cpp:152-171, src/OfdmGenerator.cpp:77-103).
    """
    p = mode_params(mode)
    tab = _PHASE_TABLE[0 if mode in (0, 4) else mode]
    out = np.empty(p.nb_carriers, dtype=np.int32)
    pos = 0
    for (i, n) in tab:
        out[pos:pos + 32] = (_PHASE_H[i] + n) % 4
        pos += 32
    assert pos == p.nb_carriers
    return out


def phase_ref_eighths(mode: int) -> np.ndarray:
    """Phase reference in eighth-turn units (for the DQPSK phase domain)."""
    return (2 * phase_ref_quarters(mode)) % 8


# eighth-turn phasors exp(i*pi/4*q), exact values to keep +/-1 and
# +/-sqrt(1/2) bit-clean
_s = np.float32(np.sqrt(0.5))
PHASE_LUT = np.array([1, _s + 1j * _s, 1j, -_s + 1j * _s,
                      -1, -_s - 1j * _s, -1j, _s - 1j * _s], dtype=np.complex64)


def phase_ref_complex(mode: int) -> np.ndarray:
    return PHASE_LUT[phase_ref_eighths(mode)]


# ---------------------------------------------------------------------------
# TII (ref: src/TII.cpp:30-337).  Carrier mask A_{c,p} plus the "write to
# k and k+1" doubling; returns a phase mask usable with the phase reference.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def tii_patterns() -> np.ndarray:
    """All 70 TII patterns: 8-bit vectors with exactly four ones, ordered by
    ascending integer value of the MSB-first bit string (EN 300 401 Table
    keyed identically in the reference)."""
    vals = [v for v in range(256) if bin(v).count("1") == 4]
    vals.sort()
    out = np.zeros((len(vals), 8), dtype=np.int32)
    for i, v in enumerate(vals):
        for b in range(8):
            out[i, b] = (v >> (7 - b)) & 1
    return out


def _tii_enable_carrier(acp: np.ndarray, carriers: int, k: int):
    ix = carriers // 2 + k + (-1 if k >= 0 else 0)
    if ix < 0 or ix + 1 >= carriers:
        raise ValueError("TII carrier out of range")
    acp[ix] = True


@lru_cache(maxsize=None)
def tii_acp(mode: int, comb: int, pattern: int) -> np.ndarray:
    """A_{c,p} boolean carrier mask in the internal carrier ordering."""
    if mode not in (1, 2):
        raise ValueError(f"TII unsupported in mode {mode}")
    if not (0 <= comb <= 23 and 0 <= pattern <= 69):
        raise ValueError("invalid TII comb/pattern")
    p = mode_params(mode)
    pat = tii_patterns()[pattern]
    acp = np.zeros(p.nb_carriers, dtype=bool)
    if mode == 1:
        for base in (-768, -384):
            for b in range(8):
                k = base + 2 * comb + 48 * b
                if base <= k < base + 384 and pat[b]:
                    _tii_enable_carrier(acp, p.nb_carriers, k)
        for base in (1, 385):
            for b in range(8):
                k = base + 2 * comb + 48 * b
                if base <= k < base + 384 and pat[b]:
                    _tii_enable_carrier(acp, p.nb_carriers, k)
    else:  # mode 2
        for b in range(4):
            k = -192 + 2 * comb + 48 * b
            if -192 <= k <= 192 and pat[b]:
                _tii_enable_carrier(acp, p.nb_carriers, k)
        for b in range(4, 8):
            k = -191 + 2 * comb + 48 * b
            if -192 <= k <= 192 and pat[b]:
                _tii_enable_carrier(acp, p.nb_carriers, k)
    return acp


def tii_symbol(mode: int, comb: int, pattern: int,
               old_variant: bool = False) -> np.ndarray:
    """The TII null-symbol carrier vector (complex64)."""
    p = mode_params(mode)
    ref = phase_ref_complex(mode)
    acp = tii_acp(mode, comb, pattern)
    out = np.zeros(p.nb_carriers, dtype=np.complex64)
    for i in range(p.nb_carriers):
        if acp[i]:
            out[i] = ref[i]
            out[i + 1] = ref[i + 1] if old_variant else ref[i]
    return out


# ---------------------------------------------------------------------------
# OFDM carrier-to-bin mapping (ref: src/OfdmGenerator.cpp:77-103, inverse
# direction): fft_in[0]=0; positive freqs 1..C/2 <- carriers[0:C/2];
# negative freqs spacing-C/2.. <- carriers[C/2:].
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def bin_map(mode: int):
    """Returns (src_idx, valid) of length `spacing`:
    fft_in[b] = carriers[src_idx[b]] * valid[b]."""
    p = mode_params(mode)
    c, n = p.nb_carriers, p.spacing
    src = np.zeros(n, dtype=np.int32)
    valid = np.zeros(n, dtype=bool)
    half = c // 2
    pos_dst = 0 if (c & 1) else 1
    src[pos_dst:pos_dst + (c + 1) // 2] = np.arange((c + 1) // 2)
    valid[pos_dst:pos_dst + (c + 1) // 2] = True
    src[n - half:] = np.arange((c + 1) // 2, c)
    valid[n - half:] = True
    return src, valid


# ---------------------------------------------------------------------------
# Guard interval + optional raised-cosine windowing
# (ref: src/GuardIntervalInserter.cpp:96-318)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def guard_interval_tables(mode: int, window_overlap: int = 0):
    """Static overlap-add formulation of the guard-interval inserter, kept
    as the plain check of ops.ofdm.guard_interval_windowed.

    Input: flattened symbols [S, spacing] with S = nb_symbols + 1 (NULL
    first).  Output: tf_samples samples.  Returns (idx_a, w_a, idx_b, w_b)
    such that out = in_flat[idx_a]*w_a + in_flat[idx_b]*w_b, where idx
    points into the flattened input with one extra zero element appended
    at index S*spacing (used where only one term contributes).
    """
    p = mode_params(mode)
    n, null_sz, sym_sz, spacing = p.tf_samples, p.null_size, p.sym_size, p.spacing
    S = p.nb_symbols + 1
    zero = S * spacing
    idx_a = np.full(n, zero, dtype=np.int32)
    w_a = np.zeros(n, dtype=np.float32)
    idx_b = np.full(n, zero, dtype=np.int32)
    w_b = np.zeros(n, dtype=np.float32)

    def flat(sym, off):
        return sym * spacing + off

    if window_overlap == 0:
        # NULL symbol: cyclic prefix of (null_size - spacing) then full symbol
        pre = null_sz - spacing
        idx_a[:pre] = flat(0, np.arange(spacing - pre, spacing))
        idx_a[pre:null_sz] = flat(0, np.arange(spacing))
        w_a[:null_sz] = 1.0
        out = null_sz
        for s in range(1, S):
            pre = sym_sz - spacing
            idx_a[out:out + pre] = flat(s, np.arange(spacing - pre, spacing))
            idx_a[out + pre:out + sym_sz] = flat(s, np.arange(spacing))
            w_a[out:out + sym_sz] = 1.0
            out += sym_sz
        assert out == n
        return idx_a, w_a, idx_b, w_b

    ov = window_overlap
    # rising half-window w[0..2ov-1], ref formula at GuardIntervalInserter.cpp:107
    win = 0.5 * (1.0 - np.cos(np.pi * np.arange(2 * ov) / (2 * ov - 1)))
    win = win.astype(np.float32)

    # NULL symbol (no rising edge, falling edge into first data symbol)
    pre = null_sz - spacing
    idx_a[:pre] = flat(0, np.arange(spacing - pre, spacing))
    w_a[:pre] = 1.0
    idx_a[pre:pre + spacing - ov] = flat(0, np.arange(spacing - ov))
    w_a[pre:pre + spacing - ov] = 1.0
    # sloping down 1 -> 0.5 over the last ov samples of the NULL symbol
    r = np.arange(ov)
    idx_a[pre + spacing - ov:pre + spacing] = flat(0, spacing - ov + r)
    w_a[pre + spacing - ov:pre + spacing] = win[2 * ov - 1 - r]
    # cyclic suffix past the nominal end: first ov samples of the symbol,
    # weighted 0.5 -> 0; it lands on the next symbol's first ov output
    # samples, overlapping that symbol's rising edge
    suffix_idx = flat(0, r)
    suffix_w = win[ov - 1 - r]
    out = null_sz

    for s in range(1, S):
        pre = sym_sz - spacing
        # rising edge spans output [out-ov, out+ov): the first half adds to
        # the previous symbol's falling edge, the second half to its suffix
        rise_src = flat(s, 2 * spacing - sym_sz - ov + r)
        idx_b[out - ov:out] = rise_src
        w_b[out - ov:out] = win[:ov]
        # previous symbol's cyclic suffix on [out, out+ov)
        idx_b[out:out + ov] = suffix_idx
        w_b[out:out + ov] = suffix_w
        # second half of the rise on [out, out+ov)
        rise2_src = flat(s, 2 * spacing - sym_sz + r)
        idx_a[out:out + ov] = rise2_src
        w_a[out:out + ov] = win[ov:2 * ov]
        # remaining cyclic prefix at full weight
        idx_a[out + ov:out + pre] = flat(s, 2 * spacing - sym_sz + np.arange(ov, pre))
        w_a[out + ov:out + pre] = 1.0
        last = (s == S - 1)
        if last:
            idx_a[out + pre:out + sym_sz] = flat(s, np.arange(spacing))
            w_a[out + pre:out + sym_sz] = 1.0
        else:
            body = spacing - ov
            idx_a[out + pre:out + pre + body] = flat(s, np.arange(body))
            w_a[out + pre:out + pre + body] = 1.0
            # falling edge 1 -> 0.5
            idx_a[out + pre + body:out + sym_sz] = flat(s, body + r)
            w_a[out + pre + body:out + sym_sz] = win[2 * ov - 1 - r]
            # suffix for the next symbol's overlap region
            suffix_idx = flat(s, r)
            suffix_w = win[ov - 1 - r]
        out += sym_sz
    assert out == n
    return idx_a, w_a, idx_b, w_b


# ---------------------------------------------------------------------------
# Default FIR spectrum-mask filter taps (ref: src/FIRFilter.cpp:50-71):
# generated low-pass, gain 1, fs 2.048 MHz, cutoff 810 kHz, transition 250 kHz
# ---------------------------------------------------------------------------

DEFAULT_FIR_TAPS = np.array([
    -0.00110450468492, 0.00120703084394, -0.000840645749122, -0.000187368263141,
    0.00184351124335, -0.00355578539893, 0.00419321097434, -0.00254214904271,
    -0.00183473504148, 0.00781436730176, -0.0125957569107, 0.0126200336963,
    -0.00537294941023, -0.00866683479398, 0.0249746385962, -0.0356550291181,
    0.0319730602205, -0.00795613788068, -0.0363943465054, 0.0938014090061,
    -0.151176810265, 0.193567320704, 0.791776955128, 0.193567320704,
    -0.151176810265, 0.0938014090061, -0.0363943465054, -0.00795613788068,
    0.0319730602205, -0.0356550291181, 0.0249746385962, -0.00866683479398,
    -0.00537294941023, 0.0126200336963, -0.0125957569107, 0.00781436730176,
    -0.00183473504148, -0.00254214904271, 0.00419321097434, -0.00355578539893,
    0.00184351124335, -0.000187368263141, -0.000840645749122, 0.00120703084394,
    -0.00110450468492], dtype=np.float32)


# Output normalisation constants (ref: src/DabMod.cpp:68-83)
NORMALISE_FACTOR_SDR = 50000.0
NORMALISE_FACTOR_FILE_FIX = 81000.0
NORMALISE_FACTOR_FILE_VAR = 46000.0
NORMALISE_FACTOR_FILE_MAX = 46000.0
