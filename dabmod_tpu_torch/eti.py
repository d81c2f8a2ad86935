"""Batch ETI(NI) parsing and synthesis (host-side NumPy).

The port's own copy of dabmod_tpu/eti.py, with the vectorised NumPy parser
only.  The original first tries its native C++ batch parser; with the
batch made from its result (contiguous sub-channels, the raw TIST word,
MID checked) that path measured slower than this parser (PERF.md), so the
port keeps its binding (native.parse_eti_batch) out of this path.  A
whole batch of 6144-byte frames is parsed at once; the ensemble layout
(NST, sub-channel table) must be constant over a batch, and a change raises
:class:`EnsembleReconfigured` (the reference's FrameMultiplexerError restart
path, src/DabMod.cpp:726-731).  Header layouts: src/Eti.h:50-136.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .tables import SubchannelParams

ETI_NI_FRAME = 6144


class EtiError(ValueError):
    pass


class EnsembleReconfigured(EtiError):
    """Sub-channel layout changed inside a batch; pipeline must be rebuilt."""


@dataclasses.dataclass(frozen=True)
class EnsembleLayout:
    """Static per-ensemble structure extracted from the ETI headers."""
    mid: int
    nst: int
    fic_length: int                      # bytes of FIC per ETI frame
    subchannels: tuple[SubchannelParams, ...]
    scids: tuple[int, ...]

    @property
    def dab_mode(self) -> int:
        # MID 0 encodes transmission mode 4 (ref: src/DabMod.cpp uses
        # eti_fc.MID directly as dabMode, with 0 -> mode 4)
        return self.mid if self.mid != 0 else 4


@dataclasses.dataclass
class EtiFrameBatch:
    """A parsed batch of T consecutive ETI frames."""
    layout: EnsembleLayout
    fct: np.ndarray                      # [T] uint8
    fp: np.ndarray                       # [T] uint8
    mnsc: np.ndarray                     # [T] uint16 (LE read, as reference)
    tist_pps: np.ndarray                 # [T] uint32, 1/16.384MHz PPS offset
    tist_raw: np.ndarray                 # [T] uint32
    fic: np.ndarray                      # [T, fic_length] uint8
    subchannels: list[np.ndarray]        # per subch [T, framesize] uint8

    def __len__(self):
        return self.fct.shape[0]


def parse_eti_frames(raw: np.ndarray) -> EtiFrameBatch:
    """Parse [T, 6144] uint8 raw ETI(NI) frames into structured arrays."""
    if raw.ndim != 2 or raw.shape[1] != ETI_NI_FRAME:
        raise EtiError(f"expected [T, {ETI_NI_FRAME}] raw frames, got {raw.shape}")
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    T = raw.shape[0]

    # FC word, bytes 4..7 (bit-field layout per src/Eti.h:56-66 on LE hosts)
    fct = raw[:, 4].copy()
    nst = raw[:, 5] & 0x7F
    ficf = raw[:, 5] >> 7
    mid = (raw[:, 6] >> 3) & 0x3
    fp = raw[:, 6] >> 5

    if not np.all(ficf == 1):
        raise EtiError("FIC must be present to modulate")
    if not (np.all(nst == nst[0]) and np.all(mid == mid[0])):
        raise EnsembleReconfigured("NST/MID changed inside batch")
    n_st = int(nst[0])

    # STC words
    stc = raw[:, 8:8 + 4 * n_st].reshape(T, n_st, 4).astype(np.uint16)
    if n_st and not np.all(stc == stc[0]):
        raise EnsembleReconfigured("sub-channel table changed inside batch")
    subch_params = []
    scids = []
    for i in range(n_st):
        b0, b1, b2, b3 = (int(stc[0, i, k]) for k in range(4))
        sad = ((b0 & 0x3) << 8) | b1
        scid = b0 >> 2
        stl = ((b2 & 0x3) << 8) | b3
        tpl = b2 >> 2
        subch_params.append(SubchannelParams(sad, stl * 8, tpl))
        scids.append(scid)

    fic_length = 128 if int(mid[0]) == 3 else 96
    layout = EnsembleLayout(int(mid[0]), n_st, fic_length,
                            tuple(subch_params), tuple(scids))

    off = 8 + 4 * n_st
    mnsc = (raw[:, off].astype(np.uint16)
            | (raw[:, off + 1].astype(np.uint16) << 8))
    off += 4  # EOH = MNSC + CRC

    fic = raw[:, off:off + fic_length].copy()
    off += fic_length

    subchannels = []
    for p in subch_params:
        subchannels.append(raw[:, off:off + p.framesize].copy())
        off += p.framesize

    off += 4  # EOF
    tb = raw[:, off:off + 4].astype(np.uint32)
    tist_raw = tb[:, 0] | (tb[:, 1] << 8) | (tb[:, 2] << 16) | (tb[:, 3] << 24)
    # getPPSOffset: ntohl(TIST) & 0xFFFFFF; 0xFFFFFF means "no timestamp"
    # (ref: src/EtiReader.cpp:286-296)
    pps = (tb[:, 1] << 16) | (tb[:, 2] << 8) | tb[:, 3]
    tist_pps = np.where(pps == 0xFFFFFF, 0, pps).astype(np.uint32)

    return EtiFrameBatch(layout, fct, fp, mnsc.astype(np.uint16),
                         tist_pps, tist_raw, fic, subchannels)


# ---------------------------------------------------------------------------
# Synthesis (for tests / standalone operation without a multiplexer)
# ---------------------------------------------------------------------------


def build_eti_frame(layout: EnsembleLayout, fct: int, fic: np.ndarray,
                    subch_data: list[np.ndarray], fp: int = 0,
                    mnsc: int = 0xFFFF, tist: int = 0xFFFFFF) -> np.ndarray:
    """Assemble one raw 6144-byte ETI(NI) frame."""
    frame = np.full(ETI_NI_FRAME, 0x55, dtype=np.uint8)
    # SYNC: ERR=0xFF then FSYNC, laid out so that the little-endian u32 read
    # of bytes 0..3 gives the reference's sync constants 0x49C5F8FF /
    # 0xB63A07FF (alternating per frame, src/InputFileReader.cpp:85)
    sync_u32 = 0xB63A07FF if (fct & 1) else 0x49C5F8FF
    frame[0] = sync_u32 & 0xFF
    frame[1] = (sync_u32 >> 8) & 0xFF
    frame[2] = (sync_u32 >> 16) & 0xFF
    frame[3] = (sync_u32 >> 24) & 0xFF
    nst = layout.nst
    # frame length in words: (header after first 8 bytes + payload) / 4
    fl = (4 * nst + 4 + layout.fic_length
          + sum(p.framesize for p in layout.subchannels)) // 4
    frame[4] = fct & 0xFF
    frame[5] = 0x80 | nst
    frame[6] = ((fp & 0x7) << 5) | ((layout.mid & 0x3) << 3) | ((fl >> 8) & 0x7)
    frame[7] = fl & 0xFF
    off = 8
    for p, scid in zip(layout.subchannels, layout.scids):
        stl = p.framesize // 8
        frame[off] = ((scid & 0x3F) << 2) | ((p.start_address >> 8) & 0x3)
        frame[off + 1] = p.start_address & 0xFF
        frame[off + 2] = ((p.tpl & 0x3F) << 2) | ((stl >> 8) & 0x3)
        frame[off + 3] = stl & 0xFF
        off += 4
    # EOH: MNSC (stored so that the reference's LE uint16 read returns `mnsc`)
    frame[off] = mnsc & 0xFF
    frame[off + 1] = (mnsc >> 8) & 0xFF
    frame[off + 2:off + 4] = 0  # CRC (unused by the modulator)
    off += 4
    if fic.size != layout.fic_length:
        raise EtiError("bad FIC length")
    frame[off:off + layout.fic_length] = fic
    off += layout.fic_length
    for p, d in zip(layout.subchannels, subch_data):
        if d.size != p.framesize:
            raise EtiError("bad subchannel length")
        frame[off:off + p.framesize] = d
        off += p.framesize
    frame[off:off + 4] = 0  # EOF
    off += 4
    # TIST stored big-endian-on-wire so ntohl(LE read) & 0xFFFFFF == tist
    frame[off] = 0
    frame[off + 1] = (tist >> 16) & 0xFF
    frame[off + 2] = (tist >> 8) & 0xFF
    frame[off + 3] = tist & 0xFF
    return frame


# A production-shaped DAB ensemble: 17 sub-channels, mixed UEP levels and
# EEP-A/EEP-B profiles, filling 855 of the 864 CIF capacity units (the same
# ensemble as the e2e_real_* goldens under tests/golden/).
# Entries: (sad_cu, stl, tpl).
REALISTIC_MUX_SPECS = (
    (0, 72, 0x02),     # UEP 192 kbps L3   140 CU
    (140, 48, 0x02),   # UEP 128 kbps L3    96 CU
    (236, 48, 0x03),   # UEP 128 kbps L4    84 CU
    (320, 36, 0x22),   # EEP-A3 96 kbps     72 CU
    (392, 36, 0x22),   # EEP-A3 96 kbps     72 CU
    (464, 30, 0x22),   # EEP-A3 80 kbps     60 CU
    (524, 24, 0x22),   # EEP-A3 64 kbps     48 CU
    (572, 24, 0x27),   # EEP-B4 64 kbps     30 CU
    (602, 18, 0x22),   # EEP-A3 48 kbps     36 CU
    (638, 18, 0x21),   # EEP-A2 48 kbps     48 CU
    (686, 12, 0x22),   # EEP-A3 32 kbps     24 CU
    (710, 12, 0x26),   # EEP-B3 32 kbps     18 CU
    (728, 12, 0x20),   # EEP-A1 32 kbps     48 CU
    (776, 12, 0x01),   # UEP 32 kbps L2     29 CU
    (805, 12, 0x26),   # EEP-B3 32 kbps     18 CU
    (823, 3, 0x21),    # EEP-A2 8 kbps       8 CU
    (831, 12, 0x22),   # EEP-A3 32 kbps     24 CU -> ends at 855
)


def synth_eti_batch(n_frames: int, mode: int = 1,
                    subch_specs=((0, 24, 0x22),),
                    seed: int = 0) -> np.ndarray:
    """Synthesize a batch of random-payload ETI frames for tests/benchmarks.

    subch_specs: iterable of (start_address_cu, stl_words, tpl).
    Default: one EEP 3-A 64 kbit/s sub-channel (tpl 0x22 = long form,
    option 0, level 3; 48 CU).
    """
    rng = np.random.default_rng(seed)
    mid = {1: 1, 2: 2, 3: 3, 4: 0}[mode]
    params = tuple(SubchannelParams(sad, stl * 8, tpl)
                   for sad, stl, tpl in subch_specs)
    fic_length = 128 if mid == 3 else 96
    layout = EnsembleLayout(mid, len(params), fic_length, params,
                            tuple(range(len(params))))
    frames = np.empty((n_frames, ETI_NI_FRAME), dtype=np.uint8)
    for t in range(n_frames):
        fic = rng.integers(0, 256, fic_length, dtype=np.uint8)
        sub = [rng.integers(0, 256, p.framesize, dtype=np.uint8)
               for p in params]
        frames[t] = build_eti_frame(layout, fct=t % 250, fic=fic,
                                    subch_data=sub, fp=t % 8,
                                    tist=(t * 393216) % 16384000)
    return frames
