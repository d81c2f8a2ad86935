"""The benchmark's input streams, made from the seed with NumPy only: raw
ETI(NI) frames (EN 300 799) of a configured ensemble, and the same frames
as EDI AF packets (ETSI TS 102 693) as ODR-DabMux's EDI output sends them
over TCP without PFT.  A frozen copy of the frame layout the port's
synthesiser writes (sync words alternating by FCT parity, FCT = i mod 250,
FP = i mod 8, no MNSC time, TIST advancing 24 ms a frame), vectorised over
frames.  Imported by the generator process, so it imports no PyTorch."""
from __future__ import annotations

import binascii

import numpy as np

ETI_FRAME = 6144
FRAME_S = 0.024                      # one ETI frame of signal
TICKS_PER_FRAME = 393_216            # 24 ms in 1/16.384 MHz ticks


def layout_sizes(ensemble):
    """[(start CU, STL in 64-bit words, TPL)] -> byte sizes a frame."""
    return [8 * stl for _, stl, _ in ensemble]


def make_frames(seed: int, n: int, ensemble, mid: int = 1) -> np.ndarray:
    """n raw ETI frames [n, 6144] uint8; FIC and sub-channel payloads
    uniformly random bytes from `seed`, frame i of the stream the same
    for every n."""
    sizes = layout_sizes(ensemble)
    fic_len = 128 if mid == 3 else 96
    nst = len(ensemble)
    payload = fic_len + sum(sizes)
    frames = np.full((n, ETI_FRAME), 0x55, np.uint8)
    # payload rows from a generator per block of 256 frames, so that
    # frame i does not depend on n
    rows = []
    for b in range(0, n, 256):
        rng = np.random.default_rng([seed, b // 256])
        rows.append(rng.integers(0, 256, (256, payload), dtype=np.uint8))
    body = np.concatenate(rows)[:n]
    i = np.arange(n)
    fct = i % 250
    sync = np.where(fct & 1, 0xB63A07FF, 0x49C5F8FF).astype(np.uint32)
    frames[:, 0:4] = sync.view(np.uint8).reshape(n, 4)
    fl = (4 * nst + 4 + payload) // 4
    frames[:, 4] = fct
    frames[:, 5] = 0x80 | nst
    frames[:, 6] = ((i % 8) << 5) | ((mid & 0x3) << 3) | ((fl >> 8) & 0x7)
    frames[:, 7] = fl & 0xFF
    off = 8
    for scid, (sad, stl, tpl) in enumerate(ensemble):
        frames[:, off] = ((scid & 0x3F) << 2) | ((sad >> 8) & 0x3)
        frames[:, off + 1] = sad & 0xFF
        frames[:, off + 2] = ((tpl & 0x3F) << 2) | ((stl >> 8) & 0x3)
        frames[:, off + 3] = stl & 0xFF
        off += 4
    frames[:, off:off + 2] = 0xFF                    # MNSC 0xFFFF
    frames[:, off + 2:off + 4] = 0                   # header CRC (unused)
    off += 4
    frames[:, off:off + payload] = body
    off += payload
    frames[:, off:off + 4] = 0                       # EOF
    off += 4
    tist = (i * TICKS_PER_FRAME) % 16_384_000
    frames[:, off] = 0
    frames[:, off + 1] = (tist >> 16) & 0xFF
    frames[:, off + 2] = (tist >> 8) & 0xFF
    frames[:, off + 3] = tist & 0xFF
    return frames


def crc16(data: bytes) -> int:
    """CRC-16-CCITT, initial 0xFFFF, inverted (EDI's AF and PF CRC)."""
    return binascii.crc_hqx(data, 0xFFFF) ^ 0xFFFF


def _tag(name: bytes, value: bytes) -> bytes:
    return name + (len(value) * 8).to_bytes(4, "big") + value


# the EDI time of frame 0: 2025-01-01T00:00:00 UTC in seconds since the EDI
# epoch 2000-01-01, and the TAI-UTC offset in EDI's convention (UTCO = TAI
# - UTC - 32)
EDI_SECONDS_0 = 788_918_400
EDI_UTCO = 5


def edi_packet(frame: np.ndarray, i: int, ensemble, seq: int,
               mid: int = 1) -> bytes:
    """One AF packet (deti + one ESTn a sub-channel, with its time) that
    carries ETI frame i of the stream (TS 102 693 clauses 5.1, 8.1)."""
    fic_len = 128 if mid == 3 else 96
    nst = len(ensemble)
    off = 8 + 4 * nst + 4
    fic = frame[off:off + fic_len].tobytes()
    off += fic_len
    dlfc = i % 5000
    hdr = (dlfc % 250) | ((dlfc // 250) << 8) | (1 << 14) | (1 << 15)
    rfu = 1                                          # no MNSC
    eti_header = (mid << 22) | ((i % 8) << 19) | (rfu << 16) | 0xFFFF
    t_ms = i * 24
    seconds = EDI_SECONDS_0 + t_ms // 1000
    tsta = (t_ms % 1000) * 16_384
    deti = (hdr.to_bytes(2, "big") + eti_header.to_bytes(4, "big")
            + bytes([EDI_UTCO]) + seconds.to_bytes(4, "big")
            + tsta.to_bytes(3, "big") + fic)
    payload = _tag(b"deti", deti)
    for k, (sad, stl, tpl) in enumerate(ensemble):
        mst = frame[off:off + 8 * stl].tobytes()
        off += 8 * stl
        sstc = (k << 18) | (sad << 8) | (tpl << 2)
        payload += _tag(b"est" + bytes([k + 1]),
                        sstc.to_bytes(3, "big") + mst)
    head = (b"AF" + len(payload).to_bytes(4, "big")
            + (seq & 0xFFFF).to_bytes(2, "big") + bytes([0x90, ord("T")]))
    pkt = head + payload
    return pkt + crc16(pkt).to_bytes(2, "big")
