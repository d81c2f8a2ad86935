"""EDI input: AF/PF packet layer, PFT reassembly with Reed-Solomon erasure
repair, and the ETI TAG decoder (deti / ESTn).

Port of the reference's generic EDI library (lib/edi/common.cpp TagDispatcher,
lib/edi/PFT.cpp fragment reassembly + RS(255,207), lib/edi/ETIDecoder.cpp)
and the EdiReader data collector (src/EtiReader.cpp:298-529).  Also provides
an *encoder* for loopback tests, since the reference's EDI sender lives in
ODR-DabMux.

The port's copy of dabmod_tpu/io/edi.py, with the port's own eti.py,
tables.py and crc16 (io/fic_decoder.py).  EdiInput adds request_stop and
close, which the runtime calls on every reader, and its read_batch reads
until it has the frames asked for (see there).
"""
from __future__ import annotations

import dataclasses
import logging
import socket
import time

import numpy as np

from . import rs
from ..eti import EnsembleLayout, build_eti_frame
from ..tables import SubchannelParams
# CRC16-CCITT (poly 0x1021, init 0xFFFF, final xor 0xFFFF -- lib/crc.c)
from .fic_decoder import crc16

log = logging.getLogger("dabmod_tpu_torch.edi")

AFPACKET_HEADER_LEN = 10


# ---------------------------------------------------------------------------
# AF packet layer
# ---------------------------------------------------------------------------


def build_af_packet(payload: bytes, seq: int) -> bytes:
    """AF packet: 'AF' + len + seq + flags(CRC, rev 1.0) + 'T' + payload + CRC."""
    hdr = (b"AF" + len(payload).to_bytes(4, "big") + (seq & 0xFFFF).to_bytes(2, "big")
           + bytes([0x80 | 0x10, ord("T")]))
    pkt = hdr + payload
    return pkt + crc16(pkt).to_bytes(2, "big")


def build_tag(name: bytes, value: bytes) -> bytes:
    assert len(name) == 4
    return name + (len(value) * 8).to_bytes(4, "big") + value


class TagDispatcher:
    """AF/PF sync + AF CRC check + TAG iteration with longest-prefix handlers
    (ref: lib/edi/common.cpp:106-168, 280-447)."""

    def __init__(self, af_packet_completed, max_delay_packets: int = 10):
        self._buf = bytearray()
        self._handlers: dict[bytes, object] = {}
        self._af_packet_completed = af_packet_completed
        self._pft = Pft(max_delay_packets)
        self._ignored: set[bytes] = set()
        # AF SEQ continuity monitor (ref: lib/edi/common.cpp checks the
        # sequence field and logs discontinuities)
        self._last_seq: int | None = None
        self.num_af_packets = 0
        self.num_seq_gaps = 0

    def register_tag(self, prefix: str, handler):
        self._handlers[prefix.encode()] = handler

    def push_bytes(self, data: bytes):
        if not data:
            self._buf.clear()
            return
        self._buf.extend(data)
        while len(self._buf) > 2:
            if self._buf[0:2] == b"AF":
                consumed, ok = self._decode_af(bytes(self._buf))
                if consumed == 0:
                    break
                del self._buf[:consumed]
                if ok:
                    self._af_packet_completed()
            elif self._buf[0:2] == b"PF":
                frag, consumed = PftFragment.parse(bytes(self._buf))
                if consumed == 0:
                    break
                del self._buf[:consumed]
                if frag is not None:
                    self._pft.push(frag)
                af = self._pft.next_af_packet()
                if af:
                    consumed2, ok = self._decode_af(af)
                    if ok:
                        self._af_packet_completed()
            else:
                del self._buf[0]

    def push_packet(self, data: bytes):
        """UDP variant: one datagram = one AF or PF packet."""
        if data[0:2] == b"AF":
            _, ok = self._decode_af(data)
            if ok:
                self._af_packet_completed()
        elif data[0:2] == b"PF":
            frag, _ = PftFragment.parse(data)
            if frag is not None:
                self._pft.push(frag)
            af = self._pft.next_af_packet()
            if af:
                _, ok = self._decode_af(af)
                if ok:
                    self._af_packet_completed()
        else:
            log.warning("EDI: unknown packet sync %r", data[:2])

    # ------------------------------------------------------------------
    def _decode_af(self, data: bytes) -> tuple[int, bool]:
        if len(data) < AFPACKET_HEADER_LEN:
            return 0, False
        taglength = int.from_bytes(data[2:6], "big")
        total = AFPACKET_HEADER_LEN + taglength + 2
        if len(data) < total:
            return 0, False
        has_crc = bool(data[8] & 0x80)
        if not has_crc or data[9] != ord("T"):
            return total, False
        if crc16(data[:AFPACKET_HEADER_LEN + taglength]) != int.from_bytes(
                data[total - 2:total], "big"):
            log.warning("EDI AF packet CRC wrong")
            return total, False
        seq = int.from_bytes(data[6:8], "big")
        self.num_af_packets += 1
        if self._last_seq is not None and \
                seq != ((self._last_seq + 1) & 0xFFFF):
            self.num_seq_gaps += 1
            log.warning("EDI AF SEQ discontinuity: %d -> %d",
                        self._last_seq, seq)
        self._last_seq = seq
        payload = data[AFPACKET_HEADER_LEN:AFPACKET_HEADER_LEN + taglength]
        return total, self._decode_tagpacket(payload)

    def _decode_tagpacket(self, payload: bytes) -> bool:
        i = 0
        success = True
        while i + 8 < len(payload):
            name = payload[i:i + 4]
            taglength = int.from_bytes(payload[i + 4:i + 8], "big")
            if taglength % 8:
                log.warning("EDI tag length not multiple of 8")
                break
            taglength //= 8
            if i + 8 + taglength > len(payload):
                log.warning("EDI tag larger than tagpacket")
                break
            value = payload[i + 8:i + 8 + taglength]
            found = False
            for prefix, handler in self._handlers.items():
                if name[:len(prefix)] == prefix:
                    found = True
                    success &= bool(handler(value, name))
            if not found and name not in self._ignored:
                log.warning("EDI: ignoring unknown TAG %r", name)
                self._ignored.add(name)
            i += 8 + taglength
        return success


# ---------------------------------------------------------------------------
# PFT layer (ETSI TS 102 821)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PftFragment:
    pseq: int
    findex: int
    fcount: int
    fec: bool
    rsk: int
    rsz: int
    plen: int
    payload: bytes

    @classmethod
    def parse(cls, buf: bytes) -> tuple["PftFragment | None", int]:
        """Returns (fragment_or_None, consumed); consumed == 0 needs more
        data (ref: lib/edi/PFT.cpp Fragment::loadData)."""
        if len(buf) < 14:
            return None, 0
        if buf[0:2] != b"PF":
            raise ValueError("invalid PFT sync")
        pseq = int.from_bytes(buf[2:4], "big")
        findex = int.from_bytes(buf[4:7], "big")
        fcount = int.from_bytes(buf[7:10], "big")
        word = int.from_bytes(buf[10:12], "big")
        fec = bool(word & 0x8000)
        addr = bool(word & 0x4000)
        plen = word & 0x3FFF
        index = 12
        rsk = rsz = 0
        if fec:
            if len(buf) < index + 2:
                return None, 0
            rsk, rsz = buf[index], buf[index + 1]
            index += 2
        if addr:
            if len(buf) < index + 4:
                return None, 0
            index += 4
        if len(buf) < index + 2:
            return None, 0
        hdr_crc_ok = crc16(buf[:index]) == int.from_bytes(
            buf[index:index + 2], "big")
        index += 2
        if len(buf) < index + plen:
            return None, 0
        valid = (not fec) or hdr_crc_ok
        frag = cls(pseq, findex, fcount, fec, rsk, rsz, plen,
                   buf[index:index + plen]) if valid else None
        return frag, index + plen


class AfBuilder:
    """Reassembles one AF packet from its PFT fragments, with RS erasure
    repair (ref: lib/edi/PFT.cpp AFBuilder)."""

    def __init__(self, pseq: int, fcount: int, lifetime: int):
        self.pseq = pseq
        self.fcount = fcount
        self.lifetime = lifetime
        self.fragments: dict[int, PftFragment] = {}

    def push(self, frag: PftFragment):
        self.fragments.setdefault(frag.findex, frag)

    def _ref_frag(self) -> PftFragment | None:
        """A fragment that is not the (possibly shorter) last one."""
        for idx in sorted(self.fragments):
            if idx != self.fcount - 1 or len(self.fragments) == 1 \
                    and self.fcount == 1:
                return self.fragments[idx]
        return None

    def can_decode(self) -> str:
        if not self.fragments:
            return "no"
        if len(self.fragments) == self.fcount:
            return "yes"
        ref = self._ref_frag()
        if ref is None:
            return "no"
        if ref.fec and ref.plen > 0:
            # plen==0 would divide by zero (the reference asserts on the
            # equivalent cmax>0, lib/edi/PFT.cpp:305-306; a crafted
            # fragment must not crash a network-facing input)
            cmax = (self.fcount * ref.plen) // (ref.rsk + 48)
            rxmin = self.fcount - (cmax * 48) // ref.plen
            if len(self.fragments) >= rxmin:
                return "maybe"
        return "no"

    def extract(self) -> bytes:
        ref = self._ref_frag()
        if ref is None:
            return b""
        if ref.fec:
            return self._extract_fec(ref)
        if len(self.fragments) != self.fcount:
            return b""
        return b"".join(self.fragments[j].payload for j in range(self.fcount))

    def _extract_fec(self, ref: PftFragment) -> bytes:
        plen, rsk, rsz = ref.plen, ref.rsk, ref.rsz
        fcount = self.fcount
        cmax = (fcount * plen) // (rsk + 48)
        block = np.zeros(plen * fcount, np.uint8)
        erasures: dict[int, list[int]] = {}
        for j in range(fcount):
            frag = self.fragments.get(j)
            if frag is not None:
                pl = np.frombuffer(frag.payload, np.uint8)
                block[np.arange(pl.size) * fcount + j] = pl
            else:
                for k in range(plen):
                    pos = k * fcount + j
                    erasures.setdefault(pos // (rsk + 48), []).append(
                        pos % (rsk + 48))
        out = bytearray()
        for i in range(cmax):
            chunk = np.zeros(255, np.uint8)
            base = (rsk + 48) * i
            chunk[:rsk] = block[base:base + rsk]
            chunk[207:255] = block[base + rsk:base + rsk + 48]
            # map erasure offsets: data offsets stay, parity offsets shift
            # to the padded positions 207..254
            eras = [(e if e < rsk else e - rsk + 207)
                    for e in erasures.get(i, [])]
            if rs.decode(chunk, eras) < 0:
                return b""
            out.extend(chunk[:rsk].tobytes())
        return bytes(out[:len(out) - rsz])


class Pft:
    """In-order AF packet queue over reassembly builders
    (ref: lib/edi/PFT.cpp PFT::pushPFTFrag/getNextAFPacket)."""

    def __init__(self, max_delay: int = 10):
        self.max_delay = max_delay
        self.builders: dict[int, AfBuilder] = {}
        self.next_pseq: int | None = None

    def push(self, frag: PftFragment):
        if not self.builders:
            self.next_pseq = frag.pseq
        if frag.pseq not in self.builders:
            self.builders[frag.pseq] = AfBuilder(
                frag.pseq, frag.fcount, frag.fcount * self.max_delay)
        self.builders[frag.pseq].push(frag)

    def next_af_packet(self) -> bytes:
        if self.next_pseq not in self.builders:
            if len(self.builders) > self.max_delay:
                self.builders.clear()
            return b""
        b = self.builders[self.next_pseq]
        state = b.can_decode()
        if state == "yes":
            af = b.extract()
            self._advance()
            return af
        if state == "maybe":
            b.lifetime -= 1
            if b.lifetime <= 0:
                af = b.extract()
                self._advance()
                return af
        else:
            b.lifetime -= 1
            if b.lifetime <= 0:
                self._advance()
        return b""

    def _advance(self):
        del self.builders[self.next_pseq]
        self.next_pseq = (self.next_pseq + 1) & 0xFFFF


# ---------------------------------------------------------------------------
# ETI TAG decoding + frame collection (ref: lib/edi/ETIDecoder.cpp and
# src/EtiReader.cpp:298-529 EdiReader)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EdiFrame:
    fct: int = 0                 # dlfc mod 250
    dlfc: int = 0
    fp: int = 0
    mid: int = 1
    mnsc: int = 0xFFFF
    fic: bytes = b""
    tsta: int = 0xFFFFFF
    utco: int = 0
    seconds: int = 0
    subchannels: dict = dataclasses.field(default_factory=dict)


class EdiEtiDecoder:
    """Collects deti/EST tags into complete frames."""

    def __init__(self):
        self.dispatcher = TagDispatcher(self._af_done)
        self.dispatcher.register_tag("*ptr", lambda v, n: True)
        self.dispatcher.register_tag("*dmy", lambda v, n: True)
        self.dispatcher.register_tag("deti", self._decode_deti)
        self.dispatcher.register_tag("est", self._decode_estn)
        self._current = EdiFrame()
        self.frames: list[EdiFrame] = []

    # -- tag handlers --
    def _decode_deti(self, value: bytes, name: bytes) -> bool:
        f = self._current
        deti = int.from_bytes(value[0:2], "big")
        atstf = (deti >> 15) & 1
        ficf = (deti >> 14) & 1
        rfudf = (deti >> 13) & 1
        fcth = (deti >> 8) & 0x1F
        f.dlfc = fcth * 250 + (deti & 0xFF)
        f.fct = f.dlfc % 250
        eti_header = int.from_bytes(value[2:6], "big")
        f.mid = (eti_header >> 22) & 0x3
        f.fp = (eti_header >> 19) & 0x7
        rfu = (eti_header >> 16) & 1
        f.mnsc = 0xFFFF if rfu else eti_header & 0xFFFF
        i = 6
        if atstf:
            f.utco = value[i]
            f.seconds = int.from_bytes(value[i + 1:i + 5], "big")
            f.tsta = int.from_bytes(value[i + 5:i + 8], "big")
            i += 8
        else:
            f.tsta = 0xFFFFFF
        if ficf:
            fic_len = 4 * (32 if f.mid == 3 else 24)
            f.fic = value[i:i + fic_len]
            i += fic_len
        if rfudf:
            i += 3
        return True

    def _decode_estn(self, value: bytes, name: bytes) -> bool:
        sstc = int.from_bytes(value[0:3], "big")
        stream_index = name[3] - 1
        scid = (sstc >> 18) & 0x3F
        sad = (sstc >> 8) & 0x3FF
        tpl = (sstc >> 2) & 0x3F
        self._current.subchannels[stream_index] = (scid, sad, tpl, value[3:])
        return True

    def _af_done(self):
        if self._current.fic:
            self.frames.append(self._current)
        self._current = EdiFrame()

    # -- conversion to the common pipeline input --
    def pop_eti_frames(self):
        """Convert collected EDI frames into raw ETI(NI) frames + timestamps.

        Returns (raw [T, 6144], list[(seconds, utco, tsta)]) and clears the
        queue.  Re-framing into ETI keeps a single ingest path into the
        batched modulator.
        """
        out = []
        times = []
        for f in self.frames:
            subs = sorted(f.subchannels.items())
            params = tuple(
                SubchannelParams(sad, len(mst), tpl)
                for _, (scid, sad, tpl, mst) in subs)
            scids = tuple(scid for _, (scid, _, _, _) in subs)
            layout = EnsembleLayout(f.mid, len(subs), len(f.fic),
                                    params, scids)
            raw = build_eti_frame(
                layout, fct=f.fct, fic=np.frombuffer(f.fic, np.uint8),
                subch_data=[np.frombuffer(m, np.uint8)
                            for _, (_, _, _, m) in subs],
                fp=f.fp, mnsc=f.mnsc, tist=f.tsta)
            out.append(raw)
            times.append((f.seconds, f.utco, f.tsta))
        self.frames = []
        if not out:
            return np.empty((0, 6144), np.uint8), []
        return np.stack(out), times


# ---------------------------------------------------------------------------
# EDI encoder (for tests / loopback; the reference's sender is in ODR-DabMux)
# ---------------------------------------------------------------------------


def encode_edi_frame(fic: bytes, subchannels, dlfc: int, fp: int = 0,
                     mid: int = 1, mnsc: int = 0xFFFF,
                     timestamp: tuple[int, int, int] | None = None) -> bytes:
    """Build one AF packet carrying deti + ESTn tags.

    subchannels: list of (scid, sad, tpl, mst_bytes).
    timestamp: optional (utco, seconds, tsta).
    """
    atstf = 1 if timestamp else 0
    ficf = 1
    deti = bytearray()
    hdr = (dlfc % 250) | ((dlfc // 250) << 8) | (0 << 13) | (ficf << 14) \
        | (atstf << 15)
    deti += hdr.to_bytes(2, "big")
    rfu = 1 if mnsc == 0xFFFF else 0
    eti_header = (0 << 24) | (mid << 22) | (fp << 19) | (rfu << 16) \
        | (mnsc & 0xFFFF)
    deti += eti_header.to_bytes(4, "big")
    if timestamp:
        utco, seconds, tsta = timestamp
        deti += bytes([utco]) + seconds.to_bytes(4, "big") \
            + tsta.to_bytes(3, "big")
    deti += fic
    payload = build_tag(b"deti", bytes(deti))
    for i, (scid, sad, tpl, mst) in enumerate(subchannels):
        sstc = (scid << 18) | (sad << 8) | (tpl << 2)
        payload += build_tag(b"est" + bytes([i + 1]),
                             sstc.to_bytes(3, "big") + mst)
    return payload


def fragment_af(af_packet: bytes, pseq: int, fragment_size: int,
                with_fec: bool = False) -> list[bytes]:
    """Split an AF packet into PF fragments (optionally RS-protected),
    inverse of AfBuilder.extract."""
    data = np.frombuffer(af_packet, np.uint8)
    if with_fec:
        rsk = 207
        # pad to a multiple of rsk
        rsz_total = (-len(data)) % rsk
        padded = np.concatenate([data, np.zeros(rsz_total, np.uint8)])
        cmax = padded.size // rsk
        block = bytearray()
        for i in range(cmax):
            chunk = padded[i * rsk:(i + 1) * rsk]
            block.extend(chunk.tobytes())
            block.extend(rs.encode(chunk).tobytes())
        blob = np.frombuffer(bytes(block), np.uint8)
        # choose fcount so that plen*fcount == len(blob), interleaved
        fcount = max(1, -(-blob.size // fragment_size))
        while blob.size % fcount:
            fcount += 1
        plen = blob.size // fcount
        frags = []
        for j in range(fcount):
            payload = blob[j::fcount][:plen]
            frags.append(_pf_header(pseq, j, fcount, True, rsk,
                                    rsz_total, plen)
                         + payload.tobytes())
        return frags
    fcount = max(1, -(-data.size // fragment_size))
    plen = -(-data.size // fcount)
    frags = []
    for j in range(fcount):
        payload = data[j * plen:(j + 1) * plen]
        frags.append(_pf_header(pseq, j, fcount, False, 0, 0, payload.size)
                     + payload.tobytes())
    return frags


def _pf_header(pseq, findex, fcount, fec, rsk, rsz, plen) -> bytes:
    hdr = bytearray(b"PF")
    hdr += pseq.to_bytes(2, "big")
    hdr += findex.to_bytes(3, "big")
    hdr += fcount.to_bytes(3, "big")
    word = plen | (0x8000 if fec else 0)
    hdr += word.to_bytes(2, "big")
    if fec:
        hdr += bytes([rsk, rsz])
    hdr += crc16(bytes(hdr)).to_bytes(2, "big")
    return bytes(hdr)


# ---------------------------------------------------------------------------
# Transports (ref: src/EtiReader.cpp:531-667 EdiTransport)
# ---------------------------------------------------------------------------


class EdiUdpTransport:
    def __init__(self, uri: str, timeout: float = 1.0):
        # udp://host:port or udp://bindaddr@mcast:port
        body = uri[len("udp://"):]
        addr, port = body.rsplit(":", 1)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM,
                                  socket.IPPROTO_UDP)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if "@" in addr:
            bind_addr, mcast = addr.split("@", 1)
            self.sock.bind((mcast, int(port)))
            mreq = socket.inet_aton(mcast) + socket.inet_aton(
                bind_addr or "0.0.0.0")
            self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                                 mreq)
        else:
            self.sock.bind((addr or "0.0.0.0", int(port)))
        self.sock.settimeout(timeout)
        self.decode_s = 0.0        # the decode's running sum, seconds

    def rx_packet(self, dispatcher: TagDispatcher) -> bool:
        try:
            data, _ = self.sock.recvfrom(65536)
        except socket.timeout:
            return False
        t0 = time.perf_counter()
        dispatcher.push_packet(data)
        self.decode_s += time.perf_counter() - t0
        return True


class EdiTcpTransport:
    """TCP EDI source with reconnect-on-drop
    (ref: src/EtiReader.cpp:599-667 runs a reconnect loop)."""

    def __init__(self, uri: str, timeout: float = 1.0,
                 reconnect_delay: float = 1.0):
        body = uri[len("tcp://"):]
        host, port = body.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._reconnect_delay = reconnect_delay
        self.num_reconnects = 0
        self.sock: socket.socket | None = None
        self.decode_s = 0.0        # the decode's running sum, seconds
        # a failed first connect is tolerated (the mux may start after
        # the modulator -- same liveness contract as EtiTcpReader);
        # rx_packet keeps retrying with backoff
        if not self._connect():
            log.warning("EDI TCP: initial connect to %s:%d failed, "
                        "will retry", *self._addr)

    def _connect(self) -> bool:
        try:
            self.sock = socket.create_connection(
                self._addr, timeout=self._timeout)
            self.sock.settimeout(self._timeout)
            return True
        except OSError:
            self.sock = None
            return False

    def rx_packet(self, dispatcher: TagDispatcher) -> bool:
        if self.sock is None:
            time.sleep(self._reconnect_delay)
            if not self._connect():
                return False
            self.num_reconnects += 1
            log.info("EDI TCP reconnected to %s:%d (count %d)",
                     self._addr[0], self._addr[1], self.num_reconnects)
        try:
            # 512-byte chunks like the reference, to avoid double-AF decode
            data = self.sock.recv(512)
        except socket.timeout:
            return False
        except OSError:
            data = b""
        if not data:
            # peer closed or connection error: drop partial frame state
            # and reconnect on the next call
            try:
                self.sock.close()
            finally:
                self.sock = None
            dispatcher.push_bytes(b"")
            return False
        t0 = time.perf_counter()
        dispatcher.push_bytes(data)
        self.decode_s += time.perf_counter() - t0
        return True


class EdiInput:
    """read_batch-compatible EDI source for the runtime.

    `never_eof`: like the reference's EDI receive loop (src/DabMod.cpp:
    648-671), packet timeouts are idle ticks, not end-of-stream."""

    never_eof = True

    def __init__(self, uri: str):
        self.decoder = EdiEtiDecoder()
        if uri.startswith("udp://"):
            self.transport = EdiUdpTransport(uri)
        elif uri.startswith("tcp://"):
            self.transport = EdiTcpTransport(uri)
        else:
            raise ValueError(f"unsupported EDI URI {uri}")
        self.timestamps = []
        self._stopping = False
        self._rebuild_s = 0.0

    @property
    def decode_s(self) -> float:
        """The decode's running sum, seconds: the transport's AF/PF and TAG
        decode with their CRCs, and the frames' rebuild into ETI here; the
        socket's wait left out."""
        return self.transport.decode_s + self._rebuild_s

    def request_stop(self):
        """Make an in-progress or future read_batch return after the
        packet it is waiting for, within one socket timeout (called from
        another thread)."""
        self._stopping = True

    def read_batch(self, n: int) -> np.ndarray:
        """The frames decoded once at least max(n, 1) are, or once a read
        times out.  dabmod_tpu gives up after 4n transport reads instead,
        which over TCP (512-byte reads) is less than a frame of a full
        multiplex: its batches of an EDI/TCP stream go out short."""
        while len(self.decoder.frames) < max(n, 1) and not self._stopping:
            if not self.transport.rx_packet(self.decoder.dispatcher):
                break
        t0 = time.perf_counter()
        raw, times = self.decoder.pop_eti_frames()
        self._rebuild_s += time.perf_counter() - t0
        self.timestamps.extend(times)
        return raw

    def close(self):
        self._stopping = True
        if self.transport.sock is not None:
            self.transport.sock.close()
