"""ETI input readers: file/stdin (Raw / Framed / Streamed framing
auto-detection) and TCP, streaming and batch-oriented; open_input also
opens the EDI input (io/edi.py).  The port's copy of
dabmod_tpu/io/readers.py.

Framing detection mirrors the reference's InputFileReader::IdentifyType
(src/InputFileReader.cpp:66-187): Raw = bare 6144-byte frames found by the
0x49c5f8ff / 0xb63a07ff sync words, Streamed = u32 frame count absent with a
u16 size prefix per frame, Framed = u32 nb_frames then u16-size-prefixed
frames.  Short frames are padded with 0x55 like the reference's Pad state.

Frames are consumed incrementally like the reference's GetNextFrame
(src/InputFileReader.cpp:219-288): the reader keeps a byte buffer plus
framing state and pulls chunks from the underlying file object on demand,
so `/dev/stdin` and FIFOs stream with bounded memory and no re-parsing.
"""
from __future__ import annotations

import io
import logging
import socket
import sys
import time

import numpy as np

from ..eti import ETI_NI_FRAME

log = logging.getLogger("dabmod_tpu_torch")

SYNCS = (0x49C5F8FF, 0xB63A07FF)
_CHUNK = 256 * ETI_NI_FRAME


def _u32le(b, off: int = 0) -> int:
    return int.from_bytes(bytes(b[off:off + 4]), "little")


def _u16le(b, off: int = 0) -> int:
    return int.from_bytes(bytes(b[off:off + 2]), "little")


class EtiFileReader:
    """Streaming ETI reader over a file, FIFO or stdin.

    `read_batch(n)` blocks until `n` frames are available (or EOF), which is
    the natural cadence coupling for live pipes; regular files just read
    ahead chunk-wise.
    """

    def __init__(self, path: str, loop: bool = False, fileobj=None):
        self.path = path
        if fileobj is not None:
            self.f = fileobj
        elif path in ("-", "/dev/stdin"):
            self.f = sys.stdin.buffer
        else:
            self.f = open(path, "rb")
        try:
            seekable = self.f.seekable()
        except (AttributeError, io.UnsupportedOperation):
            seekable = False
        if loop and not seekable:
            # the reference rewinds with fseek and loop simply fails on
            # pipes (src/InputFileReader.cpp:219-236); be explicit instead
            # of silently degrading to a single pass
            log.warning("input loop requested but %r is not seekable; "
                        "the stream will play once", path)
        self.loop = loop and seekable
        self._buf = bytearray()
        self._eof = False
        self._streamtype: str | None = None
        self._start_skipped = False

    # -- low-level buffering ------------------------------------------------
    def _fill(self, want: int) -> None:
        """Grow the buffer to >= want bytes (or EOF).  Uses read1 so a pipe
        delivers whatever is available instead of blocking for a full
        chunk."""
        read1 = getattr(self.f, "read1", None)
        while len(self._buf) < want and not self._eof:
            n = max(_CHUNK, want - len(self._buf))
            chunk = read1(n) if read1 is not None else self.f.read(n)
            if not chunk:
                self._eof = True
                break
            self._buf += chunk

    def _rewind(self) -> None:
        self.f.seek(0)
        self._buf.clear()
        self._eof = False
        self._start_skipped = False

    # -- framing ------------------------------------------------------------
    @property
    def streamtype(self) -> str:
        if self._streamtype is None:
            self._identify()
        return self._streamtype

    def _identify(self) -> None:
        """Determine the framing from the stream prefix
        (ref: src/InputFileReader.cpp:66-187)."""
        self._fill(12)
        d = self._buf
        if len(d) < 12:
            raise ValueError("input too short to identify ETI framing")
        if _u32le(d, 0) in SYNCS:
            self._streamtype = "raw"
            self._start_skipped = True
            return
        if _u32le(d, 2) in SYNCS:
            self._streamtype = "streamed"
            self._start_skipped = True
            return
        if _u32le(d, 6) in SYNCS:
            self._streamtype = "framed"
            # skip the u32 nb_frames header (the reference reads it but
            # streams until EOF regardless, src/InputFileReader.cpp:131-142)
            del self._buf[:4]
            self._start_skipped = True
            return
        # raw with offset: search byte-by-byte within the first frame
        self._fill(ETI_NI_FRAME + 14)
        d = self._buf
        for i in range(1, min(len(d) - 4, ETI_NI_FRAME + 10)):
            if _u32le(d, i) in SYNCS:
                del self._buf[:i]
                self._streamtype = "raw"
                self._start_skipped = True
                return
        raise ValueError("bad ETI input format (no sync word found)")

    def _next_frame(self) -> np.ndarray | None:
        """Pop one 6144-byte frame off the stream, or None at EOF."""
        if self._streamtype is None:
            self._identify()
        rewound = False
        while True:
            if self._streamtype == "raw":
                self._fill(ETI_NI_FRAME)
                if len(self._buf) >= ETI_NI_FRAME:
                    out = np.frombuffer(
                        bytes(self._buf[:ETI_NI_FRAME]), np.uint8)
                    del self._buf[:ETI_NI_FRAME]
                    return out
            else:
                self._fill(2)
                if len(self._buf) >= 2:
                    fs = _u16le(self._buf, 0)
                    if fs == 0 or fs > ETI_NI_FRAME:
                        return None     # corrupt length: stop like EOF
                    self._fill(2 + fs)
                    if len(self._buf) >= 2 + fs:
                        frame = np.full(ETI_NI_FRAME, 0x55, np.uint8)
                        frame[:fs] = np.frombuffer(
                            bytes(self._buf[2:2 + fs]), np.uint8)
                        del self._buf[:2 + fs]
                        return frame
            # EOF (or truncated tail)
            if not self.loop or rewound:
                return None
            rewound = True
            self._rewind()
            self._identify()

    def read_batch(self, n: int) -> np.ndarray:
        """Next [<=n, 6144] frames; empty array at EOF (wraps if loop)."""
        out = []
        for _ in range(n):
            frame = self._next_frame()
            if frame is None:
                break
            out.append(frame)
        if not out:
            return np.empty((0, ETI_NI_FRAME), np.uint8)
        return np.stack(out)

    def frames(self) -> np.ndarray:
        """Drain the remaining stream as [T, 6144] (test convenience)."""
        chunks = []
        while True:
            batch = self.read_batch(256)
            if batch.size == 0:
                return (np.concatenate(chunks) if chunks
                        else np.empty((0, ETI_NI_FRAME), np.uint8))
            chunks.append(batch)

    def close(self):
        if self.f is not sys.stdin.buffer:
            self.f.close()


class EtiTcpReader:
    """ETI over TCP (ref: src/InputTcpReader.cpp:44-93): a stream of raw
    6144-byte frames that survives multiplexer restarts.

    Mirrors the reference's auto-reconnecting TCPClient semantics
    (lib/Socket.cpp:954-999): a peer close triggers a reconnect with a 1 s
    backoff (src/InputTcpReader.cpp:77-80), a receive timeout yields an
    empty batch which the caller must treat as "keep waiting" rather than
    EOF (src/DabMod.cpp:613-627), and a half-closed connection -- no bytes
    for 5x the timeout -- forces a reconnect (lib/Socket.cpp:978-985).
    `never_eof` advertises the stream-liveness contract to the runtime.
    """

    never_eof = True

    def __init__(self, uri: str, timeout: float = 8.0,
                 reconnect_delay: float = 1.0):
        if uri.startswith("tcp://"):
            uri = uri[len("tcp://"):]
        host, port = uri.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.timeout = timeout
        # sub-second socket timeout: read_batch polls the stop flag and the
        # logical deadline at this cadence, so an external stop() takes
        # effect within ~0.5 s even mid-recv (the logical receive timeout
        # the caller observes is still `timeout`)
        self._sock_timeout = min(0.5, timeout)
        self.reconnect_delay = reconnect_delay
        self.sock: socket.socket | None = None
        self._buf = b""
        self._last_rx: float | None = None
        self._closed = False
        self._stopping = False
        self._outage = False
        self.reconnects = 0
        # the framing's running sum, seconds: the received bytes gathered
        # and cut into frames; the socket's wait left out
        self.decode_s = 0.0
        self._connect()

    def _connect(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        # a reconnected peer restarts at a frame boundary; drop any partial
        # tail so framing stays aligned (the reference's per-frame
        # MSG_WAITALL read discards partials the same way)
        self._buf = self._buf[:len(self._buf) // ETI_NI_FRAME
                              * ETI_NI_FRAME]
        try:
            self.sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
            self.sock.settimeout(self._sock_timeout)
            # arm the stream-gap clock at connect time: a peer that
            # accepts the connection but never sends must be reconnected
            # after 5x timeout like any other half-closed stream (the
            # reference counts from connect, lib/Socket.cpp:978-985)
            self._last_rx = time.monotonic()
        except OSError as e:
            log.debug("TCP input connect to %s:%d failed: %s",
                      self.host, self.port, e)
            self.sock = None

    def _reconnect(self, why: str) -> None:
        # first attempt of an outage at INFO, the retry storm at DEBUG
        # (the reference logs every attempt at debug,
        # src/InputTcpReader.cpp:77-78)
        level = logging.DEBUG if self._outage else logging.INFO
        log.log(level, "TCP input auto reconnect (%s)", why)
        self._outage = True
        self.reconnects += 1
        if self._closed or self._stopping:
            return
        time.sleep(self.reconnect_delay)
        if not (self._closed or self._stopping):
            self._connect()

    def request_stop(self):
        """Make an in-progress or future read_batch return within one
        sub-second socket-timeout tick (called from another thread)."""
        self._stopping = True

    def read_batch(self, n: int) -> np.ndarray:
        """Up to n frames; an empty batch means a timeout or a reconnect in
        progress, never end-of-stream."""
        if (n > 0 and self.sock is None
                and not (self._closed or self._stopping)):
            self._reconnect("not connected")
        want = n * ETI_NI_FRAME
        deadline = time.monotonic() + self.timeout
        try:
            while (len(self._buf) < want and self.sock is not None
                   and not self._stopping):
                try:
                    chunk = self.sock.recv(65536)
                except socket.timeout:
                    # sub-second tick: check stop, the stream-gap clock
                    # and the logical timeout, then keep waiting
                    now = time.monotonic()
                    if now - self._last_rx > 5 * self.timeout:
                        # half-closed connection (lib/Socket.cpp:978-985)
                        self._reconnect("stream gap")
                        break
                    if now >= deadline:
                        log.debug("TCP input timeout")
                        break
                    continue
                if not chunk:
                    self._reconnect("peer closed")
                    break
                t0 = time.perf_counter()
                self._buf += chunk
                self.decode_s += time.perf_counter() - t0
                self._last_rx = time.monotonic()
                if self._outage:
                    log.info("TCP input reconnected, stream resumed")
                    self._outage = False
        except OSError as e:
            self._reconnect(f"socket error: {e}")
        T = min(len(self._buf) // ETI_NI_FRAME, n)
        if T == 0:
            return np.empty((0, ETI_NI_FRAME), np.uint8)
        t0 = time.perf_counter()
        out = np.frombuffer(self._buf[:T * ETI_NI_FRAME],
                            np.uint8).reshape(T, ETI_NI_FRAME).copy()
        self._buf = self._buf[T * ETI_NI_FRAME:]
        self.decode_s += time.perf_counter() - t0
        return out

    def close(self):
        self._closed = True
        self._stopping = True
        if self.sock is not None:
            self.sock.close()
            self.sock = None


def open_input(settings):
    """EDI (transport=edi or a udp:// source), ETI over TCP (transport=tcp
    or a tcp:// source), or else the file reader, as dabmod_tpu opens them
    (transport=zmq included: dabmod_tpu reads its source as a file)."""
    name = settings.input_name
    if settings.input_transport == "edi" or name.startswith("udp://"):
        from .edi import EdiInput
        return EdiInput(name)
    if settings.input_transport == "tcp" or name.startswith("tcp://"):
        return EtiTcpReader(
            name, timeout=getattr(settings, "tcp_timeout", 8.0),
            reconnect_delay=getattr(settings, "tcp_reconnect_delay", 1.0))
    return EtiFileReader(name, loop=settings.loop)
