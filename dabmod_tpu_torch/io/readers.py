"""ETI input: the file/stdin/FIFO reader (Raw / Framed / Streamed framing
auto-detection), streaming and batch-oriented.  The port's copy of
dabmod_tpu/io/readers.py's EtiFileReader and open_input; the TCP, ZMQ and
EDI inputs are not ported yet (ROADMAP A10(b)).

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
import sys

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


def open_input(settings):
    """The ETI file reader for settings.input_name (a file, a FIFO or
    /dev/stdin).  The TCP, ZMQ and EDI transports raise
    NotImplementedError: they come with ROADMAP A10(b)."""
    name = settings.input_name
    if (settings.input_transport in ("tcp", "zmq", "edi")
            or name.startswith(("tcp://", "udp://", "zmq+tcp://"))):
        raise NotImplementedError(
            f"input transport {settings.input_transport!r} ({name}) is not "
            f"ported to dabmod_tpu_torch yet (ROADMAP A10(b))")
    return EtiFileReader(name, loop=settings.loop)
