"""Live inputs and sinks for the tests of the port's A10(b) modules, on
the CPU and on the card (tests/test_torch_cuda.py): an ETI multiplex re-encoded as an EDI stream with
per-frame timestamps, served over TCP or sent over UDP at a paced rate; ETI
bytes served over TCP; a runtime (either package's) driven in a thread
until it has modulated a number of frames; wrappers that record what the
runtime hands its sink or its SDR device transmits; and a client of the
DPD feedback server's wire protocol.  It imports the port only (never JAX
or dabmod_tpu), so the card's machine can run it.

Every socket wait here is bounded, and every socket binds an ephemeral
port.
"""
import inspect
import socket
import struct
import threading
import time

import numpy as np

from dabmod_tpu_torch.eti import parse_eti_frames
from dabmod_tpu_torch.io.edi import build_af_packet, encode_edi_frame

EDI_EPOCH = 946_684_800          # 2000-01-01 in POSIX seconds
UTCO = 37                        # TAI - UTC, as EDI's deti tag carries it
PPS_HZ = 16_384_000
FRAME_TICKS = 393_216            # 24 ms at 16.384 MHz


def edi_seconds(posix: int, utco: int = UTCO) -> int:
    """EDI seconds of a POSIX second (the inverse of the runtime's
    seconds + 946_684_800 + 32 - utco)."""
    return posix - EDI_EPOCH - 32 + utco


def edi_stream(frames: np.ndarray, t0: float, utco: int = UTCO,
               start: int = 0) -> list:
    """One AF packet (bytes) for each raw ETI frame, carrying its FIC,
    sub-channels, FCT, FP and MNSC, and a timestamp of t0 (POSIX seconds)
    plus 24 ms a frame.  `start` is the index of frames[0] in a longer
    stream that begins at t0: its packets continue that stream's
    timestamps and AF sequence numbers."""
    sec0 = int(t0)
    tick0 = int(round((t0 - sec0) * PPS_HZ))
    packets = []
    for t in range(start, start + len(frames)):
        # one frame at a time: the stream may change its layout
        b = parse_eti_frames(frames[t - start:t - start + 1])
        ticks = tick0 + t * FRAME_TICKS
        ts = (utco, edi_seconds(sec0 + ticks // PPS_HZ, utco),
              ticks % PPS_HZ)
        subs = [(scid, p.start_address, p.tpl, b.subchannels[i][0].tobytes())
                for i, (p, scid) in enumerate(zip(b.layout.subchannels,
                                                  b.layout.scids))]
        payload = encode_edi_frame(b.fic[0].tobytes(), subs, int(b.fct[0]),
                                   fp=int(b.fp[0]), mid=b.layout.mid,
                                   mnsc=int(b.mnsc[0]), timestamp=ts)
        packets.append(build_af_packet(payload, t))
    return packets


class TcpServer:
    """Serves `data` to every connection it accepts, then holds the
    connection open until close() (a peer close would read as a
    multiplexer restart)."""

    def __init__(self, data: bytes):
        self.data = data
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.srv.settimeout(0.2)
        self.port = self.srv.getsockname()[1]
        self.conns = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self.conns.append(conn)
            try:
                conn.sendall(self.data)
            except OSError:
                pass

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.srv.close()
        for c in self.conns:
            c.close()


class ChunkServer:
    """Serves the first connection it accepts one chunk (bytes) of
    `chunks` each time release() is called, in order, and holds the
    connection open until close(): a stream whose pace the caller sets.
    `released` counts the chunks handed to the sender thread."""

    def __init__(self, chunks):
        self.chunks = chunks
        self.released = 0
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(0.2)
        self.port = self.srv.getsockname()[1]
        self.conn = None
        self._go = threading.Semaphore(0)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def release(self) -> bool:
        """Send the next chunk; False when every chunk has been released."""
        if self.released >= len(self.chunks):
            return False
        self.released += 1
        self._go.release()
        return True

    def _serve(self):
        while self.conn is None and not self._stop.is_set():
            try:
                self.conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
        for chunk in self.chunks:
            while not self._go.acquire(timeout=0.2):
                if self._stop.is_set():
                    return
            try:
                self.conn.sendall(chunk)
            except OSError:
                return

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.srv.close()
        if self.conn is not None:
            self.conn.close()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def send_udp(port: int, packets, gap_s: float = 0.002):
    """Send each packet as one datagram to 127.0.0.1:port, paced."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for p in packets:
            s.sendto(p, ("127.0.0.1", port))
            time.sleep(gap_s)
    finally:
        s.close()


def drive(rt, want_frames: int, deadline_s: float = 60.0, before=None):
    """Run rt.run() in a thread until it has modulated want_frames ETI
    frames (or run() returns, or the deadline passes), then stop it;
    `before` runs once the thread has started.  Returns run()'s exit
    code."""
    rc = []
    t = threading.Thread(target=lambda: rc.append(rt.run()), daemon=True)
    t.start()
    if before is not None:
        before()
    t0 = time.monotonic()
    while (rt.framecount < want_frames and t.is_alive()
           and time.monotonic() - t0 < deadline_s):
        time.sleep(0.02)
    rt.stop()
    t.join(timeout=20)
    assert not t.is_alive(), "runtime failed to stop"
    return rc[0] if rc else None


def record_sink(output) -> list:
    """Wrap output.write so every call is recorded as (copy of the array,
    [(fct, timestamp fields)]) before it is passed on."""
    calls = []
    write = output.write
    # dabmod_tpu's ZmqOutput.write takes the array only (its runtime falls
    # back to that call when the two-argument one raises a TypeError)
    takes_meta = len(inspect.signature(write).parameters) > 1

    def recording(arr, meta=None):
        calls.append((np.array(arr), [(fct, timestamp_fields(ts))
                                      for fct, ts in (meta or [])]))
        return write(arr, meta) if takes_meta else write(arr)

    output.write = recording
    return calls


def record_transmit(device) -> list:
    """Wrap device.transmit_frame so every frame is recorded as (FCT,
    timestamp fields, copy of the frame) before it is passed on."""
    frames = []
    transmit = device.transmit_frame

    def recording(samples, ts):
        frames.append((ts.fct, timestamp_fields(ts), np.array(samples)))
        return transmit(samples, ts)

    device.transmit_frame = recording
    return frames


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise OSError("the feedback server closed the connection")
        buf += chunk
    return bytes(buf)


def feedback_request(port, n, version=b"\x01", timeout=30.0):
    """One request to the DPD feedback server (dabmod_tpu/io/sdr.py:
    406-491): a version byte and a u32 sample count.  The reply is u32
    count, u32 TX second, u32 TX pps, the TX samples (complexf), u32 RX
    second, u32 RX pps, the RX samples: returned as (count, (tx second,
    tx pps), tx [count, 2], (rx second, rx pps), rx [count, 2]), or None
    if the server closed the connection without a reply."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.sendall(version + struct.pack("=I", n))
        try:
            got, sec, pps = struct.unpack("=III", _recv_exact(s, 12))
        except OSError:
            return None
        tx = np.frombuffer(_recv_exact(s, 8 * got), np.float32)
        rsec, rpps = struct.unpack("=II", _recv_exact(s, 8))
        rx = np.frombuffer(_recv_exact(s, 8 * got), np.float32)
    return got, (sec, pps), tx.reshape(-1, 2), (rsec, rpps), rx.reshape(-1, 2)


def timestamp_fields(ts):
    """A FrameTimestamp of either package as a plain tuple."""
    if ts is None:
        return None
    return (bool(ts.valid), int(ts.seconds), int(ts.pps), int(ts.fct),
            int(ts.fp))
