"""The port's live inputs and ZeroMQ sink (dabmod_tpu_torch/io/rs.py,
edi.py, readers.py's EtiTcpReader and open_input, outputs.py's
serialize_iq, ZmqOutput and open_output) against dabmod_tpu's: the cases
of tests/test_edi.py, tests/test_tcp_input.py and tests/test_wire_formats.py
(its ZeroMQ case) run on both copies; the EDI encoders emit the same bytes;
open_input opens the reader dabmod_tpu opens; every copied module's
constants and tables equal the original's.

Every socket wait is bounded by a few seconds, every socket binds an
ephemeral port, and the TCP readers run with timeouts shrunk to a few
tenths of a second (production: 8 s timeout, 1 s back-off).
"""
import dataclasses
import socket
import threading
import time
import types

import numpy as np
import pytest

from dabmod_tpu import eti as j_eti
from dabmod_tpu import runtime as j_runtime
from dabmod_tpu import tables as j_tables
from dabmod_tpu import utils as j_utils
from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.io import bladerf_driver as j_bladerf
from dabmod_tpu.io import dexter_driver as j_dexter
from dabmod_tpu.io import edi as j_edi
from dabmod_tpu.io import lime_driver as j_lime
from dabmod_tpu.io import outputs as j_outputs
from dabmod_tpu.io import readers as j_readers
from dabmod_tpu.io import rs as j_rs
from dabmod_tpu.io import sdr as j_sdr
from dabmod_tpu.io import soapy_driver as j_soapy
from dabmod_tpu.io import uhd_driver as j_uhd
from dabmod_tpu.rc import rcs as j_rcs
from dabmod_tpu_torch import eti as t_eti
from dabmod_tpu_torch import runtime as t_runtime
from dabmod_tpu_torch import utils as t_utils
from dabmod_tpu_torch.config import ModSettings as TSettings
from dabmod_tpu_torch.io import bladerf_driver as t_bladerf
from dabmod_tpu_torch.io import dexter_driver as t_dexter
from dabmod_tpu_torch.io import edi as t_edi
from dabmod_tpu_torch.io import fic_decoder as t_fic
from dabmod_tpu_torch.io import lime_driver as t_lime
from dabmod_tpu_torch.io import outputs as t_outputs
from dabmod_tpu_torch.io import readers as t_readers
from dabmod_tpu_torch.io import rs as t_rs
from dabmod_tpu_torch.io import sdr as t_sdr
from dabmod_tpu_torch.io import soapy_driver as t_soapy
from dabmod_tpu_torch.io import uhd_driver as t_uhd
from dabmod_tpu_torch.rc import rcs as t_rcs
from live_stream import TcpServer, edi_stream, free_port, send_udp

PKGS = {
    "dabmod_tpu": types.SimpleNamespace(
        rs=j_rs, edi=j_edi, eti=j_eti, readers=j_readers, outputs=j_outputs,
        Settings=JSettings, runtime=lambda s: j_runtime.ModRuntime(s)),
    "dabmod_tpu_torch": types.SimpleNamespace(
        rs=t_rs, edi=t_edi, eti=t_eti, readers=t_readers, outputs=t_outputs,
        Settings=TSettings,
        runtime=lambda s: t_runtime.ModRuntime(s, device="cpu")),
}
TF = j_tables.mode_params(1).tf_samples


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _rc_servers_down():
    yield
    j_rcs.shutdown()
    t_rcs.shutdown()


# ---------------------------------------------------------------------------
# RS and EDI: tests/test_edi.py
# ---------------------------------------------------------------------------

def test_rs_roundtrip_errors_and_erasures(pkg):
    rs = pkg.rs
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, rs.K, dtype=np.uint8)
    block = np.concatenate([data, rs.encode(data)])
    b = block.copy()
    assert rs.decode(b) == 0
    for nerr in (1, 8, 24):
        b = block.copy()
        pos = rng.choice(255, nerr, replace=False)
        b[pos] ^= rng.integers(1, 256, nerr).astype(np.uint8)
        assert rs.decode(b) == nerr
        np.testing.assert_array_equal(b, block)
    b = block.copy()
    pos = rng.choice(255, 48, replace=False)
    b[pos] = 0
    assert rs.decode(b, erasures=pos.tolist()) >= 0
    np.testing.assert_array_equal(b, block)


def test_rs_too_many_errors_fails_alike():
    """Beyond 24 errors both decoders give up (or miscorrect) alike."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, t_rs.K, dtype=np.uint8)
    block = np.concatenate([data, t_rs.encode(data)])
    np.testing.assert_array_equal(t_rs.encode(data), j_rs.encode(data))
    for seed in range(4):
        b = block.copy()
        pos = np.random.default_rng(seed).choice(255, 30, replace=False)
        b[pos] ^= 0x5A
        bt, bj = b.copy(), b.copy()
        assert t_rs.decode(bt) == j_rs.decode(bj)
        np.testing.assert_array_equal(bt, bj)


def _frames(n=4, nsub=2):
    rng = np.random.default_rng(3)
    frames = []
    for t in range(n):
        fic = rng.integers(0, 256, 96, dtype=np.uint8).tobytes()
        subs = [(i, 48 * i, 0x22,
                 rng.integers(0, 256, 192, dtype=np.uint8).tobytes())
                for i in range(nsub)]
        frames.append((fic, subs, t))
    return frames


def _check_decoded(pkg, dec, frames):
    raw, times = dec.pop_eti_frames()
    assert raw.shape[0] == len(frames)
    batch = pkg.eti.parse_eti_frames(raw)
    assert batch.layout.nst == 2
    for t, (fic, subs, dlfc) in enumerate(frames):
        assert batch.fct[t] == dlfc % 250
        np.testing.assert_array_equal(batch.fic[t],
                                      np.frombuffer(fic, np.uint8))
        for i, (_, _, _, mst) in enumerate(subs):
            np.testing.assert_array_equal(batch.subchannels[i][t],
                                          np.frombuffer(mst, np.uint8))
    return times


def test_edi_af_tcp_stream(pkg):
    E = pkg.edi
    dec = E.EdiEtiDecoder()
    frames = _frames()
    stream = b""
    for seq, (fic, subs, dlfc) in enumerate(frames):
        stream += E.build_af_packet(E.encode_edi_frame(
            fic, subs, dlfc, timestamp=(0, 1_000_000 + dlfc, 12345)), seq)
    for i in range(0, len(stream), 517):
        dec.dispatcher.push_bytes(stream[i:i + 517])
    times = _check_decoded(pkg, dec, frames)
    assert times[0][0] == 1_000_000


def test_edi_pft_no_fec(pkg):
    E = pkg.edi
    dec = E.EdiEtiDecoder()
    frames = _frames()
    for seq, (fic, subs, dlfc) in enumerate(frames):
        af = E.build_af_packet(E.encode_edi_frame(fic, subs, dlfc), seq)
        for frag in E.fragment_af(af, pseq=seq, fragment_size=200):
            dec.dispatcher.push_packet(frag)
    _check_decoded(pkg, dec, frames)


def test_edi_pft_fec_with_lost_fragments(pkg):
    E = pkg.edi
    dec = E.EdiEtiDecoder()
    frames = _frames()
    rng = np.random.default_rng(11)
    for seq, (fic, subs, dlfc) in enumerate(frames):
        af = E.build_af_packet(E.encode_edi_frame(fic, subs, dlfc), seq)
        frags = E.fragment_af(af, pseq=seq, fragment_size=100, with_fec=True)
        n_drop = max(1, len(frags) // 7)
        drop = set(rng.choice(len(frags), n_drop, replace=False).tolist())
        for i, frag in enumerate(frags):
            if i not in drop:
                dec.dispatcher.push_packet(frag)
        for _ in range(len(frags) * 12):
            af_pkt = dec.dispatcher._pft.next_af_packet()
            if af_pkt:
                dec.dispatcher._decode_af(af_pkt)
                dec._af_done()
                break
    _check_decoded(pkg, dec, frames)


def test_edi_interleaved_fragments(pkg):
    E = pkg.edi
    dec = E.EdiEtiDecoder()
    frames = _frames(n=3)
    all_frags = [E.fragment_af(E.build_af_packet(
        E.encode_edi_frame(fic, subs, dlfc), seq), pseq=seq,
        fragment_size=300) for seq, (fic, subs, dlfc) in enumerate(frames)]
    for i in range(max(len(f) for f in all_frags)):
        for frags in all_frags:
            if i < len(frags):
                dec.dispatcher.push_packet(frags[i])
    _check_decoded(pkg, dec, frames)


def test_edi_af_seq_gap_counter(pkg):
    E = pkg.edi
    dec = E.EdiEtiDecoder()
    for seq, (fic, subs, dlfc) in zip((0, 1, 5, 6), _frames(n=4)):
        dec.dispatcher.push_packet(
            E.build_af_packet(E.encode_edi_frame(fic, subs, dlfc), seq))
    assert dec.dispatcher.num_af_packets == 4
    assert dec.dispatcher.num_seq_gaps == 1


def test_edi_tcp_reconnect(pkg):
    """The TCP transport reconnects after the sender drops the connection
    (ref: src/EtiReader.cpp:599-667)."""
    E = pkg.edi
    frames = _frames(n=2)
    packets = [E.build_af_packet(E.encode_edi_frame(fic, subs, dlfc), seq)
               for seq, (fic, subs, dlfc) in enumerate(frames)]
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    srv.settimeout(5)
    port = srv.getsockname()[1]

    def serve():
        for p in packets:
            conn, _ = srv.accept()
            conn.sendall(p)
            conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    dec = E.EdiEtiDecoder()
    tr = E.EdiTcpTransport(f"tcp://127.0.0.1:{port}", timeout=0.2,
                           reconnect_delay=0.05)
    for _ in range(100):
        tr.rx_packet(dec.dispatcher)
        if len(dec.frames) >= 2:
            break
    th.join(timeout=5)
    srv.close()
    assert tr.num_reconnects >= 1
    _check_decoded(pkg, dec, frames)


@pytest.mark.parametrize("with_fec", [False, True])
def test_edi_encoders_emit_the_same_bytes(with_fec):
    """The port's encoder (encode_edi_frame, build_af_packet, fragment_af)
    emits dabmod_tpu's bytes, with and without a timestamp and RS FEC."""
    for seq, (fic, subs, dlfc) in enumerate(_frames(n=3)):
        kw = dict(fp=seq % 8, mnsc=0x1234 * seq or 0xFFFF,
                  timestamp=(37, 800_000_000 + seq, 393_216 * seq))
        a = t_edi.build_af_packet(t_edi.encode_edi_frame(fic, subs, dlfc,
                                                         **kw), seq)
        b = j_edi.build_af_packet(j_edi.encode_edi_frame(fic, subs, dlfc,
                                                         **kw), seq)
        assert a == b
        assert (t_edi.fragment_af(a, seq, 150, with_fec)
                == j_edi.fragment_af(b, seq, 150, with_fec))


def _same_content(raw, frames):
    """The frames' FIC, sub-channels, FCT, FP and MNSC (EDI carries its
    own timestamp in place of the frames' TIST)."""
    a, b = t_eti.parse_eti_frames(raw), t_eti.parse_eti_frames(frames)
    assert a.layout == b.layout
    for k in ("fct", "fp", "mnsc", "fic"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for x, y in zip(a.subchannels, b.subchannels):
        np.testing.assert_array_equal(x, y)
    return a


def test_edi_stream_round_trips_an_eti_multiplex():
    """tests/live_stream.edi_stream re-encodes ETI frames as EDI; both
    decoders give the frames back, byte for byte, with their timestamps."""
    frames = t_eti.synth_eti_batch(6, mode=1, subch_specs=(
        (0, 24, 0x22), (48, 48, 0x02)), seed=4)
    stream = b"".join(edi_stream(frames, 1_800_000_000.5))
    for E in (t_edi, j_edi):
        dec = E.EdiEtiDecoder()
        dec.dispatcher.push_bytes(stream)
        raw, times = dec.pop_eti_frames()
        b = _same_content(raw, frames)
        assert [t[1] for t in times] == [37] * 6
        assert [t[2] for t in times] == list(b.tist_pps)
        assert [t[2] for t in times] == [(8_192_000 + 393_216 * i)
                                         % 16_384_000 for i in range(6)]


# ---------------------------------------------------------------------------
# EdiInput over TCP and UDP
# ---------------------------------------------------------------------------

FULL_MUX = t_eti.REALISTIC_MUX_SPECS


def test_edi_input_reads_whole_batches_of_a_full_multiplex():
    """At the 17-sub-channel multiplex a frame is about 5.5 kB, 11 TCP
    reads of 512 bytes: the port's EdiInput.read_batch(n) returns n frames;
    dabmod_tpu's stops after 4n reads, with fewer (ROADMAP C)."""
    frames = t_eti.synth_eti_batch(24, mode=1, subch_specs=FULL_MUX, seed=6)
    srv = TcpServer(b"".join(edi_stream(frames, 1_800_000_000.0)))
    try:
        got = {}
        for name, E in (("torch", t_edi), ("jax", j_edi)):
            inp = E.EdiInput(f"tcp://127.0.0.1:{srv.port}")
            got[name] = inp.read_batch(8)
            inp.transport.sock.close()
        assert got["torch"].shape == (8, 6144)
        _same_content(got["torch"], frames[:8])
        assert 0 < len(got["jax"]) < 8
    finally:
        srv.close()


def test_edi_input_request_stop_and_close():
    """request_stop ends a read within one socket timeout; close closes the
    transport's socket (the runtime stops and closes every reader)."""
    srv = TcpServer(b"")
    try:
        inp = t_edi.EdiInput(f"tcp://127.0.0.1:{srv.port}")
        threading.Timer(0.2, inp.request_stop).start()
        t0 = time.monotonic()
        assert inp.read_batch(4).shape == (0, 6144)
        assert time.monotonic() - t0 < 3.0
        inp.close()
        assert inp.transport.sock.fileno() == -1
    finally:
        srv.close()


@pytest.mark.parametrize("transport", ["tcp", "udp"])
def test_edi_input_frames_and_timestamps(pkg, transport):
    """EdiInput over TCP or UDP (datagrams paced) gives the frames and one
    (seconds, utco, tsta) a frame."""
    frames = t_eti.synth_eti_batch(8, mode=1, seed=7)
    packets = edi_stream(frames, 1_800_000_000.25)
    srv = None
    if transport == "tcp":
        srv = TcpServer(b"".join(packets))
        inp = pkg.edi.EdiInput(f"tcp://127.0.0.1:{srv.port}")
    else:
        inp = pkg.edi.EdiInput("udp://127.0.0.1:0")
        port = inp.transport.sock.getsockname()[1]
        threading.Thread(target=send_udp, args=(port, packets),
                         daemon=True).start()
    try:
        got = []
        deadline = time.monotonic() + 10
        while sum(len(g) for g in got) < 8 and time.monotonic() < deadline:
            got.append(inp.read_batch(8 - sum(len(g) for g in got)))
        _same_content(np.concatenate(got), frames)
        sec = [int(t[0]) for t in inp.timestamps]
        tsta = [int(t[2]) for t in inp.timestamps]
        assert len(inp.timestamps) == 8
        assert sec[0] == 1_800_000_000 - 946_684_800 - 32 + 37
        assert tsta[1] - tsta[0] == 393_216
    finally:
        inp.transport.sock.close()
        if srv is not None:
            srv.close()


# ---------------------------------------------------------------------------
# ETI over TCP: tests/test_tcp_input.py
# ---------------------------------------------------------------------------

def _listener():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(10)
    return srv, srv.getsockname()[1]


def _rebind(port):
    s2 = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s2.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s2.bind(("127.0.0.1", port))
    s2.listen(1)
    s2.settimeout(10)
    return s2


def _tcp_runtime(pkg, tmp_path, port, timeout=0.3, reconnect=0.05):
    s = pkg.Settings(input_transport="tcp",
                     input_name=f"tcp://127.0.0.1:{port}",
                     output="file", output_name=str(tmp_path / "out.iq"),
                     file_output_format="s16", batch_tf=2,
                     tcp_timeout=timeout, tcp_reconnect_delay=reconnect)
    s.normalise_for_output()
    return pkg.runtime(s)


def _drive(rt, want_frames, deadline_s=60.0):
    rc = []
    t = threading.Thread(target=lambda: rc.append(rt.run()), daemon=True)
    t.start()
    t0 = time.monotonic()
    while rt.framecount < want_frames and time.monotonic() - t0 < deadline_s:
        time.sleep(0.05)
    rt.stop()
    t.join(timeout=20)
    assert not t.is_alive(), "runtime failed to stop"
    return rc[0] if rc else None


def test_tcp_reader_reconnects_after_server_restart(pkg, tmp_path):
    frames = t_eti.synth_eti_batch(32, mode=1)
    srv, port = _listener()
    rt = _tcp_runtime(pkg, tmp_path, port)

    def server():
        conn, _ = srv.accept()
        conn.sendall(frames[:16].tobytes())
        conn.close()
        srv.close()
        time.sleep(0.5)
        s2 = _rebind(port)
        conn2, _ = s2.accept()
        conn2.sendall(frames[16:].tobytes())
        time.sleep(1.0)
        conn2.close()
        s2.close()

    th = threading.Thread(target=server, daemon=True)
    th.start()
    rc = _drive(rt, 32)
    th.join(timeout=10)
    assert rt.framecount >= 32 and rt.reader.reconnects >= 1 and rc == 0
    rt.close()
    data = np.fromfile(tmp_path / "out.iq", np.int16)
    assert data.size == 8 * TF * 2


def test_tcp_reader_survives_stream_gap(pkg, tmp_path):
    frames = t_eti.synth_eti_batch(32, mode=1)
    srv, port = _listener()
    rt = _tcp_runtime(pkg, tmp_path, port)

    def server():
        conn, _ = srv.accept()
        conn.sendall(frames[:8].tobytes())
        time.sleep(3.0)                   # stall > 5x timeout
        try:
            conn.sendall(frames[8:16].tobytes())
        except OSError:
            pass
        conn2, _ = srv.accept()
        conn2.sendall(frames[8:].tobytes())
        time.sleep(1.0)
        conn2.close()
        srv.close()

    th = threading.Thread(target=server, daemon=True)
    th.start()
    rc = _drive(rt, 32)
    th.join(timeout=10)
    assert rt.framecount >= 32 and rc == 0
    rt.close()


def test_tcp_reader_short_gap_no_reconnect(pkg):
    frames = t_eti.synth_eti_batch(8, mode=1)
    srv, port = _listener()
    done = threading.Event()

    def server():
        conn, _ = srv.accept()
        conn.sendall(frames[:4].tobytes())
        time.sleep(0.8)                   # < 5 * 0.3 s
        conn.sendall(frames[4:].tobytes())
        done.wait(10)
        conn.close()
        srv.close()

    th = threading.Thread(target=server, daemon=True)
    th.start()
    reader = pkg.readers.EtiTcpReader(f"tcp://127.0.0.1:{port}", timeout=0.3,
                                      reconnect_delay=0.05)
    got = []
    deadline = time.monotonic() + 20
    while sum(len(b) for b in got) < 8 and time.monotonic() < deadline:
        b = reader.read_batch(8)
        if len(b):
            got.append(b)
    assert reader.reconnects == 0
    done.set()
    th.join(timeout=10)
    np.testing.assert_array_equal(np.concatenate(got), frames)
    reader.close()


def test_tcp_reader_waits_for_server(pkg):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    srv.close()                           # port known, nobody listening
    reader = pkg.readers.EtiTcpReader(f"tcp://127.0.0.1:{port}", timeout=0.2,
                                      reconnect_delay=0.05)
    assert len(reader.read_batch(2)) == 0   # no server: empty, not EOF
    frames = t_eti.synth_eti_batch(4, mode=1)
    srv2 = _rebind(port)

    def server():
        conn, _ = srv2.accept()
        conn.sendall(frames.tobytes())
        time.sleep(0.5)
        conn.close()
        srv2.close()

    th = threading.Thread(target=server, daemon=True)
    th.start()
    got = []
    deadline = time.monotonic() + 20
    while sum(len(b) for b in got) < 4 and time.monotonic() < deadline:
        b = reader.read_batch(4)
        if len(b):
            got.append(b)
    th.join(timeout=10)
    assert sum(len(b) for b in got) == 4
    reader.close()


def test_tcp_mux_restart_with_fct_reset(pkg, tmp_path):
    first = t_eti.synth_eti_batch(16, mode=1)
    second = t_eti.synth_eti_batch(16, mode=1, seed=2)   # FCT 0 again
    srv, port = _listener()
    rt = _tcp_runtime(pkg, tmp_path, port)

    def server():
        conn, _ = srv.accept()
        conn.sendall(first.tobytes())
        conn.close()
        srv.close()
        time.sleep(0.5)
        s2 = _rebind(port)
        conn2, _ = s2.accept()
        conn2.sendall(second.tobytes())
        time.sleep(1.0)
        conn2.close()
        s2.close()

    th = threading.Thread(target=server, daemon=True)
    th.start()
    rc = _drive(rt, 32)
    th.join(timeout=10)
    assert rt.framecount >= 32 and rt.num_restarts >= 1 and rc == 0
    rt.close()


def test_tcp_silent_server_reconnects_from_connect(pkg):
    srv, port = _listener()
    accepted = []

    def server():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            accepted.append(conn)

    threading.Thread(target=server, daemon=True).start()
    r = pkg.readers.EtiTcpReader(f"tcp://127.0.0.1:{port}", timeout=0.3,
                                 reconnect_delay=0.05)
    try:
        t0 = time.monotonic()
        deadline = t0 + 10.0
        while r.reconnects == 0 and time.monotonic() < deadline:
            assert r.read_batch(1).size == 0
        assert r.reconnects >= 1
        assert time.monotonic() - t0 < 8.0
        while len(accepted) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(accepted) >= 2
    finally:
        r.close()
        srv.close()
        for c in accepted:
            c.close()


def test_tcp_stop_latency_mid_recv(pkg, tmp_path):
    """stop() during a stalled stream ends the run within ~1 s, not after
    the 8 s receive timeout."""
    frames = t_eti.synth_eti_batch(8, mode=1)
    srv, port = _listener()
    conns = []

    def server():
        conn, _ = srv.accept()
        conns.append(conn)
        conn.sendall(frames.tobytes())

    threading.Thread(target=server, daemon=True).start()
    rt = _tcp_runtime(pkg, tmp_path, port, timeout=8.0, reconnect=0.5)
    rc = []
    t = threading.Thread(target=lambda: rc.append(rt.run()), daemon=True)
    t.start()
    t0 = time.monotonic()
    while rt.framecount < 8 and time.monotonic() - t0 < 60:
        time.sleep(0.05)
    assert rt.framecount >= 8
    time.sleep(1.0)
    t1 = time.monotonic()
    rt.stop()
    t.join(timeout=5)
    assert not t.is_alive(), "runtime failed to stop"
    assert time.monotonic() - t1 < 2.0
    rt.close()
    srv.close()
    for c in conns:
        c.close()


# ---------------------------------------------------------------------------
# open_input, and the output sinks' choice and wire formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport,name,kind", [
    ("edi", "tcp://127.0.0.1:{port}", "EdiInput"),
    ("file", "udp://127.0.0.1:0", "EdiInput"),
    ("tcp", "127.0.0.1:{port}", "EtiTcpReader"),
    ("file", "tcp://127.0.0.1:{port}", "EtiTcpReader"),
    ("zmq", "{eti}", "EtiFileReader"),
    ("file", "{eti}", "EtiFileReader")])
def test_open_input_chooses_the_reader(pkg, tmp_path, transport, name, kind):
    """open_input opens EDI for transport=edi or a udp:// source, ETI over
    TCP for transport=tcp or a tcp:// source, and the file reader for
    anything else, transport=zmq included."""
    eti = tmp_path / "in.eti"
    eti.write_bytes(t_eti.synth_eti_batch(4, mode=1).tobytes())
    srv = TcpServer(b"")
    try:
        s = pkg.Settings(input_transport=transport, input_name=name.format(
            port=srv.port, eti=eti), tcp_timeout=0.2)
        reader = pkg.readers.open_input(s)
        try:
            assert type(reader).__name__ == kind
            if kind == "EtiFileReader":
                assert reader.read_batch(4).shape == (4, 6144)
            else:
                assert reader.never_eof
        finally:
            if kind == "EdiInput":
                reader.transport.sock.close()
            else:
                reader.close()
    finally:
        srv.close()


@pytest.mark.parametrize("fmt", ["complexf", "complexf_normalised", "s16",
                                 "u8", "s8"])
@pytest.mark.parametrize("kind", ["pairs", "complex", "wire"])
def test_serialize_iq_matches_reference(fmt, kind):
    """The port's serialize_iq_count (NumPy only) gives dabmod_tpu's bytes
    and clip count, float pairs or complex in, integer wire words through."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 50, 2)) * 30000).astype(np.float32)
    if kind == "complex":
        x = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    elif kind == "wire":
        x = x.astype(np.int16).reshape(3, -1).view(np.int32)
    assert (t_outputs.serialize_iq_count(x, fmt)
            == j_outputs.serialize_iq_count(x, fmt))
    assert t_outputs.serialize_iq(x, fmt) == j_outputs.serialize_iq(x, fmt)


def test_unknown_output_raises_alike():
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="unsupported output"):
            pkg.outputs.open_output(pkg.Settings(output="nonsense"))


@pytest.mark.parametrize("fmt", ["s16", "complexf"])
def test_zmq_rep_wire_equals_the_file_sink(pkg, tmp_path, fmt):
    """tests/test_wire_formats.py's ZeroMQ case: a REP sink sends each
    batch on request, the file sink's bytes (s16 at half the f32 size)."""
    zmq = pytest.importorskip("zmq")
    inp = tmp_path / "in.eti"
    inp.write_bytes(t_eti.synth_eti_batch(8, mode=1).tobytes())
    sf = pkg.Settings(input_name=str(inp), output="file",
                      output_name=str(tmp_path / "ref.iq"),
                      file_output_format=fmt,
                      batch_tf=1).normalise_for_output()
    rt = pkg.runtime(sf)
    assert rt.run() == 0
    rt.close()
    ref_bytes = (tmp_path / "ref.iq").read_bytes()
    port = free_port()
    sz = pkg.Settings(input_name=str(inp), output="zmq",
                      output_name=f"tcp://127.0.0.1:{port}",
                      zmq_output_socket_type="rep", zmq_output_format=fmt,
                      batch_tf=1).normalise_for_output()
    if fmt == "complexf":
        # the same scale as the file sink's, so the bytes compare
        sz.normalise = sf.normalise
    rtz = pkg.runtime(sz)
    received = []

    def consumer():
        sock = zmq.Context.instance().socket(zmq.REQ)
        sock.connect(f"tcp://127.0.0.1:{port}")
        sock.setsockopt(zmq.RCVTIMEO, 10000)
        sock.setsockopt(zmq.LINGER, 0)
        try:
            for _ in range(2):
                sock.send(b"")
                received.append(sock.recv())
        finally:
            sock.close()

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    assert rtz.run() == 0
    t.join(timeout=15)
    rtz.close()
    data = b"".join(received)
    assert len(data) == 2 * TF * 2 * (2 if fmt == "s16" else 4)
    assert data == ref_bytes


# ---------------------------------------------------------------------------
# the copies' constants and tables
# ---------------------------------------------------------------------------

COPIES = [(t_rs, j_rs), (t_edi, j_edi), (t_readers, j_readers),
          (t_outputs, j_outputs), (t_sdr, j_sdr), (t_uhd, j_uhd),
          (t_soapy, j_soapy), (t_lime, j_lime), (t_bladerf, j_bladerf),
          (t_dexter, j_dexter), (t_utils, j_utils)]


def _constants(mod):
    """A module's own data: numbers, strings, tuples, lists, dicts, sets
    and arrays bound at module level (not classes, functions, modules or
    loggers)."""
    kinds = (int, float, str, bytes, tuple, list, dict, frozenset, set,
             np.ndarray)
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and isinstance(v, kinds)
            and not isinstance(v, bool)}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("port,ref", COPIES,
                         ids=[r.__name__ for _, r in COPIES])
def test_copied_constants_equal(port, ref):
    """Every constant and table of the original module is in the copy,
    with the same value (edi's CRC table lives in the port's
    io/fic_decoder.py); every dataclass's field defaults are the same."""
    got, want = _constants(port), _constants(ref)
    if ref is j_edi:
        got["_CRC_TAB"] = t_fic._CRC_TAB
    assert set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        assert _same(got[k], v), k
    for name, cls in vars(ref).items():
        if isinstance(cls, type) and dataclasses.is_dataclass(cls) \
                and cls.__module__ == ref.__name__:
            a = {f.name: f.default for f in dataclasses.fields(
                getattr(port, name))}
            b = {f.name: f.default for f in dataclasses.fields(cls)}
            assert a == b, name
