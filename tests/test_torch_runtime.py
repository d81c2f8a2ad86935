"""The port's runtime and CLI (dabmod_tpu_torch.runtime, .cli, .io, .rc,
.events, .timestamps) on the CPU: INI file in, I/Q file out, against
dabmod_tpu.cli on the same ETI file, and the cases of tests/test_runtime.py
and tests/test_rc.py run against the port.

Tolerances of the output files: f32 within 3e-5*max|ref|
(tests/test_ofdm_kernel.py:88-89: fp32 transforms and gain reductions
summed in other orders); s16 within 1 LSB (a float difference at a
truncation edge); the kiss and dexter chains byte for byte (integer
arithmetic from the Q1.14 symbols on).
"""
import json
import logging
import os
import signal
import socket
import threading

import numpy as np
import pytest
import torch

from dabmod_tpu import cli as j_cli
from dabmod_tpu import timestamps as j_timestamps
from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.io import fic_decoder as j_fic
from dabmod_tpu.io import readers as j_readers
from dabmod_tpu.io.edi import crc16 as j_crc16
from dabmod_tpu.models import Modulator as JModulator
from dabmod_tpu.models import make_default_layout as j_layout
from dabmod_tpu.rc import dispatch_line as j_dispatch_line
from dabmod_tpu_torch import cli, events, tables, timestamps
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import build_eti_frame, synth_eti_batch
from dabmod_tpu_torch.io import fic_decoder, readers
from dabmod_tpu_torch.io.readers import EtiFileReader
from dabmod_tpu_torch.models import Modulator, make_default_layout
from dabmod_tpu_torch.rc import ParameterError, dispatch_line, rcs
from dabmod_tpu_torch.runtime import ModRuntime, RunResult
import test_fic_decoder as figs
from torch_threads import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # bench.py's ensemble
TF = tables.mode_params(1).tf_samples


@pytest.fixture(autouse=True)
def _rc_servers_down():
    """The port's RC registry is one per process: stop any server a test
    started, so the next test in this worker starts clean."""
    yield
    rcs.shutdown()


def _write_raw(tmp_path, frames, name="in.eti"):
    path = tmp_path / name
    path.write_bytes(frames.tobytes())
    return str(path)


def _settings(inp, out, fmt="complexf", **kw):
    s = ModSettings(input_name=inp, output="file", output_name=out,
                    file_output_format=fmt, **kw)
    return s.normalise_for_output()


def _run(settings):
    rt = ModRuntime(settings, device="cpu")
    try:
        assert rt.run() == 0
    finally:
        rt.close()
    return rt


# ---------------------------------------------------------------------------
# the CLI against dabmod_tpu.cli: one INI, one ETI file, two output files
# ---------------------------------------------------------------------------

CLI_CASES = {
    "complexf": ("complexf", ""),
    "s16": ("s16", ""),
    "s16_fir_cfr_3m072": ("s16", "rate=3072000\n[firfilter]\nenabled=1\n"
                          "[cfr]\nenable=1\nclip=40.0\nerrorclip=3.0\n"),
    "kiss": ("s16", "fft_engine=kiss\nofdmwindowing=90\n"),
    "dexter": ("s16", "fft_engine=dexter\n"),
}
N_FRAMES = 8            # 2 TFs of TM I, 2 batches of batch_tf=1


def _ini(directory, case, inp):
    fmt, extra = CLI_CASES[case]
    path = os.path.join(directory, f"{case}.ini")
    with open(path, "w") as f:
        f.write(f"[input]\ntransport=file\nsource={inp}\n"
                f"[fileoutput]\nfilename={directory}/{case}.iq\n"
                f"format={fmt}\n[modulator]\ngainmode=var\nbatch_tf=1\n"
                f"{extra}")
    return path


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """dabmod_tpu.cli on each case's INI, once for this module: (ETI file,
    {case: output bytes})."""
    d = tmp_path_factory.mktemp("reference")
    inp = _write_raw(d, synth_eti_batch(N_FRAMES, mode=1,
                                        subch_specs=BENCH_SPECS, seed=31))
    out = {}
    for case in CLI_CASES:
        assert j_cli.main([_ini(str(d), case, inp)]) == 0
        out[case] = (d / f"{case}.iq").read_bytes()
    return inp, out


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_reference(case, reference, tmp_path):
    inp, ref_out = reference
    handlers = [signal.getsignal(sig) for sig in (signal.SIGINT,
                                                  signal.SIGTERM)]
    assert cli.main([_ini(str(tmp_path), case, inp), "--device", "cpu"]) == 0
    # the CLI's stop handlers are gone once it returns (dabmod_tpu's stay)
    assert handlers == [signal.getsignal(sig) for sig in (signal.SIGINT,
                                                          signal.SIGTERM)]
    got = (tmp_path / f"{case}.iq").read_bytes()
    ref = ref_out[case]
    assert len(got) == len(ref) > 0
    fmt = CLI_CASES[case][0]
    rate = 3 if case.endswith("3m072") else 2
    assert len(got) == N_FRAMES // 4 * TF * rate // 2 * 2 * (
        4 if fmt == "complexf" else 2)
    if case in ("kiss", "dexter"):
        assert got == ref
    elif fmt == "s16":
        d = np.abs(np.frombuffer(got, np.int16).astype(np.int32)
                   - np.frombuffer(ref, np.int16))
        assert d.max() <= 1, d.max()
    else:
        g, r = np.frombuffer(got, np.float32), np.frombuffer(ref, np.float32)
        np.testing.assert_allclose(g, r, atol=3e-5 * np.abs(r).max())


def test_device_format_conversion_end_to_end(tmp_path):
    """s16 output converted on the device equals the host-converted path
    byte for byte (tests/test_runtime.py:135-154)."""
    inp = _write_raw(tmp_path, synth_eti_batch(8, mode=1))
    outs = {}
    for dev_conv in (True, False):
        out = str(tmp_path / f"out_{dev_conv}.iq")
        _run(_settings(inp, out, "s16", batch_tf=2,
                       device_format_conversion=dev_conv))
        outs[dev_conv] = open(out, "rb").read()
    assert len(outs[True]) == 2 * TF * 2 * 2
    assert outs[True] == outs[False]


@pytest.mark.parametrize("fmt,kw", [
    ("complexf", {}), ("complexf", {"device_interleave": True}),
    ("s16", {}), ("u8", {}), ("s16", {"device_format_conversion": False})])
def test_emits_planes_matches_reference(fmt, kw):
    """The planes contract (ModSettings.device_interleave) of every wire
    format and engine is dabmod_tpu's."""
    for engine in ("fftw", "kiss", "dexter"):
        # TM III: the smallest tables (and dexter's accelerator model)
        s = {"dab_mode": 3, "fft_engine": engine, "output": "file",
             "file_output_format": fmt, "device_interleave": False, **kw}
        m = Modulator(make_default_layout(3), ModSettings(**s), device="cpu")
        mj = JModulator(j_layout(3), JSettings(**s))
        assert m.emits_planes == mj.emits_planes, (engine, fmt, kw)
        assert m._wire_fmt == mj._wire_fmt


# ---------------------------------------------------------------------------
# the runtime's supervisor (tests/test_runtime.py), on the port
# ---------------------------------------------------------------------------

def test_runtime_fct_discontinuity_restart(tmp_path):
    """Two frames dropped after 2 TFs: a restart, and no FP-0 frame left
    to realign to, so the 2 TFs before the break are all the output."""
    frames = synth_eti_batch(16, mode=1)
    inp = _write_raw(tmp_path, np.concatenate([frames[:8], frames[10:]]))
    out = str(tmp_path / "out.iq")
    rt = _run(_settings(inp, out, batch_tf=1))
    assert rt.num_restarts == 1
    assert np.fromfile(out, np.float32).size == 2 * TF * 2


def test_runtime_fp_alignment(tmp_path):
    """Frames before the first FP-0 frame are dropped
    (ref: src/DabMod.cpp:683-692): 12 aligned frames, 3 TFs."""
    layout = make_default_layout(1)
    rng = np.random.default_rng(1)
    frames = [build_eti_frame(
        layout, fct=t, fic=rng.integers(0, 256, 96, dtype=np.uint8),
        subch_data=[rng.integers(0, 256, p.framesize, dtype=np.uint8)
                    for p in layout.subchannels], fp=(6 + t) % 8)
        for t in range(14)]
    inp = _write_raw(tmp_path, np.stack(frames))
    out = str(tmp_path / "out.iq")
    _run(_settings(inp, out, batch_tf=1))
    assert np.fromfile(out, np.float32).size == 3 * TF * 2


def test_cli_fifo_end_to_end(tmp_path):
    """The CLI consumes a FIFO (the /dev/stdin case) while the producer is
    still writing."""
    frames = synth_eti_batch(8, mode=1)
    fifo = str(tmp_path / "in.fifo")
    os.mkfifo(fifo)

    def writer():
        with open(fifo, "wb") as w:
            for f in frames:
                w.write(f.tobytes())
                w.flush()

    t = threading.Thread(target=writer)
    t.start()
    out = str(tmp_path / "fifo_out.iq")
    rc = cli.main([fifo, "-f", out, "-F", "s16", "-b", "2", "--device",
                   "cpu"])
    t.join(timeout=30)
    assert rc == 0 and not t.is_alive()
    data = np.fromfile(out, np.int16)
    assert data.size == 2 * TF * 2
    assert 8000 < np.abs(data).max() <= 32767


def test_runtime_loops_its_input(tmp_path):
    """loop=1 wraps the file of 3 TFs: the wrap's FCT jump ends the first
    run_batches with a restart request (the reference restarts there
    too), and the next one goes on past the end of the file."""
    inp = _write_raw(tmp_path, synth_eti_batch(12, mode=1))
    out = str(tmp_path / "out.iq")
    rt = ModRuntime(_settings(inp, out, batch_tf=1, loop=True), device="cpu")
    assert rt.run_batches(max_batches=5) == RunResult.AGAIN
    rt.state = rt.modulator.init_state()
    assert rt.run_batches(max_batches=2) == RunResult.NORMAL_END
    rt.close()
    assert np.fromfile(out, np.float32).size == 5 * TF * 2


def test_dynamic_offset_file_reread(tmp_path):
    """delaymanagement management=dynamic: a change to the offset file
    takes effect mid-run, without a restart."""
    inp = _write_raw(tmp_path, synth_eti_batch(16, mode=1))
    off = tmp_path / "offset.txt"
    off.write_text("0.5\n")
    rt = ModRuntime(_settings(inp, str(tmp_path / "dyn.iq"), "s16",
                              batch_tf=2, tist_enabled=True,
                              tist_delay_management="dynamic",
                              tist_dynamic_offset_file=str(off)),
                    device="cpu")
    rt.run_batches(max_batches=1)
    assert rt.ts_decoder.offset_s == 0.5
    off.write_text("0.8\n")
    st = os.stat(off)
    os.utime(off, (st.st_atime, st.st_mtime + 2))
    rt.run_batches(max_batches=1)
    assert rt.ts_decoder.offset_s == 0.8
    rt.close()


def test_trace_dir_dumps_and_same_output(tmp_path):
    """[log] trace_dir through the runtime: the stage files of both
    batches, and the output of the untraced run within 1 LSB."""
    inp = _write_raw(tmp_path, synth_eti_batch(8, mode=1))
    trace = tmp_path / "trace"
    _run(_settings(inp, str(tmp_path / "t.iq"), "s16", batch_tf=1,
                   trace_dir=str(trace)))
    _run(_settings(inp, str(tmp_path / "c.iq"), "s16", batch_tf=1))
    t = np.fromfile(tmp_path / "t.iq", np.int16).astype(np.int32)
    c = np.fromfile(tmp_path / "c.iq", np.int16).astype(np.int32)
    assert t.size == c.size == 2 * TF * 2
    assert np.abs(t - c).max() <= 1
    names = sorted(os.listdir(trace))
    gi = [n for n in names if n.endswith("guard_interval.dat")]
    assert gi and (trace / gi[0]).stat().st_size == 2 * TF * 2 * 4


def test_show_metadata_logs_fct(tmp_path, caplog):
    inp = _write_raw(tmp_path, synth_eti_batch(8, mode=1))
    with caplog.at_level(logging.WARNING, logger="dabmod_tpu_torch"):
        _run(_settings(inp, str(tmp_path / "o.iq"), batch_tf=1,
                       file_output_show_metadata=True))
    assert not any("FCT discontinuity" in m for m in caplog.messages)


# ---------------------------------------------------------------------------
# the device rule and the statistics the RC reads
# ---------------------------------------------------------------------------

def test_runtime_and_cli_default_to_the_card(tmp_path):
    inp = _write_raw(tmp_path, synth_eti_batch(4, mode=1))
    out = tmp_path / "o.iq"
    if torch.cuda.is_available():
        rt = ModRuntime(_settings(inp, str(out)))
        assert rt.device.type == "cuda"
        rt.close()
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModRuntime(_settings(inp, str(out)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([inp, "-f", str(out)])
    assert not out.exists()
    rt = ModRuntime(_settings(inp, str(out)), device="cpu")
    assert rt.device.type == "cpu"
    rt.close()


def test_batch_carries_the_host_backend_it_was_made_for(tmp_path):
    """A dexter batch reaches the fetch thread with the host chain of the
    modulator that made it, so a rebuild while batches are in flight (an
    RC windowlen change) cannot run another chain on them (dabmod_tpu's
    fetch thread reads the runtime's current modulator)."""
    p = tables.mode_params(3)
    inp = _write_raw(tmp_path, synth_eti_batch(8 * p.cif_count, mode=3))
    rt = ModRuntime(_settings(inp, str(tmp_path / "o.iq"), "s16",
                              fft_engine="dexter", batch_tf=2),
                    device="cpu")
    items = []
    put = rt._out_queue.put
    rt._out_queue.put = lambda item: (items.append(item), put(item))
    rt.run_batches(max_batches=1)
    chain = rt.modulator.host_backend
    rcs.set_param("guardinterval", "windowlen", "12")
    rt.run_batches(max_batches=1)
    rt.close()
    batches = [i for i in items if isinstance(i, tuple)]
    assert [b[3] for b in batches] == [chain, rt.modulator.host_backend]
    assert rt.modulator.host_backend is not chain
    assert rt.modulator.host_backend.window_overlap == 12


def test_rc_statistics_after_a_cfr_run(tmp_path):
    """The CFR statistics reach the RC accumulators from the fetch thread
    (host arrays, never a device tensor)."""
    inp = _write_raw(tmp_path, synth_eti_batch(8, mode=1))
    rt = _run(_settings(inp, str(tmp_path / "o.iq"), batch_tf=2,
                        enable_cfr=True, cfr_clip=30.0,
                        cfr_error_clip=0.1))
    assert isinstance(rt.last_stats["cfr_clip"], np.ndarray)
    clip = rcs.get_param("ofdm", "clip_stats")
    assert clip.startswith("Statistics : ") and "MER after CFR" in clip
    before, after = rcs.get_param("ofdm", "papr").split(": ")[1].split(", ")
    assert float(before) > float(after) > 0
    assert rt.timings["modulate_s"] > 0 and rt.timings["write_s"] > 0


# ---------------------------------------------------------------------------
# the remote control (tests/test_rc.py) on the port's registry
# ---------------------------------------------------------------------------

def test_runtime_rc_rebuild(tmp_path):
    """A structural parameter change over RC builds a new modulator on the
    main thread and keeps the time-interleaver history
    (tests/test_rc.py:108-139)."""
    inp = _write_raw(tmp_path, synth_eti_batch(16, mode=1))
    rt = ModRuntime(_settings(inp, str(tmp_path / "out.iq"), batch_tf=1),
                    device="cpu")
    rt.run_batches(max_batches=1)
    hist_before = rt.state["ti_history"][0].clone()
    mod_before = rt.modulator
    rcs.set_param("gain", "mode", "max")
    rt.run_batches(max_batches=1)
    assert rt.modulator is not mod_before
    assert rt.modulator.settings.gain_mode == 1
    assert rt.state["ti_history"][0].shape == hist_before.shape
    assert int(rt.state["tf_index"]) == 2
    mod2 = rt.modulator
    rcs.set_param("gain", "digital", "0.5")
    rt.run_batches(max_batches=1)
    assert rt.modulator is mod2
    assert rcs.get_param("modulator", "rate") == "2048000"
    assert rcs.get_param("modulator", "frames") == "12"
    rt.close()


def _registries():
    """The same registry in the port's rc module and in dabmod_tpu's."""
    from dabmod_tpu import rc as j_rc
    from dabmod_tpu_torch import rc as t_rc
    out = []
    for mod in (t_rc, j_rc):
        reg = mod.RemoteControllers()
        c = mod.RemoteControllable("gain")
        state = {"digital": 1.0}
        c.add_parameter("digital", "Digital Gain", lambda s=state:
                        s["digital"], lambda v, s=state:
                        s.__setitem__("digital", float(v)))
        c.add_parameter("ro", "read only", lambda: 42)
        reg.enrol(c)
        out.append((reg, state))
    return out


@pytest.mark.parametrize("line", [
    "help", "list", "show gain", "get gain digital", "set gain digital 3.0",
    "get gain nope", "set gain ro 1", "show nomodule", "quit", "bogus", ""])
def test_telnet_dispatch_matches_reference(line):
    (reg, state), (jreg, jstate) = _registries()
    assert dispatch_line(reg, line) == j_dispatch_line(jreg, line)
    assert state == jstate


def test_registry_get_set():
    reg, state = _registries()[0]
    reg.set_param("gain", "digital", "2.5")
    assert state["digital"] == 2.5 and reg.get_param("gain", "digital") == "2.5"
    for args in (("gain", "ro", "1"), ("gain", "nope", "1")):
        with pytest.raises(ParameterError):
            reg.set_param(*args)
    with pytest.raises(ParameterError):
        reg.get_param("nomodule", "x")


def test_telnet_server_roundtrip():
    reg, state = _registries()[0]
    srv = reg.add_telnet(0)
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=5) as c:
            f = c.makefile("rwb")
            assert b"help" in f.readline()
            f.write(b"set gain digital 7\nget gain digital\nquit\n")
            f.flush()
            assert [f.readline().strip() for _ in range(3)] == [
                b"ok", b"7.0", b"Goodbye"]
        assert state["digital"] == 7.0
    finally:
        reg.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_zmq_rc_protocol():
    zmq = pytest.importorskip("zmq")
    reg, state = _registries()[0]
    ep = f"tcp://127.0.0.1:{_free_port()}"
    reg.add_zmq(ep)
    try:
        s = zmq.Context.instance().socket(zmq.REQ)
        s.setsockopt(zmq.LINGER, 0)
        s.setsockopt(zmq.RCVTIMEO, 5000)
        s.connect(ep)
        for req, rep in (([b"ping"], [b"ok"]), ([b"list"], [b"ok", b"gain"]),
                         ([b"set", b"gain", b"digital", b"9"], [b"ok"]),
                         ([b"get", b"gain", b"digital"], [b"9.0"])):
            s.send_multipart(req)
            assert s.recv_multipart() == rep
        s.send_multipart([b"get", b"gain", b"bogus"])
        assert s.recv_multipart()[0] == b"fail"
        s.close()
        assert state["digital"] == 9.0
    finally:
        reg.shutdown()


def test_events_log_handler_forwards_warnings(monkeypatch):
    sent = []
    monkeypatch.setattr(events.events, "send",
                        lambda name, detail: sent.append((name, detail)))
    handler = events.EventLogHandler()
    lg = logging.getLogger("dabmod_tpu_torch.test_events")
    lg.addHandler(handler)
    try:
        lg.info("quiet")
        lg.warning("loud %d", 1)
    finally:
        lg.removeHandler(handler)
    assert sent == [("warning", {"message": "loud 1"})]
    events.EventSender().send("x", {})          # unbound: a no-op


# ---------------------------------------------------------------------------
# the copied host modules against their originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [readers, j_readers],
                         ids=["dabmod_tpu_torch", "dabmod_tpu"])
def test_file_reader_framing(mod, tmp_path):
    frames = synth_eti_batch(6, mode=1)
    r = mod.EtiFileReader(_write_raw(tmp_path, frames))
    assert r.streamtype == "raw"
    np.testing.assert_array_equal(r.frames(), frames)
    blob = b"".join(int(6144).to_bytes(2, "little") + f.tobytes()
                    for f in frames)
    (tmp_path / "streamed.eti").write_bytes(blob)
    r = mod.EtiFileReader(str(tmp_path / "streamed.eti"))
    assert r.streamtype == "streamed"
    np.testing.assert_array_equal(r.frames(), frames)
    (tmp_path / "framed.eti").write_bytes(int(6).to_bytes(4, "little") + blob)
    r = mod.EtiFileReader(str(tmp_path / "framed.eti"))
    assert r.streamtype == "framed"
    np.testing.assert_array_equal(r.frames(), frames)
    (tmp_path / "offset.eti").write_bytes(b"\x00\x01\x02" + frames.tobytes())
    r = mod.EtiFileReader(str(tmp_path / "offset.eti"))
    assert r.streamtype == "raw"
    np.testing.assert_array_equal(r.frames(), frames)
    r = mod.EtiFileReader(_write_raw(tmp_path, frames[:3]), loop=True)
    got = r.read_batch(7)
    np.testing.assert_array_equal(got[3:6], frames[:3])
    np.testing.assert_array_equal(got[6], frames[0])
    r.close()


def test_file_reader_streaming_pipe():
    """Frames fed through an os.pipe come out batch by batch before the
    writer closes (src/InputFileReader.cpp:219-288), and a dribbled sync
    search still frames correctly."""
    frames = synth_eti_batch(6, mode=1)
    rfd, wfd = os.pipe()
    first_two_read = threading.Event()

    def writer():
        with os.fdopen(wfd, "wb") as w:
            data = frames[:2].tobytes()
            for b in data[:64]:               # dribble the sync search
                w.write(bytes([b]))
                w.flush()
            w.write(data[64:])
            w.flush()
            assert first_two_read.wait(timeout=10)
            w.write(frames[2:].tobytes())

    t = threading.Thread(target=writer)
    t.start()
    r = EtiFileReader("pipe", fileobj=os.fdopen(rfd, "rb"))
    np.testing.assert_array_equal(r.read_batch(2), frames[:2])
    first_two_read.set()
    np.testing.assert_array_equal(r.read_batch(4), frames[2:])
    t.join(timeout=10)
    assert not t.is_alive()
    assert r.read_batch(1).size == 0
    r.close()


def test_file_reader_loop_warns_on_pipe(caplog):
    import io as io_mod
    frames = synth_eti_batch(2, mode=1)

    class Unseekable(io_mod.BytesIO):
        def seekable(self):
            return False

    with caplog.at_level(logging.WARNING, logger="dabmod_tpu_torch"):
        r = EtiFileReader("pipe", loop=True,
                          fileobj=Unseekable(frames.tobytes()))
        assert not r.loop
    assert any("not seekable" in m for m in caplog.messages)
    assert len(r.frames()) == 2


@pytest.mark.parametrize("mod", [timestamps, j_timestamps],
                         ids=["dabmod_tpu_torch", "dabmod_tpu"])
def test_timestamp_decoder_cases(mod):
    """tests/test_runtime.py:205-232 on both copies: the MNSC time of day
    over the four frame phases, and the PPS wraparound."""
    import calendar

    def bcd(v):
        return ((v // 10) << 4) | (v % 10)
    td = mod.TimestampDecoder()
    for i, mn in enumerate([0x0000, (bcd(56) & 0x7F) | ((bcd(34) | 0x80) << 8),
                            bcd(12) | (bcd(17) << 8),
                            bcd(8) | (bcd(26) << 8)]):
        td.update_eti(i, mn, pps=1_000_000, fct=i)
    ts = td.timestamp()
    assert ts.valid and ts.pps == 1_000_000
    assert ts.seconds == calendar.timegm((2026, 8, 17, 12, 34, 56, 0, 0, 0))
    td = mod.TimestampDecoder(offset_s=0.25)
    td.update_eti(0, 0, pps=16_000_000, fct=0)
    secs0 = td.time_secs
    td.update_eti(1, 0x8000, pps=100_000, fct=1)
    assert td.time_secs == secs0 + 1 and td.inhibit_second_update == 2
    assert td.timestamp().pps == 100_000 + 4_096_000


def test_timestamp_batches_match_reference():
    frames = synth_eti_batch(8, mode=1)
    from dabmod_tpu_torch.eti import parse_eti_frames
    b = parse_eti_frames(frames)
    got = timestamps.TimestampDecoder(1.5).update_eti_batch(
        b.fp, b.mnsc, b.tist_pps, b.fct, 4)
    want = j_timestamps.TimestampDecoder(1.5).update_eti_batch(
        b.fp, b.mnsc, b.tist_pps, b.fct, 4)
    assert [vars(t) for t in got] == [vars(t) for t in want]


def test_fic_decoder_matches_reference():
    """The FIBs of tests/test_fic_decoder.py through both decoders give
    the same ensemble information; the CRC copy equals the original."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 30, 97):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert fic_decoder.crc16(data) == j_crc16(data)
    long_form = bytes([(5 << 2), 100, 0x80 | (2 << 2), 48])
    stream = [figs.fib(figs.fig00) + figs.fib(figs.fig10),
              figs.fib(figs.fig11 + figs.fig02),
              figs.fib(figs.fig0(1, long_form + bytes([(6 << 2), 200, 19]))),
              figs.fib(figs.fig0(9, bytes([0x02, 0xE1, 0x01]))),
              figs.fib(figs.fig0(17, bytes([0x81, 0x11, 0x00, 10]))),
              bytes(32)]                        # a FIB with a bad CRC
    got, want = fic_decoder.FICDecoder(), j_fic.FICDecoder()
    for fib in stream:
        got.process(fib)
        want.process(fib)
    assert json.dumps(got.ensemble.to_json(), sort_keys=True) == json.dumps(
        want.ensemble.to_json(), sort_keys=True)
    assert got.ensemble.to_json()["ensemble"]["label"] == "Test Ensemble"
