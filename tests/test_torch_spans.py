"""The port's spans and counters (dabmod_tpu_torch/utils/spans.py and
ModRuntime.timings) on the CPU: every key from construction, the main
thread's spans after a file run, the stream readers' decode apart from
their socket's wait, the profiler ranges only while a profiler records,
and SdrOutput's queue wait."""
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import synth_eti_batch
from dabmod_tpu_torch.rc import rcs
from dabmod_tpu_torch.runtime import TIMINGS, ModRuntime
from dabmod_tpu_torch.utils import spans
from live_stream import TcpServer, drive, edi_stream
from torch_threads import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

MAIN_SPANS = ("read", "parse", "stage_in", "issue", "copy_out", "handoff")


@pytest.fixture(autouse=True)
def _rc_servers_down():
    yield
    rcs.shutdown()


def _file(tmp_path, n_frames, seed=61):
    path = tmp_path / "in.eti"
    path.write_bytes(synth_eti_batch(n_frames, mode=1, seed=seed).tobytes())
    return str(path)


def _file_run(tmp_path, n_frames=8, **kw):
    s = ModSettings(input_name=_file(tmp_path, n_frames), output="file",
                    output_name=str(tmp_path / "out.iq"),
                    file_output_format="complexf", **kw)
    rt = ModRuntime(s.normalise_for_output(), device="cpu")
    try:
        assert rt.run() == 0
    finally:
        rt.close()
    return rt


def test_every_timings_key_exists_at_construction(tmp_path):
    s = ModSettings(input_name=_file(tmp_path, 4), output="file",
                    output_name=str(tmp_path / "out.iq"))
    rt = ModRuntime(s.normalise_for_output(), device="cpu")
    rt.close()
    assert tuple(rt.timings) == TIMINGS
    assert set(TIMINGS) == {
        "read_s", "read_decode_s", "parse_s", "stage_in_s", "modulate_s",
        "copy_out_s", "handoff_s", "fetch_wait_s", "fetch_s", "write_s",
        "sink_queue_s"}
    assert all(v == 0 for v in rt.timings.values())


def test_file_run_fills_the_main_threads_spans(tmp_path):
    t = _file_run(tmp_path, batch_tf=1).timings
    assert t["parse_s"] > 0 and t["modulate_s"] > 0
    assert t["read_s"] > 0 and t["fetch_s"] > 0 and t["write_s"] > 0
    # a file reader has no decode of its own; no SDR sink, no queue
    assert t["read_decode_s"] == 0 and t["sink_queue_s"] == 0


@pytest.mark.parametrize("transport", ["edi", "tcp"])
def test_stream_reader_decode_apart_from_the_wait(transport, tmp_path):
    """EDI over TCP (AF/TAG decode, CRC, the rebuild into ETI) and ETI
    over TCP (framing): the decode is summed apart from the socket's wait,
    folded into the runtime's timings, and lies inside the read."""
    frames = synth_eti_batch(16, mode=1, seed=62)
    if transport == "edi":
        srv = TcpServer(b"".join(edi_stream(frames, 1_800_000_000.0)))
    else:
        srv = TcpServer(frames.tobytes())
    s = ModSettings(input_transport=transport,
                    input_name=f"tcp://127.0.0.1:{srv.port}", output="file",
                    output_name=str(tmp_path / "out.iq"), batch_tf=2)
    rt = ModRuntime(s.normalise_for_output(), device="cpu")
    try:
        drive(rt, 16, deadline_s=30)
    finally:
        rt.close()
        srv.close()
    t = rt.timings
    assert rt.framecount == 16
    assert t["read_decode_s"] == rt.reader.decode_s
    assert 0 < t["read_decode_s"] <= t["read_s"]


def test_spans_open_no_range_without_a_profiler(tmp_path, monkeypatch):
    calls = []
    real = spans._profiler.record_function

    def counting(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(spans._profiler, "record_function", counting)
    _file_run(tmp_path, batch_tf=1)
    assert calls == []
    timings = {"x_s": 0.0}
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span(timings, "probe", key="x"):
            pass
        with spans.span(None, "alone"):
            pass
    with spans.span(timings, "after", key="x"):
        pass
    assert calls == ["dabmod.probe", "dabmod.alone"]
    assert timings["x_s"] > 0


def test_spans_are_ranges_under_a_cpu_profiler(tmp_path):
    """Under a profiler that records every thread, the main thread's spans
    and the fetch and writer threads' show as dabmod.* ranges."""
    from torch._C._profiler import _ExperimentalConfig
    s = ModSettings(input_name=_file(tmp_path, 8), output="file",
                    output_name=str(tmp_path / "out.iq"),
                    file_output_format="complexf", batch_tf=1)
    rt = ModRuntime(s.normalise_for_output(), device="cpu")
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            assert rt.run_batches(None).name == "NORMAL_END"
    finally:
        rt.close()
    names = {e.name for e in prof.events()
             if e.name.startswith(spans.RANGE_PREFIX)}
    assert {"dabmod." + n for n in MAIN_SPANS} <= names
    assert {"dabmod.fetch", "dabmod.write"} <= names


def test_sdr_output_counts_its_queue_wait(tmp_path):
    """Three TFs queued at once before a device that takes 20 ms a TF: the
    device thread pops all three, the second waited for the first's
    transmit and the third for both; the `sdr` RC module reads the sum,
    and the runtime folds it into its timings from the writer thread."""
    s = ModSettings(input_name=_file(tmp_path, 12), output="loopback",
                    batch_tf=3)
    rt = ModRuntime(s.normalise_for_output(), device="cpu")
    out = rt.output
    transmit = out.device.transmit_frame

    def slow(samples, ts):
        time.sleep(0.02)
        transmit(samples, ts)

    out.device.transmit_frame = slow
    try:
        assert rt.run() == 0
    finally:
        rt.close()
    assert out.popped == 3 and out.frames == 3
    assert out.queue_wait_s >= 0.05
    assert rcs.get_param("sdr", "queue_wait_s") == str(out.queue_wait_s)
    assert 0 <= rt.timings["sink_queue_s"] <= out.queue_wait_s


def test_sink_queue_follows_a_replaced_output(tmp_path):
    """The runtime folds the wait of whatever sink it writes to: a sink
    put in place after construction starts from its own zero."""
    s = ModSettings(input_name=_file(tmp_path, 4), output="file",
                    output_name=str(tmp_path / "out.iq"))
    rt = ModRuntime(s.normalise_for_output(), device="cpu")
    rt.close()

    class Sink:
        queue_wait_s = 0.0

    a, b = Sink(), Sink()
    a.queue_wait_s = 0.25
    rt._fold_sink_queue(a)
    a.queue_wait_s = 0.5
    rt._fold_sink_queue(a)
    b.queue_wait_s = 0.125
    rt._fold_sink_queue(b)
    rt._fold_sink_queue(object())            # a sink with no queue
    assert rt.timings["sink_queue_s"] == 0.625

