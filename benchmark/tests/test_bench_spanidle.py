"""spanidle.idle_by_span on synthetic profiler events: the idle gaps put
under the program's spans as well as the benchmark's ranges, as
devtrace.summarise puts them under the benchmark's alone; and the
per-layer readers of the program's spans read nothing from a program
that lacks them."""
import importlib.util
import os
import types

import pytest

import devtrace
import spanidle
from conftest import BENCH

MAIN, OTHER = 4242, 4343          # system thread ids


def ev(name, start, end, *, cuda=False, annotation=False, tid=MAIN):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end),
        # the profiler's own thread number, and the system's id
        thread=1 if tid == MAIN else 2, device_resource_id=tid)


def trace():
    """Device work at 0-10, 20-30, 50-60, 90-100 and 130-140 us (an
    annotation on the device left out), with host ranges around it:
      gap 10-20: dabmod.issue open, bench.step.modulate inside it
      gap 30-50: bench.reader.read_batch on the main thread; a fetch span
                 on another thread started later
      gap 60-90: no range open
      gap 100-130: dabmod.handoff alone."""
    return [
        ev("void ofdm_ifft_kernel<4>(float2*)", 0, 10, cuda=True),
        ev("elementwise_kernel", 20, 30, cuda=True),
        ev("bench.step.modulate", 20, 26, cuda=True, annotation=True),
        ev("Memcpy DtoH", 50, 60, cuda=True),
        ev("elementwise_kernel", 90, 100, cuda=True),
        ev("elementwise_kernel", 130, 140, cuda=True),
        ev("dabmod.issue", 4, 19),
        ev("bench.step.modulate", 5, 18),
        ev("dabmod.read", 24, 49),
        ev("bench.reader.read_batch", 25, 48),
        ev("dabmod.fetch", 28, 45, tid=OTHER),
        ev("dabmod.handoff", 95, 129),
        ev("aten::copy_", 96, 97),
    ]


def test_without_program_spans_the_gaps_fall_as_devtrace_puts_them():
    events = [e for e in trace() if not e.name.startswith("dabmod.")]
    t = devtrace.summarise(events, 2.0, MAIN, 5, {})
    assert spanidle.idle_by_span(events, MAIN) == pytest.approx(
        t.idle_by_range)
    assert t.idle_by_range == pytest.approx({
        "bench.step.modulate": 10e-6, "bench.reader.read_batch": 20e-6,
        devtrace.NO_RANGE: 60e-6})


def test_idle_by_span_takes_the_innermost_range():
    # as in the program, bench.step.modulate opens inside dabmod.issue:
    # the innermost takes the gap
    assert spanidle.idle_by_span(trace(), MAIN) == pytest.approx({
        "bench.step.modulate": 10e-6,
        # the main thread's range first, the other thread's left aside
        "bench.reader.read_batch": 20e-6,
        devtrace.NO_RANGE: 30e-6, "dabmod.handoff": 30e-6})


def test_program_span_inside_a_benchmark_range_takes_the_gap():
    events = [
        ev("elementwise_kernel", 0, 10, cuda=True),
        ev("elementwise_kernel", 30, 40, cuda=True),
        ev("bench.step.modulate", 2, 25),
        ev("dabmod.issue", 3, 24),
    ]
    assert spanidle.idle_by_span(events, MAIN) == pytest.approx(
        {"dabmod.issue": 20e-6})
    t = devtrace.summarise(events, 1.0, MAIN, 1, {})
    assert t.idle_by_range == pytest.approx({"bench.step.modulate": 20e-6})


def test_gap_with_no_range_open_stays_under_no_range():
    events = [
        ev("elementwise_kernel", 0, 10, cuda=True),
        ev("elementwise_kernel", 30, 40, cuda=True),
        ev("dabmod.parse", 1, 9),                 # closed before the gap
        ev("dabmod.stage_in", 11, 29),            # opened after its start
        ev("dabmod.fetch", 5, 35, tid=OTHER),     # another thread's
    ]
    assert spanidle.idle_by_span(events, MAIN) == pytest.approx(
        {"dabmod.fetch": 20e-6})
    assert spanidle.idle_by_span(events[:4], MAIN) == pytest.approx(
        {devtrace.NO_RANGE: 20e-6})


def reader(name):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


NEW = {"reader.decode_ms.live": 1e3 * 0.5 / 4,
       "sink.queue_ms.live": 1e3 * 0.25 / 4,
       "runtime.parse_ms.bulk": 1e3 * 0.75 / 4}


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_readers_read_the_program_and_nothing_without_it(name):
    read = reader(name)
    now = {"read_s": 1.0, "read_decode_s": 0.5, "parse_s": 0.75,
           "modulate_s": 2.0, "sink_queue_s": 0.25, "fetch_s": 1.0}
    t = types.SimpleNamespace(timings=now, batches=4)
    assert read(t, {}) == pytest.approx(NEW[name])
    # a program whose timings lack the span, as the first benchmark's
    before = {k: now[k] for k in ("read_s", "modulate_s", "fetch_s")}
    assert read(types.SimpleNamespace(timings=before, batches=4), {}) is None
    assert read(types.SimpleNamespace(timings=now, batches=0), {}) is None
