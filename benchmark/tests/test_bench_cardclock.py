"""step_card_ms_per_tf: CUDA events around every step of an untraced window,
the steps' spans on the card over the TFs they carry; and the per-layer
frame rate of a traced run.  On the CPU, the events faked where a card
would keep their time."""
import json
import os
import time

import pytest
import torch

from conftest import ROOT

import cell
import run as run_mod


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def e2e_of(s, name):
    return [m["name"] for m in s["end_to_end"]
            if name in m.get("workloads", [name])]


class FakeEvent:
    """An event whose clock reads the number of events made before it,
    milliseconds: each step's span reads 1 ms."""
    made = 0

    def __init__(self):
        self.at = FakeEvent.made
        FakeEvent.made += 1

    def elapsed_time(self, end):
        return float(end.at - self.at)


def run_cpu(monkeypatch, trace):
    """r17_s16.bulk on the CPU at a small batch."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    monkeypatch.setattr(cell, "card_event", FakeEvent)
    s = spec()
    w = {x["name"]: x for x in s["workloads"]}["r17_s16.bulk"]
    c = cell.Cell(w, 2**31 + 321, 1.5, trace, time.monotonic(),
                  device="cpu", e2e=e2e_of(s, w["name"]),
                  traffic_overrides={"batch_tf": 2, "warm_batches": 1,
                                     "check_tfs": 2, "trace_s": 0.5})
    try:
        res = c.run()
        c.close()
        checks = run_mod.run_checks(c, res)
    finally:
        c.cleanup()
    return c, res, run_mod.result_line(s, w, c, res, checks, trace)


def test_every_step_of_the_window_is_timed_per_tf(monkeypatch):
    c, res, line = run_cpu(monkeypatch, False)
    # every step issued once set-up's warm batches were done, 2 TFs each
    assert len(c.step_clock) == c.steps > 0
    assert all(n == 2 for _, _, n in c.step_clock)
    assert res["frames_read"] - 2 * c.cif == 2 * c.cif * c.steps
    assert res["step_card_ms_per_tf"] == pytest.approx(0.5)
    assert set(line["metrics"]) == {"step_card_ms_per_tf", "setup_s"}
    assert line["correct"] is True


def test_traced_run_has_no_step_clock_and_reads_its_frame_rate(monkeypatch):
    c, res, line = run_cpu(monkeypatch, True)
    assert c.step_clock == [] and "step_card_ms_per_tf" not in res
    got = line["metrics"]["runtime.frames_per_s.traced"]
    assert got == {"value": res["frames_per_s"], "unit": "frames/s"}


def test_no_clock_in_a_cell_without_the_metric():
    s = spec()
    for w in s["workloads"]:
        names = e2e_of(s, w["name"])
        assert ("step_card_ms_per_tf" in names) == (
            w["name"] == "r17_s16.bulk")


def test_a_step_is_timed_from_its_first_graph_launch(monkeypatch):
    """The replay hook marks the first launch of a step, calls the graph's
    own replay, and is undone by cleanup."""
    monkeypatch.setattr(cell, "card_event", FakeEvent)
    calls = []

    class Graph:
        def replay(self):
            calls.append(self)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    own = Graph.replay
    s = spec()
    w = {x["name"]: x for x in s["workloads"]}["r17_s16.bulk"]
    c = cell.Cell(w, 2**31 + 5, 1.0, False, time.monotonic(), device="cpu",
                  e2e=e2e_of(s, w["name"]))
    try:
        c._hook_replay()
        c._replay_at = None
        g = Graph()
        g.replay()
        first = c._replay_at
        g.replay()
        assert isinstance(first, FakeEvent) and c._replay_at is first
        assert calls == [g, g]
    finally:
        c.cleanup()
    assert Graph.replay is own
