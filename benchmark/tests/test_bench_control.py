"""The comparison that decides `correct` has to fail: its control (the
reference in TF32 in the program's place) and a run with the timed path
broken underneath, here on the CPU at a size a test run holds; and the
measuring path without a card."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, ROOT

import cell
import control
import run as run_mod


def workloads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return {w["name"]: w for w in json.load(f)["workloads"]}


@pytest.mark.parametrize("name", ["r17_s16.bulk", "r17_dpd8m192.live_edi"])
def test_control_comes_out_not_correct(name):
    r = control.control_readings(workloads()[name], 2**31 + 77, 20.0,
                                 "cpu", n_tfs=1)
    assert r["correct"] is False, r


def run_cpu(name, monkeypatch, **overrides):
    """A run of the cell on the CPU (the harness's look for a card
    skipped): a short window, every TF of it compared."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    traffic = {"batch_tf": 2, "warm_batches": 1, "check_tfs": 1000,
               "trace_s": 0.5, **overrides}
    c = cell.Cell(workloads()[name], 2**31 + 99, 1.5, False,
                  time.monotonic(), device="cpu",
                  traffic_overrides=traffic)
    try:
        res = c.run()
        c.close()
        checks = run_mod.run_checks(c, res)
    finally:
        c.cleanup()
    return all(x["value"] <= x["limit"] for x in checks.values()), checks


def broken_step(monkeypatch, fault):
    """Modulator.modulate with one fault planted where the output or the
    state is produced."""
    from dabmod_tpu_torch.models.modulator import Modulator
    inner = Modulator.modulate

    def modulate(self, fic, subch, state):
        out, new_state, stats = inner(self, fic, subch, state)
        if fault == "state_unchanged":
            return out, state, stats
        out = out.clone()
        if fault == "half_batch_left_out":
            half = out.shape[0] // 2
            out[half:] = out[:out.shape[0] - half]
        elif fault == "answer_altered":
            out[:, 1000] += 7            # one s16 word (re) a TF
        return out, new_state, stats
    monkeypatch.setattr(Modulator, "modulate", modulate)


def test_sound_run_is_correct(monkeypatch):
    ok, checks = run_cpu("r17_s16.bulk", monkeypatch)
    assert ok, checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out",
                                   "answer_altered"])
def test_broken_step_is_not_correct(monkeypatch, fault):
    broken_step(monkeypatch, fault)
    ok, checks = run_cpu("r17_s16.bulk", monkeypatch)
    assert not ok, checks


def test_lost_tf_is_not_correct(monkeypatch):
    """A TF that never reaches the sink."""
    import sinks
    inner = sinks.BatchSink.write
    calls = []

    def write(self, iq, metadata=None):
        calls.append(1)
        if len(calls) == 3:
            iq, metadata = iq[1:], metadata[1:]
        return inner(self, iq, metadata)
    monkeypatch.setattr(sinks.BatchSink, "write", write)
    ok, checks = run_cpu("r17_s16.bulk", monkeypatch)
    assert not ok and checks["lost_frames"]["value"] == 4, checks


def test_no_card_no_result():
    """Without a CUDA card a run exits 1, names the missing card and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "r17_s16.bulk", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 1 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


@pytest.mark.cuda
def test_cell_runs_on_card():
    """One short run of the first cell on the card, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "r17_s16.bulk", "--seed", "5", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


def test_result_withheld_when_a_late_import_loads_jax(monkeypatch, capsys):
    """The check for JAX's modules comes after everything that runs once
    the window has closed (the comparison, the metric readers): a module
    loaded as late as the result line's making withholds the result."""
    import types

    class FakeCell:
        cif, open_loop, gen, setup_s, host_cpu = 4, True, None, 1.0, {}
        timings_window = {}

        def __init__(self, *args, **kwargs):
            pass

        def run(self):
            return {"run_result": "NORMAL_END"}

        def close(self):
            pass

        def cleanup(self):
            pass

    def late_import(*args):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}
    monkeypatch.setattr(cell, "Cell", FakeCell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run_mod, "run_checks", lambda run, res: {})
    monkeypatch.setattr(run_mod, "result_line", late_import)
    rc = run_mod.main(["--workload", "r17_s16.bulk", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 1 and out.out.strip() == ""
    assert "jax" in out.err
