"""The fixed-point configuration r17_kiss_s16 and its cell r17_kiss_s16.bulk:
the configuration file as the cell runs it, the cells the card clock
times, a CPU run of the cell at a small batch judged exact by
reference/kiss.py, its control not correct at the cell's window, and the
traced run's new per-layer metrics, which read nothing without a card."""
import json
import os
import time

import pytest
import torch

from conftest import ROOT

import cell
import control
import run as run_mod

CELL = "r17_kiss_s16.bulk"


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload():
    return {w["name"]: w for w in spec()["workloads"]}[CELL]


def test_configuration_is_upstreams_fixed_point_transmitter():
    cfg = cell.load_json("configs", "r17_kiss_s16")
    s16 = cell.load_json("configs", "r17_s16")
    assert cfg["ini"]["modulator"] == {"mode": "1", "fft_engine": "kiss",
                                       "rate": "2048000",
                                       "ofdmwindowing": "10"}
    assert cfg["ini"]["fileoutput"] == {"format": "s16"}
    assert cfg["ensemble"] == s16["ensemble"]
    assert cfg["reference_module"] == "kiss"
    assert cfg["reference"] == {"mode": 1, "window": 10, "wire": "s16"}
    assert cfg["limits"] == {"max_lsb": 0, "rms_lsb": 0}
    assert cfg["reduced"] == []
    assert {"ensemble", "payload", "ofdmwindowing"} <= set(cfg["assumed"])
    w = workload()
    assert (w["config"], w["traffic"], w["chips"]) == ("r17_kiss_s16",
                                                       "bulk", 1)


def test_card_clock_times_the_bulk_s16_cells():
    """step_card_ms_per_tf is the end-to-end metric of the two cells whose
    step ends in s16 words, setup_s beside it; the new per-layer metrics
    read the kiss cell only, and move the card clock."""
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert e2e["step_card_ms_per_tf"]["workloads"] == ["r17_s16.bulk", CELL]
    named = [m["name"] for m in s["end_to_end"]
             if CELL in m.get("workloads", [CELL])]
    assert named == ["step_card_ms_per_tf", "setup_s"]
    layer = {m["name"]: m for m in s["per_layer"]}
    for name, where in (("kiss_ifft_roofline", "kernels"),
                        ("step.kernels_per_tf.bulk", "step")):
        m = layer[name]
        assert m["workloads"] == [CELL] and m["layer"] == where
        assert m["moves"] == "step_card_ms_per_tf"
        assert m["source"] == "device_trace"


def run_cpu(monkeypatch, trace):
    """The cell on the CPU at 2 TFs a step (the harness's look for a card
    and its card clock, CUDA events, left out): its Cell, result and
    result line."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    s = spec()
    w = workload()
    c = cell.Cell(w, 2**31 + 22, 2.0, trace, time.monotonic(), device="cpu",
                  traffic_overrides={"batch_tf": 2, "warm_batches": 1,
                                     "check_tfs": 3, "trace_s": 0.5})
    try:
        res = c.run()
        c.close()
        checks = run_mod.run_checks(c, res)
    finally:
        c.cleanup()
    return c, res, run_mod.result_line(s, w, c, res, checks, trace)


def test_cpu_run_of_the_cell_is_exact(monkeypatch):
    _c, _res, line = run_cpu(monkeypatch, False)
    checks = line["checks"]
    assert line["correct"] is True, checks
    assert checks["max_lsb"]["value"] == 0 == checks["rms_lsb"]["value"]
    assert checks["tfs_not_compared"]["value"] == 0
    assert set(line["metrics"]) == {"setup_s"}    # no card clock on the CPU


def test_traced_cpu_run_reads_no_device_metric(monkeypatch):
    """Without a card the trace holds no device event: K4's roofline and
    the kernels a TF read nothing, and the line leaves them out."""
    _c, res, line = run_cpu(monkeypatch, True)
    assert res["trace"].batches > 0
    assert "kiss_ifft_roofline" not in line["metrics"]
    assert "step.kernels_per_tf.bulk" not in line["metrics"]
    assert line["correct"] is True, line["checks"]


def test_control_is_not_correct_at_the_cells_window():
    r = control.control_readings(workload(), 2**31 + 221, 50.0, "cpu",
                                 n_tfs=1)
    assert r["correct"] is False and r["readings"]["max_lsb"] >= 1, r


@pytest.mark.cuda
def test_control_is_not_correct_on_card():
    """The control on the card at the cell's own size (32 TFs) on three
    seeds; prints the readings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2**31 + 401, 2**31 + 402, 2**31 + 403):
        r = control.control_readings(workload(), seed, 50.0, "cuda")
        print(json.dumps(r), flush=True)
        assert r["correct"] is False and r["readings"]["max_lsb"] >= 1, r
