"""The plain reference of the fixed-point chain (reference/kiss.py): bit for
bit against the upstream C++ modulator's fft_engine=kiss goldens
(tests/golden/e2e_fixed_* and e2e_iq_fixed*, read as data) and against the
port's CPU kiss step; its control; the resolver that lets a configuration
name its reference; and runs of cell.Cell on a kiss configuration written
here, on the CPU and, marked cuda, on the card."""
import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import BENCH

import cell
import control
import run as run_mod
import streams
from reference import chain, kiss
from test_bench_reference import (REALISTIC, TWO_SUBS, frames_with, golden,
                                  imported_modules, port_outputs)

KISS_CFG = "kiss_fixture"


def kiss_config(window: int = 0, tii=None) -> dict:
    """A configuration of the fixed-point chain on the 17-sub-channel
    ensemble, s16, limits 0."""
    ini = {"modulator": {"mode": "1", "fft_engine": "kiss",
                         "rate": "2048000", "ofdmwindowing": str(window)},
           "fileoutput": {"format": "s16"}}
    ref = {"mode": 1, "window": window, "wire": "s16"}
    if tii is not None:
        ini["tii"] = {"enable": "1", "comb": str(tii[0]),
                      "pattern": str(tii[1])}
        ref["tii"] = list(tii)
    return {"name": KISS_CFG, "reference_module": "kiss", "ini": ini,
            "ensemble": [list(e) for e in REALISTIC], "reference": ref,
            "limits": {"max_lsb": 0.0, "rms_lsb": 0.0}}


def use_config(monkeypatch, cfg: dict) -> dict:
    """cell.load_json finds `cfg` under its name; the workload of a bulk
    cell on it."""
    inner = cell.load_json

    def load_json(kind, name):
        if kind == "configs" and name == cfg["name"]:
            return json.loads(json.dumps(cfg))
        return inner(kind, name)
    monkeypatch.setattr(cell, "load_json", load_json)
    return {"name": cfg["name"] + ".bulk", "config": cfg["name"],
            "traffic": "bulk", "chips": 1}


def golden_frames():
    """The goldens' two-sub-channel ETI frames (8 frames, 2 TFs)."""
    fic = golden("e2e_fixed_fic_in").reshape(8, 96)
    subs = [golden("e2e_fixed_sub0_in").reshape(8, -1),
            golden("e2e_fixed_sub1_in").reshape(8, -1)]
    return frames_with(TWO_SUBS, fic, subs)


def test_q14_carriers_match_fixed_symbols_golden():
    """rint(x * 16384) of each carrier, in carrier-vector order, against the
    complexfix symbols upstream's fixed-point chain fed its transform."""
    re, im = kiss.Chain({"mode": 1, "wire": "s16"}).q14_bins(
        golden_frames(), 0, 2)
    got = torch.stack([re, im], -1).reshape(2, 77, 2048, 2).numpy()
    carriers = np.concatenate([got[:, 1:, 1:769], got[:, 1:, 1280:]], 2)
    expect = golden("e2e_fixed_symbols", np.int16).reshape(2, 76, 1536, 2)
    np.testing.assert_array_equal(carriers, expect)
    assert not got[:, :, 0].any() and not got[:, :, 769:1280].any()


@pytest.mark.parametrize("name,window", [("e2e_iq_fixed", 0),
                                         ("e2e_iq_fixed_ov90", 90)])
def test_wire_matches_fixed_goldens(name, window):
    out = kiss.Chain({"mode": 1, "window": window, "wire": "s16"}).render(
        golden_frames(), 0, keep=2)
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy().reshape(-1),
                                  golden(name, np.int16))


@pytest.mark.parametrize("window,tii", [(0, None), (90, None), (0, (5, 31))])
def test_reference_matches_port_kiss_on_cpu(monkeypatch, window, tii):
    """Three TFs from the stream's start, one TF a step on the port's CPU
    kiss path, 17 sub-channels: every gap 0."""
    use_config(monkeypatch, kiss_config(window, tii))
    raw = streams.make_frames(13, 12, REALISTIC)
    outs, c = port_outputs(KISS_CFG, raw, 3)
    ref = cell.reference_chain(c, "cpu", "f64")
    for k in range(3):
        want = ref.render(raw[:4 * k + 4], 0)[0].numpy()
        gaps = cell.compare(outs[k], want, "s16")
        assert gaps == {"max_lsb": 0.0, "rms_lsb": 0.0}, (k, gaps)


def test_render_from_five_tfs_back_equals_from_the_start():
    ref = kiss.Chain({"mode": 1, "window": 90, "tii": [5, 31],
                      "wire": "s16"})
    raw = streams.make_frames(14, 28, REALISTIC)
    whole = ref.render(raw, 0)[0].numpy()
    late = ref.render(raw[4:], 1)[0].numpy()
    np.testing.assert_array_equal(whole, late)


@pytest.mark.parametrize("window", [0, 90])
def test_control_comes_out_not_correct(monkeypatch, window):
    """The float transform rounded once reads at least 1 LSB off the
    per-stage rounding."""
    workload = use_config(monkeypatch, kiss_config(window))
    r = control.control_readings(workload, 2**31 + 78, 20.0, "cpu",
                                 n_tfs=1)
    assert r["correct"] is False and r["readings"]["max_lsb"] >= 1, r


def test_truncating_sround_reads_at_least_one_lsb(monkeypatch):
    raw = streams.make_frames(15, 4, REALISTIC)
    settings = {"mode": 1, "wire": "s16"}
    exact = kiss.Chain(settings).render(raw, 0)[0].numpy()
    monkeypatch.setattr(kiss, "sround",
                        lambda x: kiss._wrap16(x >> kiss.FRACBITS))
    trunc = kiss.Chain(settings).render(raw, 0)[0].numpy()
    gap = cell.compare(trunc.reshape(-1).view(np.int32), exact, "s16")
    assert gap["max_lsb"] >= 1, gap


@pytest.mark.parametrize("bad", [{"gain_mode": "var"}, {"cfr": [40.0, 3.0]},
                                 {"fir": [1.0]}, {"rate": 8_192_000},
                                 {"poly": [[1.0], [0.0]]}, {"mode": 2},
                                 {"wire": "f32"}, {"normalise": 1.0}])
def test_settings_the_fixed_point_chain_rejects(bad):
    with pytest.raises(ValueError):
        kiss.Chain({"mode": 1, "wire": "s16", **bad})


def test_resolver_defaults_to_chain():
    cfg = cell.load_json("configs", "r17_s16")
    assert "reference_module" not in cfg
    assert cell.reference_module(cfg) is chain
    assert isinstance(cell.reference_chain(cfg, "cpu", "f64"), chain.Chain)
    assert chain.CONTROL_PRECISION == "tf32"


def test_resolver_finds_kiss():
    cfg = kiss_config()
    assert isinstance(cell.reference_chain(cfg, "cpu", "f64"), kiss.Chain)
    assert cell.reference_module(cfg).CONTROL_PRECISION == "float"


@pytest.mark.parametrize("name", ["nosuch", "../cell", "reference/kiss",
                                  "kiss.py", "", 3, "dab", "__init__"])
def test_resolver_refuses_what_names_no_reference(name):
    cfg = {**kiss_config(), "reference_module": name}
    with pytest.raises(ValueError, match=KISS_CFG):
        cell.reference_chain(cfg, "cpu", "f64")


def test_every_reference_module_imports_neither_jax_nor_the_port():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH,
                                                          "reference"))
                   if f.endswith(".py"))
    assert "kiss" in names and "chain" in names
    tops = imported_modules("import " + ", ".join(
        "reference." + n for n in names))
    assert not tops & {"jax", "jaxlib", "flax", "dabmod_tpu",
                       "dabmod_tpu_torch"}


def run_kiss(monkeypatch, cfg, device="cpu", seed=2**31 + 101,
             seconds=1.5, **overrides):
    """A run of a bulk cell on `cfg` (the harness's look for a card
    skipped on the CPU): the run's result and its checks."""
    workload = use_config(monkeypatch, cfg)
    if device == "cpu":
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: "cpu")
        overrides = {"batch_tf": 2, "warm_batches": 1, "check_tfs": 1000,
                     **overrides}
    c = cell.Cell(workload, seed, seconds, False, time.monotonic(),
                  device=device, traffic_overrides=overrides)
    try:
        res = c.run()
        c.close()
        t0 = time.monotonic()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        checks = run_mod.run_checks(c, res)
        res["check_s"] = time.monotonic() - t0
        if device != "cpu":
            res["check_memory_peak_bytes"] = \
                torch.cuda.max_memory_allocated()
    finally:
        c.cleanup()
    return res, checks


def plant(monkeypatch, fault):
    """Modulator.modulate with one fault planted where the output or the
    state is produced."""
    from dabmod_tpu_torch.models.modulator import Modulator
    inner = Modulator.modulate

    def modulate(self, fic, subch, state):
        out, new_state, stats = inner(self, fic, subch, state)
        if fault == "state_unchanged":
            return out, state, stats
        out = out.clone()
        out[:, 1000] += 1            # one s16 word (re) a TF, by 1 LSB
        return out, new_state, stats
    monkeypatch.setattr(Modulator, "modulate", modulate)


def correct(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def test_sound_kiss_run_is_correct(monkeypatch):
    _res, checks = run_kiss(monkeypatch, kiss_config(90))
    assert correct(checks), checks
    assert checks["max_lsb"]["value"] == 0 == checks["rms_lsb"]["value"]


@pytest.mark.parametrize("fault", ["answer_altered", "state_unchanged"])
def test_broken_kiss_step_is_not_correct(monkeypatch, fault):
    plant(monkeypatch, fault)
    _res, checks = run_kiss(monkeypatch, kiss_config(0))
    assert not correct(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 90])
def test_kiss_runtime_on_card_matches_reference(monkeypatch, window):
    """ModRuntime's kiss chain on the card, the 17-sub-channel ensemble,
    s16, 24 TFs a step in a closed loop from a seeded ETI file: 32 sampled
    TFs judged by kiss.Chain on the card, every gap 0; the control on
    three seeds at the same 32 TFs a seed.  Prints the readings, the
    check's wall time and the peaks of device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = kiss_config(window)
    res, checks = run_kiss(monkeypatch, cfg, device="cuda",
                           seed=2**31 + 2024 + window, seconds=5.0)
    controls = [control.control_readings(use_config(monkeypatch, cfg),
                                         2**31 + s, 50.0, "cuda")
                for s in (301, 302, 303)]
    print(json.dumps({
        "window": window, "device": torch.cuda.get_device_name(0),
        "checks": checks, "check_s": res["check_s"],
        "memory_peak_bytes": res["memory_peak_bytes"],
        "check_memory_peak_bytes": res["check_memory_peak_bytes"],
        "frames_per_s": res["frames_per_s"],
        "control": [c["readings"] for c in controls]}), flush=True)
    assert checks["tfs_not_compared"]["value"] == 0, checks
    assert correct(checks), checks
    assert checks["max_lsb"]["value"] == 0 == checks["rms_lsb"]["value"]
    for c in controls:
        assert c["correct"] is False and c["readings"]["max_lsb"] >= 1, c
