"""BENCHMARK.json against the contract the benchmark is held to, and every
configuration, traffic mix and per-layer metric it names found by name."""
import importlib.util
import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_lines():
    s = spec()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in s["configs"] + s["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]


@pytest.mark.parametrize("kind", ["configs", "traffic"])
def test_named_files_exist(kind):
    s = spec()
    if kind == "configs":
        for c in s["configs"]:
            assert c["file"] == f"benchmark/configs/{c['name']}.json"
            with open(os.path.join(ROOT, c["file"])) as f:
                cfg = json.load(f)
            assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
            assert set(cfg["limits"]) and cfg["reference"]["wire"] in (
                "s16", "f32")
    else:
        for w in s["workloads"]:
            with open(os.path.join(BENCH, "traffic",
                                   w["traffic"] + ".json")) as f:
                t = json.load(f)
            assert t["name"] == w["traffic"] and t["loop"] in ("open",
                                                               "closed")
            assert w["name"] == f"{w['config']}.{w['traffic']}"
            assert w["chips"] == 1


def test_per_layer_readers_and_arrows():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    cells = {w["name"] for w in s["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec_ = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(mod)
        assert callable(mod.read)
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        # every cell it lists reports the metric it moves
        for c in m["workloads"]:
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    for c in cells:
        assert sum(c in m.get("workloads", cells) for m in e2e.values()) >= 2
        assert any(c in m["workloads"] for m in s["per_layer"])


@pytest.mark.parametrize("mode,cifs", [(1, 4), (2, 1), (3, 1), (4, 2)])
def test_cifs_a_tf_follow_the_configured_mode(mode, cifs):
    import cell
    assert cell.cif_count({"reference": {"mode": mode}}) == cifs
    for c in spec()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert str(cfg["reference"]["mode"]) == cfg["ini"]["modulator"][
            "mode"]


def test_roofline_share_reads_nothing_without_launches():
    import types

    import roofline
    cell = {"device_kind": "NVIDIA H100 80GB HBM3", "batch_tf": 24,
            "rate": 2_048_000}
    least = roofline.least_seconds("ofdm_ifft", cell["device_kind"], 24,
                                   2_048_000)
    t = types.SimpleNamespace(kernels={"ofdm_ifft_kernel": [
        least, 2 * least, 4 * least]})
    assert roofline.share("ofdm_ifft", "ofdm_ifft_kernel", t, cell) == \
        pytest.approx(50.0)
    assert roofline.share("ofdm_cfr", "ofdm_cfr_kernel", t, cell) is None
    assert roofline.share("ofdm_ifft", "ofdm_ifft_kernel", t,
                          {**cell, "device_kind": "cpu"}) is None


def test_host_info_names_cpu_and_cores():
    import run
    h = run.host_info()
    assert h["cores"] >= 1 and h["affinity"]
    assert all(p.replace("-", "").isdigit() for p in h["affinity"].split(","))
