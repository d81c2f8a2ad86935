"""bench_gpu.py and the port's stage ranges on the CPU.

* The stage ranges of dabmod_tpu_torch/models/modulator.py
  (torch.profiler.record_function) carry exactly dabmod_tpu's
  jax.named_scope names, read from both sources, and a CPU profile of one
  eager step records each range the step's settings open, in JAX's order
  and siblings as the scopes are.
* bench_gpu's parts that need no card: the config table against
  tools/bench_configs.CONFIGS (names, modes, settings, batch scaling),
  each row's Modulator, the byte counts from shapes against a hand count,
  the stage attribution and its checks on synthetic event lists, the JSON
  line against bench.py's; every measuring path raises without a card, and
  none of it imports JAX or dabmod_tpu.
* bench_gpu's profile summary leaves the profiler's device-side
  annotations out of busy time and launches.
* The graph stand-in records no profiler op, and its captured step still
  equals the eager step.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

import bench_gpu
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
from dabmod_tpu_torch.models import Modulator, compiled, make_default_layout
from dabmod_tpu_torch.models.modulator import STAGES
import torch_graph_stand_in as stand_ins

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))


def _source(*path) -> str:
    with open(os.path.join(ROOT, *path)) as f:
        return f.read()


def test_stage_names_are_jax_scope_names():
    jax_names = set(re.findall(r'jax\.named_scope\("(\w+)"\)', _source(
        "dabmod_tpu", "models", "modulator.py")))
    # the front end's ranges open in its module (ops/frontend_kernel.py)
    port_names = set(re.findall(r'record_function\("(\w+)"\)', _source(
        "dabmod_tpu_torch", "models", "modulator.py") + _source(
        "dabmod_tpu_torch", "ops", "frontend_kernel.py")))
    assert len(jax_names) == 16
    assert port_names == jax_names == set(STAGES)
    assert len(STAGES) == len(set(STAGES))


# a step's settings: (TM, ModSettings keywords) at 1 TF a batch
VARIANTS = {
    "base": (1, {}),
    "cfr": (1, dict(bench_gpu.find_config("CFR")[2])),
    "fir_wingi": (1, dict(bench_gpu.find_config("FIR+winGI")[2])),
    "resamp_8m192": (1, dict(bench_gpu.find_config("resamp 8.192M")[2])),
    "tii_dpd": (1, dict(tii_enable=True, poly_coef_file="poly")),
    "kiss": (1, dict(fft_engine="kiss")),
    "s16": (1, dict(output="file", file_output_format="s16")),
    "u8": (1, dict(output="file", file_output_format="u8")),
    "dexter": (1, dict(fft_engine="dexter")),
    "tm2_fft": (2, dict(output_rate=4_096_000, resampler_mode="fft")),
}


def _variant(name, tmp_path):
    mode, kw = VARIANTS[name]
    if kw.get("poly_coef_file"):
        path = tmp_path / "poly.coef"
        path.write_text(bench_gpu.IDENTITY_POLY)
        kw = dict(kw, poly_coef_file=str(path))
    s = ModSettings(dab_mode=mode, device_interleave=False, **kw)
    if s.output == "file":
        s.normalise_for_output()
    return Modulator(make_default_layout(mode, BENCH_SPECS), s,
                     device="cpu")


def _batch(m, n_tf=1, seed=0):
    b = parse_eti_frames(synth_eti_batch(
        n_tf * m.p.cif_count, mode=m.mode, subch_specs=BENCH_SPECS,
        seed=seed))
    return torch.as_tensor(b.fic), tuple(torch.as_tensor(x)
                                         for x in b.subchannels)


def _eager(m, batch, state):
    with torch.no_grad():
        return m._modulate_impl(*batch, state, *m._gain_args(),
                                m._apply_swaps())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_records_its_stage_ranges(name, tmp_path):
    """One eager step under a CPU profile: the stage ranges it records are
    bench_gpu.expected_stages, in that order, on one thread, none inside
    another (dabmod_tpu's scopes are siblings)."""
    m = _variant(name, tmp_path)
    batch = _batch(m)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _eager(m, batch, m.init_state())
    events = prof.events()
    ranges = bench_gpu.recorded_ranges(events, STAGES)
    assert [r[0] for r in ranges] == bench_gpu.expected_stages(m)
    assert len({r[1] for r in ranges}) == 1
    for (_, _, s0, e0), (_, _, s1, _) in zip(ranges, ranges[1:]):
        assert s0 <= e0 <= s1
    for e in events:
        if e.name in STAGES:
            parent = e.cpu_parent
            while parent is not None:
                assert parent.name not in STAGES, (e.name, parent.name)
                parent = parent.cpu_parent


def test_variants_open_every_stage(tmp_path):
    seen = set()
    for name in VARIANTS:
        seen.update(bench_gpu.expected_stages(_variant(name, tmp_path)))
    assert seen == set(STAGES)


# ---------------------------------------------------------------------------
# stage attribution on synthetic event lists
# ---------------------------------------------------------------------------

def _event(name, dev, start, end, id_=0, thread=1, annotation=False):
    return SimpleNamespace(
        name=name, device_type=dev, time_range=SimpleNamespace(
            start=start, end=end), id=id_, thread=thread,
        is_user_annotation=annotation)


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _synthetic():
    """Two stage ranges on thread 1 with a third nested in the second
    (innermost wins); launches inside each, one outside every range, one
    whose runtime call is not in the trace; a device-side annotation; an
    aten op whose id equals a launch's correlation id."""
    return [
        _event("fec", CPU, 0, 100, id_=1),
        _event("ofdm_ifft", CPU, 100, 200, id_=2),
        _event("gain", CPU, 150, 180, id_=3),
        _event("aten::add", CPU, 120, 125, id_=14),
        _event("cudaLaunchKernel", CPU, 50, 52, id_=11),
        _event("cudaLaunchKernel", CPU, 160, 162, id_=12),
        _event("cudaMemcpyAsync", CPU, 250, 251, id_=13),
        _event("void foo_kernel<float>(float*)", CUDA, 300, 310, id_=11),
        _event("void (anonymous namespace)::ofdm_ifft_kernel<11>(float*)",
               CUDA, 310, 330, id_=12),
        _event("Memcpy DtoD (Device -> Device)", CUDA, 330, 335, id_=13),
        _event("elementwise_kernel", CUDA, 335, 342, id_=14),
        _event("fec", CUDA, 300, 342, annotation=True),
    ]


def test_attribution_innermost_range_and_other():
    st = bench_gpu.attribute_stages(torch, _synthetic(), STAGES, 1)
    got = {k: (round(v["device_ms"] * 1e3, 6), v["launches"])
           for k, v in st.items()}
    assert got == {"fec": (10.0, 1), "gain": (20.0, 1),
                   bench_gpu.OTHER: (12.0, 2)}
    assert st["gain"]["kernels"] == {"ofdm_backend": 1}
    assert all(not v["kernels"] for k, v in st.items() if k != "gain")
    assert sum(v["device_ms"] for v in st.values()) == pytest.approx(0.042)
    assert sum(v["share"] for v in st.values()) == pytest.approx(1.0)
    # largest first
    assert list(st) == ["gain", bench_gpu.OTHER, "fec"]
    # per step
    st2 = bench_gpu.attribute_stages(torch, _synthetic(), STAGES, 2)
    assert st2["gain"]["device_ms"] == pytest.approx(0.010)
    assert st2["gain"]["launches"] == 0.5


def test_attribution_matches_threads():
    """A range on another thread does not take a launch."""
    ev = [_event("fec", CPU, 0, 100, id_=1, thread=2),
          _event("cudaLaunchKernel", CPU, 50, 52, id_=11, thread=1),
          _event("k", CUDA, 300, 310, id_=11)]
    st = bench_gpu.attribute_stages(torch, ev, STAGES, 1)
    assert list(st) == [bench_gpu.OTHER]


def _stage_record(**over):
    rec = {"expected": ["fec", "ofdm_ifft"], "recorded": ["fec", "ofdm_ifft"],
           "stages": {"fec": {"device_ms": 1.0, "launches": 5, "share": 0.5,
                              "kernels": {}},
                      "ofdm_ifft": {"device_ms": 0.98, "launches": 1,
                                    "share": 0.49,
                                    "kernels": {"ofdm_backend": 1}},
                      bench_gpu.OTHER: {"device_ms": 0.02, "launches": 2,
                                        "share": 0.01, "kernels": {}}},
           "stage_sum_ms_per_step": 2.0, "device_busy_ms_per_step": 1.99}
    rec.update(over)
    return rec


def test_stage_problems():
    assert bench_gpu.stage_problems(_stage_record()) == []
    rec = _stage_record()
    rec["stages"]["fec"]["kernels"] = {"resample": 1}
    assert any("resample launched under fec" in p
               for p in bench_gpu.stage_problems(rec))
    rec = _stage_record()
    rec["stages"][bench_gpu.OTHER]["share"] = 0.06
    assert len(bench_gpu.stage_problems(rec)) == 1
    assert len(bench_gpu.stage_problems(_stage_record(
        device_busy_ms_per_step=1.9))) == 1
    assert len(bench_gpu.stage_problems(_stage_record(
        expected=["fec", "ofdm_ifft", "gain"]))) == 2
    assert len(bench_gpu.stage_problems(_stage_record(
        recorded=["fec", "ofdm_ifft", "dpd"]))) == 1


def test_profile_summary_leaves_out_annotations():
    """bench_gpu's busy time and launch count: the kernels' intervals
    alone, not a range's span on the device timeline."""
    ev = [_event("k1", CUDA, 0, 10), _event("k2", CUDA, 20, 30),
          _event("fec", CUDA, 0, 30, annotation=True),
          _event("aten::add", CPU, 0, 40)]
    rec = bench_gpu.profile_summary(torch, ev, 100.0, 1)
    assert rec["device_busy_ms_per_step"] == pytest.approx(0.020)
    assert rec["device_ops_per_step"] == 2
    assert rec["device_idle_share"] == pytest.approx(0.8)
    assert [e.name for e in bench_gpu.device_activity(torch, ev)] == [
        "k1", "k2"]


# ---------------------------------------------------------------------------
# the config table, the modulators, the byte counts, the JSON line
# ---------------------------------------------------------------------------

def _jax_bench_configs():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_configs", os.path.join(ROOT, "tools", "bench_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_table_is_dabmod_tpus():
    from dabmod_tpu import tables as jtables
    assert bench_gpu.CONFIGS == _jax_bench_configs().CONFIGS
    assert not {r[0] for r in bench_gpu.ROUTE_CONFIGS} & {
        r[0] for r in bench_gpu.CONFIGS}
    for mode in (1, 2, 3, 4):
        # tools/bench_configs.py:112
        assert bench_gpu.batch_scale(mode) == round(
            96 * 2048 / jtables.mode_params(mode).tf_samples)
    assert [bench_gpu.batch_scale(m) for m in (1, 2, 3, 4)] == [1, 4, 4, 2]


def test_each_config_builds_its_modulator(tmp_path):
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    poly = tmp_path / "poly.coef"
    poly.write_text(bench_gpu.IDENTITY_POLY)
    for row in bench_gpu.ALL_CONFIGS:
        name, mode, kw = row
        m, specs = bench_gpu.build_modulator(row, str(poly), "cpu")
        s = m.settings
        assert m.mode == mode and not s.device_interleave
        assert specs == (REALISTIC_MUX_SPECS if kw.get("__realistic__")
                         else BENCH_SPECS)
        assert len(m.layout.subchannels) == len(specs)
        for k, v in kw.items():
            if k == "poly_coef_file":
                assert s.poly_coef_file == str(poly)
                assert m._poly_am is not None
            elif not k.startswith("__"):
                assert getattr(s, k) == v, (name, k)
        assert m._res_route == bench_gpu.ROUTES.get(name)
        assert m.emits_planes
    # a route other than ROUTES says fails
    with pytest.raises(RuntimeError):
        bench_gpu.build_modulator(
            ("resamp 2.5M poly", 1, {"output_rate": 4_096_000}), "", "cpu")
    assert bench_gpu.find_config("full")[0] == "full"
    assert bench_gpu.find_config("realistic17 full")[0] == "realistic17 full"
    with pytest.raises(ValueError):
        bench_gpu.find_config("nothing like it")


def test_hbm_bytes_hand_count_on_main():
    """The default run's modulator at 2 TFs: 8 ETI frames of 96 FIC + 192 +
    384 sub-channel bytes; two f32 planes of 2 x 196,608 samples; the TI
    histories (15 CIFs x 48 and 96 CUs x 64 bits, a byte a bit) and the TF
    index, read and written."""
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  ModSettings(dab_mode=1, device_interleave=False),
                  device="cpu")
    batch = _batch(m, 2)
    st0 = m.init_state()
    out, st1, stats = _eager(m, batch, st0)
    nb = bench_gpu.hbm_bytes(*batch, out, stats, st0, st1,
                             2 * m.tf_samples_out)
    eti = 8 * (96 + 192 + 384)
    outputs = 2 * 2 * 196_608 * 4
    state = 2 * (15 * (48 + 96) * 64 + 4)
    assert nb == {"eti_in": eti, "outputs_out": outputs,
                  "state_read_written": state,
                  "total": eti + outputs + state,
                  "per_sample_lb": (eti + outputs + state) / (2 * 196_608)}


def test_default_record_has_bench_py_keys():
    metric = re.search(r'"metric": "([^"]+)"', _source("bench.py")).group(1)
    step = bench_gpu.quartiles([2.0, 2.2, 2.1, 1.9, 2.4], 50)
    eager = bench_gpu.quartiles([10.0, 11.0, 12.0, 13.0, 14.0], 50)
    assert step == {"median": 2.1, "q1": 2.0, "q3": 2.2, "n": 5,
                    "steps_per_run": 50}
    assert bench_gpu.CONFIGS[0] == ("base (TM-I)", 1, {})
    row = {"samples_per_s": 24 * 196_608 / 2.1e-3,
           "eager_samples_per_s": 24 * 196_608 / 12e-3, "step_ms": step,
           "eager_step_ms": eager, "host_issue_ms": {"captured": 0.1},
           "batch_tf": 24, "check": {"max_abs_err": 0.0}}
    device = {"name": "card", "power_limit_w": 700.0, "count": 1}
    rec = bench_gpu.default_record(row, device)
    assert rec["metric"] == metric == bench_gpu.METRIC
    assert rec["unit"] == "samples/s"
    assert rec["value"] == row["samples_per_s"]
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 2_048_000)
    assert rec["eager_value"] == row["eager_samples_per_s"]
    assert rec["step_ms"] == step and rec["eager_step_ms"] == eager
    assert rec["batch_tf"] == 24 and rec["device"] == device
    json.dumps(rec)


def test_every_measuring_path_raises_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    row = bench_gpu.find_config("base")
    calls = [
        lambda: bench_gpu.device_info(torch),
        lambda: bench_gpu.bench_default(torch, 1),
        lambda: bench_gpu.bench_one(torch, row, 1, ""),
        lambda: bench_gpu.run_configs(torch),
        lambda: bench_gpu.profile_stages(torch, "base", 1),
        lambda: bench_gpu.main([]),
        lambda: bench_gpu.main(["--configs"]),
        lambda: bench_gpu.main(["--stages", "full", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()
    assert not list(tmp_path.iterdir())


def test_bench_gpu_imports_no_jax():
    """In a fresh interpreter: bench_gpu's parts that need no card, with
    neither jax nor dabmod_tpu imported; and a --scaling-worker process
    imports neither."""
    code = (
        "import sys, torch, bench_gpu as B\n"
        "from types import SimpleNamespace\n"
        "row = B.find_config('realistic17 full')\n"
        "assert B.batch_scale(2) == 4\n"
        "kw, specs = B.config_settings(row[2], 'x')\n"
        "m, _ = B.build_modulator(B.find_config('resamp 8.192M fft'), '', "
        "'cpu')\n"
        "assert B.expected_stages(m)[-1] == 'resampler'\n"
        "(b,) = B.make_batches(1, B.BENCH_SPECS, 1, (0,))\n"
        "fic, subs = B.on_device(torch, b, 'cpu')\n"
        "st = m.init_state()\n"
        "out, st1, stats = m.modulate(fic, subs, st)\n"
        "nb = B.hbm_bytes(fic, subs, out, stats, st, st1, "
        "m.tf_samples_out)\n"
        "B.attribute_stages(torch, [], ('fec',), 1)\n"
        "q = B.quartiles([1.0, 2.0, 3.0], 1)\n"
        "B.default_record(dict(samples_per_s=1.0, eager_samples_per_s=1.0, "
        "step_ms=q, eager_step_ms=q, host_issue_ms={}, batch_tf=1, "
        "check={}), {})\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'dabmod_tpu') "
        "or k.startswith(('jax.', 'dabmod_tpu.')))\n"
        "print(nb['total'], bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    # the --scaling-worker entry: one rank of --hosts 1 on the CPU, every
    # module it imports listed by -X importtime
    spec = {"config": "base", "batch_per_rank": 1, "steps": 1, "runs": 2,
            "poly": "", "traced": 1, "unsharded": True, "timeout_s": 60}
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "bench_gpu.py",
         "--scaling-worker", "--rank", "0", "--hosts", "1",
         "--chips-per-host", "1", "--port", str(bench_gpu.free_port()),
         "--device", "cpu", "--spec", json.dumps(spec)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    assert json.loads(r.stdout.splitlines()[-1])["elementwise_ok"]
    imported = re.findall(r"^import time:.*\|\s*(\S+)\s*$", r.stderr, re.M)
    assert "dabmod_tpu_torch.parallel.sharding" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "dabmod_tpu")]
    for path in ("bench_gpu.py", "time_kernels.py"):
        src = _source(path)
        assert not re.search(r"^\s*(import jax|from jax|import dabmod_tpu\b"
                             r"(?!_torch)|from dabmod_tpu\b(?!_torch))",
                             src, re.M), path
    # the kernel timer stands alone: of the repo, the package only
    root_modules = {f[:-3] for f in os.listdir(ROOT) if f.endswith(".py")}
    imported = set(re.findall(r"^\s*(?:import|from)\s+(\w+)",
                              _source("time_kernels.py"), re.M))
    assert not imported & root_modules, imported & root_modules


# ---------------------------------------------------------------------------
# the graph stand-in and the ranges
# ---------------------------------------------------------------------------

class _Namespaces(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(func.namespace)
        return func(*args, **(kwargs or {}))


def test_stand_in_capture_holds_no_profiler_op(monkeypatch):
    """The step issues the ranges' profiler ops; the stand-in's capture
    keeps none of them, and its replays equal the eager step to the
    bit."""
    stand_ins.install(monkeypatch.setattr)
    settings = ModSettings(dab_mode=1, output="file",
                           file_output_format="s16").normalise_for_output()
    m = Modulator(make_default_layout(1, BENCH_SPECS), settings,
                  device="cpu")
    ref = Modulator(make_default_layout(1, BENCH_SPECS), settings,
                    device="cpu")
    seen = _Namespaces()
    with seen:
        _eager(ref, _batch(ref), ref.init_state())
    assert "profiler" in seen.seen
    m.compiled = compiled.GraphStep(m._modulate_impl)
    st, st_ref = m.init_state(), ref.init_state()
    for seed in range(3):
        batch = _batch(m, seed=seed)
        got = m.modulate(*batch, st)
        want = _eager(ref, batch, st_ref)
        st, st_ref = got[1], want[1]
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    (cap,) = m.compiled.graphs.values()
    assert cap.replays == 3 and cap.graph.ops
    assert not [f for f, *_ in cap.graph.ops if f.namespace == "profiler"]
