#!/usr/bin/env python3
"""Throughput and stage profile of dabmod_tpu_torch on one CUDA card: the
port's counterpart of bench.py and of the tools that time dabmod_tpu
(tools/bench_configs.py, tools/bench_e2e.py, tools/profile_stages.py).

    python3 bench_gpu.py [batch_tf]
    python3 bench_gpu.py --configs [batch_tf] [--only S] [--sweep L] [--json PATH]
    python3 bench_gpu.py --e2e [--out-dir DIR] [--json PATH]
    python3 bench_gpu.py --stages [CONFIG] [batch_tf] [--json PATH]

* The default run (bench.py): TM I, bench.py's 2-sub-channel ensemble,
  f32 planes, batch_tf=24, four input batches staged on the card.  The
  first batch's output is held against the port on the CPU (3e-5*max|ref|),
  then the captured step (Modulator.modulate, a CUDA graph's replay, the
  state threaded through) and the eager step (Modulator._modulate_impl)
  are timed with CUDA events around runs of N steps.  One JSON line with
  bench.py's keys (metric, value in samples/s, vs_baseline against the
  2.048 MS/s real-time rate) and the eager figure, the step's median and
  quartiles, the batch and the card.
* --configs (tools/bench_configs.py): dabmod_tpu's config matrix (CONFIGS,
  the same names, modes and settings, TM II-IV batched to the same signal
  time) and two rows for the resampler routes nothing else times
  (ROUTE_CONFIGS).  Each row: its first batch against the CPU port, the
  first step's wall (warm-up, capture, replay), captured and eager step
  times, device busy and idle share (torch.profiler), and the bytes the
  step must move (ETI in, outputs out, state read and written, counted
  from the tensors' shapes) over the card's published 3.35 TB/s: a lower
  bound on its memory traffic, hence the "_lb".
* --e2e (tools/bench_e2e.py): ModRuntime on the card, an ETI file of 1000
  synthetic frames looped, the file sink in s16 and u8, and ETI over TCP
  into s16; frames/s, x real time and each pipeline stage's share of the
  wall; beside the file runs the rate of batch-shaped device-to-pinned
  copies in the same process (the transport's ceiling) and the pipeline's
  efficiency against it, the median of 3 cycles.
* --stages (tools/profile_stages.py): the eager step of one config (default
  "full", batch 16) under torch.profiler over 20 steps; each kernel's,
  copy's and fill's device time goes to the innermost stage range
  (models/modulator.py STAGES, dabmod_tpu's jax.named_scope names) open on
  the host thread when its launch was issued, found through the launch's
  correlation to its runtime call; the rest to "(other)".  A CUDA graph
  records its ranges when captured, not at a replay, so only the eager
  step can be attributed.

Every measurement needs a CUDA card and raises RuntimeError without one.
The timing, profile and comparison helpers are chip_smoke.py's.  Every
JSON printed carries the card (name, power limit from nvidia-smi, count);
a file is written only where --json says.
"""
import argparse
import importlib.util
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

METRIC = "COFDM I/Q samples/s per chip (TM-I, 2.048 MS/s native)"
E2E_METRIC = ("end-to-end streaming x-real-time (ETI in -> wire file out), "
              "TM-I 2-subchannel ensemble, batch_tf=24")
BASE_RATE = 2_048_000            # samples/s of real time
BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))    # bench.py's ensemble
ETI_FRAME_S = 0.024
E2E_FRAMES = 1000                # 250 | 1000: FCT-continuous when looped
E2E_BATCH_TF = 24
# the identity poly DPD (format 1; the cost is the polynomial's, not the
# values'), as tools/bench_configs.py writes it
IDENTITY_POLY = "1\n5\n1.0\n0\n0\n0\n0\n0\n0\n0\n0\n0\n"
STEPS, RUNS = 50, 7              # steps a timed run, runs
STAGE_STEPS = 20                 # eager steps under the profiler
OTHER = "(other)"

# dabmod_tpu's config matrix (tools/bench_configs.py CONFIGS, copied)
CONFIGS = [
    ("base (TM-I)",   1, {}),
    ("TM-II",         2, {}),
    ("TM-III",        3, {}),
    ("TM-IV",         4, {}),
    ("FIR+winGI",     1, {"filter_taps_file": "default",
                          "ofdm_window_overlap": 32}),
    ("CFR",           1, {"enable_cfr": True, "cfr_clip": 12.0,
                          "cfr_error_clip": 3.0}),
    ("resamp 4.096M", 1, {"output_rate": 4_096_000}),
    ("resamp 8.192M", 1, {"output_rate": 8_192_000}),
    ("TII+DPD",       1, {"tii_enable": True,
                          "poly_coef_file": "__builtin_poly__"}),
    ("full",          1, {"filter_taps_file": "default",
                          "ofdm_window_overlap": 32,
                          "enable_cfr": True, "cfr_clip": 12.0,
                          "cfr_error_clip": 3.0, "tii_enable": True,
                          "poly_coef_file": "__builtin_poly__"}),
    # the 17-sub-channel / 855-CU ensemble (eti.REALISTIC_MUX_SPECS)
    ("realistic17",   1, {"__realistic__": True}),
    ("realistic17 full", 1, {"__realistic__": True,
                          "filter_taps_file": "default",
                          "ofdm_window_overlap": 32,
                          "enable_cfr": True, "cfr_clip": 12.0,
                          "cfr_error_clip": 3.0, "tii_enable": True,
                          "poly_coef_file": "__builtin_poly__"}),
]
# the resampler routes no other row takes: the plain polyphase form and
# the frequency-domain form (models/modulator.py resampler_route)
ROUTE_CONFIGS = [
    ("resamp 2.5M poly", 1, {"output_rate": 2_500_000,
                             "resampler_mode": "poly"}),
    ("resamp 8.192M fft", 1, {"output_rate": 8_192_000,
                              "resampler_mode": "fft"}),
]
ALL_CONFIGS = CONFIGS + ROUTE_CONFIGS
# the resampler route each row must take (None: no resampler)
ROUTES = {"resamp 4.096M": "kernel", "resamp 8.192M": "kernel",
          "resamp 2.5M poly": "poly", "resamp 8.192M fft": "fft"}


# ---------------------------------------------------------------------------
# the harness and the card
# ---------------------------------------------------------------------------

def harness():
    """chip_smoke.py beside this script, loaded once as the module
    "chip_smoke" (its timing, profile and comparison helpers)."""
    cs = sys.modules.get("chip_smoke")
    if cs is None:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
        cs = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = cs
        spec.loader.exec_module(cs)
    return cs


def require_card(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("bench_gpu.py measures on a CUDA card, and "
                           "torch.cuda.is_available() is False")


def device_info(torch) -> dict:
    """The card: torch's name for it, its power limit in W and the line
    nvidia-smi gives for it, and the number of cards."""
    require_card(torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    m = re.search(r"([\d.]+)\s*W", line)
    return {"name": torch.cuda.get_device_name(0),
            "power_limit_w": float(m.group(1)) if m else None,
            "nvidia_smi": line, "count": torch.cuda.device_count()}


# ---------------------------------------------------------------------------
# configurations (reachable without a card)
# ---------------------------------------------------------------------------

def find_config(sel: str):
    """The first row of ALL_CONFIGS whose name contains `sel`
    (tools/profile_stages.py's choice): (name, mode, settings)."""
    for row in ALL_CONFIGS:
        if sel in row[0]:
            return row
    raise ValueError(f"no config named like {sel!r}")


def batch_scale(mode: int) -> int:
    """TFs a step per TM I TF: the same signal time a step in every mode
    (tools/bench_configs.py:112)."""
    from dabmod_tpu_torch import tables
    return round(96 * 2048 / tables.mode_params(mode).tf_samples)


def config_settings(kw: dict, poly_path: str):
    """A row's settings as ModSettings keywords and its ensemble: the
    builtin poly file replaced by `poly_path`, "__realistic__" by the
    17-sub-channel ensemble."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    kw = dict(kw)
    if kw.get("poly_coef_file") == "__builtin_poly__":
        kw["poly_coef_file"] = poly_path
    specs = REALISTIC_MUX_SPECS if kw.pop("__realistic__", False) \
        else BENCH_SPECS
    return kw, specs


def build_modulator(row, poly_path: str, device):
    """A row's Modulator (f32 planes, device_interleave=False, as
    tools/bench_configs.py builds it) on `device`, and its ensemble; fails
    where its resampler takes another route than ROUTES says."""
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    name, mode, kw = row
    kw, specs = config_settings(kw, poly_path)
    m = Modulator(make_default_layout(mode, specs),
                  ModSettings(dab_mode=mode, device_interleave=False, **kw),
                  device=device)
    route = m._res_route
    if route != ROUTES.get(name):
        raise RuntimeError(f"{name}: resampler route {route}, not "
                           f"{ROUTES.get(name)}")
    return m, specs


def make_batches(mode, specs, batch_tf, seeds):
    """Parsed ETI batches of batch_tf TFs from synth_eti_batch, one a
    seed."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
    frames = batch_tf * tables.mode_params(mode).cif_count
    return [parse_eti_frames(synth_eti_batch(frames, mode=mode,
                                             subch_specs=specs, seed=k))
            for k in seeds]


def on_device(torch, batch, device):
    return (torch.as_tensor(batch.fic, device=device),
            tuple(torch.as_tensor(x, device=device)
                  for x in batch.subchannels))


def expected_stages(m) -> list:
    """The stage ranges modulator m's step opens, in the order it opens
    them (dabmod_tpu's scopes in its order)."""
    s = m.settings
    st = ["fec", "qpsk_map", "diff_mod", "carriers", "tii_null"]
    if m._dexter:
        return st + ["dexter_quantise"]
    if m._kiss:
        return st + ["kiss_ifft", "guard_interval", "format_convert"]
    st += ["ofdm_ifft"] + (["cfr"] if s.enable_cfr else [])
    st += ["gain", "guard_interval"]
    rp = m._runtime_params
    st += ["fir"] if "fir_taps" in rp else []
    st += ["resampler"] if m._res_route is not None else []
    st += ["dpd"] if ("poly_am" in rp or "lut" in rp) else []
    if m._wire_fmt == "s16":
        return st + ["format_convert"]
    if m._wire_fmt is None and not s.device_interleave:
        return st
    st += ["interleave_out"]
    return st + (["format_convert"] if m._wire_fmt is not None else [])


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree)
               if hasattr(x, "element_size"))


def hbm_bytes(fic, subch, out, stats, state_in, state_out, n_samples):
    """The bytes a step must move, from its tensors' shapes: the ETI
    payload in, the output and its stats out, the state read and written;
    and those per output sample."""
    eti = _nbytes((fic, tuple(subch)))
    outputs = _nbytes((out, stats))
    state = _nbytes(state_in) + _nbytes(state_out)
    total = eti + outputs + state
    return {"eti_in": eti, "outputs_out": outputs,
            "state_read_written": state, "total": total,
            "per_sample_lb": total / n_samples}


# ---------------------------------------------------------------------------
# stage attribution (reachable without a card: a list of profiler events)
# ---------------------------------------------------------------------------

_RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]\w*$")


def recorded_ranges(events, stages) -> list:
    """The stage ranges among profiler events: the host events named as a
    stage, (name, thread, start us, end us), in order of their start."""
    from torch.autograd import DeviceType
    return sorted(((e.name, e.thread, e.time_range.start, e.time_range.end)
                   for e in events
                   if e.device_type == DeviceType.CPU and e.name in stages),
                  key=lambda r: r[2])


def attribute_stages(torch, events, stages, n_steps) -> dict:
    """Each device event's time (kernels, copies, fills; the profiler's
    device-side annotations left out) under the innermost stage range open
    on the host thread where its launch was issued, found from the
    launch's runtime call (the host event of the same correlation id: a
    kernel launched through ctypes has no aten op); OTHER where no range
    encloses the launch.  Per stage, a step: device ms, launches, share of
    the device time, and the port's counted kernels (chip_smoke
    KERNEL_SYMBOLS) by their launches."""
    from torch.autograd import DeviceType
    cs = harness()
    calls = {e.id: (e.thread, e.time_range.start) for e in events
             if e.device_type == DeviceType.CPU and e.name not in stages
             and _RUNTIME_CALL.match(e.name)}
    # ranges by thread, for the innermost enclosing one
    by_thread = {}
    for name, thread, start, end in recorded_ranges(events, stages):
        by_thread.setdefault(thread, []).append((start, end, name))
    acc = {}
    for e in cs.device_activity(torch, events):
        where = calls.get(e.id)
        stage = OTHER
        if where is not None:
            thread, t = where
            inner = [r for r in by_thread.get(thread, ())
                     if r[0] <= t <= r[1]]
            if inner:
                stage = max(inner)[2]
        rec = acc.setdefault(stage, {"us": 0.0, "launches": 0,
                                     "kernels": {}})
        rec["us"] += e.time_range.end - e.time_range.start
        rec["launches"] += 1
        k = cs.KERNEL_SYMBOLS.get(cs._kernel_of(e.name))
        if k is not None:
            rec["kernels"][k] = rec["kernels"].get(k, 0) + 1
    total = sum(r["us"] for r in acc.values())
    return {stage: {"device_ms": r["us"] / n_steps / 1e3,
                    "launches": r["launches"] / n_steps,
                    "share": r["us"] / total if total else 0.0,
                    "kernels": {k: v / n_steps
                                for k, v in r["kernels"].items()}}
            for stage, r in sorted(acc.items(), key=lambda kv: -kv[1]["us"])}


# the stage each counted kernel may run under
KERNEL_STAGE = {"ofdm_ifft": "ofdm_ifft", "ofdm_cfr": "ofdm_ifft",
                "resample_poly": "resampler"}


def stage_problems(rec, other_max=0.05, busy_rel=0.02) -> list:
    """What a --stages record fails of: every expected stage recorded and
    with device time and launches, no other range, the port's kernels
    under their stages only, OTHER at most other_max of the device time,
    and the stages' sum within busy_rel of the same trace's device busy
    time (chip_smoke profile_summary)."""
    bad = []
    st = rec["stages"]
    if sorted(set(rec["recorded"])) != sorted(set(rec["expected"])):
        bad.append(f"ranges recorded {rec['recorded']}, expected "
                   f"{rec['expected']}")
    for name in rec["expected"]:
        r = st.get(name)
        if r is None or r["device_ms"] <= 0 or r["launches"] <= 0:
            bad.append(f"stage {name}: no device time or launch")
    for name, r in st.items():
        for k, n in r["kernels"].items():
            if n and name != KERNEL_STAGE[k]:
                bad.append(f"{k} launched under {name}")
    if st.get(OTHER, {}).get("share", 0.0) > other_max:
        bad.append(f"{OTHER} takes {st[OTHER]['share']:.3f} of the device "
                   f"time")
    busy = rec["device_busy_ms_per_step"]
    total = rec["stage_sum_ms_per_step"]
    if not busy or abs(total - busy) > busy_rel * busy:
        bad.append(f"stage sum {total} ms against device busy {busy} ms")
    return bad


# ---------------------------------------------------------------------------
# JSON assembly (reachable without a card)
# ---------------------------------------------------------------------------

def quartiles(ms, steps) -> dict:
    q1, med, q3 = statistics.quantiles(ms, n=4, method="inclusive")
    return {"median": statistics.median(ms), "q1": q1, "q3": q3,
            "n": len(ms), "steps_per_run": steps}


def default_record(row, device) -> dict:
    """bench.py's JSON line (metric, value, unit, vs_baseline) from the
    "base (TM-I)" row's record (bench.py's configuration): the captured
    step's samples/s, with the eager step's, both steps' times, the host's
    issue time, the batch, the CPU comparison and the card."""
    value, eager = row["samples_per_s"], row["eager_samples_per_s"]
    return {"metric": METRIC, "value": value, "unit": "samples/s",
            "vs_baseline": value / BASE_RATE, "eager_value": eager,
            "eager_vs_baseline": eager / BASE_RATE,
            "step_ms": row["step_ms"], "eager_step_ms": row["eager_step_ms"],
            "host_issue_ms": row["host_issue_ms"],
            "batch_tf": row["batch_tf"], "check": row["check"],
            "device": device,
            "note": "captured step (CUDA graph replay, outputs cloned); "
                    "CUDA events around runs of steps_per_run steps, "
                    "inputs on the card"}


# ---------------------------------------------------------------------------
# measurements (a CUDA card)
# ---------------------------------------------------------------------------

def _poly_file(d) -> str:
    path = os.path.join(d, "identity_poly.coef")
    with open(path, "w") as f:
        f.write(IDENTITY_POLY)
    return path


def check_first_batch(torch, name, m, cpu, batch, first):
    """The card's first step (its output, stats) against the CPU
    modulator's on the same batch from init_state, by chip_smoke's
    compare_batch: f32 within 3e-5*max|ref| (1e-4 after the poly DPD),
    with CFR the statistics and the clip counts within the threshold
    margin."""
    from dabmod_tpu_torch.ops import ofdm_kernel
    cs = harness()
    state = cpu.init_state()
    margin = None
    if cpu.settings.enable_cfr:
        syms, _ = cpu.ofdm_symbols(batch.fic, batch.subchannels,
                                   state["ti_history"], state["tf_index"])
        margin = ofdm_kernel.cfr_threshold_margin(
            syms, cpu._ofdm_table, cpu.settings.cfr_clip,
            cpu.settings.cfr_error_clip, rel=cs.MARGIN_REL
        ).sum(dim=1).numpy()
    out, _, stats = cpu.modulate_eti(batch, state)
    g_out, g_stats = first
    rel = cs.DPD_REL if cpu.settings.poly_coef_file else 3e-5
    err, tol = cs.compare_batch(
        f"{name}: card vs CPU", "f32", cs._to_host(g_out),
        {k: v.cpu().numpy() for k, v in g_stats.items()}, cs._to_host(out),
        {k: v.numpy() for k, v in stats.items()}, cpu.tf_samples_out,
        margin, rel, n_tf=batch.fic.shape[0] // cpu.p.cif_count)
    return {"max_abs_err": err, "tol": tol, "rel": rel}


def time_steps(torch, m, staged, steps, runs):
    """The captured and the eager step of m over the staged batches in
    turn, the state threaded through, each as {"ms": per-step device ms
    of each run (CUDA events around `steps` steps, chip_smoke time_runs)
    in quartiles, "issue_ms": the host's ms to issue a step, "step": the
    step function, for profiling}."""
    cs = harness()
    st = [m.init_state()]
    i = [0]

    def captured():
        fic, subs = staged[i[0] % len(staged)]
        i[0] += 1
        _, st[0], _ = m.modulate(fic, subs, st[0])

    def eager():
        fic, subs = staged[i[0] % len(staged)]
        i[0] += 1
        with torch.no_grad():
            _, st[0], _ = m._modulate_impl(fic, subs, st[0],
                                           *m._gain_args(),
                                           m._apply_swaps())

    res = {}
    for key, fn in (("captured", captured), ("eager", eager)):
        def run(fn=fn):
            for _ in range(steps):
                fn()
        dev, host = cs.time_runs(torch, run, n=runs, warm=1)
        res[key] = {"ms": quartiles([d / steps for d in dev], steps),
                    "issue_ms": statistics.median(host) / steps, "step": fn}
    return res


def bench_one(torch, row, batch_tf, poly_path, steps=STEPS, runs=RUNS,
              card=None) -> dict:
    """One row of --configs at batch_tf TM I TFs (module docstring); card
    is device_info's record."""
    require_card(torch)
    cs = harness()
    card = card or device_info(torch)
    name, mode, _kw = row
    m, specs = build_modulator(row, poly_path, "cuda")
    cpu, _ = build_modulator(row, poly_path, "cpu")
    n_tf = batch_tf * batch_scale(mode)
    batches = make_batches(mode, specs, n_tf, range(4))
    staged = [on_device(torch, b, "cuda") for b in batches]
    state0 = m.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, state1, stats = m.modulate(*staged[0], state0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check = check_first_batch(torch, name, m, cpu, batches[0], (out, stats))
    n_out = n_tf * m.tf_samples_out
    nb = hbm_bytes(*staged[0], out, stats, state0, state1, n_out)
    t = time_steps(torch, m, staged, steps, runs)
    step, eager = t["captured"]["ms"], t["eager"]["ms"]
    tf_duration = m.p.tf_samples / BASE_RATE
    bound_ms = nb["total"] / cs.HBM_BYTES_PER_S * 1e3
    row = {"config": name, "mode": mode, "out_rate": m.settings.output_rate,
           "resampler_route": m._res_route,
           "samples_per_s": n_out / (step["median"] / 1e3),
           "x_realtime": n_tf * tf_duration / (step["median"] / 1e3),
           "eager_samples_per_s": n_out / (eager["median"] / 1e3),
           "eager_x_realtime": n_tf * tf_duration / (eager["median"] / 1e3),
           "n_subchannels": len(specs), "batch_tf": batch_tf,
           "tfs_per_step": n_tf, "first_step_s": first_s,
           "step_ms": step, "eager_step_ms": eager,
           "host_issue_ms": {k: v["issue_ms"] for k, v in t.items()},
           "hbm_bytes": nb, "hbm_bytes_per_sample_lb": nb["per_sample_lb"],
           "bytes_bound_ms": bound_ms,
           "bytes_bound_share": bound_ms / step["median"],
           "hbm_bytes_per_s": cs.HBM_BYTES_PER_S,
           "power_limit_w": card["power_limit_w"], "check": check}
    for key in ("captured", "eager"):
        prof = cs.profile_steps(torch, t[key]["step"])
        pre = "" if key == "captured" else "eager_"
        row[pre + "device_busy_ms"] = prof.get("device_busy_ms_per_step")
        row[pre + "device_idle_share"] = prof.get("device_idle_share")
    return row


def bench_default(torch, batch_tf=24, steps=STEPS, runs=RUNS) -> dict:
    """bench.py's measurement on the card: the "base (TM-I)" row (module
    docstring) as bench.py's JSON line."""
    require_card(torch)
    card = device_info(torch)
    return default_record(bench_one(torch, CONFIGS[0], batch_tf, "", steps,
                                    runs, card), card)


def run_configs(torch, names=None, batch_list=(24,), steps=STEPS,
                runs=RUNS) -> dict:
    """--configs: each row of ALL_CONFIGS (those in `names`, if given) at
    each batch of batch_list, the best x_realtime kept
    (tools/bench_configs.py --sweep), a line printed for each."""
    require_card(torch)
    card = device_info(torch)
    rows = []
    with tempfile.TemporaryDirectory(prefix="bench_gpu_") as d:
        poly = _poly_file(d)
        for row in ALL_CONFIGS:
            if names is not None and row[0] not in names:
                continue
            best = None
            for btf in batch_list:
                r = bench_one(torch, row, btf, poly, steps, runs, card)
                if best is None or r["x_realtime"] > best["x_realtime"]:
                    best = r
            rows.append(best)
            print(f"{row[0]:17s} mode={row[1]} out_rate={best['out_rate']}"
                  f" route={best['resampler_route']}: "
                  f"{best['samples_per_s'] / 1e6:.1f} MS/s = "
                  f"{best['x_realtime']:.1f}x real time captured, "
                  f"{best['eager_x_realtime']:.1f}x eager (batch "
                  f"{best['batch_tf']}); step {best['step_ms']['median']:.4f}"
                  f" ms, eager {best['eager_step_ms']['median']:.4f} ms; "
                  f"first step {best['first_step_s']:.3f} s; device busy "
                  f"{_num(best['device_busy_ms'])} ms, idle share "
                  f"{_num(best['device_idle_share'])}; "
                  f"{best['hbm_bytes_per_sample_lb']:.2f} B a sample, bytes "
                  f"bound {best['bytes_bound_ms']:.4f} ms, share "
                  f"{best['bytes_bound_share']:.4f}", flush=True)
    return {"configs": rows, "device": card}


def profile_stages(torch, sel="full", batch_tf=16, steps=STAGE_STEPS) -> dict:
    """--stages: the eager step of the row named like `sel` under
    torch.profiler over `steps` steps, attributed to the stage ranges
    (attribute_stages), beside the same trace's device busy time
    (chip_smoke profile_summary)."""
    require_card(torch)
    from torch.profiler import ProfilerActivity, profile
    from dabmod_tpu_torch.models.modulator import STAGES
    cs = harness()
    device = device_info(torch)
    row = find_config(sel)
    with tempfile.TemporaryDirectory(prefix="bench_gpu_") as d:
        m, specs = build_modulator(row, _poly_file(d), "cuda")
    n_tf = batch_tf * batch_scale(row[1])
    (batch,) = make_batches(row[1], specs, n_tf, (0,))
    fic, subs = on_device(torch, batch, "cuda")
    st = [m.init_state()]

    def step():
        with torch.no_grad():
            _, st[0], _ = m._modulate_impl(fic, subs, st[0],
                                           *m._gain_args(), m._apply_swaps())
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    summary = cs.profile_summary(torch, events, wall_us, steps)
    stages = attribute_stages(torch, events, STAGES, steps)
    recorded = [r[0] for r in recorded_ranges(events, STAGES)]
    wall_ms = wall_us / steps / 1e3
    return {"config": row[0], "mode": row[1], "batch_tf": batch_tf,
            "tfs_per_step": n_tf, "steps": steps, "step": "eager",
            "x_realtime_under_profiler": (n_tf * m.p.tf_samples / BASE_RATE
                                          / (wall_ms / 1e3)),
            "stages": stages,
            "stage_sum_ms_per_step": sum(r["device_ms"]
                                         for r in stages.values()),
            "device_busy_ms_per_step": summary.get(
                "device_busy_ms_per_step"),
            "device_idle_share": summary.get("device_idle_share"),
            "host_wall_ms_per_step": wall_ms,
            "expected": expected_stages(m),
            "recorded": sorted(set(recorded)),
            "ranges_per_step": len(recorded) / steps,
            "device": device,
            "note": "the eager step: a CUDA graph records its ranges at "
                    "its capture, not at a replay, so a replay's kernels "
                    "cannot be attributed to stages"}


def _num(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def print_stages(rec):
    """tools/profile_stages.py's table."""
    wall = rec["host_wall_ms_per_step"]
    print(f"\nconfig '{rec['config']}' batch_tf={rec['batch_tf']}: "
          f"{wall:.3f} ms/step (eager, under the profiler), "
          f"{rec['x_realtime_under_profiler']:.0f}x real-time")
    print(f"{'stage':16s} {'device ms/step':>14s} {'%':>6s} "
          f"{'launches/step':>14s}")
    for name, r in rec["stages"].items():
        print(f"{name:16s} {r['device_ms']:14.4f} {100 * r['share']:5.1f}% "
              f"{r['launches']:14.1f}")
    print(f"{'total device':16s} {rec['stage_sum_ms_per_step']:14.4f}  "
          f"(busy {_num(rec['device_busy_ms_per_step'])}, wall {wall:.3f})")
    print(f"note: {rec['note']}")


# ---------------------------------------------------------------------------
# --e2e: the runtime end to end
# ---------------------------------------------------------------------------

def transport_rate(torch, n_tf=E2E_BATCH_TF, k=8, reps=3):
    """Batch-shaped device-to-pinned copies ([n_tf, 196608] int32, the s16
    output of a TM I batch), k back to back, reps times: (median, peak)
    bytes/s."""
    require_card(torch)
    shape = (n_tf, 196608)
    src = [torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                         device="cuda") for _ in range(k)]
    dst = [torch.empty(shape, dtype=torch.int32, pin_memory=True)
           for _ in range(k)]
    nbytes = k * src[0].numel() * 4
    dst[0].copy_(src[0])
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in zip(src, dst):
            b.copy_(a, non_blocking=True)
        torch.cuda.synchronize()
        rates.append(nbytes / (time.perf_counter() - t0))
    return statistics.median(rates), max(rates)


def run_runtime(settings, seconds):
    """ModRuntime on the card: 2 batches to warm up, 4 to size the run,
    then a run of about `seconds`: (frames, s, each timing's share)."""
    from dabmod_tpu_torch.runtime import ModRuntime
    rt = ModRuntime(settings, device="cuda")
    try:
        rt.run_batches(2)
        t0 = time.perf_counter()
        rt.run_batches(4)
        per_batch = (time.perf_counter() - t0) / 4
        n = max(8, min(2000, int(seconds / max(per_batch, 1e-3))))
        f0, before = rt.framecount, dict(rt.timings)
        t0 = time.perf_counter()
        rt.run_batches(n)
        dt = time.perf_counter() - t0
        frames = rt.framecount - f0
        shares = {k: (v - before[k]) / dt for k, v in rt.timings.items()}
    finally:
        rt.close()
    return frames, dt, shares


def _e2e_record(frames, dt, shares):
    return {"frames": frames, "seconds": dt,
            "x_realtime": frames * ETI_FRAME_S / dt,
            "share_of_wall": shares}


def e2e_file(inp, out_dir, fmt, seconds):
    from dabmod_tpu_torch.config import ModSettings
    s = ModSettings(input_name=inp, loop=True, output="file",
                    output_name=os.path.join(out_dir, f"out_{fmt}.iq"),
                    file_output_format=fmt, batch_tf=E2E_BATCH_TF)
    s.normalise_for_output()
    return _e2e_record(*run_runtime(s, seconds))


def e2e_tcp(inp, out_dir, fmt, seconds):
    """ETI over TCP from a local server thread that sends the file in a
    loop."""
    from dabmod_tpu_torch.config import ModSettings
    with open(inp, "rb") as f:
        data = f.read()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(30)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def serve():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        try:
            while not stop.is_set():
                conn.sendall(data)
        except OSError:
            pass
        finally:
            conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    s = ModSettings(input_name=f"tcp://127.0.0.1:{port}",
                    input_transport="tcp", output="file",
                    output_name=os.path.join(out_dir, f"tcp_{fmt}.iq"),
                    file_output_format=fmt, batch_tf=E2E_BATCH_TF)
    s.normalise_for_output()
    try:
        rec = _e2e_record(*run_runtime(s, seconds))
    finally:
        stop.set()
        srv.close()
        t.join(timeout=10)
    rec["port"] = port
    return rec


def with_ceiling(torch, fn, bytes_per_sample, cycles=3) -> dict:
    """`cycles` cycles of (transport rate, fn(), transport rate): each
    cycle's ceiling is the peak copy rate of its two brackets in x real
    time; the cycle of median efficiency is kept, with every cycle's
    efficiency (tools/bench_e2e.py's method)."""
    runs = []
    for _ in range(cycles):
        sus_b, peak_b = transport_rate(torch)
        r = fn()
        sus_a, peak_a = transport_rate(torch)
        peak = max(peak_b, peak_a)
        ceil = peak / bytes_per_sample / BASE_RATE
        r.update(transport_MBps=(sus_b + sus_a) / 2 / 1e6,
                 transport_peak_MBps=peak / 1e6,
                 transport_ceiling_x=ceil,
                 pipeline_efficiency=r["x_realtime"] / ceil)
        runs.append(r)
    runs.sort(key=lambda x: x["pipeline_efficiency"])
    r = dict(runs[len(runs) // 2])
    r["efficiency_cycles"] = [x["pipeline_efficiency"] for x in runs]
    return r


def bench_e2e(torch, out_dir=None, seconds=4.0, cycles=3) -> dict:
    """--e2e (module docstring).  The ETI file and the outputs go to a
    fresh directory under out_dir (default: the temporary directory)."""
    require_card(torch)
    from dabmod_tpu_torch.eti import synth_eti_batch
    device = device_info(torch)
    base = out_dir or tempfile.gettempdir()
    with tempfile.TemporaryDirectory(prefix="bench_gpu_e2e_",
                                     dir=base) as d:
        inp = os.path.join(d, "in.eti")
        synth_eti_batch(E2E_FRAMES, mode=1, subch_specs=BENCH_SPECS
                        ).tofile(inp)
        res = {"metric": E2E_METRIC, "out_dir": base,
               "input_frames": E2E_FRAMES, "batch_tf": E2E_BATCH_TF,
               "transport": "device-to-pinned copies of [24, 196608] int32 "
                            "batches, 8 back to back, in this process; the "
                            "ceiling is the peak of the two brackets"}
        res["file_s16"] = with_ceiling(
            torch, lambda: e2e_file(inp, d, "s16", seconds), 4, cycles)
        res["tcp_s16"] = e2e_tcp(inp, d, "s16", seconds)
        res["file_u8"] = with_ceiling(
            torch, lambda: e2e_file(inp, d, "u8", seconds), 2, cycles)
    res["device"] = device
    return res


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--configs", action="store_true")
    mode.add_argument("--e2e", action="store_true")
    mode.add_argument("--stages", action="store_true")
    ap.add_argument("rest", nargs="*",
                    help="[batch_tf]; with --stages [CONFIG] [batch_tf]")
    ap.add_argument("--only", default=None,
                    help="--configs: the rows whose name contains this")
    ap.add_argument("--sweep", default=None,
                    help="--configs: comma-separated batch_tf list, each "
                         "row at its best")
    ap.add_argument("--out-dir", default=None,
                    help="--e2e: where the ETI file and the outputs go "
                         "(default: the temporary directory)")
    ap.add_argument("--json", dest="json_out", default=None)
    args = ap.parse_args(argv)
    import torch
    require_card(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rest = args.rest
    problems = []
    if args.stages:
        rec = profile_stages(torch, rest[0] if rest else "full",
                             int(rest[1]) if len(rest) > 1 else 16)
        print_stages(rec)
        problems = stage_problems(rec)
        rec["problems"] = problems
        print("checks: " + ("; ".join(problems) if problems else "ok"))
    elif args.configs:
        batch = int(rest[0]) if rest else 24
        batches = ([int(x) for x in args.sweep.split(",")] if args.sweep
                   else [batch])
        names = [r[0] for r in ALL_CONFIGS
                 if args.only is None or args.only in r[0]]
        rec = run_configs(torch, names, batches)
    elif args.e2e:
        rec = bench_e2e(torch, args.out_dir)
    else:
        rec = bench_default(torch, int(rest[0]) if rest else 24)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
    print(json.dumps(rec), flush=True)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
