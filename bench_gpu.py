#!/usr/bin/env python3
"""Throughput and stage profile of dabmod_tpu_torch on CUDA cards: the
port's counterpart of bench.py and of the tools that time dabmod_tpu
(tools/bench_configs.py, tools/profile_stages.py, tools/bench_scaling.py,
tools/measure_ti_collectives.py; benchmark/ times the runtime end to end,
as tools/bench_e2e.py times dabmod_tpu's).

    python3 bench_gpu.py [batch_tf]
    python3 bench_gpu.py --configs [batch_tf] [--only S] [--sweep L] [--json PATH]
    python3 bench_gpu.py --stages [CONFIG] [batch_tf] [--json PATH]
    python3 bench_gpu.py --scaling [--worlds 1,2,4] [--config NAME] [--json PATH]
    python3 bench_gpu.py --scaling --hosts 1,2 --chips-per-host C [...]
    python3 bench_gpu.py --collectives [--full] [--json PATH]

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
* --stages (tools/profile_stages.py): the eager step of one config (default
  "full", batch 16) under torch.profiler over 20 steps; each kernel's,
  copy's and fill's device time goes to the innermost stage range
  (models/modulator.py STAGES, dabmod_tpu's jax.named_scope names) open on
  the host thread when its launch was issued, found through the launch's
  correlation to its runtime call; the rest to "(other)".  A CUDA graph
  records its ranges when captured, not at a replay, so only the eager
  step can be attributed.

* --scaling (tools/bench_scaling.py): weak scaling of the captured
  sharded step (parallel.ShardedModulator) at 24 TFs a rank, steps back
  to back, over --worlds (world 1 in this process, larger worlds spawned,
  one NCCL rank a card) or --hosts H x --chips-per-host C separate
  processes (--scaling-worker) joined by parallel.init_distributed; each
  rank held against the unsharded step on its card; samples/s at the
  output rate, efficiency, host issue and NCCL's device ms a step
  (scaling_rank).  Exits 1 where a rank's output or state differs.
* --collectives (tools/measure_ti_collectives.py): each coupling's
  exchange in the sharded step (parallel.EXCHANGES) beside the step with
  the state severed, on 4 NCCL ranks with four cards, else 2 gloo ranks
  sharing the card (collectives_rank).

Every measurement needs a CUDA card and raises RuntimeError without one;
--scaling and --collectives take --device cpu --backend gloo for a
rehearsal on the CPU (host clock: no device figure).  Every JSON printed
carries the card (name, power limit from nvidia-smi, count); a file is
written only where --json says.
"""
import argparse
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

METRIC = "COFDM I/Q samples/s per chip (TM-I, 2.048 MS/s native)"
BASE_RATE = 2_048_000            # samples/s of real time
BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))    # bench.py's ensemble
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
# the card, its traces and the comparisons
# ---------------------------------------------------------------------------

MARGIN_REL = 1e-5     # CFR threshold band (ofdm_kernel.cfr_threshold_margin)
DPD_REL = 1e-4        # f32 tolerance after the poly DPD, of max|ref|
HBM_BYTES_PER_S = 3.35e12        # NVIDIA H100 SXM data sheet
# each counted kernel's __global__ function, as a device trace names it,
# and its wrapper's name (the keys of compiled.launch_counts())
KERNEL_NAMES = {"ofdm_ifft_kernel": "ofdm_backend",
                "ofdm_cfr_kernel": "ofdm_cfr_backend",
                "resample_poly": "resample",
                "kiss_ifft_kernel": "kiss_ifft",
                "frontend_kernel": "frontend"}
# NCCL's all-reduce kernels, as a device trace names them
# (ncclDevKernel_AllReduce_Sum_u8_RING_LL, ncclKernel_AllReduce_RING_LL_...)
NCCL_ALL_REDUCE = re.compile(r"^nccl\w*AllReduce")


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


def counted_kernels() -> dict:
    """The port's counted kernel wrappers by name (compiled.COUNTED)."""
    from dabmod_tpu_torch.models import compiled
    return {name: getattr(mod, name) for mod, name in compiled.COUNTED}


def kernel_of(event_name: str) -> str:
    """A device event's function name without its namespace, template
    arguments and parameters."""
    name = event_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split()[-1].split("::")[-1]


def device_activity(torch, events) -> list:
    """The device's kernels, copies and fills among torch.profiler events:
    its device events less the user annotations (a record_function
    range's span on the device timeline, from its first kernel's start to
    its last one's end, idle gaps included)."""
    from torch.autograd import DeviceType
    return [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def busy_us(dev) -> float:
    """The union of the device events' intervals, us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def traced_launches(torch, fn, nccl=False):
    """fn() under torch.profiler, the card synchronised before and after:
    (its result, each counted kernel's launches on the card in the trace,
    keyed as counted_kernels()).  With nccl, also "nccl_all_reduce", NCCL's
    all-reduce kernels in the trace, "nccl_all_reduce_ms", their summed
    device time, and "nccl_all_reduce_each_ms", each one's in the order
    they started.  Raises where the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    dev = device_activity(torch, prof.events())
    if not dev:
        raise RuntimeError("torch.profiler traced no device event: the "
                           "launches on the card are not measured")
    out = dict.fromkeys(KERNEL_NAMES.values(), 0)
    each = []
    for e in dev:
        name = kernel_of(e.name)
        k = KERNEL_NAMES.get(name)
        if k is not None:
            out[k] += 1
        elif nccl and NCCL_ALL_REDUCE.match(name):
            each.append((e.time_range.start,
                         (e.time_range.end - e.time_range.start) / 1e3))
    if nccl:
        each = [ms for _, ms in sorted(each)]
        out.update(nccl_all_reduce=len(each), nccl_all_reduce_ms=sum(each),
                   nccl_all_reduce_each_ms=each)
    return res, out


def time_runs(torch, fn, n, warm):
    """n calls of fn(), each timed twice: on the card, between CUDA events
    recorded around the call, and on the host, from the call to its return
    (the host's time to issue it; nothing synchronises in between).
    Returns the two lists of ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        e1.synchronize()
        dev.append(e0.elapsed_time(e1))
    return dev, host


def profile_steps(torch, step, n=5) -> dict:
    """Where one step's time goes: torch.profiler over n steps, summed up
    by profile_summary."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return profile_summary(torch, prof.events(), wall_us, n,
                           prof.key_averages())


def profile_summary(torch, events, wall_us, n, averages=()) -> dict:
    """A trace of n steps that took wall_us on the host: device busy time
    (the union of the kernels', copies' and fills' intervals, the
    profiler's annotations left out: device_activity), launches and the
    host's wall time per step, and the host ops (from the trace's
    key_averages) and the kernels that take the most device time.
    Informational: where the trace holds no device activity, the device
    numbers are reported as not measured."""
    from torch.autograd import DeviceType
    dev = device_activity(torch, events)
    if not dev:
        return {"device_time": "not measured (no device events traced)",
                "host_wall_ms_per_step": wall_us / n / 1e3}
    busy = busy_us(dev)
    # device time by the host op that launched it (a kernel launched
    # through ctypes has no host op: see the kernel list)
    ops = []
    for a in averages:
        us = getattr(a, "self_device_time_total", None)
        if us is None:
            us = getattr(a, "self_cuda_time_total", 0.0)
        if a.device_type == DeviceType.CPU and us > 0:
            ops.append((a.key, us, a.count))
    ops.sort(key=lambda o: -o[1])
    kernels = {}
    for e in dev:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0][-60:]
        us, count = kernels.get(name, (0.0, 0))
        kernels[name] = (us + e.time_range.end - e.time_range.start,
                         count + 1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"host_wall_ms_per_step": wall_us / n / 1e3,
            "device_busy_ms_per_step": busy / n / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_ops_per_step": len(dev) / n,
            "top_ops_device_ms_per_step": [
                [key, us / n / 1e3, count // n] for key, us, count in ops[:8]],
            "top_kernels_device_ms_per_step": [
                [key, us / n / 1e3, count // n] for key, (us, count) in top]}


def host_bits(tree) -> list:
    """The tensors of a step's (output, stats, state) on the host, in
    pytree order."""
    from torch.utils._pytree import tree_leaves
    return [x.cpu().numpy() for x in tree_leaves(tree)]


def same_bits(got, want) -> bool:
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and a.tobytes() == b.tobytes() for a, b in zip(got, want))


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
    # on the card K5 runs the front end under the first stage's range
    st = (["fec"] if m.device.type == "cuda"
          else ["fec", "qpsk_map", "diff_mod", "carriers", "tii_null"])
    if m._dexter:
        return st + ["dexter_quantise"]
    if m._kiss:
        # with no window overlap K4 writes the wire words itself
        return st + (["kiss_ifft", "guard_interval", "format_convert"]
                     if s.ofdm_window_overlap else ["kiss_ifft"])
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
    the device time, and the port's counted kernels (KERNEL_NAMES) by
    their launches."""
    from torch.autograd import DeviceType
    calls = {e.id: (e.thread, e.time_range.start) for e in events
             if e.device_type == DeviceType.CPU and e.name not in stages
             and _RUNTIME_CALL.match(e.name)}
    # ranges by thread, for the innermost enclosing one
    by_thread = {}
    for name, thread, start, end in recorded_ranges(events, stages):
        by_thread.setdefault(thread, []).append((start, end, name))
    acc = {}
    for e in device_activity(torch, events):
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
        k = KERNEL_NAMES.get(kernel_of(e.name))
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
KERNEL_STAGE = {"ofdm_backend": "ofdm_ifft", "ofdm_cfr_backend": "ofdm_ifft",
                "resample": "resampler", "kiss_ifft": "kiss_ifft",
                "frontend": "fec"}


def stage_problems(rec, other_max=0.05, busy_rel=0.02) -> list:
    """What a --stages record fails of: every expected stage recorded and
    with device time and launches, no other range, the port's kernels
    under their stages only, OTHER at most other_max of the device time,
    and the stages' sum within busy_rel of the same trace's device busy
    time (profile_summary)."""
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
    """The card's first step (its f32 planes, stats) against the CPU
    modulator's on the same batch from init_state: the planes within
    3e-5*max|ref| (fp32 transforms and reductions in other orders;
    DPD_REL after the poly DPD), and with CFR the clip counts within the
    threshold margin, PAPR within 1e-3 dB, MER within 0.1 dB and
    mer_valid equal.  Raises where they differ; returns the largest
    difference and its tolerance."""
    from dabmod_tpu_torch.ops import ofdm_kernel
    state = cpu.init_state()
    margin = None
    if cpu.settings.enable_cfr:
        syms, _ = cpu.ofdm_symbols(batch.fic, batch.subchannels,
                                   state["ti_history"], state["tf_index"])
        margin = ofdm_kernel.cfr_threshold_margin(
            syms, cpu._ofdm_table, cpu.settings.cfr_clip,
            cpu.settings.cfr_error_clip, rel=MARGIN_REL
        ).sum(dim=1).numpy()
    out, _, stats = cpu.modulate_eti(batch, state)
    g_out, g_stats = first
    g = [x.cpu().numpy() for x in g_out]
    c = [x.numpy() for x in out]
    gs = {k: v.cpu().numpy() for k, v in g_stats.items()}
    cs = {k: v.numpy() for k, v in stats.items()}
    rel = DPD_REL if cpu.settings.poly_coef_file else 3e-5
    shape = (batch.fic.shape[0] // cpu.p.cif_count, cpu.tf_samples_out)
    bad = [f"stats keys {sorted(gs)} != {sorted(cs)}"] if set(gs) != set(
        cs) else []
    bad += [f"planes {a.shape} {a.dtype}, not {shape} float32" for a in g
            if a.shape != shape or a.dtype != np.float32]
    err = max(float(np.abs(a - b).max()) for a, b in zip(g, c))
    tol = rel * max(float(np.abs(x).max()) for x in c)
    if not err <= tol:
        bad.append(f"max abs err {err} > {tol}")
    if margin is not None:
        for key, lane in (("cfr_clip", 0), ("cfr_errclip", 1)):
            d = np.abs(gs[key].astype(np.int64) - cs[key])
            if not (d <= margin[:, lane]).all():
                bad.append(f"{key} differs beyond the threshold margin")
        for key, atol in (("papr_before_cfr", 1e-3),
                          ("papr_after_cfr", 1e-3), ("mer_db", 0.1)):
            d = float(np.abs(gs[key] - cs[key]).max())
            if not d <= atol:
                bad.append(f"{key} differs by {d} > {atol}")
        if not np.array_equal(gs["mer_valid"], cs["mer_valid"]):
            bad.append("mer_valid differs")
    if bad:
        raise RuntimeError(f"{name}: card vs CPU: {'; '.join(bad)}")
    return {"max_abs_err": err, "tol": tol, "rel": rel}


def time_steps(torch, m, staged, steps, runs):
    """The captured and the eager step of m over the staged batches in
    turn, the state threaded through, each as {"ms": per-step device ms
    of each run (CUDA events around `steps` steps, time_runs) in
    quartiles, "issue_ms": the host's ms to issue a step, "step": the
    step function, for profiling}."""
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
        dev, host = time_runs(torch, run, n=runs, warm=1)
        res[key] = {"ms": quartiles([d / steps for d in dev], steps),
                    "issue_ms": statistics.median(host) / steps, "step": fn}
    return res


def bench_one(torch, row, batch_tf, poly_path, steps=STEPS, runs=RUNS,
              card=None) -> dict:
    """One row of --configs at batch_tf TM I TFs (module docstring); card
    is device_info's record."""
    require_card(torch)
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
    bound_ms = nb["total"] / HBM_BYTES_PER_S * 1e3
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
           "hbm_bytes_per_s": HBM_BYTES_PER_S,
           "power_limit_w": card["power_limit_w"], "check": check}
    for key in ("captured", "eager"):
        prof = profile_steps(torch, t[key]["step"])
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
    (profile_summary)."""
    require_card(torch)
    from torch.profiler import ProfilerActivity, profile
    from dabmod_tpu_torch.models.modulator import STAGES
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
    summary = profile_summary(torch, events, wall_us, steps)
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
# --scaling and --collectives: the multi-rank tools
# ---------------------------------------------------------------------------

SCALING_BATCH_PER_RANK = 24      # TFs a rank (TM I; bench_scaling.py's 8 is
                                 # a CPU size)
SCALING_BATCHES = 2              # global batches checked, the state carried
TRACED_STEPS = 10                # steps a rank traces for NCCL's kernels
EXCHANGE_STEPS = 5               # eager steps whose exchanges are timed
RANK_TIMEOUT_S = 600.0           # a run of ranks, their start included
TF_S = 0.096                     # a TM I TF on air (the JAX tools' 0.096)
JAX_TF_SAMPLES = 196_608         # bench_scaling.py's samples a TF, always
SHARED_NOTE = ("ranks that share a device measure the exchange's "
               "correctness and its cost through the host, not scaling: "
               "no efficiency")
CPU_NOTE = "a CPU run (host clock): no device figure and no efficiency"


def require_ranks(torch, n_ranks: int, device: str, backend: str):
    """The devices n_ranks ranks need: a card where `device` is "cuda",
    and over NCCL one card a rank (NCCL refuses two ranks on one card)."""
    if torch.device(device).type != "cuda":
        return
    require_card(torch)
    have = torch.cuda.device_count()
    if backend == "nccl" and n_ranks > have:
        raise RuntimeError(f"{n_ranks} ranks over NCCL need {n_ranks} CUDA "
                           f"cards, one a rank; {have} present")


def run_device_info(torch, device: str) -> dict:
    """device_info on a card; on the CPU a record that says so."""
    if torch.device(device).type == "cuda":
        return device_info(torch)
    return {"name": "cpu", "power_limit_w": None, "nvidia_smi": None,
            "count": 0, "note": "a CPU run: no device figure"}


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier(mesh):
    if mesh.group is not None:
        import torch.distributed as dist
        dist.barrier(group=mesh.group)


def time_ranked(torch, mesh, step, steps, runs, warm=2):
    """`runs` runs of `steps` back-to-back calls of step() on this rank,
    the ranks started together (a barrier before each run): per run the
    step's ms (CUDA events around the run on the card; on the CPU the
    host clock to the run's end) and the host's ms to issue a step."""
    cuda = mesh.device.type == "cuda"
    for _ in range(warm):
        step()
    _sync(torch, mesh.device)
    dev, host = [], []
    for _ in range(runs):
        _barrier(mesh)
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        issue = (time.perf_counter() - t0) * 1e3
        if cuda:
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        dev.append(ms / steps)
        host.append(issue / steps)
    return dev, host


def _leaves(out) -> list:
    return list(out) if isinstance(out, tuple) else [out]


def _all_max(torch, mesh, values) -> list:
    """values (floats) as their maximum over the ranks (one all_reduce)."""
    t = torch.tensor(values, dtype=torch.float64, device=mesh.device)
    if mesh.group is not None:
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()


def traced_nccl(torch, mesh, step, steps):
    """`steps` calls of step() traced after a barrier
    (traced_launches): the trace's counts, and NCCL's all-reduce device ms
    a step, the median over the steps of each one's kernels (the wait for
    the slowest peer included; the ranks' skew in starting the trace
    lands on the first step alone)."""
    _barrier(mesh)
    _, traced = traced_launches(
        torch, lambda: [step() for _ in range(steps)], nccl=True)
    each = traced["nccl_all_reduce_each_ms"]
    k = len(each) // steps
    return traced, statistics.median(sum(each[i * k:(i + 1) * k])
                                     for i in range(steps))


def _graphs(step) -> list:
    """A GraphStep's graphs as (counted kernels, replays) records."""
    return [] if step is None else [
        {"batch_tf": B, "launches": dict(cap.launches),
         "replays": cap.replays} for B, cap in step.graphs.items()]


def _reference(torch, row, spec, staged, mesh):
    """The unsharded eager step on this rank's device over the staged
    global batches from init_state: this rank's TFs of each output and
    the final state, on the host; at world 1 also the unsharded captured
    step's (Modulator.modulate) times, as bench_default takes them.  The
    modulator is freed before the sharded step runs."""
    dev = mesh.device
    m, _ = build_modulator(row, spec["poly"], dev)
    tfs = mesh.tf_slice(staged[0][0].shape[0] // m.p.cif_count)
    st, outs = m.init_state(), []
    for fic, subs in staged:
        with torch.no_grad():
            out, st, _ = m._modulate_impl(fic, subs, st, *m._gain_args(),
                                          m._apply_swaps())
        outs.append([x[tfs].cpu().numpy() for x in _leaves(out)])
    ref = {"outs": outs, "state": host_bits(st),
           "rel": DPD_REL if m.settings.poly_coef_file else 3e-5}
    if spec["unsharded"]:
        st = [m.init_state()]
        i = [0]

        def step():
            fic, subs = staged[i[0] % len(staged)]
            i[0] += 1
            _, st[0], _ = m.modulate(fic, subs, st[0])
        dev_ms, _ = time_ranked(torch, mesh, step, spec["steps"],
                                spec["runs"])
        ref["unsharded_ms"] = statistics.median(dev_ms)
    del m
    _sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def scaling_rank(mesh, spec: dict) -> dict:
    """--scaling on one rank (parallel.launch.spawn and --scaling-worker
    run it; world 1 runs it in the calling process).  spec: config (a row
    of ALL_CONFIGS), batch_per_rank (TM I TFs a rank), poly (the identity
    poly file), steps, runs, traced, unsharded (time the unsharded step
    too).

    Every rank stages the same SCALING_BATCHES global batches on its
    device and replays them through the unsharded eager step (_reference),
    then through the sharded step from init_state, the kernel counts set
    to 0 just before and read just after (traced on the card): its TFs of
    each output within 3e-5*max|ref| (DPD_REL after the poly DPD) and its
    state equal to the bit.  Then runs of `steps` steps back to back,
    state threaded (time_ranked), and on the card a trace of `traced`
    steps for NCCL's kernels.  The slowest rank's median step, issue time
    and NCCL ms and the largest difference are all-reduced (MAX), so every
    rank returns them.  JSON-ready."""
    import torch
    from dabmod_tpu_torch.parallel import ShardedModulator
    dev = mesh.device
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    row = find_config(spec["config"])
    world = mesh.world_size
    n_tf = spec["batch_per_rank"] * world * batch_scale(row[1])
    m, specs = build_modulator(row, spec["poly"], dev)
    batches = make_batches(row[1], specs, n_tf, range(SCALING_BATCHES))
    staged = [on_device(torch, b, dev) for b in batches]
    ref = _reference(torch, row, spec, staged, mesh)

    sm = ShardedModulator(m, mesh)
    kernels = counted_kernels()

    def path():
        st, outs = sm.init_state(), []
        for fic, subs in staged:
            out, st, _ = sm.modulate(fic, subs, st)
            outs.append([x.cpu().numpy() for x in _leaves(out)])
        _sync(torch, dev)
        return st, outs
    for k in kernels.values():
        k.launches = 0
    if cuda:
        (st, outs), on_card = traced_launches(torch, path, nccl=True)
    else:
        (st, outs), on_card = path(), None
    launches = {k: f.launches for k, f in kernels.items()}
    graphs = _graphs(sm.compiled)

    diff = excess = 0.0
    for got, want in zip(outs, ref["outs"]):
        for g, w in zip(got, want):
            d = float(np.max(np.abs(g.astype(np.float64) - w)))
            tol = ref["rel"] * float(np.max(np.abs(w)))
            diff = max(diff, d)
            excess = max(excess, d / tol if tol else (0.0 if d == 0
                                                      else np.inf))
    state_equal = same_bits(host_bits(st), ref["state"])

    state = [st]
    i = [0]

    def step():
        fic, subs = staged[i[0] % len(staged)]
        i[0] += 1
        _, state[0], _ = sm.modulate(fic, subs, state[0])
    dev_ms, host_ms = time_ranked(torch, mesh, step, spec["steps"],
                                  spec["runs"])
    traced = nccl_ms = None
    if cuda:
        traced, nccl_ms = traced_nccl(torch, mesh, step, spec["traced"])
    step_ms = quartiles(dev_ms, spec["steps"])
    slowest, issue, nccl, diff_max, excess_max, unequal = _all_max(
        torch, mesh, [step_ms["median"], statistics.median(host_ms),
                      nccl_ms or 0.0, diff, excess, float(not state_equal)])
    return {"rank": mesh.rank, "world": world, "device": str(dev),
            "backend": _backend(mesh), "captured": sm.compiled is not None,
            "config": row[0], "mode": row[1], "tfs": n_tf,
            "tf_samples_out": m.tf_samples_out,
            "out_rate": m.settings.output_rate,
            "batch_per_rank": spec["batch_per_rank"],
            "clock": "cuda events" if cuda else "host clock (no card)",
            "step_ms": step_ms, "host_issue_ms": statistics.median(host_ms),
            "nccl_ms_per_step": nccl_ms,
            "slowest_step_ms": slowest, "slowest_host_issue_ms": issue,
            "slowest_nccl_ms_per_step": nccl if cuda else None,
            "max_abs_diff": diff_max, "diff_over_tol": excess_max,
            "tol_rel": ref["rel"], "state_equal": unequal == 0.0,
            "elementwise_ok": excess_max <= 1.0 and unequal == 0.0,
            "unsharded_step_ms": ref.get("unsharded_ms"),
            "launches": launches, "graphs": graphs, "on_card": on_card,
            "traced": traced, "traced_steps": spec["traced"],
            "eager_calls": 0 if sm.compiled is not None
            else SCALING_BATCHES}


def _backend(mesh) -> str | None:
    if mesh.group is None:
        return None
    import torch.distributed as dist
    return dist.get_backend(mesh.group)


def samples_per_s(tfs: int, tf_samples_out: int, step_ms: float) -> float:
    """Output samples a second: the samples the config emits (a TF's
    samples at its output rate) over the step."""
    return tfs * tf_samples_out / (step_ms / 1e3)


def scaling_row(ranks: list, **extra) -> dict:
    """One world's row from its ranks' records (scaling_rank)."""
    r0 = ranks[0]
    world = r0["world"]
    devices = [r["device"] for r in ranks]
    own = (all(d.startswith("cuda") for d in devices)
           and len(set(devices)) == world)
    step = r0["slowest_step_ms"]
    sps = samples_per_s(r0["tfs"], r0["tf_samples_out"], step)
    row = {"world": world, **extra, "config": r0["config"],
           "backend": r0["backend"], "captured": r0["captured"],
           "devices": devices, "own_cards": own, "clock": r0["clock"],
           "batch_per_rank": r0["batch_per_rank"], "tfs_per_step": r0["tfs"],
           "out_rate": r0["out_rate"], "tf_samples_out": r0["tf_samples_out"],
           "step_ms": step,
           "step_ms_ranks": [r["step_ms"] for r in ranks],
           "samples_per_s": sps,
           "x_realtime": r0["tfs"] * TF_S / (step / 1e3),
           "jax_tool_samples_per_s": r0["tfs"] * JAX_TF_SAMPLES
           / (step / 1e3),
           "host_issue_ms": r0["slowest_host_issue_ms"],
           "nccl_ms_per_step": r0["slowest_nccl_ms_per_step"],
           "max_abs_diff": r0["max_abs_diff"],
           "diff_over_tol": r0["diff_over_tol"],
           "state_equal": r0["state_equal"],
           "elementwise_ok": r0["elementwise_ok"],
           "ranks": ranks}
    if r0["unsharded_step_ms"] is not None:
        row["unsharded_step_ms"] = r0["unsharded_step_ms"]
        row["unsharded_samples_per_s"] = samples_per_s(
            r0["tfs"], r0["tf_samples_out"], r0["unsharded_step_ms"])
    if not all(d.startswith("cuda") for d in devices):
        row["note"] = CPU_NOTE
    elif not own:
        row["note"] = SHARED_NOTE
    return row


def with_efficiency(rows: list) -> list:
    """Each row's weak-scaling efficiency on samples/s against the row of
    the fewest ranks: T_N / (N x T_1) with a world-1 row
    (bench_scaling.py:148-151), per host against the 1-host row for
    --hosts (:222-227); None where the ranks of either row share a
    device."""
    base = min(rows, key=lambda r: r["world"], default=None)
    for r in rows:
        r["efficiency"] = (r["samples_per_s"] * base["world"]
                           / (r["world"] * base["samples_per_s"])
                           if base["own_cards"] and r["own_cards"]
                           else None)
    return rows


def _scaling_spec(config, batch_per_rank, steps, runs, poly, traced):
    return {"config": config, "batch_per_rank": batch_per_rank,
            "steps": steps, "runs": runs, "poly": poly, "traced": traced,
            "unsharded": False}


def run_scaling(torch, worlds=(1, 2, 4), config="realistic17",
                batch_per_rank=SCALING_BATCH_PER_RANK, steps=STEPS,
                runs=RUNS, device="cuda", backend="nccl",
                traced=TRACED_STEPS, timeout_s=RANK_TIMEOUT_S) -> dict:
    """--scaling --worlds (bench_scaling.py's single_process, --chips):
    each world of `worlds` at batch_per_rank TFs a rank, world 1 in this
    process (no process group: a world of one exchanges nothing), every
    other world's ranks from parallel.launch.spawn, one process a rank
    (device "cuda": card rank % the cards).  Returns the rows, with
    efficiency, and the device."""
    from dabmod_tpu_torch.parallel import make_mesh
    from dabmod_tpu_torch.parallel.launch import spawn
    require_ranks(torch, max(worlds), device, backend)
    card = run_device_info(torch, device)
    rows = []
    with tempfile.TemporaryDirectory(prefix="bench_gpu_") as d:
        spec = _scaling_spec(config, batch_per_rank, steps, runs,
                             _poly_file(d), traced)
        for world in worlds:
            t0 = time.perf_counter()
            if world == 1:
                ranks = [scaling_rank(make_mesh(device=device),
                                      dict(spec, unsharded=True))]
            else:
                ranks = spawn(scaling_rank, world, backend=backend,
                              device=device, store_path=d,
                              timeout_s=timeout_s, args=(spec,))
            rows.append(scaling_row(ranks, launcher="spawn" if world > 1
                                    else "in process",
                                    wall_s=time.perf_counter() - t0))
    return scaling_record(rows, card)


def free_port() -> int:
    """A free TCP port of 127.0.0.1 (bound to port 0, then closed)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path, n=4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def launch_workers(n_hosts, chips_per_host, spec, device, backend,
                   timeout_s, log_dir) -> list:
    """n_hosts * chips_per_host processes of `bench_gpu.py
    --scaling-worker`, joined by parallel.init_distributed at a free
    port of 127.0.0.1; their records (each worker prints its own last) in
    rank order.  A worker that exits non-zero, or the timeout, fails the
    call with every worker's stderr; no worker is left running."""
    world = n_hosts * chips_per_host
    port = free_port()
    procs, files = [], []
    try:
        for r in range(world):
            out = open(os.path.join(log_dir, f"rank{r}.out"), "w")
            err = open(os.path.join(log_dir, f"rank{r}.err"), "w")
            files += [out, err]
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--scaling-worker", "--rank", str(r), "--hosts",
                 str(n_hosts), "--chips-per-host", str(chips_per_host),
                 "--port", str(port), "--device", device, "--backend",
                 backend, "--spec", json.dumps(spec)],
                cwd=ROOT, stdin=subprocess.DEVNULL, stdout=out, stderr=err))
        deadline = time.monotonic() + timeout_s
        while True:
            rcs = [p.poll() for p in procs]
            failed = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if failed or time.monotonic() > deadline:
                why = (f"rank {failed[0]} exited with {rcs[failed[0]]}"
                       if failed else f"no result after {timeout_s:g} s")
                raise RuntimeError(
                    f"--scaling-worker ranks of {world}: {why}" + "".join(
                        f"\n--- rank {r} stderr:\n"
                        + _tail(os.path.join(log_dir, f"rank{r}.err"))
                        for r in range(world)))
            if all(rc == 0 for rc in rcs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    recs = []
    for r in range(world):
        with open(os.path.join(log_dir, f"rank{r}.out")) as f:
            lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
        if not lines:
            raise RuntimeError(f"--scaling-worker rank {r} printed no record")
        recs.append(json.loads(lines[-1]))
    return recs


def run_hosts(torch, hosts=(1, 2, 4), chips_per_host=1, config="realistic17",
              batch_per_rank=SCALING_BATCH_PER_RANK, steps=STEPS, runs=RUNS,
              device="cuda", backend="nccl", traced=TRACED_STEPS,
              timeout_s=RANK_TIMEOUT_S) -> dict:
    """--scaling --hosts (bench_scaling.py's worker/run_config): for each H
    of `hosts`, H x chips_per_host separate processes (launch_workers)
    meshed as make_host_chip_mesh(H, chips_per_host).  Returns the rows,
    with efficiency, and the device."""
    require_ranks(torch, max(hosts) * chips_per_host, device, backend)
    card = run_device_info(torch, device)
    rows = []
    with tempfile.TemporaryDirectory(prefix="bench_gpu_") as d:
        spec = _scaling_spec(config, batch_per_rank, steps, runs,
                             _poly_file(d), traced)
        for n_hosts in hosts:
            t0 = time.perf_counter()
            world = n_hosts * chips_per_host
            logs = tempfile.mkdtemp(prefix=f"hosts{n_hosts}_", dir=d)
            ranks = launch_workers(
                n_hosts, chips_per_host, dict(spec, unsharded=world == 1,
                                              timeout_s=timeout_s),
                device, backend, timeout_s, logs)
            rows.append(scaling_row(
                ranks, hosts=n_hosts, chips_per_host=chips_per_host,
                launcher="init_distributed",
                wall_s=time.perf_counter() - t0))
    return scaling_record(rows, card)


def scaling_worker(args) -> int:
    """--scaling-worker: one rank of run_hosts in this process: one
    intra-op thread, parallel.init_distributed at 127.0.0.1:<port> (which
    sets this process's card before any CUDA work), the host x chip mesh,
    scaling_rank; prints its record as the last line."""
    import torch
    import torch.distributed as dist
    from dabmod_tpu_torch.parallel import (init_distributed,
                                           make_host_chip_mesh)
    torch.set_num_threads(1)
    spec = json.loads(args.spec)
    world = args.hosts * args.chips_per_host
    mesh = init_distributed(f"127.0.0.1:{args.port}", world, args.rank,
                            backend=args.backend, device=args.device,
                            timeout_s=spec["timeout_s"])
    print(f"rank {args.rank}: joined a group of {world} over "
          f"{args.backend} on {mesh.device}", file=sys.stderr, flush=True)
    try:
        rec = scaling_rank(make_host_chip_mesh(
            args.hosts, args.chips_per_host, device=mesh.device), spec)
    finally:
        dist.destroy_process_group()
    print(json.dumps(rec), flush=True)
    return 0


SCALING_METRIC = ("weak scaling: output samples/s of the sharded step, a "
                  "fixed batch a rank, steps back to back")


def scaling_record(rows, card) -> dict:
    """--scaling's record: the rows with their efficiency, each printed."""
    for r in with_efficiency(rows):
        print_scaling_row(r)
    return {"metric": SCALING_METRIC, "rows": rows, "device": card}


def print_scaling_row(r):
    eff = "n/a" if r.get("efficiency") is None else f"{r['efficiency']:.3f}"
    print(f"world={r['world']} ({r['launcher']}, {r['backend']}, "
          f"{'captured' if r['captured'] else 'eager'}) "
          f"{r['samples_per_s'] / 1e6:.1f} MS/s, step {r['step_ms']:.4f} ms "
          f"(slowest rank), issue {r['host_issue_ms']:.4f} ms, NCCL ms "
          f"{_num(r['nccl_ms_per_step'])}; efficiency={eff}; output="
          + ("ok" if r["elementwise_ok"] else "MISMATCH")
          + f" (max_abs_diff={r['max_abs_diff']:.3g})"
          + (f"; {r['note']}" if "note" in r else ""), flush=True)


# measure_ti_collectives.py's configurations (:150-168): name, ensemble,
# ModSettings keywords (the poly file added by collective_configs), global
# TFs.  "realistic17 full" is the JAX tool's (4.096 MS/s, K3), not the
# --configs row of that name, and writes s16 words where the JAX tool
# writes f32 planes: only an integer format counts num_clipped, so only
# there does the sharded step exchange it.
COLLECTIVE_CONFIGS = (
    ("base 2sub", "bench", {}, 16),
    ("realistic17 full", "realistic",
     dict(filter_taps_file="default", ofdm_window_overlap=32,
          enable_cfr=True, cfr_clip=12.0, cfr_error_clip=3.0,
          tii_enable=True, output_rate=4_096_000,
          poly_coef_file="__builtin_poly__", output="file",
          file_output_format="s16"), 24),
)


def collective_configs(full: bool) -> list:
    """--collectives' configurations: "base 2sub", and with --full
    "realistic17 full" (COLLECTIVE_CONFIGS)."""
    return list(COLLECTIVE_CONFIGS[:2 if full else 1])


def jax_ti_payload(widths, n_rows: int, world: int) -> list:
    """The collectives dabmod_tpu's sharded time interleaver puts into its
    compiled step for a batch of n_rows CIF rows over `world` devices, as
    its source writes them (dabmod_tpu/parallel/sharding.py:113-148), with
    the bytes of their int32 bits: per sub-channel of n bits a CIF,
    ceil(15/tl) collective-permutes of its last min(tl, 15) rows (tl =
    n_rows/world rows a device), and one all-reduce of every sub-channel's
    [15, n] history as one tuple.  measure_ti_collectives.py counts that
    tuple's bytes as 0 (it reads the result type up to its first "(")."""
    if world == 1 or n_rows % world:
        return []
    tl = n_rows // world
    hops, halo = -(-15 // tl), min(tl, 15)
    out = [{"kind": "collective-permute", "shape": [halo, n],
            "bytes": 4 * halo * n} for n in widths for _ in range(hops)]
    out.append({"kind": "all-reduce", "shape": [[15, n] for n in widths],
                "bytes": sum(4 * 15 * n for n in widths)})
    return out


def _exchange_record(counts) -> dict:
    """parallel.EXCHANGES' couplings as a JSON-ready record."""
    return {name: {"collectives": c.collectives,
                   "buffer_bytes": c.buffer_bytes,
                   "tail_shape": list(c.tail_shape), "dtype": c.dtype,
                   "ms": c.ms() if c.spans is not None else None}
            for name, c in counts.couplings.items()}


def collectives_rank(mesh, spec: dict) -> list:
    """--collectives on one rank (run by parallel.launch.spawn).  For each
    configuration of spec["configs"] (collective_configs), one global
    batch on this rank's device, each step from init_state as the JAX
    tool's steps are, the kernel counts set to 0 before and read after:

    * EXCHANGE_STEPS eager sharded steps (ShardedModulator._sharded_impl),
      each with parallel.EXCHANGES reset(timing=True): per coupling its
      collectives, buffer bytes, tail and ms;
    * the eager sharded step timed back to back (time_ranked), and where
      the sharded step captures (NCCL), its graph: EXCHANGES counted at its
      warm-up and capture, its replays timed back to back and traced for
      NCCL's kernels;
    * the severed step (measure_ti_collectives.py's t_nostate): this
      rank's TFs through m._modulate_impl from init_state with no exchange,
      outputs discarded, eager and (on the card) captured under a
      GraphStep of its own, timed the same way.

    Returns a JSON-ready record a configuration."""
    import torch
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    from dabmod_tpu_torch.models import Modulator, compiled, \
        make_default_layout
    from dabmod_tpu_torch.parallel import EXCHANGES, ShardedModulator
    dev = mesh.device
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = counted_kernels()
    out = []
    for name, ensemble, kw, n_tf in spec["configs"]:
        specs = REALISTIC_MUX_SPECS if ensemble == "realistic" \
            else BENCH_SPECS
        kw = dict(kw)
        if kw.get("poly_coef_file") == "__builtin_poly__":
            kw["poly_coef_file"] = spec["poly"]
        s = ModSettings(dab_mode=1, device_interleave=False, **kw)
        if s.output == "file":
            s.normalise_for_output()
        m = Modulator(make_default_layout(1, specs), s, device=dev)
        sm = ShardedModulator(m, mesh)
        (batch,) = make_batches(1, specs, n_tf, (0,))
        fic, subs = on_device(torch, batch, dev)
        _, frames = sm._split(fic.shape[0])
        fic_l, subs_l = fic[frames], tuple(x[frames] for x in subs)
        st0 = m.init_state()
        # eager steps, and those of them that are severed: the unsharded
        # step, whose front end is K5 on the card
        calls, severed_calls = [0], [0]

        def sharded_eager():
            calls[0] += 1
            with torch.no_grad():
                sm._sharded_impl(fic_l, subs_l, st0, *m._gain_args(),
                                 m._apply_swaps())

        def severed_eager():
            calls[0] += 1
            severed_calls[0] += 1
            with torch.no_grad():
                m._modulate_impl(fic_l, subs_l, st0, *m._gain_args(),
                                 m._apply_swaps())

        def timed(step):
            dev_ms, host = time_ranked(torch, mesh, step, spec["steps"],
                                       spec["runs"])
            return {"ms": statistics.median(dev_ms),
                    "issue_ms": statistics.median(host)}

        for k in kernels.values():
            k.launches = 0
        per_step = []
        for i in range(2 + EXCHANGE_STEPS):
            EXCHANGES.reset(timing=True)
            sharded_eager()
            _sync(torch, dev)
            per_step.append(_exchange_record(EXCHANGES))
        EXCHANGES.reset()
        per_step = per_step[2:]          # the first two warm up
        couplings = {}
        for cname, c in per_step[0].items():
            couplings[cname] = dict(
                c, ms=statistics.median(p[cname]["ms"] for p in per_step),
                same_every_step=all(
                    {k: v for k, v in p[cname].items() if k != "ms"}
                    == {k: v for k, v in c.items() if k != "ms"}
                    for p in per_step))
        rec = {"config": name, "world": mesh.world_size, "rank": mesh.rank,
               "device": str(dev), "backend": _backend(mesh),
               "batch_tf": n_tf, "subchannel_ti_bits": list(
                   m._subch_ti_bits), "resampler_route": m._res_route,
               "couplings": couplings,
               "eager": timed(sharded_eager)}
        graphs = []
        if sm.compiled is not None:
            def sharded_captured():
                sm.compiled.step(m, fic_l, subs_l, st0)
            EXCHANGES.reset()
            sharded_captured()
            rec["captured_exchanges"] = _exchange_record(EXCHANGES)
            graphs += _graphs(sm.compiled)
            rec["captured"] = timed(sharded_captured)
            rec["traced"], rec["nccl_ms_per_step"] = traced_nccl(
                torch, mesh, sharded_captured, spec["traced"])
        rec["severed_eager"] = timed(severed_eager)
        if cuda:
            severed = compiled.GraphStep(m._modulate_impl)

            def severed_captured():
                severed.step(m, fic_l, subs_l, st0)
            rec["severed_captured"] = timed(severed_captured)
            graphs += _graphs(severed)
        rec.update(launches={k: f.launches for k, f in kernels.items()},
                   graphs=graphs, eager_calls=calls[0],
                   severed_calls=severed_calls[0],
                   traced_steps=spec["traced"])
        out.append(rec)
        del sm, m
        _sync(torch, dev)
    return out


def collectives_summary(ranks: list) -> list:
    """A configuration's record from its ranks' (collectives_rank): rank
    0's couplings (every rank's tail is the same), per coupling its
    collectives and buffer bytes a step, each rank's tail, the ring
    all_reduce's traffic through each rank (2 (world-1)/world x the
    buffer), the eager ms (slowest rank); the step's total bytes and
    their rate at real time (measure_ti_collectives.py:106, 135); the
    sharded and severed steps' ms (slowest rank), and the JAX step's TI
    payload beside."""
    out = []
    for recs in zip(*ranks):
        r0 = recs[0]
        world = r0["world"]
        couplings = {}
        for cname, c in r0["couplings"].items():
            tail = int(np.prod(c["tail_shape"], dtype=np.int64))
            couplings[cname] = {
                "collectives_per_step": c["collectives"],
                "tail_shape": c["tail_shape"], "dtype": c["dtype"],
                "tail_elements": tail,
                "tail_bytes": c["buffer_bytes"] // (world
                                                    * c["collectives"]),
                "buffer_bytes_per_step": c["buffer_bytes"],
                "ring_bytes_per_rank": 2 * (world - 1) * c["buffer_bytes"]
                / world,
                "eager_ms": max(r["couplings"][cname]["ms"] for r in recs),
                "same_every_step": all(r["couplings"][cname]
                                       ["same_every_step"] for r in recs)}
        total = sum(c["buffer_bytes_per_step"] for c in couplings.values())

        def slowest(key):
            return (max(r[key]["ms"] for r in recs) if key in r0 else None)
        step, severed = slowest("captured"), slowest("severed_captured")
        n_rows = r0["batch_tf"] * 4
        jax = jax_ti_payload(r0["subchannel_ti_bits"], n_rows, world)
        devices = [r["device"] for r in recs]
        rec = {"config": r0["config"], "world": world,
               "backend": r0["backend"], "devices": devices,
               "shared_device": len(set(devices)) < world,
               "batch_tf": r0["batch_tf"],
               "resampler_route": r0["resampler_route"],
               "couplings": couplings,
               "total_buffer_bytes_per_step": total,
               "mb_per_s_realtime": total / (r0["batch_tf"] * TF_S) / 1e6,
               "eager_step_ms": slowest("eager"),
               "captured_step_ms": slowest("captured"),
               "severed_eager_ms": slowest("severed_eager"),
               "severed_captured_ms": slowest("severed_captured"),
               "state_carry_upper_bound_ms": {
                   "eager": slowest("eager") - slowest("severed_eager"),
                   "captured": (step - severed if "captured" in r0
                                else None)},
               "nccl_ms_per_step": (max(r["nccl_ms_per_step"] for r in recs)
                                    if "nccl_ms_per_step" in r0 else None),
               "jax_ti_payload": jax,
               "jax_ti_payload_bytes": sum(c["bytes"] for c in jax),
               "ranks": list(recs)}
        if not all(d.startswith("cuda") for d in devices):
            rec["note"] = CPU_NOTE
        elif rec["shared_device"]:
            rec["note"] = SHARED_NOTE
        out.append(rec)
    return out


def run_collectives(torch, full=False, world=None, backend=None,
                    device="cuda", steps=STEPS, runs=RUNS,
                    traced=TRACED_STEPS, configs=None,
                    timeout_s=RANK_TIMEOUT_S) -> dict:
    """--collectives [--full] (measure_ti_collectives.py): the sharded
    step's exchanges per coupling on `world` ranks from
    parallel.launch.spawn.  By default world 4 over NCCL where there are
    four cards, else 2 gloo ranks sharing the card (labelled so);
    `configs` replaces collective_configs(full)."""
    from dabmod_tpu_torch.parallel.launch import spawn
    if torch.device(device).type == "cuda":
        require_card(torch)
        four = torch.cuda.device_count() >= 4
    else:
        four = False
    world = world or (4 if four else 2)
    backend = backend or ("nccl" if four else "gloo")
    if world < 2:
        raise ValueError("--collectives measures exchanges: 2 ranks or more")
    require_ranks(torch, world, device, backend)
    card = run_device_info(torch, device)
    with tempfile.TemporaryDirectory(prefix="bench_gpu_") as d:
        spec = {"configs": configs or collective_configs(full),
                "poly": _poly_file(d), "steps": steps, "runs": runs,
                "traced": traced}
        t0 = time.perf_counter()
        ranks = spawn(collectives_rank, world, backend=backend,
                      device=device, store_path=d, timeout_s=timeout_s,
                      args=(spec,))
        wall = time.perf_counter() - t0
    recs = collectives_summary(ranks)
    for r in recs:
        print_collectives(r)
    return {"configs": recs, "world": world, "backend": backend,
            "spawn_s": wall, "device": card}


def print_collectives(r):
    """measure_ti_collectives.py's report, the port's beside JAX's."""
    print(f"[{r['config']}] world {r['world']} over {r['backend']} on "
          f"{', '.join(sorted(set(r['devices'])))}, {r['batch_tf']} TFs:")
    for name, c in r["couplings"].items():
        print(f"  {name:16s} {c['collectives_per_step']} all_reduce, tail "
              f"{c['tail_shape']} {c['dtype']} ({c['tail_elements']} "
              f"elements), buffer {c['buffer_bytes_per_step']} B, ring "
              f"{c['ring_bytes_per_rank']:.0f} B a rank, eager "
              f"{c['eager_ms']:.4f} ms")
    jax = r["jax_ti_payload"]
    hops = sum(c["bytes"] for c in jax[:-1])
    print(f"  total {r['total_buffer_bytes_per_step']} B a step "
          f"({r['mb_per_s_realtime']:.2f} MB/s at real time); JAX's TI "
          f"(its source): {len(jax) - 1} collective-permutes ({hops} B) "
          f"and an all-reduce of the new histories "
          f"({r['jax_ti_payload_bytes'] - hops} B, counted as 0 by "
          f"measure_ti_collectives.py); the port: one all_reduce of world "
          f"x tail bytes for every sub-channel together")
    bound = r["state_carry_upper_bound_ms"]
    print(f"  step ms: eager {_num(r['eager_step_ms'])}, captured "
          f"{_num(r['captured_step_ms'])}; severed: eager "
          f"{_num(r['severed_eager_ms'])}, captured "
          f"{_num(r['severed_captured_ms'])}; the state carry costs at "
          f"most {_num(bound['eager'])} eager, {_num(bound['captured'])} "
          f"captured; NCCL a replay {_num(r['nccl_ms_per_step'])}"
          + (f"; {r['note']}" if "note" in r else ""), flush=True)


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--configs", action="store_true")
    mode.add_argument("--stages", action="store_true")
    mode.add_argument("--scaling", action="store_true")
    mode.add_argument("--collectives", action="store_true")
    mode.add_argument("--scaling-worker", action="store_true",
                      help="one rank of --scaling --hosts (started by it)")
    ap.add_argument("rest", nargs="*",
                    help="[batch_tf]; with --stages [CONFIG] [batch_tf]")
    ap.add_argument("--only", default=None,
                    help="--configs: the rows whose name contains this")
    ap.add_argument("--sweep", default=None,
                    help="--configs: comma-separated batch_tf list, each "
                         "row at its best")
    ap.add_argument("--worlds", default="1,2,4",
                    help="--scaling: comma-separated world sizes, ranks "
                         "spawned in one launcher")
    ap.add_argument("--hosts", default=None,
                    help="--scaling: comma-separated host counts, "
                         "H x --chips-per-host separate processes joined "
                         "by init_distributed (in place of --worlds)")
    ap.add_argument("--chips-per-host", type=int, default=1)
    ap.add_argument("--config", default="realistic17",
                    help="--scaling: the ALL_CONFIGS row (default "
                         "realistic17)")
    ap.add_argument("--full", action="store_true",
                    help="--collectives: also the JAX tool's realistic17 "
                         "full")
    ap.add_argument("--device", default="cuda",
                    help="--scaling, --collectives: cuda, or cpu for a "
                         "rehearsal over gloo")
    ap.add_argument("--backend", default=None,
                    help="--scaling, --collectives: nccl or gloo (default "
                         "nccl on cuda, gloo on the CPU)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--spec", default=None)
    ap.add_argument("--json", dest="json_out", default=None)
    args = ap.parse_args(argv)
    import torch
    multi_rank = args.scaling or args.collectives or args.scaling_worker
    if not multi_rank and args.device != "cuda":
        ap.error("--device applies to --scaling and --collectives")
    on_card = torch.device(args.device).type == "cuda"
    backend = args.backend or ("nccl" if on_card else "gloo")
    if on_card:
        require_card(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.scaling_worker:
        args.backend = backend
        args.hosts = int(args.hosts)
        return scaling_worker(args)
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
    elif args.scaling:
        kw = dict(config=args.config, device=args.device, backend=backend)
        if args.hosts:
            rec = run_hosts(torch, [int(x) for x in args.hosts.split(",")],
                            args.chips_per_host, **kw)
        else:
            rec = run_scaling(torch, [int(x) for x in args.worlds.split(",")],
                              **kw)
        problems = [f"world {r['world']}: output beyond the tolerance or "
                    f"state unequal" for r in rec["rows"]
                    if not r["elementwise_ok"]]
    elif args.collectives:
        rec = run_collectives(torch, args.full, backend=args.backend,
                              device=args.device)
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
