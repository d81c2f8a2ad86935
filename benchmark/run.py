"""The benchmark of dabmod_tpu_torch, the PyTorch and CUDA DAB modulator,
one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout that holds the port, on a machine with the
CUDA cards the cell asks for (BENCHMARK.json).  The last line of standard
output is one JSON object: correct, attempted, failed, metrics (with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
ones, and the breakdown) and device; the numbers compared with the plain
reference stand beside their limits under "checks", last, and as the last
lines of standard error.  Without the cards it exits 1 and prints no
result."""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

# every build and kernel cache of the program inside the checkout, at
# fixed paths (the port builds its own libraries in dabmod_tpu_torch/_build)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(BENCH, "_cache", sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "dabmod_tpu")


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 1


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def host_info() -> dict:
    """The host the run had: its CPU model, the cores the machine shows and
    those this process may run on (host work sets the pace of most cells,
    so a number is read beside the host it came from)."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith("model name"):
                    model = ln.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    cores = sorted(os.sched_getaffinity(0))
    spans, start = [], cores[0]
    for a, b in zip(cores, cores[1:] + [None]):
        if b != a + 1:
            spans.append(f"{start}-{a}" if a > start else f"{a}")
            start = b
    return {"cpu": model, "cores": os.cpu_count(),
            "affinity": ",".join(spans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if a.workload not in cells:
        return fail(f"no cell {a.workload!r} in BENCHMARK.json")
    cell = cells[a.workload]

    import cell as cell_mod
    run = cell_mod.Cell(cell, a.seed, a.seconds, bool(a.trace), T_PROCESS)
    try:
        import torch
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            return fail(f"the cell needs {cell['chips']} CUDA card(s); "
                        f"found {torch.cuda.device_count()}: no result")
        res = run.run()
        run.close()
        if res["run_result"] != "NORMAL_END":
            return fail(f"the runtime ended with {res['run_result']}")
        checks = run_checks(run, res)
    finally:
        run.cleanup()
    line = result_line(spec, cell, run, res, checks, bool(a.trace))
    diag = {k: res[k] for k in ("frames_per_s", "latency_p50_ms",
                                "latency_p95_ms", "frames_read") if k in res}
    diag["setup_s"] = run.setup_s
    diag["window_timings_s"] = {k: round(v, 4) for k, v in
                                run.timings_window.items()}
    diag["window_cpu_s"] = run.host_cpu
    if run.open_loop and res.get("latencies"):
        lat = res["latencies"]
        diag["latency_quantiles_ms"] = {
            q: round(float(np.percentile(lat, q)), 3)
            for q in (10, 50, 75, 90, 95, 99, 100)}
    if not run.open_loop:
        per_s = [0] * (int(run.seconds) + 1)
        for _tf, at in run.log.arrivals:
            if run.t_start <= at <= run.t_end:
                per_s[min(int(at - run.t_start), len(per_s) - 1)] += run.cif
        diag["frames_each_s"] = per_s
    if res.get("trace") is not None:
        diag.update(trace_wall_s=res["trace"].wall_s,
                    trace_batches=res["trace"].batches)
    print("run: " + json.dumps(diag), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} <= limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    if run.gen is not None and run.gen_report.get("late_s"):
        late = sorted(run.gen_report["late_s"])
        print("generator: " + json.dumps(
            {"sent": run.gen_report.get("sent"),
             "late_ms_p50": 1e3 * late[len(late) // 2],
             "late_ms_max": 1e3 * late[-1]}))
    # the last step before the result: whatever the run, the check and the
    # metric readers loaded, no module of JAX or the JAX package
    found = forbidden_modules()
    if found:
        return fail("modules of JAX or the JAX package loaded: "
                    + ", ".join(found) + ": no result")
    print(json.dumps(line), flush=True)
    return 0


def run_checks(run, res) -> dict:
    """Every number compared, with its limit (the configuration's)."""
    import cell as cell_mod
    limits = run.cfg["limits"]
    wanted = min(run.traffic["check_tfs"], max(1, run.log.seen_in_window))
    checks = {"lost_frames": {"value": res["lost_frames"], "limit": 0},
              "tfs_not_compared": {"value": wanted - len(run.log.sample),
                                   "limit": 0}}
    gaps = cell_mod.judge(run, run.log.sample, run.device)
    for name, value in gaps.items():
        checks[name] = {"value": value, "limit": limits[name]}
    return checks


def result_line(spec, cell, run, res, checks, traced) -> dict:
    import torch
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if not traced:
        values = {"setup_s": run.setup_s, **res}
        for m in spec["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]) \
                    and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": res.get("memory_peak_bytes"),
              "power_limit": power_limit(), "host": host_info()}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if traced:
        t = res.get("trace")
        if t is not None:
            ctx = {"device_kind": device["kind"],
                   "batch_tf": run.traffic["batch_tf"], "rate": run.rate}
            import cell as cell_mod
            for m in spec["per_layer"]:
                if cell["name"] not in m.get("workloads", [cell["name"]]):
                    continue
                v = cell_mod.load_reader(m["name"])(t, ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            device.update(busy_s=t.busy_s, window_s=t.wall_s)
            line["breakdown"] = t.breakdown()
    line["checks"] = checks
    return line


if __name__ == "__main__":
    sys.exit(main())
