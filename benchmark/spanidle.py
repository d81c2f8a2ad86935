"""The idle gaps of a traced run put under the program's own spans as well
as the benchmark's ranges, and the share of the window that the main
thread's spans cover:

    python3 benchmark/spanidle.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card the cell asks for.  It makes one
traced run, as run.py --trace 1 does, and prints its result line with
these keys more: `idle_by_span`, each idle gap between device activity
under the innermost `dabmod.*` or `bench.*` range open when it began (the
main thread's first, then any thread's, else devtrace.NO_RANGE);
`main_span_share`, the main thread's spans summed over the window
(ModRuntime.timings) over the window's wall; `window_timings_s`; the
window's end-to-end numbers (`window`, the traced stretch included); and
the traced stretch's wall and steps.
devtrace.summarise, which the per-layer metrics read, sees the
benchmark's ranges alone."""
from __future__ import annotations

import argparse
import collections
import json
import os
import threading

import devtrace

# the program's own spans (dabmod_tpu_torch/utils/spans.py), recorded as
# ranges while a profiler records
SPAN_PREFIX = "dabmod."
# ModRuntime.timings' keys of the main thread's spans
MAIN_SPANS = ("read_s", "parse_s", "stage_in_s", "modulate_s", "copy_out_s",
              "handoff_s")


def idle_by_span(events, main_tid) -> dict:
    """Idle seconds between the merged device activity of torch.profiler
    events, each gap under the innermost range (the latest started) open
    at its start on the main thread, else on any thread, else under
    devtrace.NO_RANGE."""
    from torch.autograd import DeviceType
    dev, ranges = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith((devtrace.RANGE_PREFIX, SPAN_PREFIX)):
            # a host event's `thread` is the profiler's own thread number;
            # the system's thread id is its device_resource_id
            main = main_tid in (e.thread, getattr(e, "device_resource_id",
                                                  None))
            ranges.append((e.time_range.start, e.time_range.end, e.name,
                           main))
    merged = []
    for s, e in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    idle = collections.defaultdict(float)
    ranges.sort()
    active, nxt = [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        while nxt < len(ranges) and ranges[nxt][0] <= a:
            active.append(ranges[nxt])
            nxt += 1
        active = [r for r in active if r[1] > a]
        open_ = max(active, key=lambda r: (r[3], r[0]), default=None)
        idle[open_[2] if open_ else devtrace.NO_RANGE] += (b - a) / 1e6
    return dict(idle)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    import run as run_mod       # the harness's caches and the root's path
    with open(os.path.join(run_mod.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = {w["name"]: w for w in spec["workloads"]}[a.workload]
    import cell as cell_mod
    run = cell_mod.Cell(cell, a.seed, a.seconds, True, run_mod.T_PROCESS)
    try:
        res = run.run()
        run.close()
        checks = run_mod.run_checks(run, res)
    finally:
        run.cleanup()
    line = run_mod.result_line(spec, cell, run, res, checks, True)
    line["run_result"] = res["run_result"]
    # the window's end-to-end numbers, traced stretch included
    line["window"] = {k: res[k] for k in ("frames_per_s", "latency_p50_ms")
                      if k in res}
    if res.get("trace") is not None:
        line["trace_wall_s"] = res["trace"].wall_s
        line["trace_batches"] = res["trace"].batches
    if run.prof_state == "done":
        idle = idle_by_span(run.prof.events(), threading.get_native_id())
        line["idle_by_span"] = sorted(idle.items(), key=lambda kv: -kv[1])
    w = run.timings_window
    line["main_span_share"] = (sum(w.get(k, 0.0) for k in MAIN_SPANS)
                               / (run.t_end - run.t_start))
    line["window_timings_s"] = w
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
