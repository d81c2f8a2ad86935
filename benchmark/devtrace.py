"""The reduction of a torch.profiler trace of a stretch of the window to
what the per-layer metrics and the breakdown read: the device's activity
(kernels, copies and fills; the profiler's own annotations of host ranges
on the device timeline left out), its union, each kernel's launches, and
the idle gaps between device activity with the benchmark's host range
that was open when each began.  (The union and the kernel-name reduction
are copies of chip_smoke.py's device_activity, busy_us and _kernel_of.)"""
from __future__ import annotations

import collections
import dataclasses

# the benchmark's host ranges, the layers they wrap (sinks.py, cell.py)
RANGE_PREFIX = "bench."
NO_RANGE = "runtime.main (parse, stage, issue, copy out)"


def kernel_of(event_name: str) -> str:
    """A device event's function name without its namespace, template
    arguments and parameters."""
    name = event_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split()[-1].split("::")[-1]


def union_us(spans) -> float:
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


@dataclasses.dataclass
class TraceSummary:
    wall_s: float                       # the traced stretch, host clock
    busy_s: float                       # union of device activity
    kernels: dict                       # kernel name -> [device seconds]
    idle_by_range: dict                 # host range -> idle seconds
    batches: int                        # steps issued in the stretch
    timings: dict                       # ModRuntime.timings' increase

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, sum(v)) for k, v in self.kernels.items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps[:top]]}


def summarise(events, wall_s, main_tid, batches, timings):
    """TraceSummary of torch.profiler events (prof.events())."""
    from torch.autograd import DeviceType
    dev, ranges = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                dev.append(e)
        elif e.name.startswith(RANGE_PREFIX):
            ranges.append((e.time_range.start, e.time_range.end, e.name,
                           e.thread == main_tid))
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    kernels = collections.defaultdict(list)
    for e in dev:
        kernels[kernel_of(e.name)].append(
            (e.time_range.end - e.time_range.start) / 1e6)
    # idle gaps between merged device spans, each put under the benchmark
    # range open at its start (the main thread's first, then any thread's)
    idle = collections.defaultdict(float)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    ranges.sort()
    active, nxt = [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        while nxt < len(ranges) and ranges[nxt][0] <= a:
            active.append(ranges[nxt])
            nxt += 1
        active = [r for r in active if r[1] > a]
        open_ = sorted(active, key=lambda r: (not r[3], -r[0]))
        idle[open_[0][2] if open_ else NO_RANGE] += (b - a) / 1e6
    return TraceSummary(wall_s, union_us(spans) / 1e6, dict(kernels),
                        dict(idle), batches, timings)
