"""The control of the comparison that decides `correct`: the plain reference
put in the program's place and computed in TF32 (reference/chain.py,
precision="tf32"), at the cell's own size, judged by the same numbers and
limits as a run.  It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--cpu]

renders as many TFs as a run compares, drawn from the seed over the TFs a
run of the cell reaches, and prints one JSON line a seed.  The benchmark's
own runs do not run it."""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)

import numpy as np  # noqa: E402

import cell as cell_mod  # noqa: E402
import streams  # noqa: E402

# the TFs a run reaches: a bulk run of run_seconds at some 6,000 TFs a
# second, a live one its window's
BULK_TFS = 120_000


def control_readings(workload: dict, seed: int, seconds: float,
                     device: str, n_tfs: int | None = None) -> dict:
    """The control's numbers for one seed: the TF32 reference against the
    reference on `n_tfs` TFs (the cell's check_tfs by default)."""
    from reference.chain import Chain
    cfg = cell_mod.load_json("configs", workload["config"])
    traffic = cell_mod.load_json("traffic", workload["traffic"])
    ensemble = [tuple(e) for e in cfg["ensemble"]]
    cif = cell_mod.cif_count(cfg)
    n_tfs = n_tfs or traffic["check_tfs"]
    rng = np.random.default_rng([seed, 0xC0])
    if traffic["loop"] == "open":
        n = math.ceil((traffic["warm_s"] + seconds + traffic["tail_s"])
                      * traffic["rate_frames_per_s"])
        lo = math.ceil(traffic["warm_s"] * traffic["rate_frames_per_s"]
                       / cif)
        hi = lo + int(seconds * traffic["rate_frames_per_s"] / cif)
    else:
        n, lo, hi = traffic["file_frames"], 0, BULK_TFS
    frames = streams.make_frames(seed, n, ensemble)
    tfs = sorted(rng.choice(np.arange(lo, hi), size=n_tfs, replace=False))
    settings = cell_mod.reference_settings(cfg)
    ref = Chain(settings, device, "f64")
    ctl = Chain(settings, device, "tf32")
    wire = settings["wire"]
    worst = {}
    for tf in tfs:
        first = max(0, tf - 5)
        idx = np.arange(cif * first, cif * (tf + 1)) % n
        want = ref.render(frames[idx], first)[0].cpu().numpy()
        got = ctl.render(frames[idx], first)[0].cpu().numpy()
        if wire == "s16":
            got = got.astype(np.int16).reshape(-1).view(np.int32)
        for k, v in cell_mod.compare(got, want, wire).items():
            worst[k] = max(worst.get(k, 0.0), v)
    limits = cfg["limits"]
    return {"seed": seed, "tfs": len(tfs), "readings": worst,
            "limits": {k: limits[k] for k in worst},
            "correct": all(worst[k] <= limits[k] for k in worst)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args(argv)
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        spec = json.load(f)
    workload = {w["name"]: w for w in spec["workloads"]}[a.workload]
    seconds = a.seconds or spec["run_seconds"]
    device = "cpu" if a.cpu else "cuda"
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(control_readings(workload, seed, seconds, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
