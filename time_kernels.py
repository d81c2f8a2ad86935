#!/usr/bin/env python3
"""Time the kernels of one checkout on one CUDA card: K1 (ofdm_backend,
csrc/ofdm_ifft.cu), K2 (ofdm_cfr_backend, csrc/ofdm_cfr.cu), K4 (kiss_ifft,
csrc/kiss_ifft.cu, wire words and planes, beside its plain version) and K3
(resample, csrc/resample_poly.cu) at 8.192 and 3.072 MS/s, through
chip_smoke.py's phase-5 helpers: phase 2's TM I input (24 TFs) and K2
clip, K3 on a stream of 24 TFs from its own seed, the same input sets
cycled past the L2, the same calls, and the card spinning while the host
issues 20 back-to-back calls.  Besides the package imported, only K3's
input differs from phase 5 (its draw, not its shape).

    python3 time_kernels.py [--tree DIR] [--label NAME]

DIR (default: this script's directory) is the checkout whose
dabmod_tpu_torch is imported, built and timed; the harness is always this
script's chip_smoke.py.  To compare two checkouts, run it for each in one
call on one card, in turns (a, b, b, a).  Prints one JSON line: the label,
the card, and for each kernel its max abs error against its plain
version and its median device and host-issue ms per call.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    # the checkout's package; the harness of this script's chip_smoke.py
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a CUDA card")
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.ops import resampler_kernel as R
    from dabmod_tpu_torch.ops.filters import PolyphasePlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    # phase 2's TM I input: the first draw from its seed
    p = tables.mode_params(1)
    planes = cs.random_planes(torch, np.random.default_rng(cs.SEED),
                              (cs.BATCH_TF, p.nb_symbols + 1, p.nb_carriers))
    table = cs.mode_table(1, "cuda")
    sets = cs.ofdm_timing_sets(torch, planes)
    calls = cs.ofdm_calls(table, cs.k2_clip(torch, planes, table))
    cpm = cs.sleep_cycles_per_ms(torch)
    rec = {"label": args.label, "tree": os.path.abspath(args.tree),
           "card": card}
    for name, fns in calls.items():
        got, want = fns[""](planes), fns["plain_"](planes)
        if name == "ofdm_cfr":          # the samples; the stats aside
            got, want = got[0], want[0]
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        tol = 2e-5 * max(float(w.abs().max()) for w in want)
        cs.check(err <= tol, f"{name}: err {err} > {tol}")
        t = cs.kernel_times(torch, {"": (fns[""], sets)}, cpm)
        rec[name] = {"max_abs_err": err, **t}
    time_kiss(torch, cs, rec, planes, table, sets, cpm)
    rng = np.random.default_rng(cs.SEED + 5)
    n = cs.BATCH_TF * p.tf_samples
    for rate in cs.K3_TIMED_RATES:
        plan = PolyphasePlan.create(2_048_000, rate)
        table = R.make_table(plan, "cuda")
        x = cs.random_planes(torch, rng, (n,))
        carry = cs.random_planes(torch, rng, (2 * plan.half,))
        got, _ = R.resample(x, carry, table)
        want, _ = R.resample_plain(x, carry, table)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        tol = 1e-5 * max(float(w.abs().max()) for w in want)
        ok = all(bool(torch.allclose(g, w, rtol=1e-5, atol=tol))
                 for g, w in zip(got, want))
        cs.check(ok, f"resample_poly {rate}: err {err}, outside rtol 1e-5 "
                 f"/ atol {tol}")
        t = cs.kernel_times(
            torch, {"": cs.resample_calls(torch, x, carry, table)[""]}, cpm)
        rec[f"resample_poly_{rate}"] = {"max_abs_err": err, **t}
    print(json.dumps(rec), flush=True)


def time_kiss(torch, cs, rec, planes, table, sets, cpm):
    """K4 (kiss_ifft, csrc/kiss_ifft.cu) and its plain version on the same
    TM I input, the wire words and the planes, each bit for bit against
    the plain version; nothing where the checkout has no K4."""
    from dabmod_tpu_torch import tables
    try:
        from dabmod_tpu_torch.ops import kiss_kernel as K4
    except ImportError:
        return
    p = tables.mode_params(1)
    kt = K4.make_table(table, p.null_size, p.sym_size)
    for wire in (True, False):
        name = "kiss_ifft_" + ("wire" if wire else "planes")
        got = K4.kiss_ifft(planes, kt, wire)
        want = K4.kiss_ifft_plain(planes, kt, wire)
        torch.cuda.synchronize()
        g, w = (got, want) if wire else (got[0], want[0])
        cs.check(torch.equal(g, w) and (wire or torch.equal(got[1], want[1])),
                 f"{name}: differs from the plain version")
        rec[name] = {"bit_exact": True, **cs.kernel_times(torch, {
            "": (lambda x, w=wire: K4.kiss_ifft(x, kt, w), sets)}, cpm),
            "plain_ms": plain_ms(torch, lambda w=wire: K4.kiss_ifft_plain(
                planes, kt, w))}


def plain_ms(torch, fn, n=5) -> float:
    """Device ms a call of a plain version that issues its int32 ops one
    by one (some 1,400 launches a call: no spin outlasts their issue), from
    CUDA events around n calls after one warm call: paced by the host."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


if __name__ == "__main__":
    main()
