#!/usr/bin/env python3
"""Time the port's kernels on one CUDA card, each beside its plain PyTorch
version, at the main path's shapes (TM I, 24 TFs a call):

* K1 (ofdm_backend, csrc/ofdm_ifft.cu) and K2 (ofdm_cfr_backend,
  csrc/ofdm_cfr.cu, clip 1.2 x the mean magnitude before CFR, error clip
  0.5) on random carrier planes [24, 77, 1536];
* K3 (resample, csrc/resample_poly.cu) at 8.192 and 3.072 MS/s on a
  random stream of 24 TFs;
* K4 (kiss_ifft, csrc/kiss_ifft.cu) writing the s16 words and writing the
  int32 planes, on K1's planes;
* K5 (frontend, csrc/frontend.cu) on batches of 24 TFs of the
  17-sub-channel ensemble (eti.REALISTIC_MUX_SPECS).

    python3 time_kernels.py [--tree DIR] [--label NAME]

For each kernel: its largest difference from its plain version (K4 and
K5 must equal it bit for bit), its device ms a call with the input sets
cycled past the 50 MB L2 ("ms") and with one set reused
("ms_warm_l2"), the host's ms to issue a call, its plain version's ms
a call timed the same way, and its bound: the least time the card could
take at its published peaks, each input, output and table byte moved
once at 3.35 TB/s or the operations at 67 TFLOP/s (fp32) or K4's int32
multiplies at 132 SMs x 64 a clock x 1.98 GHz, whichever is longer.
Device times are CUDA events around runs of 20 back-to-back calls, with
the card held in a spin (torch.cuda._sleep) while the host issues them,
so that they see the calls run back to back; a call that synchronises
with the host (the plain CFR) cannot run behind a spin and is timed
paced by the host ("host_paced").  The median of 25 runs.  The plain
versions of K4 and K5 issue hundreds of torch ops a call, more than the
card's launch queue holds behind a spin: they are timed without one, the
mean of 5 calls, paced by the host.

DIR (default: this script's directory) is the checkout whose
dabmod_tpu_torch is imported, built and timed.  To compare two
checkouts, run it for each in one call on one card, in turns (a, b, b,
a).  Prints a line a kernel, then one JSON line: the label, the tree,
the card (nvidia-smi's name and power limit) and each kernel's record.
Exits 1 where a kernel differs from its plain version beyond its
tolerance.
"""
import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH_TF = 24
N_TIMED = 25
N_WARM = 3
KERNEL_REPS = 20      # back-to-back calls a timed run
MAX_SPIN_MS = 10_000.0
L2_SETS = 4           # TM I carrier sets cycled: 4 x 22.7 MB > the 50 MB L2
RES_L2_SETS = 3       # resampler input sets: 3 x 37.7 MB > the 50 MB L2
FRONTEND_SETS = 3     # K5's ETI batches cycled (its 22.7 MB of planes out)
K2_ERROR_CLIP = 0.5   # tests/test_ofdm_kernel.py:44
K3_RATES = (8_192_000, 3_072_000)    # the resampled cells' and paths' rates
# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# 32-bit integer multiplies: 132 SMs x 64 a clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 1.98
# GHz
INT32_MUL_PER_S = 132 * 64 * 1.98e9


def sleep_cycles_per_ms(torch) -> float:
    """The card's clock as torch.cuda._sleep counts it (cycles per ms),
    after a spin that lets the clock rise from idle."""
    torch.cuda._sleep(50_000_000)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(50_000_000)
    e1.record()
    e1.synchronize()
    return 50_000_000 / e0.elapsed_time(e1)


def device_runs(torch, fn, reps, cycles_per_ms, n=N_TIMED, warm=N_WARM):
    """n runs of `reps` back-to-back calls of fn(), each timed on the card
    between CUDA events, with the card held in a spin kernel
    (torch.cuda._sleep) while the host issues the calls: the events then
    see the calls run back to back, whatever the host's time to issue them
    (a wrapper's Python and ctypes take tens of us a call, longer than a
    kernel of this size).  A run whose spin ended before the host issued
    its last call (the event recorded after the spin has completed) is
    redone with a spin twice as long.  A call that waits for the card
    itself (a host synchronisation inside fn) cannot run behind a spin:
    its runs are timed without one, paced by the host.  Returns (device ms
    per call, host ms per call) for each run, and whether the host paced
    them."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spin_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 0.1
    torch.cuda.synchronize()
    mark = torch.cuda.Event()
    torch.cuda._sleep(int(spin_ms * cycles_per_ms))
    mark.record()
    fn()
    host_paced = mark.query()
    torch.cuda.synchronize()
    dev, host = [], []
    while len(dev) < n:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if not host_paced:
            torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        spun_out = not host_paced and e0.query()
        e1.record()
        e1.synchronize()
        if spun_out:
            spin_ms *= 2
            if spin_ms > MAX_SPIN_MS:
                raise RuntimeError(
                    "the host cannot issue the calls behind a spin (their "
                    "launches fill the card's queue): time them paced by "
                    "the host")
            continue
        dev.append(e0.elapsed_time(e1) / reps)
        host.append(issue_ms / reps)
    return dev, host, host_paced


def kernel_times(torch, fns, cycles_per_ms) -> dict:
    """For each key of fns ("" for the kernel, "plain_" for its plain
    version) and its (fn, input sets): the median device ms a call
    cycling through the sets (`<key>ms`) and reusing the first
    (`<key>ms_warm_l2`), the host's median ms to issue one call
    (`<key>host_issue_ms`), and whether the host paced the runs
    (`<key>host_paced`: the call synchronises)."""
    times = {}
    for key, (fn, inputs) in fns.items():
        it = itertools.cycle(inputs)
        dev, host, paced = device_runs(torch, lambda: fn(next(it)),
                                       KERNEL_REPS, cycles_per_ms)
        times[key + "ms"] = statistics.median(dev)
        times[key + "host_issue_ms"] = statistics.median(host)
        times[key + "host_paced"] = paced
        times[key + "ms_warm_l2"] = statistics.median(device_runs(
            torch, lambda fn=fn, x=inputs[0]: fn(x), KERNEL_REPS,
            cycles_per_ms)[0])
    return times


def nbytes(*trees) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(x.numel() * x.element_size() for t in trees
               for x in tree_leaves(t))


def bound(nbytes_moved: float, ops: float, ops_per_s: float,
          ops_name: str) -> dict:
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else ops_name,
            "bytes": nbytes_moved, ops_name: ops}


def random_planes(torch, rng, shape):
    return tuple(torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32), device="cuda")
        for _ in range(2))


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def host_paced_ms(torch, fn, n=5) -> float:
    """Device ms a call of fn, from CUDA events around n calls after one
    warm call, with no spin: paced by the host."""
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


def record(torch, cpm, kernel, plain, sets, err, tol, bnd, op_chain=False,
           **extra):
    """A kernel's record: its and its plain version's times on `sets` (the
    plain version paced by the host where it is an op chain), its
    difference from the plain version against `tol`, its bound."""
    fns = {"": (kernel, sets)}
    if not op_chain:
        fns["plain_"] = (plain, sets)
    t = kernel_times(torch, fns, cpm)
    if op_chain:
        t.update(plain_ms=host_paced_ms(torch, lambda: plain(sets[0])),
                 plain_host_paced=True)
    return {"max_abs_err": err, "tol": tol, "ok": err <= tol, **t, **bnd,
            **extra}


def time_ofdm(torch, cpm, planes, sets):
    """K1 and K2 on TM I's carriers; K2 at 1.2 x the mean magnitude."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.ops import ofdm_kernel as K
    src, valid = tables.bin_map(1)
    table = K.make_table(tables.freq_interleave_inverse(1)[src], valid,
                         "cuda")
    B, S, C = planes[0].shape
    n, log2n = table.n, table.log2n
    tables_b = nbytes((table.gather, table.twiddle))
    want = K.ofdm_backend_plain(planes, table)
    got = K.ofdm_backend(planes, table)
    tol = 2e-5 * max(float(w.abs().max()) for w in want)
    recs = {"ofdm_backend": record(
        torch, cpm, lambda x: K.ofdm_backend(x, table),
        lambda x: K.ofdm_backend_plain(x, table), sets,
        max_err(got, want), tol,
        bound(nbytes(planes, got) + tables_b, 5 * n * log2n * B * S,
              FP32_FLOP_PER_S, "flops"))}
    clip = 1.2 * float(torch.sqrt(want[0] ** 2 + want[1] ** 2).mean())
    want, ref_st = K.ofdm_cfr_backend_plain(planes, table, clip,
                                            K2_ERROR_CLIP)
    got, st = K.ofdm_cfr_backend(planes, table, clip, K2_ERROR_CLIP)
    tol = 2e-5 * max(float(w.abs().max()) for w in want)
    margin = K.cfr_threshold_margin(planes, table, clip, K2_ERROR_CLIP)
    counts_ok = all(bool(((st[..., lane] - ref_st[..., lane]).abs()
                          <= margin[..., k]).all())
                    for lane, k in ((K.ST_NCLIP, 0), (K.ST_NERRCLIP, 1)))
    # three transforms of 5 N log2 N flop, 27 flop a sample for the clip,
    # the error update and the sums, a division and a square root for
    # each clipped sample and bin of this input
    n_clip = float(st[..., K.ST_NCLIP].sum() + st[..., K.ST_NERRCLIP].sum())
    rec = record(
        torch, cpm, lambda x: K.ofdm_cfr_backend(x, table, clip,
                                                 K2_ERROR_CLIP),
        lambda x: K.ofdm_cfr_backend_plain(x, table, clip, K2_ERROR_CLIP),
        sets, max_err(got, want), tol,
        bound(nbytes(planes, got, st) + tables_b,
              B * S * (15 * n * log2n + 27 * n) + 2 * n_clip,
              FP32_FLOP_PER_S, "flops"),
        clip=clip, error_clip=K2_ERROR_CLIP, clip_counts_ok=counts_ok)
    rec["ok"] = rec["ok"] and counts_ok
    recs["ofdm_cfr_backend"] = rec
    return table, recs


def kiss_multiplies(n: int) -> int:
    """The int32 multiplies of one KISS fixed-point transform of size n:
    2 a C_FIXDIV and 4 a C_MUL, so 4 a point at a radix-2 stage and 5 a
    point at a radix-4 one (adds, shifts and wraps left out)."""
    from dabmod_tpu_torch.ops import kiss_fixed
    return sum({2: 4, 4: 5}[p] * n for p, _ in kiss_fixed.kf_factor(n))


def time_kiss(torch, cpm, table, planes, sets):
    """K4 on K1's carriers, writing the s16 words and the int32 planes."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.ops import kiss_kernel as K4
    p = tables.mode_params(1)
    kt = K4.make_table(table, p.null_size, p.sym_size)
    B, S, _ = planes[0].shape
    recs = {}
    for wire in (True, False):
        got = K4.kiss_ifft(planes, kt, wire)
        want = K4.kiss_ifft_plain(planes, kt, wire)
        same = all(torch.equal(g, w) for g, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
        recs["kiss_ifft_" + ("words" if wire else "planes")] = record(
            torch, cpm, lambda x, w=wire: K4.kiss_ifft(x, kt, w),
            lambda x, w=wire: K4.kiss_ifft_plain(x, kt, w), sets,
            0.0 if same else float("inf"), 0.0,
            bound(nbytes(planes, got, (kt.gather, kt.twiddle)),
                  B * S * kiss_multiplies(kt.n), INT32_MUL_PER_S,
                  "int32_multiplies"), op_chain=True)
    return recs


def time_resample(torch, cpm, rate):
    """K3 at `rate` on a random stream of 24 TFs and a random carry."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.ops import resampler_kernel as R
    from dabmod_tpu_torch.ops.filters import PolyphasePlan
    plan = PolyphasePlan.create(2_048_000, rate)
    table = R.make_table(plan, "cuda")
    n = BATCH_TF * tables.mode_params(1).tf_samples
    rng = np.random.default_rng(SEED + 5)
    sets = [random_planes(torch, rng, (n,)) for _ in range(RES_L2_SETS)]
    carry = random_planes(torch, rng, (2 * plan.half,))
    got = R.resample(sets[0], carry, table)
    want = R.resample_plain(sets[0], carry, table)
    err = max_err(got[0], want[0])
    scale = max(float(w.abs().max()) for w in want[0])
    close = all(bool(torch.allclose(g, w, rtol=1e-5, atol=1e-5 * scale))
                for g, w in zip(got[0], want[0]))
    same_carry = all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
    # 2 flop a non-zero tap of the band for every output of both planes
    nnz = int(torch.count_nonzero(table.taps))
    rec = record(
        torch, cpm, lambda x: R.resample(x, carry, table),
        lambda x: R.resample_plain(x, carry, table), sets,
        err, 1e-5 * scale,
        bound(nbytes(sets[0], carry, got, (table.taps, table.row0)),
              2 * 2 * (n // plan.M) * nnz, FP32_FLOP_PER_S, "flops"),
        L=plan.L, M=plan.M, instance=list(R.INSTANCES[table.layout.instance]))
    # within rtol 1e-5 and atol 1e-5*max|ref|: fp32 sums of the band in
    # other orders; the carry to the bit
    rec["ok"] = close and same_carry
    return rec


def time_frontend(torch, cpm):
    """K5 on FRONTEND_SETS batches of 24 TFs of the 17-sub-channel
    ensemble from the initial state; its plain version is the op chain."""
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.eti import (REALISTIC_MUX_SPECS, parse_eti_frames,
                                      synth_eti_batch)
    from torch.utils._pytree import tree_leaves
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    from dabmod_tpu_torch.ops import frontend_kernel as K5
    m = Modulator(make_default_layout(1, REALISTIC_MUX_SPECS),
                  ModSettings(dab_mode=1), device="cuda")
    table, hist = m._frontend, m.init_state()["ti_history"]
    tf0 = torch.zeros((), dtype=torch.int32, device="cuda")
    frames = BATCH_TF * m.p.cif_count
    raw = synth_eti_batch(FRONTEND_SETS * frames, mode=1,
                          subch_specs=REALISTIC_MUX_SPECS, seed=SEED + 1)
    sets = []
    for i in range(FRONTEND_SETS):
        b = parse_eti_frames(raw[frames * i:frames * (i + 1)])
        sets.append((torch.as_tensor(b.fic, device="cuda"),
                     tuple(torch.as_tensor(x, device="cuda")
                           for x in b.subchannels)))

    def kernel(x):
        return K5.frontend(*x, hist, tf0, table)

    def plain(x):
        return K5.frontend_plain(*x, hist, tf0, table)
    got, want = kernel(sets[0]), plain(sets[0])
    same = all(torch.equal(g, w) for g, w in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    tables_b = nbytes((table.prbs, table.keep, table.cif_src,
                       table.cif_filler, table.ref_q))
    return record(torch, cpm, kernel, plain, sets,
                  0.0 if same else float("inf"), 0.0,
                  bound(nbytes(sets[0], hist, got) + tables_b, 0.0,
                        FP32_FLOP_PER_S, "flops"), op_chain=True,
                  subchannels=len(hist),
                  shape=list(got[0][0].shape))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels.py: torch.cuda.is_available() is "
                         "False: this needs a CUDA card")
    from dabmod_tpu_torch import tables
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    p = tables.mode_params(1)
    rng = np.random.default_rng(SEED)
    sets = [random_planes(torch, rng, (BATCH_TF, p.nb_symbols + 1,
                                       p.nb_carriers))
            for _ in range(L2_SETS)]
    cpm = sleep_cycles_per_ms(torch)
    table, kernels = time_ofdm(torch, cpm, sets[0], sets)
    for rate in K3_RATES:
        kernels[f"resample_{rate}"] = time_resample(torch, cpm, rate)
    kernels.update(time_kiss(torch, cpm, table, sets[0], sets))
    kernels["frontend"] = time_frontend(torch, cpm)
    for name, k in kernels.items():
        print(f"{name:24s} err {k['max_abs_err']:.3e} (tol {k['tol']:.3e})"
              f"  {k['ms']:.5f} ms, one set {k['ms_warm_l2']:.5f}, issue "
              f"{k['host_issue_ms']:.5f}; plain {k['plain_ms']:.5f} ms"
              f"{' (host-paced)' if k['plain_host_paced'] else ''}; bound "
              f"{k['bound_ms']:.5f} ms by {k['bound_by']}", flush=True)
    print(json.dumps({"label": args.label, "tree": os.path.abspath(args.tree),
                      "card": card, "kernels": kernels}), flush=True)
    bad = [name for name, k in kernels.items() if not k["ok"]]
    if bad:
        print(f"time_kernels.py: differ from their plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
