#!/usr/bin/env python3
"""Smoke run of dabmod_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Card and build: prints the card's name and power limit (nvidia-smi) and
   builds every CUDA kernel of the port from dabmod_tpu_torch/ops/csrc/
   (one nvcc per source, all started together), with each kernel's
   registers, shared memory and spills as ptxas reports them, and for each
   instance of K1 and K2 its launch shape as the source reports it on the
   card (threads and symbols a block, resident blocks an SM from the CUDA
   runtime's occupancy calculator), and for each instance of K3 the same
   at a plan that takes it (its compile-time M or 0, KP and R as the
   source builds them); fails if an instance of K1, K2 or K3 spills or
   launches another block layout than ofdm_kernel or resampler_kernel
   assumes.
2. Each kernel against its plain PyTorch version on the card, on inputs
   made from a numpy seed:
   * K1, the OFDM IFFT, at all four spacings (TM I-IV), with each mode's
     own composed carrier->bin table, on random carrier planes, and again
     on one symbol and on 13 (a ragged last block below N = 2048);
   * K2, the OFDM IFFT + CFR, the same way, with clip = 1.2 x the mean
     magnitude before CFR and error clip 0.5 (tests/test_ofdm_kernel.py:
     43-44); its clip counts may differ from the plain version's by the
     samples within 1e-5 (relative) of a threshold, which it prints; and
     on one symbol and on 13;
   * K3, the polyphase resampler, at 3.072, 4.096 and 8.192 MS/s and
     (resampler_mode="poly") 1.024 and 1.792 MS/s, so L/M = 3/2, 2, 4, 1/2
     and 7/8 (the last through the kernel's run-time-M instance), on a
     stream of the main path's length (24 TFs), and two half-stream calls
     with the carry against one call.
3. The front end against the reference goldens in tests/golden/
   (e2e_symbols: 2 TFs, 2 sub-channels; e2e_real_symbols: 4 TFs, the
   17-sub-channel ensemble).
4. Four paths at full width, TM I, batch_tf=24 (24 x 196,608 samples a
   step in), two consecutive batches carrying the state, against the port
   run on the CPU on the same ETI:
   * "main": the 17-sub-channel / 855-CU ensemble and the 2-sub-channel
     bench ensemble at 2.048 MS/s (K1), f32 planes and s16 wire words;
   * "realistic17_cfr_8m192": the 17-sub-channel ensemble with CFR
     (clip 40.0, error clip 3.0, doc/example.ini:56-59) and output at
     8.192 MS/s through the polyphase resampler (K2, K3), f32 and s16, its
     statistics (clip counts, PAPR, MER) and state (mer_index, res_carry)
     included.  At these settings the error clip never acts;
   * "realistic17_cfr30_3m072": the same ensemble with CFR at clip 30.0,
     error clip 0.1 (tests/test_quality.py:151-154), where the error clip
     acts on every TF, and output at 3.072 MS/s (L/M = 3/2) (K2, K3), f32
     and s16;
   * "realistic17_dpd_8m192": the chain that feeds DPD: the same ensemble
     with TII in the NULL symbol (comb 5, pattern 31), CFR 40/3, the
     windowed guard interval (overlap 90), the default FIR, 8.192 MS/s
     (K2, K3) and the poly DPD (tests/test_filters.py:133-134's
     coefficients, written as a format-1 file in a temporary directory),
     f32 planes at the UHD scale (1/50000), within 1e-4*max|ref| of the
     CPU after the DPD.
   Each path's kernel launch counts are set to 0 just before its card run
   and read just after; a kernel's launches are summed over its paths.
5. Times on the card (CUDA events, warm-up, median of 25 runs): each path's
   step time (with its quartiles), the host's time to issue a step in the
   same runs, samples/s at the output rate and a torch.profiler breakdown
   in each of its formats; each kernel (20 back-to-back calls a run, cycling
   through input sets larger than L2 together, and again on one input
   set; the card spins in torch.cuda._sleep while the host issues the
   calls, so the events see device time only, and the host's issue time
   is kept beside it; a call that synchronises, such as the plain CFR, is
   timed without the spin and marked host_paced), its plain version, one
   PyTorch library call as a yardstick where one computes the same
   function, and the kernel's bound from this run's shapes; K3 at both
   of the paths' rates, 8.192 and 3.072 MS/s; and the eager stages the
   DPD path adds (windowed guard interval, FIR, poly and LUT DPD), each
   alone at that path's shapes, beside its bytes bound.
6. Variant runs, each on the card against the CPU at 2 TFs a batch, two
   batches carrying the state, the 17-sub-channel ensemble, each printing
   what it checked: the LUT DPD (tests/test_filters.py:151-153's LUT,
   scale 2**31), u8 and s8 file output, the CIC equalizer (32.768 MHz),
   the frequency-domain resampler at 1.536 MS/s ("auto") and 4.096 MS/s
   ("fft"), the plain polyphase form at 2.5 MS/s (K3 launched no time),
   TII's old variant in TM II, the windowed guard interval in TM II-IV,
   modulate_traced's stage dumps of the DPD chain, and a hot swap of FIR
   taps and poly coefficients between two batches against a modulator
   built with the new ones.  K1's launches in these runs are counted.
7. The fixed-point engines and the port as a program:
   * fft_engine=kiss at overlap 0 and 90 on the golden payloads, card ==
     CPU == the reference's goldens e2e_iq_fixed / e2e_iq_fixed_ov90, bit
     for bit; TM II-IV at 2 TFs, card == CPU bit for bit;
   * fft_engine=dexter in TM I and TM III at overlap 0 and 12: the card's
     Q1.14 symbols and the host chain's wire words == the CPU's;
   * the runtime in-process on the card (ModRuntime, the 17-sub-channel
     ensemble, batch_tf=24, an ETI file of 4 batches, the file sink), for
     three INI files read with parse_ini: (a) s16 at 2.048 MS/s (K1),
     (b) CFR 40/3 at 8.192 MS/s, complexf (K2, K3), (c) kiss, s16; the
     kernel launches counted between a reset and a read around each run;
     the first 2 batches of each file against the same INI run by the
     runtime on the CPU (s16 within 1 LSB, f32 within 3e-5*max|ref|, kiss
     byte for byte); a second, warm run timed: ETI frames/s, x real time
     (an ETI frame is 24 ms), each pipeline stage's share of the wall,
     beside the step of Modulator.modulate alone from phase 5 (which also
     times the kiss path);
   * `python -m dabmod_tpu_torch.cli <ini>` as a subprocess on the card
     (INI a, 2 batches): exit 0 and the in-process run's bytes.

TF32 is switched off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False): every tolerance below assumes fp32
arithmetic.  The line before the last is one JSON object with the kernels'
numbers (and the eager stages' times and the runtime's records), labelled
with the card's name and power limit; the last is
{"ok": true, "device": {...}}.
"""
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
SEED = 0
BATCH_TF = 24
BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))   # bench.py's ensemble
N_TIMED = 25
N_WARM = 3
KERNEL_REPS = 20      # back-to-back kernel calls per timed run
L2_SETS = 4           # TM I input sets cycled: 4 x 22.7 MB > the 50 MB L2
RES_L2_SETS = 3       # resampler input sets: 3 x 37.7 MB > the 50 MB L2
MARGIN_REL = 1e-5     # CFR threshold band (ofdm_kernel.cfr_threshold_margin)
K2_ERROR_CLIP = 0.5   # phase 2's error clip (tests/test_ofdm_kernel.py:44)
# the CFR + resampler path: doc/example.ini:56-59, the DPD feedback rate
CFR_8M192 = dict(enable_cfr=True, cfr_clip=40.0, cfr_error_clip=3.0,
                 output_rate=8_192_000)
# CFR where the error clip acts (tests/test_quality.py:151-154), L/M = 3/2
CFR30_3M072 = dict(enable_cfr=True, cfr_clip=30.0, cfr_error_clip=0.1,
                   output_rate=3_072_000)
# K3's rates in phase 2: L/M = 3/2, 1/2 (decimation), 2, 4, and 7/8 (an
# M the kernel takes at run time)
RES_RATES = ((3_072_000, "auto"), (1_024_000, "poly"), (4_096_000, "auto"),
             (8_192_000, "auto"), (1_792_000, "poly"))
# a plan for each instance of K3 (resampler_kernel.INSTANCES), in order
K3_INSTANCE_RATES = (8_192_000, 3_072_000, 1_024_000, 1_792_000, 1_536_000,
                     512_000)
# the rates phase 5 times K3 at: those of the resampled paths
K3_TIMED_RATES = (8_192_000, 3_072_000)
# the chain that feeds DPD: TII (the goldens' comb and pattern), CFR 40/3,
# the guard_ov90 golden's window, the default FIR, 8.192 MS/s; the poly
# DPD's file is added by dpd_files()
DPD_8M192 = dict(CFR_8M192, tii_enable=True, tii_comb=5, tii_pattern=31,
                 ofdm_window_overlap=90, filter_taps_file="default")
POLY_AM = (1.0, 0.1, -0.05, 0.02, -0.01)    # tests/test_filters.py:133-134
POLY_PM = (0.02, -0.01, 0.005, 0.0, 0.0)
LUT_SCALE = 2.0 ** 31                       # tests/test_filters.py:151-153
DPD_REL = 1e-4        # f32 tolerance after the poly DPD, of max|ref|
VARIANT_TF = 2        # TFs a batch in phase 6

# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# goldens, read directly (dtype codes of tests/golden/manifest.txt)
# ---------------------------------------------------------------------------

_DTYPES = {"u8": np.uint8, "c8": np.complex64, "f4": np.float32,
           "i16": np.int16}


def load_golden(name: str) -> np.ndarray:
    with open(os.path.join(GOLDEN_DIR, "manifest.txt")) as f:
        manifest = {ln.split()[0]: ln.split()[1:] for ln in f if ln.strip()}
    dtype, n = manifest[name]
    data = np.fromfile(os.path.join(GOLDEN_DIR, name + ".bin"),
                       dtype=_DTYPES[dtype])
    check(data.size == int(n), f"golden {name}: {data.size} != {n}")
    return data


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_runs(torch, fn, n=N_TIMED, warm=N_WARM):
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


def cycled(fn, inputs):
    """A call of fn on the next of `inputs` in turn: with inputs larger
    than the card's L2 together, each call reads its input from device
    memory, as the kernel's bound assumes."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))


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
            continue
        dev.append(e0.elapsed_time(e1) / reps)
        host.append(issue_ms / reps)
    return dev, host, host_paced


def kernel_times(torch, fns, cycles_per_ms) -> dict:
    """For each key of fns ("", "plain_", "library_") and its (fn, input
    sets): the median device ms per call cycling through the sets
    (`<key>ms`) and reusing the first (`<key>ms_warm_l2`), the host's
    median ms to issue one call (`<key>host_issue_ms`), and whether the
    host paced the runs (`<key>host_paced`: the call synchronises)."""
    times = {}
    for key, (fn, inputs) in fns.items():
        dev, host, paced = device_runs(torch, cycled(fn, inputs),
                                       KERNEL_REPS, cycles_per_ms)
        times[key + "ms"] = statistics.median(dev)
        times[key + "host_issue_ms"] = statistics.median(host)
        times[key + "host_paced"] = paced
        times[key + "ms_warm_l2"] = statistics.median(device_runs(
            torch, lambda fn=fn, x=inputs[0]: fn(x), KERNEL_REPS,
            cycles_per_ms)[0])
    return times


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card_and_build(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from dabmod_tpu_torch.ops import build
    from dabmod_tpu_torch.ops import ofdm_kernel as K
    t0 = time.perf_counter()
    paths = build.build(*build.SOURCES)
    log(f"[1] built {', '.join(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    ptxas = {}
    for name, path in zip(build.SOURCES, paths):
        with open(path + ".log") as f:
            ptxas[name] = parse_ptxas(f.read())
        if name in ("ofdm_ifft", "ofdm_cfr"):
            for inst, rec in ptxas[name].items():
                check(rec["spill_stores"] == 0,
                      f"{name} {inst}: {rec['spill_stores']} bytes of "
                      f"spill stores")
                n = 1 << int(inst)
                rec.update(K.launch_shape(n, cfr=name == "ofdm_cfr"))
                check(rec["threads_per_block"] == K.THREADS_PER_BLOCK
                      and rec["symbols_per_block"] == K.symbols_per_block(n),
                      f"{name} N={n}: the source launches "
                      f"{rec['threads_per_block']} threads and "
                      f"{rec['symbols_per_block']} symbols a block, "
                      f"ofdm_kernel assumes {K.THREADS_PER_BLOCK} and "
                      f"{K.symbols_per_block(n)}")
        if name == "resample_poly":
            check_resampler_instances(ptxas[name])
        log(f"    {name}: {json.dumps(ptxas[name])}")
    return card, ptxas


def check_resampler_instances(ptxas):
    """Each K3 instance: no spills, and at a plan that takes it, the
    instance, threads and shared memory that resampler_kernel assumes,
    with at least one block resident an SM."""
    from dabmod_tpu_torch.ops import resampler_kernel as R
    from dabmod_tpu_torch.ops.filters import PolyphasePlan
    check(len(K3_INSTANCE_RATES) == len(R.INSTANCES),
          "a K3 instance has no plan in K3_INSTANCE_RATES")
    for i, (inst, rate) in enumerate(zip(R.INSTANCES, K3_INSTANCE_RATES)):
        key = "_".join(map(str, inst))
        check(key in ptxas, f"resample_poly: ptxas reports no instance "
              f"{key}")
        rec = ptxas[key]
        check(rec["spill_stores"] == 0, f"resample_poly {key}: "
              f"{rec['spill_stores']} bytes of spill stores")
        table = R.make_table(PolyphasePlan.create(2_048_000, rate), "cuda")
        check(table.layout.instance == i, f"{rate} takes K3 instance "
              f"{table.layout.instance}, not {i}")
        shape = R.launch_shape(table)
        check(shape["instance"] == list(inst)
              and shape["threads_per_block"] == R.THREADS
              and shape["resident_blocks_per_sm"] >= 1,
              f"resample_poly {key}: the source reports {shape}, "
              f"resampler_kernel assumes {inst} and {R.THREADS} threads")
        rec.update(shape, plan_rate=rate, q_per_chunk=table.layout
                   .q_per_chunk, groups=table.layout.groups,
                   tiles=table.layout.tiles)


def parse_ptxas(text: str) -> dict:
    """Registers, shared memory and spill stores of each kernel in nvcc's
    -Xptxas -v output, keyed by the kernel's integer template arguments
    joined by "_" (log2 N for the OFDM kernels, "M_KP_R" for K3's
    instances) or "" for a kernel that is not a template."""
    out, key = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            tmpl = re.search(r"I((?:Li\d+E)+)E", m.group(1))
            key = ("_".join(re.findall(r"Li(\d+)E", tmpl.group(1)))
                   if tmpl else "")
            out.setdefault(key, {"registers": 0, "smem_bytes": 0,
                                 "spill_stores": 0})
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            out[key]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[key]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            out[key]["smem_bytes"] = int(m.group(1))
    return out


def mode_table(mode, device):
    """The modulator's composed carrier->bin table for one mode: the bin
    map composed with the deferred frequency-interleave permutation."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.ops import ofdm_kernel
    src, valid = tables.bin_map(mode)
    src_pre = tables.freq_interleave_inverse(mode)[src]
    return ofdm_kernel.make_table(src_pre, valid, device)


def random_planes(torch, rng, shape):
    return tuple(torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32), device="cuda")
        for _ in range(2))


def phase_kernels(torch):
    """K1 and K2 against their plain versions at all four spacings, K3 at
    RES_RATES; returns, for phase 5, TM I's main-path-shaped input with
    its table and K2 clip ("ofdm"), each kernel's max abs error there (and
    K2's statistics) and K3's 8.192 MS/s input."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.ops import ofdm_kernel
    rng = np.random.default_rng(SEED)
    out = {}
    for mode in (1, 2, 3, 4):
        p = tables.mode_params(mode)
        batch = BATCH_TF if mode == 1 else 4
        shape = (batch, p.nb_symbols + 1, p.nb_carriers)
        planes = random_planes(torch, rng, shape)
        table = mode_table(mode, "cuda")
        got = ofdm_kernel.ofdm_backend(planes, table)
        torch.cuda.synchronize()
        ref = ofdm_kernel.ofdm_backend_plain(planes, table)
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        # tolerance of tests/test_ofdm_kernel.py:31-32: fp32 transforms
        # summed in different orders
        tol = 2e-5 * scale
        log(f"[2] ofdm_ifft TM {mode} N={p.spacing} {shape}: max abs err "
            f"{err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"ofdm_ifft TM {mode}: err {err} > {tol}")

        # K2 on the same carriers
        clip = k2_clip(torch, planes, table)
        out_cfr = check_cfr_kernel(torch, f"TM {mode} N={p.spacing} {shape}",
                                   planes, table, clip, K2_ERROR_CLIP)
        if mode == 1:
            out.update(ofdm=(planes, table, clip), ofdm_ifft=err,
                       ofdm_cfr=out_cfr)

        # one symbol, and 13: not a multiple of the symbols a block
        # carries below N = 2048, so the last block is ragged
        for n_sym in (1, 13):
            small = random_planes(torch, rng, (1, n_sym, p.nb_carriers))
            got = ofdm_kernel.ofdm_backend(small, table)
            torch.cuda.synchronize()
            ref = ofdm_kernel.ofdm_backend_plain(small, table)
            tol = 2e-5 * max(float(r.abs().max()) for r in ref)
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            log(f"[2] ofdm_ifft TM {mode} N={p.spacing} {n_sym} symbol(s), "
                f"{ofdm_kernel.symbols_per_block(p.spacing)} a block: max "
                f"abs err {err:.3e} (tol {tol:.3e})")
            check(err <= tol, f"ofdm_ifft TM {mode} x{n_sym}: err {err}")
            check_cfr_kernel(torch, f"TM {mode} N={p.spacing} {n_sym} "
                             f"symbol(s)", small, table, clip, K2_ERROR_CLIP)
    out["resample_poly"] = phase_resampler(torch, rng)
    return out


def k2_clip(torch, planes, table) -> float:
    """K2's clip in phase 2: 1.2 x the mean magnitude before CFR
    (tests/test_ofdm_kernel.py:43)."""
    from dabmod_tpu_torch.ops import ofdm_kernel
    td = ofdm_kernel.ofdm_backend_plain(planes, table)
    return 1.2 * float(torch.sqrt(td[0] ** 2 + td[1] ** 2).mean())


def check_cfr_kernel(torch, tag, planes, table, clip, error_clip):
    """K2 against its plain version: td within 2e-5*max|ref|, the clip
    counts per symbol within the threshold margin, the power and MER lanes
    rtol 1e-4, the pad lane 0.  Returns (max abs err, stats)."""
    from dabmod_tpu_torch.ops import ofdm_kernel as K
    (gr, gi), st = K.ofdm_cfr_backend(planes, table, clip, error_clip)
    torch.cuda.synchronize()
    (rr, ri), ref_st = K.ofdm_cfr_backend_plain(planes, table, clip,
                                                error_clip)
    scale = max(float(rr.abs().max()), float(ri.abs().max()))
    err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
    tol = 2e-5 * scale
    check(bool(torch.isfinite(gr).all() and torch.isfinite(st).all()),
          f"ofdm_cfr {tag}: not finite")
    margin = K.cfr_threshold_margin(planes, table, clip, error_clip,
                                    rel=MARGIN_REL)
    diffs = []
    for lane, k in ((K.ST_NCLIP, 0), (K.ST_NERRCLIP, 1)):
        d = (st[..., lane] - ref_st[..., lane]).abs()
        check(bool((d <= margin[..., k]).all()),
              f"ofdm_cfr {tag}: lane {lane} count differs beyond the "
              f"threshold margin")
        diffs.append((int(d.sum()), int(margin[..., k].sum()),
                      int(ref_st[..., lane].sum())))
    lane_err = 0.0
    for lane in range(K.ST_POW_BEFORE, K.ST_PAD):
        r = ref_st[..., lane]
        rel = float(((st[..., lane] - r).abs()
                     / r.abs().clamp(min=1e-30)).max())
        lane_err = max(lane_err, rel)
    check(lane_err <= 1e-4, f"ofdm_cfr {tag}: stats rtol {lane_err}")
    check(not bool(st[..., K.ST_PAD].any()), f"ofdm_cfr {tag}: pad lane")
    log(f"[2] ofdm_cfr {tag}: {K.symbols_per_block(table.n)} symbol(s) a "
        f"block; max abs err {err:.3e} (tol {tol:.3e}); clip counts |diff| {diffs[0][0]} (margin {diffs[0][1]}, of "
        f"{diffs[0][2]}), error-clip |diff| {diffs[1][0]} (margin "
        f"{diffs[1][1]}, of {diffs[1][2]}); stats lanes rtol {lane_err:.2e}")
    check(err <= tol, f"ofdm_cfr {tag}: err {err} > {tol}")
    return err, st


def phase_resampler(torch, rng):
    """K3 against its plain version on a stream of the main path's length
    (rtol 1e-5, atol 1e-5*max|ref|: fp32 sums of the band in other
    orders), and two half-stream calls against one, with the plan the
    modulator takes at each of RES_RATES.  Returns, for each of
    K3_TIMED_RATES, its input, carry, table and max abs error."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.models.modulator import resampler_route
    from dabmod_tpu_torch.ops import resampler_kernel as R
    n = BATCH_TF * tables.mode_params(1).tf_samples
    res = {}
    for rate, mode in RES_RATES:
        route, plan = resampler_route(ModSettings(output_rate=rate,
                                                  resampler_mode=mode), 2048)
        check(route == "kernel", f"{rate} ({mode}) takes the {route} route")
        table = R.make_table(plan, "cuda")
        x = random_planes(torch, rng, (n,))
        carry = random_planes(torch, rng, (2 * plan.half,))
        got, new_carry = R.resample(x, carry, table)
        torch.cuda.synchronize()
        ref, ref_carry = R.resample_plain(x, carry, table)
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        ok = all(bool(torch.allclose(g, r, rtol=1e-5, atol=1e-5 * scale))
                 for g, r in zip(got, ref))
        check(all(torch.equal(g, r) for g, r in zip(new_carry, ref_carry)),
              f"resample_poly {rate}: carry differs")
        h = n // 2
        a, mid = R.resample(tuple(v[:h] for v in x), carry, table)
        b, _ = R.resample(tuple(v[h:] for v in x), mid, table)
        split = all(torch.equal(torch.cat([u, v]), g)
                    for u, v, g in zip(a, b, got))
        log(f"[2] resample_poly {rate / 1e6:g} MS/s ({mode}) L={plan.L} "
            f"M={plan.M} K={table.n_taps}, instance "
            f"{R.INSTANCES[table.layout.instance]}, "
            f"{table.layout.q_per_chunk * plan.L} outputs a chunk, "
            f"{table.layout.smem_bytes} B of dynamic shared memory a block, "
            f"{n} -> {got[0].shape[0]} samples a plane: "
            f"max abs err {err:.3e} (rtol 1e-5, atol {1e-5 * scale:.3e}); "
            f"two half-stream calls equal one: {split}")
        check(ok, f"resample_poly {rate}: outside rtol 1e-5 / atol")
        check(split, f"resample_poly {rate}: split stream differs")
        if rate in K3_TIMED_RATES:
            res[rate] = (x, carry, table, err)
    return res


def phase_frontend(torch):
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    from dabmod_tpu_torch.ops.cplx import planes_to_complex

    def run(specs, prefix, n_frames, n_tf, sub_names=None):
        m = Modulator(make_default_layout(1, specs), ModSettings(dab_mode=1),
                      device="cuda")
        fic = load_golden(f"{prefix}fic_in").reshape(n_frames, 96)
        sizes = [stl * 8 for _, stl, _ in specs]
        if sub_names:
            subs = [load_golden(nm).reshape(n_frames, -1)
                    for nm in sub_names]
        else:
            frames = load_golden(f"{prefix}sub_in").reshape(n_frames, -1)
            offs = np.cumsum([0] + sizes)
            subs = [frames[:, offs[i]:offs[i + 1]]
                    for i in range(len(sizes))]
        expect = load_golden(f"{prefix}symbols").reshape(n_tf, 76, 1536)
        syms, _ = m.frontend(fic, tuple(subs), m.init_state()["ti_history"])
        got = planes_to_complex(syms)
        check(got.shape == expect.shape, f"{prefix}: shape {got.shape}")
        err = float(np.abs(got - expect).max())
        # the reference accumulates float32 rounding through its product
        # chain; the phase-domain result is exact (tests/test_pipeline.py)
        check(err <= 4e-6, f"{prefix}symbols: max err {err}")
        check(np.array_equal(np.angle(got).round(3),
                             np.angle(expect).round(3)),
              f"{prefix}symbols: phases differ")
        log(f"[3] front end vs {prefix}symbols ({n_tf} TFs, "
            f"{len(specs)} sub-channels): max err {err:.2e}, phases equal")

    run(BENCH_SPECS, "e2e_", 8, 2, ("e2e_sub0_in", "e2e_sub1_in"))
    run(REALISTIC_MUX_SPECS, "e2e_real_", 16, 4)


def _settings(fmt, **extra):
    """f32 planes ("f32"), f32 planes at the UHD scale ("uhd"), or a file
    sink's integer wire words ("s16", "u8", "s8"); TM I unless `extra`
    names a mode.  The batch is the number of ETI frames given to
    modulate."""
    from dabmod_tpu_torch.config import ModSettings
    extra = {"dab_mode": 1, **extra}
    if fmt == "f32":
        return ModSettings(device_interleave=False, **extra)
    if fmt == "uhd":
        return ModSettings(output="uhd", device_interleave=False,
                           **extra).normalise_for_output()
    return ModSettings(output="file", file_output_format=fmt,
                       **extra).normalise_for_output()


_TMP = []


def dpd_files() -> dict:
    """The poly DPD file (format 1) and the LUT file (format 2) of the runs
    here, written once into a temporary directory that main removes."""
    if not _TMP:
        _TMP.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        lut = (np.linspace(1.0, 0.9, 32) + 1j * np.linspace(0, 0.05, 32)
               ).astype(np.complex64)
        with open(os.path.join(_TMP[0], "poly.coef"), "w") as f:
            f.write("1\n5\n" + "".join(f"{v!r}\n"
                                        for v in (*POLY_AM, *POLY_PM)))
        with open(os.path.join(_TMP[0], "lut.coef"), "w") as f:
            f.write(f"2\n{LUT_SCALE!r}\n" + "".join(
                f"{float(v.real)!r}\n{float(v.imag)!r}\n" for v in lut))
    return {k: os.path.join(_TMP[0], f"{k}.coef") for k in ("poly", "lut")}


def _to_host(out):
    if isinstance(out, tuple):
        return tuple(x.cpu().numpy() for x in out)
    return out.cpu().numpy()


def _kernels():
    from dabmod_tpu_torch.ops import ofdm_kernel, resampler_kernel
    return {"ofdm_ifft": ofdm_kernel.ofdm_backend,
            "ofdm_cfr": ofdm_kernel.ofdm_cfr_backend,
            "resample_poly": resampler_kernel.resample}


def _paths():
    """Each path: (ensembles, settings, kernels it must launch, formats)."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    r17 = (("realistic17", REALISTIC_MUX_SPECS),)
    return {
        "main": ((*r17, ("bench2", BENCH_SPECS)), {}, ("ofdm_ifft",),
                 ("f32", "s16")),
        "realistic17_cfr_8m192": (r17, CFR_8M192,
                                  ("ofdm_cfr", "resample_poly"),
                                  ("f32", "s16")),
        "realistic17_cfr30_3m072": (r17, CFR30_3M072,
                                    ("ofdm_cfr", "resample_poly"),
                                    ("f32", "s16")),
        "realistic17_dpd_8m192": (
            r17, dict(DPD_8M192, poly_coef_file=dpd_files()["poly"]),
            ("ofdm_cfr", "resample_poly"), ("uhd",)),
    }


def phase_paths(torch):
    """Each path: two consecutive batch_tf=24 batches per (ensemble,
    format) on the card, state carried, against the port on the CPU on the
    same ETI.  Returns each kernel's launch count, summed over the card
    runs of the paths that use it, and each path's counts."""
    from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    from dabmod_tpu_torch.ops import ofdm_kernel

    kernels = _kernels()
    launches, per_path = {}, {}
    for path, (ensembles, extra, used, fmts) in _paths().items():
        cases = []
        for name, specs in ensembles:
            frames = BATCH_TF * 4                  # TM I: 4 CIFs a TF
            raw = synth_eti_batch(2 * frames, mode=1, subch_specs=specs,
                                  seed=SEED)
            batches = [parse_eti_frames(raw[:frames]),
                       parse_eti_frames(raw[frames:])]
            for fmt in fmts:
                cases.append((name, specs, fmt, batches))

        def drive(device):
            outs, margins = {}, {}
            for name, specs, fmt, batches in cases:
                m = Modulator(make_default_layout(1, specs),
                              _settings(fmt, **extra), device=device)
                state = m.init_state()
                res, marg = [], []
                for b in batches:
                    if device == "cpu" and m.settings.enable_cfr:
                        # the samples of the plain CFR at a threshold
                        syms, _ = m.ofdm_symbols(b.fic, b.subchannels,
                                                 state["ti_history"],
                                                 state["tf_index"])
                        marg.append(ofdm_kernel.cfr_threshold_margin(
                            syms, m._ofdm_table, m.settings.cfr_clip,
                            m.settings.cfr_error_clip,
                            rel=MARGIN_REL).sum(dim=1).numpy())
                    out, state, stats = m.modulate_eti(b, state)
                    res.append((_to_host(out), {k: v.cpu().numpy()
                                                for k, v in stats.items()}))
                check(int(state["tf_index"]) == 2 * BATCH_TF,
                      f"{path}/{name}/{fmt}: tf_index "
                      f"{int(state['tf_index'])}")
                outs[(name, fmt)] = (res, m.tf_samples_out)
                margins[(name, fmt)] = marg
            return outs, margins

        # the path on the card, between a reset and a read of the counts
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        gpu, _ = drive("cuda")
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in kernels.items()}
        per_path[path] = counts
        log(f"[4] {path} on the card: {len(cases)} x 2 batches in "
            f"{time.perf_counter() - t0:.1f} s; kernel launches {counts}")
        for k in used:
            check(counts[k] > 0, f"the {path} path never launched {k}")
            launches[k] = launches.get(k, 0) + counts[k]

        t0 = time.perf_counter()
        cpu, margins = drive("cpu")
        log(f"[4] the same on the CPU (plain versions) in "
            f"{time.perf_counter() - t0:.1f} s")
        rel = DPD_REL if "poly_coef_file" in extra else 3e-5
        for name, _specs, fmt, _b in cases:
            (g_res, n_out), (c_res, _) = gpu[(name, fmt)], cpu[(name, fmt)]
            for k, ((g, gs), (c, cs)) in enumerate(zip(g_res, c_res)):
                tag = f"{path}/{name}/{fmt} batch {k}"
                compare_batch(tag, fmt, g, gs, c, cs, n_out,
                              margins[(name, fmt)][k] if extra else None,
                              rel)
                if extra.get("cfr_error_clip", np.inf) < 1.0:
                    check(int(cs["cfr_errclip"].min()) > 0,
                          f"{tag}: the error clip never acted in a TF")
    return launches, per_path


def compare_batch(tag, fmt, g, gs, c, cs, n_out, margin, rel=3e-5):
    """One batch of the card against the CPU: f32 within rel*max|ref|
    (3e-5, tests/test_ofdm_kernel.py:88-89: fp32 transforms and reductions
    in other orders; DPD_REL after the poly DPD), s16 within 1 LSB (a
    float difference at a truncation edge) with equal num_clipped; with
    CFR the clip counts within the threshold margin, PAPR within 1e-3 dB,
    MER within 0.1 dB (:96) and mer_valid equal."""
    check(set(gs) == set(cs), f"{tag}: stats keys {set(gs)} != {set(cs)}")
    if fmt in ("f32", "uhd"):
        for gp in g:
            check(gp.shape == (BATCH_TF, n_out) and gp.dtype == np.float32,
                  f"{tag}: {gp.shape}")
            check(bool(np.isfinite(gp).all()), f"{tag}: not finite")
        scale = max(float(np.abs(x).max()) for x in c)
        err = max(float(np.abs(a - b).max()) for a, b in zip(g, c))
        tol = rel * scale
        log(f"    {tag}: max abs err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"{tag}: err {err} > {tol}")
    else:
        check(g.shape == (BATCH_TF, n_out) and g.dtype == np.int32,
              f"{tag}: {g.shape} {g.dtype}")
        d = np.abs(g.view(np.int16).astype(np.int32)
                   - c.view(np.int16).astype(np.int32)).max()
        log(f"    {tag}: max int16 diff {d}, num_clipped "
            f"{int(gs['num_clipped'])} / {int(cs['num_clipped'])}")
        check(d <= 1, f"{tag}: int16 diff {d} > 1")
        check(int(gs["num_clipped"]) == int(cs["num_clipped"]),
              f"{tag}: num_clipped differs")
    if margin is None:
        return
    for key, lane in (("cfr_clip", 0), ("cfr_errclip", 1)):
        d = np.abs(gs[key].astype(np.int64) - cs[key])
        log(f"    {tag}: {key} {int(gs[key].sum())} / {int(cs[key].sum())},"
            f" per-TF |diff| max {int(d.max())}, margin sum "
            f"{int(margin[:, lane].sum())}")
        check(bool((d <= margin[:, lane]).all()),
              f"{tag}: {key} differs beyond the threshold margin")
    for key, atol in (("papr_before_cfr", 1e-3), ("papr_after_cfr", 1e-3),
                      ("mer_db", 0.1)):
        d = float(np.abs(gs[key] - cs[key]).max())
        check(d <= atol, f"{tag}: {key} differs by {d} > {atol}")
    check(np.array_equal(gs["mer_valid"], cs["mer_valid"]),
          f"{tag}: mer_valid differs")
    log(f"    {tag}: PAPR before/after {float(cs['papr_before_cfr'][0]):.3f}"
        f"/{float(cs['papr_after_cfr'][0]):.3f} dB, MER "
        f"{float(cs['mer_db'][0]):.2f} dB: within tolerance")


def profile_steps(torch, step, n=5) -> dict:
    """Where one step's time goes: torch.profiler over n steps; device busy
    time (union of kernel and copy intervals), kernel launches and the
    host's wall time per step, and the host ops and the kernels that take
    the most device time.  Informational: where the profiler records no
    device activity, the device numbers are reported as not measured."""
    from torch.autograd import DeviceType
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
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return {"device_time": "not measured (no device events traced)",
                "host_wall_ms_per_step": wall_us / n / 1e3}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    # device time by the host op that launched it (a kernel launched
    # through ctypes has no host op: see the kernel list)
    ops = []
    for a in prof.key_averages():
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


def time_path(torch, path, specs, extra, fmts):
    """Step time, host issue time, samples/s at the output rate and the
    profile of one path on the 17-sub-channel ensemble, in each of its
    formats."""
    from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
    from dabmod_tpu_torch.models import Modulator, make_default_layout

    b = parse_eti_frames(synth_eti_batch(BATCH_TF * 4, mode=1,
                                         subch_specs=specs, seed=SEED + 1))
    rec = {}
    for fmt in fmts:
        m = Modulator(make_default_layout(1, specs), _settings(fmt, **extra),
                      device="cuda")
        fic = torch.as_tensor(b.fic, device="cuda")
        subs = tuple(torch.as_tensor(x, device="cuda")
                     for x in b.subchannels)
        state = [m.init_state()]

        def step():
            _, state[0], _ = m.modulate(fic, subs, state[0])
        # the host's time to issue a step comes from the same runs: equal
        # to the step time when dispatch, not the card, sets the pace
        runs, host = time_runs(torch, step)
        ms = statistics.median(runs)
        q1, _, q3 = statistics.quantiles(runs, n=4)
        n_out = BATCH_TF * m.tf_samples_out
        rec.update({
            f"{fmt}_ms_per_step": ms, f"{fmt}_ms_per_step_q1_q3": [q1, q3],
            f"{fmt}_samples_per_s": n_out / (ms / 1e3),
            f"{fmt}_host_issue_ms_per_step": statistics.median(host),
            f"{fmt}_profile": profile_steps(torch, step)})
        rate = m.settings.output_rate
        rec[f"realtime_x_{fmt}"] = rec[f"{fmt}_samples_per_s"] / rate
    rec = {"path": path, "ensemble": "realistic17", "mode": 1,
           "batch_tf": BATCH_TF, "output_rate": rate,
           "samples_per_step_out": n_out,
           "inputs": "ETI payload tensors already on the card", **rec}
    log(f"[5] {path}: {json.dumps(rec)}")
    return rec


def ofdm_timing_sets(torch, planes):
    """planes and L2_SETS - 1 more random input sets of their shape:
    cycled, they are larger than the card's L2 together."""
    rng = np.random.default_rng(SEED + 2)
    return [planes] + [random_planes(torch, rng, planes[0].shape)
                       for _ in range(L2_SETS - 1)]


def ofdm_calls(table, clip) -> dict:
    """The timed calls of K1 and K2 ("") and of their plain versions
    ("plain_") on one input set, K2 at phase 2's thresholds."""
    from dabmod_tpu_torch.ops import ofdm_kernel as K
    return {
        "ofdm_ifft": {"": lambda x: K.ofdm_backend(x, table),
                      "plain_": lambda x: K.ofdm_backend_plain(x, table)},
        "ofdm_cfr": {
            "": lambda x: K.ofdm_cfr_backend(x, table, clip, K2_ERROR_CLIP),
            "plain_": lambda x: K.ofdm_cfr_backend_plain(x, table, clip,
                                                         K2_ERROR_CLIP)}}


def table_bytes(table) -> int:
    return 4 * (table.gather.numel() + table.twiddle.numel())


def time_ofdm_ifft(torch, cpm, sets, table, calls, err, launches, ptxas):
    from dabmod_tpu_torch.ops import ofdm_kernel
    B, S, C = sets[0][0].shape
    n = table.n
    # the input sets, cycled: the headline times read their input from
    # device memory; the *_warm_l2 times reuse one set, which may sit in L2.
    # The yardstick: cuFFT alone on bins gathered ahead of time (no single
    # PyTorch call does the gather and the transform)
    bins = [torch.complex(*ofdm_kernel.gather_bins(x, table)) for x in sets]
    t = kernel_times(torch, {
        **{key: (fn, sets) for key, fn in calls.items()},
        "library_": (lambda x: torch.fft.ifft(x, norm="forward"), bins)},
        cpm)
    # least work: each carrier read once, each sample written once, the
    # tables read once; 5 N log2 N flop per symbol
    b = bound(B * S * C * 8 + B * S * n * 8 + table_bytes(table),
              5 * n * table.log2n * B * S)
    k = {"name": "ofdm_ifft", "route": "cuda",
         "source": "dabmod_tpu_torch/ops/csrc/ofdm_ifft.cu",
         "replaces": "dabmod_tpu/ops/ofdm_kernel.py:385",
         "launches": launches, "max_abs_err": err,
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
         "library_ms": t["library_ms"],
         "library_call": "torch.fft.ifft on bins gathered beforehand",
         **{key: v for key, v in t.items()
            if key.endswith(("_warm_l2", "host_issue_ms", "host_paced"))},
         "l2_sets": L2_SETS, "shape": [B, S, C, n],
         **ptxas[str(table.log2n)],
         "bytes": b["bytes"], "flops": b["flops"]}
    log(f"[5] ofdm_ifft {B}x{S} symbols, C={C}, N={n}: {t['ms']:.4f} ms "
        f"(bound {k['bound_ms']:.4f} ms by {k['bound_by']}; plain "
        f"{t['plain_ms']:.4f} ms; torch.fft.ifft alone "
        f"{t['library_ms']:.4f} ms; one input set reused: "
        f"{t['ms_warm_l2']:.4f} / {t['plain_ms_warm_l2']:.4f} / "
        f"{t['library_ms_warm_l2']:.4f} ms)")
    return k


def time_ofdm_cfr(torch, cpm, sets, table, calls, clip, err, stats,
                  launches, ptxas):
    from dabmod_tpu_torch.ops import ofdm_kernel as K
    B, S, C = sets[0][0].shape
    n = table.n
    t = kernel_times(torch, {key: (fn, sets) for key, fn in calls.items()},
                     cpm)
    # least work: carriers read once, samples and statistics written once,
    # the tables read once; three transforms of 5 N log2 N flop, 27 flop a
    # sample for the clip, the error update and the sums, and a division
    # and a square root for each clipped sample and bin of this input
    n_clip = float(stats[..., K.ST_NCLIP].sum() + stats[..., K.ST_NERRCLIP]
                   .sum())
    b = bound(B * S * C * 8 + B * S * n * 8 + B * S * K.STATS * 4
              + table_bytes(table),
              B * S * (15 * n * table.log2n + 27 * n) + 2 * n_clip)
    k = {"name": "ofdm_cfr", "route": "cuda",
         "source": "dabmod_tpu_torch/ops/csrc/ofdm_cfr.cu",
         "replaces": "dabmod_tpu/ops/ofdm_kernel.py:385 (enable_cfr=True, "
                     "body :275-320)",
         "launches": launches, "max_abs_err": err,
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
         "library_ms": None,
         "library_call": "none: no single PyTorch call computes the "
                         "transform, the clips and the statistics",
         **{key: v for key, v in t.items()
            if key.endswith(("_warm_l2", "host_issue_ms", "host_paced"))},
         "l2_sets": L2_SETS, "shape": [B, S, C, n], "clip": clip,
         "error_clip": K2_ERROR_CLIP, **ptxas[str(table.log2n)],
         "bytes": b["bytes"], "flops": b["flops"]}
    log(f"[5] ofdm_cfr {B}x{S} symbols, C={C}, N={n}: {t['ms']:.4f} ms "
        f"(bound {k['bound_ms']:.4f} ms by {k['bound_by']}; plain "
        f"{t['plain_ms']:.4f} ms; no library call; one input set reused: "
        f"{t['ms_warm_l2']:.4f} / {t['plain_ms_warm_l2']:.4f} ms)")
    return k


def resample_library(torch, table):
    """The yardstick: one cuDNN transposed convolution with stride L and
    the plan's prototype filter, re and im as a batch of two, read at every
    M-th output (a view: the convolution computes M times the outputs);
    with a zero carry its first n*L/M outputs are the resampler's."""
    plan = table.plan
    taps = table.taps.cpu().numpy()
    row0 = table.row0.cpu().numpy()
    w = np.zeros(2 * plan.half * plan.L + 1, np.float32)
    for p in range(plan.L):
        for k in range(table.n_taps):
            tt = p * plan.M - (row0[p] + k - plan.half) * plan.L
            if abs(tt) <= plan.half * plan.L:
                w[tt + plan.half * plan.L] = taps[p, k]
    weight = torch.as_tensor(w, device="cuda").view(1, 1, -1)

    def library(s):
        return torch.nn.functional.conv_transpose1d(
            s, weight, stride=plan.L)[..., ::plan.M]
    return library


def resample_calls(torch, x, carry, table) -> dict:
    """The timed calls of K3 (""), its plain version ("plain_") and the
    yardstick ("library_"), each with its input sets: x and RES_L2_SETS - 1
    more random streams of its length, larger than the card's L2
    together."""
    from dabmod_tpu_torch.ops import resampler_kernel as R
    rng = np.random.default_rng(SEED + 4)
    sets = [x] + [random_planes(torch, rng, x[0].shape)
                  for _ in range(RES_L2_SETS - 1)]
    stacked = [torch.stack(s).unsqueeze(1) for s in sets]   # [2, 1, n]
    return {"": (lambda s: R.resample(s, carry, table), sets),
            "plain_": (lambda s: R.resample_plain(s, carry, table), sets),
            "library_": (resample_library(torch, table), stacked)}


def time_resample(torch, cpm, x, carry, table, err, launches, ptxas):
    from dabmod_tpu_torch.ops import resampler_kernel as R
    plan = table.plan
    n = x[0].shape[0]
    n_out = n * plan.L // plan.M
    calls = resample_calls(torch, x, carry, table)
    library, stacked = calls["library_"]
    zero = tuple(torch.zeros_like(c) for c in carry)
    (yr, yi), _ = R.resample(x, zero, table)
    z = library(stacked[0])[:, 0, :n_out]
    scale = float(torch.stack([yr, yi]).abs().max())
    lib_err = float((z - torch.stack([yr, yi])).abs().max())
    log(f"[5] conv_transpose1d yardstick against the kernel at "
        f"{plan.L}/{plan.M} (zero carry): max abs err {lib_err:.3e} "
        f"(scale {scale:.3e})")
    check(lib_err <= 1e-5 * scale, "conv_transpose1d computes another "
          "function than the resampler")

    t = kernel_times(torch, calls, cpm)
    # least work: each input and carry sample read once, each output
    # written once, the tables read once; 2 flop per non-zero tap of the
    # band for every output of both planes
    taps = table.taps.cpu().numpy()
    nnz = int(np.count_nonzero(taps))
    b = bound(2 * 4 * (n + 2 * plan.half + n_out) + taps.nbytes
              + table.row0.numel() * 4, 2 * 2 * (n // plan.M) * nnz)
    lay = table.layout
    inst = R.INSTANCES[lay.instance]
    rate = 2_048_000 * plan.L // plan.M
    name = "resample_poly" if rate == 8_192_000 else (
        f"resample_poly_{rate // 1_000_000}m{rate // 1000 % 1000:03d}")
    k = {"name": name, "route": "cuda",
         "source": "dabmod_tpu_torch/ops/csrc/resample_poly.cu",
         "replaces": "dabmod_tpu/ops/resampler_kernel.py:140",
         "launches": launches, "max_abs_err": err,
         "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
         "library_ms": t["library_ms"],
         "library_call": "torch.nn.functional.conv_transpose1d, stride L, "
                         "the plan's prototype filter (cuDNN, no TF32), "
                         "every M-th output",
         **{key: v for key, v in t.items()
            if key.endswith(("_warm_l2", "host_issue_ms", "host_paced"))},
         "l2_sets": RES_L2_SETS, "rate": rate, "L": plan.L, "M": plan.M,
         "taps": table.n_taps, "samples_in": n, "samples_out": n_out,
         **R.launch_shape(table), "symbols_per_block": None,
         "outputs_per_chunk": lay.q_per_chunk * plan.L,
         **{key: v for key, v in ptxas["_".join(map(str, inst))].items()
            if key in ("registers", "smem_bytes", "spill_stores")},
         "bytes": b["bytes"], "flops": b["flops"]}
    log(f"[5] {name} {n} -> {n_out} samples a plane (L={plan.L}, "
        f"M={plan.M}, instance {inst}): {t['ms']:.4f} ms (bound "
        f"{k['bound_ms']:.4f} ms by {k['bound_by']}; plain "
        f"{t['plain_ms']:.4f} ms; conv_transpose1d {t['library_ms']:.4f} ms;"
        f" one input set reused: {t['ms_warm_l2']:.4f} / "
        f"{t['plain_ms_warm_l2']:.4f} / {t['library_ms_warm_l2']:.4f} ms)")
    return k


def time_dpd_stages(torch, cpm) -> dict:
    """Device ms of the eager stages realistic17_dpd_8m192 adds, alone, at
    its shapes (24 TFs, TM I): the windowed guard interval (overlap 90,
    with gains) and the FIR (the 45 default taps) at 2.048 MS/s, the poly
    and the LUT DPD at 8.192 MS/s; device_runs of 3 calls, the card held
    in a spin while the host issues them.  Each with the host's time to
    issue it and its bound: each input read and each output written once
    at the HBM rate (their operations are far below the fp32 peak)."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.ops import filters, ofdm
    p = tables.mode_params(1)
    rng = np.random.default_rng(SEED + 6)
    td = random_planes(torch, rng, (BATCH_TF, p.nb_symbols + 1, p.spacing))
    gains = torch.rand(BATCH_TF, p.nb_symbols + 1, device="cuda")
    iq = random_planes(torch, rng, (BATCH_TF, p.tf_samples))
    up = tuple(x * 0.5 for x in random_planes(torch, rng,
                                              (BATCH_TF, 4 * p.tf_samples)))
    taps = torch.as_tensor(tables.DEFAULT_FIR_TAPS, device="cuda")
    am, pm = (torch.tensor(c, dtype=torch.float32, device="cuda")
              for c in (POLY_AM, POLY_PM))
    lut = torch.rand(32, 2, device="cuda")
    scale = torch.tensor(np.float32(LUT_SCALE), device="cuda")
    plane = 4 * BATCH_TF * p.tf_samples           # bytes of one 2.048 plane
    stages = {
        "guard_interval_windowed": (
            lambda: ofdm.guard_interval_windowed(td, p.null_size,
                                                 p.sym_size, 90, gains),
            2 * 4 * td[0].numel() + 2 * plane),
        "fir_filter": (lambda: filters.fir_filter(iq, taps), 4 * plane),
        "memless_poly": (lambda: filters.memless_poly(up, am, pm),
                         4 * 4 * plane),
        "memless_lut": (lambda: filters.memless_lut(up, lut, scale),
                        4 * 4 * plane),
    }
    rec = {}
    for name, (fn, nbytes) in stages.items():
        dev, host, paced = device_runs(torch, fn, 3, cpm)
        rec[name] = {"ms": statistics.median(dev),
                     "host_issue_ms": statistics.median(host),
                     "host_paced": paced,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bytes": nbytes}
    log(f"[5] eager stages of realistic17_dpd_8m192 alone: {json.dumps(rec)}")
    return rec


def phase_times(torch, inputs, launches, ptxas):
    """Phase 5; `launches` is phase 4's (summed over paths, per path).
    Returns the eager stages' times and the kernels' records."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    total, per_path = launches
    steps = {path: time_path(torch, path, ensembles[0][1], extra, fmts)
             for path, (ensembles, extra, _used, fmts) in _paths().items()}
    # the kiss engine's step: eager int32 ops, no kernel of the port
    steps["realistic17_kiss"] = time_path(
        torch, "realistic17_kiss", REALISTIC_MUX_SPECS,
        dict(fft_engine="kiss"), ("s16",))
    cpm = sleep_cycles_per_ms(torch)
    log(f"[5] torch.cuda._sleep: {cpm:.0f} cycles a ms")
    stages = time_dpd_stages(torch, cpm)
    planes, table, clip = inputs["ofdm"]
    sets = ofdm_timing_sets(torch, planes)
    calls = ofdm_calls(table, clip)
    # K3's launches at each rate: those of the paths that run at it
    res_paths = {8_192_000: ("realistic17_cfr_8m192",
                             "realistic17_dpd_8m192"),
                 3_072_000: ("realistic17_cfr30_3m072",)}
    kernels = [
        time_ofdm_ifft(torch, cpm, sets, table, calls["ofdm_ifft"],
                       inputs["ofdm_ifft"], total["ofdm_ifft"],
                       ptxas["ofdm_ifft"]),
        time_ofdm_cfr(torch, cpm, sets, table, calls["ofdm_cfr"], clip,
                      *inputs["ofdm_cfr"], total["ofdm_cfr"],
                      ptxas["ofdm_cfr"]),
        *[time_resample(torch, cpm, *inputs["resample_poly"][rate],
                        sum(per_path[p]["resample_poly"]
                            for p in res_paths[rate]),
                        ptxas["resample_poly"])
          for rate in K3_TIMED_RATES]]
    return stages, kernels, steps


# ---------------------------------------------------------------------------
# phase 6: variant runs
# ---------------------------------------------------------------------------

def _variants():
    """(name, TM, settings, format) of the variant runs that compare
    outputs; each launches K1 and neither K2 nor K3."""
    tii_old = dict(tii_enable=True, tii_comb=5, tii_pattern=31,
                   tii_old_variant=True)
    return [
        ("lut_dpd", 1, dict(poly_coef_file=dpd_files()["lut"]), "uhd"),
        ("u8_file", 1, {}, "u8"),
        ("s8_file", 1, {}, "s8"),
        ("cic_32m768", 1, dict(cic_eq_clock_rate=32_768_000), "f32"),
        ("fft_1m536_auto", 1, dict(output_rate=1_536_000), "f32"),
        ("fft_4m096", 1, dict(output_rate=4_096_000, resampler_mode="fft"),
         "f32"),
        ("poly_plain_2m5", 1, dict(output_rate=2_500_000), "f32"),
        ("tii_old_tm2", 2, tii_old, "f32"),
        ("window90_tm2", 2, dict(ofdm_window_overlap=90), "f32"),
        ("window63_tm3", 3, dict(ofdm_window_overlap=63), "f32"),
        ("window90_tm4", 4, dict(ofdm_window_overlap=90), "f32"),
    ]


def _variant_batches(mode):
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.eti import (REALISTIC_MUX_SPECS, parse_eti_frames,
                                      synth_eti_batch)
    n = VARIANT_TF * tables.mode_params(mode).cif_count
    raw = synth_eti_batch(2 * n, mode=mode, subch_specs=REALISTIC_MUX_SPECS,
                          seed=SEED + 5)
    return [parse_eti_frames(raw[:n]), parse_eti_frames(raw[n:])]


def drive_both(torch, mode, settings, step=None):
    """Two batches through a modulator on the card and one on the CPU,
    the state carried; `step(m, batch, state, device)` replaces
    modulate_eti.
    Returns ({"cuda": [...], "cpu": [...]} of (output on the host, stats),
    the card's kernel launches)."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    step = step or (lambda m, b, st, _dev: m.modulate_eti(b, st))
    kernels = _kernels()
    outs, counts = {}, None
    for dev in ("cuda", "cpu"):
        m = Modulator(make_default_layout(mode, REALISTIC_MUX_SPECS),
                      settings, device=dev)
        if dev == "cuda":
            for k in kernels.values():
                k.launches = 0
        state, res = m.init_state(), []
        for b in _variant_batches(mode):
            out, state, stats = step(m, b, state, dev)
            res.append((_to_host(out), {k: v.cpu().numpy()
                                        for k, v in stats.items()}))
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = {k: f.launches for k, f in kernels.items()}
        outs[dev] = res
    return outs, counts


def _max_err(g, c):
    scale = max(float(np.abs(x).max()) for x in c)
    return max(float(np.abs(a - b).max()) for a, b in zip(g, c)), scale


def check_lut_variant(torch, name, settings, outs):
    """The LUT DPD: outputs within 3e-5*max|ref| except where the card's
    and the CPU's bins differ, which must be samples within 1e-6
    (relative) of a bin edge (the bins from each device's signal before
    the DPD)."""
    import dataclasses
    from dabmod_tpu_torch.ops import filters
    pre, _ = drive_both(torch, 1, dataclasses.replace(settings,
                                                      poly_coef_file=""))
    scale_t = torch.tensor(np.float32(LUT_SCALE))
    n_other = n_edge = 0
    for k in range(2):
        xg, xc = (tuple(torch.as_tensor(v) for v in pre[d][k][0])
                  for d in ("cuda", "cpu"))
        other = (filters.lut_index(xg, scale_t)
                 != filters.lut_index(xc, scale_t)).numpy()
        edge = filters.lut_edge_samples(xc, scale_t).numpy()
        check(not (other & ~edge).any(), f"[6] {name}: a LUT bin differs "
              f"away from a bin edge")
        (g, _), (c, _) = outs["cuda"][k], outs["cpu"][k]
        scale = max(float(np.abs(x).max()) for x in c)
        err = max(float(np.abs(a - b)[~other].max()) for a, b in zip(g, c))
        check(err <= 3e-5 * scale, f"[6] {name} batch {k}: err {err}")
        n_other += int(other.sum())
        n_edge += int(edge.sum())
    log(f"[6] {name}: card vs CPU, bins equal except {n_other} sample(s), "
        f"all within 1e-6 of a bin edge ({n_edge} such samples); outputs "
        f"elsewhere within 3e-5*max|ref|")


def check_variant(torch, name, mode, extra, fmt):
    settings = _settings(fmt, dab_mode=mode, **extra)
    outs, counts = drive_both(torch, mode, settings)
    check(counts == {"ofdm_ifft": 2, "ofdm_cfr": 0, "resample_poly": 0},
          f"[6] {name}: kernel launches {counts}")
    if name == "lut_dpd":
        check_lut_variant(torch, name, settings, outs)
        return counts
    for k, ((g, gs), (c, cs)) in enumerate(zip(outs["cuda"], outs["cpu"])):
        if fmt in ("u8", "s8"):
            byte = np.uint8 if fmt == "u8" else np.int8
            check(g.dtype == np.int32 and g.shape == c.shape,
                  f"[6] {name}: {g.shape} {g.dtype}")
            d = int(np.abs(g.view(byte).astype(np.int32)
                           - c.view(byte).astype(np.int32)).max())
            check(d <= 1 and int(gs["num_clipped"]) == int(cs["num_clipped"]),
                  f"[6] {name} batch {k}: byte diff {d}, clips "
                  f"{int(gs['num_clipped'])} / {int(cs['num_clipped'])}")
            what = (f"{g.shape[1]} words a TF, max byte diff {d}, "
                    f"num_clipped {int(gs['num_clipped'])} / "
                    f"{int(cs['num_clipped'])}")
        else:
            err, scale = _max_err(g, c)
            check(err <= 3e-5 * scale and all(np.isfinite(x).all()
                                              for x in g),
                  f"[6] {name} batch {k}: err {err} > {3e-5 * scale}")
            what = (f"{g[0].shape[1]} samples a TF, max abs err {err:.3e} "
                    f"(tol {3e-5 * scale:.3e})")
        log(f"[6] {name} (TM {mode}) batch {k}: {what}")
    log(f"[6] {name}: kernel launches on the card {counts}")
    return counts


def check_traced(torch):
    """modulate_traced of the DPD chain on the card against the CPU: the
    same stage files, the integer stages byte-equal, the float stages
    within 3e-5*max|ref| (DPD_REL after the poly DPD)."""
    settings = _settings("uhd", **DPD_8M192,
                         poly_coef_file=dpd_files()["poly"])
    root = os.path.join(_TMP[0], "traces")

    def traced(m, b, st, dev):
        return m.modulate_traced(b.fic, tuple(b.subchannels), st,
                                 os.path.join(root, dev))
    drive_both(torch, 1, settings, traced)
    names = sorted(os.listdir(os.path.join(root, "cuda")))
    check(names and names == sorted(os.listdir(os.path.join(root, "cpu"))),
          f"[6] modulate_traced: stage files differ: {names}")
    worst = {}
    for name in names:
        with open(os.path.join(root, "cuda", name), "rb") as f:
            got = f.read()
        with open(os.path.join(root, "cpu", name), "rb") as f:
            ref = f.read()
        check(len(got) == len(ref), f"[6] {name}: sizes differ")
        stage = name[3:-4]
        if stage in ("fec", "qpsk_map", "diff_mod"):
            check(got == ref, f"[6] modulate_traced {name}: bytes differ")
            worst[stage] = "byte-equal"
            continue
        g, r = np.frombuffer(got, np.float32), np.frombuffer(ref, np.float32)
        rel = DPD_REL if stage == "dpd" else 3e-5
        err = float(np.abs(g - r).max()) / float(np.abs(r).max())
        check(err <= rel, f"[6] modulate_traced {name}: err {err} of "
              f"max|ref| > {rel}")
        worst[stage] = f"{err:.2e}"
    log(f"[6] modulate_traced (DPD chain, {VARIANT_TF} TFs x 2 batches): "
        f"{len(names)} stage files, card vs CPU (max abs err of max|ref|): "
        f"{json.dumps(worst)}")


def check_hot_swap(torch):
    """New FIR taps and poly coefficients swapped in between two batches on
    the card: equal to a modulator built with them."""
    import dataclasses
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    taps2 = np.asarray(tables.DEFAULT_FIR_TAPS[::-1], np.float32)
    am2, pm2 = (0.9, 0.01, 0.0, 0.0, 0.0), (0.05, 0.0, 0.0, 0.0, 0.0)
    d = _TMP[0]
    with open(os.path.join(d, "taps2.txt"), "w") as f:
        f.write(f"{taps2.size}\n" + "".join(f"{float(t)!r}\n"
                                            for t in taps2))
    with open(os.path.join(d, "poly2.coef"), "w") as f:
        f.write("1\n5\n" + "".join(f"{v!r}\n" for v in (*am2, *pm2)))
    s1 = _settings("uhd", **DPD_8M192, poly_coef_file=dpd_files()["poly"])
    s2 = dataclasses.replace(s1, filter_taps_file=os.path.join(d,
                                                               "taps2.txt"),
                             poly_coef_file=os.path.join(d, "poly2.coef"))
    b1, b2 = _variant_batches(1)
    layout = make_default_layout(1, REALISTIC_MUX_SPECS)
    m = Modulator(layout, s1, device="cuda")
    _, st, _ = m.modulate_eti(b1, m.init_state())
    check(m.update_fir_taps(taps2) and m.update_dpd("poly", (am2, pm2)),
          "[6] hot swap refused")
    check(not m.update_fir_taps(taps2[:7]), "[6] a tap-count change was "
          "taken as a hot swap")
    got, _, _ = m.modulate_eti(b2, st)
    fresh = Modulator(layout, s2, device="cuda")
    _, st_f, _ = fresh.modulate_eti(b1, fresh.init_state())
    want, _, _ = fresh.modulate_eti(b2, st_f)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "[6] hot swap differs from a fresh modulator")
    log("[6] hot swap of FIR taps and poly coefficients between two "
        "batches on the card: equal to a fresh modulator built with them; "
        "a tap-count change refused")


def phase_variants(torch):
    """Phase 6; returns the kernel launches summed over the variant runs
    that compare outputs."""
    t0 = time.perf_counter()
    total = {}
    for name, mode, extra, fmt in _variants():
        for k, n in check_variant(torch, name, mode, extra, fmt).items():
            total[k] = total.get(k, 0) + n
    check_traced(torch)
    check_hot_swap(torch)
    log(f"[6] variant runs passed in {time.perf_counter() - t0:.1f} s; "
        f"kernel launches {total}")
    return total


# ---------------------------------------------------------------------------
# phase 7: the fixed-point engines, and the port as a program (the runtime
# in-process and the CLI as a subprocess)
# ---------------------------------------------------------------------------

def _kiss_runs(torch, mode, ov, batches):
    """The kiss chain on the card and on the CPU over `batches` (pairs of
    FIC and sub-channel arrays), the state carried: {device: [int32 wire
    words on the host]}."""
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    specs = BENCH_SPECS if mode == 1 else ((0, 24, 0x22),)
    s = ModSettings(dab_mode=mode, fft_engine="kiss", ofdm_window_overlap=ov)
    out = {}
    for dev in ("cuda", "cpu"):
        m = Modulator(make_default_layout(mode, specs), s, device=dev)
        state, res = m.init_state(), []
        for fic, subs in batches:
            words, state, stats = m.modulate(fic, subs, state)
            check(int(stats["num_clipped"]) == 0, "kiss: num_clipped != 0")
            res.append(words.cpu().numpy())
        out[dev] = res
    return out


def phase_fixed_point(torch):
    """fft_engine=kiss at overlap 0 and 90 on the golden payloads: card,
    CPU and the reference's goldens equal bit for bit; TM II-IV at 2 TFs,
    card against CPU bit for bit.  fft_engine=dexter in TM I and TM III at
    overlap 0 and 12: the card's Q1.14 symbols and the host chain's wire
    words bit for bit the CPU's."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    t0 = time.perf_counter()
    golden = [(load_golden("e2e_fixed_fic_in").reshape(8, 96),
               (load_golden("e2e_fixed_sub0_in").reshape(8, -1),
                load_golden("e2e_fixed_sub1_in").reshape(8, -1)))]
    for ov, name in ((0, "e2e_iq_fixed"), (90, "e2e_iq_fixed_ov90")):
        out = _kiss_runs(torch, 1, ov, golden)
        ref = load_golden(name)
        for dev in ("cuda", "cpu"):
            check(np.array_equal(out[dev][0].view(np.int16).reshape(-1),
                                 ref), f"[7] kiss overlap {ov} on {dev} "
                  f"differs from {name}")
        log(f"[7] kiss TM I overlap {ov}: card == CPU == {name} "
            f"({ref.size // 2} samples), bit for bit")
    for mode, ov in ((2, 90), (3, 63), (4, 0)):
        n = VARIANT_TF * tables.mode_params(mode).cif_count
        raw = synth_eti_batch(2 * n, mode=mode, seed=SEED + mode)
        batches = [(b.fic, tuple(b.subchannels)) for b in (
            parse_eti_frames(raw[:n]), parse_eti_frames(raw[n:]))]
        out = _kiss_runs(torch, mode, ov, batches)
        check(all(np.array_equal(g, c) for g, c in zip(out["cuda"],
                                                       out["cpu"])),
              f"[7] kiss TM {mode} overlap {ov}: card != CPU")
        log(f"[7] kiss TM {mode} overlap {ov} ({VARIANT_TF} TFs x 2 "
            f"batches): card == CPU, bit for bit")
    for mode, ov in ((1, 0), (1, 12), (3, 0), (3, 12)):
        p = tables.mode_params(mode)
        b = parse_eti_frames(synth_eti_batch(p.cif_count, mode=mode,
                                             seed=SEED + 8))
        s = ModSettings(dab_mode=mode, fft_engine="dexter",
                        ofdm_window_overlap=ov)
        got = {}
        for dev in ("cuda", "cpu"):
            m = Modulator(make_default_layout(mode), s, device=dev)
            syms, _, _ = m.modulate_eti(b, m.init_state())
            syms = syms.cpu().numpy()
            got[dev] = (syms, m.host_backend(syms),
                        m.host_backend.num_clipped)
        (gs, gw, gn), (cs, cw, cn) = got["cuda"], got["cpu"]
        check(gs.dtype == np.int32 and gs.shape == (2, 1, p.nb_symbols + 1,
                                                    p.nb_carriers),
              f"[7] dexter TM {mode}: symbols {gs.shape} {gs.dtype}")
        check(np.array_equal(gs, cs), f"[7] dexter TM {mode} overlap {ov}: "
              f"card symbols != CPU")
        check(np.array_equal(gw, cw) and gn == cn, f"[7] dexter TM {mode} "
              f"overlap {ov}: host-chain wire words differ")
        log(f"[7] dexter TM {mode} overlap {ov}: Q1.14 symbols {gs.shape} "
            f"and {gw.size} wire words card == CPU, bit for bit "
            f"(num_clipped {gn})")
    log(f"[7] fixed-point engines passed in "
        f"{time.perf_counter() - t0:.1f} s")


RUNTIME_BATCHES = 4          # batches of BATCH_TF TFs in phase 7's ETI file
RUNTIME_COMPARED = 2         # of them, compared with the CPU runtime's
ETI_FRAME_S = 0.024


def _runtime_inis():
    """Phase 7's INIs: (modulator keys, other sections, file format, the
    kernels it must launch, the step of Modulator.modulate alone that
    phase 5 timed at the same settings)."""
    return {
        "a_main_s16": ("", "", "s16", ("ofdm_ifft",), ("main", "s16")),
        "b_cfr_8m192_complexf": (
            "rate=8192000\n", "[cfr]\nenable=1\nclip=40.0\nerrorclip=3.0\n",
            "complexf", ("ofdm_cfr", "resample_poly"),
            ("realistic17_cfr_8m192", "f32")),
        "c_kiss_s16": ("fft_engine=kiss\n", "", "s16", (),
                       ("realistic17_kiss", "s16")),
    }


def _write_ini(d, name, eti, out, tag=""):
    mod, sections, fmt, _k, _s = _runtime_inis()[name]
    path = os.path.join(d, f"{name}{tag}.ini")
    with open(path, "w") as f:
        f.write(f"[input]\ntransport=file\nsource={eti}\n"
                f"[modulator]\ngainmode=var\nbatch_tf={BATCH_TF}\n{mod}"
                f"{sections}[fileoutput]\nfilename={out}\nformat={fmt}\n")
    return path


def _run_runtime(ini, device, max_batches=None):
    """One run of the runtime on the INI: (wall s of run + close, the
    runtime)."""
    from dabmod_tpu_torch.config import parse_ini
    from dabmod_tpu_torch.runtime import ModRuntime
    rt = ModRuntime(parse_ini(ini), device=device)
    t0 = time.perf_counter()
    code = rt.run(max_batches)
    rt.close()
    wall = time.perf_counter() - t0
    check(code == 0, f"[7] runtime on {ini} ({device}) exited {code}")
    return wall, rt


def _compare_files(name, fmt, got_path, ref_path, engine_fixed):
    """The card's file against the CPU runtime's, over the CPU file's
    length: the fixed-point engine byte for byte, s16 within 1 LSB, f32
    within 3e-5*max|ref|."""
    ref = np.fromfile(ref_path, np.uint8)
    got = np.fromfile(got_path, np.uint8, count=ref.size)
    check(got.size == ref.size > 0, f"[7] {name}: {got.size} bytes of the "
          f"card's file, {ref.size} of the CPU's")
    if engine_fixed:
        check(np.array_equal(got, ref), f"[7] {name}: card != CPU")
        return "byte for byte"
    if fmt == "s16":
        d = int(np.abs(got.view(np.int16).astype(np.int32)
                       - ref.view(np.int16)).max())
        check(d <= 1, f"[7] {name}: int16 diff {d} > 1")
        return f"max int16 diff {d}"
    g, r = got.view(np.float32), ref.view(np.float32)
    check(bool(np.isfinite(g).all()), f"[7] {name}: not finite")
    scale = float(np.abs(r).max())
    err = float(np.abs(g - r).max())
    check(err <= 3e-5 * scale, f"[7] {name}: err {err} > {3e-5 * scale}")
    return f"max abs err {err:.3e} (tol {3e-5 * scale:.3e})"


def _per_s(rate):
    return rate[0] / rate[1] if rate else None


def phase_runtime(torch, steps):
    """The runtime in-process on the card: the 17-sub-channel ensemble,
    batch_tf=24, an ETI file of RUNTIME_BATCHES batches and the file sink,
    for each of _runtime_inis() written as an INI file and read with
    parse_ini; kernel launches counted between a reset and a read around
    the run; the first RUNTIME_COMPARED batches of the file against the
    same INI run by the runtime on the CPU; a second, warm run timed
    (ETI frames/s, x real time, and the share of the wall time in each
    part of the pipeline) beside the step of Modulator.modulate alone that
    phase 5 timed.  Then the CLI as a subprocess on the card, INI a over
    RUNTIME_COMPARED batches: it exits 0 and writes the in-process run's
    bytes."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS, synth_eti_batch
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    _TMP.append(d)
    frames = synth_eti_batch(RUNTIME_BATCHES * BATCH_TF * 4, mode=1,
                             subch_specs=REALISTIC_MUX_SPECS, seed=SEED + 7)
    eti = os.path.join(d, "in.eti")
    frames.tofile(eti)
    eti2 = os.path.join(d, "in2.eti")
    frames[:RUNTIME_COMPARED * BATCH_TF * 4].tofile(eti2)
    n_frames = frames.shape[0]
    kernels = _kernels()
    records = {}
    for name, (mod, _sec, fmt, used, step_key) in _runtime_inis().items():
        outs = {tag: os.path.join(d, f"{name}_{tag}.iq")
                for tag in ("card", "timed", "cpu")}
        for k in kernels.values():
            k.launches = 0
        wall, rt = _run_runtime(_write_ini(d, name, eti, outs["card"]),
                                "cuda")
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in kernels.items()}
        check(rt.framecount == n_frames, f"[7] {name}: {rt.framecount} of "
              f"{n_frames} ETI frames modulated")
        for k in used:
            check(counts[k] > 0, f"[7] {name} never launched {k}")
        _, rt_cpu = _run_runtime(_write_ini(d, name, eti, outs["cpu"]),
                                 "cpu", RUNTIME_COMPARED)
        what = _compare_files(name, fmt, outs["card"], outs["cpu"],
                              "fft_engine" in mod)
        # the timed run: the modulator comes from get_modulator's cache
        wall_t, rt_t = _run_runtime(_write_ini(d, name, eti, outs["timed"]),
                                    "cuda")
        check(os.path.getsize(outs["timed"]) == os.path.getsize(
            outs["card"]), f"[7] {name}: the timed run's file differs in "
              f"size")
        fps = n_frames / wall_t
        step = steps[step_key[0]]
        step_ms = step[f"{step_key[1]}_ms_per_step"]
        modulate_fps = BATCH_TF * 4 / (step_ms / 1e3)
        rec = {
            "ini": name, "format": fmt, "output_rate": rt.settings.output_rate,
            "eti_frames": n_frames, "batches": RUNTIME_BATCHES,
            "batch_tf": BATCH_TF, "launches": counts,
            "bytes_out": os.path.getsize(outs["timed"]),
            "cold_wall_s": wall, "wall_s": wall_t,
            "frames_per_s": fps, "realtime_x": fps * ETI_FRAME_S,
            "process_rate_frames_per_s": _per_s(rt_t.process_rate()),
            "modulate_step_ms": step_ms,
            "modulate_frames_per_s": modulate_fps,
            "runtime_over_modulate": fps / modulate_fps,
            "share_of_wall": {k: v / wall_t for k, v in
                              rt_t.timings.items()},
            "vs_cpu": what, "cpu_frames_compared": rt_cpu.framecount}
        records[name] = rec
        log(f"[7] runtime {name}: {n_frames} ETI frames on the card, "
            f"launches {counts}; first {RUNTIME_COMPARED} batches vs the "
            f"CPU runtime: {what}; warm run {wall_t:.3f} s = "
            f"{fps:.1f} frames/s = {fps * ETI_FRAME_S:.2f}x real time "
            f"(cold {wall:.3f} s); modulate alone {step_ms:.3f} ms a step = "
            f"{modulate_fps:.1f} frames/s; share of wall "
            f"{json.dumps(rec['share_of_wall'])}")
        for path in outs.values():
            os.remove(path)

    # the CLI as a subprocess on the card, INI a over RUNTIME_COMPARED
    # batches, against the in-process run of the same INI and ETI file
    _run_runtime(_write_ini(d, "a_main_s16", eti2,
                            os.path.join(d, "inproc.iq"), "_inproc"), "cuda")
    ini = _write_ini(d, "a_main_s16", eti2, os.path.join(d, "cli.iq"),
                     "_cli")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dabmod_tpu_torch.cli", ini],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"[7] the CLI exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    with open(os.path.join(d, "cli.iq"), "rb") as f:
        cli_bytes = f.read()
    with open(os.path.join(d, "inproc.iq"), "rb") as f:
        inproc = f.read()
    check(len(cli_bytes) == len(inproc) > 0 and cli_bytes == inproc,
          f"[7] the CLI's file ({len(cli_bytes)} bytes) differs from the "
          f"in-process run's ({len(inproc)} bytes)")
    log(f"[7] python -m dabmod_tpu_torch.cli {os.path.basename(ini)}: exit "
        f"0 in {cli_s:.1f} s, {len(cli_bytes)} bytes equal to the "
        f"in-process run's; its last log line: "
        f"{proc.stderr.strip().splitlines()[-1] if proc.stderr else ''}")
    log(f"[7] runtime phase passed in {time.perf_counter() - t_phase:.1f} s")
    return records


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, ROOT)
    try:
        import dabmod_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"dabmod_tpu_torch is not importable from {ROOT}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    try:
        card, ptxas = phase_card_and_build(torch)
        inputs = phase_kernels(torch)
        phase_frontend(torch)
        launches = phase_paths(torch)
        stages, kernels, steps = phase_times(torch, inputs, launches, ptxas)
        variant_launches = phase_variants(torch)
        phase_fixed_point(torch)
        runtime = phase_runtime(torch, steps)
    finally:
        for d in _TMP:
            shutil.rmtree(d, ignore_errors=True)
    # K1's launches in phase 6 and each kernel's in phase 7, beside those of
    # the full-width paths of phase 4
    kernels[0]["variant_launches"] = variant_launches["ofdm_ifft"]
    for k in kernels:
        base = "resample_poly" if k["name"].startswith("resample_poly") \
            else k["name"]
        k["runtime_launches"] = {
            ini: rec["launches"][base] for ini, rec in runtime.items()
            if k.get("rate", 8_192_000) == rec["output_rate"]
            or base != "resample_poly"}
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"card": card, "kernels": kernels,
                      "eager_stages": stages, "runtime": runtime}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
