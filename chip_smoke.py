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
   assumes.  Also builds (g++) and loads the native host library
   (dabmod_tpu_torch/native.py from native/dabmod_native.cpp) and fails
   where it does not load: the EDI RS decode and the host format
   conversion take it.
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
   * K4, the KISS fixed-point transform, at all four spacings, both its
     outputs (the s16 wire words with the cyclic prefixes, and the int32
     planes the windowed guard interval takes), bit for bit against its
     plain version on the CPU, on the same random planes as K1 (at TM I
     the main path's [24, 77, 1536]), and again on one symbol and on 13
     (a ragged last block below N = 2048);
   * K3, the polyphase resampler, at 3.072, 4.096 and 8.192 MS/s and
     (resampler_mode="poly") 1.024 and 1.792 MS/s, so L/M = 3/2, 2, 4, 1/2
     and 7/8 (the last through the kernel's run-time-M instance), on a
     stream of the main path's length (24 TFs), and two half-stream calls
     with the carry against one call.
3. The front end against the reference goldens in tests/golden/
   (e2e_symbols: 2 TFs, 2 sub-channels; e2e_real_symbols: 4 TFs, the
   17-sub-channel ensemble); K5, the front end in one kernel, bit for bit
   against its plain version on the CPU (planes and new history) in TM
   I-IV on the 17-sub-channel ensemble, with TII in TM I and II and CIC in
   TM I, three chained batches of 24 TFs (TM I) and of 1 TF.
4. Five paths at full width, TM I, batch_tf=24 (24 x 196,608 samples a
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
     CPU after the DPD;
   * "realistic17_kiss": the 17-sub-channel ensemble through
     fft_engine=kiss at overlap 10 (doc/example.ini's ofdmwindowing, the
     benchmark's r17_kiss_s16): K4 writes int32 planes and the Q1.14
     windowed guard interval makes the s16 words, equal to the CPU's bit
     for bit.
   On the card Modulator.modulate replays a CUDA graph of the step
   (dabmod_tpu_torch/models/compiled.py), captured at a modulator's first
   batch after one eager warm-up; every output, stat and state tensor of
   the card's run is held against the eager step (Modulator._modulate_impl)
   on the card on the same batches, to the bit.  Each path's kernel launch
   counts are set to 0 just before its card run and read just after: the
   wrappers count where they launch, so they count each graph's warm-up
   and capture and no replay.  The card run is traced (torch.profiler):
   the trace's launches of each kernel must equal the warm-ups' plus each
   graph's at each of its replays.  A kernel's launches, counted and on
   the card, are summed over its paths.
5. Times on the card (CUDA events, warm-up, median of 25 runs): each path's
   step, the eager step (Modulator._modulate_impl) and the captured step
   (Modulator.modulate: inputs copied in, the graph replayed, its outputs
   cloned) in one process, each with its quartiles and range, the host's
   time to issue a step in the same runs, samples/s at the output rate and
   a torch.profiler breakdown, in each of its formats; the wall of the
   first step (warm-up, capture, replay), the device memory the graph
   holds after it (the caching allocator's, unused blocks released before
   and after) and the time to clone a step's outputs; the captured step
   again with the front end as the op chain in place of K5 (its output
   equal to the bit), the step before K5; each kernel (20 back-to-back calls a run, cycling
   through input sets larger than L2 together, and again on one input
   set; the card spins in torch.cuda._sleep while the host issues the
   calls, so the events see device time only, and the host's issue time
   is kept beside it; a call that synchronises, such as the plain CFR, is
   timed without the spin and marked host_paced), its plain version, one
   PyTorch library call as a yardstick where one computes the same
   function, and the kernel's bound from this run's shapes; K3 at both
   of the paths' rates, 8.192 and 3.072 MS/s; K4 writing planes (the
   kiss path's output at overlap 10) and writing words, and its planes
   followed by the unwindowed guard interval and the packing as torch ops
   (what its words spare a step at overlap 0); the kiss step at overlap
   0 ("realistic17_kiss_ov0", K4 writing the words) beside the path's
   step; K5 at TM I, 24 TFs, the 17 sub-channels, beside its plain
   version (the op chain) and its bytes bound; and the eager stages the
   DPD path adds (windowed guard interval, FIR, poly and LUT DPD), each
   alone at that path's shapes, beside its bytes bound.
6. Variant runs, each on the card against the CPU at 2 TFs a batch, two
   batches carrying the state, the 17-sub-channel ensemble, each printing
   what it checked: the LUT DPD (tests/test_filters.py:151-153's LUT,
   scale 2**31), u8 and s8 file output, the CIC equalizer (32.768 MHz),
   the frequency-domain resampler at 1.536 MS/s ("auto") and 4.096 MS/s
   ("fft"), the plain polyphase form at 2.5 MS/s (K3 launched no time),
   TII's old variant in TM II, the windowed guard interval in TM II-IV,
   modulate_traced's stage dumps of the DPD chain (the eager step), and a
   hot swap of FIR taps and poly coefficients with a digital gain change
   between two replays of one graph against a modulator built with the new
   values on the same state.  Each variant's card run is also held against
   the eager step on the card, to the bit.  K1's launches in these runs
   are counted (the warm-up and the capture a variant) and traced (the
   warm-up and two replays).
7. The fixed-point engines and the port as a program:
   * fft_engine=kiss at overlap 0 and 90 on the golden payloads, card ==
     CPU == the reference's goldens e2e_iq_fixed / e2e_iq_fixed_ov90, bit
     for bit; TM I at overlap 10 and TM II-IV at 2 TFs, card == CPU bit for
     bit; each card step's graph holds one K4 launch;
   * fft_engine=dexter in TM I and TM III at overlap 0 and 12: the card's
     Q1.14 symbols and the host chain's wire words == the CPU's; both
     engines' captured steps == their eager steps on the card;
   * the runtime in-process on the card (ModRuntime, its steps replaying
     the modulator's graphs as in phases 8 and 9, the 17-sub-channel
     ensemble, batch_tf=24, an ETI file of 4 batches, the file sink), for
     three INI files read with parse_ini: (a) s16 at 2.048 MS/s (K1),
     (b) CFR 40/3 at 8.192 MS/s, complexf (K2, K3), (c) kiss, s16; the
     kernel launches counted between a reset and a read around each run;
     the first 2 batches of each file against the same INI run by the
     runtime on the CPU (s16 within 1 LSB, f32 within 3e-5*max|ref|, kiss
     byte for byte); a second, warm run timed: ETI frames/s, x real time
     (an ETI frame is 24 ms), each pipeline stage's share of the wall,
     beside the step of Modulator.modulate alone from phase 5 (which also
     times the kiss path), and the main thread's read share of (a); one
     batch's ETI parse (96 frames of the 17-sub-channel multiplex) through
     parse_eti_frames (NumPy, what the runtime takes) and through the
     native library's parse, host ms, the fields equal;
   * `python -m dabmod_tpu_torch.cli <ini>` as a subprocess on the card
     (INI a, 2 batches): exit 0 and the in-process run's bytes.
8. The live inputs into the SDR sinks (ModRuntime in-process, INI files,
   the 17-sub-channel ensemble, batch_tf=24, a stream of 4 batches):
   (d) EDI over TCP (tests/live_stream.py's sender, the port's EDI
   encoder, timestamps 60 s ahead of the wall clock) into the DPD chain
   of realistic17_dpd_8m192, f32, out to the loopback SDR with the DPD
   feedback server and timestamps on (K2, K3); (e) ETI over TCP into an
   s16 SDR sink (output=dexter's wire and scale, the DEXTER driver
   replaced by a recording device) (K1).  Each: the kernel launches
   counted between a reset and a read; the transmitted frames of the
   first 2 batches against the CPU runtime's on the same stream, matched
   by timestamp (d: f32 within 1e-4*max|ref|, the timestamps equal and
   the EDI stream's) or FCT (e: within 1 LSB); the SDR counters (frames +
   overflows + dropped + muted) adding up to the TFs written; a warm run
   timed.  (d) also: chip_smoke's own feedback client gets a TX burst
   equal to the frame sent under its timestamp, and RX = gain*TX.
   (e) also: the pinned host memory Python references before and after
   the run, and the batch buffers the SDR queue's frames held at most;
   and a soak: (e) for 16 x 4 batches on one runtime, run 4 batches at a
   time, the pinned memory the host allocator holds and the pinned
   tensors Python references read after each run, and the most batches'
   output buffers alive at once counted (fails where the pool grows over
   the second half by more than that many output blocks, or the
   references grow over the runs).
   (f) partial batches: ETI over TCP with tcp_timeout=0.25 into (e)'s
   sink, its device replaced by one that plays each frame for a TF's time
   (96 ms) and counts an underflow where a frame comes after the one
   before has ended; the stream sends 24, 24, 5, 24 and 5 TFs, each once
   the one before is modulated, so each 5-TF chunk goes out as a partial
   batch at the read's timeout: the first captures a graph, the second
   replays it.  Each modulate call's wall (a capture's with the device
   memory it left held), the underflows by batch, the SDR counters
   adding up to the TFs sent.
9. The DPD control plane against the card (dabmod_tpu_torch/dpd/, gui.py;
   ModRuntime in a thread on realistic17_dpd_8m192's INI with the telnet
   RC, EDI over TCP released a batch at a time whenever the feedback
   server holds a request, the loopback SDR keeping 2 batches of frames
   and a PA of tests/test_sdr_dpd.py's compression and AM/PM at the
   chain's own peak): the GUI (make_handler) over chip_smoke's telnet
   stand-in for the ZeroMQ RC client (the card's machine has no pyzmq):
   /, /api/rc, /api/stats, /api/signal (a burst off the feedback port),
   then 3 poly iterations of its DPD panel (POST /api/dpd/start, polled
   on /api/dpd/status), then 2 iterations of run_engine with the LUT
   model.  Fails on an iteration that did not adapt, a reply other than
   HTTP 200, a poly swap that rebuilt, a LUT switch other than one
   rebuild then hot swaps, a poly fit without the PA's compression
   (gain at 0.6 above gain at 0.1 by 1 %) or phase (AM/PM at 0.7 above
   0.01 rad), a LUT whose magnitude does not grow with amplitude, K2 or
   K3 launched no time; the 24 TFs modulated after the last swap against
   the CPU runtime with the same LUT file on the same stream, within
   1e-4*max|ref| except samples that took the neighbouring LUT entry at
   a bin edge within the pre-DPD tolerance.  Prints each iteration's
   wall, split into measure, align, fit and RC swap, and the runtime's
   frames/s during the adaptation.
10. The TF-sharded step (dabmod_tpu_torch/parallel/: ShardedModulator over
   ranks spawned by parallel.launch.spawn, one process a rank, every
   kernel built in this process first): realistic17_dpd_8m192 (phase 4's
   chain and batches, K2 and K3) on 4 and on 2 gloo ranks sharing the
   card (CUDA tensors), with a new poly coefficient set swapped in through
   update_dpd between its two batches; main s16 at 2.048 MS/s on 2 gloo
   ranks (K1, num_clipped summed over the ranks); realistic17_dpd_8m192
   on 1 NCCL rank, and on 4 (one a card) where there are 4 cards.  Over
   gloo the sharded step runs eagerly; over NCCL each rank runs it twice,
   captured (ShardedModulator.compiled: a CUDA graph a batch size that
   holds the rank's kernels and its all_reduces) and eager, each main
   path under torch.profiler, and fails where it did not capture.  Each
   against the unsharded step on the card (Modulator.modulate, the
   captured graph) on the same batches (with the same swap):
   compare_batch's tolerances, every rank's state (TI history, res_carry,
   tf_index, mer_index) equal to the bit; an eager run's kernel launches
   (counted between a reset and a read around its run) its kernels once
   a batch; a captured run's counted launches each graph's warm-up and
   capture, its traced launches the warm-up and each replay, its
   collectives counted at the warm-up and the capture (twice the eager
   step's) and none at a replay, NCCL's all-reduce kernels in its trace
   (warm-up + replays) x the graph's collectives x the eager trace's
   kernels a collective, its output equal to the eager step's to the bit
   on every rank, and 300 more replays on the same inputs leaving the
   output unchanged and a barrier passing.  Prints which worlds ran over
   which backend, the sharded step's host wall per run and kind beside
   the unsharded step's, the collectives, buffer bytes and time of the
   eager exchanges inside the timed steps (parallel.EXCHANGES: counted
   in exchange_tails, timed with CUDA events around each) and their share
   of the step, and NCCL's all-reduce kernels a step and their device
   time from a trace of 5 steps.  Ranks that share one card measure
   correctness and the exchange's cost, not scaling.
11. bench_gpu.py's measurements in this process (its functions, at
   fewer steps a run): the default run (bench.py's step, TM I, the
   2-sub-channel ensemble, 24 TFs, captured and eager); --configs on
   "base (TM-I)", "realistic17 full" and the two resampler-route rows
   (the plain polyphase form at 2.5 MS/s, the frequency-domain form at
   8.192 MS/s); --stages (the eager step under torch.profiler, each
   device event under the stage range its launch was issued in) on "base
   (TM-I)", "realistic17 full" and "resamp 8.192M".  Fails where a
   config's first batch differs from the port on the CPU beyond
   compare_batch's tolerances, where a stage the config runs has no
   device time or launch, a range other than the config's is recorded,
   K1 or K2 runs under another stage than ofdm_ifft or K3 under another
   than resampler, "(other)" takes more than 5 % of the device time, or
   the stages' sum differs from the same trace's device busy time by
   more than 2 %.  Prints the phase's wall time.
12. The multi-rank tools in this process (bench_gpu.py's functions, at
   phase 11's steps a run), the 17-sub-channel ensemble at 24 TFs a rank:
   --scaling at world 1 (this process, the captured step of
   ShardedModulator with no process group), and on four cards also at
   worlds 2 and 4 (spawned NCCL ranks, one a card); --scaling --hosts:
   one separate process (--scaling-worker) joined through
   parallel.init_distributed over NCCL at a free port, on four cards
   2 x 2 processes; --collectives --full (bench_gpu's "base 2sub" and the
   JAX tool's "realistic17 full" at 4.096 MS/s, s16) on 2 gloo ranks
   sharing the card, on four cards 4 NCCL ranks, captured and eager.
   Fails where a rank's output differs from the unsharded eager step on
   its card beyond 3e-5*max|ref| or its state is not equal to the bit, a
   row did not run its launcher, the captured step over NCCL and one card
   a rank, a configuration's couplings are not its own (one all_reduce
   each a step, counted twice at a graph's warm-up and capture), or a
   rank's launches are not its eager steps' and its graphs' warm-ups and
   captures (counted) and its graphs' warm-ups and replays (traced).
   Prints each row and each coupling.

TF32 is switched off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False): every tolerance below assumes fp32
arithmetic.  The line before the last is one JSON object with the kernels'
numbers (and phase 5's steps, the eager stages' times and the runtime's,
the live phase's, the DPD loop's, the sharded runs' and phase 12's
records), labelled
with the card's name and power limit; the last is
{"ok": true, "device": {...}}.
"""
import itertools
import json
import logging
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
# upstream's fixed-point chain as doc/example.ini sets it (ofdmwindowing
# 10), the benchmark's r17_kiss_s16
KISS_OV10 = dict(fft_engine="kiss", ofdm_window_overlap=10)
POLY_AM = (1.0, 0.1, -0.05, 0.02, -0.01)    # tests/test_filters.py:133-134
POLY_PM = (0.02, -0.01, 0.005, 0.0, 0.0)
LUT_SCALE = 2.0 ** 31                       # tests/test_filters.py:151-153
DPD_REL = 1e-4        # f32 tolerance after the poly DPD, of max|ref|
VARIANT_TF = 2        # TFs a batch in phase 6

# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# 32-bit integer multiplies: 132 SMs x 64 a clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 1.98
# GHz
INT32_MUL_PER_S = 132 * 64 * 1.98e9


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
        if name == "kiss_ifft":
            check_kiss_instances(ptxas[name])
        if name == "frontend":
            check_frontend_instance(ptxas[name])
        log(f"    {name}: {json.dumps(ptxas[name])}")
    from dabmod_tpu_torch import native
    t0 = time.perf_counter()
    check(native.get_lib() is not None,
          "[1] the native host library (native/dabmod_native.cpp, g++) did "
          "not build or load: the RS decode and s16/u8/s8 conversion "
          "would take their NumPy branches")
    log(f"[1] native host library {os.path.relpath(native.library_path(), ROOT)} "
        f"built and loaded in {time.perf_counter() - t0:.1f} s (g++): the "
        f"EDI RS decode and the host format conversion take it")
    return card, ptxas


def check_kiss_instances(ptxas):
    """Each K4 instance (log2 N = 8..11): no spills, the threads and
    symbols a block that kiss_kernel assumes, at least one block resident
    an SM."""
    from dabmod_tpu_torch.ops import kiss_kernel as K4
    for log2n in range(8, 12):
        rec = ptxas.get(str(log2n))
        check(rec is not None, f"kiss_ifft: ptxas reports no instance "
              f"{log2n}")
        check(rec["spill_stores"] == 0, f"kiss_ifft {log2n}: "
              f"{rec['spill_stores']} bytes of spill stores")
        n = 1 << log2n
        rec.update(K4.launch_shape(n))
        check(rec["threads_per_block"] == K4.THREADS_PER_BLOCK
              and rec["symbols_per_block"] == K4.symbols_per_block(n)
              and rec["resident_blocks_per_sm"] >= 1,
              f"kiss_ifft N={n}: the source reports {rec}, kiss_kernel "
              f"assumes {K4.THREADS_PER_BLOCK} threads and "
              f"{K4.symbols_per_block(n)} symbols a block")


def check_frontend_instance(ptxas):
    """K5: no spills, the threads and carriers a block that
    frontend_kernel assumes, at least one block resident an SM."""
    from dabmod_tpu_torch.ops import frontend_kernel as K5
    rec = ptxas.get("")
    check(rec is not None, "frontend: ptxas reports no kernel")
    check(rec["spill_stores"] == 0, f"frontend: {rec['spill_stores']} "
          f"bytes of spill stores")
    rec.update(K5.launch_shape())
    check(rec["threads_per_block"] == K5.THREADS_PER_BLOCK
          and rec["carriers_per_block"] == K5.CARRIERS_PER_BLOCK
          and rec["resident_blocks_per_sm"] >= 1,
          f"frontend: the source reports {rec}, frontend_kernel assumes "
          f"{K5.THREADS_PER_BLOCK} threads and {K5.CARRIERS_PER_BLOCK} "
          f"carriers a block")


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
        kiss_table = check_kiss_kernel(torch, mode, f"{shape}", planes)
        if mode == 1:
            out["kiss"] = (planes, kiss_table)

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
            check_kiss_kernel(torch, mode, f"{n_sym} symbol(s)", small)
    out["resample_poly"] = phase_resampler(torch, rng)
    return out


def kiss_table(mode, device):
    """K4's table for one mode: the composed carrier->bin table composed
    again with KISS's input permutation."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.ops import kiss_kernel
    p = tables.mode_params(mode)
    return kiss_kernel.make_table(mode_table(mode, device), p.null_size,
                                  p.sym_size)


def check_kiss_kernel(torch, mode, tag, planes):
    """K4 on `planes` against its plain version on the CPU, bit for bit,
    writing the s16 words (cyclic prefixes included) and writing the int32
    planes; one launch counted a call.  Returns the mode's table on the
    card."""
    from dabmod_tpu_torch.ops import kiss_kernel as K4
    table, cpu_table = kiss_table(mode, "cuda"), kiss_table(mode, "cpu")
    host = tuple(x.cpu() for x in planes)
    for wire in (True, False):
        before = K4.kiss_ifft.launches
        got = K4.kiss_ifft(planes, table, wire)
        torch.cuda.synchronize()
        want = K4.kiss_ifft_plain(host, cpu_table, wire)
        got, want = ((got,), (want,)) if wire else (got, want)
        same = all(g.dtype == w.dtype == torch.int32
                   and torch.equal(g.cpu(), w) for g, w in zip(got, want))
        check(K4.kiss_ifft.launches == before + 1,
              f"kiss_ifft TM {mode} {tag}: the launch was not counted")
        check(same, f"kiss_ifft TM {mode} {tag} "
              f"{'words' if wire else 'planes'}: differs from the plain "
              f"version")
    log(f"[2] kiss_ifft TM {mode} N={table.n} {tag}, "
        f"{K4.symbols_per_block(table.n)} symbol(s) a block: words and "
        f"planes equal the plain version bit for bit")
    return table


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
    """Phase 3; returns check_frontend_kernel's inputs for phase 5."""
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
    return check_frontend_kernel(torch)


# K5's cases in phase 3: (TM, settings)
FRONTEND_CASES = ((1, dict(tii_enable=True, tii_comb=5, tii_pattern=31,
                           cic_eq_clock_rate=32_768_000)),
                  (1, {}), (2, dict(tii_enable=True, tii_comb=3,
                                    tii_pattern=12)), (3, {}), (4, {}))


def frontend_batches(torch, mode, tfs, n, seed):
    """n consecutive batches of `tfs` TFs of the 17-sub-channel ensemble,
    (fic, sub-channels) on the card."""
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.eti import (REALISTIC_MUX_SPECS, parse_eti_frames,
                                      synth_eti_batch)
    frames = tfs * tables.mode_params(mode).cif_count
    raw = synth_eti_batch(n * frames, mode=mode,
                          subch_specs=REALISTIC_MUX_SPECS, seed=seed)
    out = []
    for i in range(n):
        b = parse_eti_frames(raw[frames * i:frames * (i + 1)])
        out.append((torch.as_tensor(b.fic, device="cuda"),
                    tuple(torch.as_tensor(x, device="cuda")
                          for x in b.subchannels)))
    return out


def check_frontend_kernel(torch):
    """K5 against its plain version on the CPU, bit for bit (the symbol
    planes and the new history), FRONTEND_CASES on the 17-sub-channel
    ensemble, three chained batches of 24 TFs (TM I) or 4, and of 1 TF,
    the history and TF index carried; one launch counted a call.  Returns
    phase 5's inputs: the TM I modulator and its batches of 24 TFs."""
    from torch.utils._pytree import tree_leaves
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    from dabmod_tpu_torch.ops import frontend_kernel as K5
    out = None
    for mode, kw in FRONTEND_CASES:
        mods = {dev: Modulator(make_default_layout(mode, REALISTIC_MUX_SPECS),
                               ModSettings(dab_mode=mode, **kw), device=dev)
                for dev in ("cuda", "cpu")}
        for tfs in ((BATCH_TF if mode == 1 else 4), 1):
            batches = frontend_batches(torch, mode, tfs, 3, SEED + mode)
            hist = {dev: m.init_state()["ti_history"]
                    for dev, m in mods.items()}
            tf_index = 1
            for fic, subs in batches:
                res = {}
                for dev, m in mods.items():
                    before = K5.frontend.launches
                    res[dev] = K5.frontend(
                        fic.to(dev), tuple(x.to(dev) for x in subs),
                        hist[dev], torch.tensor(tf_index, dtype=torch.int32,
                                                device=dev), m._frontend)
                    torch.cuda.synchronize()
                    check(K5.frontend.launches - before
                          == (dev == "cuda"), f"[3] frontend TM {mode}: "
                          f"{K5.frontend.launches - before} launches counted")
                    hist[dev] = res[dev][1]
                g = [x.cpu().numpy() for x in tree_leaves(res["cuda"])]
                w = [x.numpy() for x in tree_leaves(res["cpu"])]
                check(len(g) == len(w) and all(
                    a.dtype == b.dtype and a.shape == b.shape
                    and a.tobytes() == b.tobytes() for a, b in zip(g, w)),
                    f"[3] frontend TM {mode} {kw} {tfs} TF(s): the kernel's "
                    f"planes or history differ from the plain version's")
                tf_index += tfs
            log(f"[3] frontend (K5) TM {mode} {sorted(kw) or 'plain'}, "
                f"{tfs} TF(s) x 3 chained batches, 17 sub-channels: planes "
                f"{tuple(res['cuda'][0][0].shape)} and history equal to the "
                f"plain version's, bit for bit")
            if mode == 1 and not kw and tfs == BATCH_TF:
                out = (mods["cuda"], batches)
    return out


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
    from dabmod_tpu_torch.ops import (frontend_kernel, kiss_kernel,
                                      ofdm_kernel, resampler_kernel)
    return {"ofdm_ifft": ofdm_kernel.ofdm_backend,
            "ofdm_cfr": ofdm_kernel.ofdm_cfr_backend,
            "resample_poly": resampler_kernel.resample,
            "kiss_ifft": kiss_kernel.kiss_ifft,
            "frontend": frontend_kernel.frontend}


def _bits(tree) -> list:
    """The tensors of a step's (output, stats, state) on the host, in
    pytree order."""
    from torch.utils._pytree import tree_leaves
    return [x.cpu().numpy() for x in tree_leaves(tree)]


def _same_bits(got, want) -> bool:
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and a.tobytes() == b.tobytes() for a, b in zip(got, want))


def eager_bits(torch, m, batches) -> list:
    """The eager step (Modulator._modulate_impl, no graph) of modulator m
    on the card over `batches` ((fic, subchannels) pairs), the state
    carried from init_state: _bits of each step.  Its kernel launches are
    the comparison's and are not counted: callers read the counts
    before."""
    state, res = m.init_state(), []
    for fic, subch in batches:
        with torch.no_grad():
            out, state, stats = m._modulate_impl(
                *m._batch(fic, subch), state, *m._gain_args(),
                m._apply_swaps())
        res.append(_bits((out, stats, state)))
    return res


def check_captured(tag, captured, eager):
    """The replayed graphs' steps against the eager steps: every output,
    stat and state tensor equal to the bit."""
    check(all(_same_bits(g, w) for g, w in zip(captured, eager))
          and len(captured) == len(eager),
          f"{tag}: the captured step differs from the eager step")


# each counted kernel's __global__ function, as a device trace names it
KERNEL_SYMBOLS = {"ofdm_ifft_kernel": "ofdm_ifft",
                  "ofdm_cfr_kernel": "ofdm_cfr",
                  "resample_poly": "resample_poly",
                  "kiss_ifft_kernel": "kiss_ifft",
                  "frontend_kernel": "frontend"}


def _kernel_of(event_name: str) -> str:
    """A device event's function name without its namespace, template
    arguments and parameters."""
    name = event_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split()[-1].split("::")[-1]


# NCCL's all-reduce kernels, as a device trace names them
# (ncclDevKernel_AllReduce_Sum_u8_RING_LL, ncclKernel_AllReduce_RING_LL_...)
NCCL_ALL_REDUCE = re.compile(r"^nccl\w*AllReduce")


def traced_launches(torch, fn, nccl=False):
    """fn() under torch.profiler, the card synchronised before and after:
    (its result, each counted kernel's launches on the card in the trace,
    keyed as _kernels()).  With nccl, also "nccl_all_reduce", NCCL's
    all-reduce kernels in the trace, "nccl_all_reduce_ms", their summed
    device time, and "nccl_all_reduce_each_ms", each one's in the order
    they started.  Fails where the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    dev = device_activity(torch, prof.events())
    check(len(dev) > 0, "torch.profiler traced no device event: the "
          "launches on the card are not measured")
    out = dict.fromkeys(KERNEL_SYMBOLS.values(), 0)
    each = []
    for e in dev:
        name = _kernel_of(e.name)
        k = KERNEL_SYMBOLS.get(name)
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


def check_graph_launches(tag, mods, counts, traced):
    """The launches of modulators `mods`' steps on the card.  The wrappers
    count a graph's warm-up and its capture (whose count is the graph's
    Captured.launches: the warm-up runs the same step); the trace must hold
    the warm-up's launches and the graph's at each of its replays.  Eager
    steps (no graph) launch what the wrappers count."""
    names = {f.__name__: k for k, f in _kernels().items()}
    graphs = [cap for m in mods for cap in m.compiled.graphs.values()]
    calls, on_card = dict.fromkeys(counts, 0), dict.fromkeys(counts, 0)
    for cap in graphs:
        for wrapper, n in cap.launches.items():
            calls[names[wrapper]] += 2 * n
            on_card[names[wrapper]] += (1 + cap.replays) * n
    if not graphs:
        calls = on_card = counts
    check(counts == calls, f"{tag}: the wrappers counted {counts}, not "
          f"each graph's warm-up and capture {calls}")
    check(traced == on_card, f"{tag}: launches on the card (trace) "
          f"{traced}, not the warm-ups' and the replays' {on_card}")


def _paths():
    """Each path: (ensembles, settings, kernels it must launch, formats)."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    r17 = (("realistic17", REALISTIC_MUX_SPECS),)
    return {
        "main": ((*r17, ("bench2", BENCH_SPECS)), {},
                 ("frontend", "ofdm_ifft"), ("f32", "s16")),
        "realistic17_cfr_8m192": (r17, CFR_8M192,
                                  ("frontend", "ofdm_cfr", "resample_poly"),
                                  ("f32", "s16")),
        "realistic17_cfr30_3m072": (r17, CFR30_3M072,
                                    ("frontend", "ofdm_cfr",
                                     "resample_poly"), ("f32", "s16")),
        "realistic17_dpd_8m192": (
            r17, dict(DPD_8M192, poly_coef_file=dpd_files()["poly"]),
            ("frontend", "ofdm_cfr", "resample_poly"), ("uhd",)),
        "realistic17_kiss": (r17, KISS_OV10, ("frontend", "kiss_ifft"),
                             ("s16",)),
    }


def phase_paths(torch):
    """Each path: two consecutive batch_tf=24 batches per (ensemble,
    format) on the card, state carried, against the port on the CPU on the
    same ETI, and against the eager step on the card (no graph) to the
    bit.  The wrappers count each graph's warm-up and capture; a
    torch.profiler trace of the card's run counts the launches on the card
    (the warm-ups and the replays).  Returns each kernel's count, summed
    over the card runs of the paths that use it, each path's counts and
    each path's launches on the card."""
    from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    from dabmod_tpu_torch.ops import ofdm_kernel

    kernels = _kernels()
    launches, per_path, on_card = {}, {}, {}
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
            outs, margins, mods = {}, {}, {}
            for name, specs, fmt, batches in cases:
                m = Modulator(make_default_layout(1, specs),
                              _settings(fmt, **extra), device=device)
                state = m.init_state()
                res, marg, bits = [], [], []
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
                    if device == "cuda":
                        bits.append(_bits((out, stats, state)))
                check(int(state["tf_index"]) == 2 * BATCH_TF,
                      f"{path}/{name}/{fmt}: tf_index "
                      f"{int(state['tf_index'])}")
                outs[(name, fmt)] = (res, m.tf_samples_out)
                margins[(name, fmt)] = marg
                mods[(name, fmt)] = (m, bits)
            return outs, margins, mods

        # the path on the card, between a reset and a read of the counts,
        # traced: the graphs' replays run no Python, so the trace counts
        # their launches on the card
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        (gpu, _, mods), traced = traced_launches(torch,
                                                 lambda: drive("cuda"))
        counts = {k: f.launches for k, f in kernels.items()}
        per_path[path], on_card[path] = counts, traced
        log(f"[4] {path} on the card: {len(cases)} x 2 batches in "
            f"{time.perf_counter() - t0:.1f} s (traced); kernel launches "
            f"{counts}, on the card {traced}")
        for m, _ in mods.values():
            check([c.replays for c in m.compiled.graphs.values()] == [2],
                  f"{path}: not one graph replayed twice a case")
        check_graph_launches(f"[4] {path}", [m for m, _ in mods.values()],
                             counts, traced)
        # the captured step against the eager step on the card
        for name, _specs, fmt, batches in cases:
            m, bits = mods[(name, fmt)]
            check_captured(f"[4] {path}/{name}/{fmt}", bits, eager_bits(
                torch, m, [(b.fic, tuple(b.subchannels)) for b in batches]))
        log(f"[4] {path}: the captured steps equal the eager steps on the "
            f"card to the bit (outputs, stats, state); the wrappers counted "
            f"each warm-up and capture, the trace each warm-up and replay")
        for k in used:
            check(counts[k] > 0, f"the {path} path never launched {k}")
            launches[k] = launches.get(k, 0) + counts[k]

        t0 = time.perf_counter()
        cpu, margins, _ = drive("cpu")
        log(f"[4] the same on the CPU (plain versions) in "
            f"{time.perf_counter() - t0:.1f} s")
        rel = DPD_REL if "poly_coef_file" in extra else 3e-5
        # the kiss chain is integer arithmetic from the Q1.14 carriers on
        lsb = 0 if extra.get("fft_engine") == "kiss" else 1
        for name, _specs, fmt, _b in cases:
            (g_res, n_out), (c_res, _) = gpu[(name, fmt)], cpu[(name, fmt)]
            for k, ((g, gs), (c, cs)) in enumerate(zip(g_res, c_res)):
                tag = f"{path}/{name}/{fmt} batch {k}"
                compare_batch(tag, fmt, g, gs, c, cs, n_out,
                              margins[(name, fmt)][k]
                              if extra.get("enable_cfr") else None,
                              rel, lsb=lsb)
                if extra.get("cfr_error_clip", np.inf) < 1.0:
                    check(int(cs["cfr_errclip"].min()) > 0,
                          f"{tag}: the error clip never acted in a TF")
    return launches, per_path, on_card


def compare_batch(tag, fmt, g, gs, c, cs, n_out, margin, rel=3e-5,
                  n_tf=BATCH_TF, lsb=1):
    """One batch of n_tf TFs of the card against the CPU: f32 within
    rel*max|ref| (3e-5, tests/test_ofdm_kernel.py:88-89: fp32 transforms
    and reductions in other orders; DPD_REL after the poly DPD), s16
    within `lsb` LSB (1: a float difference at a truncation edge; 0 for
    the kiss chain) with equal num_clipped; with CFR the clip counts within the threshold margin,
    PAPR within 1e-3 dB, MER within 0.1 dB (:96) and mer_valid equal.
    Returns the samples' largest difference and its tolerance."""
    check(set(gs) == set(cs), f"{tag}: stats keys {set(gs)} != {set(cs)}")
    if fmt in ("f32", "uhd"):
        for gp in g:
            check(gp.shape == (n_tf, n_out) and gp.dtype == np.float32,
                  f"{tag}: {gp.shape}")
            check(bool(np.isfinite(gp).all()), f"{tag}: not finite")
        scale = max(float(np.abs(x).max()) for x in c)
        err = max(float(np.abs(a - b).max()) for a, b in zip(g, c))
        tol = rel * scale
        log(f"    {tag}: max abs err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"{tag}: err {err} > {tol}")
        res = (err, tol)
    else:
        check(g.shape == (n_tf, n_out) and g.dtype == np.int32,
              f"{tag}: {g.shape} {g.dtype}")
        d = np.abs(g.view(np.int16).astype(np.int32)
                   - c.view(np.int16).astype(np.int32)).max()
        log(f"    {tag}: max int16 diff {d}, num_clipped "
            f"{int(gs['num_clipped'])} / {int(cs['num_clipped'])}")
        check(d <= lsb, f"{tag}: int16 diff {d} > {lsb}")
        check(int(gs["num_clipped"]) == int(cs["num_clipped"]),
              f"{tag}: num_clipped differs")
        res = (int(d), lsb)
    if margin is None:
        return res
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
    return res


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


def _device_memory(torch) -> tuple:
    """The caching allocator's reserved and allocated device memory, its
    unused blocks released first."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


def op_chain_modulator(*args, **kw):
    """A Modulator whose step runs the front end as the op chain
    (frontend_kernel.frontend_plain) on the card, as before K5: the
    captured step of the same settings without K5, for phase 5's
    comparison."""
    from dabmod_tpu_torch.models import Modulator
    from dabmod_tpu_torch.ops import fec, frontend_kernel

    class OpChain(Modulator):
        def _ofdm_symbols_impl(self, fic, subch, ti_history, tf_index,
                               time_interleave=fec.time_interleave_all):
            return frontend_kernel.frontend_plain(
                fic, subch, ti_history, tf_index, self._frontend,
                time_interleave)
    return OpChain(*args, **kw)


def time_path(torch, path, specs, extra, fmts):
    """One path on the 17-sub-channel ensemble, in each of its formats,
    timed three ways in one process: the eager step
    (Modulator._modulate_impl, keys "eager_<fmt>_..."), the captured
    step (Modulator.modulate, the graph's replay with its outputs cloned,
    keys "<fmt>_...") and the captured step with the front end as the op
    chain instead of K5 (op_chain_modulator, keys "opchain_<fmt>_...",
    its output equal to the bit); each: step time with its quartiles, the
    host's time to issue a step in the same runs, samples/s at the output
    rate and the profile.  With the graph's record ("<fmt>_graph"): the wall time
    of the first step (warm-up, capture, replay), the device memory the
    graph holds after it, the launches a replay runs, and the time to clone
    a step's outputs."""
    from torch.utils._pytree import tree_leaves, tree_map
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

        def eager():
            with torch.no_grad():
                _, state[0], _ = m._modulate_impl(
                    fic, subs, state[0], *m._gain_args(), m._apply_swaps())

        def step():
            _, state[0], _ = m.modulate(fic, subs, state[0])
        chain = op_chain_modulator(make_default_layout(1, specs),
                                   _settings(fmt, **extra), device="cuda")
        chain_state = [chain.init_state()]

        def chain_step():
            _, chain_state[0], _ = chain.modulate(fic, subs, chain_state[0])
        # the first step of the batch size (the eager warm-up, the
        # capture, a replay and the clones) on the host's clock, and the
        # device memory the caching allocator holds after it beyond what it
        # held before (its unused blocks released both times): the graph's
        # pool and static inputs
        r0, a0 = _device_memory(torch)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        r1, a1 = _device_memory(torch)
        n_out = BATCH_TF * m.tf_samples_out
        check(_same_bits(_bits(m.modulate(fic, subs, m.init_state())),
                         _bits(chain.modulate(fic, subs,
                                              chain.init_state()))),
              f"[5] {path}/{fmt}: the captured step with K5 differs from "
              f"the one with the front end's op chain")
        for key, fn in (("eager_", eager), ("", step),
                        ("opchain_", chain_step)):
            # the host's time to issue a step comes from the same runs:
            # equal to the step time when dispatch, not the card, sets the
            # pace
            runs, host = time_runs(torch, fn)
            ms = statistics.median(runs)
            q1, _, q3 = statistics.quantiles(runs, n=4)
            rec.update({
                f"{key}{fmt}_ms_per_step": ms,
                f"{key}{fmt}_ms_per_step_q1_q3": [q1, q3],
                f"{key}{fmt}_ms_per_step_range": [min(runs), max(runs)],
                f"{key}{fmt}_samples_per_s": n_out / (ms / 1e3),
                f"{key}{fmt}_host_issue_ms_per_step": statistics.median(host),
                f"{key}{fmt}_profile": profile_steps(torch, fn)})
        cap = m.compiled.graphs[BATCH_TF]
        clone, _ = time_runs(torch, lambda: tree_map(torch.clone,
                                                     cap.outputs))
        rec[f"{fmt}_graph"] = {
            "first_step_s": first_s,
            "reserved_bytes": r1 - r0, "allocated_bytes": a1 - a0,
            "launches_per_replay": cap.launches,
            "output_bytes": sum(x.numel() * x.element_size()
                                for x in tree_leaves(cap.outputs)),
            "clone_outputs_ms": statistics.median(clone)}
        rate = m.settings.output_rate
        rec[f"realtime_x_{fmt}"] = rec[f"{fmt}_samples_per_s"] / rate
        rec[f"eager_realtime_x_{fmt}"] = (rec[f"eager_{fmt}_samples_per_s"]
                                          / rate)
        rec[f"opchain_over_k5_{fmt}"] = (rec[f"opchain_{fmt}_ms_per_step"]
                                         / rec[f"{fmt}_ms_per_step"])
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


def time_frontend(torch, cpm, inputs, launches, ptxas):
    """K5 at the main path's shapes (TM I, 24 TFs, the 17-sub-channel
    ensemble), cycling through phase 3's batches; its plain version (the
    op chain, some 410 torch ops, host-paced) on the same inputs.  The
    bound counts the least bytes: the ETI payload and the history read,
    the planes and the new history written, the tables once."""
    from torch.utils._pytree import tree_leaves
    from dabmod_tpu_torch.ops import frontend_kernel as K5
    m, batches = inputs
    table = m._frontend
    hist = m.init_state()["ti_history"]
    tf0 = torch.zeros((), dtype=torch.int32, device="cuda")
    sets = [(fic, subs) for fic, subs in batches]

    def k5(x):
        return K5.frontend(*x, hist, tf0, table)

    def plain(x):
        return K5.frontend_plain(*x, hist, tf0, table)
    got, want = k5(sets[0]), plain(sets[0])
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want))),
          "frontend: the kernel differs from its plain version on the card")
    t = kernel_times(torch, {"": (k5, sets)}, cpm)
    plain_runs, _ = time_runs(torch, lambda: plain(sets[0]), n=5, warm=1)
    payload = sum(x.numel() for x in tree_leaves(sets[0]))
    hist_bytes = sum(h.numel() for h in hist)
    planes = sum(x.numel() * 4 for x in got[0])
    tables_bytes = sum(x.numel() * x.element_size() for x in (
        table.prbs, table.keep, table.cif_src, table.cif_filler,
        table.ref_q))
    nbytes = payload + 2 * hist_bytes + planes + tables_bytes
    B, S, C = got[0][0].shape
    k = {"name": "frontend", "route": "cuda",
         "source": "dabmod_tpu_torch/ops/csrc/frontend.cu",
         "replaces": "none: the front end's op chain (dabmod_tpu/ops/fec.py, "
                     "ops/ofdm.py are XLA ops, no Pallas kernel)",
         "launches": launches, "max_abs_err": 0,
         "ms": t["ms"], "plain_ms": statistics.median(plain_runs),
         **bound(nbytes, 0.0),
         "library_ms": None,
         "library_call": "none: no PyTorch call does the FEC chain",
         **{key: v for key, v in t.items()
            if key.endswith(("_warm_l2", "host_issue_ms", "host_paced"))},
         "l2_sets": len(sets), "shape": [B, S, C],
         "subchannels": len(hist), **ptxas[""]}
    log(f"[5] frontend {B}x{S}x{C}, {len(hist)} sub-channels: "
        f"{t['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms by bytes, "
        f"{nbytes / 1e6:.2f} MB; plain {k['plain_ms']:.4f} ms, host-paced; "
        f"one input set reused: {t['ms_warm_l2']:.4f} ms)")
    return k


def kiss_multiplies(n: int) -> int:
    """The int32 multiplies of one KISS fixed-point transform of size n:
    2 a C_FIXDIV and 4 a C_MUL, so 4 a point at a radix-2 stage and 5 a
    point at a radix-4 one (adds, shifts and wraps left out)."""
    from dabmod_tpu_torch.ops import kiss_fixed
    return sum({2: 4, 4: 5}[p] * n for p, _ in kiss_fixed.kf_factor(n))


def time_kiss_ifft(torch, cpm, sets, planes, table, launches, ptxas):
    """K4 writing int32 planes (the kiss path's output at a window
    overlap), writing the s16 words ("words_"), and its planes followed by
    the unwindowed guard interval and the packing as torch ops
    ("planes_gi_": what the words spare a step with no overlap); its
    plain version, host-paced (some 1,400 int32 ops a call).  The bound
    counts the least work: float32 carriers in, int16 pairs out, the
    tables once, or KISS's int32 multiplies at INT32_MUL_PER_S."""
    from dabmod_tpu_torch.ops import kiss_fixed, kiss_kernel as K4
    from dabmod_tpu_torch.ops.ofdm import guard_interval_unwindowed
    B, S, C = sets[0][0].shape
    n = table.n

    def planes_gi(x):
        return kiss_fixed.pack_words(*guard_interval_unwindowed(
            K4.kiss_ifft(x, table, False), table.null_size, table.sym_size))
    got = planes_gi(planes)
    check(torch.equal(got, K4.kiss_ifft(planes, table, True)),
          "kiss_ifft: its planes through the torch guard interval and "
          "packing differ from its words")
    t = kernel_times(torch, {
        "": (lambda x: K4.kiss_ifft(x, table, False), sets),
        "words_": (lambda x: K4.kiss_ifft(x, table, True), sets),
        "planes_gi_": (planes_gi, sets)}, cpm)
    plain, _ = time_runs(torch, lambda: K4.kiss_ifft_plain(planes, table,
                                                           False), n=5, warm=1)
    nbytes = B * S * C * 8 + B * S * n * 4 + 4 * (table.gather.numel()
                                                  + table.twiddle.numel())
    muls = B * S * kiss_multiplies(n)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_muls = muls / INT32_MUL_PER_S * 1e3
    k = {"name": "kiss_ifft", "route": "cuda",
         "source": "dabmod_tpu_torch/ops/csrc/kiss_ifft.cu",
         "replaces": "dabmod_tpu/ops/kiss_fixed.py::kiss_fft_fixed (int32 "
                     "XLA ops, no Pallas kernel)",
         "launches": launches, "max_abs_err": 0,
         "ms": t["ms"], "words_ms": t["words_ms"],
         "planes_gi_ms": t["planes_gi_ms"],
         "plain_ms": statistics.median(plain),
         "bound_ms": max(t_bytes, t_muls),
         "bound_by": "bytes" if t_bytes >= t_muls else "int32 multiplies",
         "library_ms": None,
         "library_call": "none: no PyTorch call does KISS's fixed-point "
                         "transform",
         **{key: v for key, v in t.items()
            if key.endswith(("_warm_l2", "host_issue_ms", "host_paced"))},
         "l2_sets": L2_SETS, "shape": [B, S, C, n],
         **ptxas[str(table.log2n)],
         "bytes": nbytes, "int32_multiplies": muls}
    log(f"[5] kiss_ifft {B}x{S} symbols, C={C}, N={n}: planes "
        f"{t['ms']:.4f} ms, words {t['words_ms']:.4f} ms, planes + torch "
        f"guard interval and packing {t['planes_gi_ms']:.4f} ms (bound "
        f"{k['bound_ms']:.4f} ms by {k['bound_by']}; plain "
        f"{k['plain_ms']:.4f} ms, host-paced; one input set reused: "
        f"{t['ms_warm_l2']:.4f} / {t['words_ms_warm_l2']:.4f} / "
        f"{t['planes_gi_ms_warm_l2']:.4f} ms)")
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


# K3's launches at each rate: those of the paths that run at it
K3_PATHS = {8_192_000: ("realistic17_cfr_8m192", "realistic17_dpd_8m192"),
            3_072_000: ("realistic17_cfr30_3m072",)}


def phase_times(torch, inputs, launches, ptxas):
    """Phase 5; `launches` is phase 4's (summed over paths, per path).
    Returns the eager stages' times and the kernels' records."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    total, per_path, _ = launches
    steps = {path: time_path(torch, path, ensembles[0][1], extra, fmts)
             for path, (ensembles, extra, _used, fmts) in _paths().items()}
    # the kiss engine's step with no window overlap: K4 writes the words
    steps["realistic17_kiss_ov0"] = time_path(
        torch, "realistic17_kiss_ov0", REALISTIC_MUX_SPECS,
        dict(fft_engine="kiss"), ("s16",))
    cpm = sleep_cycles_per_ms(torch)
    log(f"[5] torch.cuda._sleep: {cpm:.0f} cycles a ms")
    stages = time_dpd_stages(torch, cpm)
    planes, table, clip = inputs["ofdm"]
    sets = ofdm_timing_sets(torch, planes)
    calls = ofdm_calls(table, clip)
    kernels = [
        time_ofdm_ifft(torch, cpm, sets, table, calls["ofdm_ifft"],
                       inputs["ofdm_ifft"], total["ofdm_ifft"],
                       ptxas["ofdm_ifft"]),
        time_ofdm_cfr(torch, cpm, sets, table, calls["ofdm_cfr"], clip,
                      *inputs["ofdm_cfr"], total["ofdm_cfr"],
                      ptxas["ofdm_cfr"]),
        *[time_resample(torch, cpm, *inputs["resample_poly"][rate],
                        sum(per_path[p]["resample_poly"]
                            for p in K3_PATHS[rate]),
                        ptxas["resample_poly"])
          for rate in K3_TIMED_RATES],
        time_kiss_ifft(torch, cpm, sets, *inputs["kiss"], total["kiss_ifft"],
                       ptxas["kiss_ifft"]),
        time_frontend(torch, cpm, inputs["frontend"], total["frontend"],
                      ptxas["frontend"])]
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


def drive_both(torch, mode, settings, step=None, tag=""):
    """Two batches through a modulator on the card and one on the CPU,
    the state carried; `step(m, batch, state, device)` replaces
    modulate_eti.  The card's run is traced: its kernel launches are
    checked against the wrappers' counts (check_graph_launches), and where
    its steps replayed graphs, they are held against the eager step on
    the card, to the bit.
    Returns ({"cuda": [...], "cpu": [...]} of (output on the host, stats),
    the card's kernel launches as the wrappers counted them)."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    step = step or (lambda m, b, st, _dev: m.modulate_eti(b, st))
    kernels = _kernels()
    batches = _variant_batches(mode)

    def run(dev):
        m = Modulator(make_default_layout(mode, REALISTIC_MUX_SPECS),
                      settings, device=dev)
        state, res, bits = m.init_state(), [], []
        for b in batches:
            out, state, stats = step(m, b, state, dev)
            res.append((_to_host(out), {k: v.cpu().numpy()
                                        for k, v in stats.items()}))
            bits.append(_bits((out, stats, state)))
        return m, res, bits

    for k in kernels.values():
        k.launches = 0
    (m, res, bits), traced = traced_launches(torch, lambda: run("cuda"))
    counts = {k: f.launches for k, f in kernels.items()}
    check_graph_launches(f"[6] {tag}", [m], counts, traced)
    if m.compiled.graphs:
        check_captured(f"[6] {tag}", bits, eager_bits(
            torch, m, [(b.fic, tuple(b.subchannels)) for b in batches]))
    return {"cuda": res, "cpu": run("cpu")[1]}, counts


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
                                                      poly_coef_file=""),
                        tag=f"{name} before the DPD")
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
    outs, counts = drive_both(torch, mode, settings, tag=name)
    # K1 and K5 at the warm-up before the capture and at the capture (on
    # the card: the warm-up and two replays, drive_both's trace)
    check(counts == {"ofdm_ifft": 2, "ofdm_cfr": 0, "resample_poly": 0,
                     "kiss_ifft": 0, "frontend": 2},
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
    log(f"[6] {name}: kernel launches on the card {counts}; the captured "
        f"steps equal the eager steps to the bit")
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
    drive_both(torch, 1, settings, traced, tag="modulate_traced")
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
    """New FIR taps and poly coefficients swapped in, and the digital gain
    changed as the RC's `gain digital` changes it (the live settings),
    between two replays of one graph on the card: equal to a modulator
    built with them, on the same state; no second capture."""
    import dataclasses
    from torch.utils._pytree import tree_map
    from dabmod_tpu_torch import tables
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    taps2 = np.asarray(tables.DEFAULT_FIR_TAPS[::-1], np.float32)
    am2, pm2 = (0.9, 0.01, 0.0, 0.0, 0.0), (0.05, 0.0, 0.0, 0.0, 0.0)
    gain2 = 0.8
    d = _TMP[0]
    with open(os.path.join(d, "taps2.txt"), "w") as f:
        f.write(f"{taps2.size}\n" + "".join(f"{float(t)!r}\n"
                                            for t in taps2))
    with open(os.path.join(d, "poly2.coef"), "w") as f:
        f.write("1\n5\n" + "".join(f"{v!r}\n" for v in (*am2, *pm2)))
    s1 = _settings("uhd", **DPD_8M192, poly_coef_file=dpd_files()["poly"])
    s2 = dataclasses.replace(s1, filter_taps_file=os.path.join(d,
                                                               "taps2.txt"),
                             poly_coef_file=os.path.join(d, "poly2.coef"),
                             digital_gain=gain2)
    b1, b2 = _variant_batches(1)
    layout = make_default_layout(1, REALISTIC_MUX_SPECS)
    m = Modulator(layout, s1, device="cuda")
    _, st, _ = m.modulate_eti(b1, m.init_state())
    check(m.update_fir_taps(taps2) and m.update_dpd("poly", (am2, pm2)),
          "[6] hot swap refused")
    check(not m.update_fir_taps(taps2[:7]), "[6] a tap-count change was "
          "taken as a hot swap")
    m.settings.digital_gain = gain2
    st_f = tree_map(torch.clone, st)
    got, _, _ = m.modulate_eti(b2, st)
    fresh = Modulator(layout, s2, device="cuda")
    want, _, _ = fresh.modulate_eti(b2, st_f)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "[6] hot swap differs from a fresh modulator")
    check([c.replays for c in m.compiled.graphs.values()] == [2],
          "[6] the hot swap captured the step again")
    log("[6] hot swap of FIR taps and poly coefficients and a digital gain "
        "change between two replays of one graph on the card: equal to a "
        "fresh modulator built with them, on the same state; no second "
        "capture; a tap-count change refused")


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
    words on the host]}.  On the card the step's graph holds one K4
    launch, counted at its warm-up and its capture."""
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    from dabmod_tpu_torch.ops import kiss_kernel
    specs = BENCH_SPECS if mode == 1 else ((0, 24, 0x22),)
    s = ModSettings(dab_mode=mode, fft_engine="kiss", ofdm_window_overlap=ov)
    out = {}
    for dev in ("cuda", "cpu"):
        m = Modulator(make_default_layout(mode, specs), s, device=dev)
        state, res, bits = m.init_state(), [], []
        before = kiss_kernel.kiss_ifft.launches
        for fic, subs in batches:
            words, state, stats = m.modulate(fic, subs, state)
            check(int(stats["num_clipped"]) == 0, "kiss: num_clipped != 0")
            res.append(words.cpu().numpy())
            bits.append(_bits((words, stats, state)))
        if dev == "cuda":
            (cap,) = m.compiled.graphs.values()
            check(cap.launches["kiss_ifft"] == 1
                  and kiss_kernel.kiss_ifft.launches - before == 2,
                  f"[7] kiss TM {mode} overlap {ov}: K4 launched "
                  f"{kiss_kernel.kiss_ifft.launches - before} times, the "
                  f"graph holds {cap.launches['kiss_ifft']}")
            check_captured(f"[7] kiss TM {mode} overlap {ov}", bits,
                           eager_bits(torch, m, batches))
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
            f"({ref.size // 2} samples), bit for bit; captured == eager "
            f"on the card")
    for mode, ov in ((1, 10), (2, 90), (3, 63), (4, 0)):
        n = VARIANT_TF * tables.mode_params(mode).cif_count
        # _kiss_runs' ensemble: bench.py's in TM I, one sub-channel else
        specs = BENCH_SPECS if mode == 1 else ((0, 24, 0x22),)
        raw = synth_eti_batch(2 * n, mode=mode, subch_specs=specs,
                              seed=SEED + mode)
        batches = [(b.fic, tuple(b.subchannels)) for b in (
            parse_eti_frames(raw[:n]), parse_eti_frames(raw[n:]))]
        out = _kiss_runs(torch, mode, ov, batches)
        check(all(np.array_equal(g, c) for g, c in zip(out["cuda"],
                                                       out["cpu"])),
              f"[7] kiss TM {mode} overlap {ov}: card != CPU")
        log(f"[7] kiss TM {mode} overlap {ov} ({VARIANT_TF} TFs x 2 "
            f"batches): card == CPU, bit for bit; captured == eager on "
            f"the card")
    for mode, ov in ((1, 0), (1, 12), (3, 0), (3, 12)):
        p = tables.mode_params(mode)
        b = parse_eti_frames(synth_eti_batch(p.cif_count, mode=mode,
                                             seed=SEED + 8))
        s = ModSettings(dab_mode=mode, fft_engine="dexter",
                        ofdm_window_overlap=ov)
        got = {}
        for dev in ("cuda", "cpu"):
            m = Modulator(make_default_layout(mode), s, device=dev)
            step = m.modulate_eti(b, m.init_state())
            if dev == "cuda":
                check_captured(f"[7] dexter TM {mode} overlap {ov}",
                               [_bits((step[0], step[2], step[1]))],
                               eager_bits(
                                   torch, m, [(b.fic, b.subchannels)]))
            syms = step[0].cpu().numpy()
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
            f"(num_clipped {gn}); captured == eager on the card")
    log(f"[7] fixed-point engines passed in "
        f"{time.perf_counter() - t0:.1f} s")


RUNTIME_BATCHES = 4          # batches of BATCH_TF TFs in phase 7's ETI file
RUNTIME_COMPARED = 2         # of them, compared with the CPU runtime's
ETI_FRAME_S = 0.024


ETI_PARSE_RUNS = 20           # parses of one batch timed each way


def eti_parse_times(raw) -> dict:
    """One batch of ETI frames (the runtime's batch of the 17-sub-channel
    multiplex) through parse_eti_frames, the NumPy parser the runtime
    takes, and through the native library's parse (native.parse_eti_batch,
    which dabmod_tpu's parse_eti_frames tries first): host ms, median of
    ETI_PARSE_RUNS, the native result checked field by field against the
    NumPy batch.  Fails where the native library did not load."""
    from dabmod_tpu_torch import eti, native
    check(native.get_lib() is not None, "[7] the native host library did "
          "not load")

    def timed(parse):
        walls = []
        for _ in range(ETI_PARSE_RUNS):
            t0 = time.perf_counter()
            out = parse(raw)
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls), out
    t_numpy, b = timed(eti.parse_eti_frames)
    t_native, (mid, stc, fct, fp, mnsc, tist, fic, subs) = timed(
        native.parse_eti_batch)
    same = (mid == b.layout.mid
            and [sc for sc, _, _, _ in stc] == list(b.layout.scids)
            and [eti.SubchannelParams(sad, stl * 8, tpl)
                 for _, sad, stl, tpl in stc] == list(b.layout.subchannels)
            and all(np.array_equal(x, y) for x, y in (
                (fct, b.fct), (fp, b.fp), (mnsc, b.mnsc),
                (tist, b.tist_pps), (fic, b.fic)))
            and len(subs) == len(b.subchannels)
            and all(np.array_equal(x, y)
                    for x, y in zip(subs, b.subchannels)))
    check(same, "[7] the native ETI parse differs from the NumPy parse")
    log(f"[7] ETI parse of {raw.shape[0]} frames (one batch, "
        f"{len(b.subchannels)} sub-channels): NumPy (parse_eti_frames, "
        f"what the runtime takes) {t_numpy:.3f} ms, the native library's "
        f"parse {t_native:.3f} ms (host, median of {ETI_PARSE_RUNS}); "
        f"equal fields")
    return {"frames": raw.shape[0], "native": t_native, "numpy": t_numpy}


def _runtime_inis():
    """Phase 7's INIs: (modulator keys, other sections, file format, the
    kernels it must launch, the step of Modulator.modulate alone that
    phase 5 timed at the same settings)."""
    return {
        "a_main_s16": ("", "", "s16", ("frontend", "ofdm_ifft"),
                       ("main", "s16")),
        "b_cfr_8m192_complexf": (
            "rate=8192000\n", "[cfr]\nenable=1\nclip=40.0\nerrorclip=3.0\n",
            "complexf", ("frontend", "ofdm_cfr", "resample_poly"),
            ("realistic17_cfr_8m192", "f32")),
        "c_kiss_s16": ("fft_engine=kiss\n", "", "s16",
                       ("frontend", "kiss_ifft"),
                       ("realistic17_kiss_ov0", "s16")),
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
    parse = eti_parse_times(frames[:BATCH_TF * 4])
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
        interleaved = (rt.host_interleaved_batches,
                       rt_cpu.host_interleaved_batches)
        if fmt == "complexf":
            # the card's step makes the f32 pairs; the CPU's fetch thread
            # interleaves each batch's planes (dabmod_tpu's contract)
            check(interleaved == (0, rt_cpu.framecount // (BATCH_TF * 4)),
                  f"[7] {name}: batches interleaved on the host (card, "
                  f"CPU) {interleaved}")
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
            "read_share": rt_t.timings["read_s"] / wall_t,
            "vs_cpu": what, "cpu_frames_compared": rt_cpu.framecount,
            "host_interleaved_batches": interleaved}
        records[name] = rec
        log(f"[7] runtime {name}: {n_frames} ETI frames on the card, "
            f"launches {counts}; first {RUNTIME_COMPARED} batches vs the "
            f"CPU runtime: {what}; warm run {wall_t:.3f} s = "
            f"{fps:.1f} frames/s = {fps * ETI_FRAME_S:.2f}x real time "
            f"(cold {wall:.3f} s); modulate alone {step_ms:.3f} ms a step = "
            f"{modulate_fps:.1f} frames/s; main thread's read share "
            f"{rec['read_share']:.3f} (ETI parsed with NumPy); share of wall "
            f"{json.dumps(rec['share_of_wall'])}")
        for path in outs.values():
            os.remove(path)

    records["a_main_s16"]["eti_parse_ms"] = parse

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


# ---------------------------------------------------------------------------
# phase 8: the live inputs and the SDR sinks (ROADMAP A10(b))
# ---------------------------------------------------------------------------

LIVE_BATCHES = 4             # batches of BATCH_TF TFs a stream carries
LIVE_COMPARED = 2            # of them, compared with the CPU runtime's
LIVE_MARGIN_S = 60.0         # the EDI timestamps' lead on the wall clock
FB_SAMPLES = 32768           # samples the feedback client asks for: the
                             # NULL symbol (10,624 at 8.192 MS/s) and two
                             # symbols after it
FB_ATTEMPTS = 4              # requests before the client gives up
FB_TXGAIN, FB_RXGAIN = 10.0, 6.0     # dB; the loopback's RX gain is their sum


def _buffer_of(frame):
    """(address, bytes) of the whole buffer a frame views: the batch it
    was cut from (a numpy view of a host tensor, or an array)."""
    base = frame
    while isinstance(base, np.ndarray) and base.base is not None:
        base = base.base
    if isinstance(base, np.ndarray):
        return base.ctypes.data, base.nbytes
    storage = base.untyped_storage()        # a host tensor: no CUDA call
    return storage.data_ptr(), storage.nbytes()


def _record_device(dev, keep_tf, out=None):
    """Wrap dev.transmit_frame: every frame's (timestamp key, FCT) in
    order, and a copy of the first keep_tf frames and of every frame's
    first FB_SAMPLES samples; with `out` (the SdrOutput), the most bytes
    of batch buffers that the frames in its queue held at once."""
    rec = {"order": [], "frames": {}, "heads": {}, "held_bytes": 0}
    transmit = dev.transmit_frame

    def recording(samples, ts):
        if out is not None:
            held = dict(_buffer_of(f) for f, *_ in list(out.queue.queue))
            held.update([_buffer_of(samples)])
            rec["held_bytes"] = max(rec["held_bytes"], sum(held.values()))
        key = (int(ts.seconds), int(ts.pps)) if ts.valid else None
        fct = int(ts.fct)
        rec["order"].append((key, fct))
        tag = key if key is not None else fct
        if len(rec["order"]) <= keep_tf:
            rec["frames"][tag] = np.array(samples)
        rec["heads"][tag] = np.array(np.asarray(samples).reshape(
            -1, 2 if samples.dtype != np.int32 else 1)[:FB_SAMPLES])
        return transmit(samples, ts)

    dev.transmit_frame = recording
    return rec


def _feedback_client(port, result):
    """chip_smoke's own client of the DPD feedback server; the server waits
    5 s for the next frame and closes the connection without a reply if
    none came, so the client asks again, a few times."""
    from live_stream import feedback_request
    for _ in range(FB_ATTEMPTS):
        try:
            r = feedback_request(port, FB_SAMPLES)
        except OSError as e:
            result["error"] = repr(e)
            continue
        if r is None:
            result["error"] = "the server closed without a reply"
            continue
        result.pop("error", None)
        n, tx_key, tx, rx_key, rx = r
        result.update(n=n, tx_key=tx_key, rx_key=rx_key, tx=tx, rx=rx)
        return


def _dpd_chain_ini(coef):
    """realistic17_dpd_8m192's settings as INI lines after [modulator]'s
    gainmode and batch_tf (phases 8 (d) and 9): TII, CFR 40/3, window 90,
    the default FIR, 8.192 MS/s, the DPD file `coef`, synchronous
    delay management."""
    return ("rate=8192000\nofdmwindowing=90\n[cfr]\nenable=1\nclip=40.0\n"
            "errorclip=3.0\n[tii]\nenable=1\ncomb=5\npattern=31\n"
            "[firfilter]\nenabled=1\n[poly]\nenabled=1\n"
            f"polycoeffile={coef}\n"
            "[delaymanagement]\nsynchronous=1\noffset=0\n")


def _loopback_ini(dpd_port):
    return (f"[loopbackoutput]\nchannel=12C\ntxgain={FB_TXGAIN}\n"
            f"rxgain={FB_RXGAIN}\ndpd_port={dpd_port}\n")


def _live_ini(d, name, source, transport, extra, output):
    path = os.path.join(d, f"{name}.ini")
    with open(path, "w") as f:
        f.write(f"[input]\ntransport={transport}\nsource={source}\n"
                f"[modulator]\ngainmode=var\nbatch_tf={BATCH_TF}\n{extra}"
                f"{output}")
    return path


def _pinned_stats(torch) -> dict:
    """Pinned host memory: the bytes of the pinned tensors Python still
    references (counted here, one storage once), and the pinned host
    allocator's own statistics: allocated (its pool, handed out and
    cached) and active, current and peak."""
    import gc
    gc.collect()
    live = {}
    for o in gc.get_objects():
        if (isinstance(o, torch.Tensor) and o.device.type == "cpu"
                and o.is_pinned()):
            s = o.untyped_storage()
            live[s.data_ptr()] = s.nbytes()
    out = {"live_pinned_bytes": sum(live.values())}
    try:
        stats = torch.cuda.host_memory_stats()
    except (AttributeError, RuntimeError):
        return out          # a build without host memory statistics
    out.update({k: v for k, v in stats.items()
                if k.split(".")[0] in ("active_bytes", "allocated_bytes")
                and k.split(".")[-1] in ("current", "peak")
                or k in ("num_host_alloc", "num_host_free")})
    return out


def _run_live(torch, ini, device, batches, keep_tf, fb=None):
    """One run of the runtime on a live INI: ModRuntime.run(batches) on
    the main thread (the stream never ends by itself), with the SDR
    device's frames recorded; `fb` (a dict) runs the feedback client in a
    thread during the run.  Returns (wall s of run + close, the runtime,
    the record, the SdrOutput's counters); rt.run_s is the run's own time
    (run() flushes the sink's writes before it returns; close then stops
    the SDR device thread and the feedback server, whose socket waits tick
    at 0.2 and 0.5 s)."""
    import threading
    from dabmod_tpu_torch.config import parse_ini
    from dabmod_tpu_torch.runtime import ModRuntime
    s = parse_ini(ini)
    rt = ModRuntime(s, device=device)
    rec = _record_device(rt.output.device, keep_tf, rt.output)
    if s.output == "loopback":
        # the loopback keeps its last frames for the feedback server's RX
        # read; a batch queues BATCH_TF of them at once
        rt.output.device._hist_max = 2 * BATCH_TF
    th = None
    if fb is not None:
        th = threading.Thread(target=_feedback_client,
                              args=(s.sdr_dpd_port, fb), daemon=True)
        th.start()
    t0 = time.perf_counter()
    code = rt.run(batches)
    if device != "cpu":
        torch.cuda.synchronize()
    rt.run_s = time.perf_counter() - t0
    rt.close()
    wall = time.perf_counter() - t0
    if th is not None:
        th.join(timeout=30)
        check(not th.is_alive(), "[8] the feedback client did not finish")
    out = rt.output
    counters = {k: getattr(out, k) for k in
                ("frames", "queue_overflows", "dropped", "muted",
                 "underruns", "timestamp_discontinuities")}
    check(code == 0, f"[8] runtime on {ini} ({device}) exited {code}")
    check(out.fault is None, f"[8] {ini}: SDR device fault {out.fault!r}")
    check(rt.framecount == batches * BATCH_TF * 4,
          f"[8] {ini} ({device}): {rt.framecount} ETI frames modulated, "
          f"not {batches * BATCH_TF * 4}")
    n_tf = rt.framecount // 4
    check(counters["frames"] + counters["queue_overflows"]
          + counters["dropped"] + counters["muted"] == n_tf,
          f"[8] {ini} ({device}): counters {counters} do not add up to "
          f"the {n_tf} TFs written")
    return wall, rt, rec, counters


def _compare_live(name, got, ref, fmt):
    """The card's transmitted frames against the CPU's, matched by
    timestamp (or FCT where frames carry none): f32 within
    DPD_REL*max|ref| (the DPD path), s16 within 1 LSB."""
    common = sorted(set(got["frames"]) & set(ref["frames"]),
                    key=lambda k: (k is None, k))
    check(len(common) > 0, f"[8] {name}: no transmitted frame in common")
    worst = 0.0
    for k in common:
        g, r = got["frames"][k], ref["frames"][k]
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"[8] {name} {k}: {g.shape} {g.dtype} vs {r.shape} {r.dtype}")
        if fmt == "s16":
            d = int(np.abs(g.view(np.int16).astype(np.int32)
                           - r.view(np.int16)).max())
            check(d <= 1, f"[8] {name} {k}: int16 diff {d} > 1")
            worst = max(worst, d)
        else:
            check(bool(np.isfinite(g).all()), f"[8] {name}: not finite")
            tol = DPD_REL * float(np.abs(r).max())
            err = float(np.abs(g - r).max())
            check(err <= tol, f"[8] {name} {k}: err {err} > {tol}")
            worst = max(worst, err / tol)
    return common, worst


# (f): the ETI stream's batches in TFs, P the partial ones
PARTIAL_TF = 5
PARTIAL_CHUNKS = (BATCH_TF, BATCH_TF, PARTIAL_TF, BATCH_TF, PARTIAL_TF)
PARTIAL_TCP_TIMEOUT_S = 0.25
TF_S = 0.096                    # a transmission frame on air, TM I
UNDERFLOW_SLACK_S = 0.005       # a frame this late is the device thread's


def live_partial(torch):
    """Phase 8 (f): partial batches of a live stream into a sink that
    plays in real time.  ETI over TCP (tcp_timeout=PARTIAL_TCP_TIMEOUT_S)
    into the main path, s16, output=dexter with its driver replaced by a
    device that takes a TF's time on air for each frame (TF_S) and counts
    an underflow where a frame comes after the one before has ended.  The
    stream sends PARTIAL_CHUNKS, each once the runtime has modulated the
    one before: each partial chunk ends the read at the timeout, and the
    runtime sends a batch of PARTIAL_TF TFs: the first captures a graph,
    the second replays it.  Each modulate call's wall (a capture's with
    the device memory it left held) and the underflows by chunk."""
    import threading
    from dabmod_tpu_torch.config import parse_ini
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS, synth_eti_batch
    from dabmod_tpu_torch.io import sdr
    from dabmod_tpu_torch.models import Modulator
    from dabmod_tpu_torch.runtime import ModRuntime
    from live_stream import ChunkServer

    class PacedDevice(sdr.SdrDevice):
        """A DAC's pace: a frame plays for TF_S from when it arrives or
        when the one before ends, whichever is later; the device thread
        waits until then, as a blocking SDR write does."""

        def __init__(self, conf=None):
            self.n, self.gaps, self._end = 0, [], None

        def tune(self, lo_offset, frequency):
            pass

        def transmit_frame(self, samples, ts):
            now = time.monotonic()
            if self._end is not None and now > self._end + UNDERFLOW_SLACK_S:
                self.gaps.append((now, now - self._end))
            start = now if self._end is None else max(now, self._end)
            self._end = start + TF_S
            self.n += 1
            time.sleep(max(0.0, start - now))

    ends = np.cumsum(PARTIAL_CHUNKS) * 4          # ETI frames
    frames = synth_eti_batch(int(ends[-1]), mode=1,
                             subch_specs=REALISTIC_MUX_SPECS, seed=SEED + 9)
    srv = ChunkServer([frames[a:b].tobytes()
                       for a, b in zip((0, *ends[:-1]), ends)])
    d = _TMP[0]
    ini = os.path.join(d, "f_partial.ini")
    with open(ini, "w") as f:
        f.write(f"[input]\ntransport=tcp\nsource=tcp://127.0.0.1:"
                f"{srv.port}\ntcp_timeout={PARTIAL_TCP_TIMEOUT_S}\n"
                f"[modulator]\ngainmode=var\nbatch_tf={BATCH_TF}\n"
                f"[dexteroutput]\n")
    calls = []
    modulate = Modulator.modulate

    def timed(m, fic, subch, state):
        tfs = fic.shape[0] // m.p.cif_count
        new = tfs not in m.compiled.graphs
        if new:
            r0, a0 = _device_memory(torch)
        t0 = time.perf_counter()
        out = modulate(m, fic, subch, state)
        rec = {"tfs": tfs, "captured": new,
               "wall_s": time.perf_counter() - t0, "end": time.monotonic()}
        if new:
            r1, a1 = _device_memory(torch)
            rec.update(reserved_bytes=r1 - r0, allocated_bytes=a1 - a0)
        calls.append(rec)
        return out

    kernels = _kernels()
    driver = sdr.DexterDevice
    sdr.DexterDevice = PacedDevice
    Modulator.modulate = timed
    stop = threading.Event()
    try:
        for k in kernels.values():
            k.launches = 0
        rt = ModRuntime(parse_ini(ini), device="cuda")

        def release():
            for k in range(len(ends)):
                srv.release()
                while (rt.framecount < ends[k] and not stop.is_set()):
                    time.sleep(0.002)
        th = threading.Thread(target=release, daemon=True)
        th.start()
        t0 = time.perf_counter()
        code = rt.run(len(PARTIAL_CHUNKS))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = {k: f.launches for k, f in kernels.items()}
        rt.close()
        stop.set()
        th.join(timeout=10)
    finally:
        Modulator.modulate = modulate
        sdr.DexterDevice = driver
        srv.close()
    out, dev = rt.output, rt.output.device
    check(code == 0 and out.fault is None,
          f"[8] (f): runtime exited {code}, SDR fault {out.fault!r}")
    check(counts["ofdm_ifft"] > 0, "[8] (f) never launched ofdm_ifft")
    check([c["tfs"] for c in calls] == list(PARTIAL_CHUNKS),
          f"[8] (f): batches of {[c['tfs'] for c in calls]} TFs, not "
          f"{list(PARTIAL_CHUNKS)}")
    graphs = rt.modulator.compiled.graphs
    check(sorted(graphs) == sorted({BATCH_TF, PARTIAL_TF})
          and graphs[PARTIAL_TF].replays == 2,
          f"[8] (f): graphs {sorted(graphs)}, not one for {PARTIAL_TF} "
          f"TFs replayed twice")
    n_tf = int(ends[-1]) // 4
    counters = {k: getattr(out, k) for k in
                ("frames", "queue_overflows", "dropped", "muted",
                 "underruns")}
    check(counters["frames"] + counters["queue_overflows"]
          + counters["dropped"] + counters["muted"] == n_tf
          and dev.n == counters["frames"],
          f"[8] (f): counters {counters} do not add up to {n_tf} TFs")
    # each underflow under the batch whose frames came late: the last one
    # modulated before the gap was seen
    done = [c.pop("end") for c in calls]
    by_chunk = [0] * len(PARTIAL_CHUNKS)
    for at, _gap in dev.gaps:
        by_chunk[max(sum(t <= at for t in done) - 1, 0)] += 1
    rec = {"input": "eti/tcp", "tcp_timeout_s": PARTIAL_TCP_TIMEOUT_S,
           "output": "sdr (paced device)", "format": "s16",
           "output_rate": rt.settings.output_rate, "launches": counts,
           "chunks_tf": list(PARTIAL_CHUNKS), "tf_s": TF_S,
           "sdr_queue_tf": sdr.FRAMES_MAX_SIZE_UNSYNC,
           "modulate_calls": calls, "run_s": run_s,
           "underflows": len(dev.gaps), "underflows_by_chunk": by_chunk,
           "underflow_gaps_s": [g for _, g in dev.gaps],
           "counters": counters}
    log(f"[8] (f) partial batches into a paced SDR: {json.dumps(rec)}")
    return rec


def phase_live(torch):
    """Phase 8: the live inputs into the SDR sinks, the 17-sub-channel
    ensemble, batch_tf=24, LIVE_BATCHES batches a stream.
    (d) EDI over TCP (the port's encoder in a sender thread, which is the
    TCP server) into realistic17_dpd_8m192's settings, f32, out to the
    loopback SDR with the DPD feedback server, timestamps on; (e) ETI over
    TCP into an s16 SdrOutput (output=dexter's wire and scale, its driver
    replaced by a recording device).  Each: kernel launches between a
    reset and a read; the transmitted frames against the CPU runtime's on
    the same stream over LIVE_COMPARED batches, matched by timestamp
    (EDI) or FCT (ETI); the SDR counters adding up to the TFs written;
    a warm run timed.  (d) also: chip_smoke's own feedback client gets a
    TX burst equal to the frame sent under its timestamp, and RX =
    gain*TX.  (e) also: pinned host memory before and after.  Then (f),
    live_partial."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS, synth_eti_batch
    from dabmod_tpu_torch.io import sdr
    from live_stream import (FRAME_TICKS, PPS_HZ, TcpServer, edi_stream,
                             free_port)
    t_phase = time.perf_counter()
    poly = dpd_files()["poly"]
    d = tempfile.mkdtemp(prefix="chip_smoke_live_")
    _TMP.append(d)
    frames = synth_eti_batch(LIVE_BATCHES * BATCH_TF * 4, mode=1,
                             subch_specs=REALISTIC_MUX_SPECS, seed=SEED + 8)
    n_tf = LIVE_BATCHES * BATCH_TF
    keep = LIVE_COMPARED * BATCH_TF
    kernels = _kernels()
    records = {}

    # (d) EDI over TCP -> DPD chain -> loopback SDR + feedback server
    t0 = time.time() + LIVE_MARGIN_S
    t_enc = time.perf_counter()
    edi = TcpServer(b"".join(edi_stream(frames, t0)))
    enc_s = time.perf_counter() - t_enc
    dpd = _dpd_chain_ini(poly)
    src = f"tcp://127.0.0.1:{edi.port}"
    name = "d_edi_dpd_8m192_loopback"
    try:
        for k in kernels.values():
            k.launches = 0
        fb = {}
        ini = _live_ini(d, name, src, "edi", dpd,
                        _loopback_ini(free_port()))
        wall, rt, got, counters = _run_live(torch, ini, "cuda",
                                            LIVE_BATCHES, keep, fb)
        counts = {k: f.launches for k, f in kernels.items()}
        for k in ("ofdm_cfr", "resample_poly"):
            check(counts[k] > 0, f"[8] {name} never launched {k}")
        check(counters["frames"] == n_tf and counters["dropped"] == 0,
              f"[8] {name}: counters {counters}, {n_tf} TFs sent")
        _, rt_cpu, ref, _ = _run_live(
            torch, _live_ini(d, name + "_cpu", src, "edi", dpd,
                             _loopback_ini(free_port())),
            "cpu", LIVE_COMPARED, keep)
        common, worst = _compare_live(name, got, ref, "f32")
        check(rt.host_interleaved_batches == 0
              and rt_cpu.host_interleaved_batches == LIVE_COMPARED,
              f"[8] {name}: batches interleaved on the host: card "
              f"{rt.host_interleaved_batches}, CPU "
              f"{rt_cpu.host_interleaved_batches}")
        got_keys = [k for k, _ in got["order"][:keep]]
        ref_keys = [k for k, _ in ref["order"][:keep]]
        check(None not in got_keys and got_keys == ref_keys,
              f"[8] {name}: the card's timestamps differ from the CPU's")
        check(len(common) == keep, f"[8] {name}: {len(common)} of {keep} "
              f"frames matched by timestamp")
        # the EDI timestamps: frame 4k's time, 96 ms a TF
        want = [(int(t0) + (int(round((t0 % 1) * PPS_HZ))
                            + 4 * i * FRAME_TICKS) // PPS_HZ,
                 (int(round((t0 % 1) * PPS_HZ)) + 4 * i * FRAME_TICKS)
                 % PPS_HZ) for i in range(n_tf)]
        check([k for k, _ in got["order"]] == want,
              f"[8] {name}: the transmitted timestamps are not the EDI "
              f"stream's")
        # the feedback client's burst
        check("error" not in fb, f"[8] feedback client: {fb.get('error')}")
        check(fb["n"] == FB_SAMPLES and fb["tx_key"] in got["heads"],
              f"[8] feedback: {fb['n']} samples at {fb['tx_key']}, not a "
              f"transmitted frame's timestamp")
        tx_ref = got["heads"][fb["tx_key"]]
        check(np.array_equal(fb["tx"], tx_ref)
              and float(np.abs(tx_ref).max()) > 0,
              "[8] feedback TX burst != the frame sent at its timestamp, "
              "or silent")
        gain = 10.0 ** ((FB_TXGAIN + FB_RXGAIN) / 20.0)
        fb_err = float(np.abs(fb["rx"] - gain * fb["tx"]).max())
        check(fb["rx_key"] == fb["tx_key"]
              and fb_err <= 1e-6 * gain * float(np.abs(fb["tx"]).max()),
              f"[8] feedback RX != gain*TX (err {fb_err})")
        # the warm run, timed
        wall_t, rt_t, _, counters_t = _run_live(
            torch, _live_ini(d, name + "_timed", src, "edi", dpd,
                             _loopback_ini(free_port())),
            "cuda", LIVE_BATCHES, 0)
    finally:
        edi.close()
    fps = n_tf * 4 / wall_t
    records[name] = {
        "input": "edi/tcp", "output": "loopback", "format": "f32",
        "output_rate": rt.settings.output_rate, "eti_frames": n_tf * 4,
        "batches": LIVE_BATCHES, "batch_tf": BATCH_TF, "launches": counts,
        "encode_s": enc_s, "cold_wall_s": wall, "wall_s": wall_t,
        "frames_per_s": fps, "realtime_x": fps * ETI_FRAME_S,
        "run_s": rt_t.run_s, "run_frames_per_s": n_tf * 4 / rt_t.run_s,
        "share_of_run": {k: v / rt_t.run_s for k, v in
                         rt_t.timings.items()},
        "counters": counters_t, "cpu_frames_compared": len(common),
        "max_err_over_tol": worst,
        "feedback": {"samples": fb["n"], "tx_timestamp": fb["tx_key"],
                     "gain": gain, "max_abs_err": fb_err}}
    log(f"[8] {name}: {n_tf * 4} ETI frames as EDI/TCP (encoded in "
        f"{enc_s:.2f} s), launches {counts}; {len(common)} TFs vs the CPU "
        f"runtime matched by timestamp, max err {worst:.3f} of the "
        f"tolerance, timestamps equal; feedback burst of {fb['n']} samples "
        f"at {fb['tx_key']}: TX == the frame sent, RX == {gain:.4f} x TX "
        f"(max err {fb_err:.2e}); warm run {wall_t:.3f} s = {fps:.1f} "
        f"frames/s = {fps * ETI_FRAME_S:.2f}x real time (cold {wall:.3f} "
        f"s); the run before close {rt_t.run_s:.3f} s = "
        f"{n_tf * 4 / rt_t.run_s:.1f} frames/s = "
        f"{n_tf * 4 / rt_t.run_s * ETI_FRAME_S:.2f}x real time; counters "
        f"{counters_t}; share of the run "
        f"{json.dumps(records[name]['share_of_run'])}")

    # (e) ETI over TCP -> main path, s16 -> SdrOutput over a recording
    # device (dexter's wire and scale; its driver replaced)
    class RecordingDevice(sdr.SdrDevice):
        def __init__(self, conf=None):
            self.n = 0

        def tune(self, lo_offset, frequency):
            self.lo_offset, self.frequency = lo_offset, frequency

        def transmit_frame(self, samples, ts):
            self.n += 1

    eti = TcpServer(frames.tobytes())
    name = "e_tcp_s16_sdr"
    src = f"tcp://127.0.0.1:{eti.port}"
    driver = sdr.DexterDevice
    sdr.DexterDevice = RecordingDevice
    try:
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        try:
            torch.cuda.reset_peak_host_memory_stats()
        except (AttributeError, RuntimeError):
            pass            # a build without host memory statistics
        pinned_before = _pinned_stats(torch)
        ini = _live_ini(d, name, src, "tcp", "", "[dexteroutput]\n")
        wall, rt, got, counters = _run_live(torch, ini, "cuda",
                                            LIVE_BATCHES, keep)
        counts = {k: f.launches for k, f in kernels.items()}
        check(counts["ofdm_ifft"] > 0, f"[8] {name} never launched "
              f"ofdm_ifft")
        check(got["held_bytes"] <= 2 * BATCH_TF * 196_608 * 4,
              f"[8] {name}: the SDR queue's frames held "
              f"{got['held_bytes']} B of batch buffers, more than 2 "
              f"batches")
        del rt
        pinned_after = _pinned_stats(torch)
        _, _, ref, _ = _run_live(
            torch, _live_ini(d, name + "_cpu", src, "tcp", "",
                             "[dexteroutput]\n"), "cpu", LIVE_COMPARED,
            keep)
        common, worst = _compare_live(name, got, ref, "s16")
        wall_t, rt_t, _, counters_t = _run_live(
            torch, _live_ini(d, name + "_timed", src, "tcp", "",
                             "[dexteroutput]\n"), "cuda", LIVE_BATCHES, 0)
    finally:
        sdr.DexterDevice = driver
        eti.close()
    batch_bytes = BATCH_TF * 196_608 * 4        # s16 wire words a batch
    # what stays referenced after close is the last batch's statistics
    # (rt.last_stats, a few bytes), not its I/Q
    check(pinned_after["live_pinned_bytes"]
          <= pinned_before["live_pinned_bytes"] + (1 << 20),
          f"[8] {name}: pinned host memory still referenced after the "
          f"run: {pinned_before} -> {pinned_after}")
    fps = n_tf * 4 / wall_t
    records[name] = {
        "input": "eti/tcp", "output": "sdr (recording device)",
        "format": "s16", "output_rate": 2_048_000, "eti_frames": n_tf * 4,
        "batches": LIVE_BATCHES, "batch_tf": BATCH_TF, "launches": counts,
        "cold_wall_s": wall, "wall_s": wall_t, "frames_per_s": fps,
        "realtime_x": fps * ETI_FRAME_S,
        "run_s": rt_t.run_s, "run_frames_per_s": n_tf * 4 / rt_t.run_s,
        "share_of_run": {k: v / rt_t.run_s for k, v in
                         rt_t.timings.items()},
        "counters": counters, "counters_timed": counters_t,
        "cpu_frames_compared": len(common), "max_int16_diff": worst,
        "pinned_before": pinned_before, "pinned_after": pinned_after,
        "sdr_queue_held_bytes": got["held_bytes"],
        "pool_growth_bytes": (
            pinned_after["allocated_bytes.current"]
            - pinned_before["allocated_bytes.current"]
            if "allocated_bytes.current" in pinned_before else None)}
    log(f"[8] {name}: {n_tf * 4} ETI frames over TCP, launches {counts}; "
        f"{len(common)} TFs vs the CPU runtime matched by FCT, max int16 "
        f"diff {worst:.0f}; counters {counters} (timed run "
        f"{counters_t}); pinned host memory {pinned_before} -> "
        f"{pinned_after} (the allocator's pool grew "
        f"{records[name]['pool_growth_bytes']} B; the SDR queue's frames "
        f"held at most {got['held_bytes']} B of batch buffers, "
        f"{got['held_bytes'] / batch_bytes:.2f} batches); warm run {wall_t:.3f} s = {fps:.1f} frames/s = "
        f"{fps * ETI_FRAME_S:.2f}x real time (cold {wall:.3f} s); the run "
        f"before close {rt_t.run_s:.3f} s = {n_tf * 4 / rt_t.run_s:.1f} "
        f"frames/s = {n_tf * 4 / rt_t.run_s * ETI_FRAME_S:.2f}x real time; "
        f"share of the run {json.dumps(records[name]['share_of_run'])}")
    records["e_pinned_soak"] = live_pinned_soak(torch, d, RecordingDevice)
    records["f_tcp_partial_paced_sdr"] = live_partial(torch)
    log(f"[8] live phase passed in {time.perf_counter() - t_phase:.1f} s")
    return records


PINNED_QUARTERS = 16         # the soak's runs of LIVE_BATCHES batches each


def live_pinned_soak(torch, d, device_cls) -> dict:
    """(e) for PINNED_QUARTERS x LIVE_BATCHES batches on one runtime: ETI
    over TCP into the s16 SDR sink over a recording device, run() a
    quarter at a time, the pinned host memory read after each quarter
    (_pinned_stats, the card synchronised), and the batches' pinned output
    buffers (the runtime's _download) alive at once counted, the most of
    them kept.  The host allocator keeps a block for reuse once its tensor
    is gone, so its pool (allocated_bytes) rises to the most blocks in use
    at once and stays there, where a leak adds blocks at a rate.  Fails
    where the pool grows over the second half of the soak by more than
    the most output blocks that were alive at once, where the pinned
    tensors Python references grow after the first quarter, or where
    Python still references pinned memory after close.  The allocator's
    active_bytes counter is reported, not checked: in torch 2.11 it rises
    by about a block each batch and passes allocated_bytes, which by the
    allocator's own definition holds it."""
    import weakref
    from dabmod_tpu_torch.config import parse_ini
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS, synth_eti_batch
    from dabmod_tpu_torch.io import sdr
    from dabmod_tpu_torch.runtime import ModRuntime
    from live_stream import TcpServer
    n_batches = PINNED_QUARTERS * LIVE_BATCHES
    frames = synth_eti_batch(n_batches * BATCH_TF * 4, mode=1,
                             subch_specs=REALISTIC_MUX_SPECS, seed=SEED + 9)
    # a batch's s16 wire words, in the block the allocator gives them (a
    # request rounded up to a power of two)
    out_bytes = BATCH_TF * 196_608 * 4
    block = 1 << (out_bytes - 1).bit_length()
    srv = TcpServer(frames.tobytes())
    driver = sdr.DexterDevice
    sdr.DexterDevice = device_cls
    kernels = _kernels()
    alive, most = {}, [0]

    def counted(download):
        """_download, with the batches' output buffers alive counted."""
        def f(x):
            host = download(x)
            if host.nbytes >= out_bytes:
                # the storage: numpy views of the buffer outlive the tensor
                st = host.untyped_storage()
                key = id(st)
                alive[key] = weakref.ref(
                    st, lambda _, k=key: alive.pop(k, None))
                most[0] = max(most[0], len(alive))
            return host
        return f
    try:
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        before = _pinned_stats(torch)
        ini = _live_ini(d, "e_pinned_soak", f"tcp://127.0.0.1:{srv.port}",
                        "tcp", "", "[dexteroutput]\n")
        rt = ModRuntime(parse_ini(ini), device="cuda")
        rt._download = counted(rt._download)
        quarters = []
        t0 = time.perf_counter()
        for q in range(PINNED_QUARTERS):
            code = rt.run(LIVE_BATCHES)
            torch.cuda.synchronize()
            check(code == 0, f"[8] pinned soak: quarter {q} exited {code}")
            check(rt.framecount == (q + 1) * LIVE_BATCHES * BATCH_TF * 4,
                  f"[8] pinned soak: {rt.framecount} ETI frames after "
                  f"quarter {q}")
            quarters.append(_pinned_stats(torch))
        wall = time.perf_counter() - t0
        rt.close()
        del rt
        after = _pinned_stats(torch)
    finally:
        sdr.DexterDevice = driver
        srv.close()
    counts = {k: f.launches for k, f in kernels.items()}
    in_flight = most[0]
    check(in_flight >= 1, "[8] pinned soak: no output buffer was counted")
    half = PINNED_QUARTERS // 2
    rec = {"input": "eti/tcp", "output": "sdr (recording device)",
           "format": "s16", "output_rate": 2_048_000,
           "batches": n_batches, "batch_tf": BATCH_TF, "launches": counts,
           "wall_s": wall, "pinned_before": before,
           "pinned_quarters": quarters, "pinned_after": after,
           "output_block_bytes": block, "outputs_in_flight_max": in_flight}
    key = "allocated_bytes.current"
    if key in before:
        pool = [p[key] for p in quarters]
        active = [p.get("active_bytes.current") for p in quarters]
        growth = pool[-1] - pool[half - 1]
        rec["pool_growth_second_half_bytes"] = growth
        slope = ((active[-1] - active[0]) / ((PINNED_QUARTERS - 1)
                                            * LIVE_BATCHES)
                 if None not in active else None)
        rec["active_bytes_per_batch"] = slope
        log(f"[8] pinned soak: {n_batches} batches of (e) on one runtime in "
            f"{wall:.2f} s; at most {in_flight} batches' output buffers "
            f"({block} B blocks) alive at once; the pinned memory the host "
            f"allocator holds (allocated_bytes) {before[key]} B before, "
            f"{pool} after each quarter of {LIVE_BATCHES} batches, "
            f"{after[key]} after close, grown {growth} B over the second "
            f"half ({half * LIVE_BATCHES} batches; bound {in_flight} "
            f"blocks); cudaHostAlloc calls "
            f"{[p.get('num_host_alloc') for p in quarters]}, frees "
            f"{[p.get('num_host_free') for p in quarters]}; its "
            f"active_bytes counter {active} ({slope} B a batch, against "
            f"allocated_bytes {pool[-1]}); Python references "
            f"{[p['live_pinned_bytes'] for p in quarters]} B")
        check(growth <= in_flight * block,
              f"[8] pinned soak: the pinned pool grew {growth} B over the "
              f"second half ({pool}), more than the {in_flight} output "
              f"blocks that were alive at once: it leaks pinned memory")
    else:
        log("[8] pinned soak: this torch has no host memory statistics; "
            "the pinned allocator's pool is not measured")
    held = [p["live_pinned_bytes"] for p in quarters]
    check(max(held[1:]) <= held[0] + block,
          f"[8] pinned soak: the pinned tensors Python references grow "
          f"over the quarters, {held}: the runtime leaks pinned memory")
    check(after["live_pinned_bytes"] <= before["live_pinned_bytes"] + (1 << 20),
          f"[8] pinned soak: pinned host memory still referenced after "
          f"close: {before} -> {after}")
    return rec


# ---------------------------------------------------------------------------
# phase 9: the DPD control plane against the card runtime (ROADMAP A14)
# ---------------------------------------------------------------------------

DPD_BATCHES = 16             # batches the on-demand EDI stream holds at most
DPD_MARGIN_S = 60.0          # the EDI timestamps' lead on the wall clock:
                             # the last batch's stays within the SDR's 100 s
DPD_POLY_ITERS = 3           # through the GUI's DPD panel
DPD_LUT_ITERS = 2            # through run_engine
DPD_GATE_S = 2.0             # time after which a request that the batch in
                             # flight did not answer gets another one
DPD_WAIT_S = 120.0           # deadline of each wait of the phase
PA_COMPRESSION, PA_PHASE = 0.2, 0.15    # tests/test_sdr_dpd.py:100-106
DPD_BURST = 40960            # samples a burst of the engine (run_engine's
                             # samples_per_burst), from a TF's start
PRE_DPD_REL = 3e-5           # f32 tolerance before the DPD, of max|ref|
TELNET_BANNER = "Enter 'help' for help\r\n"
TELNET_BYE = "Goodbye\r\n"


class TelnetRc:
    """A stand-in for dabmod_tpu_torch.rc.client.ModRemoteControl, whose
    zmq the card's machine lacks: its methods over the port's telnet RC
    (rc/__init__.py: TelnetRC, dispatch_line).  Telnet replies are not
    framed (show and list reply with several lines), so each call is one
    connection: the command, then quit, and the reply is all that came
    before the goodbye.  `endpoint` is tcp://host:port."""

    def __init__(self, endpoint: str, timeout_s: float = 5.0):
        host, port = endpoint.split("//")[-1].rsplit(":", 1)
        self.addr = (host, int(port))
        self.timeout_s = timeout_s

    def _call(self, line: str) -> str:
        import socket
        with socket.create_connection(self.addr,
                                      timeout=self.timeout_s) as s:
            s.sendall(line.encode() + b"\nquit\n")
            data = b""
            while True:
                b = s.recv(65536)
                if not b:
                    break
                data += b
        text = data.decode()
        if not (text.startswith(TELNET_BANNER) and text.endswith(
                "\r\n" + TELNET_BYE)):
            raise RuntimeError(f"telnet RC: unexpected reply {text!r}")
        return text[len(TELNET_BANNER):-len("\r\n" + TELNET_BYE)]

    def ping(self) -> bool:
        return self._call("help").startswith("The following commands")

    def get_modules(self) -> list:
        return [m for m in self._call("list").splitlines()
                if m and not m.startswith("\t")]

    def show(self, module: str) -> dict:
        rep = self._call(f"show {module}")
        if rep and not rep.endswith("\n"):
            raise RuntimeError(f"rc show failed: {rep}")
        return dict(line.partition(": ")[::2] for line in rep.splitlines())

    def get_param_value(self, module: str, param: str) -> str:
        rep = self._call(f"get {module} {param}")
        if rep.startswith(("Module '", "Parameter '", "Incorrect ")):
            raise RuntimeError(f"rc get failed: {rep}")
        return rep

    def set_param_value(self, module: str, param: str, value):
        value = str(value)
        if not value or any(c.isspace() for c in value):
            # dispatch_line splits the line at whitespace
            raise ValueError(f"telnet RC: {value!r} is empty or has spaces")
        rep = self._call(f"set {module} {param} {value}")
        if rep != "ok":
            raise RuntimeError(f"rc set failed: {rep}")

    def close(self):
        pass


def _timed(events, name, fn):
    """fn, appending (name, start, seconds) to `events` at each call."""
    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            events.append((name, t, time.perf_counter() - t))
    return timed


def _iterations(events) -> list:
    """The timed calls grouped into the engine's iterations, each opened
    by a measurement: measure, align (normalise_burst: the lag, the
    fractional delay, the phase, the scaling), fit (adapt_iteration) and
    RC swap (Adapt.set_predistorter: the file, the RC set, the runtime's
    reload), and the wall from the measurement's start to the last
    call's end."""
    its = []
    for name, t, dt in events:
        if name == "measure":
            its.append({"t": t, "measure_s": dt, "end": t + dt})
        elif its:
            its[-1][f"{name}_s"] = its[-1].get(f"{name}_s", 0.0) + dt
            its[-1]["end"] = t + dt
    for it in its:
        it["wall_s"] = it.pop("end") - it.pop("t")
    return its


def _feed_on_demand(server, fbs, stop, rec):
    """Release a batch of the stream whenever the feedback server holds a
    request that no frame has answered and the batch released last has
    been sent whole (or DPD_GATE_S have passed since): the runtime
    modulates what the engine asks for, and the stream, and the CPU run
    that checks it, stay short."""
    last = time.monotonic()
    while not stop.is_set():
        now = time.monotonic()
        if (fbs._want_samples and fbs._tx_frame is None
                and (len(rec["keys"]) >= server.released * BATCH_TF
                     or now - last >= DPD_GATE_S)):
            server.release()
            last = now
        time.sleep(0.002)


def _record_dpd_device(dev, keep=False):
    """Wrap dev.transmit_frame: every frame's timestamp key in order, the
    peak magnitude of the bursts the engine measures in the first batch's
    frames (their first DPD_BURST samples), and a copy of each frame sent
    while rec["keep"] is True or whose key is in it (a set)."""
    rec = {"keys": [], "peak": 0.0, "keep": keep, "frames": {}}
    transmit = dev.transmit_frame

    def recording(samples, ts):
        key = (int(ts.seconds), int(ts.pps))
        rec["keys"].append(key)
        if len(rec["keys"]) <= BATCH_TF:
            x = np.asarray(samples, np.float32).reshape(-1, 2)[:DPD_BURST]
            rec["peak"] = max(rec["peak"], float(np.sqrt(
                (x * x).sum(-1)).max()))
        if rec["keep"] is True or key in (rec["keep"] or ()):
            rec["frames"][key] = np.array(samples)
        return transmit(samples, ts)

    dev.transmit_frame = recording
    return rec


def _pa_model(peak):
    """tests/test_sdr_dpd.py's PA (compression 1 - 0.2 a^2, AM/PM 0.15 a^2
    rad) at a = |x| / peak, the peak of the bursts this chain emits (the
    engine normalises each burst by its own peak): without the scale the
    PA would be linear at the level this chain emits."""
    def pa(x):
        m2 = np.abs(x / peak) ** 2
        return (x * (1.0 - PA_COMPRESSION * m2)
                * np.exp(1j * PA_PHASE * m2)).astype(np.complex64)
    return pa


def _lut_candidates(y, lut, scale, slack):
    """For one output sample y (complex) of the LUT predistorter: each bin
    b whose input y / L[b] lies in bin b's magnitude range, give or take
    `slack`, with that input."""
    from dabmod_tpu_torch.ops.filters import LUT_BIN
    width = LUT_BIN / scale
    out = []
    for b in range(len(lut)):
        x = y / lut[b]
        lo, hi = b * width, (b + 1) * width if b < len(lut) - 1 else np.inf
        if lo - slack <= abs(x) <= hi + slack:
            out.append((b, x))
    return out


def _check_lut_frames(got, ref, lut, scale):
    """The card's frames against the CPU's (both f32 pairs after the LUT
    DPD): within DPD_REL*max|ref|, except samples where the two took
    neighbouring LUT entries; there each side's input (its output over
    its entry) must agree with the other's within PRE_DPD_REL*max|input|
    and lie that close to the edge between the two bins.  Returns (max
    err over the tolerance elsewhere, the samples at an edge)."""
    from dabmod_tpu_torch.ops.filters import LUT_BIN
    worst, edge = 0.0, 0
    lut_c = lut[:, 0].astype(np.float64) + 1j * lut[:, 1]
    for k in sorted(ref):
        g = got[k].astype(np.float64).reshape(-1, 2)
        r = ref[k].astype(np.float64).reshape(-1, 2)
        check(g.shape == r.shape and bool(np.isfinite(g).all()),
              f"[9] frame {k}: {g.shape} vs {r.shape}, or not finite")
        yg, yr = g[:, 0] + 1j * g[:, 1], r[:, 0] + 1j * r[:, 1]
        tol = DPD_REL * float(np.abs(yr).max())
        slack = PRE_DPD_REL * float(np.abs(yr).max()) / np.abs(lut_c).min()
        err = np.abs(yg - yr)
        bad = np.flatnonzero(err > tol)
        check(bad.size <= 1000, f"[9] frame {k}: {bad.size} samples off")
        for i in bad:
            ok = False
            for bg, xg in _lut_candidates(yg[i], lut_c, scale, slack):
                for br, xr in _lut_candidates(yr[i], lut_c, scale, slack):
                    e = max(bg, br) * LUT_BIN / scale
                    ok = ok or (abs(bg - br) == 1 and abs(xg - xr) <= slack
                                and abs(abs(xr) - e) <= slack)
            check(ok, f"[9] frame {k} sample {i}: card {yg[i]} vs CPU "
                      f"{yr[i]}, not a neighbouring LUT entry at a bin "
                      f"edge")
        edge += bad.size
        mask = np.ones(err.size, bool)
        mask[bad] = False
        worst = max(worst, float(err[mask].max()) / tol)
    return worst, edge


class _LogCount(logging.Handler):
    """The runtime's log lines that tell a hot swap from a rebuild."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def count(self, text):
        return sum(text in m for m in self.lines)


def _http(port, path, method="GET") -> bytes:
    """One request to the GUI; a reply other than 200 fails the run (the
    handlers turn an exception into HTTP 500)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=DPD_WAIT_S) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    check(status == 200, f"[9] GUI {method} {path}: HTTP {status} "
          f"{body[:300]!r}")
    return body


def phase_dpd(torch, card):
    """Phase 9: the port's DPD control plane against the card runtime of
    realistic17_dpd_8m192 (the 17-sub-channel ensemble, batch_tf=24, EDI
    over TCP with timestamps DPD_MARGIN_S ahead, TII, CFR 40/3, window 90,
    FIR, 8.192 MS/s, the poly DPD from an identity file, the loopback SDR
    with the feedback server and a PA that compresses and turns the phase
    at this chain's level, the telnet RC).  The stream is released a
    batch at a time, whenever the feedback server holds a request.  The
    GUI (make_handler, port 0) over a telnet stand-in for the ZeroMQ RC
    client: /, /api/rc, /api/stats, /api/signal, then POST /api/dpd/start
    (poly, DPD_POLY_ITERS) polled on /api/dpd/status to its end; then
    run_engine(model_kind="lut") for DPD_LUT_ITERS.  Checks: every
    iteration adapted, the poly swaps hot with no rebuild, one rebuild at
    the first LUT file and hot swaps after it, the fitted poly's
    compression and AM/PM and the LUT's growing magnitude, K2 and K3
    launched, and one batch after the last swap equal to the CPU
    runtime's with the same LUT file."""
    import threading
    from http.server import ThreadingHTTPServer
    from dabmod_tpu_torch import gui
    from dabmod_tpu_torch.config import parse_ini
    from dabmod_tpu_torch.dpd import Poly, adapt, dpdce, measure
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS, synth_eti_batch
    from dabmod_tpu_torch.models.modulator import load_dpd_file
    from dabmod_tpu_torch.rc import rcs
    from dabmod_tpu_torch.runtime import ModRuntime
    from live_stream import (ChunkServer, TcpServer, drive, edi_stream,
                             free_port)
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_dpd_")
    _TMP.append(d)
    nf = BATCH_TF * 4
    frames = synth_eti_batch(DPD_BATCHES * nf, mode=1,
                             subch_specs=REALISTIC_MUX_SPECS, seed=SEED + 9)
    t0 = time.time() + DPD_MARGIN_S
    chunks = [b"".join(edi_stream(frames[i * nf:(i + 1) * nf], t0,
                                  start=i * nf))
              for i in range(DPD_BATCHES)]
    gui_coef = dpdce.DEFAULT_COEF_PATH    # the GUI's engine writes here
    gui_coef_existed = os.path.exists(gui_coef)
    identity = os.path.join(d, "identity.coef")
    adapt.write_coef_file(identity, [1, 0, 0, 0, 0], [0, 0, 0, 0, 0])
    lut_path = os.path.join(d, "lut.coef")
    telnet = free_port()
    ep = f"tcp://127.0.0.1:{telnet}"
    kernels = _kernels()
    events = []
    saved = (adapt.ModRemoteControl, measure.Measure.get_samples,
             dpdce.normalise_burst, dpdce.adapt_iteration,
             adapt.Adapt.set_predistorter)
    adapt.ModRemoteControl = TelnetRc
    measure.Measure.get_samples = _timed(events, "measure", saved[1])
    dpdce.normalise_burst = _timed(events, "align", saved[2])
    dpdce.adapt_iteration = _timed(events, "fit", saved[3])
    adapt.Adapt.set_predistorter = _timed(events, "swap", saved[4])
    rt_log = logging.getLogger("dabmod_tpu_torch")
    level = rt_log.level
    counter = _LogCount()
    rt_log.addHandler(counter)
    rt_log.setLevel(logging.INFO)
    server = ChunkServer(chunks)
    stop = threading.Event()
    httpd = feeder = rt_thread = None
    rc_codes = []
    try:
        s = parse_ini(_live_ini(
            d, "dpd_loop", f"tcp://127.0.0.1:{server.port}", "edi",
            _dpd_chain_ini(identity), _loopback_ini(free_port())
            + f"[remotecontrol]\ntelnet=1\ntelnetport={telnet}\n"))
        rt = ModRuntime(s, device="cuda")
        dev = rt.output.device
        dev._hist_max = 2 * BATCH_TF     # phase 8's history: 2 batches
        rec = _record_dpd_device(dev)
        fbs = rt.output.feedback_server
        for k in kernels.values():
            k.launches = 0
        rt_thread = threading.Thread(target=lambda: rc_codes.append(
            rt.run()), daemon=True)
        rt_thread.start()
        # the first batch: the level of the chain's bursts, for the PA
        server.release()
        deadline = time.monotonic() + DPD_WAIT_S
        while len(rec["keys"]) < BATCH_TF and time.monotonic() < deadline:
            time.sleep(0.02)
        check(len(rec["keys"]) >= BATCH_TF and rec["peak"] > 0,
              f"[9] the first batch: {len(rec['keys'])} TFs sent, peak "
              f"{rec['peak']}")
        dev.pa_model = _pa_model(rec["peak"])
        feeder = threading.Thread(target=_feed_on_demand,
                                  args=(server, fbs, stop, rec), daemon=True)
        feeder.start()

        # the GUI over the telnet stand-in, its engine on the feedback port
        rc = TelnetRc(ep)
        check(rc.ping(), "[9] the telnet RC does not answer")
        panel = gui.DpdPanel(ep, "127.0.0.1", s.sdr_dpd_port)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), gui.make_handler(
            rc, panel, ("127.0.0.1", s.sdr_dpd_port),
            sample_rate=s.output_rate))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        page = _http(port, "/")
        check(b"dabmod-tpu" in page, "[9] GUI: no page")
        mods = json.loads(_http(port, "/api/rc"))
        check({"poly", "sdr", "modulator"} <= set(mods)
              and mods["poly"]["coeffile"] == identity,
              f"[9] GUI /api/rc: {sorted(mods)}")
        stats = json.loads(_http(port, "/api/stats"))
        check("frames" in stats.get("sdr", {}),
              f"[9] GUI /api/stats: {stats}")
        sig = json.loads(_http(port, "/api/signal"))
        check(sig["sample_rate"] == 8_192_000 and sig["n_samples"] == 32768
              and len(sig["spectrum_db"]) >= 256
              and bool(np.isfinite(sig["spectrum_db"]).all())
              and len(sig["const_i"]) > 100,
              f"[9] GUI /api/signal: {sig.get('n_samples')} samples, "
              f"{len(sig.get('spectrum_db', []))} spectrum bins")

        # poly through the GUI's DPD panel
        del events[:]
        frames0, t_adapt = rt.framecount, time.perf_counter()
        started = json.loads(_http(
            port, f"/api/dpd/start?iterations={DPD_POLY_ITERS}&kind=poly",
            "POST"))
        check(started == {"ok": True}, f"[9] GUI dpd start: {started}")
        deadline = time.monotonic() + DPD_WAIT_S
        while True:
            st = json.loads(_http(port, "/api/dpd/status"))
            if not st["running"] or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        check(not st["running"], "[9] the GUI's DPD engine did not finish")
        hist = st["history"]
        check(len(hist) == DPD_POLY_ITERS
              and all(h.get("state") == "adapted" for h in hist),
              f"[9] GUI poly iterations: {hist}")
        poly_path = rc.get_param_value("poly", "coeffile")
        kind, (am, pm) = load_dpd_file(poly_path)
        check(kind == "poly"
              and np.round(am, 6).tolist() == hist[-1]["coefs_am"]
              and np.round(pm, 6).tolist() == hist[-1]["coefs_pm"],
              f"[9] {poly_path}: {kind} {am} {pm} is not the engine's "
              f"last fit {hist[-1]}")
        poly = Poly()
        poly.coefs_am, poly.coefs_pm = am, pm
        gain_hi = float(poly.am_am(np.array([0.6]))[0]) / 0.6
        gain_lo = float(poly.am_am(np.array([0.1]))[0]) / 0.1
        am_pm = float(poly.am_pm(np.array([0.7]))[0])
        check(gain_hi > gain_lo * 1.01 and am_pm > 0.01,
              f"[9] the fitted poly shows no compression or phase: gain "
              f"{gain_lo:.4f} at 0.1, {gain_hi:.4f} at 0.6, AM/PM "
              f"{am_pm:.4f} rad at 0.7")
        n_poly_swaps = counter.count("DPD poly coefficients hot-swapped")
        n_rebuild_poly = counter.count("pipeline")
        check(n_poly_swaps == DPD_POLY_ITERS and n_rebuild_poly == 0,
              f"[9] poly: {n_poly_swaps} hot swaps, {n_rebuild_poly} "
              f"rebuilds: {counter.lines}")
        mod_poly = rt.modulator

        # the LUT through run_engine: a rebuild, then hot swaps
        status = []
        lut = dpdce.run_engine(ep, "127.0.0.1", s.sdr_dpd_port,
                               iterations=DPD_LUT_ITERS, coef_path=lut_path,
                               model_kind="lut", status_cb=status.append)
        adapt_s = time.perf_counter() - t_adapt
        adapt_frames = rt.framecount - frames0
        check(len(status) == DPD_LUT_ITERS
              and all(r["state"] == "adapted" for r in status),
              f"[9] LUT iterations: {status}")
        mags = np.abs(lut.lut)
        filled = np.flatnonzero(mags != 1.0)
        check(filled.size > 4 and mags[filled[-1]] > mags[filled[0]],
              f"[9] the fitted LUT's magnitude does not grow: {mags}")
        kind, (scale, pairs) = load_dpd_file(lut_path)
        check(kind == "lut" and np.array_equal(
            pairs, np.stack([lut.lut.real, lut.lut.imag], -1)),
            f"[9] {lut_path} is not the engine's last LUT")
        check(rc.get_param_value("poly", "coeffile") == lut_path,
              "[9] the runtime does not name the LUT file")
        # one more batch, modulated after the last swap, kept whole
        n_sent = len(rec["keys"])
        rec["keep"] = True
        check(server.release(), "[9] the stream ran out of batches")
        deadline = time.monotonic() + DPD_WAIT_S
        while (len(rec["keys"]) < server.released * BATCH_TF
               and time.monotonic() < deadline):
            time.sleep(0.02)
        check(len(rec["keys"]) == server.released * BATCH_TF,
              f"[9] {len(rec['keys'])} TFs sent of the "
              f"{server.released * BATCH_TF} released")
        post = rec["keys"][n_sent:]
        n_lut_swaps = counter.count("DPD lut coefficients hot-swapped")
        n_rebuild = counter.count("pipeline")
        check(n_rebuild == 1 and n_lut_swaps == DPD_LUT_ITERS - 1
              and rt.modulator is not mod_poly
              and rt.modulator._lut is not None,
              f"[9] LUT: {n_rebuild} rebuilds, {n_lut_swaps} hot swaps: "
              f"{counter.lines}")
    finally:
        stop.set()
        if feeder is not None:
            feeder.join(timeout=5)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if rt_thread is not None:
            rt.stop()
            rt_thread.join(timeout=DPD_WAIT_S)
        server.close()
        (adapt.ModRemoteControl, measure.Measure.get_samples,
         dpdce.normalise_burst, dpdce.adapt_iteration,
         adapt.Adapt.set_predistorter) = saved
        rt_log.removeHandler(counter)
        rt_log.setLevel(level)
        rcs.shutdown()
        if not gui_coef_existed and os.path.exists(gui_coef):
            os.remove(gui_coef)
    counts = {k: f.launches for k, f in kernels.items()}
    check(not rt_thread.is_alive() and rc_codes == [0],
          f"[9] the card runtime did not stop with 0: {rc_codes}")
    rt.close()
    check(rt.output.fault is None and rt.output.dropped == 0,
          f"[9] SDR device fault {rt.output.fault!r}, "
          f"{rt.output.dropped} frames dropped")
    for k in ("ofdm_cfr", "resample_poly"):
        check(counts[k] > 0, f"[9] the DPD loop never launched {k}")
    check(counts["ofdm_ifft"] == 0, f"[9] K1 launched {counts}")

    # the batch after the last swap against the CPU runtime, the same LUT
    # file from the start, on the stream as released
    n_batches = server.released
    src = TcpServer(b"".join(chunks[:n_batches]))
    try:
        rt_cpu = ModRuntime(parse_ini(_live_ini(
            d, "dpd_loop_cpu", f"tcp://127.0.0.1:{src.port}", "edi",
            _dpd_chain_ini(lut_path), _loopback_ini(0))), device="cpu")
        # the CPU run comes later on the wall clock than the stream's
        # timestamps allow for: its loopback's clock stands before them
        rt_cpu.output.device.get_real_secs = lambda: t0 - 1.0
        keep = set(post)
        ref = _record_dpd_device(rt_cpu.output.device, keep)
        code = drive(rt_cpu, n_batches * nf, deadline_s=DPD_WAIT_S * 4)
        rt_cpu.close()
    finally:
        src.close()
    check(code == 0 and set(ref["frames"]) == keep
          and rt_cpu.output.dropped == 0,
          f"[9] the CPU runtime: exit {code}, {len(ref['frames'])} of the "
          f"{len(keep)} TFs after the last swap")
    worst, n_edge = _check_lut_frames(
        {k: rec["frames"][k] for k in post}, ref["frames"], pairs, scale)
    its = _iterations(events)
    check(len(its) == DPD_POLY_ITERS + DPD_LUT_ITERS
          and all({"align_s", "fit_s", "swap_s"} <= set(i) for i in its),
          f"[9] timed iterations: {its}")
    for i, (it, model) in enumerate(zip(its, ["poly"] * DPD_POLY_ITERS
                                        + ["lut"] * DPD_LUT_ITERS)):
        it["model"] = model
        log(f"[9] iteration {i} ({model}) on {card}: wall "
            f"{it['wall_s']:.3f} s = "
            f"measure {it['measure_s']:.3f} + align {it['align_s']:.3f} + "
            f"fit {it['fit_s']:.3f} + RC swap {it['swap_s']:.3f} s (+ the "
            f"engine's sleeps)")
    record = {
        "card": card,
        "input": "edi/tcp, released on demand", "output": "loopback",
        "output_rate": s.output_rate, "batch_tf": BATCH_TF,
        "launches": counts, "batches": n_batches,
        "pa_peak": rec["peak"], "iterations": its,
        "adapt_s": adapt_s, "adapt_frames": adapt_frames,
        "adapt_frames_per_s": adapt_frames / adapt_s,
        "poly": {"coefs_am": am.tolist(), "coefs_pm": pm.tolist(),
                 "gain_0.1": gain_lo, "gain_0.6": gain_hi,
                 "am_pm_0.7": am_pm, "hot_swaps": n_poly_swaps},
        "lut": {"magnitude": mags.tolist(), "rebuilds": n_rebuild,
                "hot_swaps": n_lut_swaps},
        "cpu_frames_compared": len(keep), "max_err_over_tol": worst,
        "lut_edge_samples": n_edge}
    log(f"[9] dpd loop: the GUI (/, /api/rc, /api/stats, /api/signal of "
        f"{sig['n_samples']} samples) and {DPD_POLY_ITERS} poly iterations "
        f"through its DPD panel, then {DPD_LUT_ITERS} LUT iterations of "
        f"run_engine, against the card runtime of realistic17_dpd_8m192 "
        f"(PA peak {rec['peak']:.4f}); launches {counts}; poly: "
        f"{n_poly_swaps} hot swaps, no rebuild, gain {gain_lo:.4f} at 0.1 "
        f"-> {gain_hi:.4f} at 0.6, AM/PM {am_pm:.4f} rad at 0.7; LUT: "
        f"{n_rebuild} rebuild, {n_lut_swaps} hot swap(s), |L| "
        f"{mags[filled[0]]:.4f} -> {mags[filled[-1]]:.4f}; {n_batches} "
        f"batches released, {adapt_frames} ETI frames modulated in the "
        f"{adapt_s:.3f} s of adaptation ({adapt_frames / adapt_s:.1f} "
        f"frames/s, the engine's demand; {card}); the {len(keep)} TFs "
        f"after the "
        f"last swap vs the CPU runtime: max err {worst:.4f} of the "
        f"tolerance, {n_edge} samples at a LUT bin edge")
    log(f"[9] dpd phase passed in {time.perf_counter() - t_phase:.1f} s")
    return {"dpd_loop_8m192": record}


# ---------------------------------------------------------------------------
# phase 10: the TF-sharded step (dabmod_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

SHARD_BATCHES = 2            # consecutive batches, the state carried
SHARD_TIMED = 10             # timed steps (and exchange sequences) a rank
SHARD_TIMEOUT_S = 300.0      # each spawn, the ranks' start included
SHARD_TRACED = 5             # steps a rank traces for the card's view
SHARD_SOAK = 300             # replays of a captured step on the same inputs
# the poly coefficients swapped in before the second batch of the DPD chain
SHARD_SWAP = ((0.95, 0.12, -0.04, 0.01, -0.005), (0.01, -0.02, 0.004,
                                                  0.001, 0.0))


def _shard_cases() -> dict:
    """name -> (specs, settings extra, format, kernels it must launch,
    poly coefficients swapped in before the second batch or None)."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    return {
        "realistic17_dpd_8m192": (
            REALISTIC_MUX_SPECS,
            dict(DPD_8M192, poly_coef_file=dpd_files()["poly"]), "uhd",
            ("ofdm_cfr", "resample_poly"), SHARD_SWAP),
        "main_s16": (REALISTIC_MUX_SPECS, {}, "s16", ("ofdm_ifft",), None)}


def _shard_batches(specs):
    """Phase 4's two batches of BATCH_TF TFs (the same seed)."""
    from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
    frames = BATCH_TF * 4
    raw = synth_eti_batch(SHARD_BATCHES * frames, mode=1, subch_specs=specs,
                          seed=SEED)
    return [parse_eti_frames(raw[k * frames:(k + 1) * frames])
            for k in range(SHARD_BATCHES)]


def _state_to_host(state) -> dict:
    return {k: tuple(x.cpu().numpy() for x in v) if isinstance(v, tuple)
            else v.cpu().numpy() for k, v in state.items()}


def _timed_steps(torch, step, n, exchanges=None) -> list:
    """Host wall ms of n calls of step(), each ended by a synchronise,
    after two warm calls.  With `exchanges` (parallel.EXCHANGES): per
    step (wall ms, collectives, all_reduce buffer bytes, exchange ms) as
    exchange_tails counted and timed them inside that step (none in a
    replay of a captured step, which runs no Python)."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        if exchanges is not None:
            exchanges.reset(timing=True)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        out.append(wall if exchanges is None else (
            wall, exchanges.collectives, exchanges.buffer_bytes,
            exchanges.ms()))
    if exchanges is not None:
        exchanges.reset()
    return out


def _shard_run(torch, sm, m, batches, swap, traced):
    """The main path of one sharded modulator: the two global batches (the
    swap before the second), the kernel launch counts and EXCHANGES set to
    0 just before and read just after; with `traced` under torch.profiler
    (traced_launches with NCCL's kernels).  Returns its record."""
    from dabmod_tpu_torch.parallel import EXCHANGES

    def path():
        state, res = sm.init_state(), []
        for i, b in enumerate(batches):
            if i and swap and not m.update_dpd("poly", swap):
                raise RuntimeError("[10] update_dpd refused the swap")
            o, state, stats = sm.modulate(b.fic, b.subchannels, state)
            res.append((_to_host(o), _state_to_host(state),
                        {k: v.cpu().numpy() for k, v in stats.items()}))
        torch.cuda.synchronize()
        return state, res
    kernels = _kernels()
    for k in kernels.values():
        k.launches = 0
    EXCHANGES.reset()
    if traced:
        (state, res), on_card = traced_launches(torch, path, nccl=True)
    else:
        (state, res), on_card = path(), None
    rec = {"batches": res, "launches": {k: f.launches
                                        for k, f in kernels.items()},
           "path_exchanges": (EXCHANGES.collectives, EXCHANGES.buffer_bytes),
           "on_card": on_card}
    if sm.compiled is not None:
        rec["graphs"] = {B: {"launches": cap.launches, "replays": cap.replays}
                         for B, cap in sm.compiled.graphs.items()}
    return state, rec


def shard_rank(mesh, cases, timed):
    """Phase 10 on one rank (run by parallel.launch.spawn).  Each case's
    two global batches through ShardedModulator: over NCCL on the card
    twice, its step captured (ShardedModulator.compiled, a CUDA graph a
    batch size holding the all_reduces) and eager (compiled set to None),
    each traced with torch.profiler; over gloo eagerly, untraced.  Then
    `timed` steps, each between synchronises: an eager step's exchanges
    counted and timed in exchange_tails (parallel.EXCHANGES), a replay's
    read from a trace of SHARD_TRACED steps; a captured step then replays
    SHARD_SOAK times more on the same inputs, after which its output must
    be unchanged and a barrier must pass (the watchdog of the NCCL
    process group has not ended the rank).  Returns per case and kind
    this rank's outputs, states and stats (numpy), the counts and the
    timed steps.  A failure raises: the launcher reports it with the
    rank's traceback."""
    import torch
    import torch.distributed as dist
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    from dabmod_tpu_torch.parallel import EXCHANGES, ShardedModulator
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = dist.get_backend()
    out = {}
    for name, (specs, extra, fmt, _used, swap) in cases.items():
        batches = _shard_batches(specs)
        out[name] = {"device": str(mesh.device), "backend": backend}
        for kind in (("captured", "eager") if backend == "nccl"
                     else ("eager",)):
            m = Modulator(make_default_layout(1, specs),
                          _settings(fmt, **extra), device=mesh.device)
            sm = ShardedModulator(m, mesh)
            if kind == "eager":
                sm.compiled = None
            elif sm.compiled is None:
                raise RuntimeError(f"[10] {name}: the sharded step over "
                                   f"{backend} on {mesh.device} does not "
                                   f"capture")
            state, rec = _shard_run(torch, sm, m, batches, swap,
                                    backend == "nccl")
            st = [state]
            b = batches[0]

            def step():
                _, st[0], _ = sm.modulate(b.fic, b.subchannels, st[0])
            dist.barrier()
            rec["steps"] = _timed_steps(torch, step, timed, EXCHANGES)
            if backend == "nccl":
                _, rec["traced_steps"] = traced_launches(
                    torch, lambda: [step() for _ in range(SHARD_TRACED)],
                    nccl=True)
            if kind == "captured":
                first = _bits(sm.modulate(b.fic, b.subchannels, st[0]))
                t0 = time.perf_counter()
                for _ in range(SHARD_SOAK):
                    sm.modulate(b.fic, b.subchannels, st[0])
                torch.cuda.synchronize()
                dist.barrier()
                rec["soak_s"] = time.perf_counter() - t0
                rec["soak_same"] = _same_bits(
                    first, _bits(sm.modulate(b.fic, b.subchannels, st[0])))
            out[name][kind] = rec
            del sm, m
    return out


def _shard_reference(torch, specs, extra, fmt, swap) -> dict:
    """The unsharded step on the card on the same batches (with the same
    swap): outputs, stats and states (numpy), the CFR threshold margins,
    tf_samples_out and the step's host wall ms (the same calls as a
    rank's)."""
    from dabmod_tpu_torch.models import Modulator, make_default_layout
    from dabmod_tpu_torch.ops import ofdm_kernel
    m = Modulator(make_default_layout(1, specs), _settings(fmt, **extra),
                  device="cuda")
    batches = _shard_batches(specs)
    state, res, margins = m.init_state(), [], []
    for i, b in enumerate(batches):
        if i and swap:
            check(m.update_dpd("poly", swap), "[10] update_dpd refused")
        if m.settings.enable_cfr:
            syms, _ = m.ofdm_symbols(b.fic, b.subchannels,
                                     state["ti_history"], state["tf_index"])
            margins.append(ofdm_kernel.cfr_threshold_margin(
                syms, m._ofdm_table, m.settings.cfr_clip,
                m.settings.cfr_error_clip, rel=MARGIN_REL).sum(dim=1)
                .cpu().numpy())
        o, state, stats = m.modulate_eti(b, state)
        res.append((_to_host(o), _state_to_host(state),
                    {k: v.cpu().numpy() for k, v in stats.items()}))
    st = [state]
    b = batches[0]

    def step():
        _, st[0], _ = m.modulate(b.fic, b.subchannels, st[0])
    return {"batches": res, "margins": margins or None,
            "n_out": m.tf_samples_out,
            "step_ms": _timed_steps(torch, step, SHARD_TIMED)}


def _check_shard_run(tag, ref, ranks, fmt, used, world, kind="eager"):
    """One case of one spawn against the unsharded step: each batch's
    output and stats (compare_batch), every rank's state equal to the
    bit, each rank's launches: an eager step's its kernels once a batch,
    no other; a captured step's each graph's warm-up and capture
    (check_graph_launches' count), with the trace holding the warm-up and
    each replay."""
    rel = DPD_REL if fmt == "uhd" else 3e-5
    for k, (c, cstate, cs) in enumerate(ref["batches"]):
        parts = [r["batches"][k] for r in ranks]
        g = (tuple(np.concatenate([p[0][j] for p in parts]) for j in (0, 1))
             if fmt == "uhd" else np.concatenate([p[0] for p in parts]))
        gs = {key: (parts[0][2][key] if key == "num_clipped"
                    else np.concatenate([p[2][key] for p in parts]))
              for key in parts[0][2]}
        if "num_clipped" in gs:
            check(all(int(p[2]["num_clipped"]) == int(gs["num_clipped"])
                      for p in parts),
                  f"{tag}: num_clipped differs between ranks")
        compare_batch(f"{tag} batch {k}", fmt, g, gs, c, cs, ref["n_out"],
                      ref["margins"][k] if ref["margins"] else None, rel)
        for r, p in enumerate(parts):
            for key, v in cstate.items():
                got = p[1].get(key)
                same = got is not None and all(
                    np.array_equal(a, b) for a, b in zip(
                        *(x if isinstance(x, tuple) else (x,)
                          for x in (got, v))))
                check(same, f"{tag} batch {k}: rank {r}'s {key} is not the "
                      f"unsharded step's")
    for r, rec in enumerate(ranks):
        eager = kind == "eager"
        steps = SHARD_BATCHES if eager else 0
        _check_rank_launches(f"{tag}: rank {r}", rec, used, steps,
                             [] if eager else rec["graphs"].values(),
                             steps if world == 1 else 0)
    log(f"    {tag}: every rank's state equal to the bit; launches a rank "
        f"{ranks[0]['launches']}"
        + (f", on the card {ranks[0]['on_card']}"
           if ranks[0]["on_card"] is not None else "") + f" (world {world})")


def _check_rank_launches(tag, rec, used, eager_steps, graphs, k5_steps):
    """One rank's launches on its main path: the wrappers count its kernels
    once an eager step (`used` once each of eager_steps; K5 once each of
    the k5_steps eager steps whose time interleaver is the unsharded one:
    the sharded coupling runs the front end's op chain) and each graph's
    warm-up and capture (the graph's count, twice); the trace of the path
    (rec["on_card"], where traced) holds the eager steps' launches and
    each graph's at its warm-up and each replay.  Each kernel of `used`
    must have launched."""
    names = {f.__name__: k for k, f in _kernels().items()}
    want = {kn: eager_steps if kn in used else 0 for kn in rec["launches"]}
    want["frontend"] = k5_steps
    on_card = dict(want)
    for g in graphs:
        for wrapper, n in g["launches"].items():
            want[names[wrapper]] += 2 * n
            on_card[names[wrapper]] += (1 + g["replays"]) * n
    check(all(want[kn] > 0 for kn in used),
          f"{tag}: its steps and graphs launch {want}, not {used}")
    check(rec["launches"] == want, f"{tag} counted {rec['launches']}, not "
          f"{want}")
    if rec["on_card"] is not None:
        traced = {kn: rec["on_card"][kn] for kn in want}
        check(traced == on_card, f"{tag} launched {traced} on the card "
              f"(trace), not {on_card}")


def _check_captured_collectives(tag, ranks, world):
    """A captured run's collectives: EXCHANGES counted the warm-up's and
    the capture's (twice the eager step's, per graph), and the trace of
    the main path holds NCCL's all-reduce kernels of the warm-up and each
    replay, at the eager step's kernels a collective.  Returns (the
    collectives a graph holds, NCCL kernels a collective)."""
    eager = [r["eager"] for r in ranks]
    cap = [r["captured"] for r in ranks]
    per_step = eager[0]["path_exchanges"][0] // SHARD_BATCHES
    nccl_eager = eager[0]["on_card"]["nccl_all_reduce"]
    check(nccl_eager % (SHARD_BATCHES * per_step) == 0 if per_step else
          nccl_eager == 0, f"{tag}: the eager steps' {nccl_eager} NCCL "
          f"all-reduce kernels are not a whole number a collective")
    per_coll = nccl_eager // (SHARD_BATCHES * per_step) if per_step else 0
    for r, rec in enumerate(cap):
        graphs = rec["graphs"]
        check(len(graphs) == 1, f"{tag}: rank {r} captured {len(graphs)} "
              f"graphs, not one")
        check(rec["path_exchanges"][0] == 2 * per_step * len(graphs),
              f"{tag}: rank {r} counted {rec['path_exchanges'][0]} "
              f"collectives, not the warm-up's and the capture's "
              f"{2 * per_step}")
        want = sum(1 + g["replays"] for g in graphs.values()) \
            * per_step * per_coll
        check(rec["on_card"]["nccl_all_reduce"] == want,
              f"{tag}: rank {r}'s trace holds "
              f"{rec['on_card']['nccl_all_reduce']} NCCL all-reduce "
              f"kernels, not the warm-up's and the replays' {want}")
        check(all(st[1:3] == (0, 0) for st in rec["steps"]),
              f"{tag}: rank {r}: a replay counted a collective")
        check(rec["soak_same"], f"{tag}: rank {r}'s output changed over "
              f"{SHARD_SOAK} replays on the same inputs")
    return per_step, per_coll


def _same_runs(tag, ranks):
    """The captured step of every rank equal to its eager step, to the bit:
    each batch's output, state and stats."""
    for r, rec in enumerate(ranks):
        for k, (c, e) in enumerate(zip(rec["captured"]["batches"],
                                       rec["eager"]["batches"])):
            check(_same_bits(_host_leaves(c), _host_leaves(e)),
                  f"{tag}: rank {r}'s captured step differs from its eager "
                  f"step in batch {k}")


def _host_leaves(tree) -> list:
    """The numpy arrays of a host record (output, state, stats) in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _host_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _host_leaves(v)]
    return [np.asarray(tree)]


def _shard_record(name, world, backend, ranks, kind, ref, wall):
    """The record of one case and kind of a run, and its log line."""
    recs = [r[kind] for r in ranks]
    walls = [s[0] for s in recs[0]["steps"]]
    step = statistics.median(walls)
    run = {"case": name, "world": world, "backend": backend, "kind": kind,
           "devices": [r["device"] for r in ranks],
           "step_ms": step, "step_ms_range": [min(walls), max(walls)],
           "unsharded_step_ms": statistics.median(ref["step_ms"]),
           "launches": {k: sum(r["launches"][k] for r in recs)
                        for k in recs[0]["launches"]},
           "spawn_s": wall}
    if kind == "eager":
        made = {s[1:3] for r in recs for s in r["steps"]}
        check(len(made) == 1, f"[10] {name} world {world} ({backend}): the "
              f"steps made different exchanges: {sorted(made)}")
        collectives, ex_bytes = made.pop()
        check(all(r["path_exchanges"] == (SHARD_BATCHES * collectives,
                                          SHARD_BATCHES * ex_bytes)
                  for r in recs),
              f"[10] {name} world {world} ({backend}): the main path's "
              f"exchanges {[r['path_exchanges'] for r in recs]} are not "
              f"{SHARD_BATCHES} timed steps'")
        ex = statistics.median(s[3] for s in recs[0]["steps"])
        run.update(
            exchange_ms=ex,
            exchange_share=statistics.median(s[3] / s[0]
                                             for s in recs[0]["steps"]),
            exchange_ms_ranks=[statistics.median(s[3] for s in r["steps"])
                               for r in recs],
            exchange_collectives=collectives,
            exchange_buffer_bytes=ex_bytes,
            exchange_bytes_per_rank=ex_bytes // world)
    else:
        run.update(
            graphs={str(B): g for B, g in recs[0]["graphs"].items()},
            soak_replays=SHARD_SOAK, soak_s=recs[0]["soak_s"],
            launches_on_card={k: sum(r["on_card"][k] for r in recs)
                              for k in _kernels()})
    if "traced_steps" in recs[0]:
        tr = recs[0]["traced_steps"]
        run.update(nccl_kernels_per_step=tr["nccl_all_reduce"]
                   / SHARD_TRACED,
                   nccl_ms_per_step=tr["nccl_all_reduce_ms"] / SHARD_TRACED)
    return run


def phase_sharded(torch, card):
    """Phase 10: ShardedModulator over ranks spawned on the card; see the
    module docstring.  Returns the phase's record."""
    from dabmod_tpu_torch.ops import build
    from dabmod_tpu_torch.parallel.launch import spawn
    t_phase = time.perf_counter()
    # every kernel is built before the ranks start, so that no two ranks
    # run nvcc at once (a no-op after phase 1)
    build.build(*build.SOURCES)
    cases = _shard_cases()
    store = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    _TMP.append(store)
    runs = [("gloo", 4, ("realistic17_dpd_8m192",)),
            ("gloo", 2, ("realistic17_dpd_8m192", "main_s16")),
            ("nccl", 1, ("realistic17_dpd_8m192",))]
    n_cards = torch.cuda.device_count()
    if n_cards >= 4:
        runs.append(("nccl", 4, ("realistic17_dpd_8m192",)))
    names = {n for _, _, ns in runs for n in ns}
    refs = {name: _shard_reference(torch, specs, extra, fmt, swap)
            for name, (specs, extra, fmt, _u, swap) in cases.items()
            if name in names}
    log(f"[10] sharded runs on {n_cards} card(s): " + "; ".join(
        f"world {w} over {b} ({', '.join(ns)}; "
        + ("captured and eager" if b == "nccl" else "eager") + ")"
        for b, w, ns in runs))
    record = {"card": card, "cards": n_cards, "runs": []}
    for backend, world, run_names in runs:
        t0 = time.perf_counter()
        res = spawn(shard_rank, world, backend=backend, device="cuda",
                    store_path=store, timeout_s=SHARD_TIMEOUT_S,
                    args=({n: cases[n] for n in run_names}, SHARD_TIMED))
        wall = time.perf_counter() - t0
        for name in run_names:
            _specs, _extra, fmt, used, _swap = cases[name]
            ranks = [r[name] for r in res]
            check(all(r["backend"] == backend for r in ranks),
                  f"[10] {name}: the ranks ran on "
                  f"{[r['backend'] for r in ranks]}, not {backend}")
            tag = f"[10] {name} world {world} ({backend})"
            kinds = ("captured", "eager") if backend == "nccl" else \
                ("eager",)
            check(all(k in r for r in ranks for k in kinds),
                  f"{tag}: a rank did not run {kinds}")
            for kind in kinds:
                _check_shard_run(f"{tag} {kind}", refs[name],
                                 [r[kind] for r in ranks], fmt, used, world,
                                 kind)
            if backend == "nccl":
                _same_runs(tag, ranks)
                per_step, per_coll = _check_captured_collectives(
                    tag, ranks, world)
                log(f"    {tag}: captured == eager to the bit on every "
                    f"rank; {per_step} collective(s) a step, counted at "
                    f"the warm-up and the capture, {per_coll} NCCL "
                    f"all-reduce kernel(s) a collective in the traces; "
                    f"{SHARD_SOAK} more replays on the same inputs left "
                    f"the output unchanged and the process group up")
            runs_rec = {kind: _shard_record(name, world, backend, ranks,
                                            kind, refs[name], wall)
                        for kind in kinds}
            record["runs"].extend(runs_rec.values())
            e = runs_rec["eager"]
            log(f"[10] {name} world {world} over {backend} on "
                f"{', '.join(sorted(set(e['devices'])))} ({card}): eager "
                f"step {e['step_ms']:.3f} ms (host wall, median of "
                f"{SHARD_TIMED}; unsharded {e['unsharded_step_ms']:.3f} "
                f"ms), {e['exchange_collectives']} all_reduce a step, "
                f"{e['exchange_buffer_bytes']} B of buffers "
                f"({e['exchange_bytes_per_rank']} B from each rank), "
                f"{e['exchange_ms']:.3f} ms of the step in them "
                f"({100 * e['exchange_share']:.1f} %; counted and timed in "
                f"exchange_tails, CUDA events around each); spawn "
                f"{wall:.1f} s"
                + ("; ranks that share a card measure correctness and "
                   "exchange cost, not scaling"
                   if len(set(e["devices"])) < world else ""))
            if "captured" in runs_rec:
                c = runs_rec["captured"]
                log(f"[10] {name} world {world} over {backend} ({card}): "
                    f"captured step {c['step_ms']:.3f} ms (range "
                    f"{c['step_ms_range'][0]:.3f}-"
                    f"{c['step_ms_range'][1]:.3f}) against eager "
                    f"{e['step_ms']:.3f} and unsharded "
                    f"{c['unsharded_step_ms']:.3f} ms; NCCL all-reduce "
                    f"kernels a step on the card: captured "
                    f"{c['nccl_kernels_per_step']:g} "
                    f"({c['nccl_ms_per_step']:.4f} ms), eager "
                    f"{e['nccl_kernels_per_step']:g} "
                    f"({e['nccl_ms_per_step']:.4f} ms) (torch.profiler, "
                    f"{SHARD_TRACED} steps); launches on the card "
                    f"{c['launches_on_card']}; {SHARD_SOAK} replays in "
                    f"{c['soak_s']:.2f} s")
    log(f"[10] sharded phase passed in {time.perf_counter() - t_phase:.1f} s")
    return record


# ---------------------------------------------------------------------------
# phase 11: bench_gpu.py's measurements
# ---------------------------------------------------------------------------

BENCH_STEPS = 10             # steps a timed run of phase 11
BENCH_RUNS = 5               # timed runs a step
BENCH_CONFIGS = ("base (TM-I)", "realistic17 full", "resamp 2.5M poly",
                 "resamp 8.192M fft")
BENCH_STAGES = ("base (TM-I)", "realistic17 full", "resamp 8.192M")
BENCH_STAGE_TF = 16          # tools/profile_stages.py's batch


def phase_bench(torch):
    """Phase 11: bench_gpu.py's default run, --configs and --stages, in
    this process; each config's first batch checked against the CPU port
    (bench_gpu.check_first_batch), each stage record against
    bench_gpu.stage_problems."""
    t0 = time.perf_counter()
    # bench_gpu takes its helpers from this module
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    import bench_gpu
    default = bench_gpu.bench_default(torch, BATCH_TF, BENCH_STEPS,
                                      BENCH_RUNS)
    log(f"[11] default run: {default['value'] / 1e6:.1f} MS/s captured "
        f"({default['vs_baseline']:.1f}x), {default['eager_value'] / 1e6:.1f}"
        f" MS/s eager; step {default['step_ms']['median']:.4f} ms "
        f"(q1-q3 {default['step_ms']['q1']:.4f}-"
        f"{default['step_ms']['q3']:.4f}), eager "
        f"{default['eager_step_ms']['median']:.4f} ms")
    log("[11] --configs:")
    configs = bench_gpu.run_configs(torch, BENCH_CONFIGS, steps=BENCH_STEPS,
                                    runs=BENCH_RUNS)
    check([r["config"] for r in configs["configs"]] == list(BENCH_CONFIGS),
          f"[11] --configs ran {[r['config'] for r in configs['configs']]}")
    stages = {}
    for name in BENCH_STAGES:
        rec = bench_gpu.profile_stages(torch, name, BENCH_STAGE_TF)
        stages[name] = rec
        log(f"[11] --stages {name}: " + ", ".join(
            f"{k} {r['device_ms']:.4f} ms / {r['launches']:g}"
            for k, r in rec["stages"].items())
            + f"; sum {rec['stage_sum_ms_per_step']:.4f} ms, device busy "
            f"{rec['device_busy_ms_per_step']:.4f} ms")
        bad = bench_gpu.stage_problems(rec)
        check(not bad, f"[11] --stages {name}: {'; '.join(bad)}")
    wall = time.perf_counter() - t0
    log(f"[11] bench phase passed in {wall:.1f} s")
    return {"default": default, "configs": configs["configs"],
            "stages": stages, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 12: the multi-rank tools (bench_gpu.py --scaling, --collectives)
# ---------------------------------------------------------------------------

MULTI_CONFIG = "realistic17"     # the scaling runs' row, BATCH_TF TFs a rank
# each --collectives configuration: its couplings, the kernels it launches
MULTI_COLLECTIVES = {
    "base 2sub": ({"time_interleave"}, ("ofdm_ifft",)),
    "realistic17 full": ({"time_interleave", "resampler", "num_clipped"},
                         ("ofdm_cfr", "resample_poly"))}


def _replay_launches(graph, steps) -> dict:
    """The launches of `steps` replays of `graph` (a trace holds them)."""
    names = {f.__name__: k for k, f in _kernels().items()}
    want = dict.fromkeys(_kernels(), 0)
    for wrapper, n in graph["launches"].items():
        want[names[wrapper]] += steps * n
    return want


def _check_scaling(tag, rec, world_list, hosts=False):
    """--scaling's rows: each world ran (in this process at world 1,
    spawned above it, or with `hosts` by init_distributed; the captured step
    over NCCL, one card a rank where there are enough), its output within
    the tolerance and its state equal on every rank; each rank's launches
    on its main path (_check_rank_launches) and in the trace of its timed
    replays."""
    check([r["world"] for r in rec["rows"]] == list(world_list),
          f"{tag}: worlds {[r['world'] for r in rec['rows']]}")
    for row in rec["rows"]:
        t = f"{tag} world {row['world']}"
        launcher = "init_distributed" if hosts else (
            "in process" if row["world"] == 1 else "spawn")
        check(row["launcher"] == launcher and row["captured"]
              and row["backend"] in (None, "nccl"),
              f"{t}: {row['launcher']}, {row['backend']}, captured "
              f"{row['captured']}")
        check(row["own_cards"], f"{t}: ranks on {row['devices']}")
        check(row["elementwise_ok"], f"{t}: max_abs_diff "
              f"{row['max_abs_diff']} ({row['diff_over_tol']:.3g} of the "
              f"tolerance), state equal {row['state_equal']}")
        for r in row["ranks"]:
            rt = f"{t}: rank {r['rank']}"
            _check_rank_launches(rt, r, ("ofdm_ifft",), r["eager_calls"],
                                 r["graphs"], r["eager_calls"]
                                 if row["world"] == 1 else 0)
            check(len(r["graphs"]) == 1, f"{rt}: {len(r['graphs'])} graphs")
            want = _replay_launches(r["graphs"][0], r["traced_steps"])
            got = {k: r["traced"][k] for k in want}
            check(got == want, f"{rt}: its traced replays launched {got}, "
                  f"not {want}")


def _check_collectives(tag, rec):
    """--collectives' records: each configuration's couplings, one
    all_reduce each a step, the same every step, counted twice at a
    graph's warm-up and capture; each rank's launches (its eager steps'
    and its graphs' warm-ups and captures) and, captured, its traced
    replays'."""
    check([r["config"] for r in rec["configs"]] == list(MULTI_COLLECTIVES),
          f"{tag}: configurations {[r['config'] for r in rec['configs']]}")
    for r in rec["configs"]:
        t = f"{tag} {r['config']}"
        names, used = MULTI_COLLECTIVES[r["config"]]
        check(set(r["couplings"]) == names,
              f"{t}: couplings {sorted(r['couplings'])}, not {sorted(names)}")
        check(all(c["collectives_per_step"] == 1 and c["same_every_step"]
                  for c in r["couplings"].values()),
              f"{t}: not one all_reduce a coupling every step")
        if "resample_poly" in used:
            check(r["resampler_route"] == "kernel",
                  f"{t}: resampler route {r['resampler_route']}")
        for k in r["ranks"]:
            rt = f"{t}: rank {k['rank']}"
            _check_rank_launches(rt, dict(k, on_card=None), used,
                                 k["eager_calls"], k["graphs"],
                                 k["severed_calls"])
            if "traced" in k:
                check({c: v["collectives"] for c, v in
                       k["captured_exchanges"].items()}
                      == dict.fromkeys(names, 2),
                      f"{rt}: the graph's warm-up and capture counted "
                      f"{k['captured_exchanges']}")
                want = _replay_launches(k["graphs"][0], k["traced_steps"])
                got = {c: k["traced"][c] for c in want}
                check(got == want, f"{rt}: its traced replays launched "
                      f"{got}, not {want}")


def _multi_launches(multi, kernel) -> dict:
    """Phase 12's launches of one kernel, summed over each run's ranks:
    [counted, on the card] for a scaling row's main path, counted for a
    --collectives configuration (its eager steps and graphs)."""
    out = {}
    for mode in ("scaling", "hosts"):
        for row in multi[mode]["rows"]:
            out[f"[12] {mode} {row['config']}@ncclx{row['world']} "
                f"captured"] = [sum(r[key][kernel] for r in row["ranks"])
                                for key in ("launches", "on_card")]
    coll = multi["collectives"]
    for r in coll["configs"]:
        out[f"[12] collectives {r['config']}"
            + (" (4.096 MS/s)" if kernel == "resample_poly" else "")
            + f"@{coll['backend']}x{coll['world']}"] = sum(
                k["launches"][kernel] for k in r["ranks"])
    return out


def phase_multi_rank(torch):
    """Phase 12: bench_gpu.py --scaling (--worlds and --hosts) and
    --collectives --full in this process; see the module docstring.
    Returns the phase's record."""
    t0 = time.perf_counter()
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    import bench_gpu
    four = torch.cuda.device_count() >= 4
    worlds = (1, 2, 4) if four else (1,)
    hosts, chips = ((2,), 2) if four else ((1,), 1)
    kw = dict(config=MULTI_CONFIG, batch_per_rank=BATCH_TF,
              steps=BENCH_STEPS, runs=BENCH_RUNS)
    log(f"[12] --scaling --worlds {worlds}:")
    scaling = bench_gpu.run_scaling(torch, worlds, **kw)
    _check_scaling("[12] --scaling", scaling, worlds)
    log(f"[12] --scaling --hosts {hosts} --chips-per-host {chips} "
        f"(init_distributed, separate processes):")
    hosts_rec = bench_gpu.run_hosts(torch, hosts, chips, **kw)
    _check_scaling("[12] --hosts", hosts_rec,
                   tuple(h * chips for h in hosts), hosts=True)
    log("[12] --collectives --full:")
    coll = bench_gpu.run_collectives(torch, full=True, steps=BENCH_STEPS,
                                     runs=BENCH_RUNS)
    _check_collectives(f"[12] --collectives ({coll['backend']} x"
                       f"{coll['world']})", coll)
    wall = time.perf_counter() - t0
    log(f"[12] multi-rank phase passed in {wall:.1f} s")
    return {"scaling": scaling, "hosts": hosts_rec, "collectives": coll,
            "wall_s": wall}


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, ROOT)
    # tests/live_stream.py: phase 8's EDI stream, TCP sender and feedback
    # client (it imports the port only)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
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
        inputs["frontend"] = phase_frontend(torch)
        launches = phase_paths(torch)
        stages, kernels, steps = phase_times(torch, inputs, launches, ptxas)
        variant_launches = phase_variants(torch)
        phase_fixed_point(torch)
        runtime = phase_runtime(torch, steps)
        live = phase_live(torch)
        dpd = phase_dpd(torch, card)
        sharded = phase_sharded(torch, card)
        bench = phase_bench(torch)
        multi = phase_multi_rank(torch)
    finally:
        for d in _TMP:
            shutil.rmtree(d, ignore_errors=True)
    # K1's launches in phase 6 and each kernel's in phases 7, 8, 9 and 10,
    # beside those of the full-width paths of phase 4
    kernels[0]["variant_launches"] = variant_launches["ofdm_ifft"]
    for k in kernels:
        base = "resample_poly" if k["name"].startswith("resample_poly") \
            else k["name"]
        # phase 4's launches on the card, from its trace (the graphs'
        # warm-ups and replays; "launches" is what the wrappers counted:
        # the warm-ups and captures)
        k["launches_on_card"] = sum(
            n[base] for path, n in launches[2].items()
            if base != "resample_poly" or path in K3_PATHS[k["rate"]])
        k["runtime_launches"] = {
            ini: rec["launches"][base]
            for ini, rec in (*runtime.items(), *live.items(), *dpd.items())
            if k.get("rate", 8_192_000) == rec["output_rate"]
            or base != "resample_poly"}
        # phase 10's launches, summed over the ranks of each run (K3 runs
        # there at 8.192 MS/s only): counted, and for a captured run on
        # the card (trace)
        k["sharded_launches"] = {
            f"{run['case']}@{run['backend']}x{run['world']}"
            + ("" if run["kind"] == "eager" else " captured"):
            run["launches"][base] if run["kind"] == "eager" else
            [run["launches"][base], run["launches_on_card"][base]]
            for run in sharded["runs"]
            if k.get("rate", 8_192_000) == 8_192_000
            or base != "resample_poly"}
        # phase 12's, summed over the ranks of each run (K3 at 4.096 MS/s,
        # beside its 8.192 MS/s row): counted, and for a scaling run also
        # on the card (main path's trace)
        if k.get("rate", 8_192_000) == 8_192_000 or base != "resample_poly":
            k["sharded_launches"].update(_multi_launches(multi, base))
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"[11] {json.dumps(bench)}")
    print(json.dumps({"card": card, "kernels": kernels, "steps": steps,
                      "eager_stages": stages, "runtime": runtime,
                      "live": live, "dpd": dpd, "sharded": sharded,
                      "multi_rank": multi}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
