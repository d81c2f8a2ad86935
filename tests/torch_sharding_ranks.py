"""Rank functions of tests/test_torch_sharding.py, run by
dabmod_tpu_torch.parallel.launch.spawn in processes of their own.  A
spawned rank imports this module anew, so it imports the port and numpy
only (the test module imports JAX).

Every input is made here from a seed, so the test process makes the same
ones for its references: ETI batches of N_TF TFs (synth_eti_batch), random
CIF bit rows for the time interleaver and random sample planes for the
resampler.  Results go back as numpy arrays.
"""
import copy
import threading

import numpy as np
import torch

from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
from dabmod_tpu_torch.models import Modulator, make_default_layout
from dabmod_tpu_torch.parallel import sharding

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # bench.py's ensemble
N_TF = 8          # TFs a batch: 2 a rank at world 4, 4 at world 2
BATCHES = 2       # consecutive batches, the state carried


def to_numpy(x):
    """Tensors (in tuples and dicts) as numpy arrays."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(to_numpy(v) for v in x)
    return x.cpu().numpy()


def ti_inputs(n_rows: int, widths, seed: int):
    """Per sub-channel of each width, random bits (uint8): the carried
    [15, width] histories, then BATCHES batches of [n_rows, width] rows."""
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 2, (r, w)).astype(np.uint8) for w in widths]
            for r in (15, *(n_rows,) * BATCHES)]


def res_inputs(m: Modulator, seed: int):
    """BATCHES batches of random (re, im) planes [N_TF, TF samples at
    2.048 MS/s]: the resampler's input."""
    rng = np.random.default_rng(seed)
    return [tuple(rng.standard_normal((N_TF, m.p.tf_samples))
                  .astype(np.float32) for _ in range(2))
            for _ in range(BATCHES)]


def eti_batches(mode: int, specs, seed: int):
    """BATCHES parsed ETI batches of N_TF TFs."""
    n = N_TF * {1: 4, 2: 1, 3: 1, 4: 2}[mode]
    raw = synth_eti_batch(BATCHES * n, mode=mode, subch_specs=specs,
                          seed=seed)
    return [parse_eti_frames(raw[k * n:(k + 1) * n]) for k in range(BATCHES)]


def make_modulator(settings, specs=BENCH_SPECS, device="cpu") -> Modulator:
    """A modulator on a copy of `settings` (a gain change sets the
    modulator's settings, as the RC does)."""
    return Modulator(make_default_layout(settings.dab_mode or 1, specs),
                     copy.copy(settings), device=device)


def apply_swap(m: Modulator, swap: dict):
    """A change between two batches, as the RC would make it: a hot swap
    of new FIR taps and poly DPD coefficients, and with "digital_gain" or
    "gain_mode_variance" new gain settings (`gain digital`, `gain var`)."""
    assert m.update_fir_taps(swap["fir_taps"])
    assert m.update_dpd("poly", swap["poly"])
    for key in ("digital_gain", "gain_mode_variance"):
        if key in swap:
            setattr(m.settings, key, swap[key])


def ti_streams(mesh, cases):
    """The sharded time interleaver on this rank's rows of each case
    (rows, sub-channel widths, seed), over BATCHES streamed batches:
    [(outputs, new histories) a batch] a case."""
    ti = sharding.make_sharded_time_interleave(mesh)
    results = []
    for n_rows, widths, seed in cases:
        hist, *batches = ti_inputs(n_rows, widths, seed)
        rows = mesh.tf_slice(n_rows)
        h = tuple(torch.as_tensor(x) for x in hist)
        res = []
        for bits in batches:
            out, h = ti([torch.as_tensor(b[rows]) for b in bits], h)
            res.append(to_numpy((tuple(out), h)))
        results.append(res)
    return results


def resample_streams(mesh, cases):
    """The sharded resampler on this rank's TFs of each case (settings,
    seed), over BATCHES streamed batches: (route, [(output planes, new
    carries) a batch]) a case."""
    results = []
    for settings, seed in cases:
        m = make_modulator(settings, device=mesh.device)
        resample = sharding.shard_resampler_backend(m, mesh)
        tfs = mesh.tf_slice(N_TF)
        state, res = m.init_state(), []
        for planes in res_inputs(m, seed):
            new = {}
            y = resample(tuple(torch.as_tensor(p[tfs], device=mesh.device)
                               for p in planes), state, new)
            res.append(to_numpy((y, new)))
            state = dict(state, **new)
        results.append((m._res_route, res))
    return results


def modulate_streams(mesh, cases):
    """ShardedModulator on each case (settings, specs, seed, swap or None),
    over BATCHES streamed batches, the swap applied before the second:
    per case a dict with "batches", a list of (this rank's output, the
    new state, this rank's stats, the gathered output, the step's
    (collectives, all_reduce buffer bytes) as sharding.EXCHANGES counted
    them), and "launches" (each kernel wrapper's launches over the
    stream)."""
    from dabmod_tpu_torch.ops import (frontend_kernel, ofdm_kernel,
                                      resampler_kernel)
    kernels = (ofdm_kernel.ofdm_backend, ofdm_kernel.ofdm_cfr_backend,
               resampler_kernel.resample, frontend_kernel.frontend)
    counts = sharding.EXCHANGES
    results = []
    for settings, specs, seed, swap in cases:
        m = make_modulator(settings, specs, mesh.device)
        sm = sharding.ShardedModulator(m, mesh)
        state, batches = sm.init_state(), []
        for k in kernels:
            k.launches = 0
        for k, b in enumerate(eti_batches(m.mode, specs, seed)):
            if k and swap:
                apply_swap(m, swap)
            counts.reset()
            out, state, stats = sm.modulate(b.fic, b.subchannels, state)
            made = (counts.collectives, counts.buffer_bytes)
            gathered = sm.gather(out, axis=1 if m._dexter else 0)
            batches.append(to_numpy((out, state, stats, gathered)) + (made,))
        results.append({"batches": batches,
                        "launches": [k.launches for k in kernels]})
    return results


def _graph_step(sm, stand_ins: bool):
    """sm with its step as a GraphStep of its _sharded_impl: set here over
    the stand-ins (a CPU mesh runs eagerly unless a caller sets it), made
    by ShardedModulator itself on the card over NCCL."""
    from dabmod_tpu_torch.models import compiled
    if stand_ins:
        assert sm.compiled is None
        sm.compiled = compiled.GraphStep(sm._sharded_impl)
    assert sm.compiled is not None, "the sharded step did not capture"
    return sm


def captured_streams(mesh, cases, stand_ins=True):
    """Each case (settings, specs, seed, swap or None) over BATCHES
    streamed batches, the swap applied before the second, through two
    ShardedModulators of this rank: one replaying a GraphStep of its
    _sharded_impl (over tests/torch_graph_stand_in.py's stand-ins with
    stand_ins, else on the card over NCCL), one eager.  Per case a dict:
    "captured" and "eager", (this rank's output, the new state, this
    rank's stats) a batch; "collectives", what sharding.EXCHANGES counted
    in each captured batch; "replays", each graph's replays by batch
    size.  Last, what a step with EXCHANGES timing raised in its capture
    (the first case) and the graphs it kept."""
    import contextlib

    import torch_graph_stand_in as stand_in
    counts = sharding.EXCHANGES
    results = []
    with stand_in.installed() if stand_ins else contextlib.nullcontext():
        for settings, specs, seed, swap in cases:
            batches = eti_batches(settings.dab_mode or 1, specs, seed)
            rec = {}
            for kind in ("eager", "captured"):
                m = make_modulator(settings, specs, mesh.device)
                sm = sharding.ShardedModulator(m, mesh)
                if kind == "captured":
                    _graph_step(sm, stand_ins)
                else:
                    sm.compiled = None
                state, res, made = sm.init_state(), [], []
                for k, b in enumerate(batches):
                    if k and swap:
                        apply_swap(m, swap)
                    counts.reset()
                    out, state, stats = sm.modulate(b.fic, b.subchannels,
                                                    state)
                    res.append(to_numpy((out, state, stats)))
                    made.append(counts.collectives)
                rec[kind] = res
            rec.update(collectives=made, replays={
                B: cap.replays for B, cap in sm.compiled.graphs.items()})
            results.append(rec)
        settings, specs, seed, _ = cases[0]
        sm = _graph_step(sharding.ShardedModulator(
            make_modulator(settings, specs, mesh.device), mesh), stand_ins)
        b = eti_batches(settings.dab_mode or 1, specs, seed)[0]
        counts.reset(timing=True)
        try:
            sm.modulate(b.fic, b.subchannels, sm.init_state())
            raised = None
        except RuntimeError as e:
            raised = str(e)
        finally:
            counts.reset()
        results.append((raised, len(sm.compiled.graphs)))
    return results


def run_cases(mesh, ti_cases, res_cases, mod_cases, captured_cases):
    """The four kinds of case in one spawn."""
    return (ti_streams(mesh, ti_cases), resample_streams(mesh, res_cases),
            modulate_streams(mesh, mod_cases),
            captured_streams(mesh, captured_cases))


def fail_capture_on_rank_0(mesh, settings):
    """A captured sharded step whose capture fails on rank 0 (a host
    synchronisation in its step), after the first collective: the other
    ranks wait for rank 0 in the capture's next collective."""
    import torch_graph_stand_in as stand_in
    with stand_in.installed():
        m = make_modulator(settings, device=mesh.device)
        sm = _graph_step(sharding.ShardedModulator(m, mesh), True)
        if mesh.rank == 0:
            symbols = m._ofdm_symbols_impl

            def syncing(*a, **k):
                out = symbols(*a, **k)
                int(out[0][0].flatten()[0] > 0)       # a host sync
                return out
            m._ofdm_symbols_impl = syncing
        b = eti_batches(m.mode, BENCH_SPECS, 3)[0]
        sm.modulate(b.fic, b.subchannels, sm.init_state())


def fail_on_rank_0(mesh):
    """Rank 0 raises; the others wait in a collective for it."""
    if mesh.rank == 0:
        raise ValueError("rank 0 fails on purpose")
    sharding.exchange_tails(torch.zeros(1), mesh)


def never_return(mesh):
    """Every rank waits for ever."""
    threading.Event().wait()
