"""The port's TF-sharded step (dabmod_tpu_torch.parallel) over gloo ranks on
the CPU, against the port's unsharded step and against dabmod_tpu's
ShardedModulator on the 8-device CPU mesh; and its captured form (a
GraphStep of ShardedModulator._sharded_impl, as on the card over NCCL)
over tests/torch_graph_stand_in.py's stand-ins for torch.cuda's graph
API, against the eager sharded step (bit for bit), the unsharded step and
dabmod_tpu, at worlds 1, 2 and 4.

The ranks run in spawned processes (parallel.launch.spawn) on the rank
functions of tests/torch_sharding_ranks.py, which import no JAX.  Each world
size is one spawn that runs every case (a module fixture), with a timeout,
so a deadlock fails the tests instead of hanging the suite.  The cuda test
of the sharded step on the card is in tests/test_torch_cuda.py, which runs
where JAX is not installed.

Tolerances: the time interleaver, the integer state (TI history, tf_index,
mer_index) and the carries that copy input samples (res_carry,
res_in_tail) equal to the bit; f32 output and the overlap-add tail that a
rank computes again from its halo within 3e-5*max|ref|
(tests/test_ofdm_kernel.py:88-89), 1e-4*max|ref| after the poly DPD; s16
words within 1 LSB with equal num_clipped; CFR clip counts equal, PAPR
within 1e-3 dB, MER within 0.1 dB.  Against JAX the carries are f32 values
(3e-5*max|ref|).
"""
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.models import Modulator as JModulator
from dabmod_tpu.models import make_default_layout as j_layout
from dabmod_tpu.ops import fft as jfft
from dabmod_tpu.parallel import sharding as jsharding
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.ops import fec
from dabmod_tpu_torch.parallel import (EXCHANGES, ShardedModulator, TfMesh,
                                       captures, init_distributed,
                                       make_host_chip_mesh, make_mesh,
                                       make_sharded_time_interleave)
from dabmod_tpu_torch.parallel import sharding
from dabmod_tpu_torch.parallel.launch import spawn
from torch.utils._pytree import tree_leaves

import torch_sharding_ranks as R

WORLDS = (2, 4)
CAPTURED_WORLDS = (1, 2, 4)
SPAWN_TIMEOUT_S = 240.0
# (rows, sub-channel widths, seed): tl = rows / 4 = 1, 4 and 16 CIF rows a
# rank at world 4 (one TF of TM II, one of TM I, four of TM I)
TI_CASES = [(4, (1024, 3072), 1), (16, (1024, 3072), 2),
            (64, (1024, 3072), 3)]
# each resampler route: the plain polyphase form, the frequency-domain
# form, K3's plan (its plain form on the CPU)
RES_RATES = {"poly": 2_500_000, "fft": 1_024_000, "kernel": 4_096_000}
AM2 = (0.9, 0.12, -0.04, 0.01, -0.005)     # the hot swap's coefficients
PM2 = (0.01, -0.02, 0.004, 0.001, 0.0)


def _write_poly(path, am=(1.0, 0.1, -0.05, 0.02, -0.01),
                pm=(0.02, -0.01, 0.005, 0.0, 0.0)):
    """A format-1 DPD file, tests/test_filters.py:133-134's coefficients."""
    with open(path, "w") as f:
        f.write("1\n5\n" + "".join(f"{v!r}\n" for v in (*am, *pm)))
    return str(path)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """name -> (port settings, dabmod_tpu settings or None, swap or None)."""
    coef = _write_poly(tmp_path_factory.mktemp("dpd") / "poly.coef")
    chain = dict(dab_mode=1, tii_enable=True, tii_comb=5, tii_pattern=31,
                 enable_cfr=True, cfr_clip=30.0, cfr_error_clip=0.1,
                 ofdm_window_overlap=10, filter_taps_file="default",
                 output_rate=4_096_000, poly_coef_file=coef, output="uhd",
                 device_interleave=False)
    s16 = dict(dab_mode=1, output="file", file_output_format="s16")
    swap = {"fir_taps": np.asarray(tables.DEFAULT_FIR_TAPS, np.float32)[::-1]
            .copy(), "poly": (np.float32(AM2), np.float32(PM2))}

    def both(kw):
        return (ModSettings(**kw).normalise_for_output(),
                JSettings(**kw).normalise_for_output())
    return {"s16": (*both(s16), None), "chain": (*both(chain), None),
            "swap": (both(chain)[0], None, swap),
            "dexter": (ModSettings(dab_mode=1, fft_engine="dexter"), None,
                       None)}


def _res_settings(route):
    return ModSettings(dab_mode=1, output_rate=RES_RATES[route])


@pytest.fixture(scope="module")
def captured_cases(cases):
    """The captured sharded step's cases: name -> (port settings,
    dabmod_tpu settings or None, swap or None).  s16 (no resampler), the
    DPD chain (K3's route), the plain polyphase and the frequency-domain
    routes (f32 pairs), and the chain with a hot swap and an RC gain
    change before the second batch."""
    swap = dict(cases["swap"][2], digital_gain=0.8, gain_mode_variance=3.0)
    return {"s16": cases["s16"], "chain": cases["chain"],
            "poly": (_res_settings("poly"), None, None),
            "fft": (_res_settings("fft"), None, None),
            "swap_gain": (cases["chain"][0], None, swap)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cases, captured_cases):
    """world -> the ranks' results of R.run_cases on every case (one spawn
    a world, made at first use; a failed spawn fails every test of it).
    World 1 runs the captured cases only."""
    made = {}

    def get(world):
        if world not in made:
            mod = [(s, R.BENCH_SPECS, 11, swap)
                   for s, _, swap in cases.values()]
            cap = [(s, R.BENCH_SPECS, 11, swap)
                   for s, _, swap in captured_cases.values()]
            ti, res = TI_CASES, [(_res_settings(r), 7) for r in RES_RATES]
            if world == 1:
                ti, res, mod = [], [], []
            try:
                made[world] = spawn(
                    R.run_cases, world, backend="gloo", device="cpu",
                    store_path=str(tmp_path_factory.mktemp("store")),
                    timeout_s=SPAWN_TIMEOUT_S, args=(ti, res, mod, cap))
            except RuntimeError as e:
                made[world] = e
        if isinstance(made[world], Exception):
            raise made[world]
        return made[world]
    return get


def _unsharded_stream(s, swap):
    """The port's unsharded step on each batch, the swap applied before
    the second: (output, state, stats), numpy."""
    m = R.make_modulator(s)
    state, res = m.init_state(), []
    for k, b in enumerate(R.eti_batches(m.mode, R.BENCH_SPECS, 11)):
        if k and swap:
            R.apply_swap(m, swap)
        o, state, stats = m.modulate_eti(b, state)
        res.append(R.to_numpy((o, state, stats)))
    return res


@pytest.fixture(scope="module")
def unsharded(cases, captured_cases):
    """name -> the port's unsharded step on each batch of every case and
    captured case."""
    both = dict(cases, **captured_cases)
    return {name: _unsharded_stream(s, swap)
            for name, (s, _, swap) in both.items()}


def _cat(parts, axis=0):
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate(p, axis=axis) for p in zip(*parts))
    return np.concatenate(parts, axis=axis)


def _mod_index(cases, name):
    return list(cases).index(name)


def _assert_close(got, ref, tol):
    """tol "exact", "lsb" (s16 words: each int16 within 1) or a float
    (f32 within tol*max|ref|); got and ref arrays or tuples of them."""
    for g, r in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, ref))):
        assert g.shape == r.shape and g.dtype == r.dtype
        if tol == "exact":
            np.testing.assert_array_equal(g, r)
        elif tol == "lsb":
            d = np.abs(g.view(np.int16).astype(np.int32)
                       - r.view(np.int16).astype(np.int32)).max()
            assert d <= 1, d
        else:
            np.testing.assert_allclose(g, r, atol=tol * np.abs(r).max(),
                                       rtol=0)


def _tol(s):
    """The output tolerance of a port setting."""
    if s.fft_engine == "dexter":
        return "exact"
    if s.output == "file" and s.file_output_format == "s16":
        return "lsb"
    return 1e-4 if s.poly_coef_file else 3e-5


def _assert_state(got, ref, exact_floats=True, rel=3e-5):
    assert set(got) == set(ref)
    for a, b in zip(got["ti_history"], ref["ti_history"]):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int32),
                                      np.asarray(b).astype(np.int32))
    for key in ("tf_index", "mer_index"):
        if key in ref:
            assert int(got[key]) == int(np.asarray(ref[key])), key
    for key in ("res_carry", "res_in_tail", "res_out_tail"):
        if key in ref:
            g, r = (np.asarray(got[key]), np.asarray(ref[key]))
            if exact_floats and key != "res_out_tail":
                np.testing.assert_array_equal(g, r)
            else:
                np.testing.assert_allclose(g, r, rtol=0,
                                           atol=rel * np.abs(r).max())


def _assert_stats(got, ref):
    assert set(got) == set(ref)
    for key in ("cfr_clip", "cfr_errclip", "mer_valid", "num_clipped"):
        if key in ref:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(ref[key]))
    for key, atol in (("papr_before_cfr", 1e-3), ("papr_after_cfr", 1e-3),
                      ("mer_db", 0.1)):
        if key in ref:
            np.testing.assert_allclose(got[key], np.asarray(ref[key]),
                                       atol=atol, rtol=0)


def _sharded(res, world, index):
    """The sharded stream of a modulate case: per batch (global output,
    each rank's state, global stats, each rank's gathered output, each
    rank's exchanges)."""
    per_rank = [r[2][index] for r in res]
    out = []
    for k in range(R.BATCHES):
        b = [p["batches"][k] for p in per_rank]
        axis = 1 if isinstance(b[0][0], np.ndarray) and b[0][0].ndim == 4 \
            else 0
        stats = {key: (b[0][2][key] if key == "num_clipped"
                       else np.concatenate([x[2][key] for x in b]))
                 for key in b[0][2]}
        out.append((_cat([x[0] for x in b], axis), [x[1] for x in b],
                    stats, [x[3] for x in b], [x[4] for x in b]))
    return out, per_rank


# ---------------------------------------------------------------------------
# case 1: the time interleaver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_time_interleave_is_bit_identical(ranks, world):
    """Over two streamed batches of two sub-channels, the ranks' output
    rows are fec.time_interleave's and every rank's new histories are the
    batch's, for 1, 4 and 16 rows a rank at world 4 (the halo from 15, 4
    and 1 ranks before)."""
    res = ranks(world)
    for ci, (n_rows, widths, seed) in enumerate(TI_CASES):
        hist, *batches = R.ti_inputs(n_rows, widths, seed)
        h = [torch.as_tensor(x) for x in hist]
        for k, bits in enumerate(batches):
            for j, b in enumerate(bits):
                out, h[j] = fec.time_interleave(torch.as_tensor(b), h[j])
                got = np.concatenate([r[0][ci][k][0][j] for r in res])
                np.testing.assert_array_equal(got, out.numpy())
                for r in res:
                    np.testing.assert_array_equal(r[0][ci][k][1][j],
                                                  h[j].numpy())


def test_world_one_is_the_plain_time_interleaver():
    assert make_sharded_time_interleave(make_mesh(device="cpu")) \
        is fec.time_interleave_all


# ---------------------------------------------------------------------------
# case 2: the resampler's carries, all three routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(RES_RATES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_resampler_streams(ranks, world, route):
    """Two batches of random planes through each route's sharded form
    equal the unsharded stream (3e-5*max|ref|: the frequency-domain form
    batches its transforms otherwise); the carries copied from input
    samples are equal to the bit on every rank, the recomputed
    overlap-add tail within 3e-5*max|ref|."""
    res = ranks(world)
    ci = list(RES_RATES).index(route)
    m = R.make_modulator(_res_settings(route))
    assert m._res_route == route and all(r[1][ci][0] == route for r in res)
    state = m.init_state()
    for k, planes in enumerate(R.res_inputs(m, 7)):
        new = {}
        y = m._resample(tuple(torch.as_tensor(p) for p in planes), state,
                        new)
        state = dict(state, **new)
        got = _cat([r[1][ci][1][k][0] for r in res])
        _assert_close(got, R.to_numpy(y), 3e-5)
        for r in res:
            carries = r[1][ci][1][k][1]
            assert set(carries) == set(new)
            for key, v in R.to_numpy(new).items():
                exact = key != "res_out_tail"
                for g, x in zip(*(c if isinstance(c, tuple) else (c,)
                                  for c in (carries[key], v))):
                    if exact:
                        np.testing.assert_array_equal(g, x)
                    else:
                        np.testing.assert_allclose(
                            g, x, rtol=0, atol=3e-5 * np.abs(x).max())


# ---------------------------------------------------------------------------
# case 3: ShardedModulator against the unsharded step and against JAX
# ---------------------------------------------------------------------------

MOD_CASES = ("s16", "chain", "dexter")


def _exchanges(s, world):
    """(collectives, all_reduce buffer bytes) of a sharded step on a batch
    of N_TF TFs: world slots of each rank's last min(CIF rows, 15) rows of
    every sub-channel's TI width (uint8 bits), of the resampler's halo
    (2*2*half f32 of the polyphase forms, fft_in f32 pairs of the
    frequency-domain form) and of num_clipped (an int32)."""
    m = R.make_modulator(s)
    rows = min(R.N_TF // world * m.p.cif_count, 15)
    sizes = [rows * sum(m._subch_ti_bits)]
    if m._res_route == "fft":
        sizes.append(m._res_plan.fft_in * 2 * 4)
    elif m._res_route is not None:
        sizes.append(2 * 2 * m._res_plan.half * 4)
    if m._wire_fmt is not None and not m._dexter:
        sizes.append(4)
    return len(sizes), world * sum(sizes)


@pytest.mark.parametrize("name", MOD_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_modulator_matches_unsharded(ranks, unsharded, cases,
                                             world, name):
    """Two streamed batches: this rank's TFs of the unsharded output, the
    same state on every rank, the per-TF stats and the global num_clipped;
    gather gives every rank the global output; each rank's step made the
    collectives and moved the bytes _exchanges counts."""
    res = ranks(world)
    s = cases[name][0]
    streams, per_rank = _sharded(res, world, _mod_index(cases, name))
    for (out, states, stats, gathered, made), (ref, ref_state, ref_stats) \
            in zip(streams, unsharded[name]):
        _assert_close(out, ref, _tol(s))
        for st in states:
            _assert_state(st, ref_state)
        _assert_stats(stats, ref_stats)
        for g in gathered:
            _assert_close(g, out, "exact")
        assert made == [_exchanges(s, world)] * world


_JAX_STREAMS = {}


def _jax_stream(s, world):
    """_jax_stream_of(s, world), computed once a module run."""
    key = (repr(s), world)
    if key not in _JAX_STREAMS:
        _JAX_STREAMS[key] = _jax_stream_of(s, world)
    return _JAX_STREAMS[key]


def _jax_stream_of(s, world):
    """dabmod_tpu's ShardedModulator on make_mesh(world) over the same two
    batches.  Its step returns the resampler carry sharded over 'tf', and
    its jit takes only a replicated state, so the state is put back
    replicated between batches."""
    jm = JModulator(j_layout(1, R.BENCH_SPECS), s)
    sm = jsharding.ShardedModulator(jm, jsharding.make_mesh(world))
    state, res = sm.init_state(), []
    try:
        for b in R.eti_batches(1, R.BENCH_SPECS, 11):
            out, state, stats = sm.modulate(b.fic, tuple(b.subchannels),
                                            state)
            res.append(jax.tree.map(np.asarray, (out, state, stats)))
            state = jax.tree.map(
                lambda x: jax.device_put(np.asarray(x), sm._replicated),
                state)
    finally:
        jfft.set_precision("high")
    return res


@pytest.mark.parametrize("name", ("s16", "chain"))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_modulator_matches_jax(ranks, cases, world, name):
    """The same two batches through dabmod_tpu's ShardedModulator at the
    same world size: the output (f32 planes within 1e-4*max|ref| after the
    poly DPD, s16 within 1 LSB), the integer state exact, the carries
    within 3e-5*max|ref|, the stats."""
    if jax.device_count() < max(WORLDS):
        pytest.skip("needs the 8-device CPU mesh")
    port_s, jax_s, _ = cases[name]
    streams, _ = _sharded(ranks(world), world, _mod_index(cases, name))
    for (out, states, stats, _, _), (ref, ref_state, ref_stats) in zip(
            streams, _jax_stream(jax_s, world)):
        _assert_close(out, ref, _tol(port_s))
        _assert_state(states[0], ref_state, exact_floats=False)
        _assert_stats(stats, ref_stats)


# ---------------------------------------------------------------------------
# case 4: a hot swap reaches the sharded step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_hot_swap_reaches_the_sharded_step(ranks, unsharded, cases, world):
    """update_fir_taps and update_dpd on the wrapped modulator between two
    batches: the sharded step's second batch equals the unsharded step's
    with the same swap, and differs from the batch without it.
    (dabmod_tpu's sharded step would not follow the swap: it bakes the
    taps and coefficients in at its first trace.)"""
    streams, _ = _sharded(ranks(world), world, _mod_index(cases, "swap"))
    (out, states, _, _, _), (ref, ref_state, _) = \
        streams[1], unsharded["swap"][1]
    _assert_close(out, ref, 1e-4)
    for st in states:
        _assert_state(st, ref_state)
    plain = _sharded(ranks(world), world, _mod_index(cases, "chain"))[0]
    assert np.abs(out[0] - plain[1][0][0]).max() > 1e-2 * np.abs(
        ref[0]).max()


# ---------------------------------------------------------------------------
# case 5: the captured sharded step (GraphStep of _sharded_impl over the
# stand-ins), as on the card over NCCL
# ---------------------------------------------------------------------------

CAPTURED = ("s16", "chain", "poly", "fft", "swap_gain")


def _captured(res, name, kind):
    """The stream of a captured case's `kind` ("captured" or "eager") run:
    per batch (global output, each rank's state, global stats, each
    rank's (output, state, stats))."""
    index = CAPTURED.index(name)
    per_rank = [r[3][index][kind] for r in res]
    out = []
    for k in range(R.BATCHES):
        b = [p[k] for p in per_rank]
        axis = 1 if isinstance(b[0][0], np.ndarray) and b[0][0].ndim == 4 \
            else 0
        stats = {key: (b[0][2][key] if key == "num_clipped"
                       else np.concatenate([x[2][key] for x in b]))
                 for key in b[0][2]}
        out.append((_cat([x[0] for x in b], axis), [x[1] for x in b],
                    stats, b))
    return out


def _same_bits(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CAPTURED)
@pytest.mark.parametrize("world", CAPTURED_WORLDS)
def test_captured_sharded_step_equals_eager(ranks, world, name):
    """Two streamed batches (a hot swap and a gain change before the
    second in swap_gain): on every rank the captured step's output, state
    and stats equal the eager sharded step's to the bit; one graph, made
    at the first batch and replayed at both."""
    res = ranks(world)
    for r in res:
        rec = r[3][CAPTURED.index(name)]
        _same_bits(rec["captured"], rec["eager"])
        assert rec["replays"] == {R.N_TF // world: R.BATCHES}


@pytest.mark.parametrize("name", CAPTURED)
@pytest.mark.parametrize("world", CAPTURED_WORLDS)
def test_captured_sharded_step_matches_unsharded(ranks, unsharded,
                                                 captured_cases, world,
                                                 name):
    """The captured step's global output, every rank's state and the
    stats against the unsharded step's (with the same swap and gain
    change), under test_sharded_modulator_matches_unsharded's
    tolerances."""
    s = captured_cases[name][0]
    for (out, states, stats, _), (ref, ref_state, ref_stats) in zip(
            _captured(ranks(world), name, "captured"), unsharded[name]):
        _assert_close(out, ref, _tol(s))
        for st in states:
            _assert_state(st, ref_state)
        _assert_stats(stats, ref_stats)


@pytest.mark.parametrize("name", ("s16", "chain"))
@pytest.mark.parametrize("world", CAPTURED_WORLDS)
def test_captured_sharded_step_matches_jax(ranks, captured_cases, world,
                                           name):
    """test_sharded_modulator_matches_jax for the captured step: f32
    planes within 1e-4*max|ref| after the poly DPD, s16 within 1 LSB, the
    integer state exact, the carries within 3e-5*max|ref|, the stats."""
    if jax.device_count() < max(CAPTURED_WORLDS):
        pytest.skip("needs the 8-device CPU mesh")
    port_s, jax_s, _ = captured_cases[name]
    for (out, states, stats, _), (ref, ref_state, ref_stats) in zip(
            _captured(ranks(world), name, "captured"),
            _jax_stream(jax_s, world)):
        _assert_close(out, ref, _tol(port_s))
        _assert_state(states[0], ref_state, exact_floats=False)
        _assert_stats(stats, ref_stats)


@pytest.mark.parametrize("world", CAPTURED_WORLDS)
def test_swap_and_gain_reach_the_next_replay(ranks, world):
    """The hot swap and the gain change between two replays of one graph
    change the second batch on every rank: it differs from the captured
    chain's second batch without them, by more than the tolerance."""
    got = _captured(ranks(world), "swap_gain", "captured")[1]
    plain = _captured(ranks(world), "chain", "captured")[1]
    for (g, _, _), (p, _, _) in zip(got[3], plain[3]):
        assert np.abs(g[0] - p[0]).max() > 1e-2 * np.abs(p[0]).max()


@pytest.mark.parametrize("world", CAPTURED_WORLDS)
def test_exchanges_count_warm_up_and_capture_not_replays(ranks, cases,
                                                         world):
    """EXCHANGES counts the collectives where they are issued: the first
    batch's warm-up and capture make two steps' worth, its replay and the
    second batch's none (a replay runs no Python)."""
    per_step = _exchanges(cases["s16"][0], world)[0] if world > 1 else 1
    for r in ranks(world):
        assert r[3][CAPTURED.index("s16")]["collectives"] == [
            2 * per_step, 0]


@pytest.mark.parametrize("world", CAPTURED_WORLDS)
def test_timing_inside_a_capture_raises(ranks, world):
    """EXCHANGES with timing on: the warm-up runs, the capture raises on
    every rank (its events would time the capture, not a replay) and no
    graph is kept."""
    for r in ranks(world):
        raised, graphs = r[3][-1]
        assert raised and "graph capture" in raised and graphs == 0


def test_a_rank_failing_its_capture_ends_the_spawn(tmp_path, cases):
    """Rank 0's capture fails after the first collective; rank 1 waits in
    the next one.  The spawn raises with rank 0's traceback well within
    its timeout, and leaves no rank running."""
    import multiprocessing as mp
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="stream is capturing"):
        spawn(R.fail_capture_on_rank_0, 2, backend="gloo", device="cpu",
              store_path=str(tmp_path), timeout_s=SPAWN_TIMEOUT_S,
              args=(cases["s16"][0],))
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S / 2
    assert not mp.active_children()


def test_graphs_only_over_nccl_on_the_card(monkeypatch):
    """captures(): a CUDA mesh over NCCL, or alone at world 1 with no
    group; never over gloo (its all_reduce of CUDA tensors copies through
    the host) or on the CPU.  A CPU ShardedModulator runs eagerly, with
    its own compiled attribute apart from the modulator's."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    group = object()
    for backend, dev, world, want in (
            ("nccl", cuda, 2, True), ("gloo", cuda, 2, False),
            ("nccl", cpu, 2, False), ("gloo", cpu, 4, False)):
        monkeypatch.setattr(sharding.dist, "get_backend",
                            lambda g, b=backend: b)
        assert captures(TfMesh(group, world, 0, ("tf",), dev)) is want
    assert captures(TfMesh(None, 1, 0, ("tf",), cuda))
    assert not captures(TfMesh(None, 1, 0, ("tf",), cpu))
    m = R.make_modulator(ModSettings(dab_mode=1))
    sm = ShardedModulator(m, make_mesh(device="cpu"))
    assert sm.compiled is None and m.compiled is None


# ---------------------------------------------------------------------------
# case 6: meshes, splits and the device rule
# ---------------------------------------------------------------------------

def test_batch_that_does_not_split_raises():
    m = R.make_modulator(ModSettings(dab_mode=1))
    sm = ShardedModulator(m, make_mesh(world_size=4, rank=1, device="cpu"))
    b = R.eti_batches(1, R.BENCH_SPECS, 3)[0]
    with pytest.raises(ValueError, match=r"6 TFs .* over 4 ranks"):
        sm.modulate(b.fic[:24], [x[:24] for x in b.subchannels],
                    sm.init_state())
    with pytest.raises(ValueError, match="6 TFs does not split over 4"):
        make_mesh(world_size=4, rank=0, device="cpu").tf_slice(6)


def test_host_chip_mesh_matches_jax_index_map():
    """Rank h*chips + c of make_host_chip_mesh(2, 2) takes the TFs that
    JAX's NamedSharding(make_host_chip_mesh(2, 2), P(('host', 'chip')))
    gives the device at (h, c)."""
    if jax.device_count() < 4:
        pytest.skip("needs the 8-device CPU mesh")
    jmesh = jsharding.make_host_chip_mesh(2, 2)
    index = NamedSharding(jmesh, P(("host", "chip"))).devices_indices_map(
        (8,))
    for h in range(2):
        for c in range(2):
            mesh = make_host_chip_mesh(2, 2, rank=2 * h + c, device="cpu")
            assert mesh.axis_names == ("host", "chip")
            assert mesh.world_size == 4
            assert mesh.tf_slice(8) == index[jmesh.devices[h, c]][0]


def test_device_none_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is the card")
    for call in (make_mesh, lambda: make_host_chip_mesh(2, 2, rank=0),
                 lambda: init_distributed("127.0.0.1:1", 1, 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_world_one_is_the_unsharded_step(unsharded, cases):
    """Without torch.distributed, a world-1 mesh runs the unsharded step
    bit for bit, makes no collective and leaves the modulator as it
    was."""
    s = cases["s16"][0]
    m = R.make_modulator(s)
    attrs = dict(vars(m))
    sm = ShardedModulator(m, make_mesh(device="cpu"))
    EXCHANGES.reset()
    state = sm.init_state()
    for b, (ref, ref_state, ref_stats) in zip(
            R.eti_batches(1, R.BENCH_SPECS, 11), unsharded["s16"]):
        out, state, stats = sm.modulate(b.fic, b.subchannels, state)
        np.testing.assert_array_equal(out.numpy(), ref)
        _assert_state(R.to_numpy(state), ref_state)
        assert int(stats["num_clipped"]) == int(ref_stats["num_clipped"])
    assert (EXCHANGES.collectives, EXCHANGES.buffer_bytes) == (0, 0)
    assert vars(m).keys() == attrs.keys()
    assert all(vars(m)[k] is v for k, v in attrs.items())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_spawn_reports_a_failing_rank(tmp_path):
    """A rank's exception fails the call with its traceback, and the rank
    that waits for it in a collective is not left running."""
    import multiprocessing as mp
    with pytest.raises(RuntimeError, match="rank 0 fails on purpose"):
        spawn(R.fail_on_rank_0, 2, backend="gloo", device="cpu",
              store_path=str(tmp_path), timeout_s=60)
    assert not mp.active_children()


def test_spawn_times_out(tmp_path):
    """Ranks that never return fail the call at its timeout and are
    stopped."""
    import multiprocessing as mp
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no result after 8"):
        spawn(R.never_return, 2, backend="gloo", device="cpu",
              store_path=str(tmp_path), timeout_s=8)
    assert time.monotonic() - t0 < 60
    assert not mp.active_children()
