"""The polyphase resampler of the port (dabmod_tpu_torch.ops.filters and the
K3 backend ops.resampler_kernel) against dabmod_tpu.

The plan is the same to the bit; the kernel's per-phase tap table rebuilds
the plan's operator to the bit; on the CPU the K3 wrapper takes its plain
version, which is held against dabmod_tpu's resample_poly (fp32 on the
CPU: rtol 1e-5, atol 1e-5*max|ref|, sums in other orders) and against its
Pallas kernel run in interpret mode (tests/test_filters.py:236's rtol
1e-3, atol 2e-4: that kernel emulates Precision.HIGH with a bf16 split).
The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py);
its index arithmetic is transcribed to NumPy in
tests/resampler_model.py and held here against the plain version, JAX's
resample_poly and an in-order fmaf sum of the unpadded band (bit for bit),
with its shared-memory accesses checked for bank conflicts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resampler_model as model
from dabmod_tpu.ops import filters as jfilters
from dabmod_tpu.ops import resampler_kernel as jrk
from dabmod_tpu_torch.ops import filters, resampler_kernel as rk

BASE = 2_048_000


def _plan(rate):
    return filters.PolyphasePlan.create(BASE, rate)


def _jplan(rate):
    """dabmod_tpu's plan with the 128-sample framing its kernel takes."""
    return jfilters.PolyphasePlan.create(BASE, rate, block=128)


def _stream(n, h2, seed):
    rng = np.random.default_rng(seed)
    x = tuple(rng.standard_normal(n).astype(np.float32) for _ in range(2))
    c = tuple(rng.standard_normal(h2).astype(np.float32) for _ in range(2))
    return x, c


def _t(a):
    return tuple(torch.as_tensor(v) for v in a)


@pytest.mark.parametrize("rate", [4_096_000, 8_192_000, 2_500_000,
                                  3_072_000, 6_144_000, 1_024_000])
def test_plan_matches_reference(rate):
    got = _plan(rate)
    ref = _jplan(rate)
    assert (got.L, got.M, got.half, got.block, got.out_block) == \
        (ref.L, ref.M, ref.half, ref.block, ref.out_block)
    assert got.matrix.dtype == np.float32
    np.testing.assert_array_equal(got.matrix, ref.matrix)


@pytest.mark.parametrize("rate,L,M", [(4_096_000, 2, 1), (8_192_000, 4, 1),
                                      (3_072_000, 3, 2), (6_144_000, 3, 1),
                                      (1_024_000, 1, 2)])
def test_compact_taps_rebuild_the_operator_exactly(rate, L, M):
    plan = _plan(rate)
    row0, taps = rk.compact_taps(plan)
    assert (plan.L, plan.M) == (L, M) and taps.shape == (L, 2 * plan.half + 1)
    np.testing.assert_array_equal(rk.expand_taps(row0, taps, plan),
                                  plan.matrix)
    # column p's band starts at row ceil(p*M/L)
    np.testing.assert_array_equal(row0, -(-np.arange(L) * M // L))
    table = rk.make_table(plan, "cpu")
    assert table.n_taps == taps.shape[1]
    np.testing.assert_array_equal(table.taps.numpy(), taps)


def test_unsupported_plans_are_refused():
    plan = _plan(2_500_000)                 # M = 512: 512-sample frames
    assert not rk.supports(plan) and rk.supports(_plan(8_192_000))
    with pytest.raises(ValueError, match="128-sample"):
        rk.make_table(plan, "cpu")
    bad = _plan(8_192_000)
    row0, taps = rk.compact_taps(bad)
    taps = taps.copy()
    taps[3, -1] = 1.0                       # reaches beyond the frame
    with pytest.raises(ValueError, match="beyond"):
        rk.expand_taps(row0 + 1, taps, bad)


RATES = [4_096_000, 8_192_000, 3_072_000, 1_024_000]   # M = 1, 1, 2, 2


@pytest.mark.parametrize("rate", RATES)
def test_plain_matches_reference_resample_poly(rate):
    plan = _plan(rate)
    table = rk.make_table(plan, "cpu")
    x, c = _stream(4096, 2 * plan.half, seed=7)
    (yr, yi), carry = rk.resample(_t(x), _t(c), table)
    ref, ref_carry = jfilters.resample_poly(
        tuple(jnp.asarray(v) for v in x), _jplan(rate),
        tuple(jnp.asarray(v) for v in c))
    assert yr.shape == (4096 * plan.L // plan.M,)
    scale = float(np.abs(np.asarray(ref[0])).max())
    for g, r in zip((yr, yi), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5 * scale)
    for g, r in zip(carry, ref_carry):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("rate", RATES)
def test_plain_matches_pallas_kernel(rate):
    plan = _plan(rate)
    apply = jrk.build_resampler_backend(_jplan(rate), interpret=True)
    x, _ = _stream(4096, 2 * plan.half, seed=8)
    z = np.zeros(2 * plan.half, np.float32)
    (kr, ki), kc = jax.jit(apply)(tuple(jnp.asarray(v) for v in x),
                                  (jnp.asarray(z),) * 2)
    (yr, yi), carry = rk.resample(_t(x), _t((z, z)), rk.make_table(plan,
                                                                   "cpu"))
    # the kernel's [n/128, 128*L/M] rows are the stream in row-major order
    for g, r in zip((yr, yi), (kr, ki)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r).reshape(-1),
                                   rtol=1e-3, atol=2e-4)
    np.testing.assert_array_equal(carry[0].numpy(), np.asarray(kc[0]))


@pytest.mark.parametrize("rate", RATES)
def test_split_stream_equals_one_call(rate):
    plan = _plan(rate)
    table = rk.make_table(plan, "cpu")
    x, c = _stream(2048, 2 * plan.half, seed=9)
    (whole_r, whole_i), whole_c = rk.resample(_t(x), _t(c), table)
    (ar, ai), mid = rk.resample(_t(v[:1024] for v in x), _t(c), table)
    (br, bi), end = rk.resample(_t(v[1024:] for v in x), mid, table)
    for got, ref in ((torch.cat([ar, br]), whole_r),
                     (torch.cat([ai, bi]), whole_i)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6)
    for g, r in zip(end, whole_c):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


@pytest.mark.parametrize("rate", RATES)
def test_kernel_sum_equals_plain(rate):
    """The sum the CUDA kernel computes, y[q*L + p] = sum_k xp[q*M +
    row0[p] + k] * taps[p, k] over the flat stream, written out in NumPy
    (float64) == the plain framed product."""
    plan = _plan(rate)
    table = rk.make_table(plan, "cpu")
    x, c = _stream(1024, 2 * plan.half, seed=10)
    xp = np.concatenate([c[0], x[0]]).astype(np.float64)
    taps = table.taps.numpy().astype(np.float64)
    row0 = table.row0.numpy()
    q = np.arange(1024 // plan.M)[:, None]
    want = np.zeros((q.shape[0], plan.L))
    for p in range(plan.L):
        idx = q * plan.M + row0[p] + np.arange(table.n_taps)[None, :]
        inside = idx < xp.shape[0]
        want[:, p] = (np.where(inside, xp[np.minimum(idx, xp.shape[0] - 1)],
                               0.0) * taps[p]).sum(axis=1)
    (yr, _), _ = rk.resample_plain(_t(x), _t(c), table)
    np.testing.assert_allclose(yr.numpy(), want.reshape(-1), rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rate", RATES)
def test_table_stages_each_block_in_its_shared_memory(rate):
    """A block's staged run covers the band of every output it computes,
    and smem_bytes, which the launch passes, is the kernel's carve-up (two
    buffers of two planes of the staged run, two planes of L staged output
    rows) within the limits make_table keeps to."""
    plan = _plan(rate)
    table = rk.make_table(plan, "cpu")
    lay = table.layout
    mt, kp, R = rk.INSTANCES[lay.instance]
    L, K = plan.L, table.n_taps
    assert lay.q_per_chunk == 32 * R * lay.tiles * lay.groups
    if mt:                       # aligned taps: one window for all phases
        assert mt == plan.M and int(table.row0.max()) + K <= kp
        last = (lay.q_per_chunk - 1) * plan.M + kp
        assert lay.in_len == model.Block(table).staged(lay.span - 1) + 1
    else:
        last = (lay.q_per_chunk - 1) * plan.M + int(table.row0.max()) + K
        assert lay.in_len == plan.M * lay.in_row
        assert lay.in_row >= -(-lay.span // plan.M)
    assert last <= lay.span
    assert lay.out_row >= lay.q_per_chunk
    assert lay.smem_bytes == 4 * (4 * lay.in_len + 2 * L * lay.out_row)
    assert lay.smem_bytes <= rk.SMEM_TARGET


# the plans of compile-time M (RATES), and two with run-time M
MODEL_RATES = RATES + [1_536_000, 1_792_000]     # L/M 3/4 (K 43), 7/8 (37)


@pytest.mark.parametrize("rate", MODEL_RATES)
def test_kernel_model_matches_plain_and_reference(rate):
    """The kernel as transcribed (staging, work items, windows, swizzled
    output rows, store order) on a stream whose last block is ragged,
    against the plain version and dabmod_tpu's resample_poly."""
    plan = _plan(rate)
    table = rk.make_table(plan, "cpu")
    n = 128 * 37
    assert (n // plan.M) % table.layout.q_per_chunk
    x, c = _stream(n, 2 * plan.half, seed=13)
    got = model.run(table, x, c)
    (pr, pi), _ = rk.resample_plain(_t(x), _t(c), table)
    ref, _ = jfilters.resample_poly(tuple(jnp.asarray(v) for v in x),
                                    _jplan(rate),
                                    tuple(jnp.asarray(v) for v in c))
    scale = float(np.abs(np.asarray(ref[0])).max())
    for g, p_, r in zip(got, (pr, pi), ref):
        assert g.shape == (n * plan.L // plan.M,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, p_.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-5,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("rate", MODEL_RATES)
def test_kernel_model_padded_band_sums_are_bit_identical(rate):
    """K padded to KP with zero taps (and, with compile-time M, each band
    moved down by row0[p]) leaves every sum equal bit for bit to the
    in-order fmaf chain over the unpadded band, and two half-stream runs
    equal one."""
    plan = _plan(rate)
    table = rk.make_table(plan, "cpu")
    n = 128 * 24
    x, c = _stream(n, 2 * plan.half, seed=14)
    whole = model.run(table, x, c)
    for g, r in zip(whole, model.reference_sum(table, x, c)):
        np.testing.assert_array_equal(g, r)
    h = n // 2
    a = model.run(table, tuple(v[:h] for v in x), c)
    mid = tuple(v[h - 2 * plan.half:h] for v in x)
    b = model.run(table, tuple(v[h:] for v in x), mid)
    for u, v, w in zip(a, b, whole):
        np.testing.assert_array_equal(np.concatenate([u, v]), w)


@pytest.mark.parametrize("rate", MODEL_RATES)
def test_kernel_shared_accesses_are_bank_conflict_free(rate):
    """Every load of the band loop and every write of a staged output
    takes one wavefront (32 banks); the reads behind the 16-byte stores
    take one where L is a power of two and at most two otherwise; the
    staging stores at most two with compile-time M, one with run-time M."""
    table = rk.make_table(_plan(rate), "cpu")
    b = model.Block(table)
    lay = b.lay
    loads, writes = [], []
    for _warp, p, first in b.items():
        for tile in range(first, first + lay.tiles):
            tq = tile * 32 * b.R
            if b.mt:
                loads += [w for w, _ in b.window_loads(tq)]
            else:
                loads += b.any_loads(tq, int(b.row0[p]))
            writes += [p * lay.out_row + cols for _, cols in
                       b.out_writes(tq)]
    assert loads and writes
    assert (rk.bank_wavefronts(np.stack(loads)) == 1).all()
    assert (rk.bank_wavefronts(np.stack(writes)) == 1).all()
    _o, _w, reads = b.readout(lay.q_per_chunk * b.L)
    worst = 1 if b.L & (b.L - 1) == 0 else 2
    assert rk.bank_wavefronts(reads).max() <= worst
    t = np.arange(0, lay.span + 31, 32)[:, None] + np.arange(32)
    t = t[:-(-lay.span // 32)]
    staging = rk.bank_wavefronts(np.where(t < lay.span, b.staged(t), -1))
    assert staging.max() <= (2 if b.mt else 1)


@pytest.mark.parametrize("rate,instance", [
    (8_192_000, 0), (4_096_000, 0), (3_072_000, 1), (1_024_000, 2),
    (2_176_000, 3), (1_792_000, 3), (1_536_000, 4), (512_000, 5),
    (768_000, 5)])
def test_each_instance_serves_its_plans(rate, instance):
    """make_table picks compile-time M for M = 1, 2 (RES_RATES) and
    run-time M for the others, the smallest KP that holds the band, and
    the work items spread over the 8 warps: L * groups items, and with
    compile-time M at least 7/8 of the warps busy in every round."""
    plan = _plan(rate)
    lay = rk.make_table(plan, "cpu").layout
    assert lay.instance == instance
    mt, kp, _ = rk.INSTANCES[instance]
    assert mt in (0, plan.M)
    items = plan.L * lay.groups
    busy = items / (rk.WARPS * -(-items // rk.WARPS))
    assert busy >= (0.9 if mt else 0.85)


def test_plans_the_old_kernel_took_still_fit():
    """Every plan with L <= 360 whose 128-sample frames the gate takes
    (M dividing 128) still gets a block that fits an SM's shared memory:
    the first version of the kernel launched those (48 KB of taps and
    run)."""
    for M in (4, 16, 128):
        for L in (1, 3, 33, 129, 355):
            if np.gcd(L, M) != 1:
                continue
            plan = filters.PolyphasePlan.create(BASE, BASE * L // M)
            if (plan.L, plan.M) != (L, M) or not rk.supports(plan):
                continue
            lay = rk.make_table(plan, "cpu").layout
            assert lay.smem_bytes <= rk.SMEM_LIMIT


def test_wrapper_checks_and_cpu_path_does_not_count():
    plan = _plan(8_192_000)
    table = rk.make_table(plan, "cpu")
    x, c = _stream(512, 32, seed=11)
    before = rk.resample.launches
    out, carry = rk.resample(_t(x), _t(c), table)
    assert rk.resample.launches == before
    ref, ref_carry = rk.resample_plain(_t(x), _t(c), table)
    for o, r in zip((*out, *carry), (*ref, *ref_carry)):
        np.testing.assert_array_equal(o.numpy(), r.numpy())
    with pytest.raises(TypeError):
        rk.resample(tuple(t.double() for t in _t(x)), _t(c), table)
    with pytest.raises(ValueError, match="multiple"):
        rk.resample(_t(v[:100] for v in x), _t(c), table)
    with pytest.raises(ValueError, match="carry"):
        rk.resample(_t(x), _t(v[:5] for v in c), table)


def test_papr_db_matches_reference():
    rng = np.random.default_rng(12)
    x = tuple(rng.standard_normal((3, 4096)).astype(np.float32)
              for _ in range(2))
    got = filters.papr_db(_t(x))
    ref = jfilters.papr_db(tuple(jnp.asarray(v) for v in x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
