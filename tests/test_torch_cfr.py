"""Crest factor reduction in the port (dabmod_tpu_torch.ops.ofdm CFR ops and
the K2 backend ops.ofdm_kernel.ofdm_cfr_backend) against dabmod_tpu.

On the CPU the K2 wrapper takes its plain version, which is held here
against dabmod_tpu's Pallas kernel run in interpret mode with the same
carrier map (enable_cfr=True, HIGHEST precision) and against its XLA
cfr_one_iteration.  The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py).

Tolerances (tests/test_ofdm_kernel.py:43-62): td within 2e-5*max|ref|
(fp32 transforms summed in other orders); clip counts equal at these fixed
seeds; the power and MER lanes rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_core_model as core
from dabmod_tpu import tables as jt
from dabmod_tpu.ops import fft as jfft
from dabmod_tpu.ops import ofdm as jofdm
from dabmod_tpu.ops import ofdm_kernel as jkernel
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.ops import fft, ofdm, ofdm_kernel

HIGHEST = jax.lax.Precision.HIGHEST
MODES = {2048: 1, 512: 2, 256: 3, 1024: 4}
ERROR_CLIP = 0.5


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    yield
    jfft.set_precision("high")


def _table(mode):
    src, valid = tables.bin_map(mode)
    return ofdm_kernel.make_table(tables.freq_interleave_inverse(mode)[src],
                                  valid, "cpu")


def _inputs(mode, seed, batch=2, symbols=7):
    """Random carrier planes [batch, symbols, C] and the clip level of
    tests/test_ofdm_kernel.py: 1.2 x the mean magnitude before CFR."""
    rng = np.random.default_rng(seed)
    shape = (batch, symbols, tables.mode_params(mode).nb_carriers)
    x = tuple(rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    td = ofdm_kernel.ofdm_backend_plain(
        tuple(torch.as_tensor(a) for a in x), _table(mode))
    clip = 1.2 * float(torch.sqrt(td[0] ** 2 + td[1] ** 2).mean())
    return x, clip


@pytest.mark.parametrize("spacing", [256, 2048])
def test_plain_cfr_matches_pallas_kernel(spacing):
    mode = MODES[spacing]
    x, clip = _inputs(mode, seed=2)
    src = jt.freq_interleave_inverse(mode)[jt.bin_map(mode)[0]]
    ap = jkernel.build_ofdm_backend(
        spacing, True, clip, ERROR_CLIP, precision=HIGHEST, interpret=True,
        carrier_map=(src, jt.bin_map(mode)[1].astype(np.float32)))
    (ref_r, ref_i), ref_st = ap(tuple(jnp.asarray(a) for a in x))
    ref_st = np.asarray(ref_st)
    (got_r, got_i), st = ofdm_kernel.ofdm_cfr_backend(
        tuple(torch.as_tensor(a) for a in x), _table(mode), clip, ERROR_CLIP)
    assert got_r.shape == (2, 7, spacing) and st.shape == (2, 7, 8)
    scale = float(np.abs(np.asarray(ref_r)).max())
    for g, r in ((got_r, ref_r), (got_i, ref_i)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=2e-5 * scale)
    st = st.numpy()
    for lane in (ofdm_kernel.ST_NCLIP, ofdm_kernel.ST_NERRCLIP):
        np.testing.assert_array_equal(st[..., lane].sum(axis=1),
                                      ref_st[..., lane].sum(axis=1))
        assert st[..., lane].sum() > 0
    for lane in (ofdm_kernel.ST_POW_BEFORE, ofdm_kernel.ST_PEAK_BEFORE,
                 ofdm_kernel.ST_POW_AFTER, ofdm_kernel.ST_PEAK_AFTER,
                 ofdm_kernel.ST_MER_DEN):
        np.testing.assert_allclose(st[..., lane], ref_st[..., lane],
                                   rtol=1e-4)
    assert not st[..., ofdm_kernel.ST_PAD].any()


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_plain_cfr_matches_reference_iteration(mode):
    """Plain K2 == dabmod_tpu's gather + ofdm_ifft + cfr_one_iteration on
    the natural-order bins, with its per-TF counts."""
    jfft.set_precision("highest")
    p = tables.mode_params(mode)
    x, clip = _inputs(mode, seed=10 + mode)
    inv = jt.freq_interleave_inverse(mode)
    bins = jofdm.to_bins_slices(tuple(jnp.asarray(a[..., inv]) for a in x),
                                p.nb_carriers, p.spacing)
    ref, n_clip, n_err = jofdm.cfr_one_iteration(
        jofdm.ofdm_ifft(bins), bins, clip, ERROR_CLIP)
    got, st = ofdm_kernel.ofdm_cfr_backend_plain(
        tuple(torch.as_tensor(a) for a in x), _table(mode), clip, ERROR_CLIP)
    scale = float(np.abs(np.asarray(ref[0])).max())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=2e-5 * scale)
    np.testing.assert_array_equal(
        st[..., ofdm_kernel.ST_NCLIP].sum(dim=1).int().numpy(),
        np.asarray(n_clip))
    np.testing.assert_array_equal(
        st[..., ofdm_kernel.ST_NERRCLIP].sum(dim=1).int().numpy(),
        np.asarray(n_err))


def test_cfr_ops_match_reference():
    """ops.ofdm.cfr_clip / cfr_one_iteration and ops.fft.fft_planes ==
    their dabmod_tpu counterparts on natural-order planes."""
    jfft.set_precision("highest")
    rng = np.random.default_rng(4)
    td = tuple(rng.standard_normal((3, 5, 512)).astype(np.float32) * 20
               for _ in range(2))
    bins = tuple(rng.standard_normal((3, 5, 512)).astype(np.float32)
                 for _ in range(2))
    t = lambda a: tuple(torch.as_tensor(v) for v in a)   # noqa: E731
    j = lambda a: tuple(jnp.asarray(v) for v in a)       # noqa: E731

    got = fft.fft_planes(t(td))
    ref = jfft.fft_planes(j(td))
    scale = float(np.abs(np.asarray(ref[0])).max())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=2e-6 * scale)

    clipped, n = ofdm.cfr_clip(t(td), 25.0)
    ref_c, ref_n = jofdm.cfr_clip(j(td), 25.0)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    # XLA's CPU division and square root may round one ulp off IEEE's
    for g, r in zip(clipped, ref_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=3e-7)

    out, n_clip, n_err = ofdm.cfr_one_iteration(t(td), t(bins), 25.0, 0.3)
    ref, ref_clip, ref_err = jofdm.cfr_one_iteration(j(td), j(bins), 25.0,
                                                     0.3)
    np.testing.assert_array_equal(n_clip.numpy(), np.asarray(ref_clip))
    np.testing.assert_array_equal(n_err.numpy(), np.asarray(ref_err))
    assert int(n_err.sum()) > 0
    scale = float(np.abs(np.asarray(ref[0])).max())
    for g, r in zip(out, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=2e-5 * scale)


def _np_clip(v, limit2):
    """amp_clip on complex64 registers: (clipped, over mask)."""
    m2 = (v.real * v.real + v.imag * v.imag).astype(np.float32)
    over = m2 > np.float32(limit2)
    scale = np.where(over, np.sqrt(np.float32(limit2)
                                   / np.where(m2 > 0, m2, 1)), 1)
    return (v * scale.astype(np.float32)).astype(np.complex64), over


@pytest.mark.parametrize("spacing", [256, 512, 1024, 2048])
def test_cfr_register_flow_matches_plain(spacing):
    """K2's data flow (csrc/ofdm_cfr.cu) on the FFT core's register layout,
    transcribed to NumPy: B gathered into the registers, x = inverse(B),
    the clip, S = forward(c) / N in B's registers, the error against B
    elementwise, out = inverse(S + e).  Equals the plain K2 within
    2e-5*max|ref|, with the clip counts within the threshold margin."""
    mode = MODES[spacing]
    table = _table(mode)
    x, clip = _inputs(mode, seed=20 + mode, batch=1, symbols=1)
    car = np.concatenate([(x[0] + 1j * x[1]).astype(np.complex64)[0, 0],
                          np.zeros(1, np.complex64)])        # the zero slot
    idx = core.register_index(spacing)
    b = car[table.gather.numpy()[idx]]
    xs = core.core_inverse(b, table)
    c, over = _np_clip(xs, ofdm.f32_square(clip))
    s = (core.core_forward(c, table) * np.float32(1.0 / spacing)).astype(
        np.complex64)
    e, over_e = _np_clip(b - s, ofdm.f32_square(ERROR_CLIP))
    out = core.core_inverse(s + e, table)
    planes = tuple(torch.as_tensor(a) for a in x)
    (rr, ri), st = ofdm_kernel.ofdm_cfr_backend_plain(planes, table, clip,
                                                      ERROR_CLIP)
    ref = (rr + 1j * ri).numpy()[0, 0]
    np.testing.assert_allclose(out, ref[idx], rtol=0,
                               atol=2e-5 * np.abs(ref).max())
    margin = ofdm_kernel.cfr_threshold_margin(planes, table, clip,
                                              ERROR_CLIP)[0, 0].numpy()
    assert over_e.sum() > 0
    for got, lane, k in ((over, ofdm_kernel.ST_NCLIP, 0),
                         (over_e, ofdm_kernel.ST_NERRCLIP, 1)):
        assert abs(int(got.sum()) - int(st[0, 0, lane])) <= margin[k]


def test_null_symbol_passes_unchanged():
    """An all-zero symbol (the NULL symbol) gives zero samples and zero
    statistics, never NaN (|x|^2 = 0 keeps scale 1)."""
    table = _table(3)
    x, clip = _inputs(3, seed=1, batch=1, symbols=3)
    x = tuple(torch.as_tensor(a) for a in x)
    for a in x:
        a[0, 0] = 0.0
    (out_r, out_i), st = ofdm_kernel.ofdm_cfr_backend(x, table, clip, 0.0)
    assert torch.isfinite(out_r).all() and torch.isfinite(st).all()
    assert not out_r[0, 0].any() and not out_i[0, 0].any()
    assert not st[0, 0].any()
    # error clip 0: every non-zero error is clipped to nothing, the output
    # is IFFT(FFT(clipped) / N), the clipped signal itself
    clipped, _ = ofdm.amp_clip(ofdm_kernel.ofdm_backend_plain(x, table),
                               clip)
    np.testing.assert_allclose(out_r.numpy(), clipped[0].numpy(),
                               atol=1e-4 * clip)


def test_thresholds_are_float32_squares():
    """The clip compares |x|^2 with clip**2 taken in double and rounded to
    float32, as dabmod_tpu's weakly typed scalar does."""
    for clip in (40.0, 1.1, 3.0, 0.37):
        want = np.float32(clip * clip)
        assert ofdm.f32_square(clip) == float(want)
        x = np.array([np.nextafter(want, -np.inf), want,
                      np.nextafter(want, np.inf)], np.float32)
        ref_over = np.asarray(jnp.asarray(x) > clip * clip)
        assert ref_over.tolist() == [False, False, True]
        got = torch.as_tensor(x) > ofdm.f32_square(clip)
        np.testing.assert_array_equal(got.numpy(), ref_over)


def test_threshold_margin_counts_samples_at_the_limit():
    table = _table(3)
    x, clip = _inputs(3, seed=6)
    x = tuple(torch.as_tensor(a) for a in x)
    td = ofdm_kernel.ofdm_backend_plain(x, table)
    m = ofdm_kernel.cfr_threshold_margin(x, table, clip, ERROR_CLIP)
    assert m.shape == (2, 7, 2) and m.dtype == torch.int32
    # a clip level set to one sample's magnitude puts it on the threshold
    at = float(torch.sqrt(td[0][1, 4, 17] ** 2 + td[1][1, 4, 17] ** 2))
    m_at = ofdm_kernel.cfr_threshold_margin(x, table, at, ERROR_CLIP)
    assert int(m_at[1, 4, 0]) >= 1
    assert int(m_at[..., 0].sum()) >= int(m[..., 0].sum())


def test_cfr_wrapper_checks_and_cpu_path_does_not_count():
    table = _table(2)
    x, clip = _inputs(2, seed=3)
    x = tuple(torch.as_tensor(a) for a in x)
    before = ofdm_kernel.ofdm_cfr_backend.launches
    out, st = ofdm_kernel.ofdm_cfr_backend(x, table, clip, ERROR_CLIP)
    assert ofdm_kernel.ofdm_cfr_backend.launches == before
    ref, ref_st = ofdm_kernel.ofdm_cfr_backend_plain(x, table, clip,
                                                     ERROR_CLIP)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), r.numpy())
    np.testing.assert_array_equal(st.numpy(), ref_st.numpy())
    with pytest.raises(TypeError):
        ofdm_kernel.ofdm_cfr_backend(tuple(a.double() for a in x), table,
                                     clip, ERROR_CLIP)
    with pytest.raises(ValueError):
        ofdm_kernel.ofdm_cfr_backend(tuple(a[..., :100] for a in x), table,
                                     clip, ERROR_CLIP)
    with pytest.raises(ValueError):
        ofdm_kernel.ofdm_cfr_backend(tuple(a[0] for a in x), table, clip,
                                     ERROR_CLIP)
