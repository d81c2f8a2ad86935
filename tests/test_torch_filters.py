"""The port's post-OFDM stages (dabmod_tpu_torch.ops.filters, on the CPU)
against dabmod_tpu.ops.filters on the same seeded numpy inputs, and against
the NumPy ports of the reference loops of tests/test_filters.py.

Tolerances: the FIR atol 1e-4 (tests/test_filters.py:54); the DPD atol
1e-5 (:147, :160), where a LUT sample may take the neighbouring entry only
within 1e-6 (relative) of a bin edge; the wire formats byte-identical;
both resamplers 2e-5 of max|ref| (:107-108).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabmod_tpu import tables as jt
from dabmod_tpu.io.outputs import serialize_iq_count
from dabmod_tpu.ops import filters as jf
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.models.modulator import resampler_route
from dabmod_tpu_torch.ops import filters, resampler_kernel


def _planes(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(shape) * scale).astype(np.float32)
                 for _ in range(2))


def _t(planes):
    return tuple(torch.as_tensor(p) for p in planes)


def _j(planes):
    return tuple(jnp.asarray(p) for p in planes)


def _fir_ref(x, taps):
    """out[n] = sum_j x[n+j]*taps[j], truncated at the frame end (the
    NumPy loop of tests/test_filters.py:28-36)."""
    n = x.size
    out = np.zeros(n, np.complex64)
    for i in range(n):
        m = min(taps.size, n - i)
        out[i] = (x[i:i + m].astype(np.complex128) @ taps[:m]).astype(
            np.complex64)
    return out


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2048, 3000, 128 * 7 + 5])
def test_fir_matches_reference_and_loop(n):
    """Two TFs of n samples: the banded form (n a multiple of 128) and the
    generic framed one; each TF truncated at its own end."""
    taps = tables.DEFAULT_FIR_TAPS
    x = _planes(n, (2, n))
    got = filters.fir_filter(_t(x), torch.as_tensor(taps))
    ref = jf.fir_filter(_j(x), jnp.asarray(taps))
    for g, r in zip(got, ref):
        assert g.shape == (2, n) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    for row in range(2):
        expect = _fir_ref(x[0][row] + 1j * x[1][row], taps)
        np.testing.assert_allclose(got[0][row].numpy() + 1j * got[1][row]
                                   .numpy(), expect, atol=1e-4)


def test_fir_taps_are_a_tensor_argument():
    """Random taps through the tensor-built operator equal dabmod_tpu's
    constant-folded NumPy operator; other taps give another output."""
    rng = np.random.default_rng(7)
    taps = rng.normal(size=45).astype(np.float32)
    x = _planes(8, (2, 2048))
    got = filters.fir_filter(_t(x), torch.as_tensor(taps))
    ref = jf.fir_filter(_j(x), taps)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-5)
    other = filters.fir_filter(_t(x), torch.as_tensor(taps[::-1].copy()))
    assert not torch.equal(other[0], got[0])
    T = filters.fir_operator(torch.as_tensor(taps), 128).numpy()
    np.testing.assert_array_equal(T, jf._fir_operator(taps.tobytes(), 45,
                                                      128))


def test_fir_longer_than_a_frame():
    """More taps than the 128-sample frame (dabmod_tpu's framing needs
    ntaps <= 128): the generic form against the loop."""
    taps = np.random.default_rng(3).normal(size=150).astype(np.float32)
    x = _planes(4, (1, 1000))
    got = filters.fir_filter(_t(x), torch.as_tensor(taps))
    expect = _fir_ref(x[0][0] + 1j * x[1][0], taps)
    np.testing.assert_allclose(got[0][0].numpy() + 1j * got[1][0].numpy(),
                               expect, atol=1e-4)


# ---------------------------------------------------------------------------
# DPD
# ---------------------------------------------------------------------------

# the coefficients of tests/test_filters.py:133-134 and its LUT (:151-153)
POLY_AM = np.array([1.0, 0.1, -0.05, 0.02, -0.01], np.float32)
POLY_PM = np.array([0.02, -0.01, 0.005, 0.0, 0.0], np.float32)
LUT = (np.linspace(1.0, 0.9, 32) + 1j * np.linspace(0, 0.05, 32)
       ).astype(np.complex64)
LUT_SCALE = 2.0 ** 31


def test_memless_poly_matches_reference():
    x = _planes(7, (3, 500), scale=0.5)
    got = filters.memless_poly(_t(x), torch.as_tensor(POLY_AM),
                               torch.as_tensor(POLY_PM))
    ref = jf.memless_poly(_j(x), jnp.asarray(POLY_AM), jnp.asarray(POLY_PM))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def _lut_pairs():
    return np.stack([LUT.real, LUT.imag], -1).astype(np.float32)


def test_memless_lut_matches_reference():
    """Every sample takes dabmod_tpu's LUT entry (its bin index computed
    with its own ops), except a sample within 1e-6 (relative) of a bin
    edge, which may take the neighbouring one; the output within 1e-5
    elsewhere."""
    x = _planes(8, (4, 5000))
    scale = torch.tensor(np.float32(LUT_SCALE))
    got = filters.memless_lut(_t(x), torch.as_tensor(_lut_pairs()), scale)
    ref = jf.memless_lut(_j(x), jnp.asarray(_lut_pairs()),
                         jnp.float32(LUT_SCALE))
    ix = filters.lut_index(_t(x), scale).numpy()
    mag = jnp.sqrt(jnp.asarray(x[0]) ** 2 + jnp.asarray(x[1]) ** 2)
    scaled = jnp.clip(jnp.round(mag * jnp.float32(LUT_SCALE)), 0,
                      2.0 ** 32 - 1)
    ref_ix = np.asarray(jnp.clip((scaled / float(1 << 27)).astype(
        jnp.int32), 0, 31))
    edge = filters.lut_edge_samples(_t(x), scale).numpy()
    other = ix != ref_ix
    print(f"{int(edge.sum())} samples within 1e-6 of a LUT bin edge, "
          f"{int(other.sum())} take another entry")
    assert not (other & ~edge).any()
    assert len(np.unique(ix)) > 8               # the bins really spread
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[~other], np.asarray(r)[~other],
                                   atol=1e-5)


def test_lut_index_at_the_edges():
    """Bin 0 for silence and just below the first edge, the next bin from
    an edge on, 31 at the top and past the clip to 2**32 - 1 (2**32 in
    float32), as dabmod_tpu computes them; round() is half to even, as
    jnp.round."""
    edge = np.float32(1 << 27)
    mags = np.array([0.0, np.nextafter(edge, np.float32(0)), edge,
                     5 * edge, 31 * edge, 2.0 ** 32, 2.0 ** 40], np.float32)
    planes = (mags, np.zeros_like(mags))
    got = filters.lut_index(_t(planes), torch.tensor(np.float32(1.0)))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 1, 5, 31, 31, 31])
    ref = jnp.clip((jnp.clip(jnp.round(jnp.asarray(mags) * jnp.float32(1.0)),
                             0, 2.0 ** 32 - 1) / float(1 << 27)).astype(
                                 jnp.int32), 0, 31)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    half = np.array([0.5, 1.5, 2.5, -0.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.as_tensor(half)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(half))))


# ---------------------------------------------------------------------------
# CIC equalizer, wire formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,rate,ratio", [(1, 2_048_000, 4),
                                             (2, 4_096_000, 3),
                                             (4, 1_024_000, 25)])
def test_cic_equalizer_taps_match_reference(mode, rate, ratio):
    p = tables.mode_params(mode)
    over = p.spacing * rate / 2_048_000.0
    np.testing.assert_array_equal(
        filters.cic_equalizer_taps(p.nb_carriers, over, ratio),
        jf.cic_equalizer_taps(p.nb_carriers, over, ratio))


def _wire_pairs():
    """test_filters.py:182-185's adversarial values: exact bounds,
    half-steps, negative fractions, then small values that fit."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-40000, 40000, size=(3, 512, 2)).astype(np.float32)
    x.reshape(-1)[:10] = [32767.0, -32768.0, 32767.5, -32768.5, 0.5,
                          -0.5, -1.5, 255.9, -129.0, 127.5]
    x[1] = rng.uniform(-200, 200, size=(512, 2))
    x.reshape(-1)[1024:1034] = [127.0, -128.0, 127.9, -128.9, -0.9, 0.9,
                                -127.5, 128.0, -129.0, 0.0]
    return x


@pytest.mark.parametrize("fmt", ["u8", "s8"])
def test_format_convert_narrow_matches_reference(fmt):
    x = _wire_pairs()
    got, n = filters.format_convert(torch.as_tensor(x), fmt)
    ref, ref_n = jf.format_convert(jnp.asarray(x), fmt)
    assert got.dtype == {"u8": torch.uint8, "s8": torch.int8}[fmt]
    assert got.shape == x.shape
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()
    host_bytes, n_host = serialize_iq_count(x, fmt)
    assert got.numpy().tobytes() == host_bytes
    assert int(n) == int(ref_n) == n_host > 0


@pytest.mark.parametrize("fmt", ["u8", "s8"])
def test_pack_bytes_matches_reference_words(fmt):
    """Four bytes to an int32 word, as dabmod_tpu's modulator.py:725-737
    packs them ([B, N, 2] -> [B, N/2])."""
    x = _wire_pairs()
    conv, _ = filters.format_convert(torch.as_tensor(x), fmt)
    words = filters.pack_bytes(conv)
    ref, _ = jf.format_convert(jnp.asarray(x), fmt)
    ref_words = jax.lax.bitcast_convert_type(
        ref.reshape(*ref.shape[:-2], -1, 4), jnp.int32)
    assert words.dtype == torch.int32 and words.shape == (3, 256)
    np.testing.assert_array_equal(words.numpy(), np.asarray(ref_words))


# ---------------------------------------------------------------------------
# the frequency-domain resampler
# ---------------------------------------------------------------------------

RATES = [4_096_000, 1_024_000, 3_072_000, 1_536_000]


def _resampler_inputs(rate, seed):
    plan = filters.ResamplerPlan.create(2_048_000, rate, 2048)
    hi, ho = plan.fft_in // 2, plan.fft_out // 2
    rng = np.random.default_rng(seed)

    def pairs(n):
        return rng.standard_normal((n, 2)).astype(np.float32)
    return plan, pairs(hi * 8), pairs(hi), pairs(ho)


@pytest.mark.parametrize("rate", RATES)
def test_resampler_plan_matches_reference(rate):
    for spacing in (2048, 512, 256, 1024):
        got = filters.ResamplerPlan.create(2_048_000, rate, spacing)
        ref = jf.ResamplerPlan.create(2_048_000, rate, spacing)
        assert (got.L, got.M, got.fft_in, got.fft_out, got.factor) == \
            (ref.L, ref.M, ref.fft_in, ref.fft_out, ref.factor)
        np.testing.assert_array_equal(got.window, ref.window)


@pytest.mark.parametrize("rate", RATES)
def test_resample_matches_reference(rate):
    """Random tails as well as the stream: the carries count."""
    plan, x, it, ot = _resampler_inputs(rate, rate // 1000)
    y, in_tail, out_tail = filters.resample(
        torch.as_tensor(x), plan, torch.as_tensor(it), torch.as_tensor(ot))
    ry, r_in, r_out = jf.resample(jnp.asarray(x), plan, jnp.asarray(it),
                                  jnp.asarray(ot))
    scale = float(np.abs(np.asarray(ry)).max())
    assert y.shape == (x.shape[0] * plan.L // plan.M, 2)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=2e-5 * scale)
    np.testing.assert_array_equal(in_tail.numpy(), np.asarray(r_in))
    np.testing.assert_allclose(out_tail.numpy(), np.asarray(r_out),
                               atol=2e-5 * scale)


@pytest.mark.parametrize("rate", RATES)
def test_resample_two_half_calls_equal_one(rate):
    plan, x, it, ot = _resampler_inputs(rate, rate // 1000 + 1)
    hi = plan.fft_in // 2
    args = [torch.as_tensor(a) for a in (x, it, ot)]
    full, _, _ = filters.resample(args[0], plan, args[1], args[2])
    a, it2, ot2 = filters.resample(args[0][:hi * 3], plan, args[1], args[2])
    b, _, _ = filters.resample(args[0][hi * 3:], plan, it2, ot2)
    scale = float(full.abs().max())
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), full.numpy(),
                               atol=2e-5 * scale)


# ---------------------------------------------------------------------------
# the polyphase plans K3 does not take
# ---------------------------------------------------------------------------

def test_polyphase_plain_form_2m5_matches_reference():
    """2.5 MS/s (L/M = 625/512): dabmod_tpu's XLA framing (32 samples
    rounded up to M = 512), the same operator to the bit, and the plain
    form's stream and carry against JAX's; two half calls equal one."""
    plan = filters.PolyphasePlan.create(2_048_000, 2_500_000,
                                        block=filters.PLAIN_BLOCK)
    ref_plan = jf.PolyphasePlan.create(2_048_000, 2_500_000)
    assert (plan.L, plan.M, plan.half, plan.block, plan.out_block) == \
        (ref_plan.L, ref_plan.M, ref_plan.half, ref_plan.block,
         ref_plan.out_block) == (625, 512, plan.half, 512, 625)
    np.testing.assert_array_equal(plan.matrix, ref_plan.matrix)
    x = _planes(25, (512 * 6,))
    c = _planes(26, (2 * plan.half,))
    got, carry = filters.resample_poly(_t(x), plan, _t(c))
    ref, ref_carry = jf.resample_poly(_j(x), ref_plan, _j(c))
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == (625 * 6,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=2e-5 * scale)
    for g, r in zip(carry, ref_carry):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    a, mid = filters.resample_poly(tuple(v[:512 * 2] for v in _t(x)), plan,
                                   _t(c))
    b, _ = filters.resample_poly(tuple(v[512 * 2:] for v in _t(x)), plan, mid)
    for u, v, g in zip(a, b, got):
        np.testing.assert_allclose(torch.cat([u, v]).numpy(), g.numpy(),
                                   atol=2e-5 * scale)


@pytest.mark.parametrize("rate,mode,route", [
    (8_192_000, "auto", "kernel"), (3_072_000, "auto", "kernel"),
    (1_024_000, "poly", "kernel"), (2_500_000, "auto", "poly"),
    (2_500_000, "poly", "poly"), (1_536_000, "auto", "fft"),
    (1_024_000, "auto", "fft"), (4_096_000, "fft", "fft")])
def test_resampler_route_is_chosen_from_the_plan(rate, mode, route):
    """As dabmod_tpu chooses: "auto" is poly at or above 2.048 MS/s and fft
    below; a poly plan goes to K3 when the kernel takes its 128-sample
    framing, else to the plain form."""
    got, plan = resampler_route(
        ModSettings(output_rate=rate, resampler_mode=mode), 2048)
    assert got == route
    if route == "kernel":
        assert resampler_kernel.supports(plan)
    elif route == "poly":
        assert plan.block == 512 and not resampler_kernel.supports(
            filters.PolyphasePlan.create(2_048_000, rate))
    else:
        assert isinstance(plan, filters.ResamplerPlan)
    assert resampler_route(ModSettings(), 2048) is None
    with pytest.raises(ValueError, match="resampler_mode"):
        resampler_route(ModSettings(output_rate=rate,
                                    resampler_mode="sinc"), 2048)


def test_default_fir_taps_used_as_jax_does():
    """The port's FIR taps table and JAX's give the same filter."""
    x = _planes(30, (1, 2048))
    got = filters.fir_filter(_t(x), torch.as_tensor(tables.DEFAULT_FIR_TAPS))
    ref = jf.fir_filter(_j(x), jnp.asarray(jt.DEFAULT_FIR_TAPS))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
