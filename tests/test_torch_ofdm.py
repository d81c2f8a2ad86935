"""The port's OFDM-side ops (dabmod_tpu_torch.ops.ofdm, .fft, .filters, on
the CPU) against the reference goldens (as tests/test_ofdm_golden.py) and
against dabmod_tpu.ops on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabmod_tpu import tables as jt
from dabmod_tpu.ops import filters as jfilters
from dabmod_tpu.ops import ofdm as jofdm
from dabmod_tpu_torch import config, tables
from dabmod_tpu_torch.ops import cplx, fft, filters, ofdm
from golden import load


def planes(x):
    return cplx.planes_from_complex(x)


def test_gain_constants_match_reference():
    assert (config.GAIN_FIX, config.GAIN_MAX, config.GAIN_VAR) == \
        (jofdm.GAIN_FIX, jofdm.GAIN_MAX, jofdm.GAIN_VAR)


def test_qpsk_mapping_golden():
    bits = torch.as_tensor(np.unpackbits(load("qpsk_in")))[None]
    q = ofdm.qpsk_phase_indices(bits, 1536)
    got = cplx.planes_to_complex(ofdm.phases_to_carriers(q)).reshape(-1)
    np.testing.assert_array_equal(got, load("qpsk_out"))


def test_phases_to_carriers_bitwise_equal_to_reference():
    q = np.arange(8, dtype=np.int32)
    got = ofdm.phases_to_carriers(torch.as_tensor(q))
    ref = jofdm.phases_to_carriers(jnp.asarray(q))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(r).view(np.uint32))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_freq_interleaver_golden(mode):
    carriers = tables.mode_params(mode).nb_carriers
    xr, xi = planes(load(f"freqint_m{mode}_in").reshape(-1, carriers))
    inv = torch.as_tensor(tables.freq_interleave_inverse(mode).astype(np.int64))
    got = cplx.planes_to_complex((ofdm.freq_interleave(xr, inv),
                                  ofdm.freq_interleave(xi, inv)))
    np.testing.assert_array_equal(got.reshape(-1), load(f"freqint_m{mode}_out"))


def test_diff_modulator_golden():
    """As tests/test_ofdm_golden.py: the golden input's phases quantised to
    eighth turns, against the reference's float32 product chain."""
    cin = load("diffmod_in").reshape(75, 1536)
    expect = load("diffmod_out").reshape(76, 1536)
    q_in = np.round(np.angle(cin) / (np.pi / 4)).astype(np.int64) % 8
    vals = jt.PHASE_LUT[q_in]
    ref_c = jt.phase_ref_complex(1)
    chain = np.empty((76, 1536), np.complex64)
    chain[0] = ref_c
    for s in range(75):
        chain[s + 1] = (chain[s] * vals[s]).astype(np.complex64)
    phases = ofdm.diff_modulate(
        torch.as_tensor(q_in.astype(np.int32))[None],
        torch.as_tensor(tables.phase_ref_eighths(1)))
    got = cplx.planes_to_complex(ofdm.phases_to_carriers(phases))[0]
    np.testing.assert_allclose(got, chain, atol=2e-6)
    np.testing.assert_array_equal(expect[0], ref_c)


@pytest.mark.parametrize("mode", [1, 3])
def test_diff_modulate_exact_against_reference(mode):
    """Integer cumsum & 7 == dabmod_tpu's triangular-matmul form, exactly."""
    p = tables.mode_params(mode)
    rng = np.random.default_rng(mode)
    q = rng.integers(0, 8, (3, p.data_symbols, p.nb_carriers), np.int32)
    ref_q = tables.phase_ref_eighths(mode)
    got = ofdm.diff_modulate(torch.as_tensor(q), torch.as_tensor(ref_q))
    ref = jofdm.diff_modulate(jnp.asarray(q), jnp.asarray(ref_q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_guard_interval_golden():
    cin = load("guard_ov0_in").reshape(77, 2048)
    p = tables.mode_params(1)
    got = ofdm.guard_interval_unwindowed(planes(cin[None]), p.null_size,
                                         p.sym_size)
    np.testing.assert_array_equal(cplx.planes_to_complex(got)[0],
                                  load("guard_ov0_out"))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_guard_interval_with_gains_matches_reference(mode):
    p = tables.mode_params(mode)
    rng = np.random.default_rng(mode)
    x = rng.standard_normal((2, p.nb_symbols + 1, p.spacing, 2))
    x = x.astype(np.float32)
    g = rng.uniform(10, 100, (2, p.nb_symbols + 1)).astype(np.float32)
    got = ofdm.guard_interval_unwindowed(
        (torch.as_tensor(x[..., 0]), torch.as_tensor(x[..., 1])),
        p.null_size, p.sym_size, gains=torch.as_tensor(g))
    ref = jofdm.guard_interval_unwindowed(
        (jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1])),
        p.null_size, p.sym_size, gains=jnp.asarray(g))
    for a, b in zip(got, ref):
        assert a.shape == (2, p.tf_samples)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_to_bins_matches_reference_and_bin_map(mode):
    p = tables.mode_params(mode)
    x = np.random.default_rng(mode).standard_normal(
        (2, 3, p.nb_carriers)).astype(np.float32)
    got = ofdm.to_bins_slices((torch.as_tensor(x),) * 2, p.nb_carriers,
                              p.spacing)[0].numpy()
    ref = np.asarray(jofdm.to_bins_slices((jnp.asarray(x),) * 2,
                                          p.nb_carriers, p.spacing)[0])
    np.testing.assert_array_equal(got, ref)
    src, valid = tables.bin_map(mode)
    np.testing.assert_array_equal(got, x[..., src] * valid)


@pytest.mark.parametrize("mode", [config.GAIN_FIX, config.GAIN_MAX,
                                  config.GAIN_VAR])
def test_compute_gain_matches_reference(mode):
    """All three gain modes against dabmod_tpu.ops.ofdm.compute_gain, the
    NULL symbol borrowing symbol 1's gain (rtol 1e-5: float32 means summed
    in different orders)."""
    rng = np.random.default_rng(3 + mode)
    x = (rng.standard_normal((2, 5, 2048)) * 40).astype(np.float32)
    y = (rng.standard_normal((2, 5, 2048)) * 40).astype(np.float32)
    got = ofdm.compute_gain((torch.as_tensor(x), torch.as_tensor(y)), mode,
                            4.0).numpy()
    ref = np.asarray(jofdm.compute_gain((jnp.asarray(x), jnp.asarray(y)),
                                        mode, jnp.float32(4.0)))
    assert got.dtype == np.float32 and got.shape == (2, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


def test_compute_gain_floor_cases():
    """A silent symbol takes gain 1 in max and var mode, as the reference."""
    zero = torch.zeros((1, 3, 64))
    for mode in (config.GAIN_MAX, config.GAIN_VAR):
        np.testing.assert_array_equal(
            ofdm.compute_gain((zero, zero), mode, 4.0).numpy(), 1.0)
    with pytest.raises(ValueError):
        ofdm.compute_gain((zero, zero), 7, 4.0)


def test_ofdm_ifft_definition():
    """Unnormalised FFTW_BACKWARD against a float64 DFT (norm="forward")."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 128)) + 1j * rng.standard_normal((3, 128))
         ).astype(np.complex64)
    got = cplx.planes_to_complex(ofdm.ofdm_ifft(planes(x)))
    k = np.arange(128)
    expect = x.astype(np.complex128) @ np.exp(2j * np.pi * np.outer(k, k)
                                              / 128).T
    np.testing.assert_allclose(got, expect, atol=1e-3)
    np.testing.assert_allclose(np.fft.fft(got) / 128, x, atol=1e-5)


def test_set_precision_accepts_reference_names():
    for name in ("default", "high", "highest"):
        fft.set_precision(name)
    with pytest.raises(ValueError):
        fft.set_precision("tf32")


def _wire_samples():
    """Float samples covering negatives, truncation edges and saturation."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 500)) * 20000).astype(np.float32)
    edge = np.array([-40000.5, -32768.9, -32768.0, -32767.5, -1.7, -0.5,
                     -0.0, 0.0, 0.5, 1.7, 32766.9, 32767.0, 32767.2,
                     40000.0], np.float32)
    x[0, :edge.size] = edge
    return x


def test_pack_s16_planes_bit_exact():
    re, im = _wire_samples(), _wire_samples()[::-1].copy()
    words, n = filters.pack_s16_planes(torch.as_tensor(re),
                                       torch.as_tensor(im))
    ref_w, ref_n = jfilters.pack_s16_planes(jnp.asarray(re), jnp.asarray(im))
    assert words.dtype == torch.int32 and words.shape == re.shape
    np.testing.assert_array_equal(words.numpy(), np.asarray(ref_w))
    assert int(n) == int(ref_n) > 0
    pairs = words.numpy().view(np.int16).reshape(*re.shape, 2)
    np.testing.assert_array_equal(pairs[..., 0],
                                  np.clip(re, -32768, 32767).astype(np.int16))


def test_format_convert_s16_matches_reference():
    x = np.stack([_wire_samples(), _wire_samples()], axis=-1)
    out, n = filters.format_convert(torch.as_tensor(x), "s16")
    ref, ref_n = jfilters.format_convert(jnp.asarray(x), "s16")
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(n) == int(ref_n)
    same, n0 = filters.format_convert(torch.as_tensor(x), "complexf")
    assert same is not None and int(n0) == 0
    # the narrow formats convert too (tests/test_torch_filters.py holds
    # them against dabmod_tpu); an unknown one is refused
    assert filters.format_convert(torch.as_tensor(x), "u8")[0].dtype == \
        torch.uint8
    with pytest.raises(ValueError, match="format"):
        filters.format_convert(torch.as_tensor(x), "s24")


# ---------------------------------------------------------------------------
# windowed guard interval
# ---------------------------------------------------------------------------

def _gi_inputs(mode, seed):
    p = tables.mode_params(mode)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, p.nb_symbols + 1, p.spacing, 2))
    g = rng.uniform(10, 100, (2, p.nb_symbols + 1))
    return p, x.astype(np.float32), g.astype(np.float32)


@pytest.mark.parametrize("ov", [10, 90])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_guard_interval_windowed_matches_reference(mode, ov):
    """With and without gains against dabmod_tpu.ops.ofdm (atol 4e-6, as
    tests/test_ofdm_golden.py:100), and against the gather form over
    tables.guard_interval_tables.  An overlap longer than the guard
    interval (90 in TM III, whose guard is 63 samples) is refused; JAX
    fails on it too."""
    p, x, g = _gi_inputs(mode, 10 * mode + ov)
    planes_t = (torch.as_tensor(x[..., 0]), torch.as_tensor(x[..., 1]))
    planes_j = (jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1]))
    if ov > p.sym_size - p.spacing:
        with pytest.raises(ValueError, match="guard interval"):
            ofdm.guard_interval_windowed(planes_t, p.null_size, p.sym_size,
                                         ov)
        with pytest.raises(Exception):
            jofdm.guard_interval_windowed(planes_j, p.null_size, p.sym_size,
                                          ov)
        return
    for gains in (None, g):
        got = ofdm.guard_interval_windowed(
            planes_t, p.null_size, p.sym_size, ov,
            gains=None if gains is None else torch.as_tensor(gains))
        ref = jofdm.guard_interval_windowed(
            planes_j, p.null_size, p.sym_size, ov,
            gains=None if gains is None else jnp.asarray(gains))
        for a, b in zip(got, ref):
            assert a.shape == (2, p.tf_samples) and a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=4e-6)
    gathered = ofdm.guard_interval(planes_t,
                                   tables.guard_interval_tables(mode, ov))
    plain = ofdm.guard_interval_windowed(planes_t, p.null_size, p.sym_size,
                                         ov)
    for a, b in zip(gathered, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=4e-6)


def test_guard_interval_windowed_golden():
    """The reference's windowed inserter at overlap 90 (guard_ov90_*),
    through the slice form and the gather form."""
    cin = load("guard_ov90_in").reshape(77, 2048)
    expect = load("guard_ov90_out")
    p = tables.mode_params(1)
    got = ofdm.guard_interval_windowed(planes(cin[None]), p.null_size,
                                       p.sym_size, 90)
    np.testing.assert_allclose(cplx.planes_to_complex(got)[0], expect,
                               atol=4e-6)
    gathered = ofdm.guard_interval(planes(cin[None]),
                                   tables.guard_interval_tables(1, 90))
    np.testing.assert_allclose(cplx.planes_to_complex(gathered)[0], expect,
                               atol=4e-6)


def test_guard_window_is_the_float64_window_rounded():
    """The window is computed in float64 and rounded to float32
    (dabmod_tpu/ops/ofdm.py:256-257), not torch.hann_window's float32."""
    ov = 90
    win = (0.5 * (1.0 - np.cos(np.pi * np.arange(2 * ov) / (2 * ov - 1)))
           ).astype(np.float32)
    rise1, rise2, fall1, fall2 = (w.numpy() for w in ofdm.guard_window(
        ov, torch.device("cpu")))
    np.testing.assert_array_equal(np.concatenate([rise1, rise2]), win)
    np.testing.assert_array_equal(fall1, win[ov:][::-1])
    np.testing.assert_array_equal(fall2, win[:ov][::-1])
