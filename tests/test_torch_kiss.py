"""fft_engine=kiss in the port (dabmod_tpu_torch.ops.kiss_fixed and the
modulator's kiss chain, on the CPU) against dabmod_tpu.ops.kiss_fixed,
dabmod_tpu's kiss modulator, the reference's fixed-point goldens and a
NumPy int64 oracle of the fixed-point primitives.

Every comparison is bit for bit (array_equal): the chain is integer
arithmetic from the Q1.14 carrier symbols on.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.models import Modulator as JModulator
from dabmod_tpu.models import make_default_layout as j_layout
from dabmod_tpu.ops import kiss_fixed as jk
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
from dabmod_tpu_torch.models import Modulator, make_default_layout
from dabmod_tpu_torch.ops import kiss_fixed as tk
from golden import load
from torch_threads import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # the goldens' ensemble
I16 = np.array([-32768, -32767, -16384, -1, 0, 1, 16383, 32766, 32767],
               np.int64)


def _int16_planes(rng, shape):
    """Random int16 values in int32 planes, the extremes included."""
    out = []
    for _ in range(2):
        x = rng.integers(-32768, 32768, shape).astype(np.int32)
        x.reshape(-1)[:I16.size] = I16
        out.append(x)
    return out


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# NumPy int64 oracle of the primitives (kiss/_kiss_fft_guts.h, fpm/fixed.hpp)
# ---------------------------------------------------------------------------

def _wrap16(x):
    return ((x + 32768) % 65536) - 32768


def _sround(x):
    return np.floor_divide(x + (1 << 14), 1 << 15)       # arithmetic >> 15


def _c_div(a, b):
    """C's truncating integer division."""
    return np.sign(a) * (np.abs(a) // b)


@pytest.mark.parametrize("div", [2, 4])
def test_fixdiv_full_scale_matches_int64_oracle(div):
    x = np.concatenate([I16, np.random.default_rng(div).integers(
        -32768, 32768, 4096)])
    k = 32767 // div
    want = _wrap16(_sround(x * k))
    got = tk._fixdiv(_t(x.astype(np.int32)), _t(x[::-1].astype(np.int32)),
                     div)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), _wrap16(_sround(
        x[::-1] * k)))


def test_cmul_full_scale_matches_int64_oracle():
    """Every pairing of full-scale operands, twiddles at +-32767: the
    summed products reach 2 * 32768 * 32767 without leaving int32."""
    tw = np.array([-32767, -23170, -1, 0, 1, 23170, 32767], np.int64)
    ar, ai, br, bi = (a.reshape(-1) for a in np.meshgrid(I16, I16, tw, tw,
                                                          indexing="ij"))
    assert np.abs(ar * br - ai * bi).max() == 2 * 32768 * 32767
    want_r = _wrap16(_sround(ar * br - ai * bi))
    want_i = _wrap16(_sround(ar * bi + ai * br))
    got = tk._cmul(*(_t(a.astype(np.int32)) for a in (ar, ai, br, bi)))
    np.testing.assert_array_equal(got[0].numpy(), want_r)
    np.testing.assert_array_equal(got[1].numpy(), want_i)


def test_fpm_mul_q14_full_scale_matches_int64_oracle():
    """fpm fixed*fixed with rounding: v = (x*w) / 2^13 truncated, then
    v/2 + v%2, both C truncating operations."""
    w = np.array([0, 1, 2, 3, 8191, 8192, 8193, 16383, 16384], np.int64)
    x, w = (a.reshape(-1) for a in np.meshgrid(I16, w, indexing="ij"))
    v = _c_div(x * w, 1 << 13)
    want = _wrap16(_c_div(v, 2) + np.fmod(v, 2))
    got = tk.fpm_mul_q14(_t(x.astype(np.int32)), _t(w.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_int32_shift_is_arithmetic_and_mask_is_twos_complement():
    x = torch.tensor([-65536, -32769, -2, -1, 0, 1, 2**31 - 1],
                     dtype=torch.int32)
    np.testing.assert_array_equal(torch.bitwise_right_shift(x, 15).numpy(),
                                  x.numpy().astype(np.int64) >> 15)
    np.testing.assert_array_equal((x & 65535).numpy(),
                                  x.numpy().astype(np.int64) % 65536)


# ---------------------------------------------------------------------------
# the transform and the Q1.14 guard interval against dabmod_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("n", [2048, 512, 256, 1024])
def test_kiss_fft_fixed_matches_reference(n, inverse):
    """Every TM's transform size (radix-4 stages, and one radix-2 stage
    at 2048 and 512), both directions."""
    re, im = _int16_planes(np.random.default_rng(n + inverse), (3, 5, n))
    # jitted: one compile instead of one for each eager op
    want = jax.jit(jk.kiss_fft_fixed, static_argnames="inverse")(
        jnp.asarray(re), jnp.asarray(im), inverse=inverse)
    got = tk.kiss_fft_fixed(_t(re), _t(im), inverse=inverse)
    assert [p for p, _ in tk.kf_factor(n)] == [p for p, _ in
                                                jk.kf_factor(n)]
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ov", [12, 90])
def test_guard_interval_windowed_fixed_matches_reference(ov):
    p = tables.mode_params(1)
    x = _int16_planes(np.random.default_rng(ov),
                      (2, p.nb_symbols + 1, p.spacing))
    want = jax.jit(jk.guard_interval_windowed_fixed, static_argnums=(1, 2, 3))(
        tuple(jnp.asarray(v) for v in x), p.null_size, p.sym_size, ov)
    got = tk.guard_interval_windowed_fixed(tuple(_t(v) for v in x),
                                           p.null_size, p.sym_size, ov)
    for g, w in zip(got, want):
        assert g.shape == (2, p.tf_samples)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tk.window_edges_q14(ov, torch.device(
        "cpu"))[0].numpy(), jk.window_q14(0.5 * (1.0 - np.cos(
            np.pi * np.arange(2 * ov) / (2 * ov - 1))))[:ov])


# ---------------------------------------------------------------------------
# the kiss modulator against the goldens and dabmod_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,ov", [("e2e_iq_fixed", 0),
                                     ("e2e_iq_fixed_ov90", 90)])
def test_kiss_configuration_bit_exact(name, ov):
    """As tests/test_ofdm_golden.py:241-262: the s16 wire samples of the
    reference's fft_engine=kiss configuration, bit for bit."""
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  ModSettings(dab_mode=1, fft_engine="kiss",
                              ofdm_window_overlap=ov), device="cpu")
    fic = load("e2e_fixed_fic_in").reshape(8, 96)
    sub0 = load("e2e_fixed_sub0_in").reshape(8, -1)
    sub1 = load("e2e_fixed_sub1_in").reshape(8, -1)
    out, state, stats = m.modulate(fic, (sub0, sub1), m.init_state())
    assert out.dtype == torch.int32 and out.shape == (2, 196608)
    np.testing.assert_array_equal(out.numpy().view(np.int16).reshape(-1),
                                  load(name).astype(np.int16))
    assert set(state) == {"ti_history", "tf_index"}
    assert stats["num_clipped"].dtype == torch.int32
    assert int(stats["num_clipped"]) == 0


@pytest.mark.parametrize("mode,ov", [(2, 0), (3, 63), (4, 90)])
def test_kiss_other_modes_match_reference(mode, ov):
    """TM II-IV (transforms of 512, 256 and 1024), plain and windowed (up
    to TM III's whole guard interval), against dabmod_tpu's kiss modulator (as tests/test_ofdm_golden.py:
    307-340 builds it), two batches with the state carried."""
    p = tables.mode_params(mode)
    n = 2 * p.cif_count
    raw = synth_eti_batch(2 * n, mode=mode, seed=mode + ov)
    kw = dict(dab_mode=mode, fft_engine="kiss", ofdm_window_overlap=ov)
    mj = JModulator(j_layout(mode), JSettings(**kw))
    m = Modulator(make_default_layout(mode), ModSettings(**kw), device="cpu")
    sj, st = mj.init_state(), m.init_state()
    for b in (parse_eti_frames(raw[:n]), parse_eti_frames(raw[n:])):
        want, sj, _ = mj.modulate(b.fic, tuple(b.subchannels), sj)
        got, st, _ = m.modulate_eti(b, st)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(st["tf_index"]) == int(sj["tf_index"]) == 4
