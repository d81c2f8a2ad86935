"""fft_engine=dexter in the port: the device's Q1.14 carrier symbols and
the host chain (dabmod_tpu_torch/io/dexter_fft.py, a copy of
dabmod_tpu/io/dexter_fft.py) against dabmod_tpu, bit for bit, and the
cases of tests/test_dexter_fft.py run on both modules; the fixed-point
construction checks of both engines.
"""
import numpy as np
import pytest
import torch

from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.io import dexter_fft as j_dx
from dabmod_tpu.models import Modulator as JModulator
from dabmod_tpu.models import make_default_layout as j_layout
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
from dabmod_tpu_torch.io import dexter_fft as t_dx
from dabmod_tpu_torch.models import Modulator, make_default_layout
from test_dexter_fft import _naive_wide_gi
from torch_threads import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.fixture(params=[j_dx, t_dx], ids=["dabmod_tpu", "dabmod_tpu_torch"])
def dx(request):
    return request.param


# ---------------------------------------------------------------------------
# tests/test_dexter_fft.py's cases of the module alone, on both copies
# ---------------------------------------------------------------------------

def test_bin_placement_tm1_matches_reference_comment(dx):
    # src/OfdmGenerator.cpp:588-592
    p = dx.bin_placement(1536, 2048)
    assert (p.zero_dst, p.zero_size) == (769, 511)
    assert (p.pos_src, p.pos_dst, p.pos_size) == (0, 1, 768)
    assert (p.neg_src, p.neg_dst, p.neg_size) == (768, 1280, 768)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_bin_placement_covers_all_modes(dx, mode):
    p = tables.mode_params(mode)
    pl = dx.bin_placement(p.nb_carriers, p.spacing)
    assert pl.pos_size + pl.neg_size == p.nb_carriers
    assert pl.zero_dst + pl.zero_size == pl.neg_dst
    assert pl.neg_dst + pl.neg_size == p.spacing


def test_bin_placement_odd_carriers_and_overflow(dx):
    pl = dx.bin_placement(5, 8)
    assert (pl.pos_dst, pl.pos_size, pl.neg_dst, pl.neg_size) == (0, 3, 6, 2)
    with pytest.raises(ValueError, match="nbCarriers > spacing"):
        dx.bin_placement(9, 8)


def test_accelerator_transform_matches_placed_idft(dx):
    """The model: inverse DFT of the placed spectrum with 64/N block
    scaling, rounded half away from zero."""
    spacing, carriers, S = 64, 48, 5
    rng = np.random.default_rng(7)
    re = rng.integers(-16384, 16384, (S, carriers)).astype(np.int16)
    im = rng.integers(-16384, 16384, (S, carriers)).astype(np.int16)
    mock = dx.MockFftAcceleratorIio(spacing)
    acc = dx.DexterFftAccelerator(S, carriers, spacing, iio_module=mock)
    out_re, out_im = acc.process(re, im)
    assert mock.n_transforms == S
    pl = acc.place
    for s in range(S):
        bins = np.zeros(spacing, np.complex128)
        c = re[s].astype(np.float64) + 1j * im[s].astype(np.float64)
        bins[pl.pos_dst:pl.pos_dst + pl.pos_size] = c[:pl.pos_size]
        bins[pl.neg_dst:pl.neg_dst + pl.neg_size] = c[pl.pos_size:]
        td = np.fft.ifft(bins) * 64.0
        for got, part in ((out_re[s], td.real), (out_im[s], td.imag)):
            np.testing.assert_array_equal(
                got, (np.floor(np.abs(part) + 0.5) * np.sign(part))
                .astype(np.int32))


def test_accelerator_pipelines_one_buffer_in_flight(dx):
    mock = dx.MockFftAcceleratorIio(16)
    depth = {"max": 0}
    orig = mock._push_input

    def tracked(payload):
        orig(payload)
        depth["max"] = max(depth["max"], len(mock._results))
    mock._push_input = tracked
    acc = dx.DexterFftAccelerator(6, 12, 16, iio_module=mock)
    acc.process(np.ones((6, 12), np.int16), np.zeros((6, 12), np.int16))
    assert depth["max"] <= 2


def test_accelerator_rejects_bad_input_and_missing_devices(dx):
    acc = dx.DexterFftAccelerator(3, 12, 16,
                                  iio_module=dx.MockFftAcceleratorIio(16))
    with pytest.raises(ValueError, match="input size not valid"):
        acc.process(np.zeros((3, 10), np.int16), np.zeros((3, 10), np.int16))

    class Empty:
        def Context(self):
            return self

        def find_device(self, name):
            return None
    with pytest.raises(RuntimeError, match="OfdmGeneratorDEXTER"):
        dx.DexterFftAccelerator(3, 12, 16, iio_module=Empty())


def test_wide_gi_matches_naive_reference_loop(dx):
    rng = np.random.default_rng(3)
    B, S, sp, sym, nul, ov = 2, 4, 16, 20, 18, 3
    re = rng.integers(-(1 << 24), 1 << 24, (B, S, sp)).astype(np.int32)
    im = rng.integers(-(1 << 24), 1 << 24, (B, S, sp)).astype(np.int32)
    got = dx.guard_interval_windowed_wide((re, im), nul, sym, ov)
    for g, w in zip(got, _naive_wide_gi(re, im, nul, sym, ov)):
        np.testing.assert_array_equal(g, w)
    gr, _ = dx.guard_interval_unwindowed_wide((re, im), nul, sym)
    assert gr.shape == (B, nul + (S - 1) * sym)
    np.testing.assert_array_equal(
        gr[0, nul:nul + sym], np.concatenate([re[0, 1, 2 * sp - sym:],
                                              re[0, 1]]))


def test_fpm_mul_q16_and_wide_to_s16(dx):
    one = 1 << 16
    assert dx.fpm_mul_q16(np.int64(-one), np.int64(one)) == -one
    assert dx.fpm_mul_q16(np.int64(3), np.int64(one // 2)) == 2
    assert dx.fpm_mul_q16(np.int64(-3), np.int64(one // 2)) == -2
    re = np.array([[0, 64, -64, 63, (1 << 22), -(1 << 22)]], np.int32)
    im = np.array([[0, 127, -127, -63, 32767 * 64, -32768 * 64]], np.int32)
    s16, n_clipped = dx.format_convert_wide_s16(re, im)
    np.testing.assert_array_equal(s16[0, :, 0], [0, 1, -1, 0, 32767, -32768])
    np.testing.assert_array_equal(s16[0, :, 1], [0, 1, -2, -1, 32767, -32768])
    assert n_clipped == 2


# ---------------------------------------------------------------------------
# the modulator's dexter engine against dabmod_tpu's
# ---------------------------------------------------------------------------

def _pair(mode, **kw):
    kw = dict(dab_mode=mode, fft_engine="dexter", **kw)
    return (JModulator(j_layout(mode), JSettings(**kw)),
            Modulator(make_default_layout(mode), ModSettings(**kw),
                      device="cpu"))


@pytest.mark.parametrize("mode,ov", [(1, 0), (3, 12)])
def test_dexter_symbols_and_wire_match_reference(mode, ov):
    """The device's Q1.14 carrier symbols [2, B, S, C] and the host
    chain's s16 wire words and clip count, against dabmod_tpu's, bit for
    bit; one TF a batch in TM I (the accelerator model is a dense DFT),
    two batches with the state carried."""
    p = tables.mode_params(mode)
    n = p.cif_count * (1 if mode == 1 else 2)
    raw = synth_eti_batch(2 * n, mode=mode, seed=mode)
    mj, m = _pair(mode, ofdm_window_overlap=ov)
    assert m.emits_planes is False and m._wire_fmt == "s16"
    assert type(m.host_backend).__module__ == "dabmod_tpu_torch.io.dexter_fft"
    sj, st = mj.init_state(), m.init_state()
    for b in (parse_eti_frames(raw[:n]), parse_eti_frames(raw[n:])):
        want, sj, want_stats = mj.modulate(b.fic, tuple(b.subchannels), sj)
        got, st, stats = m.modulate_eti(b, st)
        assert stats == {} == want_stats
        assert got.dtype == torch.int32
        assert got.shape == (2, n // p.cif_count, p.nb_symbols + 1,
                             p.nb_carriers)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        words = m.host_backend(got.numpy())
        np.testing.assert_array_equal(words, mj.host_backend(np.asarray(
            want)))
        assert m.host_backend.num_clipped == mj.host_backend.num_clipped
    assert int(st["tf_index"]) == int(sj["tf_index"])


def test_dexter_engine_matches_kiss_amplitude():
    """As tests/test_dexter_fft.py:224-257, on the port: the dexter chain
    lands on the kiss chain's s16 scale, within the fixed-point noise."""
    mode = 3
    layout = make_default_layout(mode)
    b = parse_eti_frames(synth_eti_batch(2, mode=mode))
    md = Modulator(layout, ModSettings(dab_mode=mode, fft_engine="dexter",
                                       ofdm_window_overlap=12), device="cpu")
    syms, _, _ = md.modulate_eti(b, md.init_state())
    mine = md.host_backend(syms.numpy()).view(np.int16).astype(np.float32)
    mk = Modulator(layout, ModSettings(dab_mode=mode, fft_engine="kiss",
                                       ofdm_window_overlap=12), device="cpu")
    out, _, _ = mk.modulate_eti(b, mk.init_state())
    ref = out.numpy().view(np.int16).astype(np.float32)
    assert mine.shape == ref.shape
    mer = 10 * np.log10((ref ** 2).sum() / ((mine - ref) ** 2).sum())
    assert mer >= 40.0, mer


@pytest.mark.parametrize("engine", ["kiss", "dexter"])
@pytest.mark.parametrize("kw,match", [
    ({"filter_taps_file": "default"}, "fixed point doesn't support fir"),
    ({"poly_coef_file": "poly.coef"}, "fixed point doesn't support pred"),
    ({"output_rate": 4_096_000}, "fixed point doesn't support resampler"),
    ({"enable_cfr": True, "cfr_clip": 10.0}, "fixed point doesn't support "
                                             "CFR"),
    ({"output": "soapy"}, "soapy fixed_point unsupported"),
    ({"output": "lime"}, "lime fixed_point unsupported"),
    ({"output": "bladerf"}, "bladerf fixed_point unsupported"),
])
def test_fixed_point_construction_checks(engine, kw, match):
    """The stages the fixed-point chain has no form of are refused when
    the modulator is built, with dabmod_tpu's messages
    (src/DabModulator.cpp:246-263)."""
    for cls, settings, extra in (
            (JModulator, JSettings, {}),
            (Modulator, ModSettings, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            cls(make_default_layout(1), settings(dab_mode=1,
                                                 fft_engine=engine, **kw),
                **extra)
