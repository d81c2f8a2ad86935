"""The port on a CUDA card: each kernel against its plain PyTorch version,
and the modulator on the card against the same modulator on the CPU.

Every test here carries the `cuda` marker and skips without a card.  The
file imports neither JAX nor dabmod_tpu, so it also runs where JAX is not
installed:

    DABMOD_TEST_ON_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

(DABMOD_TEST_ON_TPU=1 keeps tests/conftest.py from importing JAX.)

Tolerances: fp32 transforms summed in other orders, atol 2e-5*max|ref| for
the OFDM kernels (tests/test_ofdm_kernel.py:31-32) and 3e-5*max|ref|
through the modulator (:88-89); s16 words within 1 LSB with equal clip
counts.  CFR clip counts may differ from the plain version's by the
samples that lie within 1e-5 (relative) of a threshold
(ofdm_kernel.cfr_threshold_margin), where fp32 sums in other orders may
fall either side; the power lanes rtol 1e-4.  The resampler within rtol
1e-5, atol 1e-5*max|ref| (fp32 sums of the band, 33 to 127 taps, in other
orders).  The DPD chain's stages within 1e-5*max|ref| on their own and
1e-4*max|ref| through the modulator after the poly DPD; a LUT sample may
take the neighbouring entry only within 1e-6 (relative) of a bin edge; the
u8/s8 wire byte-equal.  TF32 is off, except in the tests that run with
every global flag at torch's default (`torch_defaults`).
"""
import os

import numpy as np
import pytest
import torch

from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
from dabmod_tpu_torch.models import Modulator, make_default_layout
from dabmod_tpu_torch.ops import filters, ofdm, ofdm_kernel, resampler_kernel
from dabmod_tpu_torch.ops.filters import PolyphasePlan

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # bench.py's ensemble


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _mode_table(mode, card):
    src, valid = tables.bin_map(mode)
    return ofdm_kernel.make_table(tables.freq_interleave_inverse(mode)[src],
                                  valid, card)


def _planes(card, seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32), device=card) for _ in range(2))


def _check_ofdm(x, table):
    """K1 against its plain version; returns the plain samples."""
    before = ofdm_kernel.ofdm_backend.launches
    got = ofdm_kernel.ofdm_backend(x, table)
    torch.cuda.synchronize()
    assert ofdm_kernel.ofdm_backend.launches == before + 1
    ref = ofdm_kernel.ofdm_backend_plain(x, table)
    scale = float(ref[0].abs().max())
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.shape == (*x[0].shape[:2],
                                                       table.n)
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   atol=2e-5 * scale)
    return ref


def _check_cfr(x, table, clip, error_clip):
    """K2 against its plain version; returns the kernel's statistics."""
    before = ofdm_kernel.ofdm_cfr_backend.launches
    got, st = ofdm_kernel.ofdm_cfr_backend(x, table, clip, error_clip)
    torch.cuda.synchronize()
    assert ofdm_kernel.ofdm_cfr_backend.launches == before + 1
    ref, ref_st = ofdm_kernel.ofdm_cfr_backend_plain(x, table, clip,
                                                     error_clip)
    scale = float(ref[0].abs().max())
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.shape == (*x[0].shape[:2],
                                                       table.n)
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   atol=2e-5 * scale)
    st, ref_st = st.cpu().numpy(), ref_st.cpu().numpy()
    margin = ofdm_kernel.cfr_threshold_margin(x, table, clip, error_clip)
    margin = margin.cpu().numpy()
    for lane, k in ((ofdm_kernel.ST_NCLIP, 0), (ofdm_kernel.ST_NERRCLIP, 1)):
        assert (np.abs(st[..., lane] - ref_st[..., lane])
                <= margin[..., k]).all()
    for lane in range(ofdm_kernel.ST_POW_BEFORE, ofdm_kernel.ST_PAD):
        np.testing.assert_allclose(st[..., lane], ref_st[..., lane],
                                   rtol=1e-4)
    assert not st[..., ofdm_kernel.ST_PAD].any()
    return st


def _clip_level(td):
    return 1.2 * float(torch.sqrt(td[0] ** 2 + td[1] ** 2).mean())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_ofdm_kernel_matches_plain(card, mode):
    table = _mode_table(mode, card)
    _check_ofdm(_planes(card, mode, (3, 11, tables.mode_params(mode)
                                     .nb_carriers)), table)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_ofdm_cfr_kernel_matches_plain(card, mode):
    table = _mode_table(mode, card)
    x = _planes(card, 10 + mode, (3, 11, tables.mode_params(mode)
                                  .nb_carriers))
    x[0][0, 0] = 0.0            # an all-zero (NULL) symbol
    x[1][0, 0] = 0.0
    clip = _clip_level(ofdm_kernel.ofdm_backend_plain(x, table))
    st = _check_cfr(x, table, clip, 0.5)
    assert not st[0, 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("symbols", [1, 13])
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_ofdm_kernels_odd_symbol_counts(card, mode, symbols):
    """One symbol, and 13: a count that is not a multiple of the 2048/N
    symbols a block carries (below N = 2048), so the last block is
    ragged."""
    table = _mode_table(mode, card)
    x = _planes(card, 20 + mode + symbols,
                (1, symbols, tables.mode_params(mode).nb_carriers))
    clip = _clip_level(_check_ofdm(x, table))
    _check_cfr(x, table, clip, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_ofdm_cfr_kernel_clips_every_sample(card, mode):
    """A symbol 10^4 times larger than the others: every one of its
    samples is clipped, and its statistics still match."""
    table = _mode_table(mode, card)
    x = _planes(card, 30 + mode, (2, 5, tables.mode_params(mode)
                                  .nb_carriers))
    clip = _clip_level(ofdm_kernel.ofdm_backend_plain(x, table))
    x[0][1, 2] *= 1e4
    x[1][1, 2] *= 1e4
    st = _check_cfr(x, table, clip, 0.5)
    assert st[1, 2, ofdm_kernel.ST_NCLIP] == table.n


# L/M = 2, 4, 3/2, 1/2 (compile-time M), 3/4, 7/8, 17/16, 1/4 (run-time M)
RES_RATES = [4_096_000, 8_192_000, 3_072_000, 1_024_000, 1_536_000,
             1_792_000, 2_176_000, 512_000]


def _check_resampler(card, rate, n, seed):
    """K3 against its plain version on an n-sample stream: the samples
    within rtol 1e-5, atol 1e-5*max|ref|, the carry equal; returns the
    plan, table, input, carry and the kernel's output."""
    plan = PolyphasePlan.create(2_048_000, rate)
    table = resampler_kernel.make_table(plan, card)
    rng = np.random.default_rng(seed)
    x = tuple(torch.as_tensor(rng.standard_normal(n).astype(
        np.float32), device=card) for _ in range(2))
    c = tuple(torch.as_tensor(rng.standard_normal(2 * plan.half).astype(
        np.float32), device=card) for _ in range(2))
    before = resampler_kernel.resample.launches
    got, carry = resampler_kernel.resample(x, c, table)
    torch.cuda.synchronize()
    assert resampler_kernel.resample.launches == before + 1
    ref, ref_carry = resampler_kernel.resample_plain(x, c, table)
    scale = float(ref[0].abs().max())
    for g, r in zip(got, ref):
        assert g.shape == (n * plan.L // plan.M,)
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5 * scale)
    for g, r in zip(carry, ref_carry):
        assert torch.equal(g, r)
    return plan, table, x, c, got


@pytest.mark.cuda
@pytest.mark.parametrize("rate", RES_RATES)
def test_resampler_kernel_matches_plain(card, rate):
    plan, table, x, c, got = _check_resampler(card, rate, 128 * 300,
                                              rate // 1000)
    # two half-stream calls with the carry == one call
    (a_r, a_i), mid = resampler_kernel.resample(
        tuple(v[:128 * 150] for v in x), c, table)
    (b_r, b_i), _ = resampler_kernel.resample(
        tuple(v[128 * 150:] for v in x), mid, table)
    assert torch.equal(torch.cat([a_r, b_r]), got[0])
    assert torch.equal(torch.cat([a_i, b_i]), got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 128 * 37])
@pytest.mark.parametrize("rate", RES_RATES)
def test_resampler_kernel_short_and_ragged_streams(card, rate, n):
    """One 128-sample frame (one block, mostly empty), and 37 frames: not
    a multiple of a block's outputs, so the last block is ragged."""
    plan, table, *_ = _check_resampler(card, rate, n, rate // 1000 + n)
    assert (n // plan.M) % table.layout.q_per_chunk


@pytest.mark.cuda
def test_resampler_refuses_outputs_it_cannot_store(card):
    """The kernel stores 16 bytes at a time: an output buffer that is not
    16-byte aligned is refused before any launch."""
    plan = PolyphasePlan.create(2_048_000, 8_192_000)
    table = resampler_kernel.make_table(plan, card)
    x = tuple(torch.zeros(128, device=card) for _ in range(2))
    c = tuple(torch.zeros(2 * plan.half, device=card) for _ in range(2))
    buf = torch.empty(512 + 1, device=card)
    before = resampler_kernel.resample.launches
    with pytest.raises(ValueError, match="16-byte"):
        resampler_kernel._launch(x, c, table, buf[1:], buf[:512])
    assert resampler_kernel.resample.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("spacing", [256, 512, 1024, 2048])
def test_ofdm_launch_shapes_match_the_wrapper(card, spacing):
    """The block layout K1 and K2 launch with is the one their wrapper and
    the CPU model of the FFT core (tests/fft_core_model.py) assume, and
    each instance fits on an SM (the occupancy calculator gives at least
    one block)."""
    for cfr in (False, True):
        shape = ofdm_kernel.launch_shape(spacing, cfr)
        assert shape["threads_per_block"] == ofdm_kernel.THREADS_PER_BLOCK
        assert (shape["symbols_per_block"]
                == ofdm_kernel.symbols_per_block(spacing))
        assert shape["resident_blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("rate", RES_RATES)
def test_resampler_launch_shape_fits(card, rate):
    """The source builds the instance make_table chose (its M, KP and R),
    with the wrapper's threads, and it fits on an SM at the table's
    shared memory."""
    table = resampler_kernel.make_table(
        PolyphasePlan.create(2_048_000, rate), card)
    shape = resampler_kernel.launch_shape(table)
    assert shape["dynamic_smem_bytes"] == table.layout.smem_bytes
    assert (shape["instance"]
            == list(resampler_kernel.INSTANCES[table.layout.instance]))
    assert shape["threads_per_block"] == resampler_kernel.THREADS
    assert shape["resident_blocks_per_sm"] >= 1


MOD_PATHS = {"main": {},
             "cfr_8m192": dict(enable_cfr=True, cfr_clip=40.0,
                               cfr_error_clip=3.0, output_rate=8_192_000),
             # the error clip acts (tests/test_quality.py:151-154); L/M 3/2
             "cfr30_3m072": dict(enable_cfr=True, cfr_clip=30.0,
                                 cfr_error_clip=0.1, output_rate=3_072_000)}


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["planes", "s16"])
@pytest.mark.parametrize("path", list(MOD_PATHS))
def test_modulator_on_card_matches_cpu(card, path, fmt):
    """Two batches of 2 TFs, state carried, through the kernels on the card
    and through the plain versions on the CPU."""
    kw = (dict(device_interleave=False) if fmt == "planes"
          else dict(output="file", file_output_format="s16"))
    settings = ModSettings(dab_mode=1, **kw,
                           **MOD_PATHS[path]).normalise_for_output()
    kernels = ((ofdm_kernel.ofdm_cfr_backend, resampler_kernel.resample)
               if path != "main" else (ofdm_kernel.ofdm_backend,))
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=4)
    batches = [parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])]
    outs, margins = {}, []
    for dev in (card, "cpu"):
        m = Modulator(make_default_layout(1, BENCH_SPECS), settings,
                      device=dev)
        state, res = m.init_state(), []
        before = [k.launches for k in kernels]
        for b in batches:
            if dev == "cpu" and settings.enable_cfr:
                syms, _ = m.ofdm_symbols(b.fic, b.subchannels,
                                         state["ti_history"])
                margins.append(ofdm_kernel.cfr_threshold_margin(
                    syms, m._ofdm_table, settings.cfr_clip,
                    settings.cfr_error_clip).sum(dim=1).numpy())
            out, state, stats = m.modulate_eti(b, state)
            res.append((out, {k: v.cpu().numpy() for k, v in stats.items()}))
        launched = [k.launches - n for k, n in zip(kernels, before)]
        assert launched == [2 if dev == card else 0] * len(kernels)
        assert int(state["tf_index"]) == 4
        outs[str(dev)] = res
    for i, ((g, gs), (c, cs)) in enumerate(zip(outs[str(card)],
                                               outs["cpu"])):
        assert set(gs) == set(cs)
        for k in ("num_clipped", "mer_valid"):
            if k in cs:
                np.testing.assert_array_equal(gs[k], cs[k])
        if "cfr_clip" in cs:
            for k, lane in (("cfr_clip", 0), ("cfr_errclip", 1)):
                assert (np.abs(gs[k] - cs[k]) <= margins[i][:, lane]).all()
            if settings.cfr_error_clip < 1.0:       # it acts, as intended
                assert cs["cfr_errclip"].min() > 0
            for k, atol in (("papr_before_cfr", 1e-3),
                            ("papr_after_cfr", 1e-3), ("mer_db", 0.1)):
                np.testing.assert_allclose(gs[k], cs[k], atol=atol)
        if fmt == "s16":
            d = (g.cpu().view(torch.int16).int()
                 - c.view(torch.int16).int()).abs().max()
            assert int(d) <= 1
            continue
        scale = max(float(x.abs().max()) for x in c)
        for gp, cp in zip(g, c):
            np.testing.assert_allclose(gp.cpu().numpy(), cp.numpy(),
                                       atol=3e-5 * scale)


@pytest.mark.cuda
def test_default_device_is_the_card(card):
    m = Modulator(make_default_layout(1))
    assert m.device.type == "cuda"
    assert m.init_state()["tf_index"].device.type == "cuda"


# ---------------------------------------------------------------------------
# the DPD chain's stages (plain PyTorch on the card) against the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def torch_defaults():
    """Every global TF32 flag at torch's default (matmul off, cuDNN on,
    float32 matmul precision "highest") for the test, restored after: a
    stage written as a cuDNN convolution would lose precision here."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cuda.matmul.allow_tf32 = saved[1]
    torch.backends.cudnn.allow_tf32 = saved[2]


def _close(got, ref, rel):
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda" and g.shape == r.shape
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   atol=rel * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_windowed_guard_interval_on_card(card, mode):
    p = tables.mode_params(mode)
    x = _planes("cpu", 40 + mode, (2, p.nb_symbols + 1, p.spacing))
    g = torch.rand(2, p.nb_symbols + 1) * 90 + 10
    ov = min(90, p.sym_size - p.spacing)
    ref = ofdm.guard_interval_windowed(x, p.null_size, p.sym_size, ov, g)
    got = ofdm.guard_interval_windowed(tuple(v.to(card) for v in x),
                                       p.null_size, p.sym_size, ov,
                                       g.to(card))
    _close(got, ref, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048 * 4, 3000])
def test_fir_on_card_with_default_flags(card, torch_defaults, n):
    """The banded (n a multiple of 128) and generic FIR forms on the card
    with torch's default flags: fp32 matmuls, so within 1e-5 of the CPU
    (TF32 would give about 1e-3)."""
    x = _planes("cpu", n, (3, n))
    for taps in (tables.DEFAULT_FIR_TAPS,
                 np.random.default_rng(1).normal(size=45).astype(
                     np.float32)):
        t = torch.as_tensor(taps)
        ref = filters.fir_filter(x, t)
        got = filters.fir_filter(tuple(v.to(card) for v in x), t.to(card))
        _close(got, ref, 1e-5)


@pytest.mark.cuda
def test_polyphase_plain_form_on_card_with_default_flags(card,
                                                         torch_defaults):
    """2.5 MS/s, the plan K3 does not take, through the plain form's
    matmul on the card."""
    plan = PolyphasePlan.create(2_048_000, 2_500_000,
                                block=filters.PLAIN_BLOCK)
    x = _planes("cpu", 50, (512 * 40,))
    c = _planes("cpu", 51, (2 * plan.half,))
    ref, ref_c = filters.resample_poly(x, plan, c)
    got, got_c = filters.resample_poly(tuple(v.to(card) for v in x), plan,
                                       tuple(v.to(card) for v in c))
    _close(got, ref, 1e-5)
    for g, r in zip(got_c, ref_c):
        assert torch.equal(g.cpu(), r)


LUT = (np.linspace(1.0, 0.9, 32) + 1j * np.linspace(0, 0.05, 32)
       ).astype(np.complex64)          # tests/test_filters.py:151-153
LUT_PAIRS = np.stack([LUT.real, LUT.imag], -1).astype(np.float32)
POLY_AM = (1.0, 0.1, -0.05, 0.02, -0.01)   # tests/test_filters.py:133-134
POLY_PM = (0.02, -0.01, 0.005, 0.0, 0.0)


@pytest.mark.cuda
def test_memless_poly_on_card(card):
    x = tuple(v * 0.5 for v in _planes("cpu", 52, (4, 5000)))
    am, pm = (torch.tensor(c, dtype=torch.float32) for c in (POLY_AM,
                                                             POLY_PM))
    ref = filters.memless_poly(x, am, pm)
    got = filters.memless_poly(tuple(v.to(card) for v in x), am.to(card),
                               pm.to(card))
    _close(got, ref, 1e-5)


@pytest.mark.cuda
def test_memless_lut_on_card(card):
    """The same bins as the CPU except within 1e-6 of a bin edge."""
    x = _planes("cpu", 53, (4, 5000))
    scale = torch.tensor(np.float32(2.0 ** 31))
    lut = torch.as_tensor(LUT_PAIRS)
    ref = filters.memless_lut(x, lut, scale)
    xc = tuple(v.to(card) for v in x)
    got = filters.memless_lut(xc, lut.to(card), scale.to(card))
    other = (filters.lut_index(xc, scale.to(card)).cpu()
             != filters.lut_index(x, scale))
    edge = filters.lut_edge_samples(x, scale)
    assert not (other & ~edge).any()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu()[~other].numpy(),
                                   r[~other].numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["u8", "s8", "s16"])
def test_format_convert_on_card(card, fmt):
    rng = np.random.default_rng(54)
    x = torch.as_tensor(rng.uniform(-300, 300, (2, 4096, 2)).astype(
        np.float32))
    x.view(-1)[:8] = torch.tensor([127.5, -128.5, 255.9, -0.5, 0.5, -1.5,
                                   32767.5, -32768.5])
    ref, n_ref = filters.format_convert(x, fmt)
    got, n = filters.format_convert(x.to(card), fmt)
    assert got.cpu().numpy().tobytes() == ref.numpy().tobytes()
    assert int(n) == int(n_ref) > 0
    if fmt != "s16":
        assert torch.equal(filters.pack_bytes(got).cpu(),
                           filters.pack_bytes(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [4_096_000, 1_024_000, 3_072_000,
                                  1_536_000])
def test_freq_resampler_on_card(card, rate):
    """cuFFT against the CPU's transforms: within 2e-5 of max|ref|."""
    plan = filters.ResamplerPlan.create(2_048_000, rate, 2048)
    hi, ho = plan.fft_in // 2, plan.fft_out // 2
    rng = np.random.default_rng(rate // 1000)
    x, it, ot = (torch.as_tensor(rng.standard_normal((n, 2)).astype(
        np.float32)) for n in (hi * 8, hi, ho))
    ref = filters.resample(x, plan, it, ot)
    got = filters.resample(x.to(card), plan, it.to(card), ot.to(card))
    _close(got, ref, 2e-5)


# ---------------------------------------------------------------------------
# the DPD chain through the modulator on the card against the CPU
# ---------------------------------------------------------------------------

def _poly_file(directory, am=POLY_AM, pm=POLY_PM, name="poly.coef"):
    path = os.path.join(str(directory), name)
    with open(path, "w") as f:
        f.write("1\n5\n" + "".join(f"{v!r}\n" for v in (*am, *pm)))
    return path


def _dpd_chain(tmp_path):
    """chip_smoke.py's realistic17_dpd_8m192 settings: TII (comb 5,
    pattern 31), CFR 40/3, overlap 90, the default FIR, 8.192 MS/s, the
    poly DPD, f32 planes at the UHD scale."""
    return ModSettings(
        dab_mode=1, output="uhd", device_interleave=False, tii_enable=True,
        tii_comb=5, tii_pattern=31, enable_cfr=True, cfr_clip=40.0,
        cfr_error_clip=3.0, ofdm_window_overlap=90,
        filter_taps_file="default", output_rate=8_192_000,
        poly_coef_file=_poly_file(tmp_path)).normalise_for_output()


def _run_both(card, settings, n_batches=2, seed=6, traced=None):
    """The modulator on the card and on the CPU, two batches of 2 TFs with
    the state carried; returns ({dev: [(out, stats)]}, launches on the
    card per kernel)."""
    kernels = {"ofdm_ifft": ofdm_kernel.ofdm_backend,
               "ofdm_cfr": ofdm_kernel.ofdm_cfr_backend,
               "resample_poly": resampler_kernel.resample}
    raw = synth_eti_batch(8 * n_batches, mode=1, subch_specs=BENCH_SPECS,
                          seed=seed)
    outs, launched = {}, {}
    for dev in (card, "cpu"):
        m = Modulator(make_default_layout(1, BENCH_SPECS), settings,
                      device=dev)
        state, res = m.init_state(), []
        before = {k: f.launches for k, f in kernels.items()}
        for i in range(n_batches):
            b = parse_eti_frames(raw[8 * i:8 * (i + 1)])
            if traced is None:
                out, state, stats = m.modulate_eti(b, state)
            else:
                out, state, stats = m.modulate_traced(
                    b.fic, tuple(b.subchannels), state,
                    os.path.join(traced, str(dev)))
            res.append((out, {k: v.cpu() for k, v in stats.items()}))
        if dev == card:
            torch.cuda.synchronize()
            launched = {k: f.launches - before[k]
                        for k, f in kernels.items()}
        outs[str(dev)] = res
    return outs[str(card)], outs["cpu"], launched


@pytest.mark.cuda
def test_dpd_chain_on_card(card, tmp_path):
    """The new full-width path's settings at 2 TFs a batch: K2 and K3
    launched once a batch, K1 never; the output within 1e-4*max|ref| of
    the CPU's, CFR's PAPR within 1e-3 dB."""
    gpu, cpu, launched = _run_both(card, _dpd_chain(tmp_path))
    assert launched == {"ofdm_ifft": 0, "ofdm_cfr": 2, "resample_poly": 2}
    for (g, gs), (c, cs) in zip(gpu, cpu):
        assert g[0].shape == (2, 4 * tables.mode_params(1).tf_samples)
        _close(g, c, 1e-4)
        for k in ("papr_before_cfr", "papr_after_cfr"):
            np.testing.assert_allclose(gs[k], cs[k], atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("rate,mode,k3", [(2_500_000, "auto", 0),
                                          (1_536_000, "auto", 0),
                                          (4_096_000, "fft", 0),
                                          (4_096_000, "auto", 2)])
def test_resampler_route_on_card(card, rate, mode, k3):
    """The route is fixed by the plan: the plain polyphase form and the
    frequency-domain resampler never launch K3, K3's plans always do."""
    s = ModSettings(dab_mode=1, device_interleave=False, output_rate=rate,
                    resampler_mode=mode)
    gpu, cpu, launched = _run_both(card, s)
    assert launched == {"ofdm_ifft": 2, "ofdm_cfr": 0, "resample_poly": k3}
    for (g, _), (c, _) in zip(gpu, cpu):
        _close(g, c, 3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(output="file", file_output_format="u8"),
    dict(output="zmq", zmq_output_format="s8", digital_gain=3.0),
    dict(cic_eq_clock_rate=32_768_000),
    dict(tii_enable=True, tii_comb=5, tii_pattern=31)])
def test_modulator_variants_on_card(card, kw):
    s = ModSettings(dab_mode=1, device_interleave=False,
                    **kw).normalise_for_output()
    gpu, cpu, _ = _run_both(card, s)
    for (g, gs), (c, cs) in zip(gpu, cpu):
        if isinstance(c, tuple):
            _close(g, c, 3e-5)
            continue
        byte = torch.uint8 if "file" in kw.values() else torch.int8
        d = (g.cpu().view(byte).int() - c.view(byte).int()).abs().max()
        assert int(d) <= 1
        assert int(gs["num_clipped"]) == int(cs["num_clipped"])


@pytest.mark.cuda
def test_modulate_traced_on_card(card, tmp_path):
    """The card's stage dumps against the CPU's: the integer stages
    byte-equal, the float stages within 3e-5*max|ref| (1e-4 after the
    poly DPD)."""
    _run_both(card, _dpd_chain(tmp_path), traced=str(tmp_path))
    names = sorted(os.listdir(tmp_path / "cuda"))
    assert names == sorted(os.listdir(tmp_path / "cpu")) and names
    for name in names:
        got = (tmp_path / "cuda" / name).read_bytes()
        ref = (tmp_path / "cpu" / name).read_bytes()
        if name[3:-4] in ("fec", "qpsk_map", "diff_mod"):
            assert got == ref, name
            continue
        g, r = np.frombuffer(got, np.float32), np.frombuffer(ref, np.float32)
        rel = 1e-4 if name.endswith("dpd.dat") else 3e-5
        np.testing.assert_allclose(g, r, atol=rel * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.cuda
def test_hot_swap_on_card(card, tmp_path):
    """New FIR taps and poly coefficients between two batches on the card
    give what a modulator built with them gives."""
    taps2 = np.asarray(tables.DEFAULT_FIR_TAPS[::-1], np.float32)
    am2, pm2 = (0.9, 0.01, 0.0, 0.0, 0.0), (0.05, 0.0, 0.0, 0.0, 0.0)
    s = _dpd_chain(tmp_path)
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=8)
    b1, b2 = parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])
    m = Modulator(make_default_layout(1, BENCH_SPECS), s, device=card)
    _, st, _ = m.modulate_eti(b1, m.init_state())
    assert m.update_fir_taps(taps2)
    assert m.update_dpd("poly", (np.asarray(am2), np.asarray(pm2)))
    got, _, _ = m.modulate_eti(b2, st)
    taps_file = os.path.join(str(tmp_path), "taps2.txt")
    with open(taps_file, "w") as f:
        f.write(f"{taps2.size}\n" + "\n".join(repr(float(t))
                                                for t in taps2))
    fresh_s = ModSettings(**{**vars(s), "filter_taps_file": taps_file,
                             "poly_coef_file": _poly_file(
                                 tmp_path, am2, pm2, "p2.coef")})
    fresh = Modulator(make_default_layout(1, BENCH_SPECS), fresh_s,
                      device=card)
    _, st_f, _ = fresh.modulate_eti(b1, fresh.init_state())
    want, _, _ = fresh.modulate_eti(b2, st_f)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the fixed-point engines and the runtime on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_int32_shift_and_mask_on_card(card):
    """The kiss arithmetic's two integer assumptions on CUDA tensors: `>>`
    on a signed int32 is arithmetic, `& 65535` is two's complement."""
    x = torch.tensor([-65536, -32769, -2, -1, 0, 1, 2**31 - 1],
                     dtype=torch.int32)
    got = x.to(card)
    assert torch.equal(torch.bitwise_right_shift(got, 15).cpu(),
                       torch.bitwise_right_shift(x, 15))
    assert torch.equal((got & 65535).cpu(), x & 65535)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,ov", [(1, 0), (1, 90), (2, 90), (3, 63),
                                     (4, 0)])
def test_kiss_on_card_equals_cpu(card, mode, ov):
    """fft_engine=kiss on the card, bit for bit the CPU's (two batches,
    the state carried), at every TM's transform size."""
    p = tables.mode_params(mode)
    n = 2 * p.cif_count
    raw = synth_eti_batch(2 * n, mode=mode, seed=mode)
    s = ModSettings(dab_mode=mode, fft_engine="kiss", ofdm_window_overlap=ov)
    outs = {}
    for dev in (card, "cpu"):
        m = Modulator(make_default_layout(mode), s, device=dev)
        st, res = m.init_state(), []
        for i in range(2):
            out, st, stats = m.modulate_eti(
                parse_eti_frames(raw[n * i:n * (i + 1)]), st)
            res.append(out.cpu())
            assert int(stats["num_clipped"]) == 0
        outs[str(dev)] = res
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert g.dtype == torch.int32 and torch.equal(g, c)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [1, 3])
def test_dexter_on_card_equals_cpu(card, mode):
    """fft_engine=dexter: the card's Q1.14 symbols and the host chain's
    wire words, bit for bit the CPU's."""
    p = tables.mode_params(mode)
    raw = synth_eti_batch(p.cif_count, mode=mode, seed=mode)
    s = ModSettings(dab_mode=mode, fft_engine="dexter",
                    ofdm_window_overlap=12)
    got = {}
    for dev in (card, "cpu"):
        m = Modulator(make_default_layout(mode), s, device=dev)
        syms, _, _ = m.modulate_eti(parse_eti_frames(raw), m.init_state())
        syms = syms.cpu().numpy()
        got[str(dev)] = (syms, m.host_backend(syms))
    for g, c in zip(got["cuda"], got["cpu"]):
        np.testing.assert_array_equal(g, c)


def _runtime_file(tmp_path, fmt, device, **kw):
    from dabmod_tpu_torch.runtime import ModRuntime
    inp = tmp_path / "in.eti"
    if not inp.exists():
        inp.write_bytes(synth_eti_batch(32, mode=1, subch_specs=BENCH_SPECS,
                                        seed=12).tobytes())
    out = tmp_path / f"{device}_{fmt}.iq"
    s = ModSettings(input_name=str(inp), output="file", output_name=str(out),
                    file_output_format=fmt, batch_tf=2,
                    **kw).normalise_for_output()
    rt = ModRuntime(s, device=device)
    assert rt.run() == 0
    rt.close()
    return out.read_bytes(), rt


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,kw", [
    ("complexf", {}), ("s16", {}),
    ("complexf", dict(enable_cfr=True, cfr_clip=40.0, cfr_error_clip=3.0,
                      output_rate=8_192_000)),
    ("s16", dict(fft_engine="kiss")), ("s16", dict(fft_engine="dexter"))],
    ids=["complexf", "s16", "cfr_8m192", "kiss", "dexter"])
def test_runtime_on_card_equals_cpu(card, tmp_path, fmt, kw):
    """ModRuntime on the card (ETI bytes in and output out through pinned
    host memory, non_blocking copies and an event) writes the file the CPU
    runtime writes: f32 within 3e-5*max|ref|, s16 within 1 LSB, the
    fixed-point engines byte for byte."""
    got, rt = _runtime_file(tmp_path, fmt, "cuda", **kw)
    assert rt.device.type == "cuda" and rt.timings["fetch_wait_s"] >= 0
    ref, _ = _runtime_file(tmp_path, fmt, "cpu", **kw)
    assert len(got) == len(ref) > 0
    if kw.get("fft_engine"):
        assert got == ref
    elif fmt == "s16":
        d = np.abs(np.frombuffer(got, np.int16).astype(np.int32)
                   - np.frombuffer(ref, np.int16))
        assert d.max() <= 1
    else:
        g, r = np.frombuffer(got, np.float32), np.frombuffer(ref, np.float32)
        np.testing.assert_allclose(g, r, atol=3e-5 * np.abs(r).max())


@pytest.mark.cuda
def test_runtime_uploads_through_pinned_memory(card, tmp_path):
    """ETI bytes (a strided view, as a parsed batch's sub-channel is) go
    to the card through pinned memory; the output comes back into pinned
    memory."""
    from dabmod_tpu_torch.runtime import ModRuntime
    inp = tmp_path / "in.eti"
    inp.write_bytes(synth_eti_batch(4, mode=1).tobytes())
    rt = ModRuntime(ModSettings(input_name=str(inp), output="file",
                                output_name=str(tmp_path / "o.iq")),
                    device=card)
    a = np.arange(6 * 96, dtype=np.uint8).reshape(6, 96)[:, ::2]
    up = rt._upload(a)
    assert up.device.type == "cuda" and torch.equal(up.cpu(),
                                                    torch.from_numpy(a.copy()))
    down = rt._download(up)
    torch.cuda.synchronize()
    assert down.is_pinned() and torch.equal(down, up.cpu())
    rt.close()
