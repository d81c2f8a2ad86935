"""The port on a CUDA card, the one check of it there: each kernel built
without spills and against its plain PyTorch version, the front end and
the fixed-point chain against the reference's goldens, the modulator on
the card against the same modulator on the CPU (at full width too), the
captured step against the eager one, the runtime, the CLI, the live
inputs and the sharded step (over four cards where there are four).

Every test here but the parser's (test_ptxas_log_parser) carries the
`cuda` marker and skips without a card (the four-card cases with fewer
than four).  The file imports neither JAX nor dabmod_tpu, so it also runs
where JAX is not installed:

    DABMOD_TEST_ON_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda

(DABMOD_TEST_ON_TPU=1 keeps tests/conftest.py from importing JAX.)  The
kernels' times are time_kernels.py's, the steps' bench_gpu.py's and the
program's the benchmark's (benchmark/).

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
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_gpu
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import (REALISTIC_MUX_SPECS, parse_eti_frames,
                                  synth_eti_batch)
from dabmod_tpu_torch.models import Modulator, make_default_layout
from dabmod_tpu_torch.ops import (build, filters, kiss_kernel, ofdm,
                                  ofdm_kernel, resampler_kernel)
from dabmod_tpu_torch.ops.filters import PolyphasePlan
from golden import load as load_golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # bench.py's ensemble


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cards(n):
    """Skips below n cards."""
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, one a rank")


# ---------------------------------------------------------------------------
# the builds: no kernel spills
# ---------------------------------------------------------------------------

def parse_ptxas(text: str) -> dict:
    """Each function in nvcc's -Xptxas -v output (keyed by its mangled
    name): its registers, shared memory and spill stores and loads, in
    bytes."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {"registers": 0, "smem_bytes": 0,
                                  "spill_stores": 0, "spill_loads": 0})
            continue
        if name is None:
            continue
        for key, pattern in (("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pattern, ln)
            if m:
                out[name][key] = int(m.group(1))
    return out


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6spillyILi11EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6spillyILi11EEvPf
    48 bytes stack frame, 40 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 16384 bytes smem, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5cleanPf' for 'sm_90a'
ptxas info    : Function properties for _Z5cleanPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 5120 bytes smem, 360 bytes cmem[0]
"""


def test_ptxas_log_parser():
    """The parser of the spill check, on a log of one spilling function
    and one clean one (no card needed)."""
    got = parse_ptxas(PTXAS_LOG)
    assert got == {
        "_Z6spillyILi11EEvPf": {"registers": 255, "smem_bytes": 16384,
                                "spill_stores": 40, "spill_loads": 16},
        "_Z5cleanPf": {"registers": 32, "smem_bytes": 5120,
                       "spill_stores": 0, "spill_loads": 0}}


@pytest.mark.cuda
@pytest.mark.parametrize("source", build.SOURCES)
def test_kernel_source_builds_without_spills(card, source):
    """Every function of each CUDA source, as ptxas reports it in the log
    that build.build keeps beside the library (-Xptxas -v): no byte of
    spill stores or loads."""
    (path,) = build.build(source)
    with open(path + ".log") as f:
        funcs = parse_ptxas(f.read())
    assert funcs, f"{source}: ptxas reports no function"
    spilled = {k: v for k, v in funcs.items()
               if v["spill_stores"] or v["spill_loads"]}
    assert not spilled, spilled


@pytest.mark.cuda
def test_native_host_library_loads_on_card(card):
    """The native host library (native/dabmod_native.cpp, g++) builds and
    loads beside the card: the EDI RS decode and the host format
    conversion take it, not their NumPy branches."""
    from dabmod_tpu_torch import native
    assert native.get_lib() is not None


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


# the wrappers' counts of a new modulator's two batches on the card: the
# warm-up before its graph's capture and the capture (a replay runs no
# Python: its launches are counted in a trace, below)
WARMUP_AND_CAPTURE = 2

MOD_PATHS = {"main": {},
             "cfr_8m192": dict(enable_cfr=True, cfr_clip=40.0,
                               cfr_error_clip=3.0, output_rate=8_192_000),
             # the error clip acts (tests/test_quality.py:151-154); L/M 3/2
             "cfr30_3m072": dict(enable_cfr=True, cfr_clip=30.0,
                                 cfr_error_clip=0.1, output_rate=3_072_000)}


# the paths no cell runs, also at full width: the 17-sub-channel ensemble
# at 24 TFs a batch ("<path>_full")
FULL_WIDTH = ("cfr_8m192", "cfr30_3m072")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["planes", "s16"])
@pytest.mark.parametrize("path", [*MOD_PATHS, *(p + "_full"
                                                 for p in FULL_WIDTH)])
def test_modulator_on_card_matches_cpu(card, path, fmt):
    """Two batches, state carried, through the kernels on the card and
    through the plain versions on the CPU: 2 TFs of bench.py's ensemble,
    or at full width 24 TFs of the 17 sub-channels."""
    full = path.endswith("_full")
    path = path.removesuffix("_full")
    specs, tfs = (REALISTIC_MUX_SPECS, 24) if full else (BENCH_SPECS, 2)
    kw = (dict(device_interleave=False) if fmt == "planes"
          else dict(output="file", file_output_format="s16"))
    settings = ModSettings(dab_mode=1, **kw,
                           **MOD_PATHS[path]).normalise_for_output()
    kernels = ((ofdm_kernel.ofdm_cfr_backend, resampler_kernel.resample)
               if path != "main" else (ofdm_kernel.ofdm_backend,))
    raw = synth_eti_batch(8 * tfs, mode=1, subch_specs=specs, seed=4)
    batches = [parse_eti_frames(raw[:4 * tfs]),
               parse_eti_frames(raw[4 * tfs:])]
    outs, margins = {}, []
    for dev in (card, "cpu"):
        m = Modulator(make_default_layout(1, specs), settings, device=dev)
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
        assert launched == [WARMUP_AND_CAPTURE if dev == card else 0] * len(
            kernels)
        assert int(state["tf_index"]) == 2 * tfs
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


def _dpd_chain_kw(tmp_path):
    """The DPD chain of the benchmark's r17_dpd8m192: TII (comb 5, pattern
    31), CFR 40/3, overlap 90, the default FIR, 8.192 MS/s, the poly
    DPD."""
    return dict(tii_enable=True, tii_comb=5, tii_pattern=31, enable_cfr=True,
                cfr_clip=40.0, cfr_error_clip=3.0, ofdm_window_overlap=90,
                filter_taps_file="default", output_rate=8_192_000,
                poly_coef_file=_poly_file(tmp_path))


def _dpd_chain(tmp_path):
    """The DPD chain's settings with f32 planes at the UHD scale."""
    return ModSettings(
        dab_mode=1, output="uhd", device_interleave=False,
        **_dpd_chain_kw(tmp_path)).normalise_for_output()


def _run_both(card, settings, n_batches=2, seed=6, traced=None, mode=1):
    """The modulator on the card and on the CPU, two batches of 8 ETI
    frames (2 TFs in TM I) with the state carried; returns
    ({dev: [(out, stats)]}, launches on the card per kernel)."""
    kernels = {"ofdm_ifft": ofdm_kernel.ofdm_backend,
               "ofdm_cfr": ofdm_kernel.ofdm_cfr_backend,
               "resample_poly": resampler_kernel.resample}
    raw = synth_eti_batch(8 * n_batches, mode=mode, subch_specs=BENCH_SPECS,
                          seed=seed)
    outs, launched = {}, {}
    for dev in (card, "cpu"):
        m = Modulator(make_default_layout(mode, BENCH_SPECS), settings,
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
    launched once a step (and at the warm-up), K1 never; the output within 1e-4*max|ref| of
    the CPU's, CFR's PAPR within 1e-3 dB."""
    gpu, cpu, launched = _run_both(card, _dpd_chain(tmp_path))
    assert launched == {"ofdm_ifft": 0, "ofdm_cfr": WARMUP_AND_CAPTURE,
                        "resample_poly": WARMUP_AND_CAPTURE}
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
    assert launched == {"ofdm_ifft": WARMUP_AND_CAPTURE, "ofdm_cfr": 0,
                        "resample_poly": WARMUP_AND_CAPTURE if k3 else 0}
    for (g, _), (c, _) in zip(gpu, cpu):
        _close(g, c, 3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kw", [
    (1, dict(output="file", file_output_format="u8")),
    (1, dict(output="zmq", zmq_output_format="s8", digital_gain=3.0)),
    (1, dict(cic_eq_clock_rate=32_768_000)),
    (1, dict(tii_enable=True, tii_comb=5, tii_pattern=31)),
    (2, dict(tii_enable=True, tii_comb=5, tii_pattern=31,
             tii_old_variant=True)),
    (2, dict(ofdm_window_overlap=90)), (3, dict(ofdm_window_overlap=63)),
    (4, dict(ofdm_window_overlap=90))],
    ids=["kw0", "kw1", "kw2", "kw3", "tii_old_tm2", "window90_tm2",
         "window63_tm3", "window90_tm4"])
def test_modulator_variants_on_card(card, mode, kw):
    s = ModSettings(dab_mode=mode, device_interleave=False,
                    **kw).normalise_for_output()
    gpu, cpu, _ = _run_both(card, s, mode=mode)
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
@pytest.mark.parametrize("mode,ov,golden", [
    (1, 0, None), (1, 10, None), (1, 90, None), (2, 90, None),
    (3, 63, None), (4, 0, None), (1, 0, "e2e_iq_fixed"),
    (1, 90, "e2e_iq_fixed_ov90")],
    ids=["1-0", "1-10", "1-90", "2-90", "3-63", "4-0", "e2e_iq_fixed",
         "e2e_iq_fixed_ov90"])
def test_kiss_on_card_equals_cpu(card, mode, ov, golden):
    """fft_engine=kiss on the card, bit for bit the CPU's (two batches,
    the state carried), at every TM's transform size; on the goldens'
    payloads (one batch of 2 TFs, bench.py's ensemble) the card's and
    the CPU's words equal the reference's sc16 samples too."""
    p = tables.mode_params(mode)
    s = ModSettings(dab_mode=mode, fft_engine="kiss", ofdm_window_overlap=ov)
    if golden:
        layout = make_default_layout(mode, BENCH_SPECS)
        batches = [(load_golden("e2e_fixed_fic_in").reshape(8, 96),
                    tuple(load_golden(f"e2e_fixed_sub{i}_in").reshape(8, -1)
                          for i in (0, 1)))]
    else:
        layout = make_default_layout(mode)
        n = 2 * p.cif_count
        raw = synth_eti_batch(2 * n, mode=mode, seed=mode)
        batches = [(b.fic, b.subchannels) for b in (
            parse_eti_frames(raw[:n]), parse_eti_frames(raw[n:]))]
    outs = {}
    for dev in (card, "cpu"):
        m = Modulator(layout, s, device=dev)
        st, res = m.init_state(), []
        for fic, subs in batches:
            out, st, stats = m.modulate(fic, tuple(subs), st)
            res.append(out.cpu())
            assert int(stats["num_clipped"]) == 0
        outs[str(dev)] = res
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert g.dtype == torch.int32 and torch.equal(g, c)
    if golden:
        np.testing.assert_array_equal(
            outs["cuda"][0].numpy().view(np.int16).reshape(-1),
            load_golden(golden))


def _kiss_table(mode, device):
    p = tables.mode_params(mode)
    return p, kiss_kernel.make_table(_mode_table(mode, device), p.null_size,
                                     p.sym_size)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("mode,tfs", [(1, 1), (1, 24), (2, 3), (3, 5),
                                      (4, 2)])
def test_kiss_kernel_equals_plain_on_card(card, mode, tfs, wire):
    """K4 against its plain version on the CPU, bit for bit, on carrier
    planes past full scale (the butterflies' int16 stores wrap); one launch
    counted."""
    p, table = _kiss_table(mode, card)
    x = tuple(1.5 * v for v in _planes(
        card, 100 * mode + tfs, (tfs, p.nb_symbols + 1, p.nb_carriers)))
    before = kiss_kernel.kiss_ifft.launches
    got = kiss_kernel.kiss_ifft(x, table, wire=wire)
    torch.cuda.synchronize()
    assert kiss_kernel.kiss_ifft.launches == before + 1
    want = kiss_kernel.kiss_ifft_plain(tuple(v.cpu() for v in x),
                                       _kiss_table(mode, "cpu")[1], wire)
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_kiss_kernel_launch_shape_on_card(card):
    """Each K4 instance reports the threads and symbols a block that
    kiss_kernel assumes, and fits on an SM."""
    for n in (256, 512, 1024, 2048):
        shape = kiss_kernel.launch_shape(n)
        assert shape["threads_per_block"] == kiss_kernel.THREADS_PER_BLOCK
        assert shape["symbols_per_block"] == kiss_kernel.symbols_per_block(n)
        assert shape["resident_blocks_per_sm"] >= 1


FRONTEND_CASES = {
    "tm1": (1, {}), "tm1_tii_cic": (1, dict(
        tii_enable=True, tii_comb=5, tii_pattern=31,
        cic_eq_clock_rate=32_768_000)),
    "tm2_tii": (2, dict(tii_enable=True, tii_comb=3, tii_pattern=12)),
    "tm3": (3, {}), "tm4": (4, {})}


@pytest.mark.cuda
@pytest.mark.parametrize("tfs", [1, 24])
@pytest.mark.parametrize("case", list(FRONTEND_CASES))
def test_frontend_kernel_equals_plain_on_card(card, case, tfs):
    """K5 against its plain version on the CPU, bit for bit (planes and
    new history), on the 17 sub-channels of REALISTIC_MUX_SPECS over three
    chained batches, the history and TF index carried; one launch a batch
    counted."""
    from dabmod_tpu_torch.eti import REALISTIC_MUX_SPECS
    from dabmod_tpu_torch.ops import frontend_kernel
    mode, kw = FRONTEND_CASES[case]
    mods = {dev: Modulator(make_default_layout(mode, REALISTIC_MUX_SPECS),
                           ModSettings(dab_mode=mode, **kw), device=dev)
            for dev in (card, "cpu")}
    frames = tfs * tables.mode_params(mode).cif_count
    raw = synth_eti_batch(3 * frames, mode=mode,
                          subch_specs=REALISTIC_MUX_SPECS, seed=50 + mode)
    hist = {dev: m.init_state()["ti_history"] for dev, m in mods.items()}
    tf_index = 3
    for i in range(3):
        b = parse_eti_frames(raw[frames * i:frames * (i + 1)])
        out = {}
        for dev, m in mods.items():
            before = frontend_kernel.frontend.launches
            out[dev] = frontend_kernel.frontend(
                *m._batch(b.fic, b.subchannels), hist[dev],
                torch.tensor(tf_index, dtype=torch.int32, device=dev),
                m._frontend)
            torch.cuda.synchronize()
            assert frontend_kernel.frontend.launches - before == (
                1 if dev == card else 0)
            hist[dev] = out[dev][1]
        g, w = _leaves(out[card]), _leaves(out["cpu"])
        assert len(g) == len(w) == 2 + len(REALISTIC_MUX_SPECS)
        for a, c in zip(g, w):
            assert a.device.type == "cuda" and a.dtype == c.dtype
            assert a.shape == c.shape and a.is_contiguous()
            assert a.cpu().numpy().tobytes() == c.numpy().tobytes()
        tf_index += tfs


@pytest.mark.cuda
@pytest.mark.parametrize("name,specs,n_frames", [
    ("e2e", BENCH_SPECS, 8), ("e2e_real", REALISTIC_MUX_SPECS, 16)])
def test_frontend_kernel_matches_goldens_on_card(card, name, specs,
                                                  n_frames):
    """K5 on the reference's payloads (2 TFs of two sub-channels, 4 of the
    17): its data symbols, in carrier order, are the reference's
    e2e_symbols / e2e_real_symbols within 4e-6 (the reference rounds
    float32 through its product chain, K5's phases are exact), the
    phases equal; its NULL rows silent; one launch."""
    from dabmod_tpu_torch.ops import frontend_kernel
    from dabmod_tpu_torch.ops.cplx import planes_to_complex
    m = Modulator(make_default_layout(1, specs), ModSettings(dab_mode=1),
                  device=card)
    fic = load_golden(f"{name}_fic_in").reshape(n_frames, 96)
    if name == "e2e":
        subs = tuple(load_golden(f"e2e_sub{i}_in").reshape(n_frames, -1)
                     for i in (0, 1))
    else:
        frames = load_golden("e2e_real_sub_in").reshape(n_frames, -1)
        offs = np.cumsum([0] + [stl * 8 for _, stl, _ in specs])
        subs = tuple(frames[:, offs[i]:offs[i + 1]]
                     for i in range(len(specs)))
    before = frontend_kernel.frontend.launches
    (re_, im_), _ = frontend_kernel.frontend(
        torch.as_tensor(fic, device=card),
        tuple(torch.as_tensor(x, device=card) for x in subs),
        m.init_state()["ti_history"],
        torch.zeros((), dtype=torch.int32, device=card), m._frontend)
    torch.cuda.synchronize()
    assert frontend_kernel.frontend.launches == before + 1
    assert not re_[:, 0].any() and not im_[:, 0].any()
    got = planes_to_complex(tuple(
        ofdm.freq_interleave(x[:, 1:], m._inv_perm_t).cpu()
        for x in (re_, im_)))
    expect = load_golden(f"{name}_symbols").reshape(n_frames // 4, 76, 1536)
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, atol=4e-6)
    np.testing.assert_array_equal(np.angle(got).round(3),
                                  np.angle(expect).round(3))


@pytest.mark.cuda
def test_frontend_kernel_launch_shape_on_card(card):
    """K5 reports the threads and carriers a block that frontend_kernel
    assumes, and fits on an SM."""
    from dabmod_tpu_torch.ops import frontend_kernel
    shape = frontend_kernel.launch_shape()
    assert shape["threads_per_block"] == frontend_kernel.THREADS_PER_BLOCK
    assert shape["carriers_per_block"] == frontend_kernel.CARRIERS_PER_BLOCK
    assert shape["resident_blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["main_s16", "dpd_poly", "kiss", "dexter"])
def test_frontend_kernel_once_a_captured_step_on_card(card, tmp_path, path):
    """The captured step of the s16, DPD, kiss and dexter chains holds one
    K5 launch, counted at its warm-up and its capture; a trace of three
    replays finds it once in each."""
    from dabmod_tpu_torch.ops import frontend_kernel
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  _graph_paths(tmp_path)[path], device=card)
    batches = _card_batches(card, 4)
    before = frontend_kernel.frontend.launches
    st = [m.modulate(*batches[0], m.init_state())[1]]

    def run():
        for batch in batches[1:]:
            _, st[0], _ = m.modulate(*batch, st[0])
    _, traced = bench_gpu.traced_launches(torch, run)
    (cap,) = m.compiled.graphs.values()
    assert cap.launches["frontend"] == 1
    assert frontend_kernel.frontend.launches - before == 2
    assert traced["frontend"] == 3


@pytest.mark.cuda
def test_frontend_op_chain_where_k5_does_not_apply_on_card(card, tmp_path):
    """modulate_traced and another time-interleaver coupling (a sharded
    one) run the op chain on the card, no K5 launch, and give K5's
    symbols to the bit."""
    from dabmod_tpu_torch.ops import fec, frontend_kernel
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  ModSettings(dab_mode=1, output="file",
                              file_output_format="s16"
                              ).normalise_for_output(), device=card)
    (batch,) = _card_batches(card, 1)
    before = frontend_kernel.frontend.launches
    m.modulate_traced(*batch, m.init_state(), str(tmp_path))
    hist = m.init_state()["ti_history"]
    tf0 = torch.zeros((), dtype=torch.int32, device=card)

    def coupling(bits, histories):
        return fec.time_interleave_all(bits, histories)
    with torch.no_grad():
        chain = m._ofdm_symbols_impl(*batch, hist, tf0, coupling)
        assert frontend_kernel.frontend.launches == before
        k5 = m._ofdm_symbols_impl(*batch, hist, tf0)
    assert frontend_kernel.frontend.launches == before + 1
    _assert_same_bits(k5, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("tii", [None, (5, 31)], ids=["no_tii", "tii"])
@pytest.mark.parametrize("ov", [0, 10, 90])
def test_kiss_captured_step_matches_reference_on_card(card, ov, tii):
    """K4 in the captured step, TM I, the 17-sub-channel ensemble of
    benchmark/configs/r17_kiss_s16.json, batches of 3, 1 and 1 TFs (two
    graphs), the state carried: bit for bit benchmark/reference/kiss.py
    (upstream's fixed-point chain in int64, rendered on the card); K4
    counted at each graph's warm-up and capture, one launch a graph."""
    import json
    import sys
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import streams
    from reference import kiss
    with open(os.path.join(bench, "configs", "r17_kiss_s16.json")) as f:
        ensemble = [tuple(e) for e in json.load(f)["ensemble"]]
    frames = streams.make_frames(2**31 + 17 + ov, 4 * 5, ensemble)
    kw = dict(tii_enable=True, tii_comb=tii[0], tii_pattern=tii[1]) \
        if tii else {}
    layout = parse_eti_frames(frames[:4]).layout
    m = Modulator(layout, ModSettings(dab_mode=1, fft_engine="kiss",
                                      ofdm_window_overlap=ov, **kw),
                  device=card)
    before = kiss_kernel.kiss_ifft.launches
    st, outs = m.init_state(), []
    for lo, hi in ((0, 3), (3, 4), (4, 5)):
        out, st, _ = m.modulate_eti(parse_eti_frames(frames[4 * lo:4 * hi]),
                                    st)
        outs.append(out.cpu())
    settings = {"mode": 1, "window": ov, "wire": "s16"}
    if tii:
        settings["tii"] = list(tii)
    want = kiss.Chain(settings, card, "f64").render(frames, 0, keep=5)
    got = torch.cat(outs).numpy().view(np.int16).reshape(want.shape)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    caps = m.compiled.graphs
    assert sorted(caps) == [1, 3]
    assert [caps[b].launches["kiss_ifft"] for b in (1, 3)] == [1, 1]
    assert [caps[b].replays for b in (1, 3)] == [2, 1]
    assert kiss_kernel.kiss_ifft.launches - before == 4


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


@pytest.mark.cuda
def test_runtime_swaps_dpd_files_over_rc_on_card(card, tmp_path):
    """What the DPD engine and the GUI do to a runtime on the card (they set
    `poly coeffile` over the RC): a poly file of the same shape hot-swaps
    into the modulator whose graph replays, a LUT file rebuilds the
    modulator once, a second LUT file hot-swaps into the new one's graph;
    each swap's coefficients reach the modulator the next batch runs."""
    from dabmod_tpu_torch.rc import rcs
    from dabmod_tpu_torch.runtime import ModRuntime
    inp = tmp_path / "in.eti"
    inp.write_bytes(synth_eti_batch(32, mode=1, subch_specs=BENCH_SPECS,
                                    seed=13).tobytes())
    rt = ModRuntime(ModSettings(
        input_name=str(inp), output="file", output_name=str(tmp_path / "o"),
        file_output_format="complexf", batch_tf=2,
        poly_coef_file=_poly_file(tmp_path)).normalise_for_output(),
        device=card)
    lut1 = _lut_file(tmp_path)
    lut2 = tmp_path / "lut2.coef"     # its first entry 0.95 in place of 1.0
    lut2.write_text((tmp_path / "lut.coef").read_text().replace(
        "1.0\n", "0.95\n", 1))
    try:
        rt.run_batches(max_batches=1)
        poly_mod = rt.modulator
        rcs.set_param("poly", "coeffile", _poly_file(
            tmp_path, (0.9, 0.01, 0.0, 0.0, 0.0), (0.05, 0.0, 0.0, 0.0, 0.0),
            "p2.coef"))
        rt.run_batches(max_batches=1)
        assert rt.modulator is poly_mod
        np.testing.assert_array_equal(poly_mod._poly_am,
                                      np.float32((0.9, 0.01, 0, 0, 0)))
        rcs.set_param("poly", "coeffile", lut1)
        rt.run_batches(max_batches=1)
        lut_mod = rt.modulator
        assert lut_mod is not poly_mod and lut_mod._lut is not None
        rcs.set_param("poly", "coeffile", str(lut2))
        rt.run_batches(max_batches=1)
        assert rt.modulator is lut_mod
        assert float(lut_mod._lut[0, 0]) == np.float32(0.95)
        for m in (poly_mod, lut_mod):
            (cap,) = m.compiled.graphs.values()
            assert cap.replays == 2
    finally:
        rt.close()
    assert rt.framecount == 32


@pytest.mark.cuda
def test_cli_on_card_writes_the_runtimes_bytes(card, tmp_path):
    """`python -m dabmod_tpu_torch.cli <ini>` as a subprocess on the card
    (an ETI file of two batches of 24 TFs of the 17 sub-channels into an
    s16 file): exit 0 and the bytes ModRuntime writes in this process
    from the same INI."""
    from dabmod_tpu_torch.config import parse_ini
    from dabmod_tpu_torch.runtime import ModRuntime
    eti = tmp_path / "in.eti"
    synth_eti_batch(2 * 24 * 4, mode=1, subch_specs=REALISTIC_MUX_SPECS,
                    seed=7).tofile(str(eti))

    def ini(name):
        path = tmp_path / f"{name}.ini"
        path.write_text(f"[input]\ntransport=file\nsource={eti}\n"
                        f"[modulator]\ngainmode=var\nbatch_tf=24\n"
                        f"[fileoutput]\nfilename={tmp_path / name}.iq\n"
                        f"format=s16\n")
        return str(path)
    rt = ModRuntime(parse_ini(ini("inproc")), device=card)
    assert rt.run() == 0
    rt.close()
    proc = subprocess.run([sys.executable, "-m", "dabmod_tpu_torch.cli",
                           ini("cli")], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = (tmp_path / "cli.iq").read_bytes()
    assert len(got) == 2 * 24 * tables.mode_params(1).tf_samples * 4
    assert got == (tmp_path / "inproc.iq").read_bytes()


def _f32_file_settings(tmp_path, chain, inp, out, **kw):
    """A complexf file sink behind the plain TM I chain ("main") or the DPD
    chain at the UHD scale, as r17_dpd8m192 transmits it ("dpd_8m192"),
    2 TFs a batch."""
    extra = _dpd_chain_kw(tmp_path) if chain == "dpd_8m192" else {}
    s = ModSettings(input_name=str(inp), output="file",
                    output_name=str(out), file_output_format="complexf",
                    batch_tf=2, **extra, **kw).normalise_for_output()
    if chain == "dpd_8m192":
        s.normalise = 1.0 / tables.NORMALISE_FACTOR_SDR
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["main", "dpd_8m192"])
def test_runtime_makes_f32_pairs_on_card(card, tmp_path, chain):
    """An f32 sink on the card: the captured step ends in planes_to_pairs
    and the fetch thread interleaves no batch.  The complexf file equals,
    byte for byte, the planes the card's step returns with
    device_interleave=False for the same batches, interleaved here; and
    the CPU runtime's file (the planes contract, one host interleave a
    batch) within 3e-5*max|ref|, 1e-4*max|ref| after the poly DPD."""
    from dabmod_tpu_torch.runtime import ModRuntime
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=19)
    inp = tmp_path / "in.eti"
    inp.write_bytes(raw.tobytes())
    files, runtimes = {}, {}
    for key, dev in (("card", card), ("cpu", "cpu")):
        out = tmp_path / f"{key}.iq"
        rt = ModRuntime(_f32_file_settings(tmp_path, chain, inp, out),
                        device=dev)
        assert rt.run() == 0
        rt.close()
        files[key], runtimes[key] = out.read_bytes(), rt
    gpu, cpu = runtimes["card"], runtimes["cpu"]
    assert gpu.settings.device_interleave and not gpu.modulator.emits_planes
    assert gpu.host_interleaved_batches == 0
    assert cpu.modulator.emits_planes and cpu.host_interleaved_batches == 2

    batches = [parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])]
    m = Modulator(batches[0].layout, _f32_file_settings(
        tmp_path, chain, inp, tmp_path / "unused.iq",
        device_interleave=False), device=card)
    state, pairs = m.init_state(), []
    for b in batches:
        (re, im), state, _ = m.modulate_eti(b, state)
        pairs.append(torch.stack([re, im], -1).cpu().numpy())
    assert files["card"] == np.concatenate(pairs).tobytes()

    g = np.frombuffer(files["card"], np.float32)
    r = np.frombuffer(files["cpu"], np.float32)
    assert g.size == r.size == 4 * tables.mode_params(1).tf_samples * 2 * (
        4 if chain == "dpd_8m192" else 1)
    rel = 1e-4 if chain == "dpd_8m192" else 3e-5
    np.testing.assert_allclose(g, r, atol=rel * np.abs(r).max())


# ---------------------------------------------------------------------------
# the live inputs and the SDR sinks on the card (ROADMAP A10(b))
# ---------------------------------------------------------------------------

def _live_runtime(device, **kw):
    from dabmod_tpu_torch.runtime import ModRuntime
    s = ModSettings(batch_tf=2, **kw).normalise_for_output()
    return ModRuntime(s, device=device)


def _by_key(sent):
    """live_stream.record_transmit's frames by timestamp (EDI) or FCT (ETI
    without one)."""
    return {(ts[1], ts[2]) if ts[0] else fct: a for fct, ts, a in sent}


@pytest.mark.cuda
def test_edi_tcp_into_loopback_on_card_equals_cpu(card):
    """EDI over TCP, a stream that starts off frame phase 0 and ends on a
    partial batch (a timeout dispatches it), into the loopback SDR with
    timestamps on: the card transmits the frames the CPU transmits, under
    the same timestamps, f32 within 3e-5*max|ref|."""
    import time
    from live_stream import TcpServer, edi_stream, record_transmit
    frames = synth_eti_batch(40, mode=1, subch_specs=BENCH_SPECS, seed=41)
    srv = TcpServer(b"".join(edi_stream(frames[3:36], time.time() + 30)))
    got = {}
    try:
        for dev in ("cuda", "cpu"):
            rt = _live_runtime(dev, input_transport="edi",
                               input_name=f"tcp://127.0.0.1:{srv.port}",
                               output="loopback", tist_enabled=True)
            sent = record_transmit(rt.output.device)
            assert rt.run(4) == 0           # 3 full batches, 1 partial
            rt.close()
            got[dev] = _by_key(sent)
            assert rt.framecount == 28 and rt.output.frames == 7
    finally:
        srv.close()
    assert list(got["cuda"]) == list(got["cpu"])
    for k, r in got["cpu"].items():
        np.testing.assert_allclose(got["cuda"][k], r,
                                   atol=3e-5 * np.abs(r).max())


def _silent_dexter(monkeypatch):
    """output=dexter's wire with its driver replaced by a device that
    transmits nothing (live_stream.record_transmit records its frames)."""
    from dabmod_tpu_torch.io import sdr

    class Silent(sdr.SdrDevice):
        def __init__(self, conf=None):
            pass

        def tune(self, lo_offset, frequency):
            pass

        def transmit_frame(self, samples, ts):
            pass

    monkeypatch.setattr(sdr, "DexterDevice", Silent)


def _pinned_in_use() -> int:
    """Bytes of the pinned tensors Python still references (a storage
    once)."""
    import gc
    gc.collect()
    live = {}
    for o in gc.get_objects():
        if (isinstance(o, torch.Tensor) and o.device.type == "cpu"
                and o.is_pinned()):
            live[o.untyped_storage().data_ptr()] = \
                o.untyped_storage().nbytes()
    return sum(live.values())


@pytest.mark.cuda
def test_tcp_eti_into_s16_sdr_on_card_equals_cpu(card, monkeypatch):
    """ETI over TCP into an s16 SdrOutput (output=dexter's wire, its
    driver replaced by a recording device): the card's wire words equal
    the CPU's within 1 LSB, matched by FCT; the pinned batch buffers the
    sink's queued frames view are released after close."""
    from live_stream import TcpServer, record_transmit
    _silent_dexter(monkeypatch)
    frames = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=42)
    srv = TcpServer(frames.tobytes())
    got = {}
    try:
        before = _pinned_in_use()
        for dev in ("cuda", "cpu"):
            rt = _live_runtime(dev, input_transport="tcp",
                               input_name=f"tcp://127.0.0.1:{srv.port}",
                               output="dexter", tcp_timeout=0.5)
            sent = record_transmit(rt.output.device)
            assert rt.run(2) == 0
            rt.close()
            got[dev] = _by_key(sent)
            out = rt.output
            assert (out.frames + out.queue_overflows + out.dropped
                    + out.muted) == 4
            if dev == "cuda":
                del rt, out
                after = _pinned_in_use()
                assert after <= before + (1 << 20), (before, after)
    finally:
        srv.close()
    common = set(got["cuda"]) & set(got["cpu"])
    assert common
    for k in common:
        g, r = got["cuda"][k], got["cpu"][k]
        assert g.dtype == r.dtype == np.int32
        d = np.abs(g.view(np.int16).astype(np.int32) - r.view(np.int16))
        assert d.max() <= 1


@pytest.mark.cuda
def test_pinned_host_memory_flat_over_runs_on_card(card, monkeypatch):
    """One runtime, ETI over TCP into the s16 SdrOutput, run() two batches
    at a time eight times: the pinned host memory Python references (the
    batches' pinned blocks, which the sink's queued frames view) grows by
    no more than one batch's output block after the first run, and none
    is referenced after close."""
    from live_stream import TcpServer
    runs, per_run = 8, 2
    _silent_dexter(monkeypatch)
    frames = synth_eti_batch(runs * per_run * 8, mode=1,
                             subch_specs=BENCH_SPECS, seed=43)
    # a batch's s16 words, in the block the host allocator gives them (a
    # request rounded up to a power of two)
    block = 1 << (2 * tables.mode_params(1).tf_samples * 4 - 1).bit_length()
    srv = TcpServer(frames.tobytes())
    try:
        before = _pinned_in_use()
        rt = _live_runtime("cuda", input_transport="tcp",
                           input_name=f"tcp://127.0.0.1:{srv.port}",
                           output="dexter", tcp_timeout=0.5)
        held = []
        for k in range(runs):
            assert rt.run(per_run) == 0
            torch.cuda.synchronize()
            assert rt.framecount == (k + 1) * per_run * 8
            held.append(_pinned_in_use())
        rt.close()
        del rt
        after = _pinned_in_use()
    finally:
        srv.close()
    assert max(held[1:]) <= held[0] + block, held
    assert after <= before + (1 << 20), (before, after)


@pytest.mark.cuda
def test_sharded_step_on_card_equals_unsharded(card, tmp_path):
    """Two gloo ranks sharing the card (parallel.launch.spawn on
    tests/torch_sharding_ranks.py), two batches of 8 TFs: the DPD chain
    (TII, CFR 30/0.1, window 10, default FIR, 4.096 MS/s through K3, poly
    DPD) and s16 at 2.048 MS/s (K1), against the unsharded step on the
    card: f32 within 1e-4*max|ref|, s16 within 1 LSB with equal
    num_clipped, clip counts equal, the state equal on every rank; each
    rank launches its kernels once a batch, and K5 never: at world 2 the
    time interleaver is the sharded coupling."""
    import torch_sharding_ranks as R
    from dabmod_tpu_torch.parallel.launch import spawn
    coef = tmp_path / "poly.coef"
    coef.write_text("1\n5\n1.0\n0.1\n-0.05\n0.02\n-0.01\n"
                    "0.02\n-0.01\n0.005\n0.0\n0.0\n")
    chain = ModSettings(
        dab_mode=1, tii_enable=True, tii_comb=5, tii_pattern=31,
        enable_cfr=True, cfr_clip=30.0, cfr_error_clip=0.1,
        ofdm_window_overlap=10, filter_taps_file="default",
        output_rate=4_096_000, poly_coef_file=str(coef), output="uhd",
        device_interleave=False).normalise_for_output()
    s16 = ModSettings(dab_mode=1, output="file",
                      file_output_format="s16").normalise_for_output()
    settings = (chain, s16)
    res = spawn(R.modulate_streams, 2, backend="gloo", device="cuda",
                store_path=str(tmp_path / "store"), timeout_s=300,
                args=([(s, BENCH_SPECS, 11, None) for s in settings],))
    # launches of (K1, K2, K3, K5) over the two batches, on each rank: no
    # K5, the sharded time interleaver runs the front end's op chain
    for ci, (s, launches) in enumerate(zip(settings, ((0, 2, 2, 0),
                                                      (2, 0, 0, 0)))):
        m = R.make_modulator(s, device=card)
        state = m.init_state()
        for k, b in enumerate(R.eti_batches(1, BENCH_SPECS, 11)):
            out, state, stats = m.modulate_eti(b, state)
            ref, ref_state, stats = R.to_numpy((out, state, stats))
            parts = [r[ci]["batches"][k] for r in res]
            if s.output == "uhd":
                for j in (0, 1):
                    got = np.concatenate([p[0][j] for p in parts])
                    np.testing.assert_allclose(
                        got, ref[j], rtol=0, atol=1e-4 * np.abs(ref[j]).max())
            else:
                got = np.concatenate([p[0] for p in parts])
                d = np.abs(got.view(np.int16).astype(np.int32)
                           - ref.view(np.int16))
                assert d.max() <= 1
            for key, v in stats.items():
                g = (parts[0][2][key] if key == "num_clipped" else
                     np.concatenate([p[2][key] for p in parts]))
                if key in ("cfr_clip", "cfr_errclip", "num_clipped",
                           "mer_valid"):
                    np.testing.assert_array_equal(g, v)
            for p in parts:
                for key, v in ref_state.items():
                    for a, x in zip(*(y if isinstance(y, tuple) else (y,)
                                      for y in (p[1][key], v))):
                        np.testing.assert_array_equal(a, x)
        for r in res:
            assert r[ci]["launches"] == list(launches)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 4])
def test_captured_sharded_step_over_nccl_on_card(card, tmp_path, world):
    """NCCL ranks, one a card (parallel.launch.spawn on
    tests/torch_sharding_ranks.py's captured_streams; world 4 skips below
    four cards): ShardedModulator captures its step (a GraphStep of
    _sharded_impl holding the all_reduces) and replays it; two batches of
    8 TFs of the DPD chain (K2, K3), of s16 (K1), and of the chain with a
    hot swap and a gain change before the second.  On every rank the
    captured step equals the eager sharded step to the bit; the ranks'
    TFs together equal the unsharded step on the card (f32 within
    1e-4*max|ref|, s16 within 1 LSB with equal num_clipped, the state
    equal on every rank); EXCHANGES counts the warm-up's and the capture's
    collectives and no replay's; timing the exchanges inside the capture
    raises."""
    _cards(world)
    import torch_sharding_ranks as R
    from dabmod_tpu_torch.parallel.launch import spawn
    from torch.utils._pytree import tree_leaves
    coef = tmp_path / "poly.coef"
    coef.write_text("1\n5\n1.0\n0.1\n-0.05\n0.02\n-0.01\n"
                    "0.02\n-0.01\n0.005\n0.0\n0.0\n")
    chain = ModSettings(
        dab_mode=1, tii_enable=True, tii_comb=5, tii_pattern=31,
        enable_cfr=True, cfr_clip=30.0, cfr_error_clip=0.1,
        ofdm_window_overlap=10, filter_taps_file="default",
        output_rate=4_096_000, poly_coef_file=str(coef), output="uhd",
        device_interleave=False).normalise_for_output()
    s16 = ModSettings(dab_mode=1, output="file",
                      file_output_format="s16").normalise_for_output()
    swap = {"fir_taps": np.asarray(tables.DEFAULT_FIR_TAPS,
                                   np.float32)[::-1].copy(),
            "poly": (np.float32((0.9, 0.12, -0.04, 0.01, -0.005)),
                     np.float32((0.01, -0.02, 0.004, 0.001, 0.0))),
            "digital_gain": 0.8, "gain_mode_variance": 3.0}
    cases = [(s16, BENCH_SPECS, 11, None), (chain, BENCH_SPECS, 11, None),
             (chain, BENCH_SPECS, 11, swap)]
    ranks = spawn(R.captured_streams, world, backend="nccl", device="cuda",
                  store_path=str(tmp_path / "store"), timeout_s=300,
                  args=(cases, False))
    for res in ranks:
        raised, graphs = res[-1]
        assert raised and "graph capture" in raised and graphs == 0
    for c, (s, _, _, sw) in enumerate(cases):
        recs = [res[c] for res in ranks]
        for rec in recs:
            got = tree_leaves(rec["captured"])
            want = tree_leaves(rec["eager"])
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
            assert rec["replays"] == {R.N_TF // world: R.BATCHES}
            # a step's collectives, counted at the warm-up and the
            # capture: the resampler's carry or the num_clipped sum, and
            # from world 2 on the time interleaver's rows
            per_step = 1 if world == 1 else 2
            assert rec["collectives"] == [2 * per_step, 0]
        m = R.make_modulator(s, device=card)
        state = m.init_state()
        for k, b in enumerate(R.eti_batches(1, BENCH_SPECS, 11)):
            if k and sw:
                R.apply_swap(m, sw)
            o, state, st_ = m.modulate_eti(b, state)
            ref, ref_state, ref_stats = R.to_numpy((o, state, st_))
            parts = [rec["captured"][k] for rec in recs]
            if s.output == "uhd":
                for j in (0, 1):
                    np.testing.assert_allclose(
                        np.concatenate([p[0][j] for p in parts]), ref[j],
                        rtol=0, atol=1e-4 * np.abs(ref[j]).max())
            else:
                out = np.concatenate([p[0] for p in parts])
                d = np.abs(out.view(np.int16).astype(np.int32)
                           - ref.view(np.int16))
                assert d.max() <= 1
            for key in ("cfr_clip", "cfr_errclip", "num_clipped",
                        "mer_valid"):
                if key in ref_stats:
                    got = (parts[0][2][key] if key == "num_clipped" else
                           np.concatenate([p[2][key] for p in parts]))
                    np.testing.assert_array_equal(got, ref_stats[key])
            for _, st, _ in parts:
                for key, v in ref_state.items():
                    for a, x in zip(*(y if isinstance(y, tuple) else (y,)
                                      for y in (st[key], v))):
                        np.testing.assert_array_equal(a, x)


# ---------------------------------------------------------------------------
# the compiled step: Modulator.modulate replays a CUDA graph a batch size
# ---------------------------------------------------------------------------

def _lut_file(directory):
    lut = (np.linspace(1.0, 0.9, 32) + 1j * np.linspace(0, 0.05, 32)
           ).astype(np.complex64)
    path = os.path.join(str(directory), "lut.coef")
    with open(path, "w") as f:
        f.write(f"2\n{2.0 ** 31!r}\n" + "".join(
            f"{float(v.real)!r}\n{float(v.imag)!r}\n" for v in lut))
    return path


def _graph_paths(tmp_path):
    """The paths whose captured step is held against the eager step."""
    planes = dict(device_interleave=False)
    return {
        "main": ModSettings(dab_mode=1, **planes),
        "main_s16": ModSettings(dab_mode=1, output="file",
                                file_output_format="s16"
                                ).normalise_for_output(),
        "cfr_8m192": ModSettings(dab_mode=1, **planes,
                                 **MOD_PATHS["cfr_8m192"]),
        "cfr30_3m072": ModSettings(dab_mode=1, **planes,
                                   **MOD_PATHS["cfr30_3m072"]),
        "dpd_poly": _dpd_chain(tmp_path),
        "dpd_lut": ModSettings(dab_mode=1, output="uhd", **planes,
                               poly_coef_file=_lut_file(tmp_path)
                               ).normalise_for_output(),
        "kiss_fused": ModSettings(dab_mode=1, fft_engine="kiss"),
        "kiss": ModSettings(dab_mode=1, fft_engine="kiss",
                            ofdm_window_overlap=90),
        "dexter": ModSettings(dab_mode=1, fft_engine="dexter",
                              ofdm_window_overlap=12),
    }


def _card_batches(card, n, tfs=2, seed=9):
    raw = synth_eti_batch(4 * tfs * n, mode=1, subch_specs=BENCH_SPECS,
                          seed=seed)
    out = []
    for i in range(n):
        b = parse_eti_frames(raw[4 * tfs * i:4 * tfs * (i + 1)])
        out.append((torch.as_tensor(b.fic, device=card),
                    tuple(torch.as_tensor(x, device=card)
                          for x in b.subchannels)))
    return out


def _eager_step(m, batch, state):
    with torch.no_grad():
        return m._modulate_impl(*batch, state, *m._gain_args(),
                                m._apply_swaps())


def _leaves(tree):
    from torch.utils._pytree import tree_leaves
    return tree_leaves(tree)


def _assert_same_bits(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["main", "main_s16", "cfr_8m192",
                                  "cfr30_3m072", "dpd_poly", "dpd_lut",
                                  "kiss_fused", "kiss", "dexter"])
def test_captured_step_equals_eager_on_card(card, tmp_path, path):
    """Three batches, the state carried: the replayed graph's output, stats
    and state equal to the bit the eager step's on the same card."""
    s = _graph_paths(tmp_path)[path]
    m = Modulator(make_default_layout(1, BENCH_SPECS), s, device=card)
    ref = Modulator(make_default_layout(1, BENCH_SPECS), s, device=card)
    st, st_ref = m.init_state(), ref.init_state()
    for batch in _card_batches(card, 3):
        got = m.modulate(*batch, st)
        want = _eager_step(ref, batch, st_ref)
        _assert_same_bits(got, want)
        st, st_ref = got[1], want[1]
    (cap,) = m.compiled.graphs.values()
    assert cap.replays == 3


@pytest.mark.cuda
def test_swaps_and_gains_between_replays_on_card(card, tmp_path):
    """FIR taps, poly coefficients, `gain digital` and `gain var` changed
    between two replays: the second equals a modulator built with the new
    values on the same state, with no second capture."""
    import dataclasses
    s = _dpd_chain(tmp_path)
    m = Modulator(make_default_layout(1, BENCH_SPECS), s, device=card)
    b1, b2 = _card_batches(card, 2)
    _, st, _ = m.modulate(*b1, m.init_state())
    taps2 = np.asarray(tables.DEFAULT_FIR_TAPS[::-1], np.float32)
    am2, pm2 = (0.9, 0.01, 0.0, 0.0, 0.0), (0.05, 0.0, 0.0, 0.0, 0.0)
    assert m.update_fir_taps(taps2) and m.update_dpd("poly", (am2, pm2))
    s.digital_gain, s.gain_mode_variance = 0.8, 3.0
    kept = tuple(x.clone() for x in _leaves(st))
    got = m.modulate(*b2, st)
    taps_file = tmp_path / "taps2.txt"
    taps_file.write_text(f"{taps2.size}\n" + "".join(
        f"{float(t)!r}\n" for t in taps2))
    fresh = Modulator(m.layout, dataclasses.replace(
        s, filter_taps_file=str(taps_file),
        poly_coef_file=_poly_file(tmp_path, am2, pm2, "p2.coef")),
        device=card)
    from torch.utils._pytree import tree_flatten, tree_unflatten
    st_f = tree_unflatten(list(kept), tree_flatten(st)[1])
    want = fresh.modulate(*b2, st_f)
    _assert_same_bits(got, want)
    (cap,) = m.compiled.graphs.values()
    assert cap.replays == 2


@pytest.mark.cuda
def test_second_batch_size_captures_a_second_graph_on_card(card):
    s = ModSettings(dab_mode=1, device_interleave=False,
                    **MOD_PATHS["cfr_8m192"])
    m = Modulator(make_default_layout(1, BENCH_SPECS), s, device=card)
    ref = Modulator(make_default_layout(1, BENCH_SPECS), s, device=card)
    st, st_ref = m.init_state(), ref.init_state()
    two, one = _card_batches(card, 2, 2, 10), _card_batches(card, 2, 1, 11)
    r0, reserved = _reserved_bytes(), []
    for batch in (two[0], one[0], two[1], one[1]):
        got = m.modulate(*batch, st)
        want = _eager_step(ref, batch, st_ref)
        _assert_same_bits(got, want)
        st, st_ref = got[1], want[1]
        reserved.append(_reserved_bytes())
    assert sorted(m.compiled.graphs) == [1, 2]
    assert [m.compiled.graphs[b].replays for b in (1, 2)] == [2, 2]
    # one pool: the smaller graph, captured second, takes little beyond
    # what the first graph's pool holds
    first, second = reserved[0] - r0, reserved[1] - reserved[0]
    assert first > 0 and second < first


@pytest.mark.cuda
def test_returned_output_unchanged_after_next_call_on_card(card):
    m = Modulator(make_default_layout(1, BENCH_SPECS), ModSettings(
        dab_mode=1, device_interleave=False, **MOD_PATHS["cfr_8m192"]),
        device=card)
    b1, b2 = _card_batches(card, 2)
    first = m.modulate(*b1, m.init_state())
    kept = [x.clone() for x in _leaves(first)]
    m.modulate(*b2, first[1])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_leaves(first), kept))


def _reserved_bytes() -> int:
    """The caching allocator's device memory, its unused blocks released:
    what the live tensors and the graphs' pools hold."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


@pytest.mark.cuda
def test_launch_counts_equal_replays_on_card(card):
    """Four steps: the wrappers count the warm-up's launches and the
    capture's, and nothing at a replay; the card runs the warm-up's
    launches and the graph's at each replay (a torch.profiler trace of the
    run)."""
    m = Modulator(make_default_layout(1, BENCH_SPECS), ModSettings(
        dab_mode=1, device_interleave=False, **MOD_PATHS["cfr_8m192"]),
        device=card)
    batches = _card_batches(card, 4)
    kernels = (ofdm_kernel.ofdm_backend, ofdm_kernel.ofdm_cfr_backend,
               resampler_kernel.resample)
    for k in kernels:
        k.launches = 0
    st = [m.init_state()]

    def run():
        for batch in batches:
            _, st[0], _ = m.modulate(*batch, st[0])
    _, traced = bench_gpu.traced_launches(torch, run)
    (cap,) = m.compiled.graphs.values()
    assert cap.launches == {"ofdm_backend": 0, "ofdm_cfr_backend": 1,
                            "resample": 1, "kiss_ifft": 0, "frontend": 1}
    assert [k.launches for k in kernels] == [0, 2, 2]
    assert cap.replays == 4
    assert traced == {k: (1 + cap.replays) * n
                      for k, n in cap.launches.items()}


@pytest.mark.cuda
def test_bench_gpu_default_run_on_card(card):
    """bench_gpu.py's default run, briefly: its first batch equals the
    port on the CPU, the captured and the eager step are timed, and the
    line carries bench.py's keys and the card."""
    rec = bench_gpu.bench_default(torch, 4, steps=3, runs=5)
    assert rec["metric"] == bench_gpu.METRIC and rec["unit"] == "samples/s"
    assert rec["value"] > 0 and rec["eager_value"] > 0
    assert rec["check"]["max_abs_err"] <= rec["check"]["tol"]
    assert rec["step_ms"]["n"] == 5 and rec["step_ms"]["steps_per_run"] == 3
    assert rec["device"]["name"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_bench_gpu_stages_on_card(card):
    """bench_gpu.py --stages, briefly, on the "CFR" row (K2) and the
    "resamp 8.192M" row (K3): every stage the step opens
    has device time and launches, K2 under ofdm_ifft, K3 under resampler,
    "(other)" within 5 %, the stages' sum within 2 % of device busy."""
    for name in ("CFR", "resamp 8.192M"):
        rec = bench_gpu.profile_stages(torch, name, 2, steps=3)
        assert bench_gpu.stage_problems(rec) == [], name
        kernel = "ofdm_cfr_backend" if name == "CFR" else "resample"
        stage = bench_gpu.KERNEL_STAGE[kernel]
        assert rec["stages"][stage]["kernels"].get(kernel, 0) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [1, 4])
def test_bench_gpu_scaling_on_card(card, cards):
    """bench_gpu.py --scaling, briefly: world 1 in the process and one
    --scaling-worker process through init_distributed over NCCL; on four
    cards (skips below) also worlds 2 and 4 spawned and 2 x 2
    --scaling-worker processes; each the captured sharded step equal to
    the unsharded step on the card."""
    _cards(cards)
    kw = dict(config="base", batch_per_rank=2, steps=3, runs=2, traced=2)
    if cards == 1:
        rows = (bench_gpu.run_scaling(torch, (1,), **kw)["rows"]
                + bench_gpu.run_hosts(torch, (1,), 1, **kw)["rows"])
        launchers = ["in process", "init_distributed"]
    else:
        rows = (bench_gpu.run_scaling(torch, (1, 2, 4), **kw)["rows"]
                + bench_gpu.run_hosts(torch, (2,), 2, **kw)["rows"])
        launchers = ["in process", "spawn", "spawn", "init_distributed"]
    assert [r["launcher"] for r in rows] == launchers
    for r in rows:
        assert r["captured"] and r["own_cards"] and r["elementwise_ok"]
        assert r["ranks"][0]["launches"]["ofdm_backend"] == 2
    # each record's efficiency against its row of fewest ranks
    assert rows[0]["efficiency"] == rows[-1]["efficiency"] == 1.0
    assert all(r["efficiency"] > 0 for r in rows)


@pytest.mark.cuda
def test_bench_gpu_collectives_on_card(card):
    """bench_gpu.py --collectives on 2 gloo ranks sharing the card: the
    TI coupling's one all_reduce a step, the severed step eager and
    captured, and the rows labelled as no scaling."""
    rec = bench_gpu.run_collectives(torch, world=2, backend="gloo",
                                    steps=2, runs=2, traced=2)
    (r,) = rec["configs"]
    assert set(r["couplings"]) == {"time_interleave"}
    assert r["couplings"]["time_interleave"]["tail_shape"] == [15, 9216]
    assert r["severed_captured_ms"] > 0 and r["eager_step_ms"] > 0
    assert r["shared_device"] and r["note"] == bench_gpu.SHARED_NOTE


# last in the file: a failed capture leaves its side stream unusable
@pytest.mark.cuda
def test_failed_capture_raises_on_card(card, monkeypatch):
    """A host synchronisation in the step fails the capture: modulate
    raises, keeps no graph and carries on neither eagerly nor on the
    CPU."""
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  ModSettings(dab_mode=1, device_interleave=False),
                  device=card)
    impl = m._ofdm_symbols_impl

    def syncing(*a, **k):
        out = impl(*a, **k)
        float(out[0][0].sum())              # a device-to-host copy
        return out
    monkeypatch.setattr(m, "_ofdm_symbols_impl", syncing)
    (batch,) = _card_batches(card, 1)
    with pytest.raises(RuntimeError):
        m.modulate(*batch, m.init_state())
    assert not m.compiled.graphs
    torch.cuda.synchronize()
