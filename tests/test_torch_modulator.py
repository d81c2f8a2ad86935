"""The port's modulator (dabmod_tpu_torch.models.Modulator, on the CPU)
against the reference goldens and against dabmod_tpu.models.Modulator.

Tolerances: the front end is exact (phase-domain integers; atol 4e-6 and
equal phases against the goldens, as tests/test_pipeline.py); f32 output
within 3e-5*max|ref| (tests/test_ofdm_kernel.py:88-89: fp32 transforms and
gain reductions summed in different orders); s16 words within 1 LSB (a
float difference at a truncation edge) with equal clip counts.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.models import Modulator as JModulator
from dabmod_tpu.models import make_default_layout as j_layout
from dabmod_tpu.ops import fft as jfft
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import (REALISTIC_MUX_SPECS, parse_eti_frames,
                                  synth_eti_batch)
from dabmod_tpu_torch.models import (Modulator, make_default_layout,
                                     state_from_numpy)
from dabmod_tpu_torch.ops import cplx
from golden import load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # bench.py's ensemble
FORMATS = {
    "planes": dict(device_interleave=False),
    "pairs": dict(device_interleave=True),
    "s16": dict(output="file", file_output_format="s16"),
}


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    """JAX modulators built here set dabmod_tpu's module-level FFT
    precision; put its import-time default back for later tests."""
    yield
    jfft.set_precision("high")


def _settings(cls, fmt, **kw):
    return cls(dab_mode=kw.pop("dab_mode", 1), **FORMATS[fmt],
               **kw).normalise_for_output()


def _port(specs=BENCH_SPECS, fmt="planes", mode=1, **kw):
    return Modulator(make_default_layout(mode, specs),
                     _settings(ModSettings, fmt, dab_mode=mode, **kw),
                     device="cpu")


def _jax(specs=BENCH_SPECS, fmt="planes", mode=1, **kw):
    return JModulator(j_layout(mode, specs),
                      _settings(JSettings, fmt, dab_mode=mode, **kw))


def _np(out):
    if isinstance(out, tuple):
        return tuple(np.asarray(x) for x in out)
    return np.asarray(out)


def _assert_same_output(got, ref, fmt, got_stats=None, ref_stats=None):
    if fmt == "s16":
        assert got.dtype == np.int32 and got.shape == ref.shape
        d = np.abs(got.view(np.int16).astype(np.int32)
                   - ref.view(np.int16).astype(np.int32)).max()
        assert d <= 1, d
        assert int(got_stats["num_clipped"]) == int(ref_stats["num_clipped"])
        return
    if fmt == "planes":
        got, ref = np.stack(got, -1), np.stack(ref, -1)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=3e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# front end against the goldens
# ---------------------------------------------------------------------------

def _golden_subs(name, n_frames, specs):
    if name == "e2e":
        return (load("e2e_sub0_in").reshape(n_frames, -1),
                load("e2e_sub1_in").reshape(n_frames, -1))
    frames = load("e2e_real_sub_in").reshape(n_frames, -1)
    offs = np.cumsum([0] + [stl * 8 for _, stl, _ in specs])
    return tuple(frames[:, offs[i]:offs[i + 1]] for i in range(len(specs)))


@pytest.mark.parametrize("name,specs,n_frames,n_tf", [
    ("e2e", BENCH_SPECS, 8, 2),
    ("e2e_real", REALISTIC_MUX_SPECS, 16, 4)])
def test_frontend_matches_reference_goldens(name, specs, n_frames, n_tf):
    m = _port(specs)
    fic = load(f"{name}_fic_in").reshape(n_frames, 96)
    expect = load(f"{name}_symbols").reshape(n_tf, 76, 1536)
    syms, hist = m.frontend(fic, _golden_subs(name, n_frames, specs),
                            m.init_state()["ti_history"])
    got = cplx.planes_to_complex(syms)
    assert got.shape == expect.shape and len(hist) == len(specs)
    np.testing.assert_allclose(got, expect, atol=4e-6)
    np.testing.assert_array_equal(np.angle(got).round(3),
                                  np.angle(expect).round(3))


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_frontend_matches_reference_other_modes(mode):
    m = _port(((0, 24, 0x22),), mode=mode)
    p = tables.mode_params(mode)
    n = 2 * p.cif_count
    syms, _ = m.frontend(load(f"e2e_m{mode}_fic_in").reshape(n, p.fic_size_in),
                         (load(f"e2e_m{mode}_sub_in").reshape(n, -1),),
                         m.init_state()["ti_history"])
    expect = load(f"e2e_m{mode}_symbols").reshape(2, p.nb_symbols,
                                                  p.nb_carriers)
    np.testing.assert_allclose(cplx.planes_to_complex(syms), expect,
                               atol=4e-6)


# ---------------------------------------------------------------------------
# the whole modulate against dabmod_tpu
# ---------------------------------------------------------------------------

def test_tables_match_reference_modulator():
    m = _port(REALISTIC_MUX_SPECS)
    mj = _jax(REALISTIC_MUX_SPECS)
    for name in ("_inv_perm", "_ref_q_pre", "_bin_src_pre", "_bin_valid"):
        np.testing.assert_array_equal(getattr(m, name),
                                      np.asarray(getattr(mj, name)))
    assert m._subch_ti_bits == [int(x.shape[1]) for x in mj._subch_masks]
    assert m._subch_offsets == mj._subch_offsets


@pytest.mark.parametrize("backend,fmt", [
    ("xla", "planes"), ("xla", "pairs"), ("xla", "s16"),
    ("pallas-interpret", "planes")])
def test_modulate_matches_reference(backend, fmt):
    """bench.py's layout at batch_tf=2 (8 ETI frames), every output format
    of the main path.  The wire format does not depend on which OFDM
    backend ran, so the Pallas kernel (interpreted) is held against the
    planes only."""
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=5))
    mj = _jax(fmt=fmt, ofdm_backend=backend, fft_precision="highest")
    ref, ref_state, ref_stats = mj.modulate(b.fic, tuple(b.subchannels),
                                            mj.init_state())
    m = _port(fmt=fmt, fft_precision="highest")
    got, state, stats = m.modulate_eti(b, m.init_state())
    assert set(stats) == set(ref_stats)
    _assert_same_output(_np(got), _np(ref), fmt, stats, ref_stats)
    assert int(state["tf_index"]) == int(ref_state["tf_index"]) == 2
    for h, hj in zip(state["ti_history"], ref_state["ti_history"]):
        np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


@pytest.mark.parametrize("mode", [2, 3, 4])
def test_modulate_other_modes_match_reference(mode):
    p = tables.mode_params(mode)
    specs = ((0, 24, 0x22),)
    b = parse_eti_frames(synth_eti_batch(2 * p.cif_count, mode=mode,
                                         subch_specs=specs, seed=mode))
    mj = _jax(specs, mode=mode, ofdm_backend="xla", fft_precision="highest")
    ref, _, _ = mj.modulate(b.fic, tuple(b.subchannels), mj.init_state())
    m = _port(specs, mode=mode)
    got, _, _ = m.modulate_eti(b, m.init_state())
    assert got[0].shape == (2, p.tf_samples)
    _assert_same_output(_np(got), _np(ref), "planes")


def test_state_carried_over_from_reference():
    """JAX modulates the first batch; its state, through state_from_numpy,
    lets the port modulate the second batch exactly as JAX does."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=9)
    b1, b2 = parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])
    mj = _jax(ofdm_backend="xla", fft_precision="highest")
    _, sj, _ = mj.modulate(b1.fic, tuple(b1.subchannels), mj.init_state())
    sj_np = {"ti_history": tuple(np.asarray(h) for h in sj["ti_history"]),
             "tf_index": np.asarray(sj["tf_index"])}
    ref2, sj2, _ = mj.modulate(b2.fic, tuple(b2.subchannels), sj)

    m = _port()
    state = state_from_numpy(sj_np, "cpu")
    assert state["ti_history"][0].dtype == torch.uint8
    got2, state2, _ = m.modulate_eti(b2, state)
    _assert_same_output(_np(got2), _np(ref2), "planes")
    assert int(state2["tf_index"]) == int(sj2["tf_index"]) == 4
    for h, hj in zip(state2["ti_history"], sj2["ti_history"]):
        np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


def test_one_batch_equals_two_batches():
    """4 TFs in one batch == 2 + 2 TFs with the state carried."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=2)
    m = _port()
    full, _, _ = m.modulate_eti(parse_eti_frames(raw), m.init_state())
    st = m.init_state()
    a, st, _ = m.modulate_eti(parse_eti_frames(raw[:8]), st)
    b, st, _ = m.modulate_eti(parse_eti_frames(raw[8:]), st)
    for k in range(2):
        got = torch.cat([a[k], b[k]]).numpy()
        np.testing.assert_allclose(got, full[k].numpy(),
                                   atol=3e-5 * float(full[k].abs().max()))
    assert int(st["tf_index"]) == 4


def test_output_contracts():
    b = parse_eti_frames(synth_eti_batch(4, mode=1, seed=1))
    n = tables.mode_params(1).tf_samples
    specs = ((0, 24, 0x22),)
    out, _, stats = _port(specs, "planes").modulate_eti(
        b, _port(specs).init_state())
    assert isinstance(out, tuple) and out[0].shape == (1, n) and stats == {}
    out, _, _ = _port(specs, "pairs").modulate_eti(b, _port(specs).init_state())
    assert out.shape == (1, n, 2) and out.dtype == torch.float32
    out, _, stats = _port(specs, "s16").modulate_eti(
        b, _port(specs).init_state())
    assert out.shape == (1, n) and out.dtype == torch.int32
    assert stats["num_clipped"].dtype == torch.int32
    with pytest.raises(ValueError, match="multiple"):
        _port(specs).modulate(b.fic[:3], (b.subchannels[0][:3],),
                              _port(specs).init_state())


# ---------------------------------------------------------------------------
# CFR and the polyphase resampler against dabmod_tpu
# ---------------------------------------------------------------------------

# the repo's documented CFR settings (doc/example.ini:56-59)
CFR = dict(enable_cfr=True, cfr_clip=40.0, cfr_error_clip=3.0)
# where the error clip acts (tests/test_quality.py:151-154); the error clip
# of 3.0 above never does
CFR_ERR = dict(enable_cfr=True, cfr_clip=30.0, cfr_error_clip=0.1)
PATHS = {"cfr": CFR, "8m192": dict(output_rate=8_192_000),
         "cfr_8m192": dict(CFR, output_rate=8_192_000),
         # L/M = 3/2 and 1/2: the kernel's M > 1 indexing
         "cfr30_3m072": dict(CFR_ERR, output_rate=3_072_000),
         "1m024_poly": dict(output_rate=1_024_000, resampler_mode="poly")}
# dabmod_tpu's XLA resampler frames 32 samples, too few for the 64-sample
# carry of L/M = 1/2: only its kernels (here interpreted) decimate by poly
JAX_BACKEND = {"1m024_poly": "pallas-interpret"}
# at this seed the plain transforms and dabmod_tpu's decide every sample
# near the clip threshold alike, so the clip counts are equal
CFR_SEED = 2


def _assert_same_stats(got, ref):
    assert set(got) == set(ref)
    for k in ("cfr_clip", "cfr_errclip", "mer_valid", "num_clipped"):
        if k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k, atol in (("papr_before_cfr", 1e-3), ("papr_after_cfr", 1e-3),
                    ("mer_db", 0.1)):
        if k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       atol=atol)


def _flat(out, fmt, n_tf=2):
    """dabmod_tpu's resampled output keeps its kernel's [rows, 128*L/M]
    shape on some backends; the flat stream per TF is what both packages
    define."""
    if fmt == "planes":
        return tuple(np.asarray(x).reshape(n_tf, -1) for x in out)
    return np.asarray(out)


@pytest.mark.parametrize("fmt", ["planes", "s16"])
@pytest.mark.parametrize("path", list(PATHS))
def test_cfr_and_resampler_match_reference(path, fmt):
    """bench.py's layout, 2 TFs a batch, two batches with the state
    (mer_index, res_carry) carried, against dabmod_tpu's XLA path."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=CFR_SEED)
    batches = [parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])]
    mj = _jax(fmt=fmt, ofdm_backend=JAX_BACKEND.get(path, "xla"),
              fft_precision="highest", **PATHS[path])
    m = _port(fmt=fmt, fft_precision="highest", **PATHS[path])
    sj, st = mj.init_state(), m.init_state()
    assert set(st) == set(sj)
    for b in batches:
        ref, sj, ref_stats = mj.modulate(b.fic, tuple(b.subchannels), sj)
        got, st, stats = m.modulate_eti(b, st)
        _assert_same_output(_np(got), _flat(ref, fmt), fmt, stats,
                            ref_stats)
        _assert_same_stats(stats, ref_stats)
        if PATHS[path].get("cfr_error_clip") == CFR_ERR["cfr_error_clip"]:
            # the error clip acts and MER leaves its 90 dB clamp
            assert stats["cfr_errclip"].min() > 0
            assert stats["mer_db"][stats["mer_valid"]].max() < 90.0
    assert int(st["tf_index"]) == int(sj["tf_index"]) == 4
    if "mer_index" in sj:
        assert int(st["mer_index"]) == int(sj["mer_index"]) == 4
    if "res_carry" in sj:
        for g, r in zip(st["res_carry"], sj["res_carry"]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       atol=3e-5 * float(np.abs(r).max()))


def test_cfr_resampler_state_carried_over_from_reference():
    """JAX modulates the first batch with CFR and the resampler; its state
    (mer_index, res_carry included) lets the port modulate the second."""
    raw = synth_eti_batch(16, mode=1, subch_specs=BENCH_SPECS, seed=CFR_SEED)
    b1, b2 = parse_eti_frames(raw[:8]), parse_eti_frames(raw[8:])
    kw = PATHS["cfr_8m192"]
    mj = _jax(ofdm_backend="xla", fft_precision="highest", **kw)
    _, sj, _ = mj.modulate(b1.fic, tuple(b1.subchannels), mj.init_state())
    sj_np = {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                 else np.asarray(v)) for k, v in sj.items()}
    ref2, sj2, ref_stats = mj.modulate(b2.fic, tuple(b2.subchannels), sj)

    m = _port(fft_precision="highest", **kw)
    state = state_from_numpy(sj_np, "cpu")
    assert int(state["mer_index"]) == 2
    assert state["res_carry"][0].dtype == torch.float32
    got2, state2, stats = m.modulate_eti(b2, state)
    _assert_same_output(_np(got2), _flat(ref2, "planes"), "planes")
    _assert_same_stats(stats, ref_stats)
    assert int(state2["mer_index"]) == int(sj2["mer_index"])


def test_resampled_output_contracts():
    b = parse_eti_frames(synth_eti_batch(4, mode=1, seed=1))
    specs = ((0, 24, 0x22),)
    for rate, L in ((4_096_000, 2), (8_192_000, 4)):
        m = _port(specs, "pairs", output_rate=rate, **CFR)
        n = tables.mode_params(1).tf_samples * L
        assert m.tf_samples_out == n
        state = m.init_state()
        assert state["mer_index"].dtype == torch.int32
        assert state["res_carry"][0].shape == (32,)
        out, state, stats = m.modulate_eti(b, state)
        assert out.shape == (1, n, 2) and out.dtype == torch.float32
        assert stats["cfr_clip"].dtype == torch.int32
        assert stats["mer_valid"].dtype == torch.bool
        assert stats["mer_db"].shape == (1,)
        assert int(state["mer_index"]) == 1
    assert _port(specs).tf_samples_out == tables.mode_params(1).tf_samples


# ---------------------------------------------------------------------------
# device rule, unsupported settings, isolation from JAX
# ---------------------------------------------------------------------------

def test_default_device_is_cuda():
    layout = make_default_layout(1)
    if torch.cuda.is_available():
        assert Modulator(layout).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Modulator(layout)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Modulator(layout, device="cuda")
    assert Modulator(layout, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw,item", [
    ({"fft_engine": "kiss"}, "A9"),
    ({"fft_engine": "dexter"}, "A9"),
    ({"output_rate": 1_024_000}, "A7"),
    ({"tii_enable": True}, "A8"),
    ({"output_rate": 4_096_000, "resampler_mode": "fft"}, "A7"),
    ({"output_rate": 2_500_000}, "A7"),
    ({"cic_eq_clock_rate": 32_768_000}, "A8"),
    ({"filter_taps_file": "default"}, "A8"),
    ({"poly_coef_file": "poly.coef"}, "A8"),
    ({"ofdm_window_overlap": 10}, "A7"),
    ({"output": "file", "file_output_format": "u8"}, "A7"),
    ({"output": "zmq", "zmq_output_format": "s8"}, "A7"),
])
def test_unsupported_settings_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Modulator(make_default_layout(1), ModSettings(dab_mode=1, **kw),
                  device="cpu")


def test_inactive_cic_rate_is_accepted():
    """dabmod_tpu builds no CIC taps when the ratio rule turns them off
    (400 MHz master clock, even ratio), so neither does the port."""
    m = Modulator(make_default_layout(1),
                  ModSettings(dab_mode=1, cic_eq_clock_rate=400_000_000),
                  device="cpu")
    assert m.device.type == "cpu"


def test_port_imports_no_jax():
    """Importing every module of dabmod_tpu_torch loads neither jax nor
    any module of dabmod_tpu."""
    code = (
        "import pkgutil, sys, importlib, dabmod_tpu_torch\n"
        "mods = [importlib.import_module(m.name) for m in pkgutil."
        "walk_packages(dabmod_tpu_torch.__path__, 'dabmod_tpu_torch.')]\n"
        "assert len(mods) >= 12, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'dabmod_tpu' or "
        "m.startswith('dabmod_tpu.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
