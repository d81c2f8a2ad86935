"""The compiled step (dabmod_tpu_torch/models/compiled.py) on the CPU.

* The step with its gains as 0-d float32 tensors against dabmod_tpu's
  jitted step, at two digital gains and two gain_mode_variance values
  (f32 within 3e-5*max|ref|, tests/test_ofdm_kernel.py:88-89).
* No host synchronisation inside Modulator._modulate_impl after a warm-up
  step: a TorchDispatchMode sees every aten op the step runs, on each
  path and variant tests/test_torch_cuda.py runs on the card, at a size
  that fits a small CPU run.  The
  kernels' plain versions, which the card replaces with K1-K3, are left
  out of the check.
* GraphStep's host logic, with a stand-in for torch.cuda.CUDAGraph that
  records the aten ops of the captured step and runs them again on
  replay, writing each result into the tensor the capture made, as a
  graph replays its kernels on the addresses it captured.  It refuses a
  host-syncing op as a capture does.  The stand-in and the other
  torch.cuda stand-ins live here, never in the package.  Against the eager
  step the graph step is bit for bit: the same ops on the same inputs.
"""
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils._python_dispatch import TorchDispatchMode

from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.models import Modulator as JModulator
from dabmod_tpu.models import make_default_layout as j_layout
from dabmod_tpu.ops import fft as jfft
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import GAIN_VAR, ModSettings
from dabmod_tpu_torch.eti import parse_eti_frames, synth_eti_batch
from dabmod_tpu_torch.models import Modulator, compiled, make_default_layout
from dabmod_tpu_torch.ops import ofdm_kernel
import torch_graph_stand_in as stand_ins
from torch_threads import one_intra_op_thread  # noqa: F401

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # bench.py's ensemble
POLY_AM = (1.0, 0.1, -0.05, 0.02, -0.01)          # tests/test_filters.py
POLY_PM = (0.02, -0.01, 0.005, 0.0, 0.0)
LUT_SCALE = 2.0 ** 31


@pytest.fixture(autouse=True)
def _restore_jax_precision():
    yield
    jfft.set_precision("high")


def _dpd_files(d):
    """The poly and LUT files (formats 1 and 2) of the DPD chains."""
    lut = (np.linspace(1.0, 0.9, 32) + 1j * np.linspace(0, 0.05, 32)
           ).astype(np.complex64)
    poly, lutf = d / "poly.coef", d / "lut.coef"
    poly.write_text("1\n5\n" + "".join(f"{v!r}\n"
                                        for v in (*POLY_AM, *POLY_PM)))
    lutf.write_text(f"2\n{LUT_SCALE!r}\n" + "".join(
        f"{float(v.real)!r}\n{float(v.imag)!r}\n" for v in lut))
    return str(poly), str(lutf)


CFR_8M192 = dict(enable_cfr=True, cfr_clip=40.0, cfr_error_clip=3.0,
                 output_rate=8_192_000)
DPD_8M192 = dict(tii_enable=True, tii_comb=5, tii_pattern=31,
                 enable_cfr=True, cfr_clip=40.0, cfr_error_clip=3.0,
                 ofdm_window_overlap=90, filter_taps_file="default",
                 output_rate=8_192_000)

# the card's paths and variants (tests/test_torch_cuda.py), with the kiss
# and dexter engines, at 1 TF a batch: (TM, settings, output)
VARIANTS = {
    "main_f32": (1, {}, "f32"),
    "main_s16": (1, {}, "s16"),
    "cfr_8m192": (1, CFR_8M192, "f32"),
    "cfr30_3m072": (1, dict(enable_cfr=True, cfr_clip=30.0,
                            cfr_error_clip=0.1, output_rate=3_072_000),
                    "s16"),
    "dpd_8m192": (1, dict(DPD_8M192, poly_coef_file="poly"), "uhd"),
    "lut_dpd": (1, dict(poly_coef_file="lut"), "uhd"),
    "u8_file": (1, {}, "u8"),
    "s8_file": (1, {}, "s8"),
    "cic_32m768": (1, dict(cic_eq_clock_rate=32_768_000), "f32"),
    "fft_1m536_auto": (1, dict(output_rate=1_536_000), "f32"),
    "fft_4m096": (1, dict(output_rate=4_096_000, resampler_mode="fft"),
                  "f32"),
    "poly_plain_2m5": (1, dict(output_rate=2_500_000), "f32"),
    "tii_old_tm2": (2, dict(tii_enable=True, tii_comb=5, tii_pattern=31,
                            tii_old_variant=True), "f32"),
    "window90_tm2": (2, dict(ofdm_window_overlap=90), "f32"),
    "pairs": (1, dict(device_interleave=True), "pairs"),
    "kiss": (1, dict(fft_engine="kiss"), "f32"),
    "kiss_ov90": (2, dict(fft_engine="kiss", ofdm_window_overlap=90), "f32"),
    "dexter": (1, dict(fft_engine="dexter", ofdm_window_overlap=12), "f32"),
}


def _settings(cls, fmt, mode, **kw):
    if fmt in ("f32", "pairs"):
        kw.setdefault("device_interleave", False)
        return cls(dab_mode=mode, **kw)
    if fmt == "uhd":
        return cls(dab_mode=mode, output="uhd", device_interleave=False,
                   **kw).normalise_for_output()
    return cls(dab_mode=mode, output="file", file_output_format=fmt,
               **kw).normalise_for_output()


def _variant(name, tmp_path):
    mode, kw, fmt = VARIANTS[name]
    kw = dict(kw)
    if "poly_coef_file" in kw:
        poly, lut = _dpd_files(tmp_path)
        kw["poly_coef_file"] = poly if kw["poly_coef_file"] == "poly" else lut
    m = Modulator(make_default_layout(mode, BENCH_SPECS),
                  _settings(ModSettings, fmt, mode, **kw), device="cpu")
    return m


def _batches(m, n, tfs=1, seed=5):
    """n batches of `tfs` TFs, as tensors."""
    C = m.p.cif_count
    raw = synth_eti_batch(n * tfs * C, mode=m.mode, subch_specs=BENCH_SPECS,
                          seed=seed)
    out = []
    for i in range(n):
        b = parse_eti_frames(raw[i * tfs * C:(i + 1) * tfs * C])
        out.append((torch.as_tensor(b.fic),
                    tuple(torch.as_tensor(x) for x in b.subchannels)))
    return out


def _eager(m, batch, state):
    with torch.no_grad():
        return m._modulate_impl(*batch, state, *m._gain_args(),
                                m._apply_swaps())


def _clone(tree):
    return tree_map(torch.clone, tree)


def _assert_equal(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the gains as tensors against dabmod_tpu's jitted step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variance", [4.0, 2.5])
@pytest.mark.parametrize("digital_gain", [1.0, 0.37])
def test_gain_tensors_match_reference(digital_gain, variance):
    """The port's step with 0-d float32 gain tensors gives what
    dabmod_tpu's step gives with its jnp.float32 gain arguments."""
    kw = dict(gain_mode=GAIN_VAR, digital_gain=digital_gain,
              gain_mode_variance=variance, fft_precision="highest")
    b = parse_eti_frames(synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS,
                                         seed=21))
    mj = JModulator(j_layout(1, BENCH_SPECS),
                    _settings(JSettings, "f32", 1, ofdm_backend="xla", **kw))
    ref, _, _ = mj.modulate(b.fic, tuple(b.subchannels), mj.init_state())
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  _settings(ModSettings, "f32", 1, **kw), device="cpu")
    gains = m._gain_args()
    assert all(g.shape == () and g.dtype == torch.float32 for g in gains)
    assert [float(g) for g in gains] == [
        float(np.float32(digital_gain)), float(np.float32(variance))]
    got, _, _ = _eager(m, (torch.as_tensor(b.fic), tuple(
        torch.as_tensor(x) for x in b.subchannels)), m.init_state())
    got, ref = np.stack([x.numpy() for x in got], -1), np.stack(
        [np.asarray(x) for x in ref], -1)
    np.testing.assert_allclose(got, ref, atol=3e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# no host synchronisation inside the step
# ---------------------------------------------------------------------------

_host_sync = stand_ins.host_sync
_IN_KERNEL = stand_ins.IN_KERNEL


@pytest.fixture
def kernels_hidden(monkeypatch):
    """The kernel wrappers, patched to run their plain versions with
    _IN_KERNEL raised."""
    stand_ins.hide_kernels(monkeypatch.setattr)


class _Ops(TorchDispatchMode):
    """Records the aten ops run under it, outside the kernels' plain
    versions."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _IN_KERNEL[0]:
            self.ops.append((func, args))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_has_no_host_sync(name, tmp_path, kernels_hidden,
                               one_intra_op_thread):
    m = _variant(name, tmp_path)
    (batch,) = _batches(m, 1)
    mode = _Ops()
    _eager(m, batch, m.init_state())           # warm-up: fills the caches
    state, gains, rp = m.init_state(), m._gain_args(), m._apply_swaps()
    with mode, torch.no_grad():
        m._modulate_impl(*batch, state, *gains, rp)
    bad = sorted({str(f) for f, a in mode.ops if _host_sync(f, a)})
    assert mode.ops and not bad, bad


def test_sync_check_sees_a_sync():
    """The recorder sees what the check looks for."""
    mode = _Ops()
    x = torch.arange(6.0)
    with mode:
        int(x[2])
        x[x > 2]
        torch.tensor([1.0])
    bad = {f.overloadpacket.__name__ for f, a in mode.ops if _host_sync(f, a)}
    assert bad == {"_local_scalar_dense", "index", "lift_fresh"}


# ---------------------------------------------------------------------------
# the graph step's host logic, with stand-ins for torch.cuda
# ---------------------------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch):
    """torch.cuda's graph API and streams on the CPU, the kernel wrappers
    hidden from the capture's check (tests/torch_graph_stand_in.py)."""
    return stand_ins.install(monkeypatch.setattr)


def _graph_modulator(name, tmp_path):
    """A CPU modulator whose modulate takes the graph step, as on the
    card."""
    m = _variant(name, tmp_path)
    m.compiled = compiled.GraphStep(m._modulate_impl)
    return m


@pytest.mark.parametrize("name", ["main_s16", "dpd_8m192", "lut_dpd",
                                  "fft_1m536_auto", "kiss", "dexter"])
def test_graph_step_equals_eager(name, tmp_path, stand_in):
    """Three batches through one captured graph, the state carried: each
    output, stats and state equal to the eager step's."""
    m = _graph_modulator(name, tmp_path)
    ref = _variant(name, tmp_path)
    st, st_ref = m.init_state(), ref.init_state()
    for batch in _batches(m, 3):
        got = m.modulate(*batch, st)
        want = _eager(ref, batch, st_ref)
        _assert_equal(got, want)
        _, st, _ = got
        _, st_ref, _ = want
    (cap,) = m.compiled.graphs.values()
    assert cap.replays == 3 and stand_in.made == 1
    assert int(st["tf_index"]) == 3


def test_inputs_go_into_the_static_buffers(tmp_path, stand_in):
    m = _graph_modulator("main_f32", tmp_path)
    b1, b2 = _batches(m, 2)
    m.modulate(*b1, m.init_state())
    st = m.init_state()
    m.modulate(*b2, st)
    (cap,) = m.compiled.graphs.values()
    _assert_equal(cap.inputs, tree_leaves((*b2, st)))
    assert all(x is not y for x, y in zip(cap.inputs,
                                          tree_leaves((*b2, st))))


def test_outputs_are_not_overwritten(tmp_path, stand_in):
    """Nothing a step returns changes in the next step: not the output,
    the stats or the state."""
    m = _graph_modulator("cfr_8m192", tmp_path)
    b1, b2 = _batches(m, 2)
    first = m.modulate(*b1, m.init_state())
    kept = _clone(first)
    second = m.modulate(*b2, first[1])
    _assert_equal(first, kept)
    assert not torch.equal(first[0][0], second[0][0])
    (cap,) = m.compiled.graphs.values()
    assert not any(a.untyped_storage().data_ptr()
                   == b.untyped_storage().data_ptr()
                   for a in tree_leaves(second)
                   for b in tree_leaves(cap.outputs) if a.numel())


def test_swaps_and_gains_reach_the_next_replay(tmp_path, stand_in):
    """New FIR taps, poly coefficients, digital gain and variance between
    two replays: the second equals a modulator built with them on the same
    state, and nothing is captured again."""
    import dataclasses
    m = _graph_modulator("dpd_8m192", tmp_path)
    b1, b2 = _batches(m, 2)
    _, st, _ = m.modulate(*b1, m.init_state())
    taps2 = np.asarray(tables.DEFAULT_FIR_TAPS[::-1], np.float32)
    am2, pm2 = (0.9, 0.01, 0.0, 0.0, 0.0), (0.05, 0.0, 0.0, 0.0, 0.0)
    assert m.update_fir_taps(taps2) and m.update_dpd("poly", (am2, pm2))
    assert not m.update_fir_taps(taps2[:7])
    assert not m.update_dpd("lut", (1.0, np.zeros((32, 2), np.float32)))
    m.settings.digital_gain = 0.8            # the RC's `gain digital`
    m.settings.gain_mode_variance = 3.0      # the RC's `gain var`
    got = m.modulate(*b2, _clone(st))
    poly2 = tmp_path / "poly2.coef"
    poly2.write_text("1\n5\n" + "".join(f"{v!r}\n" for v in (*am2, *pm2)))
    taps_file = tmp_path / "taps2.txt"
    taps_file.write_text(f"{taps2.size}\n" + "".join(
        f"{float(t)!r}\n" for t in taps2))
    fresh = Modulator(m.layout, dataclasses.replace(
        m.settings, filter_taps_file=str(taps_file),
        poly_coef_file=str(poly2)), device="cpu")
    want = _eager(fresh, b2, _clone(st))
    _assert_equal(got, want)
    (cap,) = m.compiled.graphs.values()
    assert cap.replays == 2 and stand_in.made == 1
    # and the old values give another signal
    assert not torch.equal(got[0][0], _eager(
        _variant("dpd_8m192", tmp_path), b2, _clone(st))[0][0])


def test_lut_swap_reaches_the_next_replay(tmp_path, stand_in):
    m = _graph_modulator("lut_dpd", tmp_path)
    b1, b2 = _batches(m, 2)
    _, st, _ = m.modulate(*b1, m.init_state())
    lut2 = np.stack([np.linspace(0.95, 0.8, 32), np.linspace(0, 0.1, 32)],
                    -1).astype(np.float32)
    assert m.update_dpd("lut", (2.0 ** 30, lut2))
    got = m.modulate(*b2, _clone(st))
    ref = _variant("lut_dpd", tmp_path)
    assert ref.update_dpd("lut", (2.0 ** 30, lut2))
    _assert_equal(got, _eager(ref, b2, _clone(st)))
    assert stand_in.made == 1


def test_swap_is_staged_until_the_next_step(tmp_path):
    """update_dpd on another thread stages the pair; the issuing thread
    copies both into the step's tensors, in place, at its next step."""
    import threading
    m = _variant("dpd_8m192", tmp_path)
    rp = m._runtime_params
    tensors = dict(rp)
    t = threading.Thread(target=m.update_dpd,
                         args=("poly", ((0.9,) + (0.0,) * 4, (0.1,) * 5)))
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert rp["poly_am"][0] == np.float32(POLY_AM[0])     # not yet
    got = m._apply_swaps()
    assert got is rp and all(got[k] is v for k, v in tensors.items())
    np.testing.assert_array_equal(got["poly_am"].numpy(),
                                  np.float32((0.9,) + (0.0,) * 4))
    np.testing.assert_array_equal(got["poly_pm"].numpy(), np.float32(0.1))


def test_a_graph_per_batch_size(tmp_path, stand_in):
    """A 2-TF batch captures a second graph (a partial batch of a live
    stream); each replays on its own, and the state carries across."""
    m = _graph_modulator("cfr_8m192", tmp_path)
    ref = _variant("cfr_8m192", tmp_path)
    st, st_ref = m.init_state(), ref.init_state()
    b2 = _batches(m, 2, tfs=2, seed=7)
    b1 = _batches(m, 2, tfs=1, seed=8)
    for batch in (b2[0], b1[0], b2[1], b1[1]):
        got = m.modulate(*batch, st)
        want = _eager(ref, batch, st_ref)
        _assert_equal(got, want)
        st, st_ref = got[1], want[1]
    assert sorted(m.compiled.graphs) == [1, 2] and stand_in.made == 2
    assert [c.replays for c in m.compiled.graphs.values()] == [2, 2]


@pytest.fixture
def counted_k1(monkeypatch):
    """K1's wrapper, counting its calls as the card's counts its launches:
    where it launches, and nowhere else."""
    plain = ofdm_kernel.ofdm_backend

    def counted(*a, **k):
        counted.launches += 1
        return plain(*a, **k)
    counted.launches = 0
    monkeypatch.setattr(ofdm_kernel, "ofdm_backend", counted)
    return counted


def test_launch_counts_follow_the_replays(tmp_path, stand_in, counted_k1):
    """The wrapper counts the warm-up's launch and the capture's; a replay
    runs no Python and adds nothing.  The graph records the launches it
    holds, those each replay runs on the card."""
    m = _graph_modulator("main_f32", tmp_path)
    st = m.init_state()
    for k, batch in enumerate(_batches(m, 4)):
        _, st, _ = m.modulate(*batch, st)
        assert counted_k1.launches == 2
    (cap,) = m.compiled.graphs.values()
    assert cap.launches == {"ofdm_backend": 1, "ofdm_cfr_backend": 0,
                            "resample": 0, "kiss_ifft": 0, "frontend": 0}
    assert cap.replays == 4


def test_a_failed_capture_raises(tmp_path, stand_in, counted_k1,
                                 monkeypatch):
    """A host synchronisation in the step fails the capture: the step
    raises and keeps no graph; the counts hold the launches made: the
    warm-up's (the capture fails before K1)."""
    m = _graph_modulator("main_f32", tmp_path)
    (batch,) = _batches(m, 1)
    monkeypatch.setattr(m, "_ofdm_symbols_impl", _syncing(
        m._ofdm_symbols_impl))
    with pytest.raises(RuntimeError, match="capturing"):
        m.modulate(*batch, m.init_state())
    assert not m.compiled.graphs and counted_k1.launches == 1


def _syncing(fn):
    def f(*a, **k):
        out = fn(*a, **k)
        int(out[0][0].flatten()[0] > 0)       # a host sync
        return out
    return f


def test_an_input_of_another_shape_raises(tmp_path, stand_in):
    m = _graph_modulator("main_f32", tmp_path)
    (batch,) = _batches(m, 1)
    m.modulate(*batch, m.init_state())
    st = m.init_state()
    st["ti_history"] = tuple(h[:, :-1] for h in st["ti_history"])
    with pytest.raises(ValueError, match="the graph takes"):
        m.modulate(*batch, st)


def test_cpu_modulator_runs_eagerly():
    m = Modulator(make_default_layout(1), ModSettings(dab_mode=1),
                  device="cpu")
    assert m.compiled is None
