"""K5, the front end in one kernel (ops/frontend_kernel.py,
csrc/frontend.cu), on the CPU: the kernel's index arithmetic
(tests/frontend_kernel_model.py) against the plain front end, bit for bit,
planes and new history, in TM I-IV, on UEP and EEP-A/B layouts with filler
gaps and an overlapping one, with TII and CIC, over chained batches of 1
and 24 TFs; the layout's tables; the wrapper's checks and launch count;
and which steps of the modulator take the wrapper and which the op chain.

Every comparison is bit for bit: the chain is integer arithmetic up to the
carrier values, which are exact, and one float32 product a tap."""
import numpy as np
import pytest
import torch

import frontend_kernel_model as model
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.eti import (REALISTIC_MUX_SPECS, parse_eti_frames,
                                  synth_eti_batch)
from dabmod_tpu_torch.models import Modulator, compiled, make_default_layout
from dabmod_tpu_torch.ops import fec, frontend_kernel
from torch_threads import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))
# UEP (0x02, 0x03), EEP-A (0x22) and EEP-B (0x25) with filler between and
# after them
GAP_SPECS = ((6, 24, 0x22), (100, 48, 0x25), (300, 48, 0x03),
             (420, 12, 0x02))
# the second sub-channel starts inside the first: assemble_cif's overlay,
# the last writer wins
OVERLAP_SPECS = ((0, 48, 0x22), (40, 24, 0x22), (200, 24, 0x02))


def _modulator(mode, specs, **kw):
    return Modulator(make_default_layout(mode, specs),
                     ModSettings(dab_mode=mode, **kw), device="cpu")


def _batches(m, specs, tfs, n, seed):
    """n consecutive batches of `tfs` TFs: (fic, sub-channel tuple) numpy
    arrays."""
    frames = tfs * m.p.cif_count
    raw = synth_eti_batch(n * frames, mode=m.mode, subch_specs=specs,
                          seed=seed)
    out = []
    for i in range(n):
        b = parse_eti_frames(raw[frames * i:frames * (i + 1)])
        out.append((b.fic, tuple(b.subchannels)))
    return out


def _random_history(m, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, 2, (15, w), np.uint8))
                 for w in m._subch_ti_bits)


def _check_chain(m, specs, tfs, n=1, seed=0, tf_index=0, history=None):
    """n batches through the plain front end and through the kernel's
    model, the history and TF index carried: equal to the bit."""
    table = m._frontend
    hist = history if history is not None else m.init_state()["ti_history"]
    for fic, subs in _batches(m, specs, tfs, n, seed):
        want, new_hist = frontend_kernel.frontend_plain(
            torch.as_tensor(fic), tuple(torch.as_tensor(x) for x in subs),
            hist, torch.tensor(tf_index, dtype=torch.int32), table)
        got, got_hist = model.kernel(table, fic, subs,
                                     [h.numpy() for h in hist], tf_index)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == tuple(w.shape)
            assert g.tobytes() == w.numpy().tobytes()
        assert len(got_hist) == len(new_hist) == len(specs)
        for g, w in zip(got_hist, new_hist):
            np.testing.assert_array_equal(g, w.numpy())
        hist, tf_index = new_hist, tf_index + tfs


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_kernel_model_matches_plain_realistic_mux(mode):
    """The 17 sub-channels of REALISTIC_MUX_SPECS (UEP, EEP-A and EEP-B,
    filler at the end of the CIF), 2 TFs from a random history."""
    m = _modulator(mode, REALISTIC_MUX_SPECS)
    _check_chain(m, REALISTIC_MUX_SPECS, 2, seed=mode,
                 history=_random_history(m, mode))


@pytest.mark.parametrize("specs", [GAP_SPECS, OVERLAP_SPECS],
                         ids=["filler_gaps", "overlap"])
@pytest.mark.parametrize("mode", [1, 3])
def test_kernel_model_matches_plain_layouts(mode, specs):
    m = _modulator(mode, specs)
    _check_chain(m, specs, 2, n=2, seed=10 + mode,
                 history=_random_history(m, 20 + mode))


@pytest.mark.parametrize("mode,kw", [
    (1, dict(tii_enable=True, tii_comb=5, tii_pattern=31)),
    (2, dict(tii_enable=True, tii_comb=3, tii_pattern=12)),
    (1, dict(cic_eq_clock_rate=32_768_000)),
    (1, dict(tii_enable=True, tii_comb=5, tii_pattern=31,
             cic_eq_clock_rate=32_768_000))],
    ids=["tii_tm1", "tii_tm2", "cic", "tii_cic"])
def test_kernel_model_null_row_and_cic(mode, kw):
    """TII in the NULL row of even TFs only (3 TFs from an odd TF index),
    the CIC taps on every row."""
    m = _modulator(mode, BENCH_SPECS, **kw)
    assert (m._tii_vec is not None) == ("tii_enable" in kw)
    assert (m._cic_taps is not None) == ("cic_eq_clock_rate" in kw)
    _check_chain(m, BENCH_SPECS, 3, seed=30, tf_index=7)


@pytest.mark.parametrize("tfs", [1, 24])
def test_kernel_model_chained_batches(tfs):
    """Three batches in a row, the history and TF index carried: at 1 TF
    (4 CIFs, the history shifts by 4) and at 24 (96 CIFs, the history is
    the batch's last 15)."""
    m = _modulator(1, REALISTIC_MUX_SPECS, tii_enable=True, tii_comb=5,
                   tii_pattern=31)
    _check_chain(m, REALISTIC_MUX_SPECS, tfs, n=3, seed=40 + tfs)


def test_tables_of_the_layout():
    """The generator masks are tables.CONV_TAPS', the delays fec's; each
    CIF bit names the last sub-channel written there (or the filler); each
    unit's puncture index and PRBS are the plain chain's."""
    assert frontend_kernel.GEN_MASKS == (0x6D, 0x4F, 0x53, 0x6D)
    assert model.GEN_MASKS == sum(g << (8 * i) for i, g in
                                  enumerate(frontend_kernel.GEN_MASKS))
    assert [model.ti_delay(j) for j in range(16)] == list(fec.TI_DELAYS)
    m = _modulator(1, OVERLAP_SPECS)
    t = m._frontend
    src = t.cif_src.numpy()
    for i, (off, w) in enumerate(zip(t.offsets, t.widths)):
        mine = src[off:off + w] >> 16 == i + 1
        later = np.zeros(w, bool)
        for o2, w2 in zip(t.offsets[i + 1:], t.widths[i + 1:]):
            later[max(o2 - off, 0):max(o2 + w2 - off, 0)] = True
        assert np.array_equal(mine, ~later)
        np.testing.assert_array_equal(src[off:off + w][mine] & 0xFFFF,
                                      np.arange(w)[mine])
    covered = np.zeros(tables.CIF_BITS, bool)
    for off, w in zip(t.offsets, t.widths):
        covered[off:off + w] = True
    assert np.array_equal(src < 0, ~covered)
    for k, (n, prbs, keep, width) in enumerate(t.units):
        punct = t.fic_punct if k == 0 else t.subch_punct[k - 1]
        bits = t.fic_prbs if k == 0 else t.subch_prbs[k - 1]
        kept = t.keep[keep:keep + width].numpy()
        np.testing.assert_array_equal(kept[:punct[0].numel()],
                                      punct[0].numpy())
        assert (kept[punct[0].numel():] == -1).all()
        assert width == punct[0].numel() + punct[1]
        np.testing.assert_array_equal(
            np.unpackbits(t.prbs[prbs:prbs + n].numpy()), bits.numpy())


def test_make_table_refuses_a_sub_channel_past_the_cif():
    p = tables.mode_params(1)
    layout = make_default_layout(1, ((850, 24, 0x22),))
    with pytest.raises(ValueError, match="past the CIF"):
        frontend_kernel.make_table(p, layout, tables.phase_ref_eighths(1))


@pytest.mark.parametrize("bad,error", [
    ("subchannels", ValueError), ("fic_frames", ValueError),
    ("history", ValueError), ("dtype", TypeError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, error):
    m = _modulator(1, BENCH_SPECS)
    ((fic, subs),) = _batches(m, BENCH_SPECS, 1, 1, 0)
    fic = torch.as_tensor(fic)
    subs = tuple(torch.as_tensor(x) for x in subs)
    hist = m.init_state()["ti_history"]
    args = {"subchannels": (fic, subs[:1], hist[:1]),
            "fic_frames": (fic[:3], tuple(x[:3] for x in subs), hist),
            "history": (fic, subs, (hist[0][:14], hist[1])),
            "dtype": (fic.int(), subs, hist)}[bad]
    with pytest.raises(error):
        frontend_kernel.frontend(*args, 0, m._frontend)


def test_launch_counts_name_k5_and_the_cpu_counts_no_launch():
    """On the CPU the wrapper is the plain front end and counts nothing."""
    assert "frontend" in compiled.launch_counts()
    assert (frontend_kernel, "frontend") in compiled.COUNTED
    m = _modulator(1, BENCH_SPECS)
    ((fic, subs),) = _batches(m, BENCH_SPECS, 1, 1, 0)
    before = frontend_kernel.frontend.launches
    args = (torch.as_tensor(fic), tuple(torch.as_tensor(x) for x in subs),
            m.init_state()["ti_history"], 0, m._frontend)
    got = frontend_kernel.frontend(*args)
    want = frontend_kernel.frontend_plain(*args)
    assert frontend_kernel.frontend.launches == before
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)


def _spy(monkeypatch):
    calls = []
    inner = frontend_kernel.frontend

    def spy(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    monkeypatch.setattr(frontend_kernel, "frontend", spy)
    return calls


@pytest.mark.parametrize("kw", [
    {}, dict(fft_engine="kiss", ofdm_window_overlap=10),
    dict(fft_engine="dexter"),
    dict(output_rate=8_192_000, enable_cfr=True, cfr_clip=40.0,
         cfr_error_clip=3.0)], ids=["s16", "kiss", "dexter", "cfr_8m192"])
def test_every_step_takes_the_wrapper_once(monkeypatch, kw):
    """The modulator's step goes through K5's wrapper once a batch, on
    every chain."""
    calls = _spy(monkeypatch)
    m = _modulator(1, BENCH_SPECS, **kw)
    st = m.init_state()
    for fic, subs in _batches(m, BENCH_SPECS, 1, 2, 3):
        _, st, _ = m.modulate(fic, subs, st)
    assert calls == [1, 1]


def test_traced_step_and_another_coupling_take_the_op_chain(monkeypatch,
                                                            tmp_path):
    """modulate_traced (its taps dump every stage) and a time-interleaver
    coupling other than fec.time_interleave_all (a sharded one) run the
    op chain, and give the wrapper's symbols."""
    calls = _spy(monkeypatch)
    m = _modulator(1, BENCH_SPECS)
    ((fic, subs),) = _batches(m, BENCH_SPECS, 1, 1, 5)
    m.modulate_traced(fic, subs, m.init_state(), str(tmp_path))
    assert calls == []
    fic_t = torch.as_tensor(fic)
    subs_t = tuple(torch.as_tensor(x) for x in subs)
    hist = m.init_state()["ti_history"]
    tf0 = torch.zeros((), dtype=torch.int32)

    def coupling(bits, histories):
        return fec.time_interleave_all(bits, histories)
    got = m._ofdm_symbols_impl(fic_t, subs_t, hist, tf0, coupling)
    assert calls == []
    want = m._ofdm_symbols_impl(fic_t, subs_t, hist, tf0)
    assert calls == [1]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
