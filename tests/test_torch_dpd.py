"""The port's DPD engine (dabmod_tpu_torch/dpd/, a copy of dabmod_tpu/dpd/)
on the CPU:

* the cases of tests/test_dpd_modules.py (alignment, MER, shoulders, AGC
  loops, heuristics, the LUT model and its file), run on the port's copy,
  the LUT file read by the port's load_dpd_file and applied by its
  memless_lut;
* the dpd/ cases of tests/test_sdr_dpd.py, run on the port: the closed
  loop through the feedback server, Adapt -> the port's ZeroMQ RC -> the
  port's ModRuntime on device="cpu" (coefficient reload, analog gains),
  and the LUT engine against the loopback PA;
* parity with dabmod_tpu: bursts made from a numpy seed, with a
  synthetic PA, an integer lag and a fractional delay, go through both
  packages' alignment, normalisation, statistics, model fits, adaptation
  step, MER, shoulders, AGC loops and heuristics, and must give equal
  arrays (both are NumPy on one machine); both Adapts must write the same
  coefficient and LUT files byte for byte, read the same by both
  load_dpd_files; both run_engines, fed the same recorded bursts, must
  write the same files at every iteration; the copies' constants, the
  DpdConfig fields and DpdceServer.DUMPS_KEPT are held equal.
"""
import inspect
import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from dabmod_tpu import gui as j_gui
from dabmod_tpu import dpd as j_dpd
from dabmod_tpu.dpd import adapt as j_adapt
from dabmod_tpu.dpd import dpdce as j_dpdce
from dabmod_tpu.dpd import globalconfig as j_globalconfig
from dabmod_tpu.dpd import measure as j_measure
from dabmod_tpu.dpd import model_lut as j_model_lut
from dabmod_tpu.dpd import server as j_server
from dabmod_tpu.models.modulator import load_dpd_file as j_load_dpd_file
from dabmod_tpu.rc import client as j_client
from dabmod_tpu.rc import yamlrpc as j_yamlrpc
from dabmod_tpu.utils import racecheck as j_racecheck
from dabmod_tpu_torch import gui as t_gui
from dabmod_tpu_torch import dpd as t_dpd
from dabmod_tpu_torch.dpd import (DpdConfig, Lut, Mer, MeasureShoulders,
                                  RxAgc, SymbolAlign, TxAgc, align_tx_rx,
                                  coarse_align, get_learning_rate,
                                  get_n_meas, phase_align, subsample_align)
from dabmod_tpu_torch.dpd import adapt as t_adapt
from dabmod_tpu_torch.dpd import dpdce as t_dpdce
from dabmod_tpu_torch.dpd import globalconfig as t_globalconfig
from dabmod_tpu_torch.dpd import measure as t_measure
from dabmod_tpu_torch.dpd import model_lut as t_model_lut
from dabmod_tpu_torch.dpd import server as t_server
from dabmod_tpu_torch.dpd.align import lag
from dabmod_tpu_torch.io.sdr import DpdFeedbackServer, LoopbackSdrDevice
from dabmod_tpu_torch.models.modulator import load_dpd_file
from dabmod_tpu_torch.rc import client as t_client
from dabmod_tpu_torch.rc import yamlrpc as t_yamlrpc
from dabmod_tpu_torch.timestamps import FrameTimestamp
from dabmod_tpu_torch.utils import racecheck as t_racecheck
from live_stream import free_port

C = DpdConfig(sample_rate=2_048_000)
RNG = np.random.default_rng(7)


def _qpsk_carriers(n, rng=RNG):
    return ((rng.integers(0, 2, n) * 2 - 1)
            + 1j * (rng.integers(0, 2, n) * 2 - 1)).astype(
                np.complex128) / np.sqrt(2)


def _symbol_from_spectrum(carriers):
    """Build one T_U time-domain symbol whose fftshifted spectrum crop
    (Mer._spectrum convention) equals `carriers`."""
    full = np.zeros(C.T_U, np.complex128)
    band = full[C.FFT_start:C.FFT_end]
    band[:C.FFT_delete] = carriers[:C.FFT_delete]
    band[C.FFT_delete + 1:] = carriers[C.FFT_delete:]
    return np.fft.ifft(np.fft.ifftshift(full))


def _dab_burst(n_syms=8, rng=RNG):
    """Synthetic TM-I-like burst: OFDM symbols with cyclic prefixes."""
    syms = []
    for _ in range(n_syms):
        body = _symbol_from_spectrum(_qpsk_carriers(C.FFT_delta, rng))
        syms.append(np.concatenate([body[-C.T_C:], body]))
    return np.concatenate(syms)


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------


def test_lag_and_coarse_align():
    sig = RNG.standard_normal(4096) + 1j * RNG.standard_normal(4096)
    delay = 37
    rec = np.concatenate([np.zeros(delay), sig])[:4096]
    assert lag(sig, rec) == delay
    tx, rx = coarse_align(sig, rec)
    assert tx.shape == rx.shape
    corr = np.abs(np.vdot(tx, rx)) / (np.linalg.norm(tx)
                                      * np.linalg.norm(rx))
    assert corr > 0.99


def test_subsample_align_recovers_fractional_delay():
    n = 2048
    spec = np.zeros(n, np.complex128)
    spec[1:200] = RNG.standard_normal(199) + 1j * RNG.standard_normal(199)
    ref = np.fft.ifft(spec)
    tau = 0.37
    omega = np.fft.fftfreq(n, d=1.0 / (2 * np.pi))
    delayed = np.fft.ifft(np.exp(-1j * tau * omega) * spec)
    fixed = subsample_align(delayed, ref)
    assert fixed.size == n
    err_before = np.linalg.norm(delayed - ref)
    err_after = np.linalg.norm(fixed - ref)
    assert err_after < 0.05 * err_before


def test_phase_align_removes_rotation():
    sig = RNG.standard_normal(1000) + 1j * RNG.standard_normal(1000)
    rotated = sig * np.exp(1j * 0.8)
    fixed = phase_align(rotated, sig)
    assert np.linalg.norm(fixed - sig) < 1e-6 * np.linalg.norm(sig)


def test_align_tx_rx_pipeline():
    tx = _dab_burst(4)
    rx = np.concatenate([np.zeros(123), tx * np.exp(1j * 0.5)])
    tx_a, rx_a = align_tx_rx(tx, rx)
    err = np.linalg.norm(rx_a - tx_a) / np.linalg.norm(tx_a)
    assert err < 1e-3


def test_symbol_align_finds_offset():
    burst = _dab_burst(10)
    offset = 1700
    sa = SymbolAlign(C)
    got = sa.calc_offset(burst[offset:])
    # the offset points at a symbol body (prefix start + T_C), mod T_S
    assert got % C.T_S == (C.T_S - offset + C.T_C) % C.T_S
    sym = sa.crop_symbol_without_cyclic_prefix(burst[offset:])
    assert sym.shape[0] == C.T_U


# ---------------------------------------------------------------------------
# MER / shoulders
# ---------------------------------------------------------------------------


def test_mer_clean_vs_noisy():
    carriers = _qpsk_carriers(C.FFT_delta)
    clean = _symbol_from_spectrum(carriers)
    mer = Mer(C)
    m_clean = mer.calc_mer(clean)
    assert m_clean < -60          # error far below signal
    noisy = clean + 0.001 * (RNG.standard_normal(C.T_U)
                             + 1j * RNG.standard_normal(C.T_U))
    m_noisy = mer.calc_mer(noisy)
    assert m_noisy > m_clean + 10
    assert m_noisy < -10


def test_shoulders_in_band_vs_adjacent():
    burst = _dab_burst(24)
    ms = MeasureShoulders(C)
    diff, shoulder, peak = ms.average_shoulders(burst, n_avg=8)
    assert peak > shoulder
    assert diff > 40              # clean signal: huge shoulder distance
    # a nonlinearity must reduce the shoulder distance (spectral regrowth)
    pa = burst * (1 - 0.3 * np.abs(burst * 40) ** 2)
    diff_pa, _, _ = ms.average_shoulders(pa, n_avg=8)
    assert diff_pa < diff


# ---------------------------------------------------------------------------
# AGC loops
# ---------------------------------------------------------------------------


class _FakeAdapt:
    def __init__(self, txgain=70.0, rxgain=25.0, digital=1.0):
        self.txgain, self.rxgain, self.digital = txgain, rxgain, digital
        self.calls = []

    def set_txgain(self, g):
        self.calls.append(("tx", g))
        self.txgain = g

    def get_txgain(self):
        return self.txgain

    def set_rxgain(self, g):
        self.calls.append(("rx", g))
        self.rxgain = g

    def get_rxgain(self):
        return self.rxgain

    def set_digital_gain(self, g):
        self.calls.append(("dig", g))
        self.digital = g

    def get_digital_gain(self):
        return self.digital


class _FakeMeasure:
    """RX median scales with the current rxgain, anchored at 25 dB."""

    def __init__(self, adapt, base_median=0.005, rng=RNG):
        self.adapt = adapt
        self.base = base_median
        self.rng = rng

    def get_samples(self):
        scale = 10 ** ((self.adapt.rxgain - 25.0) / 20.0)
        rx = (self.rng.standard_normal(4096)
              + 1j * self.rng.standard_normal(4096)) * self.base * scale
        rx *= self.base * scale / np.median(np.abs(rx))
        return rx.copy(), 0.0, rx, 0.0


def test_rx_agc_converges_to_target_median():
    adapt = _FakeAdapt()
    meas = _FakeMeasure(adapt, base_median=0.005)
    agc = RxAgc(meas, adapt, C)
    ok, report = agc.run()
    assert ok, report
    # correction: 20*log10(1/(20*0.005)) = +20 dB above the 25 dB anchor
    assert adapt.rxgain == pytest.approx(45.0, abs=0.5)
    _, _, rx, _ = meas.get_samples()
    assert np.median(np.abs(rx)) == pytest.approx(
        C.RAGC_rx_median_target, rel=0.05)


def test_rx_agc_flags_excessive_power():
    adapt = _FakeAdapt()
    meas = _FakeMeasure(adapt, base_median=0.5)   # way too hot
    ok, report = RxAgc(meas, adapt, C).run()
    assert not ok
    assert "too high" in report


def test_tx_agc_trades_tx_for_digital_gain():
    adapt = _FakeAdapt(txgain=70.0, digital=1.0)
    agc = TxAgc(adapt, C)
    tx = np.full(1000, 0.3 + 0j)      # median 0.3 > tolerated max
    assert agc.adapt_if_necessary(tx)
    delta_db = 20 * np.log10(C.TAGC_tx_median_target / 0.3)
    assert adapt.txgain == pytest.approx(70.0 - delta_db, abs=1e-6)
    assert adapt.digital == pytest.approx(10 ** (delta_db / 20), abs=1e-9)
    # digital reduced before analog raised (no transient overshoot)
    assert adapt.calls[0][0] == "dig"
    # in-band median: no change
    adapt2 = _FakeAdapt()
    assert not TxAgc(adapt2, C).adapt_if_necessary(
        np.full(1000, C.TAGC_tx_median_target + 0j))
    assert adapt2.calls == []


# ---------------------------------------------------------------------------
# heuristics / LUT model
# ---------------------------------------------------------------------------


def test_heuristics_schedules():
    assert get_learning_rate(0) == pytest.approx(0.4)
    assert get_learning_rate(10) == pytest.approx(0.05)
    assert get_learning_rate(100) == pytest.approx(0.05)
    assert get_n_meas(0) == 10
    assert get_n_meas(10) == 20


def _pa(x):
    m2 = np.abs(x) ** 2
    return x * (1 - 0.2 * m2) * np.exp(1j * 0.15 * m2)


def test_lut_model_learns_inverse():
    tx = (RNG.standard_normal(40000)
          + 1j * RNG.standard_normal(40000)) * 0.25
    peak = np.abs(tx).max()
    tx = tx / peak * 0.9
    rx = _pa(tx)
    lut = Lut()
    lut.train(tx, rx)
    # predistorted signal through the PA must be closer to the original
    err_plain = np.linalg.norm(_pa(tx) - tx)
    err_dpd = np.linalg.norm(_pa(lut.apply(tx)) - tx)
    assert err_dpd < 0.25 * err_plain


def test_lut_file_roundtrip_and_device_path(tmp_path):
    """The port's LUT file, read by the port's load_dpd_file and applied
    by the port's memless_lut (plain PyTorch on the CPU) == the model's
    host apply."""
    from dabmod_tpu_torch.dpd.adapt import write_lut_file
    from dabmod_tpu_torch.ops.filters import memless_lut

    lut = Lut()
    tx = (RNG.standard_normal(5000) + 1j * RNG.standard_normal(5000)) * 0.3
    lut.train(tx, _pa(tx))
    path = str(tmp_path / "lut.coef")
    write_lut_file(path, lut.scalefactor, lut.lut)
    kind, (scale, pairs) = load_dpd_file(path)
    assert kind == "lut"
    assert scale == pytest.approx(lut.scalefactor)
    np.testing.assert_allclose(pairs[:, 0], lut.lut.real, rtol=1e-6)
    np.testing.assert_allclose(pairs[:, 1], lut.lut.imag, rtol=1e-6)

    planes = (torch.as_tensor(tx.real.astype(np.float32)),
              torch.as_tensor(tx.imag.astype(np.float32)))
    dr, di = memless_lut(planes, torch.as_tensor(pairs),
                         torch.tensor(np.float32(scale)))
    host = lut.apply(tx.astype(np.complex64))
    np.testing.assert_allclose(dr.numpy() + 1j * di.numpy(), host,
                               rtol=2e-4, atol=2e-6)


# ---------------------------------------------------------------------------
# the dpd/ cases of tests/test_sdr_dpd.py, on the port
# ---------------------------------------------------------------------------


def _wait(cond, timeout=5.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < timeout:
        time.sleep(0.02)
    assert cond()


def _pa_model(x):
    """Synthetic PA: compression + phase rotation growing with power."""
    m2 = np.abs(x) ** 2
    gain = 1.0 - 0.2 * m2
    phase = 0.15 * m2
    return (x * gain * np.exp(1j * phase)).astype(np.complex64)


def test_dpd_closed_loop():
    """Feedback server + Measure + ExtractStatistic + Poly on a synthetic
    PA: the fitted model must recover the PA's AM/AM compression."""
    from dabmod_tpu_torch.dpd import ExtractStatistic, Measure, Poly
    from dabmod_tpu_torch.dpd.measure import normalise_rx
    from dabmod_tpu_torch.dpd.measure import phase_align as phase_align_rx

    dev = LoopbackSdrDevice(pa_model=_pa_model)
    server = DpdFeedbackServer(dev, port=0, sample_rate=2_048_000)
    try:
        rng = np.random.default_rng(5)
        n = 20000
        iq = (rng.standard_normal((n, 2)) * 0.25).astype(np.float32)
        ts = FrameTimestamp(valid=True, seconds=1000, pps=0)
        dev.transmit_frame(iq, ts)

        meas = Measure("127.0.0.1", server.port, n)
        result = {}

        def fetch():
            result["data"] = meas.get_samples()

        t = threading.Thread(target=fetch)
        t.start()
        # the server waits for the next TX frame snapshot
        for _ in range(50):
            server.set_tx_frame(iq, ts)
            time.sleep(0.05)
            if not t.is_alive():
                break
        t.join(timeout=5)
        assert "data" in result
        tx, tx_ts, rx, rx_ts = result["data"]
        assert tx.size == n and rx.size == n
        assert tx_ts == 1000.0

        # closed-loop fit
        rx = phase_align_rx(tx, normalise_rx(tx, rx))
        es = ExtractStatistic(n_bins=40, n_per_bin=200, peak_amplitude=1.0)
        tx_avg, rx_avg, ph = es.extract(tx, rx)
        assert tx_avg.size > 10

        model = Poly()
        model.train(tx_avg, rx_avg, ph)
        # the AM/AM curve must show compression: predistorter gain above 1
        # at high amplitude (tx_est > rx for large rx)
        hi = model.am_am(np.array([0.6]))[0]
        lo = model.am_am(np.array([0.1]))[0]
        assert hi / 0.6 > lo / 0.1 * 1.01
        # phase model must capture the positive phase rotation
        assert model.am_pm(np.array([0.7]))[0] > 0.01
    finally:
        server.stop()


def test_adapt_writes_and_reloads_coefs(tmp_path):
    """Adapt -> the port's ZeroMQ RC -> the port's runtime on the CPU: the
    poly coefficients reload, and the digital gain reads and writes."""
    pytest.importorskip("zmq")
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.dpd.adapt import Adapt, write_coef_file
    from dabmod_tpu_torch.eti import synth_eti_batch
    from dabmod_tpu_torch.rc import rcs
    from dabmod_tpu_torch.runtime import ModRuntime

    coef_path = str(tmp_path / "poly.coef")
    write_coef_file(coef_path, [1, 0, 0, 0, 0], [0, 0, 0, 0, 0])

    frames = synth_eti_batch(8, mode=1)
    inp = tmp_path / "in.eti"
    inp.write_bytes(frames.tobytes())
    ep = f"tcp://127.0.0.1:{free_port()}"
    s = ModSettings(input_name=str(inp), output="file",
                    output_name=str(tmp_path / "out.iq"),
                    file_output_format="complexf", batch_tf=1,
                    poly_coef_file=coef_path, rc_zmq_endpoint=ep)
    s.normalise_for_output()
    rt = ModRuntime(s, device="cpu")
    try:
        rt.run_batches(max_batches=1)

        adapt = Adapt(ep, coef_path)
        new_am = np.array([1.05, 0.2, 0, 0, 0], np.float32)
        new_pm = np.array([0.01, 0, 0, 0, 0], np.float32)
        adapt.set_predistorter(("poly", new_am, new_pm))

        rt.run_batches(max_batches=1)    # the coefficients in the step
        np.testing.assert_allclose(
            np.asarray(rt.modulator._poly_am), new_am, rtol=1e-6)
        assert adapt.get_digital_gain() == 1.0
        adapt.set_digital_gain(0.9)
        assert rt.settings.digital_gain == 0.9
        adapt.rc.close()
    finally:
        rt.close()
        rcs.shutdown()


def test_loopback_sdr_output_via_runtime(tmp_path):
    """output=loopback builds an SdrOutput with the full sdr RC surface
    (txgain/rxgain/freq/muting/counters) and transmits frames; the DPD
    Adapt's analog-gain path drives it over the port's ZeroMQ RC."""
    pytest.importorskip("zmq")
    from dabmod_tpu_torch.config import ModSettings
    from dabmod_tpu_torch.dpd.adapt import Adapt
    from dabmod_tpu_torch.eti import synth_eti_batch
    from dabmod_tpu_torch.io.sdr import SdrOutput
    from dabmod_tpu_torch.rc import rcs
    from dabmod_tpu_torch.runtime import ModRuntime

    frames = synth_eti_batch(8, mode=1)
    inp = tmp_path / "in.eti"
    inp.write_bytes(frames.tobytes())
    ep = f"tcp://127.0.0.1:{free_port()}"
    s = ModSettings(input_name=str(inp), output="loopback", batch_tf=1,
                    sdr_txgain=50.0, sdr_rxgain=30.0,
                    sdr_frequency=227_360_000.0, sdr_dpd_port=0,
                    rc_zmq_endpoint=ep)
    s.normalise_for_output()
    rt = ModRuntime(s, device="cpu")
    try:
        assert isinstance(rt.output, SdrOutput)
        assert rt.output.device.frequency == 227_360_000.0
        rt.run_batches(max_batches=2)
        _wait(lambda: rt.output.frames == 2)

        adapt = Adapt(ep, str(tmp_path / "c.coef"))
        assert adapt.get_txgain() == 50.0
        adapt.set_rxgain(42.5)
        assert rt.output.device.rxgain == 42.5
        assert adapt.get_rxgain() == 42.5
        adapt.rc.close()
    finally:
        rt.output.close()
        rcs.shutdown()


def test_lut_engine_closed_loop(tmp_path):
    """The port's run_engine with the LUT model linearises the loopback
    PA; its file is read by the port's load_dpd_file."""
    pytest.importorskip("zmq")
    from dabmod_tpu_torch.dpd.dpdce import run_engine
    from dabmod_tpu_torch.rc import RemoteControllable, rcs

    dev = LoopbackSdrDevice(pa_model=_pa_model)
    server = DpdFeedbackServer(dev, port=0, sample_rate=2_048_000)
    state = {"coeffile": ""}
    poly_rc = RemoteControllable("poly")
    poly_rc.add_parameter("coeffile", "coef file", lambda: state["coeffile"],
                          lambda v: state.__setitem__("coeffile", v))
    rcs.enrol(poly_rc)
    ep = f"tcp://127.0.0.1:{free_port()}"
    rcs.add_zmq(ep)
    stop = threading.Event()

    def feeder():
        rng = np.random.default_rng(3)
        ts = FrameTimestamp(valid=True, seconds=700, pps=0)
        iq = (rng.standard_normal((50000, 2)) * 0.2).astype(np.float32)
        dev.transmit_frame(iq, ts)
        while not stop.is_set():
            server.set_tx_frame(iq, ts)
            time.sleep(0.02)

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        model = run_engine(ep, "127.0.0.1", server.port, iterations=2,
                           samples_per_burst=40000, sleep_s=0.0,
                           learning_rate=1.0, model_kind="lut",
                           coef_path=str(tmp_path / "lut.coef"))
        # compression -> correction magnitude grows with amplitude
        mags = np.abs(model.lut)
        filled = mags != 1.0
        assert filled.sum() > 4
        idx = np.flatnonzero(filled)
        assert mags[idx[-1]] > mags[idx[0]]
        assert state["coeffile"]
        kind, (scale, pairs) = load_dpd_file(state["coeffile"])
        assert kind == "lut" and pairs.shape == (32, 2)
    finally:
        stop.set()
        server.stop()
        rcs.shutdown()
        rcs.remove("poly")


# ---------------------------------------------------------------------------
# parity with dabmod_tpu
# ---------------------------------------------------------------------------

PKGS = {"port": t_dpd, "ref": j_dpd}


def _bursts(seed, n_syms=10, lag_samples=37, tau=0.31, phase=0.7):
    """A TM-I-like TX burst at 2.048 MS/s and its RX: the PA, a gain, a
    bulk phase, a fractional delay tau and an integer lag, plus a little
    noise; complex64 as the feedback server sends them."""
    rng = np.random.default_rng(seed)
    tx = _dab_burst(n_syms, rng)
    tx = tx / np.abs(tx).max() * 0.8
    n = tx.size
    omega = np.fft.fftfreq(n, d=1.0 / (2 * np.pi))
    rx = np.fft.ifft(np.exp(-1j * tau * omega) * np.fft.fft(_pa(tx)))
    rx = 3.1 * np.exp(1j * phase) * rx
    rx = np.concatenate([np.zeros(lag_samples), rx])[:n]
    rx = rx + 1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return tx.astype(np.complex64), rx.astype(np.complex64)


def _eq(a, b):
    """Equal values of equal type, recursively (arrays bit for bit)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (type(a) is type(b) and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=True))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    return type(a) is type(b) and (a == b or (a != a and b != b))


@pytest.mark.parametrize("seed", [0, 1])
def test_alignment_and_normalisation_match_reference(seed):
    tx, rx = _bursts(seed)
    outs = {k: (p.align_tx_rx(tx, rx),
                p.coarse_align(tx, rx),
                p.align.lag(tx, rx),
                p.subsample_align(rx[:4096], tx[:4096]),
                p.phase_align(rx, tx),
                p.SymbolAlign(C).calc_offset(tx[1700:]))
            for k, p in PKGS.items()}
    assert _eq(outs["port"], outs["ref"])
    assert outs["port"][2] == 37          # the RX lag
    nb = {k: m.normalise_burst(tx, rx) for k, m in
          (("port", t_dpdce), ("ref", j_dpdce))}
    assert _eq(nb["port"], nb["ref"])
    for m in (t_dpdce, j_dpdce):
        with pytest.raises(ValueError):
            m.normalise_burst(tx, np.zeros_like(rx))
    assert _eq(t_measure.normalise_rx(tx, rx), j_measure.normalise_rx(tx, rx))
    assert _eq(t_measure.phase_align_rx(tx, rx),
               j_measure.phase_align_rx(tx, rx))


@pytest.mark.parametrize("seed", [2, 3])
def test_statistics_and_models_match_reference(seed):
    tx, rx = _bursts(seed)
    txn, rxn = t_dpdce.normalise_burst(tx, rx)
    got = {}
    for k, p in PKGS.items():
        es = p.ExtractStatistic(peak_amplitude=1.0)
        stats = es.extract(txn, rxn)
        stats2 = es.extract(txn[::-1], rxn[::-1])
        poly = p.Poly(learning_rate_am=0.4, learning_rate_pm=0.3)
        poly.train(*stats2)
        poly.train(*stats2)
        lut = p.Lut(learning_rate=0.7)
        lut.train(txn, rxn)
        lut.train(rxn, txn)
        a = np.linspace(0, 1, 17)
        got[k] = (stats, stats2, es.n_meas, poly.coefs_am, poly.coefs_pm,
                  poly.am_am(a), poly.am_pm(a), poly.get_dpd_data(),
                  lut.lut, lut.scalefactor, lut.apply(txn),
                  lut.get_dpd_data())
    assert _eq(got["port"], got["ref"])
    assert got["port"][0][0].size >= 8


@pytest.mark.parametrize("kind", ["poly", "lut"])
def test_adapt_iteration_matches_reference(kind):
    tx, rx = _bursts(4)
    txn, rxn = t_dpdce.normalise_burst(tx, rx)
    got = {}
    for k, (p, m) in {"port": (t_dpd, t_dpdce),
                      "ref": (j_dpd, j_dpdce)}.items():
        model = p.Lut() if kind == "lut" else p.Poly()
        recs = [m.adapt_iteration(model, kind, m.get_learning_rate(i),
                                  txn, rxn) for i in range(3)]
        few = m.adapt_iteration(p.Poly(), "poly", 0.4, txn[:64], rxn[:64])
        got[k] = (recs, few, model.get_dpd_data())
    assert _eq(got["port"], got["ref"])
    assert all(r["state"] == "adapted" for r in got["port"][0])
    assert got["port"][1]["state"] == "too_few_bins"


def test_mer_and_shoulders_match_reference():
    rng = np.random.default_rng(11)
    burst = _dab_burst(24, rng)
    sym = _symbol_from_spectrum(_qpsk_carriers(C.FFT_delta, rng))
    noisy = sym + 0.01 * (rng.standard_normal(C.T_U)
                          + 1j * rng.standard_normal(C.T_U))
    pa = burst * (1 - 0.3 * np.abs(burst * 40) ** 2)
    got = {}
    for k, p in PKGS.items():
        c = p.DpdConfig(sample_rate=2_048_000)
        c4 = p.DpdConfig()
        ms = p.MeasureShoulders(c)
        got[k] = (p.Mer(c).calc_mer(sym), p.Mer(c).calc_mer(noisy),
                  ms.average_shoulders(burst, n_avg=8),
                  ms.average_shoulders(pa),
                  p.MeasureShoulders(c4).average_shoulders(
                      np.tile(burst, 5)[:c4.MS_FFT_size * 2], n_avg=4))
    assert _eq(got["port"], got["ref"])


def test_agc_loops_match_reference():
    """RxAgc and TxAgc of both packages, over the same fake RC and fake
    measurements: the same reports, gains and calls in the same order."""
    got = {}
    for k, p in PKGS.items():
        c = p.DpdConfig(sample_rate=2_048_000)
        runs = []
        for base in (0.005, 0.5, 1e-5):
            adapt = _FakeAdapt()
            meas = _FakeMeasure(adapt, base, np.random.default_rng(5))
            agc = p.RxAgc(meas, adapt, c)
            runs.append((agc.run(), agc.run(), adapt.calls, agc.rxgain))
        for med in (0.3, 0.01, c.TAGC_tx_median_target):
            adapt = _FakeAdapt(txgain=70.0, digital=1.0)
            runs.append((p.TxAgc(adapt, c).adapt_if_necessary(
                np.full(1000, med + 0j)), adapt.calls))
        adapt = _FakeAdapt(txgain=88.0)
        with pytest.raises(RuntimeError) as e:
            p.TxAgc(adapt, c).adapt_if_necessary(np.full(100, 0.3 + 0j))
        runs.append((str(e.value), adapt.calls))
        got[k] = runs
    assert _eq(got["port"], got["ref"])


def test_heuristics_match_reference():
    for i in range(-1, 25):
        assert t_dpd.get_learning_rate(i) == j_dpd.get_learning_rate(i)
        assert t_dpd.get_n_meas(i) == j_dpd.get_n_meas(i)


class _FakeRc:
    """ModRemoteControl's surface, recording every set and the bytes of
    the file a `poly coeffile` set names."""

    def __init__(self, endpoint, timeout_s=5.0):
        self.endpoint = endpoint
        self.sets = []
        self.files = []
        self.values = {("gain", "digital"): "1.0", ("sdr", "txgain"): "50",
                       ("sdr", "rxgain"): "30"}

    def get_param_value(self, module, param):
        return self.values[(module, param)]

    def set_param_value(self, module, param, value):
        self.sets.append((module, param, os.path.basename(str(value))))
        self.values[(module, param)] = str(value)
        if (module, param) == ("poly", "coeffile"):
            with open(value, "rb") as f:
                self.files.append(f.read())

    def close(self):
        pass


@pytest.fixture
def fake_rc(monkeypatch):
    """Both packages' Adapt build a _FakeRc instead of ModRemoteControl."""
    made = {}
    for k, mod in (("port", t_adapt), ("ref", j_adapt)):
        def factory(endpoint, timeout_s=5.0, k=k):
            made[k] = _FakeRc(endpoint, timeout_s)
            return made[k]
        monkeypatch.setattr(mod, "ModRemoteControl", factory)
    return made


def test_adapt_files_match_reference(tmp_path, fake_rc):
    """Both Adapts write the same coefficient and LUT files byte for byte,
    which both load_dpd_files read the same; the analog and digital gain
    calls and non-finite refusals match."""
    tx, rx = _bursts(6)
    txn, rxn = t_dpdce.normalise_burst(tx, rx)
    poly = t_dpd.Poly()
    t_dpdce.adapt_iteration(poly, "poly", 0.4, txn, rxn)
    lut = t_dpd.Lut()
    lut.train(txn, rxn)
    datas = [poly.get_dpd_data(), lut.get_dpd_data(),
             ("poly", np.float32([1, 0, 0, 0, 0]), np.zeros(5, np.float32)),
             ("lut", 2.0 ** 31, np.full(32, 0.9 - 0.1j, np.complex64))]
    got = {}
    for k, (mod, load) in {"port": (t_adapt, load_dpd_file),
                           "ref": (j_adapt, j_load_dpd_file)}.items():
        d = tmp_path / k
        d.mkdir()
        a = mod.Adapt("tcp://127.0.0.1:1", str(d / "dpd.coef"))
        loaded = []
        for data in datas:
            a.set_predistorter(data)
            loaded.append(load(str(d / "dpd.coef")))
        for bad in (("poly", np.float32([1, np.nan, 0, 0, 0]),
                     np.zeros(5)), ("lut", 1.0, np.full(32, np.inf)),
                    ("cubic", 1, 2)):
            with pytest.raises(ValueError):
                a.set_predistorter(bad)
        gains = (a.get_digital_gain(), a.get_txgain(), a.get_rxgain())
        a.set_digital_gain(0.5)
        a.set_txgain(41.5)
        a.set_rxgain(20)
        rc = fake_rc[k]
        got[k] = (rc.files, loaded, gains, rc.sets,
                  sorted(os.listdir(d)))
    assert _eq(got["port"], got["ref"])
    assert got["port"][1][0][0] == "poly" and got["port"][1][1][0] == "lut"
    assert got["port"][4] == ["dpd.coef"]


class _RecordedMeasure:
    """Hands out the same sequence of recorded bursts to every run_engine,
    an empty one among them (which the engine skips)."""

    bursts = None

    def __init__(self, host, port, n):
        self.k = 0

    def get_samples(self):
        tx, rx = self.bursts[self.k % len(self.bursts)]
        self.k += 1
        return tx, 1.0, rx, 1.0


@pytest.mark.parametrize("kind,lr", [("poly", None), ("lut", None),
                                     ("poly", 0.7)])
def test_run_engines_write_the_same_files(tmp_path, monkeypatch, fake_rc,
                                          kind, lr):
    """Both run_engines, fed the same recorded bursts through a fake
    Measure, write the same coefficient files at every iteration and
    report the same status records."""
    bursts = [_bursts(20 + i) for i in range(3)]
    bursts.insert(1, (np.zeros(0, np.complex64), np.zeros(0, np.complex64)))
    monkeypatch.setattr(_RecordedMeasure, "bursts", bursts)
    got = {}
    for k, mod in (("port", t_dpdce), ("ref", j_dpdce)):
        monkeypatch.setattr(mod, "Measure", _RecordedMeasure)
        status = []
        model = mod.run_engine("tcp://127.0.0.1:1", "127.0.0.1", 1,
                               iterations=5, samples_per_burst=1,
                               coef_path=str(tmp_path / f"{k}.coef"),
                               learning_rate=lr, sleep_s=0.0,
                               model_kind=kind, status_cb=status.append)
        got[k] = (fake_rc[k].files, status, model.get_dpd_data())
    assert _eq(got["port"], got["ref"])
    files, status, _ = got["port"]
    assert len(files) == 4
    assert [s["state"] for s in status] == ["adapted", "empty_burst"] + \
        ["adapted"] * 3


def test_signal_view_matches_reference():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(20000) + 1j * rng.standard_normal(20000))
    for fs, n in ((2_048_000, 2048), (8_192_000, 1024)):
        assert (t_gui.compute_signal_view(x, fs, fft_size=n)
                == j_gui.compute_signal_view(x, fs, fft_size=n))


# ---------------------------------------------------------------------------
# the copies' constants
# ---------------------------------------------------------------------------

COPIES = [(getattr(t_dpd, m), getattr(j_dpd, m)) for m in (
    "adapt", "agc", "align", "dpdce", "extract_statistic", "globalconfig",
    "heuristics", "measure", "mer", "model_lut", "model_poly", "server",
    "shoulders")] + [(t_gui, j_gui), (t_yamlrpc, j_yamlrpc),
                     (t_client, j_client), (t_racecheck, j_racecheck)]


def _constants(mod):
    """A module's own data: numbers, strings, tuples, lists, dicts and
    sets bound at module level (not classes, functions, modules, loggers
    or the thread-local store)."""
    kinds = (int, float, str, bytes, tuple, list, dict, frozenset, set)
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and isinstance(v, kinds)
            and not isinstance(v, bool)}


@pytest.mark.parametrize("port,ref", COPIES,
                         ids=[r.__name__ for _, r in COPIES])
def test_copied_constants_equal(port, ref):
    """Every constant of the original module is in the copy with the same
    value, and every public function and class of the original is in the
    copy with the same signature."""
    got, want = _constants(port), _constants(ref)
    assert set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        assert got[k] == v, k
    for name, obj in vars(ref).items():
        if (inspect.isfunction(obj) or inspect.isclass(obj)) \
                and obj.__module__ == ref.__name__:
            mine = getattr(port, name)
            if name in ("run_engine", "DpdceServer"):
                continue            # their default paths differ (below)
            assert (inspect.signature(mine)
                    == inspect.signature(obj)), name


@pytest.mark.parametrize("rate", [2_048_000, 4_096_000, 8_192_000,
                                  16_384_000])
def test_dpd_config_fields_equal(rate):
    assert (vars(t_globalconfig.DpdConfig(rate))
            == vars(j_globalconfig.DpdConfig(rate)))
    assert t_server.DpdceServer.DUMPS_KEPT == j_server.DpdceServer.DUMPS_KEPT
    assert t_model_lut.LUT_ENTRIES == j_model_lut.LUT_ENTRIES
    with pytest.raises(ValueError):
        t_globalconfig.DpdConfig(rate + 1000)


def test_default_paths_follow_tmpdir():
    """The one difference of dpdce.py and server.py from dabmod_tpu's:
    the default coefficient file and dump directory lie in
    tempfile.gettempdir() (TMPDIR), where dabmod_tpu's name /tmp; the
    other parameters are the same."""
    tmp = tempfile.gettempdir()
    assert t_dpdce.DEFAULT_COEF_PATH == os.path.join(
        tmp, "dabmod_tpu_poly.coef")
    for name, obj, paths in (
            ("run_engine", "run_engine", ("coef_path",)),
            ("DpdceServer", "DpdceServer", ("coef_path", "dump_dir"))):
        mod_t = t_dpdce if name == "run_engine" else t_server
        mod_j = j_dpdce if name == "run_engine" else j_server
        sig_t = inspect.signature(getattr(mod_t, obj)).parameters
        sig_j = inspect.signature(getattr(mod_j, obj)).parameters
        assert list(sig_t) == list(sig_j)
        for p in sig_t:
            if p in paths:
                assert os.path.dirname(sig_t[p].default) in (tmp, "") \
                    or sig_t[p].default == tmp
            else:
                assert sig_t[p] == sig_j[p], p
    assert inspect.signature(t_server.DpdceServer).parameters[
        "dump_dir"].default == tmp
