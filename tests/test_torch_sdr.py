"""The port's SDR sinks (dabmod_tpu_torch/io/sdr.py, a copy of
dabmod_tpu/io/sdr.py, and the copied vendor drivers uhd_driver.py,
soapy_driver.py, lime_driver.py, bladerf_driver.py, dexter_driver.py)
against dabmod_tpu's: the cases of tests/test_sdr_realtime.py,
tests/test_sdr_dpd.py (those that do not need dabmod_tpu/dpd/),
tests/test_wire_formats.py's SDR cases, tests/test_uhd_driver.py,
tests/test_soapy_driver.py and tests/test_vendor_drivers.py, each run on
both copies with the fakes of those files; the DPD feedback server spoken
to by a client of its wire protocol; the drivers' loaders without their
vendor libraries; open_sdr_output for every driver.
"""
import sys
import threading
import time
import types

import numpy as np
import pytest

from dabmod_tpu import runtime as j_runtime
from dabmod_tpu import timestamps as j_ts
from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.eti import synth_eti_batch
from dabmod_tpu.io import bladerf_driver as j_bladerf
from dabmod_tpu.io import dexter_driver as j_dexter
from dabmod_tpu.io import lime_driver as j_lime
from dabmod_tpu.io import outputs as j_outputs
from dabmod_tpu.io import sdr as j_sdr
from dabmod_tpu.io import soapy_driver as j_soapy
from dabmod_tpu.io import uhd_driver as j_uhd
from dabmod_tpu.rc import rcs as j_rcs
from dabmod_tpu_torch import runtime as t_runtime
from dabmod_tpu_torch import timestamps as t_ts
from dabmod_tpu_torch.config import ModSettings as TSettings
from dabmod_tpu_torch.io import bladerf_driver as t_bladerf
from dabmod_tpu_torch.io import dexter_driver as t_dexter
from dabmod_tpu_torch.io import lime_driver as t_lime
from dabmod_tpu_torch.io import outputs as t_outputs
from dabmod_tpu_torch.io import sdr as t_sdr
from dabmod_tpu_torch.io import soapy_driver as t_soapy
from dabmod_tpu_torch.io import uhd_driver as t_uhd
from dabmod_tpu_torch.rc import rcs as t_rcs
from live_stream import feedback_request, free_port
from test_sdr_realtime import (SAMPLE_RATE, TF_SAMPLES, TF_TICKS, SimClock)
from test_soapy_driver import make_mock as make_soapy_mock
from test_uhd_driver import FakeClock, FakeSensor, FakeUsrp, make_fake_uhd
from test_vendor_drivers import FakeClock as IioClock
from test_vendor_drivers import MockBladeRFModule, MockIioModule, MockLms

PKGS = {
    "dabmod_tpu": types.SimpleNamespace(
        sdr=j_sdr, uhd=j_uhd, soapy=j_soapy, lime=j_lime, bladerf=j_bladerf,
        dexter=j_dexter, ts=j_ts, outputs=j_outputs, Settings=JSettings,
        rcs=j_rcs, runtime=lambda s: j_runtime.ModRuntime(s),
        runtime_mod=j_runtime),
    "dabmod_tpu_torch": types.SimpleNamespace(
        sdr=t_sdr, uhd=t_uhd, soapy=t_soapy, lime=t_lime, bladerf=t_bladerf,
        dexter=t_dexter, ts=t_ts, outputs=t_outputs, Settings=TSettings,
        rcs=t_rcs, runtime=lambda s: t_runtime.ModRuntime(s, device="cpu"),
        runtime_mod=t_runtime),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _rc_servers_down():
    yield
    j_rcs.shutdown()
    t_rcs.shutdown()


def _wait(cond, timeout=5.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < timeout:
        time.sleep(0.02)
    assert cond()


# ---------------------------------------------------------------------------
# SdrOutput: tests/test_sdr_dpd.py, test_sdr_realtime.py, test_wire_formats.py
# ---------------------------------------------------------------------------

def test_sdr_output_unsync(pkg, tmp_path):
    dev = pkg.sdr.FileSdrDevice(str(tmp_path / "out.iq"))
    out = pkg.sdr.SdrOutput(dev, sync=False)
    frame = np.ones((1000, 2), np.float32)
    for _ in range(5):
        out.write(frame)
    _wait(lambda: out.frames == 5)
    out.close()
    data = np.fromfile(tmp_path / "out.iq", np.float32)
    assert data.size == 5 * 2000
    assert out.get_run_statistics()["underruns"] == 0


def test_sdr_sync_drops_late_frames(pkg):
    dev = pkg.sdr.LoopbackSdrDevice()
    out = pkg.sdr.SdrOutput(dev, sync=True)
    frame = np.ones((100, 2), np.float32)
    FT = pkg.ts.FrameTimestamp
    out.write(frame, FT(valid=True, seconds=int(time.time()) - 10, pps=0))
    out.write(frame, FT(valid=True, seconds=int(time.time()) + 2, pps=0))
    _wait(lambda: out.dropped == 1)
    _wait(lambda: out.frames == 1)
    out.close()


def test_sdr_batch_write_per_tf_timestamps(pkg):
    """A batched [B, N, 2] write with per-TF metadata becomes B queue
    entries, each gated on its own timestamp."""
    dev = pkg.sdr.LoopbackSdrDevice(history_frames=16)
    out = pkg.sdr.SdrOutput(dev, sync=True)
    B, N = 4, 100
    batch = np.arange(B * N * 2, dtype=np.float32).reshape(B, N, 2)
    now = int(time.time())
    meta = [(i, pkg.ts.FrameTimestamp(
        valid=True, seconds=now - 10 if i == 1 else now + 2, pps=i))
        for i in range(B)]
    out.write(batch, meta)
    _wait(lambda: out.frames == B - 1 and out.dropped == 1)
    out.close()
    assert [ts.pps for _, ts in dev._history] == [0, 2, 3]
    assert all(s.shape == (N, 2) for s, _ in dev._history)


def test_timestamp_decoder_batch_per_tf(pkg):
    dec = pkg.ts.TimestampDecoder()
    C, n = 4, 16
    frame_pps = int(0.024 * 16_384_000)
    ppss = [(i * frame_pps) % 16_384_000 for i in range(n)]
    ts_list = dec.update_eti_batch([i % 8 for i in range(n)], [0] * n, ppss,
                                   list(range(n)), C)
    assert [t.fct for t in ts_list] == [0, 4, 8, 12]
    assert [t.pps for t in ts_list] == [ppss[0], ppss[4], ppss[8], ppss[12]]


def test_sdr_queue_overflow(pkg):
    class SlowDevice(pkg.sdr.LoopbackSdrDevice):
        def transmit_frame(self, samples, ts):
            time.sleep(0.2)
            super().transmit_frame(samples, ts)
    out = pkg.sdr.SdrOutput(SlowDevice(), sync=False)   # queue bound = 8
    frame = np.ones((10, 2), np.float32)
    for _ in range(30):
        out.write(frame)
    assert out.queue_overflows > 0
    out._running = False
    out._thread.join(timeout=2)


def test_loopback_receive_unpacks_wire_words(pkg):
    dev = pkg.sdr.LoopbackSdrDevice()
    dev.txgain = dev.rxgain = 0.0
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=7, pps=0)
    pairs = (np.arange(64, dtype=np.int16).reshape(32, 2) * 100)
    words = (pairs[:, 1].astype(np.int32) << 16) \
        | (pairs[:, 0].astype(np.int32) & 0xFFFF)
    dev.transmit_frame(words, ts)
    rx, _ = dev.receive_frame(32, ts)
    np.testing.assert_allclose(rx, pairs.astype(np.float32) / 32768.0,
                               atol=1e-6)


class RealtimeSimDevice:
    """tests/test_sdr_realtime.py's device whose clock advances with the
    samples it transmits, on either package's SdrDevice."""

    @staticmethod
    def make(sdr_mod, clock):
        class Dev(sdr_mod.SdrDevice):
            def __init__(self):
                self.clock = clock
                self.tx_log = []

            def tune(self, lo_offset, frequency):
                pass

            def get_real_secs(self):
                return self.clock.now()

            def transmit_frame(self, samples, ts):
                n = int(np.asarray(samples).size // 2)
                self.tx_log.append((n, ts))
                self.clock.advance(n / SAMPLE_RATE)
        return Dev()


def test_sdr_realtime_soak(pkg):
    """At a 1x-rate device clock, 320 TFs (30.7 s of signal) with SFN
    timestamps go out with no drop, overflow, mute or discontinuity."""
    clock = SimClock()
    dev = RealtimeSimDevice.make(pkg.sdr, clock)
    out = pkg.sdr.SdrOutput(dev, sync=True, sample_rate=SAMPLE_RATE)
    clock_start = clock.now()
    n_frames = 320
    frame = np.zeros((TF_SAMPLES, 2), np.float32)
    t0 = clock.now() + 0.5
    sec0, ticks0 = int(t0), int(round((t0 - int(t0)) * 16_384_000))
    deadline = time.monotonic() + 60
    for i in range(n_frames):
        ticks = ticks0 + i * TF_TICKS
        ts = pkg.ts.FrameTimestamp(
            valid=True, seconds=sec0 + ticks // 16_384_000,
            pps=ticks % 16_384_000, fct=(i * 4) % 250)
        while ts.as_seconds() - clock.now() > 5.0:
            assert time.monotonic() < deadline, "device clock stalled"
            time.sleep(0.001)
        out.write(frame, ts)
    while len(dev.tx_log) < n_frames:
        assert time.monotonic() < deadline, "device starved / frames stuck"
        time.sleep(0.005)
    out._running = False
    out._thread.join(timeout=5)
    assert out.fault is None
    assert (out.dropped, out.queue_overflows, out.muted, out.underruns,
            out.timestamp_discontinuities) == (0, 0, 0, 0, 0)
    assert out.frames == n_frames
    times = [ts.as_seconds() for _, ts in dev.tx_log]
    np.testing.assert_allclose(np.diff(times), TF_SAMPLES / SAMPLE_RATE,
                               atol=1e-9)
    assert abs((clock.now() - clock_start)
               - n_frames * TF_SAMPLES / SAMPLE_RATE) < 1e-6


def test_sdr_realtime_late_frame_dropped(pkg):
    clock = SimClock()
    dev = RealtimeSimDevice.make(pkg.sdr, clock)
    out = pkg.sdr.SdrOutput(dev, sync=True, sample_rate=SAMPLE_RATE)
    frame = np.zeros((TF_SAMPLES, 2), np.float32)
    FT = pkg.ts.FrameTimestamp
    late = FT(valid=True, seconds=int(clock.now()) - 10, pps=0)
    ok = FT(valid=True, seconds=int(clock.now()) + 1, pps=0)
    out.write(frame, late)
    out.write(frame, ok)
    _wait(lambda: out.frames >= 1, 10)
    out._running = False
    out._thread.join(timeout=5)
    assert out.dropped == 1 and out.frames == 1
    assert dev.tx_log[0][1].seconds == ok.seconds


def test_sc16_pairs_roundtrip(pkg):
    pairs = np.array([[100, -100], [32767, -32768]], np.int16)
    packed = pairs.reshape(-1).view(np.int32)
    np.testing.assert_array_equal(pkg.sdr.sc16_pairs(packed), pairs)
    assert pkg.sdr.n_complex_samples(packed) == 2
    assert pkg.sdr.n_complex_samples(pairs.astype(np.float32)) == 2
    np.testing.assert_allclose(pkg.sdr.f32_pairs_from_wire(packed),
                               pairs / 32768.0)


def test_sdr_output_splits_packed_batches(pkg):
    dev = pkg.sdr.LoopbackSdrDevice()
    out = pkg.sdr.SdrOutput(dev, sync=False, sample_rate=2_048_000)
    B, N = 3, 64
    pairs = np.arange(B * N * 2, dtype=np.int16).reshape(B, N, 2)
    packed = np.ascontiguousarray(pairs).reshape(B, -1).view(np.int32)
    out.write(packed, [(i, None) for i in range(B)])
    _wait(lambda: len(dev._history) == B)
    np.testing.assert_array_equal(pkg.sdr.sc16_pairs(dev._history[0][0]),
                                  pairs[0])
    out.close()


def test_sdr_counters_add_up_under_overflow(pkg):
    """The unsynced queue holds 8 TFs and a batch pushes 24 at once: what
    is not transmitted is counted, frames + queue_overflows + dropped +
    muted == the TFs written, and the transmitted TFs are the batch's
    last ones, in order (push_overflow evicts the oldest)."""
    gate = threading.Event()

    class Gated(pkg.sdr.LoopbackSdrDevice):
        def transmit_frame(self, samples, ts):
            gate.wait(5)
            super().transmit_frame(samples, ts)
    dev = Gated(history_frames=64)
    out = pkg.sdr.SdrOutput(dev, sync=False)
    B = 24
    batch = np.arange(B * 8 * 2, dtype=np.float32).reshape(B, 8, 2)
    out.write(batch, [(4 * i, pkg.ts.FrameTimestamp(fct=4 * i))
                      for i in range(B)])
    gate.set()
    _wait(lambda: out.queue.empty() and out.frames + out.queue_overflows
          == B)
    out.close()
    assert out.frames + out.queue_overflows + out.dropped + out.muted == B
    assert out.queue_overflows >= B - 9
    sent = [ts.fct for _, ts in dev._history]
    assert sent == sorted(sent) and sent[-1] == 4 * (B - 1)


# ---------------------------------------------------------------------------
# the DPD feedback server, spoken to by a client of its wire protocol
# (dabmod_tpu/io/sdr.py:406-491; the protocol of python/dpd/Measure.py)
# ---------------------------------------------------------------------------

def _pa_model(x):
    m2 = np.abs(x) ** 2
    return (x * (1.0 - 0.2 * m2) * np.exp(1j * 0.15 * m2)).astype(
        np.complex64)


def test_feedback_server_protocol(pkg):
    """The server answers a request with the next TX frame's first n
    samples and their timestamp, and the loopback's RX of that frame:
    pa_model(TX) * 10**((txgain + rxgain) / 20)."""
    dev = pkg.sdr.LoopbackSdrDevice(pa_model=_pa_model)
    dev.set_txgain(6.0)
    dev.set_rxgain(-2.0)
    server = pkg.sdr.DpdFeedbackServer(dev, port=0, sample_rate=2_048_000)
    try:
        rng = np.random.default_rng(5)
        n = 2000
        iq = (rng.standard_normal((n + 100, 2)) * 0.25).astype(np.float32)
        ts = pkg.ts.FrameTimestamp(valid=True, seconds=1000, pps=4096)
        dev.transmit_frame(iq, ts)
        result = {}
        t = threading.Thread(target=lambda: result.update(
            r=feedback_request(server.port, n)))
        t.start()
        for _ in range(100):
            server.set_tx_frame(iq, ts)
            time.sleep(0.02)
            if not t.is_alive():
                break
        t.join(timeout=10)
        got, tx_key, tx, rx_key, rx = result["r"]
        assert got == n and tx_key == rx_key == (1000, 4096)
        np.testing.assert_array_equal(tx, iq[:n])
        x = _pa_model(iq[:n, 0] + 1j * iq[:n, 1]) * 10 ** (4.0 / 20)
        np.testing.assert_allclose(rx[:, 0] + 1j * rx[:, 1], x, rtol=1e-5,
                                   atol=1e-6)
        # another version byte: the server closes without a reply
        assert feedback_request(server.port, n, b"\x02") is None
    finally:
        server.stop()


def test_feedback_server_pads_a_short_rx(pkg):
    """A device that receives fewer samples than asked is padded with
    zeros: the header announces n for both streams."""
    class Short(pkg.sdr.LoopbackSdrDevice):
        def receive_frame(self, num_samples, ts):
            return np.ones((num_samples // 2, 2), np.float32), ts
    dev = Short()
    server = pkg.sdr.DpdFeedbackServer(dev, port=0, sample_rate=2_048_000)
    try:
        iq = np.full((64, 2), 0.5, np.float32)
        ts = pkg.ts.FrameTimestamp(valid=True, seconds=3, pps=0)
        result = {}
        t = threading.Thread(target=lambda: result.update(
            r=feedback_request(server.port, 64)))
        t.start()
        for _ in range(100):
            server.set_tx_frame(iq, ts)
            time.sleep(0.02)
            if not t.is_alive():
                break
        t.join(timeout=10)
        got, _, tx, _, rx = result["r"]
        assert got == 64 and rx.shape == (64, 2)
        np.testing.assert_array_equal(rx[:32], 1.0)
        np.testing.assert_array_equal(rx[32:], 0.0)
    finally:
        server.stop()


def test_sdr_output_feeds_the_feedback_server(pkg):
    """SdrOutput hands each timestamped frame to its feedback server,
    wire words as f32 pairs at int16 full scale."""
    dev = pkg.sdr.LoopbackSdrDevice()
    port = free_port()
    out = pkg.sdr.SdrOutput(dev, sync=False, feedback_port=port)
    try:
        pairs = (np.arange(256, dtype=np.int16).reshape(128, 2) * 64)
        words = np.ascontiguousarray(pairs).reshape(-1).view(np.int32)
        ts = pkg.ts.FrameTimestamp(valid=True, seconds=9, pps=0)
        result = {}
        t = threading.Thread(target=lambda: result.update(
            r=feedback_request(port, 100)))
        t.start()
        for _ in range(100):
            out.write(words, ts)
            time.sleep(0.02)
            if not t.is_alive():
                break
        t.join(timeout=10)
        got, tx_key, tx, _, _ = result["r"]
        assert got == 100 and tx_key == (9, 0)
        np.testing.assert_allclose(tx, pairs[:100] / 32768.0)
    finally:
        out.close()


# ---------------------------------------------------------------------------
# UHD: tests/test_uhd_driver.py
# ---------------------------------------------------------------------------

def make_uhd(pkg, **conf_kw):
    clock = FakeClock()
    fake_uhd, holder = make_fake_uhd(clock)
    conf = pkg.uhd.UhdConfig(sample_rate=2_048_000, frequency=222_064_000,
                             **conf_kw)
    dev = pkg.uhd.UhdDevice(conf, uhd_module=fake_uhd, time_fn=clock.time,
                            sleep_fn=clock.sleep)
    return dev, holder["usrp"], clock


def test_uhd_device_setup(pkg):
    dev, usrp, _ = make_uhd(pkg, refclk_src="external", pps_src="external",
                            txgain=30.0)
    assert usrp.clock_source == "external" == usrp.time_source
    assert usrp.tx_rate == 2_048_000
    assert dev.frequency == 222_064_000 and dev.get_txgain() == 30.0
    assert usrp.time_sets and usrp.time_sets[0][0] == "pps"
    dev.close()


def test_uhd_timed_send_chunks_and_advancing_timespec(pkg):
    dev, usrp, _ = make_uhd(pkg, enable_sync=True)
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=5000, pps=8_192_000)
    dev.transmit_frame(np.ones((2500, 2), np.float32), ts)
    sends = usrp.tx_stream.sends
    assert [s[0] for s in sends] == [1000, 1000, 500]
    assert all(s[1] for s in sends)
    t0, dt = 5000.5, 1000 / 2_048_000
    np.testing.assert_allclose([s[2] for s in sends],
                               [t0, t0 + dt, t0 + 2 * dt], rtol=0, atol=1e-9)
    assert not any(s[3] for s in sends)
    dev.close()


def test_uhd_eob_after_timestamp_refresh(pkg):
    dev, usrp, _ = make_uhd(pkg, enable_sync=True)
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=5000, pps=0)
    dev.require_timestamp_refresh()
    dev.transmit_frame(np.ones((800, 2), np.float32), ts)
    assert usrp.tx_stream.sends[-1][3] is True
    dev.transmit_frame(np.ones((800, 2), np.float32), ts)
    assert usrp.tx_stream.sends[-1][3] is False
    dev.close()


def test_uhd_unsync_send_has_no_timespec(pkg):
    dev, usrp, _ = make_uhd(pkg, enable_sync=False)
    dev.transmit_frame(np.ones((100, 2), np.float32), None)
    assert usrp.tx_stream.sends == [(100, False, None, False)]
    dev.close()


def test_uhd_sends_wire_words_as_sc16(pkg):
    """Packed s16 wire words (kiss, or a device-converted stream) go out
    as their int16 pairs, not as float amplitudes."""
    dev, usrp, _ = make_uhd(pkg, enable_sync=False)
    pairs = np.arange(200, dtype=np.int16).reshape(100, 2)
    dev.transmit_frame(np.ascontiguousarray(pairs).reshape(-1).view(
        np.int32), None)
    assert usrp.tx_stream.sends == [(100, False, None, False)]
    dev.close()


def test_uhd_receive_frame_timed(pkg):
    dev, usrp, _ = make_uhd(pkg)
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=123, pps=0)
    rx, rx_ts = dev.receive_frame(64, ts)
    assert rx.shape == (64, 2)
    cmd = usrp.rx_stream.cmds[-1]
    assert cmd.num_samps == 64 and cmd.stream_now is False
    assert cmd.time_spec.get_real_secs() == 123.0 and rx_ts.seconds == 123
    dev.close()


@pytest.mark.parametrize("behaviour", ["crash", "ignore"])
def test_refclk_lock_lost(pkg, behaviour):
    dev, usrp, _ = make_uhd(pkg, refclk_src="external", pps_src="none",
                            refclk_lock_loss_behaviour=behaviour)
    assert dev.is_clk_source_ok()
    usrp.sensors["ref_locked"] = FakeSensor(False)
    if behaviour == "crash":
        with pytest.raises(pkg.uhd.RefclkLockLost):
            dev.is_clk_source_ok()
    else:
        assert dev.is_clk_source_ok() is False
    dev.close()


def test_gpsdo_bootup_gates_until_fix(pkg):
    clock = FakeClock()
    fake_uhd, holder = make_fake_uhd(clock)
    pre = FakeUsrp(clock)

    def multi(args):
        pre.sensors["gps_locked"] = FakeSensor(False)
        return pre
    fake_uhd.usrp.MultiUSRP = multi
    dev = pkg.uhd.UhdDevice(
        pkg.uhd.UhdConfig(refclk_src="gpsdo-ettus", pps_src="gpsdo",
                          max_gps_holdover_time=30.0),
        uhd_module=fake_uhd, time_fn=clock.time, sleep_fn=clock.sleep)
    ut = dev.device_time
    assert ut.gps_state == pkg.uhd.UsrpTime.BOOTUP
    assert dev.is_clk_source_ok() is False
    assert ut.get_gnss_stats()["holdover"] is True
    pre.sensors["gps_locked"] = FakeSensor(True)
    clock.sleep(pkg.uhd.GPS_FIX_CHECK_INTERVAL)
    assert dev.is_clk_source_ok() is True
    assert ut.gps_state == pkg.uhd.UsrpTime.MONITOR
    assert any(kind == "pps" for kind, _ in pre.time_sets)
    assert ut.get_gnss_stats()["holdover"] is False
    dev.close()


def test_gpsdo_holdover_then_fix_lost(pkg):
    dev, usrp, clock = make_uhd(pkg, refclk_src="gpsdo-ettus",
                                pps_src="gpsdo", max_gps_holdover_time=25.0)
    assert dev.device_time.gps_state == pkg.uhd.UsrpTime.MONITOR
    assert dev.is_clk_source_ok()
    usrp.sensors["gps_locked"] = FakeSensor(False)
    for _ in range(2):
        clock.sleep(pkg.uhd.GPS_FIX_CHECK_INTERVAL)
        assert dev.is_clk_source_ok() is True
    clock.sleep(pkg.uhd.GPS_FIX_CHECK_INTERVAL)
    with pytest.raises(pkg.uhd.GpsFixLost):
        dev.is_clk_source_ok()
    dev.close()


def test_gpsdo_fix_recovers_in_holdover(pkg):
    dev, usrp, clock = make_uhd(pkg, refclk_src="gpsdo-ettus",
                                pps_src="gpsdo", max_gps_holdover_time=100.0)
    usrp.sensors["gps_locked"] = FakeSensor(False)
    clock.sleep(pkg.uhd.GPS_FIX_CHECK_INTERVAL)
    assert dev.is_clk_source_ok()
    assert dev.device_time.num_checks_without_fix == 1
    usrp.sensors["gps_locked"] = FakeSensor(True)
    clock.sleep(pkg.uhd.GPS_FIX_CHECK_INTERVAL)
    assert dev.is_clk_source_ok()
    assert dev.device_time.num_checks_without_fix == 0
    dev.close()


def test_sdr_output_mute_no_timestamps(pkg):
    out = pkg.sdr.SdrOutput(pkg.sdr.LoopbackSdrDevice(), sync=True,
                            mute_no_timestamps=True)
    frame = np.ones((100, 2), np.float32)
    out.write(frame, pkg.ts.FrameTimestamp(valid=False))
    out.write(frame, pkg.ts.FrameTimestamp(
        valid=True, seconds=int(time.time()) + 2, pps=0))
    _wait(lambda: (out.muted, out.frames) == (1, 1))
    out.close()


def test_sdr_output_clk_gating_and_fault(pkg):
    class GatedDevice(pkg.sdr.LoopbackSdrDevice):
        ok = False
        crash = False

        def is_clk_source_ok(self):
            if self.crash:
                raise pkg.uhd.GpsFixLost("lost GPS fix for 40 seconds")
            return self.ok

    dev = GatedDevice()
    out = pkg.sdr.SdrOutput(dev, sync=False)
    frame = np.ones((10, 2), np.float32)
    out.write(frame)
    _wait(lambda: out.muted == 1)
    assert out.frames == 0
    dev.ok = True
    out.write(frame)
    _wait(lambda: out.frames == 1)
    dev.crash = True
    out.write(frame)
    _wait(lambda: out.fault is not None)
    assert isinstance(out.fault, pkg.uhd.GpsFixLost)
    out._thread.join(timeout=2)


def test_gpsdo_stats_flow_to_rc(pkg, tmp_path, monkeypatch):
    """The GPSDO's satellites, holdover and state and the hardware clock
    are parameters of the `sdr` RC module."""
    dev, usrp, clock = make_uhd(pkg, refclk_src="gpsdo", pps_src="gpsdo",
                                max_gps_holdover_time=30.0)
    usrp.sensors["gps_timelock"] = FakeSensor("TIME LOCKED")
    usrp.sensors["gps_gngga"] = FakeSensor(
        "$GNGGA,120000.00,4717.11,N,00833.91,E,1,07,1.0,430.0,M,48.0,M,,")
    assert dev.is_clk_source_ok()
    out = pkg.sdr.SdrOutput(dev, sync=False, sample_rate=2_048_000)
    monkeypatch.setattr(pkg.runtime_mod, "open_output", lambda s: out)
    inp = tmp_path / "in.eti"
    inp.write_bytes(synth_eti_batch(4, mode=1).tobytes())
    rt = pkg.runtime(pkg.Settings(input_name=str(inp), output="uhd",
                                  output_name="", batch_tf=1))
    try:
        get = pkg.rcs.get_param
        assert get("sdr", "gpsdo_num_sv") == "7"
        assert get("sdr", "gpsdo_holdover") == "0"
        assert get("sdr", "gps_state") == "monitor_fix"
        assert float(get("sdr", "device_time")) > 0
        usrp.sensors["gps_timelock"] = FakeSensor("TIME UNLOCKED")
        clock.sleep(pkg.uhd.GPS_FIX_CHECK_INTERVAL)
        dev.is_clk_source_ok()
        assert get("sdr", "gpsdo_holdover") == "1"
    finally:
        rt.close()


# ---------------------------------------------------------------------------
# Soapy: tests/test_soapy_driver.py
# ---------------------------------------------------------------------------

def make_soapy(pkg, **conf_kw):
    conf = pkg.soapy.SoapyConfig(device_args="driver=fake",
                                 sample_rate=2_048_000,
                                 frequency=222_064_000.0, txgain=30.0,
                                 rxgain=10.0, **conf_kw)
    dev = pkg.soapy.SoapyDevice(conf, soapy_module=make_soapy_mock(),
                                time_fn=lambda: 123.0)
    return dev, dev.dev


def test_soapy_constructor_configures_device(pkg):
    dev, fake = make_soapy(pkg, master_clock_rate=32_768_000.0,
                           bandwidth=1_750_000.0, tx_antenna="BAND2",
                           rx_antenna="LNAL")
    assert fake.master_clock_rate == 32_768_000.0
    assert fake.rates == {0: 2_048_000, 1: 2_048_000}
    assert fake.gains == {0: 30.0, 1: 10.0}
    assert fake.antennas == {0: "BAND2", 1: "LNAL"}
    assert fake.bandwidths == {0: 1_750_000.0, 1: 1_750_000.0}
    assert dev.frequency == 222_064_000.0
    assert fake.hardware_time_ns == int(123.0 * 1e9)
    assert dev.get_real_secs() == 123.0


def test_soapy_tune_passes_lo_offset_arg(pkg):
    dev, fake = make_soapy(pkg)
    dev.tune(10_000.0, 220_352_000.0)
    assert fake.freqs[0] == (220_352_000.0, {"OFFSET": "10000.0"})


def test_soapy_transmit_unsynchronised_chunks_at_mtu(pkg):
    dev, fake = make_soapy(pkg)
    samples = np.zeros((2500, 2), np.float32)
    dev.transmit_frame(samples, None)
    assert fake.activations == [(("stream", 0), 0, 0, 0)]
    assert [w[0] for w in fake.writes] == [1000, 1000, 500]
    assert dev.num_frames_modulated == 1
    dev.transmit_frame(samples, None)
    assert len(fake.activations) == 1


def test_soapy_transmit_timed_burst_advances_time_ns(pkg):
    dev, fake = make_soapy(pkg, enable_sync=True)
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=100, pps=8_192_000)
    dev.transmit_frame(np.zeros((2048, 2), np.float32), ts)
    (stream, flags, t0, _), = fake.activations
    assert flags == pkg.soapy.SOAPY_SDR_HAS_TIME
    assert t0 == int(100.5 * 1e9)
    assert fake.writes[0][2] == t0
    assert fake.writes[1][2] == t0 + int(1e9 * 1000 / 2_048_000)


def test_soapy_timestamp_refresh_deactivates_stream(pkg):
    dev, fake = make_soapy(pkg, enable_sync=True)
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=100, pps=0)
    dev.transmit_frame(np.zeros((500, 2), np.float32), ts)
    assert not fake.deactivations
    dev.require_timestamp_refresh()
    dev.transmit_frame(np.zeros((500, 2), np.float32), ts)
    assert len(fake.deactivations) == 1
    dev.transmit_frame(np.zeros((500, 2), np.float32), ts)
    assert len(fake.activations) == 2


def test_soapy_muting_sends_eob_and_stops(pkg):
    dev, fake = make_soapy(pkg)
    dev.muting = True
    dev.transmit_frame(np.zeros((2500, 2), np.float32), None)
    assert [w[0] for w in fake.writes] == [1000]
    assert len(fake.deactivations) == 1


def test_soapy_flow_error_counters(pkg):
    dev, fake = make_soapy(pkg)
    fake.write_script = [pkg.soapy.SOAPY_SDR_TIMEOUT,
                         pkg.soapy.SOAPY_SDR_OVERFLOW,
                         pkg.soapy.SOAPY_SDR_UNDERFLOW]
    dev.transmit_frame(np.zeros((800, 2), np.float32), None)
    assert (dev.timeouts, dev.overflows, dev.underflows) == (1, 1, 1)
    assert [w[0] for w in fake.writes] == [800]
    stats = dev.get_run_statistics()
    assert stats["timeouts"] == 1 and stats["underruns"] == 1


def test_soapy_stream_error_raises(pkg):
    dev, fake = make_soapy(pkg)
    fake.write_script = [-2]
    with pytest.raises(RuntimeError, match="stream error"):
        dev.transmit_frame(np.zeros((100, 2), np.float32), None)


def test_soapy_receive_frame_timed_burst(pkg):
    dev, fake = make_soapy(pkg)
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=50, pps=0)
    rx, rx_ts = dev.receive_frame(256, ts)
    (stream, flags, t_ns, n), = [a for a in fake.activations
                                 if a[0] == ("stream", 1)]
    assert n == 256 and t_ns == int(50 * 1e9)
    assert rx.shape == (256, 2)
    assert ("stream", 1) in fake.deactivations
    assert rx_ts.valid and rx_ts.seconds == 50


# ---------------------------------------------------------------------------
# Lime, BladeRF, Dexter: tests/test_vendor_drivers.py
# ---------------------------------------------------------------------------

def make_lime(pkg, **kw):
    lms = MockLms()
    conf = pkg.lime.LimeConfig(sample_rate=2_048_000, frequency=222_064_000,
                               txgain=70.0, **kw)
    return pkg.lime.LimeDevice(conf, lms=lms), lms


def test_lime_construction_sequence(pkg):
    dev, lms = make_lime(pkg, master_clock_rate=122.88e6)
    assert [c[0] for c in lms.calls][:3] == ["open", "reset", "init"]
    assert ("enable_channel", lms.LMS_CH_TX, 0, True) in lms.calls
    assert ("set_gfir_coeff", lms.LMS_GFIR3, 61) in lms.calls
    assert ("enable_gfir", lms.LMS_GFIR3, True) in lms.calls
    assert ("setup_stream", 196_608 * 10, "i16") in lms.calls
    assert lms.streaming and lms.clock_freq == 122.88e6
    assert lms.gain == pytest.approx(0.70)
    assert dev.frequency == 222_064_000


def test_lime_txgain_normalised_roundtrip(pkg):
    dev, lms = make_lime(pkg)
    dev.set_txgain(55.0)
    assert lms.gain == pytest.approx(0.55)
    assert dev.get_txgain() == pytest.approx(55.0)


def test_lime_float_to_s16_conversion_and_send(pkg):
    dev, lms = make_lime(pkg)
    samples = np.array([[0.5, -0.5], [2.0, -2.0], [0.25, 1.0]], np.float32)
    dev.transmit_frame(samples, None)
    np.testing.assert_array_equal(
        lms.sent[0], np.array([16384, -16384, 32767, -32767, 8192, 32767],
                              np.int16))
    assert dev.num_frames_modulated == 1


def test_lime_stream_status_accumulates(pkg):
    dev, lms = make_lime(pkg)
    lms.stream_status.update(underrun=2, overrun=1, dropped_packets=3,
                             fifo_filled_count=50, fifo_size=200)
    dev.transmit_frame(np.zeros((16, 2), np.float32), None)
    lms.stream_status.update(underrun=1)
    dev.transmit_frame(np.zeros((16, 2), np.float32), None)
    stats = dev.get_run_statistics()
    assert (stats["underruns"], stats["overruns"], stats["dropped_packets"],
            stats["frames"]) == (3, 2, 6, 2)
    assert stats["fifo_fill"] == pytest.approx(25.0)


def test_lime_close_teardown_order(pkg):
    dev, lms = make_lime(pkg)
    lms.calls.clear()
    dev.close()
    assert not lms.streaming
    assert lms.calls[-2:] == [("enable_channel", lms.LMS_CH_TX, 0, False),
                              ("close",)]


def make_bladerf(pkg, **kw):
    mod = MockBladeRFModule()
    conf = pkg.bladerf.BladeRFConfig(sample_rate=2_048_000,
                                     frequency=222_064_000, txgain=30.0,
                                     bandwidth=1_750_000, **kw)
    return pkg.bladerf.BladeRFDevice(conf, bladerf_module=mod), mod.dev


def test_bladerf_construction(pkg):
    dev, brf = make_bladerf(pkg, refclk_src="pps")
    ch = brf.channels[("tx", 0)]
    assert brf.tamer_mode == "1pps"
    assert (ch.sample_rate, ch.gain, ch.bandwidth, ch.enable) == (
        2_048_000, 30, 1_750_000, True)
    assert ("sync_config", "tx_x1", "sc16_q11", 16, 8192, 8, 3500) \
        in brf.calls


def test_bladerf_refclk_10mhz(pkg):
    dev, brf = make_bladerf(pkg, refclk_src="10mhz")
    assert brf.tamer_mode == "10mhz"


def test_bladerf_lo_offset_forced_to_zero(pkg):
    dev, brf = make_bladerf(pkg, lo_offset=10_000.0)
    assert dev.lo_offset == 0.0 and dev.conf.lo_offset == 0.0
    assert brf.channels[("tx", 0)].frequency == 222_064_000


def test_bladerf_transmit_sc16_q11(pkg):
    dev, brf = make_bladerf(pkg)
    samples = np.array([[100.4, -100.4], [5000.0, -5000.0]], np.float32)
    dev.transmit_frame(samples, None)
    np.testing.assert_array_equal(
        brf.tx[0], np.array([100, -100, 2047, -2048], np.int16))
    assert dev.get_run_statistics() == {"frames": 1}


def test_bladerf_driver_accepts_packed_i32(pkg):
    dev, brf = make_bladerf(pkg)
    pairs = np.array([[100, -100], [2047, -2048]], np.int16)
    dev.transmit_frame(pairs.reshape(-1).view(np.int32), None)
    np.testing.assert_array_equal(brf.tx[0], pairs.reshape(-1))


def test_bladerf_gain_and_temperature(pkg):
    dev, brf = make_bladerf(pkg)
    dev.set_txgain(12.0)
    assert dev.get_txgain() == 12.0
    assert dev.get_temperature() == 55.0


def make_dexter(pkg, **kw):
    clock = IioClock()
    mod = MockIioModule(clock)
    conf = pkg.dexter.DexterConfig(frequency=222_064_000, lo_offset=64_000,
                                   txgain=60.0, **kw)
    dev = pkg.dexter.DexterDevice(conf, iio_module=mod, time_fn=clock.time,
                                  sleep_fn=clock.sleep, underflow_poll=False)
    return dev, mod, clock


def test_dexter_rejects_non_native_rate(pkg):
    clock = IioClock()
    with pytest.raises(RuntimeError, match="2048000"):
        pkg.dexter.DexterDevice(pkg.dexter.DexterConfig(sample_rate=4_096_000),
                                iio_module=MockIioModule(clock),
                                time_fn=clock.time, sleep_fn=clock.sleep,
                                underflow_poll=False)


def test_dexter_construction(pkg):
    dev, mod, clock = make_dexter(pkg)
    a = mod.dsp.attrs
    assert a["dc0"].value == "0" and a["dc1"].value == "0"
    assert a["stream0_flush_fifo_trigger"].writes == ["1"]
    assert a["stream0_start_clks"].writes[0] == "0"
    assert mod.ad9957.attrs["center_frequency"].value == "222000000"
    assert a["frequency0"].value == "64000"
    assert dev.get_tx_freq() == 222_064_000
    assert mod.ad9957_tx0.channels[0].enabled
    assert len(mod.buffers[0].pushed) == 1
    assert set(mod.buffers[0].pushed[0]) == {0}
    assert a["gain0"].writes[-1] == "60"


def test_dexter_clock_state_machine(pkg):
    D = pkg.dexter
    dev, mod, clock = make_dexter(pkg, enable_sync=True,
                                  max_gps_holdover_time=30.0)
    assert dev.is_clk_source_ok() is False
    assert dev.clock_state == D.STATE_STARTUP
    mod.dsp.attrs["gpsdo_locked"].value = "1"
    assert dev.is_clk_source_ok() is True
    assert dev.clock_state == D.STATE_NORMAL
    assert dev._clock_count_at_startup == int(clock.time()) * D.DSP_CLOCK
    assert dev.get_real_secs() == pytest.approx(clock.time(), abs=1e-3)
    mod.dsp.attrs["pps_loss_of_signal"].value = "1"
    assert dev.is_clk_source_ok() is True
    assert dev.clock_state == D.STATE_HOLDOVER
    stats = dev.get_run_statistics()
    assert stats["clock_state"] == "holdover"
    assert stats["remaining_holdover_s"] == 30
    clock.sleep(31.0)
    assert dev.is_clk_source_ok() is False
    assert dev.clock_state == D.STATE_STARTUP


def _locked_dexter(pkg):
    dev, mod, clock = make_dexter(pkg, enable_sync=True,
                                  max_gps_holdover_time=30.0)
    mod.dsp.attrs["gpsdo_locked"].value = "1"
    assert dev.is_clk_source_ok()
    return dev, mod, clock


def _dexter_frame(pkg):
    return np.full((pkg.dexter.TRANSMISSION_FRAME_LEN_SAMPS // 2, 2), 100.0,
                   np.float32)


def test_dexter_timed_transmit_start_clks(pkg):
    D = pkg.dexter
    dev, mod, clock = _locked_dexter(pkg)
    t0 = int(clock.time())
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=t0 + 2, pps=16_384, fct=0)
    dev.transmit_frame(_dexter_frame(pkg), ts)
    expected = ((ts.seconds - dev._utc_seconds_at_startup) * D.DSP_CLOCK
                + dev._clock_count_at_startup + 16_384 * 10)
    assert mod.dsp.attrs["stream0_start_clks"].writes[-1] == str(expected)
    assert len(mod.buffers[0].pushed) == 1 + D.IIO_BUFFERS
    assert dev.num_frames_modulated == 1 and dev._channel_is_up


def test_dexter_short_margin_skips_frame(pkg):
    dev, mod, clock = _locked_dexter(pkg)
    ts = pkg.ts.FrameTimestamp(valid=True, seconds=int(clock.time()), pps=0,
                               fct=0)
    dev.transmit_frame(_dexter_frame(pkg), ts)
    assert dev.num_late == 1 and dev.num_frames_modulated == 0
    assert not dev._channel_is_up


def test_dexter_invalid_frame_length_raises(pkg):
    dev, mod, clock = make_dexter(pkg)
    with pytest.raises(RuntimeError, match="invalid buffer size"):
        dev.transmit_frame(np.zeros((100, 2), np.float32), None)


def test_dexter_timestamp_refresh_downs_channel(pkg):
    D = pkg.dexter
    dev, mod, clock = _locked_dexter(pkg)
    t0 = int(clock.time())
    FT = pkg.ts.FrameTimestamp
    dev.transmit_frame(_dexter_frame(pkg), FT(valid=True, seconds=t0 + 2,
                                              pps=0, fct=0))
    assert dev._channel_is_up
    base = [0]
    mod.dsp.attrs["buffer_underflows0"]._read_fn = lambda: base[0]
    dev.require_timestamp_refresh()
    base[0] = 1
    dev.transmit_frame(_dexter_frame(pkg), FT(valid=True, seconds=t0 + 4,
                                              pps=0, fct=1))
    assert "0" in mod.dsp.attrs["gain0"].writes[-3:]
    assert not dev._channel_is_up and dev.num_frames_modulated == 1
    ts3 = FT(valid=True, seconds=t0 + 6, pps=0, fct=2)
    dev.transmit_frame(_dexter_frame(pkg), ts3)
    assert dev._channel_is_up and dev.num_frames_modulated == 2
    expected = ((ts3.seconds - dev._utc_seconds_at_startup) * D.DSP_CLOCK
                + dev._clock_count_at_startup)
    assert mod.dsp.attrs["stream0_start_clks"].writes[-1] == str(expected)


def test_dexter_underflow_poll(pkg):
    dev, mod, clock = make_dexter(pkg)
    mod.dsp.attrs["buffer_underflows0"].value = "7"
    dev.poll_underflows_once()
    assert dev.get_run_statistics()["underruns"] == 7


# ---------------------------------------------------------------------------
# the loaders without their vendor libraries, and open_sdr_output
# ---------------------------------------------------------------------------

LOADERS = [("_load_uhd_device", "uhd", "UHD"),
           ("_load_soapy_device", "SoapySDR", "SoapySDR"),
           ("_load_lime_device", "LimeSuite", "LimeSDR"),
           ("_load_bladerf_device", "bladerf", "BladeRF"),
           ("_load_dexter_device", "iio", "Dexter")]


@pytest.mark.parametrize("loader,module,name", LOADERS)
def test_missing_vendor_library_raises(pkg, monkeypatch, loader, module,
                                       name):
    """Without its vendor library each driver's loader gives a class whose
    construction raises a RuntimeError naming the library."""
    monkeypatch.setitem(sys.modules, module, None)      # import fails
    if module == "LimeSuite":
        def no_lms():
            raise ImportError("libLimeSuite")
        monkeypatch.setattr(pkg.lime, "_load_lms_api", no_lms)
    cls = getattr(pkg.sdr, loader)()
    with pytest.raises(RuntimeError, match=f"{name} output requires"):
        cls()


def _sdr_settings(pkg, output, **kw):
    return pkg.Settings(output=output, sdr_frequency=222_064_000.0,
                        sdr_txgain=25.0, output_rate=2_048_000,
                        **kw).normalise_for_output()


@pytest.mark.parametrize("output", ["uhd", "soapy", "lime", "bladerf",
                                    "dexter", "loopback"])
def test_open_output_builds_the_sdr_sink(pkg, monkeypatch, output):
    """open_output builds an SdrOutput over each driver from the settings
    (the vendor modules faked, as the drivers' own tests fake them)."""
    drv = {"uhd": (pkg.uhd, "UhdDevice"), "soapy": (pkg.soapy, "SoapyDevice"),
           "lime": (pkg.lime, "LimeDevice"),
           "bladerf": (pkg.bladerf, "BladeRFDevice"),
           "dexter": (pkg.dexter, "DexterDevice")}
    if output == "uhd":
        monkeypatch.setitem(sys.modules, "uhd", make_fake_uhd(FakeClock())[0])
    elif output == "soapy":
        monkeypatch.setitem(sys.modules, "SoapySDR", make_soapy_mock())
    elif output == "lime":
        monkeypatch.setattr(pkg.lime, "_load_lms_api", lambda: MockLms())
    elif output == "bladerf":
        monkeypatch.setitem(sys.modules, "bladerf", MockBladeRFModule())
    elif output == "dexter":
        monkeypatch.setitem(sys.modules, "iio", MockIioModule(IioClock()))
    if output in drv:
        mod, name = drv[output]
        monkeypatch.setattr(pkg.sdr, name, getattr(mod, name))
    out = pkg.outputs.open_output(_sdr_settings(pkg, output))
    try:
        assert isinstance(out, pkg.sdr.SdrOutput)
        if output in drv:
            assert isinstance(out.device, getattr(*drv[output]))
        else:
            assert out.device.frequency == 222_064_000.0
        assert out.device.get_txgain() == 25.0
        assert out.sync is False and out.feedback_server is None
    finally:
        out.close()
