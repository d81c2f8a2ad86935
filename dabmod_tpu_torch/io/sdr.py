"""SDR output framework: async device sink with SFN timestamp gating.

Port of the reference's device-agnostic Output::SDR wrapper
(src/output/SDR.cpp:50-543): the modulator thread enqueues timestamped frames
into a bounded queue; a realtime device thread pops, checks SFN timing
(drop frames whose timestamp is in the past, abort if >100 s in the future),
tracks continuity/underruns, and forwards to an SDRDevice implementation.

Concrete SDR drivers (UHD/Soapy/Lime/BladeRF/Dexter) require their vendor
libraries; a FileSdrDevice and LoopbackSdrDevice provide the same interface
without hardware, for file output and DPD-feedback testing.  The hardware
drivers raise an informative error when the vendor library is absent.

The port's copy of dabmod_tpu/io/sdr.py.
"""
from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
import time

import numpy as np

from ..timestamps import FrameTimestamp
from ..utils.spans import span

log = logging.getLogger("dabmod_tpu_torch.sdr")

# ref: src/output/SDR.cpp:52-56
FRAMES_MAX_SIZE_UNSYNC = 8
FRAMES_MAX_SIZE_SYNC = 250


def sc16_pairs(frame: np.ndarray) -> np.ndarray:
    """View a device-converted frame as int16 I/Q pairs.

    The modulator's device-side FormatConverter packs s16 pairs into i32
    wire words for the fast D2H path (models/modulator.py); sc16 drivers
    unpack them with a free reinterpreting view."""
    if frame.dtype == np.int32:
        return frame.view(np.int16).reshape(*frame.shape, 2)
    return frame


def f32_pairs_from_wire(frame: np.ndarray) -> np.ndarray:
    """Any wire frame -> float32 (N, 2) I/Q pairs in +-1.0 full scale.

    Integer (packed-s16 / sc16) frames map int16 full scale to 1.0 (DAC
    full scale); float frames pass through.  The ONE conversion shared by
    every float-streaming consumer (UHD/Soapy fc32 paths, the loopback
    device, the DPD feedback snapshot) so the scaling convention cannot
    drift between drivers."""
    if np.issubdtype(frame.dtype, np.integer):
        return (sc16_pairs(frame).reshape(-1, 2).astype(np.float32)
                * (1.0 / 32768.0))
    return np.asarray(frame, np.float32).reshape(-1, 2)


def n_complex_samples(frame: np.ndarray) -> int:
    """Complex sample count of a frame in any wire layout (f32/int16
    pairs, or i32-packed s16 where one word is one complex sample)."""
    if frame.dtype == np.int32:
        return int(frame.size)
    return int(frame.size // 2)


class SdrDevice:
    """Interface mirror of src/output/SDRDevice.h:113-146."""

    txgain: float = 0.0
    rxgain: float = 0.0
    frequency: float = 0.0
    lo_offset: float = 0.0

    def tune(self, lo_offset: float, frequency: float):
        raise NotImplementedError

    # gain accessors (ref: src/output/SDRDevice.h:117-121)
    def set_txgain(self, gain: float):
        self.txgain = float(gain)

    def get_txgain(self) -> float:
        return self.txgain

    def set_rxgain(self, gain: float):
        self.rxgain = float(gain)

    def get_rxgain(self) -> float:
        return self.rxgain

    def transmit_frame(self, samples: np.ndarray, ts: FrameTimestamp | None):
        raise NotImplementedError

    def receive_frame(self, num_samples: int, ts: FrameTimestamp):
        """Returns (samples, rx_timestamp)."""
        raise NotImplementedError

    def get_run_statistics(self) -> dict:
        return {}

    def close(self):
        pass


class FileSdrDevice(SdrDevice):
    """File-backed device (testing / offline use)."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.frames_transmitted = 0

    def tune(self, lo_offset, frequency):
        pass

    def transmit_frame(self, samples, ts):
        self.f.write(np.ascontiguousarray(samples, np.float32).tobytes())
        self.frames_transmitted += 1

    def get_run_statistics(self):
        return {"frames": self.frames_transmitted}

    def close(self):
        self.f.close()


class LoopbackSdrDevice(SdrDevice):
    """Keeps the last transmitted frames and 'receives' them through an
    optional PA model -- the closed-loop test double for the DPD engine.
    RX/TX gains scale the loopback linearly relative to 0 dB so the AGC
    loops observe a real effect."""

    def __init__(self, pa_model=None, history_frames: int = 4):
        self.pa_model = pa_model or (lambda x: x)
        self._history: list[tuple[np.ndarray, FrameTimestamp | None]] = []
        self._hist_max = history_frames
        self.frames_transmitted = 0

    def tune(self, lo_offset, frequency):
        self.lo_offset, self.frequency = lo_offset, frequency

    def transmit_frame(self, samples, ts):
        self._history.append((np.asarray(samples), ts))
        self._history = self._history[-self._hist_max:]
        self.frames_transmitted += 1

    def receive_frame(self, num_samples, ts):
        # the requested frame may still be queued ahead of the device
        # thread; wait briefly for it to be "transmitted" (a real SDR's
        # timed RX waits for the burst the same way)
        deadline = time.time() + 2.0
        while True:
            for samples, fts in self._history:
                if fts is not None and ts is not None \
                        and fts.seconds == ts.seconds and fts.pps == ts.pps:
                    # kiss/device-converted frames arrive as packed-s16
                    # wire words; the PA model needs float pairs
                    flat = f32_pairs_from_wire(samples)
                    sel = flat[:num_samples]
                    gain = 10.0 ** ((self.txgain + self.rxgain) / 20.0)
                    rx = self.pa_model(sel[:, 0] + 1j * sel[:, 1]) * gain
                    return (np.stack([rx.real, rx.imag], -1)
                            .astype(np.float32), ts)
            if time.time() >= deadline:
                return np.zeros((num_samples, 2), np.float32), ts
            time.sleep(0.02)

    def get_run_statistics(self):
        return {"frames": self.frames_transmitted}


def _missing_driver(name, module):
    class Missing(SdrDevice):
        def __init__(self, *a, **kw):
            raise RuntimeError(
                f"{name} output requires the {module} library, which is not "
                f"installed")
    return Missing


def _load_uhd_device():
    try:
        import uhd  # noqa: F401, PLC0415
    except ImportError:
        return _missing_driver("UHD", "uhd")
    from .uhd_driver import UhdDevice as _UhdDevice  # noqa: PLC0415
    return _UhdDevice


def _load_soapy_device():
    try:
        import SoapySDR  # noqa: F401, PLC0415
    except ImportError:
        return _missing_driver("SoapySDR", "SoapySDR")
    from .soapy_driver import SoapyDevice as _SoapyDevice  # noqa: PLC0415
    return _SoapyDevice


def _load_lime_device():
    try:
        from .lime_driver import _load_lms_api  # noqa: PLC0415
        _load_lms_api()
    except ImportError:
        return _missing_driver("LimeSDR", "LimeSuite")
    from .lime_driver import LimeDevice as _LimeDevice  # noqa: PLC0415
    return _LimeDevice


def _load_bladerf_device():
    try:
        import bladerf  # noqa: F401, PLC0415
    except ImportError:
        return _missing_driver("BladeRF", "libbladeRF")
    from .bladerf_driver import BladeRFDevice as _Brf  # noqa: PLC0415
    return _Brf


def _load_dexter_device():
    try:
        import iio  # noqa: F401, PLC0415
    except ImportError:
        return _missing_driver("Dexter", "libiio")
    from .dexter_driver import DexterDevice as _Dexter  # noqa: PLC0415
    return _Dexter


UhdDevice = _load_uhd_device()
SoapyDevice = _load_soapy_device()
LimeDevice = _load_lime_device()
BladeRFDevice = _load_bladerf_device()
DexterDevice = _load_dexter_device()


class SdrOutput:
    """Async sink + SFN gating (ref: src/output/SDR.cpp:135-361)."""

    def __init__(self, device: SdrDevice, sync: bool = False,
                 sample_rate: int = 2_048_000, feedback_port: int = 0,
                 mute: bool = False, mute_no_timestamps: bool = False):
        self.device = device
        self.sync = sync
        self.sample_rate = sample_rate
        self.muting = mute
        self.mute_no_timestamps = mute_no_timestamps
        maxsize = FRAMES_MAX_SIZE_SYNC if sync else FRAMES_MAX_SIZE_UNSYNC
        self.queue: queue.Queue = queue.Queue(maxsize)
        self._enqueue_lock = threading.Lock()
        self.underruns = 0
        self.dropped = 0
        self.muted = 0
        self.queue_overflows = 0
        self.frames = 0
        # the device thread's sum of each TF's wait in the queue (popped
        # less enqueued), and the TFs it popped
        self.queue_wait_s = 0.0
        self.popped = 0
        self.timestamp_discontinuities = 0
        self.num_clipped_samples = 0
        self._last_tx_ticks = None       # (seconds, pps) of last frame sent
        self._running = True
        self.fault = None                # terminal device-thread exception
        self.feedback_server = None
        if feedback_port:
            self.feedback_server = DpdFeedbackServer(
                device, feedback_port, sample_rate)
        self._thread = threading.Thread(target=self._device_thread,
                                        daemon=True, name="sdr-device")
        self._thread.start()

    # -- modulator-thread side --------------------------------------------
    def write(self, iq, ts=None):
        """Enqueue transmission frames.  `ts` may be a single timestamp, a
        (fct, timestamp) tuple, or -- for a batched [B, N, 2] array -- a list
        of per-TF (fct, timestamp) entries; each TF becomes its own queue
        entry so the device thread gates SFN timing per transmission frame
        (ref: src/output/SDR.cpp:135-201)."""
        frame = np.asarray(iq)
        if isinstance(ts, list):
            # batched arrays: [B, N, 2] float/int16 pairs or [B, N]
            # i32-packed s16 (device-side FormatConverter wire words)
            batched = (frame.ndim >= 3
                       or (frame.ndim == 2 and frame.dtype == np.int32))
            if batched and frame.shape[0] == len(ts):
                for i, entry in enumerate(ts):
                    t = entry[1] if isinstance(entry, tuple) else entry
                    self._enqueue(frame[i], t)
                return
            ts = ts[0] if ts else None
        if isinstance(ts, tuple):   # runtime metadata is (fct, timestamp)
            ts = ts[1]
        self._enqueue(frame, ts)

    def _enqueue(self, frame: np.ndarray, ts):
        if self.feedback_server is not None and ts is not None:
            snap = frame
            if np.issubdtype(snap.dtype, np.integer):
                # the DPD engine consumes f32 pairs (shared conversion,
                # see f32_pairs_from_wire)
                snap = f32_pairs_from_wire(snap)
            self.feedback_server.set_tx_frame(snap, ts)
        # push_overflow: drop oldest on full (lib/ThreadsafeQueue.h).  The
        # evict-one-then-put must be atomic against other producers, else a
        # second writer could win the freed slot and the retry would raise
        # queue.Full into the modulate loop.
        item = (frame, ts, time.perf_counter())
        with self._enqueue_lock:
            try:
                self.queue.put_nowait(item)
            except queue.Full:
                self.queue_overflows += 1
                try:
                    self.queue.get_nowait()
                except queue.Empty:
                    pass
                self.queue.put_nowait(item)

    # -- device thread ----------------------------------------------------
    def _device_thread(self):
        while self._running:
            try:
                frame, ts, enqueued = self.queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self.queue_wait_s += time.perf_counter() - enqueued
            self.popped += 1
            try:
                with span(None, "sdr.transmit"):
                    self._handle_frame(frame, ts)
            except Exception as e:      # noqa: BLE001
                # terminal: timestamp abort, refclk-crash behaviour, GPS
                # fix lost past holdover (ref: src/output/SDR.cpp:342-351)
                log.error("SDR device thread aborting: %s", e)
                self.fault = e
                self._running = False

    def _handle_frame(self, frame, ts):
        """Per-transmission-frame SFN gating
        (ref: src/output/SDR.cpp:254-361 handle_frame)."""
        # GPSDO / external reference discipline gate
        clk_ok = getattr(self.device, "is_clk_source_ok", None)
        if clk_ok is not None and not clk_ok():
            self.muted += 1
            return
        if self.sync and self.mute_no_timestamps \
                and (ts is None or not ts.valid):
            self.muted += 1
            log.info("SDR: muting frame, no timestamp")
            return
        if ts is not None and self.sync and ts.valid:
            get_secs = getattr(self.device, "get_real_secs", time.time)
            device_time = get_secs()
            # timestamp continuity vs expected per-frame increment
            # (ref: src/output/SDR.cpp:292-326)
            n_samps = n_complex_samples(np.asarray(frame))
            if self._last_tx_ticks is not None:
                inc = n_samps * 16_384_000 // self.sample_rate
                exp_sec = self._last_tx_ticks[0] + \
                    (self._last_tx_ticks[1] + inc) // 16_384_000
                exp_pps = (self._last_tx_ticks[1] + inc) % 16_384_000
                if (exp_sec, exp_pps) != (ts.seconds, ts.pps):
                    self.timestamp_discontinuities += 1
                    log.warning(
                        "SDR: timestamp irregularity at FCT=%d: expected "
                        "%d+%d got %d+%d", ts.fct, exp_sec, exp_pps,
                        ts.seconds, ts.pps)
                    self._refresh_device_timestamp()
            self._last_tx_ticks = (ts.seconds, ts.pps)
            offset = ts.as_seconds() - device_time
            if offset < 0:
                # Timestamp in the past: drop the frame
                # (ref: src/output/SDR.cpp:332-340)
                self.dropped += 1
                log.warning("SDR: dropping frame FCT=%d with timestamp "
                            "%.3f s in the past", ts.fct, -offset)
                self._refresh_device_timestamp()
                return
            if offset > 100:
                # (ref: src/output/SDR.cpp:342-351)
                raise RuntimeError(
                    f"timestamp {offset:.1f} s in the future")
        if self.muting:
            self.muted += 1
            self._refresh_device_timestamp()
            return
        try:
            self.device.transmit_frame(frame, ts)
            self.frames += 1
        except Exception as e:      # noqa: BLE001
            self.underruns += 1
            log.error("SDR transmit error: %s", e)

    def _refresh_device_timestamp(self):
        refresh = getattr(self.device, "require_timestamp_refresh", None)
        if refresh is not None:
            refresh()

    def get_run_statistics(self) -> dict:
        stats = {"underruns": self.underruns, "dropped": self.dropped,
                 "queue_overflows": self.queue_overflows,
                 "frames": self.frames}
        stats.update(self.device.get_run_statistics())
        return stats

    def close(self):
        deadline = time.time() + 5
        while not self.queue.empty() and time.time() < deadline:
            time.sleep(0.02)
        self._running = False
        self._thread.join(timeout=2)
        if self.feedback_server:
            self.feedback_server.stop()
        self.device.close()


class DpdFeedbackServer:
    """TCP server pairing timestamp-aligned TX snapshots with RX bursts
    (ref: src/output/Feedback.cpp; wire protocol per python/dpd/Measure.py:
    client sends version byte 0x01 + u32 num_samples; server replies
    u32 num_samps, u32 tx_second, u32 tx_pps, tx samples (complexf),
    u32 rx_second, u32 rx_pps, rx samples)."""

    def __init__(self, device: SdrDevice, port: int, sample_rate: int):
        self.device = device
        self.sample_rate = sample_rate
        self._tx_lock = threading.Condition()
        self._want_samples = 0
        self._tx_frame = None
        self._tx_ts = None
        self._running = True
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen(1)
        self._srv.settimeout(0.5)
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="dpd-feedback")
        self._thread.start()

    def set_tx_frame(self, frame: np.ndarray, ts: FrameTimestamp):
        with self._tx_lock:
            if self._want_samples and self._tx_frame is None:
                flat = frame.reshape(-1, 2)
                self._tx_frame = flat[:self._want_samples].copy()
                self._tx_ts = ts
                self._tx_lock.notify_all()

    def _serve(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._handle(conn)
            except (OSError, struct.error, NotImplementedError) as e:
                log.warning("DPD feedback connection error: %s", e)
            finally:
                conn.close()

    def _handle(self, conn: socket.socket):
        conn.settimeout(5)
        version = conn.recv(1)
        if version != b"\x01":
            return
        (num_samples,) = struct.unpack("=I", conn.recv(4))
        num_samples = min(num_samples, 10 * self.sample_rate)
        with self._tx_lock:
            self._want_samples = num_samples
            self._tx_frame = None
            ok = self._tx_lock.wait_for(lambda: self._tx_frame is not None,
                                        timeout=5)
            self._want_samples = 0
            if not ok:
                return
            tx = self._tx_frame
            ts = self._tx_ts
        rx, rx_ts = self.device.receive_frame(num_samples, ts)
        rx = np.asarray(rx, np.float32).reshape(-1, 2)
        if rx.shape[0] < num_samples:
            # the header advertises num_samples for BOTH streams; a short
            # device read must still honour the wire contract or the
            # client blocks on its socket
            rx = np.concatenate(
                [rx, np.zeros((num_samples - rx.shape[0], 2), np.float32)])
        sec = ts.seconds if ts else 0
        pps = ts.pps if ts else 0
        conn.sendall(struct.pack("=III", tx.shape[0], sec, pps))
        conn.sendall(np.ascontiguousarray(tx, np.float32).tobytes())
        rsec = rx_ts.seconds if rx_ts else 0
        rpps = rx_ts.pps if rx_ts else 0
        conn.sendall(struct.pack("=II", rsec, rpps))
        conn.sendall(np.ascontiguousarray(rx, np.float32).tobytes())

    def stop(self):
        self._running = False
        self._srv.close()
        self._thread.join(timeout=2)
