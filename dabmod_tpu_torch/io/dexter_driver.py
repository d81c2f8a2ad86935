"""PrecisionWave DEXTER output driver.

Port of the reference's Output::Dexter (src/output/Dexter.cpp:69-699)
against the libiio Python bindings (pylibiio: ``iio.Context`` exposing
devices with attribute dicts and pushable buffers).  The ``iio_module``,
``time_fn`` and ``sleep_fn`` are injectable so the full driver -- the
GPSDO clock state machine (startup -> normal -> holdover), the UTC+PPS ->
FPGA-DSP-clock timestamp mapping for ``stream0_start_clks``, channel
up/down with FIFO flush, and underflow accounting -- is testable without
the DEXTER hardware (tests/test_vendor_drivers.py).

The modulator feeds this device floats already normalised to int16 full
scale (settings.normalise = 32767/NORMALISE_FACTOR_SDR); the driver rounds
and saturates to the sc16 wire format the FPGA expects.

The port's copy of dabmod_tpu/io/dexter_driver.py.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time as _time

import numpy as np

from ..timestamps import FrameTimestamp
from .sdr import SdrDevice

log = logging.getLogger("dabmod_tpu_torch.dexter")

# ref: src/output/Dexter.cpp:47-53
DSP_CLOCK = 2_048_000 * 80
TRANSMISSION_FRAME_LEN_SAMPS = (2656 + 76 * 2552) * 2   # I+Q int16 at 2.048M
IIO_BUFFERS = 2
IIO_BUFFER_LEN_SAMPS = TRANSMISSION_FRAME_LEN_SAMPS // IIO_BUFFERS
# timestamp_pps is in 16.384 MHz units; DSP clock runs 10x faster
# (ref: src/output/Dexter.cpp:552-558)
PPS_PER_DSP_CLOCKS = DSP_CLOCK // 16_384_000

STATE_STARTUP = "startup"
STATE_NORMAL = "normal"
STATE_HOLDOVER = "holdover"


@dataclasses.dataclass
class DexterConfig:
    """Subset of SDRDeviceConfig used by the Dexter driver."""
    sample_rate: int = 2_048_000
    frequency: float = 0.0
    lo_offset: float = 0.0
    txgain: float = 0.0
    enable_sync: bool = False
    max_gps_holdover_time: float = 0.0

    @classmethod
    def from_settings(cls, s):
        return cls(sample_rate=s.output_rate,
                   frequency=s.sdr_frequency,
                   lo_offset=s.sdr_lo_offset,
                   txgain=s.sdr_txgain,
                   enable_sync=s.tist_enabled,
                   max_gps_holdover_time=s.sdr_max_gps_holdover_time)


class DexterDevice(SdrDevice):
    """DEXTER driver (ref: src/output/Dexter.cpp:69-699).

    `iio_module` must expose `Context()`; a context finds devices by name
    (`find_device`), each device has an `attrs` mapping of attribute name ->
    object with a read/writable `.value` string, and `Buffer(device, n)`
    objects support `.write(bytes)` + `.push()` (the pylibiio surface)."""

    def __init__(self, conf: DexterConfig | None = None, iio_module=None,
                 time_fn=_time.time, sleep_fn=_time.sleep,
                 underflow_poll: bool = True):
        self.conf = c = conf or DexterConfig()
        if iio_module is None:
            import iio as iio_module  # noqa: PLC0415
        self._iio = iio_module
        self._time = time_fn
        self._sleep = sleep_fn

        if c.sample_rate != 2_048_000:
            # (ref: src/output/Dexter.cpp:109-111)
            raise RuntimeError("Dexter: Only 2048000 samplerate supported")

        log.info("Dexter: creating the device")
        self.ctx = iio_module.Context()
        self._dsp = self._find("dexter_dsp_tx")
        self._ad9957 = self._find("ad9957")
        self._ad9957_tx0 = self._find("ad9957_tx0")

        # disable DC offsets (ref: src/output/Dexter.cpp:100-107)
        self._w(self._dsp, "dc0", 0)
        self._w(self._dsp, "dc1", 0)

        self.tune(c.lo_offset, c.frequency)
        # the reference refuses to run on a failed tune readback
        # (ref: src/output/Dexter.cpp:114-127)
        actual = self.get_tx_freq()
        if c.frequency and round(actual) != round(c.frequency):
            raise RuntimeError(
                f"Could not set frequency: wanted {c.frequency} read back "
                f"{actual}")

        # gain down + FIFO flush before arming (ref: Dexter.cpp:132-143)
        self._w(self._dsp, "gain0", 0)
        self._w(self._dsp, "stream0_flush_fifo_trigger", 1)
        self._w(self._dsp, "stream0_start_clks", 0)

        # enable the TX scan channel before creating the buffer -- libiio
        # refuses a buffer on a device with no enabled channels
        # (ref: src/output/Dexter.cpp:145-151)
        channels = getattr(self._ad9957_tx0, "channels", [])
        if not channels:
            raise RuntimeError("Dexter: Cannot create IIO channel")
        self._tx_channel = channels[0]
        self._tx_channel.enabled = True

        self._buffer = iio_module.Buffer(self._ad9957_tx0,
                                         IIO_BUFFER_LEN_SAMPS)
        # flush the FPGA FIFO with one zero buffer (ref: Dexter.cpp:158-169)
        self._buffer.write(bytes(IIO_BUFFER_LEN_SAMPS * 2))
        self._buffer.push()
        self._sleep(0.2)

        self._w(self._dsp, "gain0", c.txgain)
        self.txgain = float(c.txgain)

        self.clock_state = STATE_STARTUP
        self._utc_seconds_at_startup = 0
        self._clock_count_at_startup = 0
        self._holdover_since = 0.0
        self._channel_is_up = False
        self._require_timestamp_refresh = False

        self.underflows = 0
        self._prev_underflows = 0
        self.num_late = 0
        self.num_frames_modulated = 0
        self._num_buffers_pushed = 0

        self._lock = threading.Lock()
        self._running = True
        self._underflow_thread = None
        if underflow_poll:
            self._underflow_thread = threading.Thread(
                target=self._underflow_read_process, daemon=True,
                name="dexter_underflow")
            self._underflow_thread.start()

    # --------------------------------------------------------------- iio
    def _find(self, name):
        dev = self.ctx.find_device(name)
        if dev is None:
            raise RuntimeError(f"Dexter: Unable to find {name} iio device")
        return dev

    @staticmethod
    def _w(dev, attr, value):
        dev.attrs[attr].value = str(int(value))

    @staticmethod
    def _r(dev, attr) -> int:
        return int(dev.attrs[attr].value)

    # ------------------------------------------------------------- control
    def tune(self, lo_offset: float, frequency: float):
        """lo_offset goes to the DSP NCO, the carrier to the ad9957 -- this
        split gives lower spurs (ref: src/output/Dexter.cpp:358-376)."""
        self._w(self._ad9957, "center_frequency",
                round(frequency - lo_offset))
        self._w(self._dsp, "frequency0", round(lo_offset))
        self.frequency = self.get_tx_freq()
        self.lo_offset = lo_offset

    def get_tx_freq(self) -> float:
        return float(self._r(self._dsp, "frequency0")
                     + self._r(self._ad9957, "center_frequency"))

    def set_txgain(self, gain: float):
        self._w(self._dsp, "gain0", gain)
        self.conf.txgain = self.txgain = float(
            self._r(self._dsp, "gain0"))

    def get_txgain(self) -> float:
        return float(self._r(self._dsp, "gain0"))

    def get_real_secs(self) -> float:
        """UTC from the free-running DSP clock counter via the startup
        alignment (ref: src/output/Dexter.cpp:465-482)."""
        if self.clock_state == STATE_STARTUP:
            return 0.0
        clks = self._r(self._dsp, "clks")
        return (self._utc_seconds_at_startup
                + (clks - self._clock_count_at_startup) / DSP_CLOCK)

    def require_timestamp_refresh(self):
        self._require_timestamp_refresh = True

    # ----------------------------------------------------- clock discipline
    def is_clk_source_ok(self) -> bool:
        """Advance the clock state machine; transmission is gated until the
        PPS alignment completed (ref: src/output/Dexter.cpp:506-515)."""
        if not self.conf.enable_sync:
            return True
        self._handle_hw_time()
        return self.clock_state != STATE_STARTUP

    def _handle_hw_time(self):
        """startup -> normal on GPSDO lock (with PPS/DSP-clock alignment),
        normal -> holdover on PPS loss, holdover -> startup on timeout or
        PPS return (ref: src/output/Dexter.cpp:230-356)."""
        if self.clock_state == STATE_STARTUP:
            if (self._r(self._dsp, "gpsdo_locked") == 1
                    and self._r(self._dsp, "pps_loss_of_signal") == 0):
                self._align_clocks()
        elif self.clock_state == STATE_NORMAL:
            if self._r(self._dsp, "pps_loss_of_signal") == 1:
                self._holdover_since = self._time()
                self.clock_state = STATE_HOLDOVER
                log.debug("Dexter: switch clock state Normal -> Holdover")
        elif self.clock_state == STATE_HOLDOVER:
            pps_lost = self._r(self._dsp, "pps_loss_of_signal")
            elapsed = self._time() - self._holdover_since
            if elapsed > self.conf.max_gps_holdover_time or pps_lost == 0:
                self.clock_state = STATE_STARTUP
                self._utc_seconds_at_startup = 0
                self._clock_count_at_startup = 0
                self._holdover_since = 0.0
                log.debug("Dexter: switch clock state Holdover -> Startup")

    def _align_clocks(self):
        """Wait 200 ms after two consecutive UTC second changes, read
        pps_clks at each, and require exactly DSP_CLOCK increment; then
        record the UTC-second <-> clock-count correspondence
        (ref: src/output/Dexter.cpp:258-314)."""
        log.info("Dexter: waiting for second change...")
        self._wait_second_change()
        self._sleep(0.2)
        pps_clks = self._r(self._dsp, "pps_clks")
        self._wait_second_change()
        self._sleep(0.2)
        pps_clks2 = self._r(self._dsp, "pps_clks")
        now = int(self._time())
        log.info("Dexter: pps_clks increased by %d", pps_clks2 - pps_clks)
        if pps_clks + DSP_CLOCK != pps_clks2:
            raise RuntimeError(
                f"Dexter: Wrong increase of pps_clks, expected {DSP_CLOCK}")
        self._utc_seconds_at_startup = now
        self._clock_count_at_startup = pps_clks2
        self._holdover_since = 0.0
        self.clock_state = STATE_NORMAL
        log.debug("Dexter: switch clock state Startup -> Normal")

    def _wait_second_change(self):
        start_sec = int(self._time())
        while int(self._time()) == start_sec:
            self._sleep(0.001)

    # ------------------------------------------------------ channel up/down
    def _channel_up(self):
        self._w(self._dsp, "gain0", self.conf.txgain)
        self._channel_is_up = True
        log.debug("DEXTER CHANNEL_UP")

    def _channel_down(self):
        """Gain to zero, flush by zeroing start_clks, then wait for the FIFO
        to drain (observed as an underflow)
        (ref: src/output/Dexter.cpp:192-228)."""
        self._w(self._dsp, "gain0", 0)
        self._w(self._dsp, "stream0_start_clks", 0)
        underflows_old = self._r(self._dsp, "buffer_underflows0")
        underflows = underflows_old
        for _ in range(10):
            if underflows != underflows_old:
                break
            underflows = self._r(self._dsp, "buffer_underflows0")
            self._sleep(0.096)
        if underflows == underflows_old:
            log.warning("DEXTER CHANNEL_DOWN, no underflow detected! %d",
                        underflows)
        self._channel_is_up = False
        log.debug("DEXTER CHANNEL_DOWN")

    # ------------------------------------------------------------ transmit
    def transmit_frame(self, samples: np.ndarray,
                       ts: FrameTimestamp | None):
        """Timed transmission: map UTC+PPS to DSP clock counts, arm
        stream0_start_clks, then push the TF through the two IIO buffers
        (ref: src/output/Dexter.cpp:535-636)."""
        if np.issubdtype(samples.dtype, np.integer):
            # already s16 on device (the reference's DEXTER path also
            # arrives pre-converted, src/DabMod.cpp:454-455)
            from .sdr import sc16_pairs
            buf = np.ascontiguousarray(sc16_pairs(samples).reshape(-1))
        else:
            flat = np.ascontiguousarray(samples, np.float32).reshape(-1)
            buf = np.clip(np.rint(flat), -32768, 32767).astype(np.int16)
        if buf.shape[0] != TRANSMISSION_FRAME_LEN_SAMPS:
            raise RuntimeError(
                f"Dexter: invalid buffer size {buf.shape[0]}, expected "
                f"{TRANSMISSION_FRAME_LEN_SAMPS}")

        require_timestamped = (self.conf.enable_sync and ts is not None
                               and ts.valid)
        if not self._channel_is_up:
            if require_timestamped:
                if self.clock_state == STATE_STARTUP:
                    return      # not ready
                frame_start_clocks = (
                    (ts.seconds - self._utc_seconds_at_startup) * DSP_CLOCK
                    + self._clock_count_at_startup
                    + ts.pps * PPS_PER_DSP_CLOCKS)
                margin_s = ts.as_seconds() - self._time()
                # hand over to hardware with some margin
                # (ref: src/output/Dexter.cpp:577-588)
                if margin_s < 0.2:
                    log.warning("Skip frame short margin %.3f", margin_s)
                    self.num_late += 1
                    return
                self._w(self._dsp, "stream0_start_clks", frame_start_clocks)
                self._require_timestamp_refresh = False
            self._channel_up()

        if self._require_timestamp_refresh:
            log.debug("DEXTER REQUIRE REFRESH")
            self._channel_down()
            self._require_timestamp_refresh = False

        if self._channel_is_up:
            raw = buf.tobytes()
            buflen = IIO_BUFFER_LEN_SAMPS * 2
            for i in range(IIO_BUFFERS):
                self._buffer.write(raw[i * buflen:(i + 1) * buflen])
                try:
                    self._buffer.push()
                except OSError as e:
                    log.error("Dexter: failed to push buffer %s after %d "
                              "bufs", e, self._num_buffers_pushed)
                    self._num_buffers_pushed = 0
                    self._channel_down()
                    break
                self._num_buffers_pushed += 1
            else:
                self.num_frames_modulated += 1

        with self._lock:
            u = self.underflows
        if u and u != self._prev_underflows:
            log.warning("Dexter: underflow! %d -> %d",
                        self._prev_underflows, u)
        self._prev_underflows = u

    def poll_underflows_once(self):
        """One pass of the underflow reader (the thread body's loop step);
        exposed so tests and diagnostics can run it synchronously
        (ref: src/output/Dexter.cpp:638-668)."""
        n = self._r(self._dsp, "buffer_underflows0")
        with self._lock:
            if n != self.underflows and n != 0:
                self.underflows = n

    def _underflow_read_process(self):
        while self._running:
            self._sleep(1.0)
            try:
                self.poll_underflows_once()
            except (RuntimeError, OSError, KeyError):
                pass

    # ------------------------------------------------------------ counters
    def get_run_statistics(self) -> dict:
        with self._lock:
            stats = {"underruns": self.underflows}
        stats.update({
            "latepackets": self.num_late,
            "frames": self.num_frames_modulated,
            "clock_state": self.clock_state,
            "in_holdover_since": 0,
            "remaining_holdover_s": self.conf.max_gps_holdover_time,
        })
        if self.clock_state == STATE_HOLDOVER:
            stats["in_holdover_since"] = self._holdover_since
            stats["remaining_holdover_s"] = int(
                self.conf.max_gps_holdover_time
                - (self._time() - self._holdover_since))
        return stats

    def get_temperature(self) -> float | None:
        """Baseboard temperature sysfs node
        (ref: src/output/Dexter.cpp:522-533)."""
        try:
            path = ("/sys/bus/i2c/devices/1-002f/hwmon/hwmon0/temp1_input")
            with open(path) as f:
                return int(f.read().strip()) / 1000.0
        except (OSError, ValueError):
            return None

    def close(self):
        self._running = False
        if self._underflow_thread is not None:
            self._underflow_thread.join(timeout=2)
        try:
            self._w(self._dsp, "gain0", 0)
        except (RuntimeError, OSError, KeyError):
            pass
