"""SoapySDR generic SDR driver.

Port of the reference's Output::Soapy (src/output/Soapy.cpp:50-368) against
the SoapySDR Python API.  SoapySDR is the vendor-neutral layer that also
covers LimeSDR and BladeRF hardware through their Soapy plugins, so this one
driver closes most of the hardware-output matrix.

The `soapy_module` is injectable so the complete driver -- timed
activate/writeStream bursts with per-chunk timeNs advance, MTU chunking,
EOB-deactivate on timestamp refresh/muting, underflow/overflow/timeout
counters, and the timed readStream DPD feedback path -- is testable without
hardware (tests/test_soapy_driver.py provides a mock).

The port's copy of dabmod_tpu/io/soapy_driver.py.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np

from ..timestamps import FrameTimestamp
from .sdr import SdrDevice

log = logging.getLogger("dabmod_tpu_torch.soapy")

# SoapySDR error codes (SoapySDR/Errors.h); the module also exports these,
# but keeping local copies lets the mock stay minimal
SOAPY_SDR_TIMEOUT = -1
SOAPY_SDR_OVERFLOW = -4
SOAPY_SDR_UNDERFLOW = -7
# stream flags (SoapySDR/Constants.h)
SOAPY_SDR_HAS_TIME = 1 << 2


@dataclasses.dataclass
class SoapyConfig:
    """Subset of SDRDeviceConfig relevant to SoapySDR
    (ref: src/output/SDRDevice.h:54-111)."""
    device_args: str = ""
    sample_rate: int = 2_048_000
    frequency: float = 0.0
    lo_offset: float = 0.0
    txgain: float = 0.0
    rxgain: float = 0.0
    bandwidth: float = 0.0
    master_clock_rate: float = 0.0
    tx_antenna: str = ""
    rx_antenna: str = ""
    enable_sync: bool = False

    @classmethod
    def from_settings(cls, s):
        return cls(device_args=s.sdr_device_args,
                   sample_rate=s.output_rate,
                   frequency=s.sdr_frequency,
                   lo_offset=s.sdr_lo_offset,
                   txgain=s.sdr_txgain,
                   rxgain=s.sdr_rxgain,
                   bandwidth=s.sdr_bandwidth,
                   master_clock_rate=s.sdr_master_clock_rate,
                   tx_antenna=s.sdr_tx_antenna,
                   rx_antenna=s.sdr_rx_antenna,
                   enable_sync=s.tist_enabled)


class SoapyDevice(SdrDevice):
    """SoapySDR driver (ref: src/output/Soapy.cpp:50-368).

    `soapy_module` is injectable for tests; by default `import SoapySDR`."""

    def __init__(self, conf: SoapyConfig | None = None, soapy_module=None,
                 time_fn=time.time):
        self.conf = c = conf or SoapyConfig()
        if soapy_module is None:
            import SoapySDR as soapy_module  # noqa: PLC0415
        self._soapy = soapy_module
        self._tx_dir = soapy_module.SOAPY_SDR_TX
        self._rx_dir = soapy_module.SOAPY_SDR_RX
        self._cf32 = soapy_module.SOAPY_SDR_CF32

        log.info("Soapy: creating the device with: %r", c.device_args)
        self.dev = soapy_module.Device(c.device_args)
        log.info("Soapy: driver=%s hardware=%s", self.dev.getDriverKey(),
                 self.dev.getHardwareKey())

        if c.master_clock_rate:
            self.dev.setMasterClockRate(c.master_clock_rate)
            log.info("Soapy: actual master clock rate %.4f kHz",
                     self.dev.getMasterClockRate() / 1e3)

        self.dev.setSampleRate(self._tx_dir, 0, c.sample_rate)
        self.dev.setSampleRate(self._rx_dir, 0, c.sample_rate)
        log.info("Soapy: actual TX rate %.4f ksps",
                 self.dev.getSampleRate(self._tx_dir, 0) / 1e3)

        self.tune(c.lo_offset, c.frequency)

        if c.bandwidth > 0:
            self.dev.setBandwidth(self._tx_dir, 0, c.bandwidth)
            self.dev.setBandwidth(self._rx_dir, 0, c.bandwidth)

        self.dev.setGain(self._tx_dir, 0, c.txgain)
        self.txgain = float(self.dev.getGain(self._tx_dir, 0))
        self.dev.setGain(self._rx_dir, 0, c.rxgain)
        self.rxgain = float(self.dev.getGain(self._rx_dir, 0))
        if c.tx_antenna:
            self.dev.setAntenna(self._tx_dir, 0, c.tx_antenna)
        if c.rx_antenna:
            self.dev.setAntenna(self._rx_dir, 0, c.rx_antenna)

        # seed the hardware clock from system time so SFN offsets are sane
        # (ref: src/output/Soapy.cpp:112-117)
        if self.dev.hasHardwareTime():
            self.dev.setHardwareTime(int(time_fn() * 1e9))

        self._tx_stream = self.dev.setupStream(self._tx_dir, self._cf32, [0])
        self._rx_stream = self.dev.setupStream(self._rx_dir, self._cf32, [0])
        self._mtu = int(self.dev.getStreamMTU(self._tx_stream))
        self._tx_stream_active = False
        self._require_timestamp_refresh = False
        self.muting = False

        self.underflows = 0
        self.overflows = 0
        self.timeouts = 0
        self.num_frames_modulated = 0

    # ------------------------------------------------------------- control
    def tune(self, lo_offset: float, frequency: float):
        if frequency == 0:
            return
        # the LO offset travels as the OFFSET tune arg
        # (ref: src/output/Soapy.cpp:138-148)
        self.dev.setFrequency(self._tx_dir, 0, frequency,
                              {"OFFSET": str(lo_offset)})
        self.frequency = float(self.dev.getFrequency(self._tx_dir, 0))
        self.lo_offset = lo_offset

    def set_txgain(self, gain: float):
        self.dev.setGain(self._tx_dir, 0, gain)
        self.txgain = float(self.dev.getGain(self._tx_dir, 0))

    def get_txgain(self) -> float:
        return float(self.dev.getGain(self._tx_dir, 0))

    def set_rxgain(self, gain: float):
        self.dev.setGain(self._rx_dir, 0, gain)
        self.rxgain = float(self.dev.getGain(self._rx_dir, 0))

    def get_rxgain(self) -> float:
        return float(self.dev.getGain(self._rx_dir, 0))

    def get_real_secs(self) -> float:
        return self.dev.getHardwareTime() / 1e9

    def require_timestamp_refresh(self):
        """After dropped/muted frames the next burst re-activates the stream
        with a fresh time (ref: src/output/SDR.cpp:292-331)."""
        self._require_timestamp_refresh = True

    # ------------------------------------------------------------ transmit
    @staticmethod
    def _ret(result):
        """The Python API returns a StreamResult object; a plain int is
        accepted too so simple mocks work."""
        return int(getattr(result, "ret", result))

    def transmit_frame(self, samples: np.ndarray,
                       ts: FrameTimestamp | None):
        """MTU-chunked writeStream loop with timeNs advance and
        EOB-deactivate (ref: src/output/Soapy.cpp:276-368)."""
        if np.issubdtype(samples.dtype, np.integer):
            # device-converted frames arrive as packed s16 wire words;
            # this driver streams fc32 (full scale +-1.0), so divide by
            # 32768 to map int16 full scale onto DAC full scale
            from .sdr import f32_pairs_from_wire
            samples = f32_pairs_from_wire(samples)
        flat = np.ascontiguousarray(samples, np.float32).reshape(-1, 2)
        cplx = flat.view(np.complex64).reshape(-1)
        n = cplx.shape[0]

        has_time_spec = (self.conf.enable_sync and ts is not None
                         and ts.valid)
        time_ns = int(ts.as_seconds() * 1e9) if has_time_spec else 0

        if not self._tx_stream_active:
            flags = SOAPY_SDR_HAS_TIME if has_time_spec else 0
            ret = self.dev.activateStream(self._tx_stream, flags, time_ns)
            if ret != 0:
                raise RuntimeError(
                    f"Soapy activate TX stream failed: {ret}")
            self._tx_stream_active = True

        acc = 0
        while acc < n:
            to_send = min(n - acc, self._mtu)
            eob_because_muting = self.muting
            end_of_burst = eob_because_muting or (
                ts is not None and ts.valid
                and self._require_timestamp_refresh
                and to_send <= self._mtu)

            result = self.dev.writeStream(self._tx_stream,
                                          [cplx[acc:acc + to_send]],
                                          to_send, 0, time_ns)
            sent = self._ret(result)
            if sent == SOAPY_SDR_TIMEOUT:
                self.timeouts += 1
                continue
            if sent == SOAPY_SDR_OVERFLOW:
                self.overflows += 1
                continue
            if sent == SOAPY_SDR_UNDERFLOW:
                self.underflows += 1
                continue
            if sent < 0:
                raise RuntimeError(f"Soapy stream error {sent}")

            time_ns += int(1e9 * sent / self.conf.sample_rate)
            acc += sent

            if end_of_burst:
                ret = self.dev.deactivateStream(self._tx_stream)
                if ret != 0:
                    raise RuntimeError(
                        f"Soapy deactivate TX stream failed: {ret}")
                self._tx_stream_active = False
                self._require_timestamp_refresh = False
            if eob_because_muting:
                break
        self.num_frames_modulated += 1

    def receive_frame(self, num_samples: int, ts: FrameTimestamp):
        """Timed RX burst: activate -> readStream -> deactivate
        (ref: src/output/Soapy.cpp:218-255)."""
        time_ns = int(ts.as_seconds() * 1e9)
        ret = self.dev.activateStream(self._rx_stream, 0, time_ns,
                                      num_samples)
        if ret != 0:
            raise RuntimeError(f"Soapy activate RX stream failed: {ret}")
        buf = np.zeros(num_samples, np.complex64)
        # python-API signature is (stream, buffs, numElems, flags,
        # timeoutUs): the C++ timeNs is an OUT param surfaced on the
        # result object, NOT an argument -- passing time_ns here would
        # set a ~50-year timeout
        result = self.dev.readStream(self._rx_stream, [buf], num_samples)
        got = self._ret(result)
        rx_ns = int(getattr(result, "timeNs", time_ns))
        ret = self.dev.deactivateStream(self._rx_stream)
        if ret != 0:
            raise RuntimeError(f"Soapy deactivate RX stream failed: {ret}")
        if got < 0:
            raise RuntimeError(f"Soapy failed to read from RX stream: {got}")
        rx_ts = FrameTimestamp(valid=True, seconds=rx_ns // 1_000_000_000,
                               pps=int((rx_ns % 1_000_000_000)
                                       * 16.384e6 / 1e9))
        pairs = np.stack([buf.real, buf.imag], -1).astype(np.float32)
        return pairs[:got], rx_ts

    # ------------------------------------------------------------ counters
    def get_run_statistics(self) -> dict:
        return {"underruns": self.underflows, "overruns": self.overflows,
                "timeouts": self.timeouts,
                "frames": self.num_frames_modulated}

    def close(self):
        for stream in (self._tx_stream, self._rx_stream):
            try:
                self.dev.closeStream(stream)
            except RuntimeError:
                pass
