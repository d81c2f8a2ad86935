"""LimeSDR output driver.

Port of the reference's Output::Lime (src/output/Lime.cpp:92-451) against
the LimeSuite LMS C API.  LimeSuite ships no official Python binding, so the
driver talks to a thin Pythonic facade of the LMS_* entry points; by default
the facade is built over ``ctypes`` from ``libLimeSuite`` (`_load_lms_api`),
and tests inject a mock facade instead (tests/test_vendor_drivers.py), the
same pattern as the UHD and Soapy drivers.

Reproduced behaviours: device open/reset/init sequence, optional CGEN master
clock, TX2 antenna + 2.5 MHz calibration, the 61-tap GFIR3 interpolation
filter upload, a 10-transmission-frame FIFO, float->s16 conversion with the
reference's +-1 clamp, per-send stream-status accounting (underrun/overrun/
dropped packets/FIFO fill), and normalised 0..100 gain.

The port's copy of dabmod_tpu/io/lime_driver.py.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ..timestamps import FrameTimestamp
from .sdr import SdrDevice

log = logging.getLogger("dabmod_tpu_torch.lime")

# ref: src/output/Lime.cpp:54-55 (FRAME_LENGTH at native rate; FIFO holds 10)
FRAME_LENGTH = 196_608
FIFO_FRAMES = 10

# 61-tap interpolation GFIR3 coefficients for interpolate=1
# (hardware-config constant table, ref: src/output/Lime.cpp:206-219)
GFIR3_COEFF_INTERP1 = np.array([
    -0.0008126748726, -0.0003874975955, 0.0007290032809, -0.0009636150789,
    0.0007643355639, 3.123887291e-05, -0.001263667713, 0.002418729011,
    -0.002785810735, 0.001787990681, 0.0006407162873, -0.003821208142,
    0.006409643684, -0.006850919221, 0.004091503099, 0.00172403187,
    -0.008917749859, 0.01456955727, -0.01547530293, 0.009518089704,
    0.00304264226, -0.01893160492, 0.0322769247, -0.03613986075,
    0.02477015182, 0.0041426518, -0.04805115238, 0.09958232939,
    -0.1481673121, 0.1828524768, 0.8045722842, 0.1828524768, -0.1481673121,
    0.09958232939, -0.04805115238, 0.0041426518, 0.02477015182,
    -0.03613986075, 0.0322769247, -0.01893160492, 0.00304264226,
    0.009518089704, -0.01547530293, 0.01456955727, -0.008917749859,
    0.00172403187, 0.004091503099, -0.006850919221, 0.006409643684,
    -0.003821208142, 0.0006407162873, 0.001787990681, -0.002785810735,
    0.002418729011, -0.001263667713, 3.123887291e-05, 0.0007643355639,
    -0.0009636150789, 0.0007290032809, -0.0003874975955, -0.0008126748726,
], np.float64)


@dataclasses.dataclass
class LimeConfig:
    """Subset of SDRDeviceConfig used by the Lime driver
    (ref: src/output/SDRDevice.h:54-111)."""
    device_args: str = ""
    sample_rate: int = 2_048_000
    frequency: float = 0.0
    lo_offset: float = 0.0
    txgain: float = 0.0          # 0..100, normalised /100 on the device
    master_clock_rate: float = 0.0
    upsample: int = 1            # FPGA interpolation factor

    @classmethod
    def from_settings(cls, s):
        return cls(device_args=s.sdr_device_args,
                   sample_rate=s.output_rate,
                   frequency=s.sdr_frequency,
                   lo_offset=s.sdr_lo_offset,
                   txgain=s.sdr_txgain,
                   master_clock_rate=s.sdr_master_clock_rate)


def _load_lms_api():
    """Build the Pythonic LMS facade over libLimeSuite with ctypes.

    Binds the entry points and struct layouts of the stable public
    LimeSuite.h C API (LimeSuite v17+); raises ImportError when the library
    is absent so `sdr._load_lime_device` falls back to the informative
    missing-driver stub.  Each facade method raises RuntimeError with
    LMS_GetLastErrorMessage text on a negative status."""
    import ctypes as ct  # noqa: PLC0415
    import ctypes.util  # noqa: PLC0415
    name = ctypes.util.find_library("LimeSuite") or "libLimeSuite.so"
    try:
        lib = ct.CDLL(name)
    except OSError as e:
        raise ImportError(f"libLimeSuite not available: {e}") from e

    double = ct.c_double          # LimeSuite float_type

    class StreamT(ct.Structure):  # lms_stream_t
        _fields_ = [("handle", ct.c_size_t), ("isTx", ct.c_bool),
                    ("channel", ct.c_uint32), ("fifoSize", ct.c_uint32),
                    ("throughputVsLatency", ct.c_float),
                    ("dataFmt", ct.c_int)]

    class StreamMetaT(ct.Structure):  # lms_stream_meta_t
        _fields_ = [("timestamp", ct.c_uint64),
                    ("waitForTimestamp", ct.c_bool),
                    ("flushPartialPacket", ct.c_bool)]

    class StreamStatusT(ct.Structure):  # lms_stream_status_t
        _fields_ = [("active", ct.c_bool),
                    ("fifoFilledCount", ct.c_uint32),
                    ("fifoSize", ct.c_uint32), ("underrun", ct.c_uint32),
                    ("overrun", ct.c_uint32),
                    ("droppedPackets", ct.c_uint32),
                    ("sampleRate", double), ("linkRate", double),
                    ("timestamp", ct.c_uint64)]

    lib.LMS_GetLastErrorMessage.restype = ct.c_char_p
    LMS_FMT = {"f32": 0, "i16": 1, "i12": 2}

    class _CtypesLms:
        LMS_CH_TX = 1            # bool dir_tx
        LMS_CLOCK_CGEN = 3       # LimeSuite.h LMS_CLOCK_CGEN
        LMS_PATH_TX2 = 2         # TX antenna path index
        LMS_GFIR3 = 2            # lms_gfir_t

        def __init__(self):
            self._lib = lib
            self._dev = ct.c_void_p()

        def _ck(self, status, what):
            if status < 0:
                msg = (lib.LMS_GetLastErrorMessage() or b"").decode()
                raise RuntimeError(f"LMS {what} failed: {msg}")
            return status

        # ------------------------------------------------------ lifecycle
        def open(self, device_args=""):
            n = self._ck(lib.LMS_GetDeviceList(None), "GetDeviceList")
            if n < 1:
                raise RuntimeError("Cannot find LimeSDR output device")
            info = (ct.c_char * 256 * n)()
            self._ck(lib.LMS_GetDeviceList(info), "GetDeviceList")
            self._ck(lib.LMS_Open(ct.byref(self._dev), info[0], None),
                     "Open")

        def reset(self):
            self._ck(lib.LMS_Reset(self._dev), "Reset")

        def init(self):
            self._ck(lib.LMS_Init(self._dev), "Init")

        def close(self):
            lib.LMS_Close(self._dev)

        # -------------------------------------------------------- control
        def enable_channel(self, dir_tx, chan, enabled):
            self._ck(lib.LMS_EnableChannel(self._dev, ct.c_bool(dir_tx),
                                           ct.c_size_t(chan),
                                           ct.c_bool(enabled)),
                     "EnableChannel")

        def set_sample_rate(self, rate, oversample):
            self._ck(lib.LMS_SetSampleRate(self._dev, double(rate),
                                           ct.c_size_t(oversample)),
                     "SetSampleRate")

        def get_sample_rate(self, dir_tx, chan):
            host, rf = double(), double()
            self._ck(lib.LMS_GetSampleRate(self._dev, ct.c_bool(dir_tx),
                                           ct.c_size_t(chan),
                                           ct.byref(host), ct.byref(rf)),
                     "GetSampleRate")
            return host.value

        def set_clock_freq(self, clk_id, freq):
            self._ck(lib.LMS_SetClockFreq(self._dev, ct.c_size_t(clk_id),
                                          double(freq)), "SetClockFreq")

        def get_clock_freq(self, clk_id):
            out = double()
            self._ck(lib.LMS_GetClockFreq(self._dev, ct.c_size_t(clk_id),
                                          ct.byref(out)), "GetClockFreq")
            return out.value

        def set_lo_frequency(self, dir_tx, chan, freq):
            self._ck(lib.LMS_SetLOFrequency(self._dev, ct.c_bool(dir_tx),
                                            ct.c_size_t(chan),
                                            double(freq)),
                     "SetLOFrequency")

        def get_lo_frequency(self, dir_tx, chan):
            out = double()
            self._ck(lib.LMS_GetLOFrequency(self._dev, ct.c_bool(dir_tx),
                                            ct.c_size_t(chan),
                                            ct.byref(out)),
                     "GetLOFrequency")
            return out.value

        def set_normalized_gain(self, dir_tx, chan, gain):
            self._ck(lib.LMS_SetNormalizedGain(
                self._dev, ct.c_bool(dir_tx), ct.c_size_t(chan),
                double(gain)), "SetNormalizedGain")

        def get_normalized_gain(self, dir_tx, chan):
            out = double()
            self._ck(lib.LMS_GetNormalizedGain(
                self._dev, ct.c_bool(dir_tx), ct.c_size_t(chan),
                ct.byref(out)), "GetNormalizedGain")
            return out.value

        def set_antenna(self, dir_tx, chan, path):
            self._ck(lib.LMS_SetAntenna(self._dev, ct.c_bool(dir_tx),
                                        ct.c_size_t(chan),
                                        ct.c_size_t(path)), "SetAntenna")

        def calibrate(self, dir_tx, chan, bw, flags):
            self._ck(lib.LMS_Calibrate(self._dev, ct.c_bool(dir_tx),
                                       ct.c_size_t(chan), double(bw),
                                       ct.c_uint(flags)), "Calibrate")

        def set_gfir_coeff(self, dir_tx, chan, gfir, coeff):
            arr = np.ascontiguousarray(coeff, np.float64)
            self._ck(lib.LMS_SetGFIRCoeff(
                self._dev, ct.c_bool(dir_tx), ct.c_size_t(chan),
                ct.c_int(gfir),
                arr.ctypes.data_as(ct.POINTER(double)),
                ct.c_size_t(arr.size)), "SetGFIRCoeff")

        def enable_gfir(self, dir_tx, chan, gfir, enabled):
            self._ck(lib.LMS_SetGFIR(self._dev, ct.c_bool(dir_tx),
                                     ct.c_size_t(chan), ct.c_int(gfir),
                                     ct.c_bool(enabled)), "SetGFIR")

        def set_lpfbw(self, dir_tx, chan, bw):
            self._ck(lib.LMS_SetLPFBW(self._dev, ct.c_bool(dir_tx),
                                      ct.c_size_t(chan), double(bw)),
                     "SetLPFBW")

        def get_lpfbw(self, dir_tx, chan):
            out = double()
            self._ck(lib.LMS_GetLPFBW(self._dev, ct.c_bool(dir_tx),
                                      ct.c_size_t(chan), ct.byref(out)),
                     "GetLPFBW")
            return out.value

        def get_chip_temperature(self, index):
            out = double()
            self._ck(lib.LMS_GetChipTemperature(self._dev,
                                                ct.c_size_t(index),
                                                ct.byref(out)),
                     "GetChipTemperature")
            return out.value

        # ------------------------------------------------------ streaming
        def setup_stream(self, channel, fifo_size, throughput_vs_latency,
                         is_tx, data_fmt):
            st = StreamT(handle=0, isTx=is_tx, channel=channel,
                         fifoSize=fifo_size,
                         throughputVsLatency=throughput_vs_latency,
                         dataFmt=LMS_FMT[data_fmt])
            self._ck(lib.LMS_SetupStream(self._dev, ct.byref(st)),
                     "SetupStream")
            return st

        def start_stream(self, st):
            self._ck(lib.LMS_StartStream(ct.byref(st)), "StartStream")

        def stop_stream(self, st):
            lib.LMS_StopStream(ct.byref(st))

        def destroy_stream(self, st):
            lib.LMS_DestroyStream(self._dev, ct.byref(st))

        def send_stream(self, st, buf, num_samples, timeout_ms):
            arr = np.ascontiguousarray(buf, np.int16)
            meta = StreamMetaT(timestamp=0, waitForTimestamp=False,
                               flushPartialPacket=True)
            return lib.LMS_SendStream(
                ct.byref(st), arr.ctypes.data_as(ct.c_void_p),
                ct.c_size_t(num_samples), ct.byref(meta),
                ct.c_uint(timeout_ms))

        def get_stream_status(self, st):
            status = StreamStatusT()
            lib.LMS_GetStreamStatus(ct.byref(st), ct.byref(status))
            return {"underrun": status.underrun,
                    "overrun": status.overrun,
                    "dropped_packets": status.droppedPackets,
                    "fifo_filled_count": status.fifoFilledCount,
                    "fifo_size": status.fifoSize}

    return _CtypesLms()


class LimeDevice(SdrDevice):
    """LimeSDR driver (ref: src/output/Lime.cpp:92-451).

    `lms` is the injectable facade; its methods mirror the LMS C API but are
    Pythonic (raise/return values instead of status-int + out-params):
    open/reset/init/enable_channel/set_sample_rate/get_sample_rate/
    set_clock_freq/get_clock_freq/set_lo_frequency/get_lo_frequency/
    set_normalized_gain/get_normalized_gain/set_antenna/calibrate/
    set_gfir_coeff/enable_gfir/setup_stream/start_stream/send_stream/
    get_stream_status/set_lpfbw/get_lpfbw/get_chip_temperature/
    stop_stream/destroy_stream/close.
    """

    def __init__(self, conf: LimeConfig | None = None, lms=None):
        self.conf = c = conf or LimeConfig()
        if lms is None:
            lms = _load_lms_api()
        self._lms = lms
        self._channel = 0
        self._interpolate = max(1, int(c.upsample))

        log.info("Lime: creating the device with: %r", c.device_args)
        lms.open(c.device_args)
        lms.reset()
        lms.init()

        if c.master_clock_rate:
            # CGEN clock (ref: src/output/Lime.cpp:131-148)
            lms.set_clock_freq(lms.LMS_CLOCK_CGEN, c.master_clock_rate)
            log.info("Lime: master clock rate set to %.4f",
                     lms.get_clock_freq(lms.LMS_CLOCK_CGEN))

        lms.enable_channel(lms.LMS_CH_TX, self._channel, True)
        lms.set_sample_rate(c.sample_rate * self._interpolate, 0)
        log.info("Lime: sample rate set to %.4f kHz",
                 lms.get_sample_rate(lms.LMS_CH_TX, self._channel) / 1e3)

        self.tune(c.lo_offset, c.frequency)
        log.info("Lime: actual frequency %.3f kHz", self.frequency / 1e3)

        # normalised 0..1 gain from the 0..100 config value
        # (ref: src/output/Lime.cpp:181-186)
        lms.set_normalized_gain(lms.LMS_CH_TX, self._channel,
                                c.txgain / 100.0)
        self.txgain = c.txgain
        lms.set_antenna(lms.LMS_CH_TX, self._channel, lms.LMS_PATH_TX2)
        # minimal-bandwidth calibration (ref: src/output/Lime.cpp:194-199)
        lms.calibrate(lms.LMS_CH_TX, self._channel, 2.5e6, 0)

        if self._interpolate == 1:
            lms.set_gfir_coeff(lms.LMS_CH_TX, self._channel, lms.LMS_GFIR3,
                               GFIR3_COEFF_INTERP1)
        else:
            raise RuntimeError(
                f"Unsupported interpolate: {self._interpolate}")

        # 10-frame FIFO, I16 wire format (ref: src/output/Lime.cpp:229-243)
        samplerate_ratio = c.sample_rate // 2_048_000
        fifo_size = FRAME_LENGTH * self._interpolate * samplerate_ratio \
            * FIFO_FRAMES
        self._stream = lms.setup_stream(
            channel=self._channel, fifo_size=fifo_size,
            throughput_vs_latency=2.0, is_tx=True, data_fmt="i16")
        lms.start_stream(self._stream)
        lms.enable_gfir(lms.LMS_CH_TX, self._channel, lms.LMS_GFIR3, True)

        self.underflows = 0
        self.overflows = 0
        self.dropped_packets = 0
        self.num_frames_modulated = 0
        self._last_fifo_fill_percent = 0.0

    # ------------------------------------------------------------- control
    def tune(self, lo_offset: float, frequency: float):
        if frequency == 0:
            return
        # the reference ignores lo_offset for Lime
        # (ref: src/output/Lime.cpp:258-267)
        self._lms.set_lo_frequency(self._lms.LMS_CH_TX, self._channel,
                                   frequency)
        self.frequency = float(self._lms.get_lo_frequency(
            self._lms.LMS_CH_TX, self._channel))
        self.lo_offset = 0.0

    def get_tx_freq(self) -> float:
        return float(self._lms.get_lo_frequency(self._lms.LMS_CH_TX,
                                                self._channel))

    def set_txgain(self, gain: float):
        self.conf.txgain = gain
        self._lms.set_normalized_gain(self._lms.LMS_CH_TX, self._channel,
                                      gain / 100.0)
        self.txgain = float(gain)

    def get_txgain(self) -> float:
        return float(self._lms.get_normalized_gain(
            self._lms.LMS_CH_TX, self._channel)) * 100.0

    def set_bandwidth(self, bandwidth: float):
        self._lms.set_lpfbw(self._lms.LMS_CH_TX, self._channel, bandwidth)

    def get_bandwidth(self) -> float:
        return float(self._lms.get_lpfbw(self._lms.LMS_CH_TX, self._channel))

    def get_temperature(self) -> float | None:
        try:
            return float(self._lms.get_chip_temperature(0))
        except RuntimeError as e:
            log.error("Error getting LimeSDR temperature: %s", e)
            return None

    def get_real_secs(self) -> float:
        # the reference has no hardware-time support for Lime
        # (ref: src/output/Lime.cpp:332-336)
        return 0.0

    # ------------------------------------------------------------ transmit
    @staticmethod
    def _s16_from_float(flat: np.ndarray) -> np.ndarray:
        """Reference conversion: clamp to +-1, scale 32767, round to nearest
        away from zero (ref: src/output/Lime.cpp:57-90)."""
        v = np.clip(flat, -1.0, 1.0) * 32767.0
        return (v + np.copysign(0.5, v)).astype(np.int16)

    def transmit_frame(self, samples: np.ndarray,
                       ts: FrameTimestamp | None):
        """Untimed FIFO send with per-call stream-status accounting
        (ref: src/output/Lime.cpp:386-451)."""
        if np.issubdtype(samples.dtype, np.integer):
            from .sdr import sc16_pairs
            buf = np.ascontiguousarray(sc16_pairs(samples).reshape(-1))
        else:
            flat = np.ascontiguousarray(samples, np.float32).reshape(-1)
            buf = self._s16_from_float(flat)
        num_samples = buf.shape[0] // 2

        status = self._lms.get_stream_status(self._stream)
        self.overflows += status.get("overrun", 0)
        self.underflows += status.get("underrun", 0)
        self.dropped_packets += status.get("dropped_packets", 0)
        fifo_size = status.get("fifo_size", 1) or 1
        self._last_fifo_fill_percent = \
            status.get("fifo_filled_count", 0) / fifo_size

        sent = self._lms.send_stream(self._stream, buf, num_samples,
                                     timeout_ms=1000)
        if sent == 0:
            log.info("Lime: zero samples sent")
        elif sent < 0:
            log.error("Error sending LimeSDR stream")
        self.num_frames_modulated += 1

    # ------------------------------------------------------------ counters
    def get_run_statistics(self) -> dict:
        return {"underruns": self.underflows, "overruns": self.overflows,
                "dropped_packets": self.dropped_packets,
                "frames": self.num_frames_modulated,
                "fifo_fill": self._last_fifo_fill_percent * 100}

    def close(self):
        # teardown order per the reference dtor (src/output/Lime.cpp:247-256)
        self._lms.stop_stream(self._stream)
        self._lms.destroy_stream(self._stream)
        self._lms.enable_channel(self._lms.LMS_CH_TX, self._channel, False)
        self._lms.close()
