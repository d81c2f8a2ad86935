"""Output sinks: file (every sample format), ZeroMQ PUB/REP, and the SDR
sinks (io/sdr.py over the device drivers).  The port's copy of
dabmod_tpu/io/outputs.py (src/OutputFile.cpp, src/OutputZeroMQ.cpp,
src/DabMod.cpp:250-363).  Samples arrive as host arrays (the runtime's fetch
thread copies them off the card) and are written as interleaved I/Q,
little endian.
"""
from __future__ import annotations

import logging
import time

import numpy as np

log = logging.getLogger("dabmod_tpu_torch")

F32_FORMATS = ("complexf", "complexf_normalised", "f32", "")


def serialize_iq(iq: np.ndarray, fmt: str) -> bytes:
    return serialize_iq_count(iq, fmt)[0]


def serialize_iq_count(iq: np.ndarray, fmt: str) -> tuple[bytes, int]:
    """Convert samples into the chosen interleaved format with saturation,
    matching FormatConverter semantics (src/FormatConverter.cpp:62-206;
    C float->int conversion truncates), through the native C++ converter
    when available (native.py), else NumPy, as dabmod_tpu's does.

    `iq` is either pair-domain [..., N, 2] float32 (the native layout, which
    is already interleaved I/Q when flattened) or complex."""
    x = np.asarray(iq)
    if np.issubdtype(x.dtype, np.integer):
        # already converted on the device, possibly packed into i32 wire
        # words whose little-endian byte stream equals the narrow stream;
        # the clip count travels in the device stats
        return np.ascontiguousarray(x).tobytes(), 0
    if np.iscomplexobj(x):
        interleaved = np.empty(x.size * 2, np.float32)
        interleaved[0::2] = x.real.reshape(-1)
        interleaved[1::2] = x.imag.reshape(-1)
    else:
        interleaved = np.ascontiguousarray(x, np.float32).reshape(-1)
    if fmt in F32_FORMATS:
        return interleaved.tobytes(), 0
    from .. import native
    conv = native.convert(interleaved, fmt)
    if conv is not None:
        out, n = conv
        return out.tobytes(), n
    if fmt == "s16":
        clipped = np.clip(interleaved, -32768.0, 32767.0)
        n = int((clipped != interleaved).sum())
        return clipped.astype(np.int16).tobytes(), n
    if fmt == "u8":
        shifted = interleaved + 128.0
        clipped = np.clip(shifted, 0.0, 255.0)
        n = int((clipped != shifted).sum())
        return clipped.astype(np.uint8).tobytes(), n
    if fmt == "s8":
        clipped = np.clip(interleaved, -128.0, 127.0)
        n = int((clipped != interleaved).sum())
        return clipped.astype(np.int8).tobytes(), n
    raise ValueError(f"invalid output format {fmt}")


class FileOutput:
    def __init__(self, path: str, fmt: str = "complexf",
                 show_metadata: bool = False):
        self.fmt = fmt
        self.f = open(path, "wb")
        self.num_clipped_samples = 0
        self.show_metadata = show_metadata
        self._last_fct = None
        self._fct_step = None

    def write(self, iq, metadata=None) -> None:
        x = np.asarray(iq)
        if np.issubdtype(x.dtype, np.integer) or (
                x.dtype == np.float32 and self.fmt in F32_FORMATS):
            # already wire bytes (device-side conversion / f32 pairs):
            # stream straight from the array buffer.  num_clipped_samples
            # is left untouched: for device-converted streams the runtime's
            # fetch thread polls the device's clip counter into it
            np.ascontiguousarray(x).tofile(self.f)
        else:
            data, n_clipped = serialize_iq_count(x, self.fmt)
            self.num_clipped_samples = n_clipped
            self.f.write(data)
        if self.show_metadata and metadata is not None:
            entries = metadata if isinstance(metadata, list) else [metadata]
            if len(entries) >= 2:
                # FCT step per TF == the mode's CIFs per frame, inferred
                # from consecutive TF metadata (1 for TM-II/III, 2 TM-IV,
                # 4 TM-I; ref: src/BlockPartitioner.cpp:44-73)
                self._fct_step = (entries[1][0] - entries[0][0]) % 250
            for fct, ts in entries:
                self._show_one(fct, ts)

    def _show_one(self, fct, ts):
        # FCT/TIST continuity display like OutputFile show_metadata
        # (ref: src/OutputFile.cpp:69-139)
        if self._last_fct is not None and self._fct_step:
            expected = (self._last_fct + self._fct_step) % 250
            if fct != expected:
                log.warning("FCT discontinuity in output: %d -> %d",
                            self._last_fct, fct)
        self._last_fct = fct
        if ts is not None and ts.valid:
            log.info("Frame %d TS %.6f offset to wallclock %.3f",
                     fct, ts.as_seconds(), ts.as_seconds() - time.time())

    def close(self):
        self.f.close()


class ZmqOutput:
    """ZMQ PUB or REP sink of raw I/Q (ref: src/OutputZeroMQ.cpp:35-80)."""

    def __init__(self, endpoint: str, socket_type: str = "pub",
                 fmt: str = "complexf"):
        import zmq
        self.fmt = fmt
        self.ctx = zmq.Context.instance()
        kind = {"pub": zmq.PUB, "rep": zmq.REP}[socket_type]
        self.socket_type = socket_type
        self.sock = self.ctx.socket(kind)
        self.sock.bind(endpoint)

    def write(self, iq, metadata=None) -> None:
        """One message a batch; `metadata` (the runtime's per-TF (fct,
        timestamp) list) is not sent, as dabmod_tpu sends none."""
        data = serialize_iq(iq, self.fmt)
        if self.socket_type == "rep":
            # wait for a request before each send, like the reference
            self.sock.recv()
        self.sock.send(data, copy=False)

    def close(self):
        self.sock.close()


def open_output(settings):
    """The sink for settings.output (as dabmod_tpu's open_output)."""
    if settings.output == "file":
        return FileOutput(settings.output_name, settings.file_output_format,
                          settings.file_output_show_metadata)
    if settings.output == "zmq":
        return ZmqOutput(settings.output_name,
                         settings.zmq_output_socket_type,
                         settings.zmq_output_format)
    if settings.output in ("uhd", "soapy", "lime", "bladerf", "dexter",
                           "loopback"):
        return open_sdr_output(settings)
    raise ValueError(f"unsupported output {settings.output!r}")


def open_sdr_output(settings):
    """Construct the async SDR sink over the configured device driver
    (ref: src/DabMod.cpp:250-363 prepare_output SDR branches).  The
    hardware drivers raise when their vendor library is absent; the
    `loopback` device closes the DPD feedback loop without hardware."""
    from . import sdr

    if settings.output == "uhd":
        from .uhd_driver import UhdConfig  # noqa: PLC0415
        device = sdr.UhdDevice(UhdConfig.from_settings(settings))
    elif settings.output == "soapy":
        from .soapy_driver import SoapyConfig  # noqa: PLC0415
        device = sdr.SoapyDevice(SoapyConfig.from_settings(settings))
    elif settings.output == "lime":
        from .lime_driver import LimeConfig  # noqa: PLC0415
        device = sdr.LimeDevice(LimeConfig.from_settings(settings))
    elif settings.output == "bladerf":
        from .bladerf_driver import BladeRFConfig  # noqa: PLC0415
        device = sdr.BladeRFDevice(BladeRFConfig.from_settings(settings))
    elif settings.output == "dexter":
        from .dexter_driver import DexterConfig  # noqa: PLC0415
        device = sdr.DexterDevice(DexterConfig.from_settings(settings))
    else:
        device = sdr.LoopbackSdrDevice()
        device.set_txgain(settings.sdr_txgain)
        device.set_rxgain(settings.sdr_rxgain)
        if settings.sdr_frequency:
            device.tune(settings.sdr_lo_offset, settings.sdr_frequency)
    return sdr.SdrOutput(device, sync=settings.tist_enabled,
                         sample_rate=settings.output_rate,
                         feedback_port=settings.sdr_dpd_port,
                         mute=False,
                         mute_no_timestamps=settings.sdr_mute_no_timestamps)
