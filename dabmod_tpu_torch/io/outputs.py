"""Output sinks: the file sink (every sample format).  The port's copy of
dabmod_tpu/io/outputs.py's serialize_iq_count, FileOutput and
open_output (src/OutputFile.cpp); the ZeroMQ and SDR sinks are not ported
yet (ROADMAP A10(b)).  Samples arrive as host arrays (the runtime's fetch
thread copies them off the card) and are written as interleaved I/Q,
little endian.
"""
from __future__ import annotations

import logging
import time

import numpy as np

log = logging.getLogger("dabmod_tpu_torch")

F32_FORMATS = ("complexf", "complexf_normalised", "f32", "")


def serialize_iq_count(iq: np.ndarray, fmt: str) -> tuple[bytes, int]:
    """Convert samples into the chosen interleaved format with saturation,
    matching FormatConverter semantics (src/FormatConverter.cpp:62-206;
    C float->int conversion truncates).  dabmod_tpu's NumPy branch (its
    native C++ converter is not part of the port).

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


def open_output(settings):
    """The file sink for settings.output == "file".  The ZeroMQ and SDR
    sinks raise NotImplementedError: they come with ROADMAP A10(b)."""
    if settings.output == "file":
        return FileOutput(settings.output_name, settings.file_output_format,
                          settings.file_output_show_metadata)
    if settings.output in ("zmq", "uhd", "soapy", "lime", "bladerf",
                           "dexter", "loopback"):
        raise NotImplementedError(
            f"output {settings.output!r} is not ported to dabmod_tpu_torch "
            f"yet (ROADMAP A10(b))")
    raise ValueError(f"unsupported output {settings.output!r}")
