"""Shoulder measurement: spectral regrowth of the PA output.

Counterpart of ``python/dpd/Measure_Shoulders.py``: averages, over many
window offsets, the dB difference between the in-band DAB plateau and the
adjacent-channel "shoulders" at +-976 kHz.  The reference fans the
per-offset FFTs over a multiprocessing pool; here all windows are one
batched ``np.fft.fft`` call.

The port's copy of dabmod_tpu/dpd/shoulders.py.
"""
from __future__ import annotations

import numpy as np

from .globalconfig import DpdConfig


def calc_shoulder(fft_db: np.ndarray, c: DpdConfig):
    """(peak, shoulder) mean levels of one fftshifted dB spectrum
    (ref: Measure_Shoulders.py:33-55)."""
    peak = float(np.mean(fft_db[..., c.MS_peak_start:c.MS_peak_end]))
    left = np.mean(fft_db[..., c.MS_shoulder_left_start:
                          c.MS_shoulder_left_end])
    right = np.mean(fft_db[..., c.MS_shoulder_right_start:
                           c.MS_shoulder_right_end])
    return peak, float((left + right) / 2.0)


class MeasureShoulders:
    def __init__(self, c: DpdConfig):
        self.c = c

    def average_shoulders(self, signal: np.ndarray, n_avg: int | None = None):
        """Returns (mean shoulder distance dB, mean shoulder, mean peak)
        over `n_avg` windows spread across the burst, or None if
        disabled."""
        c = self.c
        if not c.MS_enable:
            return None
        if signal.shape[0] <= c.MS_FFT_size:
            raise ValueError("signal shorter than one measurement window")
        n_avg = n_avg or c.MS_averaging_size
        offsets = np.linspace(0, signal.shape[0] - c.MS_FFT_size,
                              num=n_avg, dtype=int)
        windows = np.stack([signal[o:o + c.MS_FFT_size] for o in offsets])
        spec = np.fft.fftshift(np.fft.fft(windows, axis=-1), axes=-1)
        fft_db = 20.0 * np.log10(np.abs(spec) + 1e-30)
        # one window-slicing definition: calc_shoulder handles the whole
        # batch via its leading-... indexing, and mean(per-window diffs)
        # == mean(peaks) - mean(shoulders) exactly (equal window sizes)
        peak, shoulder = calc_shoulder(fft_db, c)
        return (peak - shoulder, shoulder, peak)
