"""Modulation error rate of a symbol-aligned DAB burst.

Counterpart of ``python/dpd/MER.py``: take one OFDM symbol (without
cyclic prefix), crop the occupied carriers of its fftshifted spectrum,
split the constellation into the four QPSK quadrants (auto-detecting
axis-aligned vs diagonal orientation) and average the per-point
error-vector magnitude.

The port's copy of dabmod_tpu/dpd/mer.py.
"""
from __future__ import annotations

import numpy as np

from .globalconfig import DpdConfig


def _split_quadrants(x: np.ndarray, y: np.ndarray):
    """Partition constellation samples into 4 clusters.  If the points sit
    on the axes (|x| != |y| on average) split by the rotated quadrants,
    else by the ordinary quadrants (ref: MER.py:33-63)."""
    axis_aligned = 0.5 < np.mean(np.abs(np.abs(x) - np.abs(y))
                                 / np.abs(np.abs(x) + np.abs(y)))
    if axis_aligned:
        masks = [(y < x) & (y > -x), (y > x) & (y > -x),
                 (y > x) & (y < -x), (y < x) & (y < -x)]
    else:
        masks = [(x > 0) & (y > 0), (x < 0) & (y > 0),
                 (x < 0) & (y < 0), (x > 0) & (y < 0)]
    return [(x[m], y[m]) for m in masks]


def _point_mer_db(x: np.ndarray, y: np.ndarray) -> float:
    """MER contribution of one constellation cluster (ref: MER.py:65-75)."""
    xm, ym = np.mean(x), np.mean(y)
    u_rms = np.sqrt(xm * xm + ym * ym)
    u_err = np.mean(np.sqrt((x - xm) ** 2 + (y - ym) ** 2))
    return 20.0 * np.log10(u_err / u_rms)


class Mer:
    def __init__(self, c: DpdConfig):
        self.c = c

    def _spectrum(self, tx: np.ndarray) -> np.ndarray:
        fft = np.fft.fftshift(np.fft.fft(tx))
        return np.delete(fft[self.c.FFT_start:self.c.FFT_end],
                         self.c.FFT_delete)

    def calc_mer(self, tx: np.ndarray) -> float:
        """MER in dB (negative: error below signal) for one T_U-sample
        symbol-aligned slice."""
        if tx.shape[0] != self.c.T_U:
            raise ValueError("wrong input length")
        spec = self._spectrum(tx)
        mers = [_point_mer_db(x, y) for x, y in
                _split_quadrants(np.real(spec), np.imag(spec))]
        return float(20.0 * np.log10(np.mean(
            [10.0 ** (m / 20.0) for m in mers])))
