"""Magnitude-binned LUT predistortion model.

Counterpart of ``python/dpd/Model_Lut.py`` -- whose ``train`` is an empty
stub in the reference.  Here the LUT is actually fitted: TX/RX pairs are
binned by the same top-5-bits index the modulator's LUT applier uses
(src/MemlessPoly.cpp:278-309, ops/filters.memless_lut), and each bin's
complex correction factor is updated towards desired/observed with a
learning rate.

The port's copy of dabmod_tpu/dpd/model_lut.py.
"""
from __future__ import annotations

import numpy as np

LUT_ENTRIES = 32


class Lut:
    def __init__(self, learning_rate: float = 1.0):
        self.learning_rate = learning_rate
        self.reset_coefs()

    def reset_coefs(self):
        # scalefactor maps the amplitude range onto uint32, whose top 5
        # bits select the entry (ref: Model_Lut.py:31-33)
        self.scalefactor = float(0xFFFFFFFF)
        self.lut = np.ones(LUT_ENTRIES, np.complex64)

    def _bin_index(self, tx_abs: np.ndarray) -> np.ndarray:
        scaled = np.clip(np.round(np.nan_to_num(tx_abs) * self.scalefactor),
                         0, 2.0**32 - 1)
        return np.minimum((scaled / float(1 << 27)).astype(np.int64),
                          LUT_ENTRIES - 1)

    def train(self, tx, rx):
        """Update the LUT from aligned complex TX (modulator output) and
        RX (PA output) samples, both normalised to peak <= 1."""
        tx = np.asarray(tx)
        rx = np.asarray(rx)
        ok = np.isfinite(tx) & np.isfinite(rx)
        tx, rx = tx[ok], rx[ok]
        if tx.size == 0:
            return
        ix = self._bin_index(np.abs(tx))
        # per-bin complex gain of the PA: g_b = <rx * conj(tx)> / <|tx|^2>
        num = np.zeros(LUT_ENTRIES, np.complex128)
        den = np.zeros(LUT_ENTRIES, np.float64)
        np.add.at(num, ix, rx * np.conj(tx))
        np.add.at(den, ix, np.abs(tx) ** 2)
        filled = den > 0
        pa_gain = np.ones(LUT_ENTRIES, np.complex128)
        pa_gain[filled] = num[filled] / den[filled]
        # a silent RX burst (or an empty bin) gives a ~0 gain estimate;
        # skip those bins rather than diverging
        good = filled & (np.abs(pa_gain) > 1e-6)
        target = np.ones(LUT_ENTRIES, np.complex128)
        target[good] = 1.0 / pa_gain[good]
        self.lut = (self.lut + self.learning_rate
                    * (target - self.lut)).astype(np.complex64)

    def apply(self, x):
        """Predistort complex samples with the current LUT (host-side
        mirror of the device kernel, for residual evaluation)."""
        x = np.asarray(x)
        return x * self.lut[self._bin_index(np.abs(x))]

    def get_dpd_data(self):
        return ("lut", self.scalefactor, self.lut)
