"""Memoryless polynomial model fitting (port of python/dpd/Model_Poly.py).

AM/AM: tx_est = sum_{i=1..5} c_i * rx^i  (least squares over binned stats)
AM/PM: phase  = sum_{i=0..4} p_i * tx^i

The port's copy of dabmod_tpu/dpd/model_poly.py.
"""
from __future__ import annotations

import numpy as np


class Poly:
    def __init__(self, learning_rate_am: float = 1.0,
                 learning_rate_pm: float = 1.0, mpm_tx_min: float = 0.1):
        self.learning_rate_am = learning_rate_am
        self.learning_rate_pm = learning_rate_pm
        self.mpm_tx_min = mpm_tx_min
        self.reset_coefs()

    def reset_coefs(self):
        self.coefs_am = np.zeros(5, np.float32)
        self.coefs_am[0] = 1
        self.coefs_pm = np.zeros(5, np.float32)

    @staticmethod
    def _am_poly(sig):
        return np.array([sig ** i for i in range(1, 6)]).T

    @staticmethod
    def _pm_poly(sig):
        return np.array([sig ** i for i in range(0, 5)]).T

    def train(self, tx_abs, rx_abs, phase_diff):
        tx_abs = np.asarray(tx_abs, np.float64)
        rx_abs = np.asarray(rx_abs, np.float64)
        phase_diff = np.asarray(phase_diff, np.float64).copy()
        # assume zero phase for small amplitudes (Model_Poly.py
        # _discard_small_values)
        phase_diff[tx_abs < self.mpm_tx_min] = 0

        am_new = np.linalg.lstsq(self._am_poly(rx_abs), tx_abs,
                                 rcond=None)[0]
        pm_new = np.linalg.lstsq(self._pm_poly(tx_abs), phase_diff,
                                 rcond=None)[0]
        self.coefs_am = (self.coefs_am
                         + self.learning_rate_am
                         * (am_new - self.coefs_am)).astype(np.float32)
        self.coefs_pm = (self.coefs_pm
                         + self.learning_rate_pm
                         * (pm_new - self.coefs_pm)).astype(np.float32)

    def am_am(self, rx_abs):
        return self._am_poly(np.asarray(rx_abs)) @ self.coefs_am

    def am_pm(self, tx_abs):
        return self._pm_poly(np.asarray(tx_abs)) @ self.coefs_pm

    def get_dpd_data(self):
        return ("poly", self.coefs_am, self.coefs_pm)
