"""Binned AM/AM + AM/PM statistics from TX/RX sample pairs
(port of python/dpd/ExtractStatistic.py).

The port's copy of dabmod_tpu/dpd/extract_statistic.py.
"""
from __future__ import annotations

import numpy as np


class ExtractStatistic:
    def __init__(self, n_bins: int = 64, n_per_bin: int = 128,
                 peak_amplitude: float = 1.0):
        self.n_bins = n_bins
        self.n_per_bin = n_per_bin
        self.tx_boundaries = np.linspace(0.0, peak_amplitude, n_bins + 1)
        self.rx_values = [[] for _ in range(n_bins)]
        self.tx_values = [[] for _ in range(n_bins)]
        self.phase_diffs = [[] for _ in range(n_bins)]
        self.n_meas = 0

    def extract(self, tx: np.ndarray, rx: np.ndarray):
        """Accumulate one measurement; returns (tx_avg, rx_avg, phase_diff)
        arrays over the bins that have enough samples."""
        self.n_meas += 1
        tx_abs = np.abs(tx)
        rx_abs = np.abs(rx)
        phase = np.angle(rx * np.conj(tx))
        for i in range(self.n_bins):
            lo, hi = self.tx_boundaries[i], self.tx_boundaries[i + 1]
            mask = (tx_abs >= lo) & (tx_abs < hi)
            free = self.n_per_bin - len(self.rx_values[i])
            if free > 0 and np.any(mask):
                idx = np.nonzero(mask)[0][:free]
                self.rx_values[i].extend(rx_abs[idx].tolist())
                self.tx_values[i].extend(tx_abs[idx].tolist())
                self.phase_diffs[i].extend(phase[idx].tolist())
        return self.get_statistic()

    def get_statistic(self):
        tx_avg, rx_avg, ph = [], [], []
        for i in range(self.n_bins):
            if len(self.rx_values[i]) >= max(1, self.n_per_bin // 8):
                tx_avg.append(np.mean(self.tx_values[i]))
                rx_avg.append(np.mean(self.rx_values[i]))
                ph.append(np.mean(self.phase_diffs[i]))
        return (np.array(tx_avg), np.array(rx_avg), np.array(ph))
