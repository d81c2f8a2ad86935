"""Automatic gain control loops for the DPD feedback path.

Counterparts of ``python/dpd/RX_Agc.py`` and ``python/dpd/TX_Agc.py``.
Both estimate the (rare, unstable) signal peak from the robust median via
the configured median-to-peak ratio, then steer the analog gains so the
feedback ADC / transmit DAC operate in their linear quantisation range.

The port's copy of dabmod_tpu/dpd/agc.py.
"""
from __future__ import annotations

import time

import numpy as np

from .globalconfig import DpdConfig


class RxAgc:
    """Set the feedback RX gain so the estimated RX peak reaches full
    scale (ref: python/dpd/RX_Agc.py:38-100)."""

    def __init__(self, measure, adapt, c: DpdConfig,
                 settle_s: float = 0.0):
        self.measure = measure
        self.adapt = adapt
        self.min_rxgain = c.RAGC_min_rxgain
        self.max_rxgain = c.RAGC_max_rxgain
        self.rxgain = float(self.min_rxgain)
        self.peak_to_median = 1.0 / c.RAGC_rx_median_target
        self.settle_s = settle_s

    def run(self) -> tuple[bool, str]:
        self.adapt.set_rxgain(self.rxgain)
        time.sleep(self.settle_s)
        tx, _, rx, _ = self.measure.get_samples()
        rx_median = float(np.median(np.abs(rx)))
        if rx_median == 0:
            return False, "RX feedback is silent"
        rx_peak = self.peak_to_median * rx_median
        correction_db = 20.0 * np.log10(1.0 / rx_peak)
        self.rxgain += correction_db
        report = (f"RX median {rx_median:.4f}, estimated peak "
                  f"{rx_peak:.4f}, correction {correction_db:+.2f} dB, "
                  f"new RX gain {self.rxgain:.2f}")
        if self.rxgain < self.min_rxgain:
            # clamp the stored value too: the next run() drives the
            # hardware with self.rxgain and must not push an unsupported
            # gain (ref: python/dpd/RX_Agc.py keeps gain in range)
            self.rxgain = float(self.min_rxgain)
            return False, report + " -- below minimum, RX power too high"
        if self.rxgain > self.max_rxgain:
            self.rxgain = float(self.min_rxgain)
            self.adapt.set_rxgain(self.min_rxgain)
            return False, report + " -- above maximum, increase RX power"
        self.adapt.set_rxgain(self.rxgain)
        time.sleep(self.settle_s)
        return True, report


class TxAgc:
    """Trade analog TX gain against digital gain to keep the TX median in
    a target band and avoid DAC clipping (ref: python/dpd/TX_Agc.py:22-100).
    """

    def __init__(self, adapt, c: DpdConfig, settle_s: float = 0.0):
        self.adapt = adapt
        self.max_txgain = c.TAGC_max_txgain
        self.tx_median_target = c.TAGC_tx_median_target
        self.tx_median_max = c.TAGC_tx_median_max
        self.tx_median_min = c.TAGC_tx_median_min
        self.settle_s = settle_s

    def adapt_if_necessary(self, tx) -> bool:
        """Returns True if gains were changed (caller should re-measure)."""
        tx_median = float(np.median(np.abs(tx)))
        if self.tx_median_min <= tx_median <= self.tx_median_max:
            return False
        delta_db = 20.0 * np.log10(self.tx_median_target / tx_median)
        new_txgain = self.adapt.get_txgain() - delta_db
        if new_txgain >= self.max_txgain:
            raise RuntimeError(
                f"TX AGC failed: new TX gain {new_txgain:.1f} too large")
        digital_factor = 10.0 ** (delta_db / 20.0)
        digital_gain = self.adapt.get_digital_gain() * digital_factor
        # order avoids a transient output power increase
        # (ref: TX_Agc.py:79-91)
        if digital_factor < 1:
            self.adapt.set_digital_gain(digital_gain)
            time.sleep(self.settle_s)
            self.adapt.set_txgain(new_txgain)
        else:
            self.adapt.set_txgain(new_txgain)
            time.sleep(self.settle_s)
            self.adapt.set_digital_gain(digital_gain)
        return True
