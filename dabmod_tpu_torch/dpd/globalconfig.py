"""DPD engine configuration constants.

Counterpart of the reference's ``python/dpd/GlobalConfig.py`` (which is
hard-wired to the 4x oversampled 8.192 MS/s feedback rate); here every
constant is derived from the sample rate so the engine also works on the
native 2.048 MS/s rate used in loopback tests.

The port's copy of dabmod_tpu/dpd/globalconfig.py.
"""
from __future__ import annotations

import numpy as np


class DpdConfig:
    """Derived DAB timing/frequency constants for the DPD engine.

    ref: python/dpd/GlobalConfig.py:10-77
    """

    def __init__(self, sample_rate: int = 8_192_000,
                 plot_location: str | None = None):
        if sample_rate % 2_048_000:
            raise ValueError("sample rate must be a multiple of 2.048 MS/s")
        oversample = sample_rate // 2_048_000
        self.sample_rate = sample_rate
        self.plot_location = plot_location

        # TM-I frame timing at the oversampled rate
        self.T_F = oversample * 196_608     # transmission frame
        self.T_NULL = oversample * 2656     # NULL symbol
        self.T_S = oversample * 2552        # data symbol incl. cyclic prefix
        self.T_U = oversample * 2048        # symbol without prefix
        self.T_C = oversample * 504         # cyclic prefix

        self.median_to_peak = 12            # typical for DAB OFDM

        # Occupied-carrier window of an fftshifted T_U-point spectrum:
        # 1536 carriers at 1 kHz spacing around DC, DC itself unused.
        centre = self.T_U // 2
        self.FFT_delta = 1536
        self.FFT_start = centre - 768
        self.FFT_end = centre + 769
        self.FFT_delete = 768               # DC index within the crop

        # 1 kHz carrier spacing: phase slope of a one-sample offset
        self.phase_offset_per_sample = 2.0 * np.pi * 1000.0 / sample_rate

        # ExtractStatistic binning
        self.ES_end = 1.0
        self.ES_n_bins = 64
        self.ES_n_per_bin = 128

        # Shoulder measurement windows: +-976 kHz offset, 100 kHz wide
        # (ref GlobalConfig.py:44-58).  The reference's edge-based index
        # arithmetic only lands in-range at its hard-wired 4x rate; it is
        # kept verbatim there and replaced by the direct spectral
        # positions at other rates.
        self.MS_enable = True
        self.MS_FFT_size = 2048 * oversample
        meas_offset = 976
        meas_width = 100
        if oversample == 4:
            edge = abs(meas_offset - self.FFT_delta)
            left_centre = self.FFT_start - edge
            right_centre = self.FFT_end + edge
        else:
            left_centre = centre - meas_offset
            right_centre = centre + meas_offset
        clamp = lambda i: int(min(max(i, 0), self.MS_FFT_size))  # noqa: E731
        self.MS_shoulder_left_start = clamp(left_centre - meas_width / 2)
        self.MS_shoulder_left_end = clamp(left_centre + meas_width / 2)
        self.MS_shoulder_right_start = clamp(right_centre - meas_width / 2)
        self.MS_shoulder_right_end = clamp(right_centre + meas_width / 2)
        self.MS_peak_start = self.FFT_start + 100
        self.MS_peak_end = self.FFT_end - 100
        self.MS_averaging_size = 40

        # Model_Poly: zero the phase fit below this TX amplitude
        self.MPM_tx_min = 0.1

        # RX AGC (B200-flavoured defaults kept from the reference)
        self.RAGC_min_rxgain = 25
        self.RAGC_max_rxgain = 65
        self.RAGC_rx_median_target = 0.05

        # TX AGC
        self.TAGC_max_txgain = 89
        self.TAGC_tx_median_target = 0.1
        self.TAGC_tx_median_max = self.TAGC_tx_median_target * 1.4
        self.TAGC_tx_median_min = self.TAGC_tx_median_target / 1.4
