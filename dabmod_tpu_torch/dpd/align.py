"""TX/RX burst alignment for the DPD engine.

Counterparts of the reference's ``python/dpd/Dab_Util.py`` (coarse lag +
crop), ``subsample_align.py`` (frequency-domain fractional-delay search),
``phase_align.py`` (median bulk-phase removal) and ``Symbol_align.py``
(cyclic-prefix correlation symbol sync).  The algorithms are re-derived
from the reference's behavior but vectorised: the lag search uses an FFT
cross-correlation instead of a direct ``signal.correlate``, and the symbol
search builds its moving minimum with a sliding-window view.

The port's copy of dabmod_tpu/dpd/align.py.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage, optimize

from .globalconfig import DpdConfig


# ---------------------------------------------------------------------------
# Coarse alignment (ref: python/dpd/Dab_Util.py lag/subsample_align)
# ---------------------------------------------------------------------------


def lag(sig_orig: np.ndarray, sig_rec: np.ndarray) -> int:
    """Integer lag of `sig_rec` relative to `sig_orig` (positive: the
    recording starts later), from the peak of the cross-correlation."""
    n = int(sig_orig.shape[0] + sig_rec.shape[0])
    nfft = 1 << (n - 1).bit_length()
    X = np.fft.fft(sig_orig, nfft)
    Y = np.fft.fft(sig_rec, nfft)
    corr = np.fft.ifft(X * np.conj(Y))
    # index k = lag of sig_rec behind sig_orig (mod nfft)
    k = int(np.argmax(np.abs(corr)))
    if k > nfft // 2:
        k -= nfft
    return -k


def coarse_align(sig_tx: np.ndarray, sig_rx: np.ndarray):
    """Crop the two signals to their overlapping, integer-aligned region
    (ref: Dab_Util.subsample_align crop logic)."""
    off = lag(sig_tx, sig_rx)
    if off > 0:
        sig_tx = sig_tx[:-off]
        sig_rx = sig_rx[off:]
    elif off < 0:
        sig_tx = sig_tx[-off:]
        sig_rx = sig_rx[:off]
    n = min(sig_tx.shape[0], sig_rx.shape[0])
    n -= n % 2  # subsample_align needs an even length
    return sig_tx[:n], sig_rx[:n]


# ---------------------------------------------------------------------------
# Subsample alignment (ref: python/dpd/subsample_align.py:28-88)
# ---------------------------------------------------------------------------


def _omega(n: int) -> np.ndarray:
    w = np.fft.fftfreq(n, d=1.0 / (2.0 * np.pi))
    return w


def subsample_align(sig: np.ndarray, ref_sig: np.ndarray) -> np.ndarray:
    """Shift `sig` by a fractional sample delay tau in (-1, 1) chosen to
    maximise correlation with `ref_sig`; the shift is applied as a linear
    phase ramp in the frequency domain."""
    n = sig.shape[0]
    if n % 2:
        raise ValueError("needs an even-length signal")
    half = n // 2
    fft_sig = np.fft.fft(sig)
    omega = _omega(n)

    def neg_corr(tau: float) -> float:
        rot = np.exp(1j * tau * omega)
        # the Nyquist bin is its own conjugate: keep the shift real there
        rot[half] = np.cos(np.pi * tau)
        shifted = np.fft.ifft(rot * fft_sig)
        return -float(np.abs(np.sum(np.conj(shifted) * ref_sig)))

    res = optimize.minimize_scalar(neg_corr, bounds=(-1, 1),
                                   method="bounded")
    if not res.success:
        return np.zeros(0, np.complex64)
    rot = np.exp(1j * res.x * omega)
    rot[half] = np.cos(np.pi * res.x)
    return np.fft.ifft(rot * fft_sig).astype(np.complex64)


# ---------------------------------------------------------------------------
# Bulk phase alignment (ref: python/dpd/phase_align.py:9-77)
# ---------------------------------------------------------------------------


def phase_align(sig: np.ndarray, ref_sig: np.ndarray) -> np.ndarray:
    """Remove the median phase offset of `sig` relative to `ref_sig`.
    The median of cos/sin of the per-sample angle difference is robust
    against the low-amplitude samples that dominate a mean."""
    diff = (np.angle(sig) - np.angle(ref_sig)) % (2.0 * np.pi)
    angle = np.angle(np.median(np.cos(diff)) + 1j * np.median(np.sin(diff)))
    return sig * np.exp(-1j * angle)


# ---------------------------------------------------------------------------
# Symbol alignment (ref: python/dpd/Symbol_align.py)
# ---------------------------------------------------------------------------


def _remove_outliers(x: np.ndarray, stds: float = 5.0) -> np.ndarray:
    dev = np.abs(x - np.mean(x))
    return x[dev < stds * np.std(x)]


def _delta_angle(fft_crop: np.ndarray) -> float:
    """Mean carrier-to-carrier phase slope, invariant against the QPSK
    constellation (angles folded mod pi/2, jumps unwrapped)."""
    angles = np.angle(fft_crop) % (np.pi / 2.0)
    d = np.diff(angles)
    d[d > np.pi / 4.0] -= np.pi / 2.0
    d[-d > np.pi / 4.0] += np.pi / 2.0
    return float(np.mean(_remove_outliers(d)))


class SymbolAlign:
    """Find the sample offset of the first OFDM symbol (without cyclic
    prefix) in an unaligned DAB burst.

    Two stages, as in the reference: a cyclic-prefix self-similarity
    search for the symbol boundary modulo T_S, then a spectral phase-slope
    estimate for the residual few-sample offset.
    """

    def __init__(self, c: DpdConfig):
        self.c = c

    def _offset_to_first_symbol(self, tx: np.ndarray) -> int:
        c = self.c
        # |x[n] - x[n+T_U]| vanishes over each cyclic prefix
        d = np.abs(tx[:-c.T_U] - tx[c.T_U:])
        avg = np.correlate(d, np.ones(c.T_C), mode="valid")
        floor = ndimage.minimum_filter1d(avg, int(1.5 * c.T_S))
        peaks = np.flatnonzero(avg == floor)
        offset = int(peaks[np.argmin(avg[peaks])])
        # the match point is the prefix start; symbol body begins T_C later
        return (offset + c.T_C) % c.T_S

    def _sample_offset(self, sig: np.ndarray) -> int:
        c = self.c
        if sig.shape[0] != c.T_U:
            raise ValueError("need exactly one symbol without prefix")
        fft = np.fft.fftshift(np.fft.fft(sig))
        crop = np.delete(fft[c.FFT_start:c.FFT_end], c.FFT_delete)
        delta = -_delta_angle(crop) / c.phase_offset_per_sample
        delta_int = int(np.round(delta))
        if abs(delta_int - delta) > 0.1:
            raise RuntimeError(
                f"could not resolve sample offset ({delta:.3f})")
        return delta_int

    def calc_offset(self, tx: np.ndarray) -> int:
        off_sym = self._offset_to_first_symbol(tx)
        off_sam = self._sample_offset(tx[off_sym:off_sym + self.c.T_U])
        off = (off_sym + off_sam) % self.c.T_S
        if self._sample_offset(tx[off:off + self.c.T_U]) != 0:
            raise RuntimeError("failed to converge on symbol offset")
        return off

    def crop_symbol_without_cyclic_prefix(self, tx: np.ndarray):
        off = self.calc_offset(tx)
        return tx[off:off + self.c.T_U]


def align_tx_rx(sig_tx: np.ndarray, sig_rx: np.ndarray):
    """Full alignment pipeline used by Measure: coarse integer lag crop,
    fractional-delay correction of RX, then bulk phase removal
    (ref: python/dpd/Measure.py:87-103)."""
    tx, rx = coarse_align(np.asarray(sig_tx), np.asarray(sig_rx))
    if tx.size == 0:
        return tx, rx
    rx_sub = subsample_align(rx, tx)
    if rx_sub.size:
        rx = rx_sub
    rx = phase_align(rx, tx)
    return tx.astype(np.complex64), rx.astype(np.complex64)
