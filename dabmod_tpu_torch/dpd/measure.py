"""Fetch aligned TX/RX bursts from the DPD feedback port
(port of python/dpd/Measure.py:16-114; wire protocol identical).

The port's copy of dabmod_tpu/dpd/measure.py.
"""
from __future__ import annotations

import socket
import struct

import numpy as np


class Measure:
    def __init__(self, host: str, port: int, num_samples_to_request: int):
        self.host = host
        self.port = port
        self.num_samples_to_request = num_samples_to_request
        self.sizeof_sample = 8      # complexf

    def _recv_exact(self, sock: socket.socket, num_bytes: int) -> bytes:
        bufs = []
        while num_bytes > 0:
            b = sock.recv(num_bytes)
            if not b:
                # the feedback server closes without replying when no TX
                # frame arrived within its window (modulator still warming
                # up or muted) -- surface that instead of a struct error
                raise RuntimeError(
                    "feedback server returned no burst (modulator not "
                    "transmitting yet?)")
            bufs.append(b)
            num_bytes -= len(b)
        return b"".join(bufs)

    def get_samples(self):
        """Returns (txframe, tx_ts, rxframe, rx_ts) as complex64 arrays and
        float timestamps in seconds."""
        with socket.create_connection((self.host, self.port), timeout=10) as s:
            s.sendall(b"\x01")
            s.sendall(struct.pack("=I", self.num_samples_to_request))
            num_samps, tx_second, tx_pps = struct.unpack(
                "=III", self._recv_exact(s, 12))
            tx_bytes = self._recv_exact(s, num_samps * self.sizeof_sample)
            rx_second, rx_pps = struct.unpack("=II", self._recv_exact(s, 8))
            rx_bytes = self._recv_exact(s, num_samps * self.sizeof_sample)
        tx = np.frombuffer(tx_bytes, np.complex64)
        rx = np.frombuffer(rx_bytes, np.complex64)
        tx_ts = tx_second + tx_pps / 16_384_000.0
        rx_ts = rx_second + rx_pps / 16_384_000.0
        return tx, tx_ts, rx, rx_ts

    def get_samples_aligned(self):
        """One burst, integer/fractional/phase aligned, with the medians
        the AGC loops need (ref: python/dpd/Measure.py:87-114 returns
        (txframe_aligned, tx_ts, rxframe_aligned, rx_ts, rx_median,
        tx_median))."""
        from .align import align_tx_rx

        tx, tx_ts, rx, rx_ts = self.get_samples()
        tx_median = float(np.median(np.abs(tx))) if tx.size else 0.0
        rx_median = float(np.median(np.abs(rx))) if rx.size else 0.0
        tx_a, rx_a = align_tx_rx(tx, rx)
        return tx_a, tx_ts, rx_a, rx_ts, rx_median, tx_median


def phase_align_rx(tx: np.ndarray, rx: np.ndarray) -> np.ndarray:
    """Remove the bulk phase rotation of RX relative to TX, returning the
    rotated RX.  Named distinctly from align.phase_align(sig, ref) --
    which rotates its FIRST argument -- so the two cannot be swapped
    silently (simplified python/dpd/phase_align.py)."""
    corr = np.sum(rx * np.conj(tx))
    if np.abs(corr) == 0:
        return rx
    return rx * np.exp(-1j * np.angle(corr))


# backwards-compat alias (argument order differs from align.phase_align!)
phase_align = phase_align_rx


def normalise_rx(tx: np.ndarray, rx: np.ndarray) -> np.ndarray:
    """Scale rx so its median amplitude matches tx
    (python/dpd/RX_Agc.py role in the loop)."""
    m_rx = np.median(np.abs(rx))
    m_tx = np.median(np.abs(tx))
    if m_rx == 0:
        return rx
    return rx * (m_tx / m_rx)
