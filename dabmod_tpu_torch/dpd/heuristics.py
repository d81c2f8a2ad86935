"""Adaptation schedules for the DPD engine
(ref: python/dpd/Heuristics.py:9-33).

The port's copy of dabmod_tpu/dpd/heuristics.py.
"""
from __future__ import annotations


def get_learning_rate(idx_run: int) -> float:
    """Anneal the learning rate from 0.4 down to 0.05 over the first 10
    iterations, then hold."""
    idx_max, lr_min, lr_max = 10.0, 0.05, 0.4
    t = min(idx_run, idx_max) / idx_max
    return lr_max - (lr_max - lr_min) * t


def get_n_meas(idx_run: int) -> int:
    """Grow the number of bursts per statistic from 10 to 20 over the
    first 10 iterations, then hold."""
    idx_max, n_min, n_max = 10.0, 10, 20
    t = min(idx_run, idx_max) / idx_max
    return int(round(n_min + (n_max - n_min) * t))
