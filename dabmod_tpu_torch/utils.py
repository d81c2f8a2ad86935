"""Utility helpers: DAB Band III channel table, frame durations, realtime
scheduling (port of src/Utils.cpp; the port's copy of
dabmod_tpu/utils/__init__.py)."""
from __future__ import annotations

import os

# DAB Band III channel centre frequencies in Hz (src/Utils.cpp:260-306)
CHANNELS = {
    "5A": 174_928_000, "5B": 176_640_000, "5C": 178_352_000, "5D": 180_064_000,
    "6A": 181_936_000, "6B": 183_648_000, "6C": 185_360_000, "6D": 187_072_000,
    "7A": 188_928_000, "7B": 190_640_000, "7C": 192_352_000, "7D": 194_064_000,
    "8A": 195_936_000, "8B": 197_648_000, "8C": 199_360_000, "8D": 201_072_000,
    "9A": 202_928_000, "9B": 204_640_000, "9C": 206_352_000, "9D": 208_064_000,
    "10A": 209_936_000, "10B": 211_648_000, "10C": 213_360_000,
    "10D": 215_072_000,
    "11A": 216_928_000, "11B": 218_640_000, "11C": 220_352_000,
    "11D": 222_064_000,
    "12A": 223_936_000, "12B": 225_648_000, "12C": 227_360_000,
    "12D": 229_072_000,
    "13A": 230_784_000, "13B": 232_496_000, "13C": 234_208_000,
    "13D": 235_776_000, "13E": 237_488_000, "13F": 239_200_000,
}

_FREQ_TO_CHANNEL = {v: k for k, v in CHANNELS.items()}


def parse_channel(chan: str) -> float:
    if chan not in CHANNELS:
        raise ValueError(f"Channel {chan} does not exist in table")
    return float(CHANNELS[chan])


def convert_frequency_to_channel(frequency: float) -> str | None:
    return _FREQ_TO_CHANNEL.get(int(round(frequency)))


def transmission_frame_duration_ms(dabmode: int) -> int:
    """(src/Utils.cpp:355-365)"""
    return {1: 96, 2: 24, 3: 24, 4: 48}[dabmode]


def set_realtime_prio(prio: int = 1) -> bool:
    """Best-effort SCHED_RR like the reference (src/Utils.cpp:243)."""
    try:
        os.sched_setscheduler(0, os.SCHED_RR, os.sched_param(prio))
        return True
    except (PermissionError, OSError):
        return False
