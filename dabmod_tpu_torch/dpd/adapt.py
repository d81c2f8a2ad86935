"""Push updated predistorter settings into the running modulator over RC
(port of python/dpd/Adapt.py:57-170).

The reference serialises the coefficients over the RC `coefs` parameter /
coefficient file; here Adapt writes the reference-format coefficient file
(format indicator 1, count, 5 AM + 5 PM coefficients --
src/MemlessPoly.cpp coefficient file reader) and triggers a reload via
`set poly coeffile`.

The port's copy of dabmod_tpu/dpd/adapt.py.
"""
from __future__ import annotations

import os

import numpy as np

from ..rc.client import ModRemoteControl


def write_coef_file(path: str, coefs_am, coefs_pm):
    with open(path, "w") as f:
        f.write("1\n5\n")
        for c in np.asarray(coefs_am, np.float64):
            f.write(f"{float(c)!r}\n")
        for c in np.asarray(coefs_pm, np.float64):
            f.write(f"{float(c)!r}\n")


def write_lut_file(path: str, scalefactor: float, lut):
    """Format indicator 2: scalefactor then 32 're im' entry lines.
    (The reference's own LUT loader, src/MemlessPoly.cpp:203-224, never
    re-reads the entry-count line its serialiser writes and parses only a
    real value per entry; this framework's format keeps the full complex
    correction.)"""
    lut = np.asarray(lut, np.complex64)
    with open(path, "w") as f:
        f.write(f"2\n{float(scalefactor)!r}\n")
        for v in lut:
            f.write(f"{float(v.real)!r} {float(v.imag)!r}\n")


class Adapt:
    def __init__(self, rc_endpoint: str, coef_path: str):
        self.rc = ModRemoteControl(rc_endpoint)
        self.coef_path = coef_path

    def set_predistorter(self, dpddata):
        kind = dpddata[0]
        tmp = self.coef_path + ".tmp"
        if kind == "poly":
            _, coefs_am, coefs_pm = dpddata
            if not (np.all(np.isfinite(coefs_am))
                    and np.all(np.isfinite(coefs_pm))):
                raise ValueError("refusing non-finite poly coefficients")
            write_coef_file(tmp, coefs_am, coefs_pm)
        elif kind == "lut":
            _, scalefactor, lut = dpddata
            if not np.all(np.isfinite(lut)):
                raise ValueError("refusing non-finite LUT entries")
            write_lut_file(tmp, scalefactor, lut)
        else:
            raise ValueError(f"unknown predistorter kind {kind!r}")
        os.replace(tmp, self.coef_path)
        self.rc.set_param_value("poly", "coeffile", self.coef_path)

    def get_digital_gain(self) -> float:
        return float(self.rc.get_param_value("gain", "digital"))

    def set_digital_gain(self, gain: float):
        self.rc.set_param_value("gain", "digital", str(gain))

    # analog gains via the sdr RC module (ref: python/dpd/Adapt.py
    # set_txgain/set_rxgain over the uhd module)
    def get_txgain(self) -> float:
        return float(self.rc.get_param_value("sdr", "txgain"))

    def set_txgain(self, gain: float):
        self.rc.set_param_value("sdr", "txgain", str(gain))

    def get_rxgain(self) -> float:
        return float(self.rc.get_param_value("sdr", "rxgain"))

    def set_rxgain(self, gain: float):
        self.rc.set_param_value("sdr", "rxgain", str(gain))
