"""Modulator settings: the port's copy of the fields of
dabmod_tpu.config.ModSettings (the reference's mod_settings_t,
src/ConfigParser.h:44-95) that the modulator reads, under the same names
and defaults; fft_engine=kiss|dexter, which the port does not have yet,
makes the Modulator raise NotImplementedError instead of computing a
silently different signal.  INI parsing comes with the runtime and CLI."""
from __future__ import annotations

import dataclasses

from . import tables

# gain modes (ref: src/GainControl.cpp); same values as dabmod_tpu.ops.ofdm
GAIN_FIX, GAIN_MAX, GAIN_VAR = 0, 1, 2


@dataclasses.dataclass
class ModSettings:
    # output
    output: str = ""                     # file | zmq | uhd | ...
    file_output_format: str = "complexf"
    zmq_output_format: str = "complexf"
    output_rate: int = 2_048_000         # != 2.048 MS/s needs the resampler
    resampler_mode: str = "auto"         # auto | poly | fft (as dabmod_tpu)
    cic_eq_clock_rate: int = 0
    # modulator
    dab_mode: int = 0                    # 0 = derive from ETI MID
    digital_gain: float = 1.0
    gain_mode: int = GAIN_VAR
    gain_mode_variance: float = 4.0
    normalise: float = 1.0
    # CFR
    enable_cfr: bool = False
    cfr_clip: float = 0.0
    cfr_error_clip: float = 0.0
    fft_engine: str = "fftw"             # fftw | kiss | dexter
    ofdm_window_overlap: int = 0
    filter_taps_file: str = ""           # "" disables the FIR
    poly_coef_file: str = ""             # "" disables DPD
    tii_enable: bool = False
    tii_comb: int = 0
    tii_pattern: int = 0
    tii_old_variant: bool = False
    # convert to the wire format (s16, u8, s8) on the device
    device_format_conversion: bool = True
    # interleave re/im into [., 2] pairs on the device for f32 outputs;
    # False returns (re, im) planes for the host writer to interleave
    device_interleave: bool = True
    # accepted for parity with dabmod_tpu; the port computes the transform
    # in fp32 for every value (see ops.fft.set_precision)
    fft_precision: str = "high"          # default | high | highest

    def normalise_for_output(self):
        """Set self.normalise per output type, mirroring prepare_output
        (ref: src/DabMod.cpp:250-363)."""
        if self.output == "file":
            fmt = self.file_output_format
            if fmt == "complexf":
                pass
            elif fmt == "complexf_normalised":
                if self.gain_mode == GAIN_FIX:
                    self.normalise = 1.0 / tables.NORMALISE_FACTOR_FILE_FIX
                elif self.gain_mode == GAIN_MAX:
                    self.normalise = 1.0 / tables.NORMALISE_FACTOR_FILE_MAX
                else:
                    self.normalise = 1.0 / tables.NORMALISE_FACTOR_FILE_VAR
            elif fmt == "s16":
                self.normalise = 32767.0 / tables.NORMALISE_FACTOR_SDR
            elif fmt in ("s8", "u8"):
                self.normalise = 127.0 / tables.NORMALISE_FACTOR_SDR
            else:
                raise ValueError(f"unknown file output format {fmt}")
        elif self.output == "zmq":
            if self.zmq_output_format == "s16":
                self.normalise = 32767.0 / tables.NORMALISE_FACTOR_SDR
            elif self.zmq_output_format in ("s8", "u8"):
                self.normalise = 127.0 / tables.NORMALISE_FACTOR_SDR
            else:
                self.normalise = 1.0 / tables.NORMALISE_FACTOR_SDR
        elif self.output in ("uhd", "soapy", "lime", "loopback"):
            self.normalise = 1.0 / tables.NORMALISE_FACTOR_SDR
        elif self.output == "bladerf":
            self.normalise = 2047.0 / tables.NORMALISE_FACTOR_SDR
        elif self.output == "dexter":
            self.normalise = 32767.0 / tables.NORMALISE_FACTOR_SDR
        return self
