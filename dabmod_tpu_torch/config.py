"""Modulator settings and the INI parsing that fills them: the port's copy
of dabmod_tpu/config.py (the reference's mod_settings_t,
src/ConfigParser.h:44-95, and src/ConfigParser.cpp:87-641), with every
field of dabmod_tpu.config.ModSettings under the same name and default
except ofdm_backend: the port has one OFDM backend, the hand-written
kernel on the card and its plain version on the CPU."""
from __future__ import annotations

import configparser
import dataclasses

from . import tables

# gain modes (ref: src/GainControl.cpp); same values as dabmod_tpu.ops.ofdm
GAIN_FIX, GAIN_MAX, GAIN_VAR = 0, 1, 2

GAIN_MODES = {"fix": GAIN_FIX, "max": GAIN_MAX, "var": GAIN_VAR,
              "0": GAIN_FIX, "1": GAIN_MAX, "2": GAIN_VAR}


@dataclasses.dataclass
class ModSettings:
    # input
    input_name: str = ""
    input_transport: str = "file"        # file | tcp | zmq | edi
    loop: bool = False
    # TCP input timing (the reference hardcodes 8 s receive timeout and a
    # 1 s reconnect backoff, src/InputTcpReader.cpp:73-80)
    tcp_timeout: float = 8.0
    tcp_reconnect_delay: float = 1.0
    # output
    output: str = ""                     # file | zmq | uhd | ...
    output_name: str = ""
    file_output_format: str = "complexf"
    file_output_show_metadata: bool = False
    zmq_output_socket_type: str = "pub"
    zmq_output_format: str = "complexf"
    output_rate: int = 2_048_000         # != 2.048 MS/s needs the resampler
    resampler_mode: str = "auto"         # auto | poly | fft (as dabmod_tpu)
    cic_eq_clock_rate: int = 0
    # SDR outputs (common SDRDeviceConfig subset, src/output/SDRDevice.h)
    sdr_device_args: str = ""
    sdr_frequency: float = 0.0
    sdr_txgain: float = 0.0
    sdr_rxgain: float = 0.0
    sdr_lo_offset: float = 0.0
    sdr_dpd_port: int = 0
    sdr_mute_no_timestamps: bool = False
    sdr_master_clock_rate: float = 0.0
    sdr_refclk_src: str = "internal"     # internal | external | gpsdo | gpsdo-ettus
    sdr_pps_src: str = "none"            # none | pps | gpsdo | external
    sdr_behaviour_refclk_lock_lost: str = "ignore"   # ignore | crash
    sdr_max_gps_holdover_time: float = 0.0           # seconds, 0 = no monitor
    sdr_bandwidth: float = 0.0
    sdr_subdevice: str = ""
    sdr_rx_antenna: str = ""
    sdr_tx_antenna: str = ""
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
    # fft_engine=kiss: the reference's fixed-point configuration
    # (src/DabModulator.cpp:144-241), bit-exact int16 KISS arithmetic;
    # fft_engine=dexter: the card emits Q1.14 carrier symbols and the host
    # runs the FPGA FFT accelerator chain (io/dexter_fft.py)
    fft_engine: str = "fftw"             # fftw | kiss | dexter
    ofdm_window_overlap: int = 0
    filter_taps_file: str = ""           # "" disables, "default" = built-in
    poly_coef_file: str = ""             # "" disables DPD
    tii_enable: bool = False
    tii_comb: int = 0
    tii_pattern: int = 0
    tii_old_variant: bool = False
    # timestamps / SFN
    tist_enabled: bool = False
    tist_offset: float = 0.0
    # old-syntax offset management (ref warns at src/ConfigParser.cpp:
    # 456-459; kept functional here): "", "fixed" or "dynamic"
    tist_delay_management: str = ""
    tist_dynamic_offset_file: str = ""   # re-read at runtime when it changes
    # remote control
    rc_telnet_port: int = 0              # 0 disables
    rc_zmq_endpoint: str = ""            # "" disables
    # general
    startup_check: str = ""              # shell gate before start
    # events
    events_endpoint: str = ""            # ZMQ PUB endpoint for events
    log_trace_file: str = ""             # microsecond-stamped trace file
    # per-stage raw .dat dumps of every stage (the reference's
    # --enable-trace node files, src/Flowgraph.cpp:62-70,177-194)
    trace_dir: str = ""
    log_syslog: bool = False
    log_file: str = ""                   # file log (filelog=1 + filename)
    # transmission frames per device step
    batch_tf: int = 16
    # convert to the wire format (s16, u8, s8) on the device
    device_format_conversion: bool = True
    # interleave re/im into [., 2] pairs on the device for f32 outputs;
    # False returns (re, im) planes for the host writer to interleave
    device_interleave: bool = True
    # accepted for parity with dabmod_tpu; the port computes the transform
    # in fp32 for every value (see ops.fft.set_precision)
    fft_precision: str = "high"          # default | high | highest
    show_process_time: bool = True

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


def parse_ini(path: str) -> ModSettings:
    """Parse an odr-dabmod INI configuration file
    (section/key grammar per src/ConfigParser.cpp:87-477, doc/example.ini).
    Sections of inputs and outputs the port does not run yet still parse;
    the runtime refuses them when it opens them."""
    cp = configparser.ConfigParser(strict=False, inline_comment_prefixes=(";", "#"))
    cp.read(path)
    s = ModSettings()

    def get(sec, key, fallback=None):
        return cp.get(sec, key, fallback=fallback)

    def getint(sec, key, fallback=0):
        return cp.getint(sec, key, fallback=fallback)

    def getfloat(sec, key, fallback=0.0):
        return cp.getfloat(sec, key, fallback=fallback)

    def getbool(sec, key, fallback=False):
        try:
            return cp.getboolean(sec, key, fallback=fallback)
        except ValueError:
            return bool(getint(sec, key, int(fallback)))

    if getbool("remotecontrol", "telnet", False):
        s.rc_telnet_port = getint("remotecontrol", "telnetport", 0)
    if getbool("remotecontrol", "zmqctrl", False):
        s.rc_zmq_endpoint = get("remotecontrol", "zmqctrlendpoint", "")
    s.events_endpoint = get("log", "events_endpoint", "") or ""
    s.log_trace_file = get("log", "trace", "") or ""
    s.trace_dir = get("log", "trace_dir", "") or ""
    s.startup_check = get("general", "startupcheck", "") or ""
    s.log_syslog = getbool("log", "syslog", False)
    if getbool("log", "filelog", False):
        s.log_file = get("log", "filename", "odr-dabmod.log")

    s.input_transport = get("input", "transport", "file")
    s.input_name = get("input", "source", "/dev/stdin")
    s.loop = getbool("input", "loop", False)
    s.tcp_timeout = getfloat("input", "tcp_timeout", 8.0)
    s.tcp_reconnect_delay = getfloat("input", "tcp_reconnect_delay", 1.0)

    s.dab_mode = getint("modulator", "mode", 0)
    s.digital_gain = getfloat("modulator", "digital_gain", 1.0)
    gm = get("modulator", "gainmode", "var").lower()
    if gm not in GAIN_MODES:
        raise ValueError(f"invalid gainmode {gm}")
    s.gain_mode = GAIN_MODES[gm]
    s.gain_mode_variance = getfloat("modulator", "normalise_variance", 4.0)
    s.output_rate = getint("modulator", "rate", 2_048_000)
    s.cic_eq_clock_rate = getint("uhdoutput", "master_clock_rate", 0)
    s.ofdm_window_overlap = getint("modulator", "ofdmwindowing", 0)

    s.enable_cfr = getbool("cfr", "enable", False)
    s.cfr_clip = getfloat("cfr", "clip", 0.0)
    s.cfr_error_clip = getfloat("cfr", "errorclip", 0.0)

    if getbool("firfilter", "enabled", False):
        s.filter_taps_file = get("firfilter", "filtertapsfile", "default")

    if getbool("poly", "enabled", False):
        s.poly_coef_file = get("poly", "polycoeffile", "")

    s.tii_enable = getbool("tii", "enable", False)
    s.tii_comb = getint("tii", "comb", 0)
    s.tii_pattern = getint("tii", "pattern", 0)
    s.tii_old_variant = getbool("tii", "old_variant", False)

    # output selection: first enabled [xyzoutput] section wins, like getopt
    if getbool("output", "file", False) or cp.has_section("fileoutput"):
        s.output = "file"
        s.output_name = get("fileoutput", "filename", "")
        s.file_output_format = get("fileoutput", "format", "complexf")
        s.file_output_show_metadata = getbool("fileoutput", "show_metadata",
                                              False)
    if cp.has_section("zmqoutput") and getbool("zmqoutput", "enabled", True) \
            and get("zmqoutput", "listen", None):
        s.output = "zmq"
        s.output_name = get("zmqoutput", "listen")
        s.zmq_output_socket_type = get("zmqoutput", "socket_type", "pub")
        s.zmq_output_format = get("zmqoutput", "format", "complexf")

    # SDR outputs: [uhdoutput]/[soapyoutput]/... sections share the common
    # SDRDeviceConfig keys (ref: src/ConfigParser.cpp:308-477,
    # doc/example.ini uhdoutput section)
    for name in ("uhd", "soapy", "lime", "bladerf", "dexter", "loopback"):
        sec = name + "output"
        if cp.has_section(sec) and getbool(sec, "enabled", True):
            s.output = name
            s.sdr_device_args = get(sec, "device", "")
            chan = get(sec, "channel", None)
            if chan:
                from .utils import parse_channel
                s.sdr_frequency = parse_channel(chan)
            s.sdr_frequency = getfloat(sec, "frequency", s.sdr_frequency)
            s.sdr_txgain = getfloat(sec, "txgain", 0.0)
            s.sdr_rxgain = getfloat(sec, "rxgain", 0.0)
            s.sdr_lo_offset = getfloat(sec, "lo_offset", 0.0)
            s.sdr_dpd_port = getint(sec, "dpd_port", 0)
            s.sdr_mute_no_timestamps = getbool(sec, "mute_no_timestamps",
                                               False)
            s.sdr_master_clock_rate = getfloat(sec, "master_clock_rate", 0.0)
            s.sdr_refclk_src = get(sec, "refclk_source", "internal")
            s.sdr_pps_src = get(sec, "pps_source", "none")
            behave = get(sec, "behaviour_refclk_lock_lost", "ignore")
            if behave not in ("ignore", "crash"):
                # ref: src/ConfigParser.cpp:295-306
                raise ValueError(
                    f"behaviour_refclk_lock_lost invalid: {behave}")
            s.sdr_behaviour_refclk_lock_lost = behave
            s.sdr_max_gps_holdover_time = getfloat(
                sec, "max_gps_holdover_time", 0.0)
            s.sdr_bandwidth = getfloat(sec, "bandwidth", 0.0)
            s.sdr_subdevice = get(sec, "subdevice", "")
            s.sdr_rx_antenna = get(sec, "rx_antenna", "")
            s.sdr_tx_antenna = get(sec, "tx_antenna", "")
            break

    # delaymanagement (ref: src/ConfigParser.cpp:449-476): synchronous +
    # mutenotimestamps always parsed; with synchronous enabled an offset is
    # mandatory.  The pre-v1 syntax (management=fixed|dynamic with
    # fixedoffset / dynamicoffsetfile) draws the reference's "old config
    # syntax" warning but is kept *functional* here: fixed maps onto the
    # offset, dynamic points at a file the runtime re-reads on change.
    s.tist_enabled = getbool("delaymanagement", "synchronous", False)
    if cp.has_option("delaymanagement", "mutenotimestamps"):
        s.sdr_mute_no_timestamps = getbool(
            "delaymanagement", "mutenotimestamps", False)
    mgmt = (get("delaymanagement", "management", "") or "").lower()
    fixedoffset = get("delaymanagement", "fixedoffset", "") or ""
    dynfile = get("delaymanagement", "dynamicoffsetfile", "") or ""
    if s.tist_enabled:
        if mgmt or fixedoffset or dynfile:
            import warnings
            warnings.warn(
                "you are using the old config syntax for the offset "
                "management; please see example.ini for the new settings")
        if mgmt not in ("", "fixed", "dynamic"):
            raise ValueError(
                f"delaymanagement: invalid management mode {mgmt}")
        s.tist_delay_management = mgmt
        if mgmt == "fixed":
            if not fixedoffset:
                raise ValueError("delaymanagement: management=fixed "
                                 "needs fixedoffset")
            s.tist_offset = float(fixedoffset)
        elif mgmt == "dynamic":
            if not dynfile:
                raise ValueError("delaymanagement: management=dynamic "
                                 "needs dynamicoffsetfile")
            s.tist_dynamic_offset_file = dynfile
        elif cp.has_option("delaymanagement", "offset"):
            s.tist_offset = getfloat("delaymanagement", "offset", 0.0)
        else:
            # ref: src/ConfigParser.cpp:462-467
            raise ValueError("delaymanagement: synchronous is enabled, "
                             "but no offset defined")
    else:
        s.tist_offset = getfloat("delaymanagement", "offset", 0.0)

    s.show_process_time = getbool("log", "show_process_time", True)
    s.batch_tf = getint("modulator", "batch_tf", 8)
    s.fft_engine = get("modulator", "fft_engine", "fftw").lower()
    if s.fft_engine not in ("fftw", "kiss", "dexter"):
        # ref: src/ConfigParser.cpp:66-84
        raise ValueError(f"modulator.fft_engine invalid: {s.fft_engine}")
    s.normalise_for_output()
    return s
