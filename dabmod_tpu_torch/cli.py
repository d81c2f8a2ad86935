"""odr-dabmod-compatible command line interface of the port (the port of
dabmod_tpu/cli.py):

    python -m dabmod_tpu_torch.cli [input.eti] [-f out.iq -F format]
        [-m mode] [-g gainmode] [-a gain] [-r rate] [-T tapsfile] [-l]
        [-b batch_tf] [-C config.ini] [--device cpu|cuda|cuda:N]

The flag grammar is dabmod_tpu's (the reference's, src/ConfigParser.cpp:
480-641); a single non-flag argument is an INI configuration file.  The
one flag dabmod_tpu lacks is --device: the modulator runs on the CUDA card
unless it names another device, and without a card it raises.
"""
from __future__ import annotations

import argparse
import logging
import signal
import subprocess
import sys

from .config import GAIN_MODES, ModSettings, parse_ini

log = logging.getLogger("dabmod_tpu_torch")


def _parse(argv) -> tuple[ModSettings, str | None]:
    """(settings, device) from the command line."""
    ap = argparse.ArgumentParser(
        prog="dabmod-tpu-torch",
        description="DAB modulator on PyTorch/CUDA (ODR-DabMod capabilities)")
    ap.add_argument("input", nargs="?", default=None,
                    help="ETI input file / tcp:// URI (default /dev/stdin)")
    ap.add_argument("-C", dest="config", help="configuration file")
    ap.add_argument("-a", dest="digital_gain", type=float, default=None,
                    help="digital gain")
    ap.add_argument("-f", dest="output_file", default=None,
                    help="output I/Q file name")
    ap.add_argument("-F", dest="format", default=None,
                    help="output format: complexf|complexf_normalised|s16|s8|u8")
    ap.add_argument("-g", dest="gainmode", default=None,
                    help="gain mode: fix|max|var")
    ap.add_argument("-m", dest="mode", type=int, default=None,
                    help="DAB mode 1-4 (0: from ETI)")
    ap.add_argument("-o", dest="tist_offset", type=float, default=None,
                    help="timestamp offset in seconds (enables sync)")
    ap.add_argument("-r", dest="rate", type=int, default=None,
                    help="output sample rate")
    ap.add_argument("-T", dest="taps_file", default=None,
                    help="FIR filter taps file ('default' for built-in)")
    ap.add_argument("-l", dest="loop", action="store_true",
                    help="loop input file")
    ap.add_argument("-b", dest="batch_tf", type=int, default=None,
                    help="transmission frames per device batch")
    ap.add_argument("-c", dest="clock_rate", type=int, default=None,
                    help="FPGA clock rate for the CIC equalizer "
                    "(ref: -c, src/ConfigParser.cpp:511-513)")
    ap.add_argument("-u", dest="uhd_device", default=None,
                    help="UHD output with the given device string "
                    "(ref: -u; mutually exclusive with -f)")
    ap.add_argument("-G", dest="txgain", type=float, default=None,
                    help="SDR TX gain (ref: -G)")
    ap.add_argument("--device", default=None,
                    help="torch device of the modulator (default: the CUDA "
                    "card; 'cpu' runs it on the CPU)")
    ap.add_argument("-V", action="version", version="dabmod-tpu-torch 0.1.0")
    # no argument at all: show usage and fail, like the reference's
    # argc == 1 path (src/ConfigParser.cpp:487-490)
    if not argv:
        ap.print_usage(sys.stderr)
        raise SystemExit("Invalid command line options")
    args = ap.parse_args(argv)

    # option values that count as command-line modulator configuration --
    # ONE tuple so the -C mutual-exclusion check and the argc==2 config
    # detection below can never drift apart (--device is not one)
    flag_values = (args.digital_gain, args.output_file, args.format,
                   args.gainmode, args.mode, args.tist_offset, args.rate,
                   args.taps_file, args.clock_rate, args.uhd_device,
                   args.txgain, args.batch_tf)
    flags_used = (any(v is not None for v in flag_values) or args.loop)

    # -C plus any other option is rejected: the reference refuses to mix a
    # configuration file with command line arguments
    # (src/ConfigParser.cpp:624-636)
    if args.config is not None and (flags_used or args.input is not None):
        ap.print_usage(sys.stderr)
        raise SystemExit("Invalid command line options: both configuration "
                         "file and command line arguments were given")

    # single non-flag argument and no other flags => config file, like the
    # reference's `argc == 2` rule
    only_positional = (args.input is not None and args.config is None
                       and not flags_used
                       and not str(args.input).startswith("tcp://")
                       and (args.input.endswith(".ini")))
    if only_positional:
        args.config = args.input
        args.input = None

    s = parse_ini(args.config) if args.config else ModSettings()

    if args.input is not None:
        s.input_name = args.input
        if args.input.startswith("tcp://"):
            s.input_transport = "tcp"
    elif not s.input_name:
        s.input_name = "/dev/stdin"
    if args.loop:
        s.loop = True
    if args.digital_gain is not None:
        s.digital_gain = args.digital_gain
    if args.output_file is not None:
        if args.uhd_device is not None:
            # ref: src/ConfigParser.cpp:516-520, 564-567
            raise SystemExit("Options -u and -f are mutually exclusive")
        s.output = "file"
        s.output_name = args.output_file
    if args.uhd_device is not None:
        s.output = "uhd"
        s.sdr_device_args = args.uhd_device
        s.sdr_refclk_src = "internal"
    if args.txgain is not None:
        s.sdr_txgain = args.txgain
    if args.clock_rate is not None:
        s.cic_eq_clock_rate = args.clock_rate
    if args.format is not None:
        s.file_output_format = args.format
    if args.gainmode is not None:
        s.gain_mode = GAIN_MODES[args.gainmode.lower()]
    if args.mode is not None:
        s.dab_mode = args.mode
    if args.tist_offset is not None:
        s.tist_offset = args.tist_offset
        s.tist_enabled = True
    if args.rate is not None:
        s.output_rate = args.rate
    if args.taps_file is not None:
        s.filter_taps_file = args.taps_file
    if args.batch_tf is not None:
        s.batch_tf = args.batch_tf
    if not s.output:
        raise SystemExit("no output defined (use -f or a config file)")
    s.normalise_for_output()
    return s, args.device


def build_settings(argv) -> ModSettings:
    """The settings of a command line, as dabmod_tpu.cli.build_settings
    makes them."""
    return _parse(argv)[0]


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    s, device = _parse(argv if argv is not None else sys.argv[1:])
    root = logging.getLogger()
    if s.log_file:
        fh = logging.FileHandler(s.log_file)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        root.addHandler(fh)
    if s.log_syslog:
        from logging.handlers import SysLogHandler
        try:
            root.addHandler(SysLogHandler(address="/dev/log"))
        except OSError as e:
            log.warning("syslog unavailable: %s", e)
    if s.startup_check:
        # run the configured gate (e.g. `chronyc waitsync`) and refuse to
        # start on failure (ref: src/DabMod.cpp:404-421)
        log.info("startup check: %s", s.startup_check)
        ret = subprocess.call(s.startup_check, shell=True)
        if ret != 0:
            log.error("startup check failed with code %d", ret)
            return 1
    from .runtime import ModRuntime
    rt = ModRuntime(s, device=device)

    # graceful stop on SIGINT/SIGTERM like the reference's signal handler
    # (src/DabMod.cpp:87-97): the first signal asks for a clean stop after
    # the current batch (a stream reader's wait is cut at its sub-second
    # socket tick), a second one is fatal
    def _on_signal(signum, frame):
        log.info("signal %d received, stopping", signum)
        rt.stop()
        signal.signal(signal.SIGINT, signal.SIG_DFL)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)

    previous = {sig: signal.signal(sig, _on_signal)
                for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        code = rt.run()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    if s.show_process_time:
        rt.log_process_time()
    rt.close()
    log.info("done: %d ETI frames modulated, %d restarts",
             rt.framecount, rt.num_restarts)
    return code


if __name__ == "__main__":
    sys.exit(main())
