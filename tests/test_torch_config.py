"""The port's settings, INI parser and command line (dabmod_tpu_torch.config,
dabmod_tpu_torch.cli, dabmod_tpu_torch.utils) against dabmod_tpu's: every
INI of tests/test_config.py and doc/example.ini gives the same value in
every field the two ModSettings share, and the command-line cases of
tests/test_config.py run against the port's build_settings."""
import dataclasses
import os
import warnings

import pytest

from dabmod_tpu import cli as j_cli
from dabmod_tpu import config as j_config
from dabmod_tpu import utils as j_utils
from dabmod_tpu_torch import cli, config, utils
from dabmod_tpu_torch.config import (GAIN_FIX, GAIN_VAR, ModSettings,
                                     parse_ini)
from test_config import EXAMPLE_INI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SDR_INI = """
[input]
transport=file
source=test.eti

[uhdoutput]
device=type=b200
channel=12C
txgain=55.5
rxgain=30
lo_offset=1000
dpd_port=50055
"""

DELAY_INI = """
[input]
transport=file
source=test.eti

[modulator]
gainmode=var

[fileoutput]
filename=out.iq
format=complexf

[delaymanagement]
%s
"""

LOG_INI = """
[log]
syslog=1
filelog=1
filename=mod.log

[general]
startupcheck=false
"""

FIXED_INI = """
[modulator]
fft_engine=kiss
ofdmwindowing=12
batch_tf=2
gainmode=max

[tii]
enable=1
comb=1
pattern=3
old_variant=1

[output]
file=1

[fileoutput]
filename=out.iq
format=complexf_normalised
"""

INIS = {
    "example": EXAMPLE_INI,
    "sdr": SDR_INI,
    "delay_offset": DELAY_INI % "synchronous=1\noffset=2.5",
    "delay_mute": DELAY_INI % "mutenotimestamps=1",
    "delay_fixed": DELAY_INI % "synchronous=1\nmanagement=fixed\n"
                               "fixedoffset=1.25",
    "delay_dynamic": DELAY_INI % "synchronous=1\nmanagement=dynamic\n"
                                 "dynamicoffsetfile=offset.txt",
    "log": LOG_INI,
    "fixed": FIXED_INI,
    "doc_example": None,
}


def _shared_fields_equal(got, ref):
    names = {f.name for f in dataclasses.fields(got)}
    ref_names = {f.name for f in dataclasses.fields(ref)}
    # the port has every field of dabmod_tpu's but its OFDM backend choice
    assert names == ref_names - {"ofdm_backend"}
    for name in sorted(names):
        assert getattr(got, name) == getattr(ref, name), name


@pytest.mark.parametrize("name", list(INIS))
def test_parse_ini_matches_reference(name, tmp_path):
    if INIS[name] is None:
        path = os.path.join(ROOT, "doc", "example.ini")
    else:
        path = tmp_path / "cfg.ini"
        path.write_text(INIS[name])
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = parse_ini(str(path))
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        ref = j_config.parse_ini(str(path))
    _shared_fields_equal(got, ref)
    assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w]


def test_parse_ini_values(tmp_path):
    """tests/test_config.py::test_parse_ini's values, on the port."""
    p = tmp_path / "cfg.ini"
    p.write_text(EXAMPLE_INI)
    s = parse_ini(str(p))
    assert s.rc_telnet_port == 2121
    assert s.rc_zmq_endpoint == "tcp://127.0.0.1:9400"
    assert s.input_name == "test.eti" and s.loop
    assert s.gain_mode == GAIN_VAR and s.digital_gain == 0.8
    assert s.output_rate == 4_096_000 and s.dab_mode == 2
    assert s.ofdm_window_overlap == 90
    assert s.enable_cfr and s.cfr_clip == 40.0 and s.cfr_error_clip == 3.0
    assert s.filter_taps_file == "default"
    assert s.tii_enable and s.tii_comb == 3 and s.tii_pattern == 42
    assert s.output == "file" and s.output_name == "out.iq"
    assert s.file_output_format == "s16" and s.file_output_show_metadata
    assert s.tist_enabled and s.tist_offset == 2.5
    assert abs(s.normalise - 32767.0 / 50000.0) < 1e-9


@pytest.mark.filterwarnings("ignore:you are using the old config syntax")
@pytest.mark.parametrize("body,match", [
    ("synchronous=1", "no offset defined"),
    ("synchronous=1\nmanagement=bogus", "invalid management"),
    ("synchronous=1\nmanagement=fixed", "needs fixedoffset"),
], ids=["no_offset", "bad_management", "fixed_without_offset"])
def test_delaymanagement_errors_match_reference(body, match, tmp_path):
    p = tmp_path / "delay.ini"
    p.write_text(DELAY_INI % body)
    for parse in (parse_ini, j_config.parse_ini):
        with pytest.raises(ValueError, match=match):
            parse(str(p))


@pytest.mark.parametrize("text,match", [
    ("[modulator]\nfft_engine=bogus\n", "fft_engine invalid"),
    ("[modulator]\ngainmode=loud\n", "invalid gainmode"),
    ("[uhdoutput]\nbehaviour_refclk_lock_lost=panic\n",
     "behaviour_refclk_lock_lost invalid"),
], ids=["fft_engine", "gainmode", "refclk_lock_lost"])
def test_invalid_values_match_reference(text, match, tmp_path):
    p = tmp_path / "bad.ini"
    p.write_text(text)
    for parse in (parse_ini, j_config.parse_ini):
        with pytest.raises(ValueError, match=match):
            parse(str(p))


# ---------------------------------------------------------------------------
# the command line (tests/test_config.py:109-279)
# ---------------------------------------------------------------------------

ARGVS = {
    "flags": ["in.eti", "-f", "o.iq", "-F", "u8", "-m", "4", "-g", "fix",
              "-a", "0.5", "-r", "2048000", "-l"],
    "reference_flags": ["in.eti", "-u", "type=b200", "-G", "55.5", "-c",
                        "400000000"],
    "offset_rate_taps_batch": ["in.eti", "-f", "o.iq", "-o", "1.5", "-r",
                               "8192000", "-T", "default", "-b", "3"],
    "tcp_input": ["tcp://127.0.0.1:9200", "-f", "o.iq", "-F", "s16"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_build_settings_matches_reference(name):
    _shared_fields_equal(cli.build_settings(ARGVS[name]),
                         j_cli.build_settings(ARGVS[name]))


def test_cli_flags():
    s = cli.build_settings(ARGVS["flags"])
    assert s.input_name == "in.eti" and s.loop
    assert s.output == "file" and s.file_output_format == "u8"
    assert s.dab_mode == 4 and s.gain_mode == GAIN_FIX
    assert s.digital_gain == 0.5
    assert abs(s.normalise - 127.0 / 50000.0) < 1e-9


@pytest.mark.parametrize("extra", [[], ["--device", "cpu"]])
def test_cli_single_config_arg(extra, tmp_path):
    """One INI path (and --device, which is no modulator flag) reads the
    INI, like the reference's argc == 2 rule."""
    p = tmp_path / "cfg.ini"
    p.write_text(EXAMPLE_INI)
    s, device = cli._parse([str(p), *extra])
    assert s.input_name == "test.eti" and s.output_name == "out.iq"
    assert device == (extra[1] if extra else None)
    _shared_fields_equal(s, j_cli.build_settings([str(p)]))


def test_cli_reference_flags():
    s = cli.build_settings(ARGVS["reference_flags"])
    assert s.output == "uhd" and s.sdr_device_args == "type=b200"
    assert s.sdr_txgain == 55.5 and s.cic_eq_clock_rate == 400_000_000
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.build_settings(["in.eti", "-u", "x", "-f", "out.iq"])


def test_cli_version_flag(capsys):
    with pytest.raises(SystemExit) as e:
        cli.build_settings(["-V"])
    assert e.value.code == 0
    assert "dabmod-tpu-torch" in capsys.readouterr().out


def test_cli_no_arguments_shows_usage(capsys):
    with pytest.raises(SystemExit):
        cli.build_settings([])
    assert "usage" in capsys.readouterr().err.lower()


def test_cli_no_output_refused():
    with pytest.raises(SystemExit, match="no output defined"):
        cli.build_settings(["in.eti", "-m", "1"])


def test_cli_config_and_flags_mutually_exclusive(tmp_path):
    p = tmp_path / "c.ini"
    p.write_text("[input]\nsource=in.eti\n[fileoutput]\nfilename=o.iq\n"
                 "format=complexf\n[output]\noutput=file\n")
    cli.build_settings(["-C", str(p)])
    cli.build_settings(["-C", str(p), "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.build_settings(["-C", str(p), "-m", "2"])
    with pytest.raises(SystemExit):
        cli.build_settings(["-C", str(p), "in.eti"])


def test_startupcheck_gate(tmp_path):
    """general.startupcheck gates startup (ref: src/DabMod.cpp:404-421),
    before any device is opened."""
    p = tmp_path / "cfg.ini"
    p.write_text("[general]\nstartupcheck=false\n[input]\ntransport=file\n"
                 "source=/nonexistent.eti\n[fileoutput]\nfilename=%s\n"
                 "format=complexf\n" % (tmp_path / "o.iq"))
    assert cli.main([str(p)]) == 1
    assert not (tmp_path / "o.iq").exists()


def test_channel_table_matches_reference():
    assert utils.CHANNELS == j_utils.CHANNELS
    assert utils.parse_channel("5A") == 174_928_000
    assert utils.parse_channel("13F") == 239_200_000
    assert utils.convert_frequency_to_channel(227_360_000) == "12C"
    assert utils.convert_frequency_to_channel(1) is None
    with pytest.raises(ValueError):
        utils.parse_channel("99Z")
    for mode in (1, 2, 3, 4):
        assert (utils.transmission_frame_duration_ms(mode)
                == j_utils.transmission_frame_duration_ms(mode))


def test_gain_modes_and_normalisation_match_reference():
    assert config.GAIN_MODES == j_config.GAIN_MODES
    for out, fmt in (("file", "complexf"), ("file", "complexf_normalised"),
                     ("file", "s16"), ("file", "u8"), ("zmq", "complexf"),
                     ("zmq", "s8"), ("uhd", ""), ("bladerf", ""),
                     ("dexter", ""), ("loopback", "")):
        for gm in (0, 1, 2):
            kw = dict(output=out, gain_mode=gm, file_output_format=fmt
                      or "complexf", zmq_output_format=fmt or "complexf")
            assert (ModSettings(**kw).normalise_for_output().normalise
                    == j_config.ModSettings(**kw).normalise_for_output()
                    .normalise)
