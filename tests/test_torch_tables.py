"""The port's copied tables (dabmod_tpu_torch.tables, .uep_tables) equal
dabmod_tpu's for all four modes and every protection profile."""
from dataclasses import asdict

import numpy as np
import pytest

from dabmod_tpu import tables as jt
from dabmod_tpu import uep_tables as juep
from dabmod_tpu_torch import tables as tt
from dabmod_tpu_torch import uep_tables as tuep
from golden import load

MODES = [1, 2, 3, 4]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fn", ["freq_interleave_indices",
                                "freq_interleave_inverse",
                                "phase_ref_quarters", "phase_ref_eighths"])
def test_mode_tables(fn, mode):
    _same(getattr(tt, fn)(mode), getattr(jt, fn)(mode))


@pytest.mark.parametrize("mode", MODES)
def test_mode_params_and_bin_map(mode):
    assert asdict(tt.mode_params(mode)) == asdict(jt.mode_params(mode))
    assert tt.mode_params(mode).tf_samples == jt.mode_params(mode).tf_samples
    for a, b in zip(tt.bin_map(mode), jt.bin_map(mode)):
        _same(a, b)


def test_mode_zero_is_mode_four():
    assert asdict(tt.mode_params(0)) == asdict(jt.mode_params(0))


@pytest.mark.parametrize("n", [96, 288, 6912])
def test_prbs_matches_golden_and_reference(n):
    _same(tt.prbs_bytes(n), load(f"prbs_{n}"))
    _same(tt.prbs_bits(n), jt.prbs_bits(n))


def test_constants():
    assert tt.CONV_TAPS == jt.CONV_TAPS
    assert tt.TAIL_RULE == jt.TAIL_RULE
    assert tt.CIF_BYTES == jt.CIF_BYTES and tt.CIF_BITS == jt.CIF_BITS
    assert tuep.UEP_RULES == juep.UEP_RULES
    assert tuep.UEP_SUBCH_CU == juep.UEP_SUBCH_CU
    for name in ("NORMALISE_FACTOR_SDR", "NORMALISE_FACTOR_FILE_FIX",
                 "NORMALISE_FACTOR_FILE_VAR", "NORMALISE_FACTOR_FILE_MAX"):
        assert getattr(tt, name) == getattr(jt, name)


@pytest.mark.parametrize("mid", [0, 1, 2, 3])
def test_fic_rules_and_plan(mid):
    assert tt.fic_rules(mid) == jt.fic_rules(mid)
    fic_in = 128 if mid == 3 else 96
    assert tt.puncture_plan(tt.fic_rules(mid), fic_in * 4 + 3) == \
        jt.puncture_plan(jt.fic_rules(mid), fic_in * 4 + 3)


@pytest.mark.parametrize("n_bits", [384 * 8, 6912])
def test_time_interleave_masks(n_bits):
    _same(tt.time_interleave_masks(n_bits), jt.time_interleave_masks(n_bits))


def _profile(mod, br, tpl):
    """(rules, CU, puncture plan) of one profile, or the exception type."""
    p = mod.SubchannelParams(0, br * 3, tpl)
    try:
        rules = [(int(a), int(b) & 0xFFFFFFFF) for a, b in p.rules()]
        cu = p.framesize_cu
        plan = mod.puncture_plan(p.rules(), p.framesize * 4 + 3,
                                 out_bytes_expected=cu * 8)
    except (ValueError, KeyError) as e:
        return type(e)
    return rules, cu, plan, (p.protection_form, p.protection_level,
                             p.protection_option, p.bitrate)


@pytest.mark.parametrize("form", ["uep", "eep"])
def test_every_protection_profile(form):
    """Every (bitrate, TPL) of the short (UEP) or long (EEP) form: same
    rule list, CU size and puncturing plan, or the same rejection."""
    bitrates = [8, 16, 24, 32, 40, 48, 56, 64, 80, 96,
                112, 128, 160, 192, 224, 256, 320, 384]
    tpls = range(32) if form == "uep" else range(32, 64)
    n_accepted = 0
    for br in bitrates:
        for tpl in tpls:
            ours = _profile(tt, br, tpl)
            assert ours == _profile(jt, br, tpl), (br, hex(tpl))
            n_accepted += not isinstance(ours, type)
    assert n_accepted > 50          # the sweep really covers the tables


# ---------------------------------------------------------------------------
# TII, the windowed guard interval's tables, the FIR taps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_phase_ref_complex(mode):
    got = tt.phase_ref_complex(mode)
    assert got.dtype == np.complex64
    _same(got.view(np.uint32), jt.phase_ref_complex(mode).view(np.uint32))


def test_tii_patterns():
    _same(tt.tii_patterns(), jt.tii_patterns())
    assert (tt.tii_patterns().sum(axis=1) == 4).all()


@pytest.mark.parametrize("mode", [1, 2])
def test_tii_acp_every_comb_and_pattern(mode):
    """All 24 x 70 carrier masks against the reference's (the tii_acp_m*
    golden, as tests/test_table_sweeps.py reads it) and dabmod_tpu's."""
    carriers = tt.mode_params(mode).nb_carriers
    stride = (carriers + 7) // 8
    blob = load(f"tii_acp_m{mode}").reshape(24 * 70, stride)
    for k, (comb, pattern) in enumerate(
            (c, p) for c in range(24) for p in range(70)):
        ref = np.unpackbits(blob[k], bitorder="little")[:carriers]
        ours = tt.tii_acp(mode, comb, pattern)
        _same(ours, ref.astype(bool))
        _same(ours, jt.tii_acp(mode, comb, pattern))


@pytest.mark.parametrize("variant", ["new", "old"])
@pytest.mark.parametrize("mode", [1, 2])
def test_tii_symbol_golden(mode, variant):
    """Comb 5, pattern 31 against the reference's TII symbol (as
    tests/test_ofdm_golden.py:107-113), and every comb at pattern 31
    against dabmod_tpu's."""
    old = variant == "old"
    got = tt.tii_symbol(mode, comb=5, pattern=31, old_variant=old)
    _same(got, load(f"tii_m{mode}_{variant}"))
    for comb in range(24):
        _same(tt.tii_symbol(mode, comb, 31, old),
              jt.tii_symbol(mode, comb, 31, old))


def test_tii_rejects_what_the_reference_rejects():
    for mode in (3, 4):
        with pytest.raises(ValueError, match="mode"):
            tt.tii_symbol(mode, 5, 31)
        with pytest.raises(ValueError, match="mode"):
            jt.tii_symbol(mode, 5, 31)
    for comb, pattern in ((24, 0), (0, 70), (-1, 0)):
        with pytest.raises(ValueError, match="comb"):
            tt.tii_acp(1, comb, pattern)


@pytest.mark.parametrize("ov", [0, 10, 90])
@pytest.mark.parametrize("mode", MODES)
def test_guard_interval_tables(mode, ov):
    for a, b in zip(tt.guard_interval_tables(mode, ov),
                    jt.guard_interval_tables(mode, ov)):
        _same(a, b)


def test_default_fir_taps():
    assert tt.DEFAULT_FIR_TAPS.dtype == np.float32
    _same(tt.DEFAULT_FIR_TAPS, jt.DEFAULT_FIR_TAPS)
