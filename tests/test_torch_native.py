"""The port's native host library (dabmod_tpu_torch/native.py, built from
native/dabmod_native.cpp into dabmod_tpu_torch/_build/) against three
references: dabmod_tpu.native on the same inputs, the port's own NumPy
code (eti.parse_eti_frames, which the port keeps on NumPy, and the NumPy
branches of io/rs.py, io/outputs.py and io/fic_decoder.crc16) and the
reference goldens' payloads in
tests/golden/ framed as ETI.  Everything is exact: the library computes
integers, and its float conversions truncate as the NumPy branches do.
"""
import contextlib
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from dabmod_tpu import eti as j_eti
from dabmod_tpu import native as j_native
from dabmod_tpu_torch import eti, native
from dabmod_tpu_torch.io import outputs, rs
from dabmod_tpu_torch.io.fic_decoder import crc16 as py_crc16
from dabmod_tpu_torch.models import make_default_layout

from golden import load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))

pytestmark = pytest.mark.skipif(
    native.get_lib() is None or j_native.get_lib() is None,
    reason="the native library does not build here (no g++)")


@contextlib.contextmanager
def numpy_branch():
    """The port's native library switched off, as DABMOD_NO_NATIVE=1 does
    in a fresh process: the callers take their NumPy branches."""
    saved = native._lib, native._load_attempted
    native._lib, native._load_attempted = None, True
    try:
        yield
    finally:
        native._lib, native._load_attempted = saved


def _blocks(seed):
    """A random RS(255, 207) code word (data, parity) from the port's NumPy
    encoder."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, rs.K, dtype=np.uint8)
    return rng, np.concatenate([data, rs.encode(data)])


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_built_into_the_package_build_dir():
    """The library lies in dabmod_tpu_torch/_build/ under its hash name; the
    source under native/ is only read."""
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "dabmod_tpu_torch",
                                                 "_build")
    assert os.path.exists(path)
    assert native.SOURCE == os.path.join(ROOT, "native", "dabmod_native.cpp")
    assert not any(f.endswith(".tmp") for f in os.listdir(native.BUILD_DIR))


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    """Four builds started at once into an empty directory: one g++ run
    under the lock, one library, no temporary file left."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    got = []
    threads = [threading.Thread(target=lambda: got.append(native._build()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert len(got) == 4 and len(set(got)) == 1 and got[0]
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(got[0]), "native.lock"])


def test_no_native_env_takes_the_numpy_branch():
    """DABMOD_NO_NATIVE=1: get_lib is None, every wrapper None, and the
    callers give the same results through NumPy (a fresh process, as the
    variable is read once a process)."""
    code = (
        "import numpy as np\n"
        "from dabmod_tpu_torch import eti, native\n"
        "from dabmod_tpu_torch.io import outputs, rs\n"
        "assert native.get_lib() is None\n"
        "assert native.crc16(b'x') is None and native.convert("
        "np.zeros(4, np.float32), 's16') is None\n"
        "raw = eti.synth_eti_batch(8, mode=1, seed=3)\n"
        "assert native.parse_eti_batch(raw) is None\n"
        "b = eti.parse_eti_frames(raw)\n"
        "blk = np.zeros(255, np.uint8); blk[3] = 9\n"
        "print(len(b.subchannels), int(b.tist_raw[0]), rs.decode(blk), "
        "int(blk.sum()), outputs.serialize_iq_count("
        "np.float32([1e6, -3.5]), 's16')[1])\n")
    env = dict(os.environ, DABMOD_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    raw = eti.synth_eti_batch(8, mode=1, seed=3)
    b = eti.parse_eti_frames(raw)
    blk = np.zeros(255, np.uint8)
    blk[3] = 9
    want = (f"{len(b.subchannels)} {int(b.tist_raw[0])} {rs.decode(blk)} "
            f"{int(blk.sum())} 1")
    assert r.stdout.split("\n")[0] == want


# ---------------------------------------------------------------------------
# CRC16 and RS(255, 207)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 10, 1000, 6144])
def test_crc16(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    got = native.crc16(data.tobytes())
    assert got == native.crc16(data) == j_native.crc16(data.tobytes())
    assert got == py_crc16(data.tobytes())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rs_encode(seed):
    data = np.random.default_rng(seed).integers(0, 256, rs.K,
                                                dtype=np.uint8)
    want = rs.encode(data)
    np.testing.assert_array_equal(native.rs_encode(data), want)
    np.testing.assert_array_equal(j_native.rs_encode(data), want)


def _decode_all(block, erasures=None):
    """(corrected count, block after) from the port's native decoder,
    dabmod_tpu's and the port's NumPy decoder, each on its own copy."""
    out = []
    for fn in (native.rs_decode, j_native.rs_decode):
        b = block.copy()
        out.append((fn(b, erasures), b))
    b = block.copy()
    with numpy_branch():
        out.append((rs.decode(b, erasures), b))
    return out


@pytest.mark.parametrize("case", ["clean", "errors20", "erasures48",
                                  "errors10_erasures20", "too_many"])
def test_rs_decode(case):
    """A clean word, 20 symbol errors, 48 erasures, 10 errors with 20
    erasures (all within 2e + s <= 48) and 30 errors (beyond it): the three
    decoders agree on the count, and where they correct, restore the
    word."""
    rng, word = _blocks(len(case))
    block, eras = word.copy(), None
    if case in ("errors20", "too_many"):
        pos = rng.choice(255, 20 if case == "errors20" else 30,
                         replace=False)
        block[pos] ^= rng.integers(1, 256, pos.size).astype(np.uint8)
    elif case == "erasures48":
        eras = rng.choice(255, 48, replace=False).tolist()
        block[eras] = 0
    elif case == "errors10_erasures20":
        pos = rng.choice(255, 30, replace=False)
        block[pos[:10]] ^= rng.integers(1, 256, 10).astype(np.uint8)
        eras = pos[10:].tolist()
        block[eras] = 0
    results = _decode_all(block, eras)
    counts = [r for r, _ in results]
    want = {"clean": 0, "errors20": 20, "erasures48": 48,
            "errors10_erasures20": 30, "too_many": -1}[case]
    assert counts == [want] * 3
    if want >= 0:
        for _, b in results:
            np.testing.assert_array_equal(b, word)


def test_rs_decode_takes_erasures_as_the_numpy_decoder():
    """Erasure positions outside the block and repeated ones, which the C
    decoder would index its tables with: the port's native decoder drops
    them as its NumPy decoder does, and a block of another size raises."""
    rng, word = _blocks(11)
    block = word.copy()
    eras = rng.choice(255, 10, replace=False).tolist()
    block[eras] = 0
    given = eras + eras[:3] + [-4, 255, 1000]
    (got, b), _, (want, w) = _decode_all(block, given)
    assert got == want == 10
    np.testing.assert_array_equal(b, w)
    b = block.copy()
    assert native.rs_decode(b, np.array(given, np.int32)) == 10
    np.testing.assert_array_equal(b, word)
    with pytest.raises(ValueError, match="255 contiguous"):
        native.rs_decode(np.zeros(200, np.uint8))
    with pytest.raises(ValueError, match="207 bytes"):
        native.rs_encode(np.zeros(200, np.uint8))


def test_rs_decode_through_the_pft_path():
    """io/rs.py's decode takes the native decoder and writes the corrected
    word back into the caller's block."""
    rng, word = _blocks(7)
    block = word.copy()
    block[[5, 90, 200]] ^= np.uint8(0x5A)
    assert rs.decode(block) == 3
    np.testing.assert_array_equal(block, word)


# ---------------------------------------------------------------------------
# the ETI batch parse
# ---------------------------------------------------------------------------

def _golden_frames(mode):
    """The reference goldens' FIC and sub-channel payloads (mode 1: the
    2-sub-channel bench ensemble and the 17-sub-channel mux; modes 2-4:
    one sub-channel) framed as ETI by the port: (frames, fic, payloads)."""
    if mode == "real":
        specs = eti.REALISTIC_MUX_SPECS
        fic = load("e2e_real_fic_in").reshape(16, 96)
        blob = load("e2e_real_sub_in").reshape(16, -1)
        subs, off = [], 0
        for _, stl, _ in specs:
            subs.append(blob[:, off:off + stl * 8])
            off += stl * 8
        layout = make_default_layout(1, specs)
    elif mode == 1:
        fic = load("e2e_fic_in").reshape(8, 96)
        subs = [load("e2e_sub0_in").reshape(8, -1),
                load("e2e_sub1_in").reshape(8, -1)]
        layout = make_default_layout(1, BENCH_SPECS)
    else:
        fic = load(f"e2e_m{mode}_fic_in").reshape(-1, 128 if mode == 3
                                                  else 96)
        sub = load(f"e2e_m{mode}_sub_in").reshape(fic.shape[0], -1)
        subs = [sub]
        layout = make_default_layout(mode, ((0, sub.shape[1] // 8, 0x22),))
    frames = np.stack([eti.build_eti_frame(
        layout, fct=t % 250, fic=fic[t], subch_data=[s[t] for s in subs],
        fp=t % 8, mnsc=0x1234 + t, tist=(t * 16384) & 0xFFFFFF)
        for t in range(fic.shape[0])])
    return frames, fic, subs


def _assert_native_is_numpy(raw):
    """The port's parse_eti_batch gives, field by field, the batch of the
    NumPy parser eti.parse_eti_frames (its TIST word is the PPS offset)."""
    mid, stc, fct, fp, mnsc, tist, fic, subs = native.parse_eti_batch(raw)
    b = eti.parse_eti_frames(raw)
    assert mid == b.layout.mid
    assert [s[0] for s in stc] == list(b.layout.scids)
    assert [eti.SubchannelParams(sad, stl * 8, tpl)
            for (_, sad, stl, tpl) in stc] == list(b.layout.subchannels)
    for x, y in ((fct, b.fct), (fp, b.fp), (mnsc, b.mnsc),
                 (tist, b.tist_pps), (fic, b.fic)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert len(subs) == len(b.subchannels)
    for x, y in zip(subs, b.subchannels):
        np.testing.assert_array_equal(x, y)


def _assert_same_native(raw):
    """The port's parse_eti_batch equals dabmod_tpu.native's, field by
    field."""
    got, want = native.parse_eti_batch(raw), j_native.parse_eti_batch(raw)
    assert got[:2] == want[:2]
    for x, y in zip(got[2:7], want[2:7]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert len(got[7]) == len(want[7])
    for x, y in zip(got[7], want[7]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", [1, "real", 2, 3, 4])
def test_parse_golden_eti(mode):
    """The goldens' payloads framed as ETI: the native parse equals
    dabmod_tpu's native parse and the port's NumPy parse, and the NumPy
    parse gives back the golden FIC and sub-channel payloads."""
    frames, fic, subs = _golden_frames(mode)
    _assert_same_native(frames)
    _assert_native_is_numpy(frames)
    got = eti.parse_eti_frames(frames)
    np.testing.assert_array_equal(got.fic, fic)
    for x, y in zip(got.subchannels, subs):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(got.mnsc, 0x1234 + np.arange(len(fic)))


@pytest.mark.parametrize("mode,specs", [
    (1, ((0, 24, 0x22),)), (1, BENCH_SPECS), (1, "real"), (2, BENCH_SPECS),
    (3, BENCH_SPECS), (4, BENCH_SPECS)])
def test_parse_synth_eti(mode, specs):
    """synth_eti_batch in every mode: native == dabmod_tpu's native ==
    the port's NumPy parse (TIST words 0xFFFFFF: no timestamp)."""
    specs = eti.REALISTIC_MUX_SPECS if specs == "real" else specs
    n = {1: 4, 2: 1, 3: 1, 4: 2}[mode] * 6
    raw = eti.synth_eti_batch(n, mode=mode, subch_specs=specs, seed=mode)
    _assert_same_native(raw)
    _assert_native_is_numpy(raw)


def _broken(code):
    """8 synthetic frames with the fault of native return code `code`."""
    raw = eti.synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS, seed=4)
    if code == -1:
        raw[5, 5] &= 0x7F                     # FICF clear
    elif code == -2:
        raw[3, 9] ^= 0x01                     # a SAD bit of the STC
    elif code == -3:
        raw[6, 5] = (raw[6, 5] & 0x80) | 1    # NST 2 -> 1
    return raw


@pytest.mark.parametrize("code,exc", [
    (-1, eti.EtiError), (-2, eti.EnsembleReconfigured),
    (-3, eti.EnsembleReconfigured)])
def test_parse_errors(code, exc):
    """Each failure code of the C parser raises the port's exception of
    the class dabmod_tpu raises for it (its own eti's), and the NumPy
    branch raises the same class."""
    raw = _broken(code)
    with pytest.raises(exc) as got:
        native.parse_eti_batch(raw)
    assert type(got.value) is exc
    with pytest.raises(j_eti.EtiError) as want:
        j_native.parse_eti_batch(raw)
    assert type(want.value) is getattr(j_eti, exc.__name__)
    assert str(want.value) == str(got.value)
    with pytest.raises(exc):
        eti.parse_eti_frames(raw)


@pytest.mark.parametrize("fault", ["streams", "payload"])
def test_table_beyond_the_parser_takes_the_numpy_branch(fault):
    """A first frame whose sub-channel table would overrun the C parser's
    buffers (100 streams; payloads that run past the 6144-byte frame):
    the native wrapper declines it (None, as where the library is off),
    and the NumPy parser raises, on the streams' tables, which differ
    between frames, or on the payload that runs past the frame."""
    raw = eti.synth_eti_batch(4, mode=1, subch_specs=BENCH_SPECS, seed=6)
    if fault == "streams":
        raw[:, 5] = 0x80 | 100
    else:
        raw[:, 8 + 2] |= 0x03                 # stl of stream 0: +768 words
    assert native.parse_eti_batch(raw) is None
    with pytest.raises((IndexError, eti.EtiError)):
        eti.parse_eti_frames(raw)


def test_mid_change_raises_as_the_numpy_parse():
    """A MID change inside a batch, which the C parser does not check (the
    port's parse_eti_frames, on NumPy, raises EnsembleReconfigured)."""
    raw = eti.synth_eti_batch(8, mode=1, subch_specs=BENCH_SPECS, seed=5)
    raw[4, 6] = (raw[4, 6] & ~np.uint8(0x18)) | (2 << 3)
    assert native.parse_eti_batch(raw) is not None
    with pytest.raises(eti.EnsembleReconfigured):
        eti.parse_eti_frames(raw)


# ---------------------------------------------------------------------------
# format conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,scale", [("s16", 30000.0), ("u8", 150.0),
                                       ("s8", 150.0)])
def test_convert(fmt, scale):
    """Saturating conversion with clip counts: the port's native converter
    equals dabmod_tpu's and the port's NumPy branch (serialize_iq_count
    with the library off), truncation and the exact limits included."""
    rng = np.random.default_rng(len(fmt))
    x = (rng.standard_normal(20000) * scale).astype(np.float32)
    x[:6] = (-32768.5, 32767.5, -128.5, 127.5, 0.99, -0.99)
    x[6:12] = (-32768.0, 32767.0, -128.0, 127.0, -129.0, 128.0)
    got, n = native.convert(x, fmt)
    want, wn = j_native.convert(x, fmt)
    assert got.dtype == want.dtype and n == wn and n > 0
    np.testing.assert_array_equal(got, want)
    assert outputs.serialize_iq_count(x, fmt) == (got.tobytes(), n)
    with numpy_branch():
        assert outputs.serialize_iq_count(x, fmt) == (got.tobytes(), n)


def test_convert_other_formats_fall_through():
    """f32 formats never reach the converter, and an unknown format is
    None from the wrapper and a ValueError from serialize_iq_count."""
    x = np.float32([1.5, -2.5])
    assert native.convert(x, "complexf") is None
    assert outputs.serialize_iq_count(x, "complexf") == (x.tobytes(), 0)
    with pytest.raises(ValueError, match="invalid output format"):
        outputs.serialize_iq_count(x, "s32")
