"""The plain reference: its front end against the upstream C++ modulator's
goldens (tests/golden/e2e_*, read as data), the whole chain against the
port's CPU step at a few TFs, and what it imports."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT

import streams
from reference import dab
from reference.chain import Chain

GOLDEN = os.path.join(ROOT, "tests", "golden")
REALISTIC = [(0, 72, 2), (140, 48, 2), (236, 48, 3), (320, 36, 34),
             (392, 36, 34), (464, 30, 34), (524, 24, 34), (572, 24, 39),
             (602, 18, 34), (638, 18, 33), (686, 12, 34), (710, 12, 38),
             (728, 12, 32), (776, 12, 1), (805, 12, 38), (823, 3, 33),
             (831, 12, 34)]
TWO_SUBS = [(0, 24, 0x22), (48, 48, 0x02)]


def golden(name, dtype=np.uint8):
    return np.fromfile(os.path.join(GOLDEN, name + ".bin"), dtype)


def frames_with(ensemble, fic, subs):
    """ETI frames of `ensemble` carrying the given FIC and sub-channel
    bytes."""
    n = fic.shape[0]
    f = streams.make_frames(0, n, ensemble)
    off = 8 + 4 * len(ensemble) + 4
    f[:, off:off + 96] = fic
    off += 96
    for s in subs:
        f[:, off:off + s.shape[1]] = s
        off += s.shape[1]
    return f


@pytest.mark.parametrize("name,ensemble,n_frames", [
    ("e2e", TWO_SUBS, 8), ("e2e_real", REALISTIC, 16)])
def test_front_end_matches_reference_goldens(name, ensemble, n_frames):
    """FIC and sub-channel FEC, time interleaving from zero history, CIF,
    QPSK, frequency interleaving and DQPSK against the symbols the
    upstream C++ modulator wrote."""
    fic = golden(f"{name}_fic_in").reshape(n_frames, 96)
    if name == "e2e":
        subs = [golden("e2e_sub0_in").reshape(n_frames, -1),
                golden("e2e_sub1_in").reshape(n_frames, -1)]
    else:
        blob = golden("e2e_real_sub_in").reshape(n_frames, -1)
        offs = np.cumsum([0] + [8 * stl for _, stl, _ in ensemble])
        subs = [blob[:, a:b] for a, b in zip(offs, offs[1:])]
    expect = golden(f"{name}_symbols", np.complex64).reshape(
        n_frames // 4, 76, 1536)
    z, _null = Chain({"normalise": 1.0, "wire": "f32"}).carriers(
        frames_with(ensemble, fic, subs), 0)
    np.testing.assert_allclose(z.numpy(), expect, atol=4e-6)


def test_tii_and_interleaver_tables():
    perm = dab.freq_interleaver(1)
    assert sorted(perm) == list(range(1536))
    tii = dab.tii_null_symbol(1, 5, 31)
    assert np.count_nonzero(tii) == 2 * 4 * 4      # 4 bits x 4 sub-bands
    np.testing.assert_allclose(np.abs(tii[tii != 0]), 1.0)


def port_outputs(cfg_name, raw, n_tf):
    """The port's CPU step, one TF a batch from the stream's start."""
    import tempfile

    from dabmod_tpu_torch.config import parse_ini
    from dabmod_tpu_torch.eti import parse_eti_frames
    from dabmod_tpu_torch.models import Modulator

    import cell
    c = cell.load_json("configs", cfg_name)
    ini = {k: dict(v) for k, v in c["ini"].items()}
    d = tempfile.mkdtemp()
    if "fileoutput" in ini:
        ini["fileoutput"]["filename"] = os.devnull
    if "poly" in ini:
        path = os.path.join(d, "p.coef")
        with open(path, "w") as f:
            f.write("1\n5\n" + "".join(
                f"{v!r}\n" for v in c["poly_coefs"]["am"]
                + c["poly_coefs"]["pm"]))
        ini["poly"]["polycoeffile"] = path
    cell.write_ini(os.path.join(d, "m.ini"),
                   {"input": {"source": "x"}, **ini})
    s = parse_ini(os.path.join(d, "m.ini"))
    s.device_interleave = True
    b = parse_eti_frames(raw)
    m = Modulator(b.layout, s, "cpu")
    state, outs = m.init_state(), []
    for k in range(n_tf):
        sl = slice(4 * k, 4 * k + 4)
        o, state, _ = m.modulate(b.fic[sl], tuple(x[sl] for x in
                                                   b.subchannels), state)
        outs.append(o.numpy()[0])
    return outs, c


@pytest.mark.parametrize("cfg_name", ["r17_s16", "r17_dpd8m192"])
def test_reference_matches_port_on_cpu(cfg_name):
    """Three TFs from the stream's start, one TF a step on the port's CPU
    path: within the configuration's limits."""
    import cell
    raw = streams.make_frames(11, 12, REALISTIC)
    outs, c = port_outputs(cfg_name, raw, 3)
    chain = Chain(cell.reference_settings(c))
    wire = c["reference"]["wire"]
    for k in range(3):
        ref = chain.render(raw[:4 * k + 4], 0)[0].numpy()
        for name, v in cell.compare(outs[k], ref, wire).items():
            assert v <= c["limits"][name], (k, name, v)


@pytest.mark.parametrize("cfg_name", ["r17_s16", "r17_dpd8m192"])
def test_render_from_five_tfs_back_equals_from_the_start(cfg_name):
    """The interleaver's 15 CIFs and the resampler's input history are
    rebuilt from the five TFs before the one rendered."""
    import cell
    raw = streams.make_frames(12, 28, REALISTIC)
    chain = Chain(cell.reference_settings(cell.load_json("configs",
                                                         cfg_name)))
    whole = chain.render(raw, 0)[0].numpy()
    late = chain.render(raw[4:], 1)[0].numpy()
    np.testing.assert_array_equal(whole, late)


def imported_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{BENCH!r}]; "
         f"{code}; print(' '.join(sorted(sys.modules)))"],
        capture_output=True, text=True, check=True, cwd=BENCH)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_reference_imports_neither_jax_nor_the_port():
    tops = imported_modules("import reference.chain, reference.dab, "
                            "streams, roofline, generator")
    assert not tops & {"jax", "jaxlib", "flax", "dabmod_tpu",
                       "dabmod_tpu_torch"}


def test_no_benchmark_source_imports_jax():
    """Every import in the benchmark's sources, by its whole top-level
    name (dabmod_tpu_torch begins with dabmod_tpu)."""
    found = set()
    for root, _dirs, files in os.walk(BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    found |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    found.add(node.module.split(".")[0])
    assert not found & {"jax", "jaxlib", "flax", "dabmod_tpu"}
    # only the harness (not the reference) reaches the port
    for root, _dirs, files in os.walk(os.path.join(BENCH, "reference")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert "dabmod_tpu" not in f.read()
