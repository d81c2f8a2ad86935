"""K4, the KISS fixed-point inverse transform (ops/kiss_kernel.py,
csrc/kiss_ifft.cu), on the CPU: its composed gather against the bin map and
KISS's input permutation; its plain version against kiss_fixed's transform
and the reference's fixed-point goldens; the kernel's index arithmetic
(tests/kiss_kernel_model.py) against the plain version; the wrapper's
checks, its launch count and the modulator's use of it; and the
benchmark's readers of K4's roofline share and of the step's kernels a TF.

Every comparison is bit for bit: from the Q1.14 carriers on, the chain is
integer arithmetic."""
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

import kiss_kernel_model as model
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.models import Modulator, compiled, make_default_layout
from dabmod_tpu_torch.ops import kiss_fixed, kiss_kernel, ofdm, ofdm_kernel
from golden import load
from torch_threads import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)          # benchmark/roofline_kiss imports roofline

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))     # the goldens' ensemble
MODES = [1, 2, 3, 4]                              # N = 2048, 512, 256, 1024
H100 = "NVIDIA H100 80GB HBM3"


def _tables(mode):
    """The mode's parameters, its carrier order's inverse permutation, and
    K1's and K4's tables on the CPU, as the modulator builds them."""
    p = tables.mode_params(mode)
    src, valid = tables.bin_map(mode)
    inv = np.asarray(tables.freq_interleave_inverse(mode))
    ot = ofdm_kernel.make_table(inv[src], valid, "cpu")
    return p, inv, ot, kiss_kernel.make_table(ot, p.null_size, p.sym_size)


def _planes(mode, tfs=2, seed=0, scale=1.5):
    """Carrier planes [tfs, S, C] in interleaver-input order: values past
    full scale, so that the butterflies' int16 stores wrap, and carriers
    exactly half an LSB off the Q1.14 grid, so that rint's ties show."""
    p = tables.mode_params(mode)
    rng = np.random.default_rng([mode, seed])
    shape = (tfs, p.nb_symbols + 1, p.nb_carriers)
    out = []
    for _ in range(2):
        x = (scale * rng.standard_normal(shape)).astype(np.float32)
        flat = x.reshape(-1)
        at = rng.choice(flat.size, 64, replace=False)
        ties = rng.integers(-20000, 20000, 64) + 0.5
        flat[at] = (ties / 16384.0).astype(np.float32)
        out.append(torch.as_tensor(x))
    return tuple(out)


def _q14(x):
    return torch.round(x * 16384.0).to(torch.int32)


def _chain_transform(planes, mode):
    """The port's chain before K4: the frequency interleave restored,
    Q1.14, the bin map, then kiss_fft_fixed (its own permutation)."""
    p, inv, _, _ = _tables(mode)
    inv_t = torch.as_tensor(inv, dtype=torch.int64)
    bins = ofdm.to_bins_slices(
        tuple(_q14(ofdm.freq_interleave(x, inv_t)) for x in planes),
        p.nb_carriers, p.spacing)
    return kiss_fixed.kiss_fft_fixed(*bins, inverse=True)


@pytest.mark.parametrize("mode", MODES)
def test_composed_gather_is_bin_map_then_kiss_permutation(mode):
    p, inv, _, kt = _tables(mode)
    assert kt.n == p.spacing and kt.gather.dtype == torch.int32
    planes = _planes(mode, tfs=1)
    inv_t = torch.as_tensor(inv, dtype=torch.int64)
    perm = torch.as_tensor(kiss_fixed._build_perm(
        p.spacing, kiss_fixed.kf_factor(p.spacing)))
    for x in planes:
        q = _q14(x)
        want = ofdm.to_bins_slices((_q14(ofdm.freq_interleave(x, inv_t)),),
                                   p.nb_carriers, p.spacing)[0]
        got = torch.cat([q, q.new_zeros((*q.shape[:-1], 1))], -1)
        assert torch.equal(got.index_select(-1, kt.gather),
                           want.index_select(-1, perm))


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_matches_kiss_fft_fixed(mode, wire):
    p = tables.mode_params(mode)
    planes = _planes(mode)
    kt = _tables(mode)[3]
    got = kiss_kernel.kiss_ifft(planes, kt, wire=wire)
    td = _chain_transform(planes, mode)
    if wire:
        want = kiss_fixed.pack_words(*ofdm.guard_interval_unwindowed(
            td, p.null_size, p.sym_size))
        assert got.dtype == torch.int32
        assert got.shape == want.shape == (2, p.tf_samples)
        assert torch.equal(got, want)
    else:
        assert all(torch.equal(g, w) for g, w in zip(got, td))


@pytest.mark.parametrize("wire", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_model_matches_plain_version(mode, wire):
    """csrc/kiss_ifft.cu's blocks, threads, register and shared-memory
    stages and stores, transcribed, give the plain version's bits."""
    p = tables.mode_params(mode)
    planes = _planes(mode, seed=1)
    kt = _tables(mode)[3]
    C = p.nb_carriers
    got = model.kernel(planes[0].reshape(-1, C).numpy(),
                       planes[1].reshape(-1, C).numpy(), kt.gather.numpy(),
                       kt.twiddle.numpy(), p.nb_symbols + 1, p.null_size,
                       p.sym_size, kt.log2n, wire=wire)
    want = kiss_kernel.kiss_ifft_plain(planes, kt, wire=wire)
    if wire:
        np.testing.assert_array_equal(got, want.numpy())
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.reshape(-1, kt.n).numpy())


@pytest.mark.parametrize("name,ov", [("e2e_iq_fixed", 0),
                                     ("e2e_iq_fixed_ov90", 90)])
def test_plain_version_and_kernel_model_give_the_goldens(name, ov):
    """The modulator's carrier planes of the goldens' two TFs through K4's
    plain version and through the kernel's model (with overlap 90 the
    planes, then the Q1.14 windowed guard interval): upstream's words."""
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  ModSettings(dab_mode=1, fft_engine="kiss",
                              ofdm_window_overlap=ov), device="cpu")
    fic = load("e2e_fixed_fic_in").reshape(8, 96)
    subs = (load("e2e_fixed_sub0_in").reshape(8, -1),
            load("e2e_fixed_sub1_in").reshape(8, -1))
    planes, _ = m.ofdm_symbols(fic, subs, m.init_state()["ti_history"])
    kt, p = m._kiss_table, m.p
    C = p.nb_carriers
    args = (planes[0].reshape(-1, C).numpy(), planes[1].reshape(-1, C).numpy(),
            kt.gather.numpy(), kt.twiddle.numpy(), p.nb_symbols + 1,
            p.null_size, p.sym_size, kt.log2n)
    if ov:
        td = kiss_kernel.kiss_ifft(planes, kt, wire=False)
        sym = tuple(torch.as_tensor(x).reshape(td[0].shape)
                    for x in model.kernel(*args, wire=False))
        outs = [kiss_fixed.pack_words(
            *kiss_fixed.guard_interval_windowed_fixed(
                x, p.null_size, p.sym_size, ov)) for x in (td, sym)]
    else:
        outs = [kiss_kernel.kiss_ifft(planes, kt),
                torch.as_tensor(model.kernel(*args))]
    for out in outs:
        np.testing.assert_array_equal(
            out.numpy().view(np.int16).reshape(-1),
            load(name).astype(np.int16))


@pytest.mark.parametrize("bad,error", [
    ("two_dims", ValueError), ("shapes", ValueError),
    ("float64", TypeError), ("carriers", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, error):
    re, im = _planes(1, tfs=1)
    kt = _tables(1)[3]
    planes = {"two_dims": (re[0], im[0]),
              "shapes": (re, im[:, :-1]),
              "float64": (re.double(), im.double()),
              "carriers": (re[..., :-4], im[..., :-4])}[bad]
    with pytest.raises(error):
        kiss_kernel.kiss_ifft(planes, kt)


def test_make_table_refuses_what_the_kernel_does_not_take():
    p, inv, ot, _ = _tables(1)
    with pytest.raises(ValueError, match="cyclic prefixes"):
        kiss_kernel.make_table(ot, p.spacing - 1, p.sym_size)
    src, valid = tables.bin_map(1)
    valid = valid.copy()
    valid[np.flatnonzero(valid)[-2:]] = 0           # 1534 carriers
    src = np.where(valid, np.minimum(src, 1533), 0)
    odd = ofdm_kernel.make_table(src, valid, "cpu")
    with pytest.raises(ValueError, match="four at a time"):
        kiss_kernel.make_table(odd, p.null_size, p.sym_size)


def test_launch_counts_name_k4_and_the_cpu_counts_no_launch():
    assert "kiss_ifft" in compiled.launch_counts()
    assert (kiss_kernel, "kiss_ifft") in compiled.COUNTED
    before = kiss_kernel.kiss_ifft.launches
    kiss_kernel.kiss_ifft(_planes(3, tfs=1), _tables(3)[3])
    assert kiss_kernel.kiss_ifft.launches == before


@pytest.mark.parametrize("ov", [0, 10])
def test_kiss_step_calls_k4_once(monkeypatch, ov):
    """The modulator's kiss step goes through K4's wrapper once a batch:
    the wire words with no overlap, the planes for the windowed guard
    interval with one."""
    calls = []
    inner = kiss_kernel.kiss_ifft

    def spy(planes, table, wire=True):
        calls.append(wire)
        return inner(planes, table, wire)
    monkeypatch.setattr(kiss_kernel, "kiss_ifft", spy)
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  ModSettings(dab_mode=1, fft_engine="kiss",
                              ofdm_window_overlap=ov), device="cpu")
    fic = load("e2e_fixed_fic_in").reshape(8, 96)[:4]
    subs = (load("e2e_fixed_sub0_in").reshape(8, -1)[:4],
            load("e2e_fixed_sub1_in").reshape(8, -1)[:4])
    out, _, _ = m.modulate(fic, subs, m.init_state())
    assert calls == [ov == 0] and out.shape == (1, m.p.tf_samples)


# ---------------------------------------------------------------------------
# the benchmark's readers of K4 (benchmark/roofline_kiss.py, metrics/)
# ---------------------------------------------------------------------------

def _reader(name):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_kiss_roofline_counts_tm1_at_24_tfs():
    """1,848 symbols: 37.8 MB (carriers in as float32, int16 pairs out) and
    29 int32 multiplies a point, 110 M; bytes-bound, 11.3 us."""
    import roofline_kiss
    muls, data = roofline_kiss.kiss_ifft(24, 2_048_000)
    assert muls == 1848 * 2048 * 29 == 109_756_416
    assert data == 1848 * (1536 * 2 * 4 + 2048 * 2 * 2) == 37_847_040
    rate = roofline_kiss.PEAKS[H100]["i32_mul_per_s"]
    assert rate == 132 * 64 * 1.98e9 == pytest.approx(1.67e13, rel=2e-3)
    least = roofline_kiss.least_seconds(H100, 24, 2_048_000)
    assert least == pytest.approx(data / 3.35e12) == pytest.approx(
        11.3e-6, rel=1e-2)
    assert muls / rate == pytest.approx(6.56e-6, rel=1e-2)
    assert muls / rate < least
    assert roofline_kiss.least_seconds("cpu", 24, 2_048_000) is None


def test_trace_readers_of_k4_and_the_kernels_a_tf():
    read_share = _reader("kiss_ifft_roofline")
    read_count = _reader("step.kernels_per_tf.bulk")
    import roofline_kiss
    cell = {"device_kind": H100, "batch_tf": 24, "rate": 2_048_000}
    least = roofline_kiss.least_seconds(H100, 24, 2_048_000)
    t = types.SimpleNamespace(
        kernels={"kiss_ifft_kernel": [least, 2 * least, 4 * least],
                 "elementwise_kernel": [1e-6] * 40, "DtoH": [1e-4] * 2,
                 "HtoD": [1e-6] * 6, "DtoD": [1e-6] * 2,
                 "Memset": [1e-6] * 2},
        batches=2)
    assert read_share(t, cell) == pytest.approx(50.0)
    assert read_count(t, cell) == pytest.approx((3 + 40) / 48)
    empty = types.SimpleNamespace(kernels={"DtoH": [1e-4]}, batches=2)
    assert read_share(empty, cell) is None and read_count(empty, cell) is None
    assert read_count(types.SimpleNamespace(kernels=t.kernels, batches=0),
                      cell) is None
    assert read_share(t, {**cell, "device_kind": "cpu"}) is None
