"""The OFDM IFFT backend of the port (dabmod_tpu_torch.ops.ofdm_kernel).

On the CPU the wrapper takes the plain PyTorch version, which is held here
against dabmod_tpu's Pallas kernel run in interpret mode with the same
carrier map, at all four spacings.  The CUDA kernel itself runs only on a
card: its tests carry the `cuda` marker and skip without one
(tests/test_torch_cuda.py; time_kernels.py times it beside its plain
version at full size).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fft_core_model as core
from dabmod_tpu import tables as jt
from dabmod_tpu.ops import ofdm_kernel as jkernel
from dabmod_tpu_torch import tables
from dabmod_tpu_torch.ops import ofdm, ofdm_kernel

# fp32 everywhere: the tolerances below assume no TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODES = {2048: 1, 512: 2, 256: 3, 1024: 4}


def _carrier_map(mode):
    """The modulator's composed table: bin map + deferred interleaving."""
    src, valid = tables.bin_map(mode)
    return tables.freq_interleave_inverse(mode)[src], valid


def _inputs(mode, batch=2, symbols=7, seed=1):
    p = tables.mode_params(mode)
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((batch, symbols, p.nb_carriers))
                 .astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("spacing", [256, 512, 1024, 2048])
def test_plain_matches_pallas_kernel(spacing):
    """Plain K1 == build_ofdm_backend(interpret=True, carrier_map=...) at
    HIGHEST precision; atol 2e-5*max|ref| as tests/test_ofdm_kernel.py."""
    mode = MODES[spacing]
    src_pre, valid = _carrier_map(mode)
    x = _inputs(mode)
    ap = jkernel.build_ofdm_backend(
        spacing, False, 0.0, 0.0, precision=jax.lax.Precision.HIGHEST,
        interpret=True,
        carrier_map=(jt.freq_interleave_inverse(mode)[jt.bin_map(mode)[0]],
                     jt.bin_map(mode)[1].astype(np.float32)))
    ref, stats = ap(tuple(jnp.asarray(a) for a in x))
    assert stats is None
    table = ofdm_kernel.make_table(src_pre, valid, "cpu")
    got = ofdm_kernel.ofdm_backend(tuple(torch.as_tensor(a) for a in x),
                                   table)
    scale = float(np.abs(np.asarray(ref[0])).max())
    for g, r in zip(got, ref):
        assert g.shape == (2, 7, spacing) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=2e-5 * scale)


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_plain_equals_bins_then_ifft(mode):
    """The composed gather == freq-interleave, to_bins_slices, then the
    reference transform."""
    p = tables.mode_params(mode)
    x = tuple(torch.as_tensor(a) for a in _inputs(mode, seed=mode))
    table = ofdm_kernel.make_table(*_carrier_map(mode), "cpu")
    got = ofdm_kernel.ofdm_backend_plain(x, table)
    inv = torch.as_tensor(tables.freq_interleave_inverse(mode).astype(np.int64))
    bins = ofdm.to_bins_slices(tuple(ofdm.freq_interleave(a, inv) for a in x),
                               p.nb_carriers, p.spacing)
    ref = ofdm.ofdm_ifft(bins)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-4)


def test_table_contents():
    table = ofdm_kernel.make_table(*_carrier_map(1), "cpu")
    assert (table.n, table.log2n, table.n_carriers) == (2048, 11, 1536)
    assert table.src.dtype == torch.int32 and table.valid.dtype == torch.float32
    assert table.gather.dtype == torch.int32
    # part 1 [16, R0 = 8], then part 2 [16, N / 16 = 128]
    assert table.twiddle.shape == (16 * 8 + 2048, 2)
    r = np.arange(16)[:, None]
    expect = np.exp(2j * np.pi * np.concatenate([
        (r * np.arange(8) / 128.0).ravel(),
        (r * np.arange(128) / 2048.0).ravel()]))
    tw = table.twiddle.numpy().astype(np.float64)
    # float64 values rounded once to float32
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], expect, atol=6e-8)
    np.testing.assert_array_equal(
        table.twiddle.numpy(),
        np.stack([expect.real, expect.imag], -1).astype(np.float32))
    assert int(table.valid.sum()) == 1536 and float(table.valid[0]) == 0.0
    assert int(table.src[~table.valid.bool()].abs().sum()) == 0
    # the kernels' gather: src where a carrier lands, the zero slot C else
    valid = table.valid.bool()
    assert torch.equal(table.gather[valid], table.src[valid])
    assert bool((table.gather[~valid] == 1536).all())


@pytest.mark.parametrize("spacing", [256, 512, 1024, 2048])
def test_core_schedule_matches_numpy_fft(spacing):
    """The kernels' pass schedule (tests/fft_core_model.py), fed the tables
    make_table builds and the bins gathered as the kernels gather them
    (zero slot included), equals np.fft within 2e-5*max|ref|: the inverse
    leaves x[t + TS*m] in register m of thread t, and the forward transform
    of x leaves bin t + TS*m in the register that held it before the
    inverse."""
    mode = MODES[spacing]
    table = ofdm_kernel.make_table(*_carrier_map(mode), "cpu")
    x = _inputs(mode, batch=1, symbols=1, seed=spacing)
    car = (x[0] + 1j * x[1]).astype(np.complex64)[0, 0]
    car = np.concatenate([car, np.zeros(1, np.complex64)])   # the zero slot
    idx = core.register_index(spacing)
    regs = car[table.gather.numpy()[idx]]
    bins = np.zeros(spacing, np.complex128)
    bins[idx] = regs
    ref = np.fft.ifft(bins) * spacing
    got = core.core_inverse(regs, table)
    assert got.shape == (spacing // ofdm_kernel.POINTS, ofdm_kernel.POINTS)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref[idx], rtol=0, atol=2e-5 * scale)
    back = core.core_forward(got, table)
    ref_f = np.fft.fft(ref)
    np.testing.assert_allclose(back, ref_f[idx], rtol=0,
                               atol=2e-5 * np.abs(ref_f).max())
    # the round trip is N x the bins, in the registers that held them
    np.testing.assert_allclose(back / spacing, regs, rtol=0,
                               atol=2e-5 * np.abs(regs).max())


@pytest.mark.parametrize("spacing", [256, 512, 1024, 2048])
def test_core_exchanges_are_bank_conflict_free(spacing):
    """Every access of the two exchanges (csrc/fft_core.cuh): the kernels'
    base-plus-constant slot is the padded slot of its index (pad1 for
    exchange 1, pad2 for exchange 2, each one-to-one into a symbol's
    N + N/16 floats), every index of the transform is written once, and
    each warp-wide access (a block of THREADS_PER_BLOCK threads,
    symbols_per_block(N) symbols at that stride) hits 32 distinct
    shared-memory banks."""
    n, ts = spacing, spacing // ofdm_kernel.POINTS
    stride = n + ts
    a = np.arange(n)
    for pad in (core.pad1, lambda i: core.pad2(i, n)):
        assert len(set(pad(a).tolist())) == n and pad(a).max() < stride
    tid = np.arange(ofdm_kernel.THREADS_PER_BLOCK)
    ls, t = tid // ts, tid % ts
    assert ls.max() + 1 == ofdm_kernel.symbols_per_block(n)
    for name, index, slot in core.slots(n):
        pad = core.pad1 if name.startswith(("pass 0", "pass 1 read")) else \
            (lambda i: core.pad2(i, n))
        np.testing.assert_array_equal(slot, pad(index), err_msg=name)
        assert sorted(index.ravel().tolist()) == list(range(n)), name
        for k in np.ndindex(*slot.shape[1:]):
            phys = ls * stride + slot[(t, *k)]
            for w in range(tid.size // 32):
                banks = phys[32 * w:32 * w + 32] % 32
                assert len(set(banks.tolist())) == 32, (name, k, w)


def test_symbols_per_block():
    assert [ofdm_kernel.symbols_per_block(n)
            for n in (256, 512, 1024, 2048)] == [8, 4, 2, 1]


def test_table_rejects_bad_maps():
    src, valid = _carrier_map(1)
    with pytest.raises(ValueError):
        ofdm_kernel.make_table(src[:1000], valid[:1000], "cpu")
    with pytest.raises(ValueError):
        ofdm_kernel.make_table(np.concatenate([src, src]),
                               np.concatenate([valid, valid]), "cpu")
    with pytest.raises(ValueError):      # below the FFT core's 256 points
        ofdm_kernel.make_table(src[:128], valid[:128], "cpu")
    full = np.ones(256, bool)                # more than 3/4 of the bins
    with pytest.raises(ValueError):
        ofdm_kernel.make_table(np.arange(256) % 200, full, "cpu")
    bad = src.copy()
    bad[5] = 5000
    with pytest.raises(ValueError):
        ofdm_kernel.make_table(bad, valid, "cpu")


def test_wrapper_checks_and_cpu_path_does_not_count():
    table = ofdm_kernel.make_table(*_carrier_map(2), "cpu")
    x = tuple(torch.as_tensor(a) for a in _inputs(2))
    before = ofdm_kernel.ofdm_backend.launches
    out = ofdm_kernel.ofdm_backend(x, table)
    assert ofdm_kernel.ofdm_backend.launches == before
    for o, r in zip(out, ofdm_kernel.ofdm_backend_plain(x, table)):
        np.testing.assert_array_equal(o.numpy(), r.numpy())
    with pytest.raises(TypeError):
        ofdm_kernel.ofdm_backend(tuple(a.double() for a in x), table)
    with pytest.raises(ValueError):
        ofdm_kernel.ofdm_backend((x[0], x[1][:1]), table)
    with pytest.raises(ValueError):
        ofdm_kernel.ofdm_backend(tuple(a[..., :100] for a in x), table)
    with pytest.raises(ValueError):
        ofdm_kernel.ofdm_backend(tuple(a[0] for a in x), table)

