"""The FFT core's pass schedule (dabmod_tpu_torch/ops/csrc/fft_core.cuh),
transcribed to NumPy for the CPU tests of K1 and K2.

Each thread t of a symbol holds P = ofdm_kernel.POINTS points in
registers, v[t, m] at index t + TS*m (TS = N/P); pass 0 (radix
R0 = N/P^2, exchange 1), pass 1 (radix P, exchange 2), pass 2 (radix P, in
registers); the forward transform is the inverse one transposed, with
conjugate twiddles.  The DFTs inside a pass run on the register axis; the
exchanges are indexed by the kernels' slot arithmetic (a per-thread base
plus a constant).  Fed the tables ofdm_kernel.make_table builds.
"""
import numpy as np

from dabmod_tpu_torch.ops.ofdm_kernel import POINTS as P


def pad1(a):
    """Slot of index a in exchange 1: one pad float every 32."""
    return a + (a >> 5)


def pad2(a, n):
    """Slot of index a in exchange 2: R0 = N/P^2 pad floats every TS."""
    return a + (a // (n // P)) * (n // (P * P))


def slots(n):
    """The four access sets of a transform, as the kernels compute them,
    each as (name, index, slot): arrays [TS threads, ...] of the logical
    index a thread reads or writes and the slot it uses for it."""
    ts, r0 = n // P, n // (P * P)
    t = np.arange(ts)[:, None]
    r = np.arange(P)[None, :]
    out = []
    if r0 > 1:
        b = np.arange(P // r0)[None, :, None]
        rr = np.arange(r0)[None, None, :]
        tt = t[:, :, None]
        out.append(("pass 0 write", (tt + b * ts) * r0 + rr,
                    pad1(tt * r0) + pad1(b * ts * r0) + rr))
        out.append(("pass 1 read", t + r * ts, pad1(t) + pad1(r * ts)))
    out.append(("pass 1 write", (t // r0) * ts + t % r0 + r * r0,
                (t // r0) * (ts + r0) + t % r0 + r * r0))
    out.append(("pass 2 read", t + r * ts, t + r * (ts + r0)))
    return out


def register_index(n):
    """[TS, P]: the index t + TS*m of the point in register m of thread t."""
    ts = n // P
    return np.arange(ts)[:, None] + ts * np.arange(P)[None, :]


def _dft(u, inverse):
    """R-point DFT along the last axis (sign + for the inverse)."""
    r = u.shape[-1]
    w = np.exp((2j if inverse else -2j) * np.pi
               * np.outer(np.arange(r), np.arange(r)) / r)
    return (u @ w).astype(np.complex64)


def _schedule(table):
    n = table.n
    ts, r0 = n // P, n // (P * P)
    tw = table.twiddle.numpy()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    t = np.arange(ts)[:, None]
    r = np.arange(P)[None, :]
    sl = {name: slot for name, _, slot in slots(n)}
    return n, ts, r0, tw[:P * r0].reshape(P, r0), \
        tw[P * r0:].reshape(P, ts), t, r, sl


def core_inverse(v, table):
    """The inverse transform of registers v [TS, P] (bins t + TS*m)."""
    n, ts, r0, tw1, tw2, t, r, sl = _schedule(table)
    stride = n + n // P
    if r0 > 1:
        ex = np.zeros(stride, np.complex64)
        g0 = P // r0
        u = v[:, np.arange(g0)[:, None] + np.arange(r0)[None, :] * g0]
        ex[sl["pass 0 write"]] = _dft(u, True)
        v = ex[sl["pass 1 read"]] * tw1[r, t % r0]
    ex2 = np.zeros(stride, np.complex64)
    ex2[sl["pass 1 write"]] = _dft(v, True)
    return _dft(ex2[sl["pass 2 read"]] * tw2[r, t], True)


def core_forward(v, table):
    """The forward transform, core_inverse transposed: samples t + TS*m in
    registers v [TS, P] -> bin t + TS*m in register m of thread t."""
    n, ts, r0, tw1, tw2, t, r, sl = _schedule(table)
    stride = n + n // P
    ex2 = np.zeros(stride, np.complex64)
    ex2[sl["pass 2 read"]] = _dft(v, False) * np.conj(tw2[r, t])
    v = _dft(ex2[sl["pass 1 write"]], False)
    if r0 > 1:
        ex = np.zeros(stride, np.complex64)
        ex[sl["pass 1 read"]] = v * np.conj(tw1[r, t % r0])
        g0 = P // r0
        u = _dft(ex[sl["pass 0 write"]], False)        # [TS, g0, r0]
        out = np.empty_like(v)
        out[:, np.arange(g0)[:, None] + np.arange(r0)[None, :] * g0] = u
        v = out
    return v
