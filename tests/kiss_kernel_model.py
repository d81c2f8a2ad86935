"""csrc/kiss_ifft.cu (K4) transcribed to NumPy: its blocks, threads, points,
stages and stores with the kernel's own index arithmetic, in int64 with
the kernel's int16 wraps.  tests/test_torch_kiss_kernel.py holds it
against the plain version (kiss_kernel.kiss_ifft_plain) bit for bit, so an
index change is rehearsed here before a chip call."""
import numpy as np

THREADS = 256        # kThreads
POINTS = 8           # kPoints


def wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def sround(x):
    return wrap16((x + (1 << 14)) >> 15)


def fixdiv(a, k):
    return sround(a[0] * k), sround(a[1] * k)


def cmul(a, b):
    return (sround(a[0] * b[0] - a[1] * b[1]),
            sround(a[0] * b[1] + a[1] * b[0]))


def add(a, b):
    return wrap16(a[0] + b[0]), wrap16(a[1] + b[1])


def sub(a, b):
    return wrap16(a[0] - b[0]), wrap16(a[1] - b[1])


def bfly2(x0, x1, tw):
    f0 = fixdiv(x0, 32767 // 2)
    t = cmul(fixdiv(x1, 32767 // 2), tw)
    return add(f0, t), sub(f0, t)


def bfly4(x0, x1, x2, x3, tw1, tw2, tw3):
    f0 = fixdiv(x0, 32767 // 4)
    s0 = cmul(fixdiv(x1, 32767 // 4), tw1)
    s1 = cmul(fixdiv(x2, 32767 // 4), tw2)
    s2 = cmul(fixdiv(x3, 32767 // 4), tw3)
    s5 = sub(f0, s1)
    f0 = add(f0, s1)
    s3 = add(s0, s2)
    s4 = sub(s0, s2)
    return (add(f0, s3), (wrap16(s5[0] - s4[1]), wrap16(s5[1] + s4[0])),
            sub(f0, s3), (wrap16(s5[0] + s4[1]), wrap16(s5[1] - s4[0])))


def kernel(xr, xi, gather, twiddle, n_sym_tf, null_size, sym_size, log2n,
           wire=True):
    """K4 on float32 carriers [n_symbols, C]: the wire words
    [n_symbols / n_sym_tf, tf] (wire) or the planes [n_symbols, N] as int32.
    The symbols of all blocks at once: arrays [n_symbols, threads a
    symbol, ...]."""
    N = 1 << log2n
    TS = N // POINTS
    assert THREADS // TS * 2 * N == 2 * THREADS * POINTS
    n_symbols, C = xr.shape
    t = np.arange(TS)
    tw = twiddle.astype(np.int64)

    def twd(idx):
        return tw[idx, 0], tw[idx, 1]

    # 1-2. the carriers, each thread's 8 points of KISS's input order
    g = gather[POINTS * t[:, None] + np.arange(POINTS)]       # [TS, 8]
    z = g >= C
    gi = np.where(z, 0, g)

    def q14(x):
        v = np.where(z, np.float32(0), x[:, gi]) * np.float32(16384)
        return np.rint(v).astype(np.int64)
    v = list(zip(np.moveaxis(q14(xr), -1, 0), np.moveaxis(q14(xi), -1, 0)))
    tw0 = twd(0)
    if log2n & 1:
        for k in range(0, POINTS, 2):
            v[k], v[k + 1] = bfly2(v[k], v[k + 1], tw0)
        v[0], v[2], v[4], v[6] = bfly4(v[0], v[2], v[4], v[6], tw0, tw0, tw0)
        v[1], v[3], v[5], v[7] = bfly4(v[1], v[3], v[5], v[7], twd(N // 8),
                                       twd(2 * N // 8), twd(3 * N // 8))
    else:
        v[0:4] = bfly4(*v[0:4], tw0, tw0, tw0)
        v[4:8] = bfly4(*v[4:8], tw0, tw0, tw0)
    sr = np.zeros((n_symbols, N), np.int64)
    si = np.zeros_like(sr)
    for k in range(POINTS):
        sr[:, POINTS * t + k], si[:, POINTS * t + k] = v[k]

    # 3. the radix-4 stages in shared memory
    first_m = 8 if log2n & 1 else 4
    for st in range((log2n - (3 if log2n & 1 else 2)) // 2):
        m = first_m << (2 * st)
        fstride = N // (4 * m)
        for h in range(2):
            u = t + h * TS
            i = u % m
            base = (u - i) * 4 + i
            pos = [base + q * m for q in range(4)]
            a = [(sr[:, p], si[:, p]) for p in pos]
            out = bfly4(*a, twd(i * fstride), twd(2 * i * fstride),
                        twd(3 * i * fstride))
            for p, o in zip(pos, out):
                sr[:, p], si[:, p] = o

    # 4. out
    if not wire:
        return sr.astype(np.int32), si.astype(np.int32)
    B = n_symbols // n_sym_tf
    tf = null_size + (n_sym_tf - 1) * sym_size
    words = np.zeros(B * tf, np.int64)
    for sym in range(n_symbols):
        b, s = divmod(sym, n_sym_tf)
        pre = (null_size if s == 0 else sym_size) - N
        off = b * tf + (0 if s == 0 else null_size + (s - 1) * sym_size)
        k = np.arange(pre + N)
        n = np.where(k < pre, N - pre + k, k - pre)
        words[off + k] = ((si[sym, n] & 0xFFFF) << 16) | (sr[sym, n] & 0xFFFF)
    return wrap32(words).reshape(B, tf)


def wrap32(x):
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).astype(np.int32)
