"""Reed-Solomon RS(255, 207) over GF(2^8), poly 0x11d, fcr=1, prim=1.

Errors-and-erasures Berlekamp-Massey decoder used by the EDI PFT layer
(ref: lib/edi/PFT.cpp:55-108, lib/fec/decode_rs.h).  Pure NumPy/Python: PFT
runs at ETI frame cadence on the host, far off the device hot path.

The port's copy of dabmod_tpu/io/rs.py.
"""
from __future__ import annotations

import numpy as np

_POLY = 0x11D
N = 255
K = 207
NROOTS = N - K

# GF(256) log/antilog tables
_EXP = np.zeros(512, np.int32)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
_EXP[255:510] = _EXP[:255]


def _mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _poly_mul(p, q):
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        if a:
            for j, b in enumerate(q):
                out[i + j] ^= _mul(a, b)
    return out


def _poly_eval(p, x):
    """Evaluate polynomial (highest-order first) at x."""
    y = 0
    for c in p:
        y = _mul(y, x) ^ c
    return y


_GENPOLY = [1]
for _i in range(1, NROOTS + 1):   # roots alpha^1 .. alpha^48 (fcr=1)
    _GENPOLY = _poly_mul(_GENPOLY, [1, int(_EXP[_i])])


def encode(data: bytes | np.ndarray) -> np.ndarray:
    """Systematic RS encode: 207 data bytes -> 48 parity bytes."""
    data = np.frombuffer(bytes(data), np.uint8) if not isinstance(
        data, np.ndarray) else data.astype(np.uint8)
    assert data.size == K
    rem = [0] * NROOTS
    for b in data.tolist():
        factor = rem[0] ^ b
        rem = rem[1:] + [0]
        if factor:
            lf = _LOG[factor]
            for i in range(NROOTS):
                g = _GENPOLY[i + 1]
                if g:
                    rem[i] ^= _EXP[lf + _LOG[g]]
    return np.array(rem, np.uint8)


def decode(block: np.ndarray, erasures: list[int] | None = None) -> int:
    """Errors-and-erasures decode of a 255-byte block in place.

    Returns the number of corrected symbols, or -1 on failure.  Delegates to
    the native C++ decoder when available (native.py), as dabmod_tpu's does.
    """
    from .. import native
    block_np = np.ascontiguousarray(block, np.uint8)
    r = native.rs_decode(block_np, erasures)
    if r is not None:
        block[:] = block_np
        return r
    block = np.asarray(block)
    assert block.size == N
    data = block.astype(np.int32)

    # syndromes S_i = r(alpha^(fcr+i)), i = 0..47
    synd = []
    for i in range(NROOTS):
        synd.append(_poly_eval(data.tolist(), int(_EXP[i + 1])))
    if not any(synd):
        return 0

    eras = sorted(set(int(e) for e in (erasures or []) if 0 <= e < N))
    if len(eras) > NROOTS:
        return -1

    # erasure locator product (1 - X_j x) -> coefficients lowest-first
    gamma = [1]
    for e in eras:
        xj = int(_EXP[(N - 1 - e) % 255])
        new = [0] * (len(gamma) + 1)
        for i, c in enumerate(gamma):
            new[i] ^= c
            new[i + 1] ^= _mul(c, xj)
        gamma = new

    # modified syndromes (Forney): Xi(x) = S(x) * gamma(x) mod x^NROOTS
    s_poly = synd   # lowest-first: S0 + S1 x + ...
    xi = [0] * NROOTS
    for i in range(len(gamma)):
        for j in range(NROOTS - i):
            if gamma[i] and s_poly[j]:
                xi[i + j] ^= _mul(gamma[i], s_poly[j])

    # Berlekamp-Massey on modified syndromes for the error locator
    nu = len(eras)
    lam = [1] + [0] * NROOTS
    b = [1] + [0] * NROOTS
    L = 0
    m = 1
    bcoef = 1
    for n in range(NROOTS - nu):
        d = xi[n + nu]
        for i in range(1, L + 1):
            d ^= _mul(lam[i], xi[n + nu - i])
        if d == 0:
            m += 1
        elif 2 * L <= n:
            t = lam.copy()
            coef = _mul(d, _EXP[255 - _LOG[bcoef]] if bcoef else 0)
            for i in range(NROOTS + 1 - m):
                lam[i + m] ^= _mul(coef, b[i])
            L = n + 1 - L
            b = t
            bcoef = d
            m = 1
        else:
            coef = _mul(d, _EXP[255 - _LOG[bcoef]] if bcoef else 0)
            for i in range(NROOTS + 1 - m):
                lam[i + m] ^= _mul(coef, b[i])
            m += 1

    # total locator sigma = lambda * gamma (lowest-first)
    sigma = [0] * (NROOTS + 1)
    for i in range(len(lam)):
        for j in range(len(gamma)):
            if i + j <= NROOTS and lam[i] and gamma[j]:
                sigma[i + j] ^= _mul(lam[i], gamma[j])
    while len(sigma) > 1 and sigma[-1] == 0:
        sigma.pop()
    deg = len(sigma) - 1

    # Chien search for roots -> error positions
    positions = []
    for pos in range(N):
        xinv = int(_EXP[(N - 1 - pos) % 255])     # X_j for position pos
        # sigma(X_j^{ -1 }): evaluate at inverse of locator value
        xj_inv = _EXP[(255 - _LOG[xinv]) % 255] if xinv else 0
        val = 0
        xp = 1
        for c in sigma:
            val ^= _mul(c, xp)
            xp = _mul(xp, int(xj_inv))
        if val == 0:
            positions.append(pos)
    if len(positions) != deg:
        return -1

    # Forney algorithm: error evaluator omega = S*sigma mod x^NROOTS
    omega = [0] * NROOTS
    for i in range(len(sigma)):
        for j in range(NROOTS - i):
            if sigma[i] and s_poly[j]:
                omega[i + j] ^= _mul(sigma[i], s_poly[j])

    sigma_deriv = [sigma[i] for i in range(1, len(sigma), 2)]   # odd coeffs
    for pos in positions:
        xj = int(_EXP[(N - 1 - pos) % 255])
        xj_inv = int(_EXP[(255 - _LOG[xj]) % 255])
        num = 0
        xp = 1
        for c in omega:
            num ^= _mul(c, xp)
            xp = _mul(xp, xj_inv)
        den = 0
        xp = 1
        xj_inv_sq = _mul(xj_inv, xj_inv)
        for c in sigma_deriv:
            den ^= _mul(c, xp)
            xp = _mul(xp, xj_inv_sq)
        if den == 0:
            return -1
        # fcr = 1: magnitude = X_j^(1-fcr) * num / den = num / den
        mag = _mul(num, int(_EXP[(255 - _LOG[den]) % 255]))
        data[pos] ^= mag

    # verify
    for i in range(NROOTS):
        if _poly_eval(data.tolist(), int(_EXP[i + 1])) != 0:
            return -1
    block[:] = data.astype(block.dtype)
    return len(positions)
