"""csrc/frontend.cu (K5) transcribed to NumPy: its blocks, threads and
stores with the kernel's own index arithmetic (the bit gather through the
layout's tables, the 7-bit encoder window, the time interleaver's source
CIF, the phase walk, the NULL row, the history).
tests/test_torch_frontend_kernel.py holds it against the plain front end
(frontend_kernel.frontend_plain) bit for bit, so an index change is
rehearsed here before a chip call.

The threads of a symbol block's first phase, and the history threads, are
independent: each array below holds all of them at once (one TF at a time
for the symbol blocks)."""
import numpy as np

THREADS = 256        # kThreads
LANES = 32           # kLanes
WARPS = THREADS // LANES
HISTORY = 15         # kHistory
CIF_BITS = 864 * 64  # kCifBits
GEN_MASKS = 0x6D | 0x4F << 8 | 0x53 << 16 | 0x6D << 24     # kGenMasks
QPSK = 0x5371        # kQpsk
HALF = np.float32(0.7071067811865476)                     # kHalf
POPCOUNT = np.array([bin(v).count("1") for v in range(256)], np.int64)


def ti_delay(p):
    """__brev(p & 15) >> 28."""
    x = p & 15
    return (x & 1) << 3 | (x & 2) << 1 | (x & 4) >> 1 | (x & 8) >> 3


class Units:
    """The kernel's Units and Tables from the wrapper's arguments: unit 0
    the FIC, unit i + 1 sub-channel i; each unit's bytes (and history) as
    numpy arrays, its sizes from FrontendTable.units, its new history's
    offset as the wrapper sets it."""

    def __init__(self, table, fic, subch, hist_in):
        self.bytes = [np.asarray(x, np.int64) for x in (fic, *subch)]
        self.hist_in = [None] + [np.asarray(h, np.int64).reshape(-1)
                                 for h in hist_in]
        self.n_bytes, self.prbs, self.keep, self.width = (
            np.array(col) for col in zip(*table.units))
        self.hist_out = np.concatenate(
            [[-1, 0], np.cumsum(HISTORY * self.width[1:])])[:-1]
        self.n_units = len(table.units)
        self.prbs_bytes = table.prbs.numpy().astype(np.int64)
        self.keep_table = table.keep.numpy().astype(np.int64)
        self.cif_src = table.cif_src.numpy().astype(np.int64)
        self.filler = table.cif_filler.numpy().astype(np.int64)

    def row_byte(self, k, f, j):
        """bytes[k][f * n_bytes[k] + j] for arrays k, f, j (j in range)."""
        out = np.zeros(k.shape, np.int64)
        for unit in np.unique(k):
            at = k == unit
            out[at] = self.bytes[unit].reshape(-1)[
                f[at] * self.n_bytes[unit] + j[at]]
        return out

    def hist_byte(self, k, i):
        out = np.zeros(k.shape, np.int64)
        for unit in np.unique(k):
            at = k == unit
            out[at] = self.hist_in[unit][i[at]]
        return out


def conv_bit(u, k, f, m):
    """conv_bit: encoder output m of unit k's frame f (arrays)."""
    lo = (m >> 2) - 6
    j0 = lo >> 3
    n = u.n_bytes[k]
    pr = u.prbs[k]

    def byte(j, ok):
        js = np.where(ok, j, 0)
        return np.where(ok, u.row_byte(k, f, js) ^ u.prbs_bytes[pr + js], 0)
    b0 = byte(j0, j0 >= 0)
    b1 = byte(j0 + 1, j0 + 1 < n)
    w = ((b0 << 8 | b1) >> (9 - (lo & 7))) & 0x7F
    return POPCOUNT[w & ((GEN_MASKS >> (8 * (m & 3))) & 0xFF)] & 1


def punct_bit(u, k, f, p):
    """punct_bit: punctured bit p of unit k's frame f (arrays)."""
    m = u.keep_table[u.keep[k] + p]
    return np.where(m < 0, 0, conv_bit(u, k, f, np.maximum(m, 0)))


def tf_bit(u, cif_count, fic_width, b, j):
    """tf_bit: bit j of TF b's stream (arrays of equal shape)."""
    fic_bits = cif_count * fic_width
    is_fic = j < fic_bits
    c = j // fic_width
    fic = punct_bit(u, np.zeros_like(j), np.where(is_fic, b * cif_count + c,
                                                  0),
                    np.where(is_fic, j - c * fic_width, 0))
    jj = np.where(is_fic, 0, j - fic_bits)
    c = jj // CIF_BITS
    x = jj - c * CIF_BITS
    src = u.cif_src[x]
    filler = u.filler[x]
    owned = ~is_fic & (src >= 0)
    k = np.where(owned, src >> 16, 1)
    p = np.where(owned, src & 0xFFFF, 0)
    f = b * cif_count + c - ti_delay(p)
    cur = punct_bit(u, k, np.maximum(f, 0), p)
    old = u.hist_byte(k, np.where(f < 0, (HISTORY + f) * u.width[k] + p, 0))
    msc = np.where(src < 0, filler, np.where(f >= 0, cur, old))
    return np.where(is_fic, fic, msc)


def carrier(q):
    """carrier: phases_to_carriers of the eighth-turn indices q."""
    b1 = (q >> 1) & 1
    b2 = (q >> 2) & 1
    sb2 = (1 - 2 * b2).astype(np.float32)
    odd = (q & 1) == 1
    re = np.where(odd, HALF * (1 - 2 * (b1 ^ b2)).astype(np.float32),
                  (1 - b1).astype(np.float32) * sb2)
    im = np.where(odd, HALF * sb2, b1.astype(np.float32) * sb2)
    return re.astype(np.float32), im.astype(np.float32)


def symbol_blocks(u, b, ref_q, tii, cic, tf_index, cif_count, n_sym,
                  n_carriers, fic_width):
    """The symbol blocks of TF b: planes [S, C] of its rows."""
    C = n_carriers
    chunks = -(-C // LANES)
    rows = n_sym + 2
    re = np.zeros((rows, C), np.float32)
    im = np.zeros((rows, C), np.float32)
    per = -(-rows // WARPS)
    for chunk in range(chunks):
        c = chunk * LANES + np.arange(LANES)
        c = c[c < C]                                    # live lanes
        # phase 1: warp w computes symbols w, w + 8, ..: all at once
        l = np.arange(n_sym)[:, None]
        j = 2 * l * C + c[None, :]
        bb = np.full(j.shape, b)
        bi = tf_bit(u, cif_count, fic_width, bb, j)
        bq = tf_bit(u, cif_count, fic_width, bb, j + C)
        qs = (QPSK >> (4 * (2 * bi + bq))) & 7          # [L, lanes]
        # phase 2: warp w writes rows s0 .. s1 - 1
        for w in range(WARPS):
            s0 = w * per
            s1 = min(rows, s0 + per)
            acc = ref_q[c].astype(np.int64)
            for ll in range(s0 - 2):
                acc = acc + qs[ll]
            tap = cic[c] if cic is not None else np.float32(1)
            for s in range(s0, s1):
                if s == 0:
                    if tii is not None:
                        insert = np.float32(0 if (tf_index + b) & 1 else 1)
                        r, i = tii[0][c] * insert, tii[1][c] * insert
                    else:
                        r = i = np.zeros(len(c), np.float32)
                else:
                    if s >= 2:
                        acc = acc + qs[s - 2]
                    r, i = carrier(acc & 7)
                if cic is not None:
                    r, i = r * tap, i * tap
                re[s, c], im[s, c] = r, i
    return re, im


def history_blocks(u, frames):
    """The history blocks: the flat new-history buffer."""
    hist_elems = HISTORY * int(u.width[1:].sum())
    e = np.arange(hist_elems)
    k = np.ones_like(e)
    for unit in range(2, u.n_units):         # while (hist_out[k+1] <= e)
        k = np.where(u.hist_out[unit] <= e, unit, k)
    w = u.width[k]
    r = (e - u.hist_out[k]) // w
    p = e - u.hist_out[k] - r * w
    f = frames + r - HISTORY
    cur = punct_bit(u, k, np.maximum(f, 0), p)
    old = u.hist_byte(k, np.where(f < 0, (frames + r) * w + p, 0))
    return np.where(f >= 0, cur, old).astype(np.uint8)


def kernel(table, fic, subch, hist_in, tf_index):
    """K5 on one batch: (re, im [B, S, C] float32, the new histories
    [15, width] uint8 a sub-channel), from the FrontendTable and numpy
    inputs."""
    p = table.p
    u = Units(table, fic, subch, hist_in)
    frames = fic.shape[0]
    B = frames // p.cif_count
    ref_q = table.ref_q.numpy()
    tii = None if table.tii is None else tuple(x.numpy() for x in table.tii)
    cic = None if table.cic is None else table.cic.numpy()
    planes = [symbol_blocks(u, b, ref_q, tii, cic, int(tf_index),
                            p.cif_count, p.data_symbols, p.nb_carriers,
                            table.fic_width) for b in range(B)]
    re = np.stack([x[0] for x in planes])
    im = np.stack([x[1] for x in planes])
    flat = history_blocks(u, frames)
    hist = np.split(flat, np.cumsum(HISTORY * u.width[1:])[:-1])
    return (re, im), [h.reshape(HISTORY, w)
                      for h, w in zip(hist, u.width[1:])]
