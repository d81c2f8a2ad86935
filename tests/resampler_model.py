"""NumPy transcription of the K3 kernel's index arithmetic
(dabmod_tpu_torch/ops/csrc/resample_poly.cu), for the CPU tests: how a
block stages the input run of a chunk, which words each lane of each warp
reads and writes for its work items, the staged output's swizzled rows and
the order in which the block stores them.  Sums are fmaf chains in the kernel's
order (fmaf emulated: the float32 product is exact in float64, then one
rounding to float32).  Words a block never stages hold NaN, so a read of
the wrong word shows in the result.

Imported by tests/test_torch_resampler.py, as tests/fft_core_model.py is by
the OFDM kernel tests.
"""
import numpy as np

from dabmod_tpu_torch.ops import resampler_kernel as rk


def fmaf(a, b, c):
    return (np.float64(1.0) * a * b + c).astype(np.float32)


class Block:
    """Table and layout of one plan, as numpy values."""

    def __init__(self, table):
        self.plan = table.plan
        self.L, self.M = table.plan.L, table.plan.M
        self.lg_m = self.M.bit_length() - 1
        self.K = table.n_taps
        self.row0 = table.row0.cpu().numpy()
        self.ktaps = table.kernel_taps.cpu().numpy()
        self.lay = table.layout
        self.mt, self.kp, self.R = rk.INSTANCES[self.lay.instance]

    # --- where things live in shared memory -------------------------------

    def staged(self, t):
        """Staged word of run sample t (staged() in the source)."""
        if self.mt:
            return t + t // (self.R * self.mt)
        return (t & (self.M - 1)) * self.lay.in_row + (t >> self.lg_m)

    def items(self):
        """(warp, phase, first tile) of every work item of a chunk."""
        n = self.L * self.lay.groups
        for item in range(n):
            p = item // self.lay.groups
            yield item % rk.WARPS, p, (item - p * self.lay.groups) \
                * self.lay.tiles

    def window_loads(self, tq):
        """The staged words a warp reads for the tile starting at output
        group tq, one [32] row per load instruction (the same for both
        planes), in the order of the source's loop, with the tap index
        each feeds: a list of (addresses [32], [(lane's output r, k)])."""
        lane = np.arange(32)
        out = []
        if self.mt:
            ch = self.R * self.mt
            ql = tq + lane * self.R
            base = (ql * self.mt // ch) * (ch + 1)
            for w in range((self.R - 1) * self.mt + self.kp):
                uses = [(r, w - r * self.mt) for r in range(self.R)
                        if 0 <= w - r * self.mt < self.kp]
                out.append((base + w + w // ch, uses))
        return out

    def any_loads(self, tq, r0):
        """Run-time M: the staged words a warp reads for its tile, one
        [32] row per tap k < K, as the source's incremental offsets
        give them."""
        q = tq + np.arange(32)
        m = r0 & (self.M - 1)
        off = m * self.lay.in_row + (r0 >> self.lg_m) + q
        rows = []
        for _ in range(self.K):
            rows.append(off.copy())
            m += 1
            if m == self.M:
                m = 0
                off = off + 1 - (self.M - 1) * self.lay.in_row
            else:
                off = off + self.lay.in_row
        return rows

    def out_writes(self, tq):
        """Columns a warp writes in its phase's row for the tile at tq:
        [(r, columns [32])]."""
        lane = np.arange(32)
        if self.mt:
            return [(r, rk.swizzle(tq + lane * self.R + r))
                    for r in range(self.R)]
        return [(0, rk.swizzle(tq + lane))]

    def readout(self, n_loc):
        """The source's store loop: for each (thread, iteration), the
        outputs o .. o + 3 it stores and the staged words it reads for
        them, from its incremental (p, q).  Returns (o [n], word [n]) for
        every output o < n_loc, and the words of each warp load [n, 32]
        (-1 where a lane has no output)."""
        L = self.L
        step = 4 * rk.THREADS
        tid = np.arange(rk.THREADS)
        o = 4 * tid
        q, p = o // L, o % L
        dq, dp = step // L, step % L
        outs, words, warp_rows = [], [], []
        while (o < n_loc).any():
            pe, qe = p.copy(), q.copy()
            per_e = []
            for e in range(4):
                live = o + e < n_loc
                wd = pe * self.lay.out_row + rk.swizzle(qe)
                outs.append((o + e)[live])
                words.append(wd[live])
                per_e.append(np.where(live, wd, -1))
                pe = pe + 1
                qe = np.where(pe == L, qe + 1, qe)
                pe = np.where(pe == L, 0, pe)
            for e in range(4):
                warp_rows.append(per_e[e].reshape(rk.WARPS, 32))
            o = o + step
            p, q = p + dp, q + dq
            q = np.where(p >= L, q + 1, q)
            p = np.where(p >= L, p - L, p)
        return (np.concatenate(outs), np.concatenate(words),
                np.concatenate(warp_rows))


def run(table, x, carry):
    """The kernel's output planes for flat planes x and carry, chunk by
    chunk as the source computes them."""
    b = Block(table)
    lay = b.lay
    n = x[0].shape[0]
    n_q = n // b.M
    ys = [np.full(n_q * b.L, np.nan, np.float32) for _ in range(2)]
    for q0 in range(0, n_q, lay.q_per_chunk):
        nq_blk = min(lay.q_per_chunk, n_q - q0)
        t = np.arange(lay.span)
        g = q0 * b.M + t
        s_x, s_y = [], []
        for xv, cv in zip(x, carry):
            xp = np.concatenate([cv, xv, np.zeros(lay.span, np.float32)])
            s = np.full(lay.in_len, np.nan, np.float32)
            s[b.staged(t)] = xp[g]
            s_x.append(s)
            s_y.append(np.full(b.L * lay.out_row, np.nan, np.float32))
        for _warp, p, first in b.items():
            taps = b.ktaps[p]
            row = p * lay.out_row
            for tile in range(first, first + lay.tiles):
                tq = tile * 32 * b.R
                if tq >= nq_blk:
                    break
                for s, sy in zip(s_x, s_y):
                    if b.mt:
                        acc = np.zeros((b.R, 32), np.float32)
                        for words, uses in b.window_loads(tq):
                            v = s[words]
                            for r, k in uses:
                                acc[r] = fmaf(v, taps[k], acc[r])
                    else:
                        acc = np.zeros((1, 32), np.float32)
                        for k, words in enumerate(b.any_loads(
                                tq, int(b.row0[p]))):
                            acc[0] = fmaf(s[words], taps[k], acc[0])
                    for r, cols in b.out_writes(tq):
                        sy[row + cols] = acc[r]
        o, words, _ = b.readout(nq_blk * b.L)
        for y, sy in zip(ys, s_y):
            y[q0 * b.L + o] = sy[words]
    return ys


def reference_sum(table, x, carry):
    """Each output as an fmaf chain over its band k = 0..K-1 in order,
    straight from the compact (unpadded) taps: what the kernel's padded
    sums must equal bit for bit."""
    plan = table.plan
    row0 = table.row0.cpu().numpy()
    taps = table.taps.cpu().numpy()
    n = x[0].shape[0]
    q = np.arange(n // plan.M)
    ys = []
    for xv, cv in zip(x, carry):
        xp = np.concatenate([cv, xv, np.zeros(2 * table.n_taps,
                                              np.float32)])
        y = np.zeros((q.size, plan.L), np.float32)
        for p in range(plan.L):
            for k in range(table.n_taps):
                y[:, p] = fmaf(xp[q * plan.M + row0[p] + k], taps[p, k],
                               y[:, p])
        ys.append(y.reshape(-1))
    return ys
