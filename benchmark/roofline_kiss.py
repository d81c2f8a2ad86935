"""The yardstick of K4's roofline share (kiss_ifft_roofline), beside
roofline.py, whose float32 peak does not measure integer work: the bytes
K4's work needs and the int32 multiplies that KISS's fixed-point
arithmetic specifies, counted from the cell's shapes (TM I symbols,
carriers and the transform size, the TFs of a batch), never from a
kernel's launch arguments.

Bytes: the float32 carrier planes in (C x 2 x 4 B a symbol) and the int16
(re, im) pairs of the transform out (N x 2 x 2 B), each once.  Multiplies:
2 a C_FIXDIV and 4 a C_MUL, so 5 a point a radix-4 stage and 4 a point the
radix-2 one: 29 x 2048 a symbol at TM I.  Adds, shifts and wraps are left
out (paired 16-bit instructions could halve them), so this is a lower
bound on the work: no sound kernel reads over 100 %.  At TM I with 24 TFs
(1,848 symbols) the bytes, 37.8 MB, take 11.3 us at 3.35 TB/s and the
110 M multiplies 6.6 us: the share is bytes-bound."""
from __future__ import annotations

import statistics

import roofline

# the int32 multiply rate of one card: 64 results a clock an SM for
# compute capability 9.0 (CUDA C++ Programming Guide, "Arithmetic
# Instructions", the throughput table's 32-bit integer multiply and
# multiply-add row), 132 SMs at the H100 SXM's 1.98 GHz boost clock
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"i32_mul_per_s": 132 * 64 * 1.98e9},
}

I16 = 2


def kiss_ifft(batch_tf: int, rate: int) -> tuple[float, float]:
    """(int32 multiplies, bytes) of K4's work at TM I: carriers of
    B x 77 symbols in, KISS's fixed-point inverse transform of size 2048
    (kf_factor: five radix-4 stages and one radix-2), int16 pairs out."""
    sym = batch_tf * roofline.SYMBOLS
    n, radix4 = roofline.SPACING, 0
    while n % 4 == 0:
        n //= 4
        radix4 += 1
    per_point = 5 * radix4 + (4 if n == 2 else 0)
    muls = sym * roofline.SPACING * per_point
    data = sym * (roofline.CARRIERS * 2 * roofline.F32
                  + roofline.SPACING * 2 * I16)
    return muls, data


def least_seconds(device_kind: str, batch_tf: int,
                  rate: int) -> float | None:
    """The least time the card could take for K4's work: the larger of
    bytes over bandwidth and multiplies over the int32 multiply rate; None
    for a card without a row in both PEAKS."""
    peak, ipeak = roofline.PEAKS.get(device_kind), PEAKS.get(device_kind)
    if peak is None or ipeak is None:
        return None
    muls, data = kiss_ifft(batch_tf, rate)
    return max(data / peak["bytes_per_s"], muls / ipeak["i32_mul_per_s"])


def share(kernel_name: str, t, cell: dict) -> float | None:
    """K4's share of its roofline, %: the least time at the cell's batch
    over the median device time of the launches of `kernel_name` in the
    trace summary `t`; None where the trace has no such launch (the port
    before K4) or the card no row in PEAKS."""
    times = t.kernels.get(kernel_name)
    if not times:
        return None
    least = least_seconds(cell["device_kind"], cell["batch_tf"],
                          cell["rate"])
    if least is None:
        return None
    return 100.0 * least / statistics.median(times)
