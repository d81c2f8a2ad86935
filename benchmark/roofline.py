"""The yardstick of the kernels' roofline shares: the card's peaks, and the
operations and bytes that each kernel's work needs, counted from the
cell's shapes (TM I symbols, carriers and samples a TF, and the TFs of a
batch), never from a kernel's launch arguments, so that a kernel that
replaces one of these is judged on the same work.

Bytes count each input once and each output once, in float32 planes; the
operations are those of the transforms and the resampler's products
(5 N log2 N real operations a complex transform of size N, 2 a
multiply-add), and leave the elementwise clipping out: both kernels are
far below their operation bound."""
from __future__ import annotations

import math
import statistics

# published peaks of one card (NVIDIA data sheets, dense, no sparsity) at
# its full power limit, by the name torch.cuda.get_device_name() gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_per_s": 67e12},
}

# TM I
SYMBOLS = 77                  # NULL + 76
CARRIERS = 1536
SPACING = 2048
TF_SAMPLES = 196_608          # at 2.048 MS/s
F32 = 4


def ofdm_ifft(batch_tf: int, rate: int) -> tuple[float, float]:
    """(operations, bytes) of K1's work: carriers of B x 77 symbols in,
    the unnormalised inverse transform of size 2048, time samples out."""
    sym = batch_tf * SYMBOLS
    ops = sym * 5 * SPACING * math.log2(SPACING)
    data = sym * (CARRIERS + SPACING) * 2 * F32
    return ops, data


def ofdm_cfr(batch_tf: int, rate: int) -> tuple[float, float]:
    """(operations, bytes) of K2's work: K1's, two more transforms (the
    clipped symbol's forward transform and the corrected one's inverse)
    and 8 float32 statistics a symbol out."""
    ops, data = ofdm_ifft(batch_tf, rate)
    sym = batch_tf * SYMBOLS
    return ops * 3, data + sym * 8 * F32


def resample_poly(batch_tf: int, rate: int) -> tuple[float, float]:
    """(operations, bytes) of K3's work: the TFs' samples in at 2.048 MS/s,
    out at `rate`, each output sample of each plane a sum of the products
    with the interpolator's taps that fall on input samples
    (reference/dab.polyphase_prototype: output j of phase (j M) mod L
    takes the taps phase + k L <= 2 half L)."""
    from reference.dab import polyphase_prototype
    L, M, half, _h = polyphase_prototype(2_048_000, rate)
    n_in = batch_tf * TF_SAMPLES
    n_out = n_in * L // M
    taps = sum((2 * half * L - (j * M) % L) // L + 1 for j in range(L)) / L
    ops = n_out * 2 * 2 * taps
    data = (n_in + n_out) * 2 * F32
    return ops, data


WORK = {"ofdm_ifft": ofdm_ifft, "ofdm_cfr": ofdm_cfr,
        "resample_poly": resample_poly}


def least_seconds(kernel: str, device_kind: str, batch_tf: int,
                  rate: int) -> float | None:
    """The least time the card could take for the kernel's work: the
    larger of bytes over bandwidth and operations over the float32 peak;
    None for a card without a row in PEAKS."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    ops, data = WORK[kernel](batch_tf, rate)
    return max(data / peak["bytes_per_s"], ops / peak["f32_per_s"])


def share(work: str, kernel_name: str, t, cell: dict) -> float | None:
    """A kernel's share of its roofline, %: the least time of `work` at the
    cell's batch and rate over the median device time of the launches of
    the device function `kernel_name` in the trace summary `t`; None where
    the trace has no such launch or the card no row in PEAKS."""
    times = t.kernels.get(kernel_name)
    if not times:
        return None
    least = least_seconds(work, cell["device_kind"], cell["batch_tf"],
                          cell["rate"])
    if least is None:
        return None
    return 100.0 * least / statistics.median(times)
