"""Bit-domain FEC chain on tensors (port of dabmod_tpu/ops/fec.py).

The reference implements these stages as per-frame byte loops
(src/PrbsGenerator.cpp, src/ConvEncoder.cpp, src/PuncturingEncoder.cpp,
src/TimeInterleaver.cpp, src/FrameMultiplexer.cpp, src/BlockPartitioner.cpp).
Here every stage is a static slice / gather / XOR over {0,1} bit tensors
with a leading batch axis.

Convention: a "bit tensor" has dtype uint8 with values in {0,1}, MSB-first
relative to the reference's byte streams.  (dabmod_tpu keeps bits in int32
because of the TPU's 32-bit lanes; uint8 moves a quarter of the bytes.)
"""
from __future__ import annotations

import numpy as np
import torch

from ..tables import CONV_TAPS

BIT_DTYPE = torch.uint8


def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """[..., n_bytes] uint8 -> [..., n_bytes*8] uint8 bits (MSB first)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data.to(torch.uint8).unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def scramble(bits: torch.Tensor, prbs: torch.Tensor) -> torch.Tensor:
    """Energy dispersal: XOR with the precomputed PRBS bit sequence."""
    return bits ^ prbs


def conv_encode(bits: torch.Tensor, n_bits: int) -> torch.Tensor:
    """K=7 rate-1/4 convolutional encoder, generators 133/171/145/133 octal
    (ref: src/ConvEncoder.cpp:59-150).

    Each generator stream is an XOR of static slices of the zero-padded
    input (delay taps).  bits: [..., n_bits]; out: [..., 4*(n_bits+6)]
    interleaved [y0[i], y1[i], y2[i], y3[i]].
    """
    steps = n_bits + 6
    zeros6 = torch.zeros((*bits.shape[:-1], 6), dtype=bits.dtype,
                         device=bits.device)
    padded = torch.cat([zeros6, bits, zeros6], dim=-1)
    streams = []
    for taps in CONV_TAPS:
        acc = padded[..., 6 - taps[0]: 6 - taps[0] + steps]
        for d in taps[1:]:
            acc = acc ^ padded[..., 6 - d: 6 - d + steps]
        streams.append(acc)
    return torch.stack(streams, dim=-1).reshape(*bits.shape[:-1], steps * 4)


def puncture_index(plan) -> np.ndarray:
    """The kept bit positions of a tables.puncture_plan, in output order.

    Within each region the same `width`-bit pattern repeats word for word,
    so the kept positions are start + word*width + col for every kept col."""
    regions, _pad_bits, _out_bytes = plan
    parts = [(start + np.arange(n_words)[:, None] * width
              + np.asarray(cols, np.int64)[None, :]).reshape(-1)
             for start, n_words, width, cols in regions]
    return np.concatenate(parts).astype(np.int64)


def puncture(bits: torch.Tensor, keep: torch.Tensor,
             pad_bits: int) -> torch.Tensor:
    """Keep the bits at positions `keep` (a device tensor of
    puncture_index), then append `pad_bits` zero bits."""
    out = bits.index_select(-1, keep)
    if pad_bits:
        out = torch.cat([out, torch.zeros(
            (*bits.shape[:-1], pad_bits), dtype=bits.dtype,
            device=bits.device)], dim=-1)
    return out


def puncture_regions(bits: torch.Tensor, plan) -> torch.Tensor:
    """Puncture by a tables.puncture_plan (builds the keep index on every
    call; the modulator precomputes it once and calls puncture)."""
    keep = torch.as_tensor(puncture_index(plan), device=bits.device)
    return puncture(bits, keep, plan[1])


def fec_path(bits: torch.Tensor, prbs: torch.Tensor, n_bits: int,
             keep: torch.Tensor, pad_bits: int) -> torch.Tensor:
    """scramble -> convolutional encode -> puncture."""
    return puncture(conv_encode(scramble(bits, prbs), n_bits), keep, pad_bits)


# The DAB interleaving rule delays bit b by DELAYS[b mod 16] CIFs -- the
# bit-reversed 0..15 sequence (ref: src/TimeInterleaver.cpp:66-92,
# EN 300 401 Table 21).
TI_DELAYS = (0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15)


def time_interleave(bits: torch.Tensor, history: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """DAB time interleaver over a batch of consecutive CIFs.

    bits:    [T, n] current frames in time order
    history: [15, n] the 15 previous frames (history[-1] = most recent)

    Returns (out [T, n], new_history [15, n]).  The delay depends only on
    b mod 16, so with the bit axis viewed as [n/16, 16] each of the 16 lanes
    is a static slice along the CIF axis.
    """
    T, n = bits.shape
    full = torch.cat([history, bits], dim=0)                  # [15+T, n]
    fr = full.view(15 + T, n // 16, 16)
    lanes = [fr[15 - d:15 - d + T, :, j] for j, d in enumerate(TI_DELAYS)]
    out = torch.stack(lanes, dim=-1).reshape(T, n)
    return out, full[-15:].clone()


def time_interleave_all(bits: list[torch.Tensor], histories
                        ) -> tuple[list[torch.Tensor], tuple]:
    """time_interleave of every sub-channel of a batch: bits [T, n_i] and
    histories [15, n_i] a sub-channel -> (outputs, new histories)."""
    pairs = [time_interleave(b, h) for b, h in zip(bits, histories)]
    return [out for out, _ in pairs], tuple(h for _, h in pairs)


def assemble_cif(subch_bits: list[torch.Tensor], offsets_bits: list[int],
                 filler_bits: torch.Tensor) -> torch.Tensor:
    """Overlay sub-channel frames into the 864-CU CIF over the PRBS filler
    (ref: src/FrameMultiplexer.cpp:43-91).

    subch_bits: per-subchannel [T, framesize_cu*64] bit tensors
    offsets_bits: static start offsets (start_address * 64)
    filler_bits: [CIF_BITS] PRBS filler

    Non-overlapping sub-channels (every real mux) assemble as one concat of
    [filler gap, sub, filler gap, ...] pieces; overlapping layouts are
    overlaid one after another, like the reference.
    """
    T = subch_bits[0].shape[0] if subch_bits else None
    n = filler_bits.shape[0]
    order = sorted(range(len(subch_bits)), key=lambda i: offsets_bits[i])
    disjoint = all(
        offsets_bits[order[k]] + subch_bits[order[k]].shape[1]
        <= offsets_bits[order[k + 1]]
        for k in range(len(order) - 1))
    if T is not None and subch_bits and disjoint \
            and offsets_bits[order[-1]] \
            + subch_bits[order[-1]].shape[1] <= n:
        pieces = []
        pos = 0
        fill = filler_bits.expand(T, n)
        for i in order:
            off, sb = offsets_bits[i], subch_bits[i]
            if off > pos:
                pieces.append(fill[:, pos:off])
            pieces.append(sb)
            pos = off + sb.shape[1]
        if pos < n:
            pieces.append(fill[:, pos:])
        return torch.cat(pieces, dim=1)
    # overlapping/degenerate layouts: sequential overlay like the reference
    cif = filler_bits.expand(T, n) if T is not None else filler_bits[None]
    for sb, off in zip(subch_bits, offsets_bits):
        cif = torch.cat([cif[:, :off], sb, cif[:, off + sb.shape[1]:]], dim=1)
    return cif


def block_partition(fic_bits: torch.Tensor, cif_bits: torch.Tensor,
                    cif_count: int) -> torch.Tensor:
    """Group cif_count CIFs into one transmission-frame bit stream:
    [cifCount x FIC][cifCount x CIF] (ref: src/BlockPartitioner.cpp:78-124).

    fic_bits: [T, fic_out_bits] per ETI frame; cif_bits: [T, CIF_BITS];
    T must be a multiple of cif_count.  Returns [T/cifCount, tf_bits].
    """
    B = fic_bits.shape[0] // cif_count
    f = fic_bits.reshape(B, cif_count * fic_bits.shape[1])
    c = cif_bits.reshape(B, cif_count * cif_bits.shape[1])
    return torch.cat([f, c], dim=1)
