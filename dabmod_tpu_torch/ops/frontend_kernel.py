"""The front end, ETI payload bytes to the OFDM backend's carrier planes: a
hand-written CUDA kernel for Hopper (K5, csrc/frontend.cu) and its plain
PyTorch version, the chain of ops/fec.py and ops/ofdm.py.

The chain: for the FIC and every sub-channel, unpack_bits -> scramble ->
conv_encode -> puncture; the sub-channels' time interleaver
(fec.time_interleave_all) and the CIF overlay over the PRBS filler
(fec.assemble_cif); block_partition; then qpsk_phase_indices ->
diff_modulate -> phases_to_carriers and the NULL row (TII in the NULL
symbol of even TFs), the CIC taps on every row.  Out: symbol planes
[B, S, C] float32 in interleaver-input order (the deferred frequency
interleave, models/modulator.py), the NULL row first, and the new
time-interleaver history, one [15, width] uint8 tensor a sub-channel.

The TPU package runs this chain as XLA ops, which XLA fuses: it has no
Pallas kernel here, and K5 replaces none.  On the card the chain ran as
some 410 small eager ops a captured step, whatever the batch; K5 computes
every output from the input bytes through the tables of FrontendTable,
built once from the layout, in one launch.

* `frontend(fic, subch, ti_history, tf_index, table)`: CUDA tensors
  launch K5 (and count the launch in `frontend.launches`); CPU tensors
  take frontend_plain.
* `frontend_plain(..., time_interleave=, tap=)`: the chain, each stage
  under its record_function range; the modulator also runs it on the card
  where K5 does not apply (another time-interleaver coupling, or the stage
  taps of modulate_traced).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
from torch.profiler import record_function

from .. import tables
from . import build, fec, ofdm

THREADS_PER_BLOCK = 256     # csrc/frontend.cu kThreads
CARRIERS_PER_BLOCK = 32     # csrc/frontend.cu kLanes: carriers a symbol block
MAX_SYMBOLS = 160           # csrc/frontend.cu kMaxSymbols: data symbols a TF
MAX_UNITS = 65              # csrc/frontend.cu kMaxUnits: the FIC and 64
                            # sub-channels
HISTORY = 15                # CIFs of time-interleaver history

# each generator's taps as a 7-bit mask over input bits s, s-1, .., s-6 of
# encoder step s (csrc/frontend.cu kGenMask)
GEN_MASKS = tuple(sum(1 << d for d in taps) for taps in tables.CONV_TAPS)


@dataclasses.dataclass(frozen=True)
class FrontendTable:
    """The front end's tables on one device: those of the plain chain and
    K5's composed ones.

    K5's units are the FIC (unit 0) and the sub-channels (unit i + 1 for
    sub-channel i), each with its input bytes a frame, the offset of its
    packed PRBS in `prbs`, the offset of its punctured bits' mother-code
    indices in `keep` and its punctured bits a frame (the sub-channels'
    time-interleaver width)."""
    p: tables.ModeParams
    # the plain chain's
    fic_prbs: torch.Tensor           # uint8 bits [fic_size_in * 8]
    fic_punct: tuple                 # (keep int64, pad bits)
    subch_prbs: tuple                # uint8 bits [n_i * 8] a sub-channel
    subch_punct: tuple               # (keep int64, pad bits) a sub-channel
    widths: tuple                    # punctured bits a frame a sub-channel
    offsets: tuple                   # each sub-channel's first CIF bit
    cif_filler: torch.Tensor         # uint8 bits [CIF_BITS]
    ref_q: torch.Tensor              # int32 [C]: the phase reference
    tii: tuple | None                # (re, im) float32 [C] of the NULL row
    cic: torch.Tensor | None         # float32 [C]: the CIC equalizer taps
    # K5's
    units: tuple                     # (n_bytes, prbs offset, keep offset,
                                     #  width) a unit
    prbs: torch.Tensor               # uint8: each unit's PRBS, packed
    keep: torch.Tensor               # int32: each unit's punctured bits'
                                     # mother-code indices, -1 the padding
    cif_src: torch.Tensor            # int32 [CIF_BITS]: unit << 16 | bit,
                                     # -1 the filler (the last writer's)

    @property
    def fic_width(self) -> int:
        return self.units[0][3]


def make_table(p: tables.ModeParams, layout, ref_q: np.ndarray,
               tii=None, cic=None, device="cpu") -> FrontendTable:
    """The front end's tables for mode parameters p and an ensemble layout
    on `device`: `ref_q` the phase reference in eighths (int, [C]), `tii`
    the NULL row's TII planes or None, `cic` the CIC taps or None, all in
    interleaver-input order."""
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    units, prbs, keeps = [], [], []

    def unit(n_bytes, plan):
        keep = fec.puncture_index(plan)
        width = keep.size + plan[1]
        units.append((n_bytes, sum(a.size for a in prbs),
                      sum(a.size for a in keeps), width))
        prbs.append(tables.prbs_bytes(n_bytes))
        keeps.append(np.concatenate([keep, np.full(plan[1], -1)]))
        return (t(keep, torch.int64), plan[1]), width

    plan = tables.puncture_plan(tables.fic_rules(layout.mid),
                                p.fic_size_in * 4 + 3)
    assert plan[2] == p.fic_size_out, (plan[2], p.fic_size_out)
    fic_punct, _ = unit(p.fic_size_in, plan)
    subch_punct, widths, offsets = [], [], []
    cif_src = np.full(tables.CIF_BITS, -1, np.int64)
    for i, sub in enumerate(layout.subchannels):
        plan = tables.puncture_plan(sub.rules(), sub.framesize * 4 + 3,
                                    out_bytes_expected=sub.framesize_cu * 8)
        punct, width = unit(sub.framesize, plan)
        off = sub.start_address * 64
        if off + width > tables.CIF_BITS:
            raise ValueError(f"sub-channel {i} ends at bit {off + width}, "
                             f"past the CIF's {tables.CIF_BITS}")
        subch_punct.append(punct)
        widths.append(width)
        offsets.append(off)
        # fec.assemble_cif overlays the sub-channels in layout order
        cif_src[off:off + width] = ((i + 1) << 16) + np.arange(width)
    if len(units) > MAX_UNITS:
        raise ValueError(f"{len(units) - 1} sub-channels: K5 takes "
                         f"{MAX_UNITS - 1} at most")
    return FrontendTable(
        p=p, fic_prbs=t(tables.prbs_bits(p.fic_size_in), torch.uint8),
        fic_punct=fic_punct,
        subch_prbs=tuple(t(tables.prbs_bits(sub.framesize), torch.uint8)
                         for sub in layout.subchannels),
        subch_punct=tuple(subch_punct), widths=tuple(widths),
        offsets=tuple(offsets),
        cif_filler=t(tables.prbs_bits(tables.CIF_BYTES), torch.uint8),
        ref_q=t(ref_q, torch.int32), tii=tii, cic=cic, units=tuple(units),
        prbs=t(np.concatenate(prbs), torch.uint8),
        keep=t(np.concatenate(keeps), torch.int32),
        cif_src=t(cif_src, torch.int32))


def _no_tap(name, value):
    pass


def data_symbols_plain(fic, subch, ti_history, table: FrontendTable,
                       time_interleave=fec.time_interleave_all,
                       tap=_no_tap):
    """FEC and carrier mapping: ETI payload bytes -> differentially
    modulated carrier planes [B, L + 1, C] (the phase reference first) and
    the new time-interleaver history.  `time_interleave` takes every
    sub-channel's punctured rows and histories at once
    (parallel.ShardedModulator passes its minimal-halo form); `tap(name,
    value)` sees each stage's output (modulate_traced's dumps)."""
    p = table.p
    with record_function("fec"):
        fic_out = fec.fec_path(fec.unpack_bits(fic), table.fic_prbs,
                               p.fic_size_in * 8, *table.fic_punct)
        punctured = [
            fec.fec_path(fec.unpack_bits(x), prbs, prbs.shape[0], *punct)
            for x, prbs, punct in zip(subch, table.subch_prbs,
                                      table.subch_punct)]
        cif_parts, new_hist = time_interleave(punctured, ti_history)
        cif = fec.assemble_cif(cif_parts, list(table.offsets),
                               table.cif_filler)
        tf_bits = fec.block_partition(fic_out, cif, p.cif_count)
        tap("fec", tf_bits)
    with record_function("qpsk_map"):
        q = ofdm.qpsk_phase_indices(tf_bits, p.nb_carriers)
        tap("qpsk_map", q)
    with record_function("diff_mod"):
        phases = ofdm.diff_modulate(q, table.ref_q)
        tap("diff_mod", phases)
    with record_function("carriers"):
        carriers = ofdm.phases_to_carriers(phases)
        tap("carriers", carriers)
    return carriers, tuple(new_hist)


def frontend_plain(fic, subch, ti_history, tf_index, table: FrontendTable,
                   time_interleave=fec.time_interleave_all, tap=_no_tap):
    """Plain PyTorch version of frontend: data_symbols_plain, then the NULL
    symbol ahead of each TF, with TII in the NULL symbol of every TF whose
    index (tf_index + b) is even, and the CIC taps on every row."""
    p = table.p
    B = fic.shape[0] // p.cif_count
    data_syms, new_hist = data_symbols_plain(fic, subch, ti_history, table,
                                             time_interleave, tap)
    with record_function("tii_null"):
        if table.tii is not None:
            # ref: src/TII.cpp:241-243
            tf_idx = tf_index + torch.arange(B, dtype=torch.int32,
                                             device=fic.device)
            insert = (tf_idx % 2 == 0).to(torch.float32)[:, None]
            null_row = tuple(v[None, :] * insert for v in table.tii)
        else:
            zero = torch.zeros((B, p.nb_carriers), dtype=torch.float32,
                               device=fic.device)
            null_row = (zero, zero)
        symbols = tuple(torch.cat([n[:, None], d], dim=1)
                        for n, d in zip(null_row, data_syms))
        if table.cic is not None:
            symbols = tuple(x * table.cic for x in symbols)
        tap("tii_null", symbols)
    return symbols, new_hist


def _check_inputs(fic, subch, ti_history, table: FrontendTable) -> bool:
    """True when the inputs lie on the CPU (take the plain version)."""
    p = table.p
    if len(subch) != len(table.widths) or len(ti_history) != len(subch):
        raise ValueError(f"{len(subch)} sub-channels and {len(ti_history)} "
                         f"histories, the table has {len(table.widths)}")
    T = fic.shape[0]
    if fic.dim() != 2 or fic.shape[1] != p.fic_size_in or T % p.cif_count:
        raise ValueError(f"FIC bytes {tuple(fic.shape)}: expected [T, "
                         f"{p.fic_size_in}], T a multiple of {p.cif_count}")
    for x, h, (n, _, _, w) in zip(subch, ti_history, table.units[1:]):
        if tuple(x.shape) != (T, n) or tuple(h.shape) != (HISTORY, w):
            raise ValueError(f"sub-channel bytes {tuple(x.shape)} and "
                             f"history {tuple(h.shape)}: expected "
                             f"[{T}, {n}] and [{HISTORY}, {w}]")
    tensors = (fic, *subch, *ti_history)
    if any(x.dtype != torch.uint8 for x in tensors):
        raise TypeError("expected uint8 bytes and histories")
    if any(x.device != table.keep.device for x in tensors):
        raise ValueError(f"inputs not all on the table's device "
                         f"{table.keep.device}")
    if fic.device.type == "cpu":
        return True
    if fic.device.type != "cuda":
        raise ValueError(f"unsupported device {fic.device}")
    return False


class _Units(ctypes.Structure):
    """csrc/frontend.cu's Units, passed to the launch function by
    address: each unit's pointers and sizes."""
    _fields_ = [("bytes", ctypes.c_void_p * MAX_UNITS),
                ("hist_in", ctypes.c_void_p * MAX_UNITS),
                ("n_bytes", ctypes.c_int * MAX_UNITS),
                ("prbs", ctypes.c_int * MAX_UNITS),
                ("keep", ctypes.c_int * MAX_UNITS),
                ("width", ctypes.c_int * MAX_UNITS),
                ("hist_out", ctypes.c_int * MAX_UNITS),
                ("n_units", ctypes.c_int)]


@functools.cache
def _launcher():
    return build.launcher("frontend", "dabmod_frontend", 13,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int)


def launch_shape() -> dict:
    """K5's launch shape on the current CUDA device, as its source reports
    it: threads and carriers a block, and resident blocks an SM by the
    CUDA runtime's occupancy calculator.  Builds the library if needed."""
    threads, lanes, blocks = build.query("frontend", "dabmod_frontend_shape",
                                         3)
    return {"threads_per_block": threads, "carriers_per_block": lanes,
            "resident_blocks_per_sm": blocks}


def frontend(fic, subch, ti_history, tf_index, table: FrontendTable):
    """ETI payload bytes (fic [T, fic_size_in], subch [T, n_i] a
    sub-channel, uint8), the time-interleaver history ([15, width] uint8 a
    sub-channel) and the state's TF index -> (symbol planes [B, S, C]
    float32 in interleaver-input order, the NULL row first; the new
    history).

    CUDA tensors launch K5 (and count the launch in `frontend.launches`);
    CPU tensors take frontend_plain."""
    if _check_inputs(fic, subch, ti_history, table):
        return frontend_plain(fic, subch, ti_history, tf_index, table)
    p = table.p
    dev = fic.device
    T = fic.shape[0]
    B, C, L = T // p.cif_count, p.nb_carriers, p.data_symbols
    if L > MAX_SYMBOLS:
        raise ValueError(f"{L} data symbols: K5 takes {MAX_SYMBOLS} at most")
    if not isinstance(tf_index, torch.Tensor):
        tf_index = torch.tensor(tf_index, dtype=torch.int32, device=dev)
    if tf_index.dtype != torch.int32 or tf_index.device != dev:
        raise TypeError(f"tf_index {tf_index.dtype} on {tf_index.device}: "
                        f"expected int32 on {dev}")
    re = torch.empty((B, L + 2, C), dtype=torch.float32, device=dev)
    im = torch.empty_like(re)
    hist = torch.empty(HISTORY * sum(table.widths), dtype=torch.uint8,
                       device=dev)
    # the sub-channels' [15, width] histories, contiguous views of one
    # buffer in layout order
    new_hist = tuple(x.view(HISTORY, w) for x, w in zip(
        hist.split([HISTORY * w for w in table.widths]), table.widths))
    if B == 0:
        return (re, im), new_hist
    units = _Units(n_units=len(table.units))
    inputs = [x.contiguous() for x in (fic, *subch)]
    hist_in = [None, *(h.contiguous() for h in ti_history)]
    hist_at = 0
    for k, (n, prbs, keep, width) in enumerate(table.units):
        units.bytes[k] = inputs[k].data_ptr()
        units.n_bytes[k], units.prbs[k] = n, prbs
        units.keep[k], units.width[k] = keep, width
        if k:                       # a sub-channel: its history
            units.hist_in[k] = hist_in[k].data_ptr()
            units.hist_out[k] = hist_at
            hist_at += HISTORY * width
    tii = table.tii or (None, None)
    optional = [0 if x is None else x.data_ptr() for x in (*tii, table.cic)]
    # the five front-end stages in one launch, under the first's range
    with record_function("fec"), torch.cuda.device(dev):
        err = _launcher()(
            ctypes.addressof(units), table.prbs.data_ptr(),
            table.keep.data_ptr(), table.cif_src.data_ptr(),
            table.cif_filler.data_ptr(), table.ref_q.data_ptr(), *optional,
            tf_index.data_ptr(), re.data_ptr(), im.data_ptr(),
            hist.data_ptr(), T, p.cif_count, L, C, table.fic_width,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"frontend kernel launch failed: CUDA error {err}")
    frontend.launches += 1
    return (re, im), new_hist


frontend.launches = 0
