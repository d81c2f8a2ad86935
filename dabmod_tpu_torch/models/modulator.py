"""The DAB modulator on PyTorch (port of dabmod_tpu/models/modulator.py,
main path).

One call modulates a batch of transmission frames:

    out, state, stats = Modulator(layout, settings).modulate(
        fic_bytes, subch_bytes, state)

The mode- and ensemble-dependent tables are built in NumPy at construction
and held as tensors on the modulator's device.  The sequential state is
the time interleaver's 15-CIF history per sub-channel and the TF index,
with CFR the rotating MER symbol index, and with the resampler its input
carry: a dict of tensors carried from one batch to the next.

The ported paths: TM I-IV, fft_engine=fftw, guard-interval overlap 0, with
or without one CFR iteration (enable_cfr, with its statistics), at
2.048 MS/s or through the polyphase resampler to an output rate that
dabmod_tpu's resampler kernel takes (L/M with M dividing 128: 3.072,
4.096 and 8.192 MS/s among them, and with resampler_mode="poly" also
below 2.048 MS/s, such as 1.024 MS/s); no TII, CIC, FIR or DPD;
f32 (re, im) planes, f32 pairs or s16 wire words out.  Every other setting
raises NotImplementedError naming the ROADMAP.md item that ports it.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..config import ModSettings
from ..eti import EnsembleLayout, EtiFrameBatch
from ..ops import fec, fft, ofdm, ofdm_kernel, resampler_kernel
from ..ops.cplx import planes_to_pairs
from ..ops.filters import PolyphasePlan, pack_s16_planes

BASE_RATE = 2_048_000        # the modulator's native sample rate


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card.  Without one this raises: the CPU runs
    only when the caller asks for it with device="cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the modulator runs on the CUDA card by "
            "default; pass device='cpu' to run it on the CPU")
    return dev


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to dabmod_tpu_torch yet (ROADMAP {item})")


def resampler_plan(s: ModSettings) -> PolyphasePlan | None:
    """The polyphase plan for s.output_rate, or None at 2.048 MS/s.

    dabmod_tpu's rule (its modulator.py:162-198): resampler_mode "auto"
    takes the polyphase resampler for output rates above 2.048 MS/s and
    the frequency-domain one below; its kernel takes a polyphase plan with
    128-sample frames (M divides 128).  The port has that kernel only:
    every other choice raises NotImplementedError (ROADMAP A7)."""
    if s.output_rate == BASE_RATE:
        return None
    mode = s.resampler_mode
    if mode not in ("auto", "poly", "fft"):
        raise ValueError(f"unknown resampler_mode {mode!r}")
    if mode == "auto":
        mode = "poly" if s.output_rate >= BASE_RATE else "fft"
    what = f"the resampler at output_rate={s.output_rate}"
    if mode == "fft":
        raise _not_ported(f"{what} (frequency-domain)", "A7")
    plan = PolyphasePlan.create(BASE_RATE, s.output_rate)
    if not resampler_kernel.supports(plan):
        raise _not_ported(f"{what} (L/M = {plan.L}/{plan.M}: the polyphase "
                          f"form without the 128-sample kernel)", "A7")
    return plan


def _check_supported(s: ModSettings) -> PolyphasePlan | None:
    """Reject every setting outside the ported paths; returns the
    resampler's plan (None at 2.048 MS/s)."""
    if s.fft_engine != "fftw":
        raise _not_ported(f"fft_engine={s.fft_engine}", "A9")
    if s.tii_enable:
        raise _not_ported("TII (tii_enable)", "A8")
    plan = resampler_plan(s)
    if s.cic_eq_clock_rate:
        # the same activation rule as dabmod_tpu's CIC taps
        ratio = s.cic_eq_clock_rate // s.output_rate // 4
        use = (ratio & 1) if s.cic_eq_clock_rate == 400_000_000 else True
        if use and ratio > 0:
            raise _not_ported("the CIC equalizer (cic_eq_clock_rate)", "A8")
    if s.filter_taps_file:
        raise _not_ported("the FIR filter (filter_taps_file)", "A8")
    if s.poly_coef_file:
        raise _not_ported("DPD (poly_coef_file)", "A8")
    if s.ofdm_window_overlap:
        raise _not_ported(
            f"the windowed guard interval (ofdm_window_overlap="
            f"{s.ofdm_window_overlap})", "A7")
    return plan


def _wire_format(s: ModSettings):
    """Wire-format selection of dabmod_tpu (src/DabMod.cpp:450-466): file
    and ZMQ convert to their integer format, the sc16-native SDR devices
    (BladeRF, Dexter) always take s16.  None = float output."""
    if not s.device_format_conversion:
        return None
    if s.output == "file" and s.file_output_format in ("s16", "u8", "s8"):
        fmt = s.file_output_format
    elif s.output == "zmq" and s.zmq_output_format in ("s16", "u8", "s8"):
        fmt = s.zmq_output_format
    elif s.output in ("bladerf", "dexter"):
        fmt = "s16"
    else:
        return None
    if fmt != "s16":
        raise _not_ported(f"the {fmt} wire format", "A7")
    return fmt


class Modulator:
    """Modulator for one (mode, ensemble layout, settings) triple, with its
    tables on one device (default: the CUDA card)."""

    def __init__(self, layout: EnsembleLayout,
                 settings: ModSettings | None = None, device=None):
        self.layout = layout
        self.settings = s = settings or ModSettings()
        res_plan = _check_supported(s)
        fft.set_precision(s.fft_precision)
        self.device = dev = resolve_device(device)
        mode = s.dab_mode if s.dab_mode else layout.dab_mode
        self.mode = mode
        self.p = p = tables.mode_params(mode)

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        # --- FEC tables (bits are uint8, see ops.fec) ---
        self._fic_prbs = t(tables.prbs_bits(p.fic_size_in), torch.uint8)
        self._fic_nbits = p.fic_size_in * 8
        plan = tables.puncture_plan(
            tables.fic_rules(layout.mid), p.fic_size_in * 4 + 3)
        assert plan[2] == p.fic_size_out, (plan[2], p.fic_size_out)
        self._fic_punct = (t(fec.puncture_index(plan)), plan[1])

        self._subch_prbs = []
        self._subch_nbits = []
        self._subch_punct = []
        self._subch_ti_bits = []
        self._subch_offsets = []
        for sub in layout.subchannels:
            n = sub.framesize
            self._subch_prbs.append(t(tables.prbs_bits(n), torch.uint8))
            self._subch_nbits.append(n * 8)
            plan = tables.puncture_plan(
                sub.rules(), n * 4 + 3, out_bytes_expected=sub.framesize_cu * 8)
            self._subch_punct.append((t(fec.puncture_index(plan)), plan[1]))
            # the width of the time-interleaver history
            self._subch_ti_bits.append(int(
                tables.time_interleave_masks(plan[2] * 8).shape[1]))
            self._subch_offsets.append(sub.start_address * 64)

        self._cif_filler = t(tables.prbs_bits(tables.CIF_BYTES), torch.uint8)

        # --- OFDM tables ---
        self._inv_perm = np.asarray(tables.freq_interleave_inverse(mode))
        ref_q = np.asarray(tables.phase_ref_eighths(mode))
        bm_src, bm_valid = tables.bin_map(mode)
        self._bin_valid = np.asarray(bm_valid.astype(np.float32))

        # Deferred frequency interleaving (as in dabmod_tpu): the
        # interleaver is a carrier permutation and the differential cumsum
        # acts per carrier, so they commute.  The front end emits symbols
        # in interleaver-INPUT order, the phase reference is pre-permuted
        # to match, and the permutation rides the OFDM kernel's composed
        # carrier->bin gather.
        carrier_of_pre = np.argsort(self._inv_perm)
        self._ref_q_pre = ref_q[carrier_of_pre]
        self._bin_src_pre = self._inv_perm[bm_src]
        self._ref_q_pre_t = t(self._ref_q_pre, torch.int32)
        self._inv_perm_t = t(self._inv_perm, torch.int64)
        self._ofdm_table = ofdm_kernel.make_table(
            self._bin_src_pre, self._bin_valid, dev)

        # --- resampler (the polyphase kernel's table) ---
        self._res_table = (None if res_plan is None
                           else resampler_kernel.make_table(res_plan, dev))

        self._wire_fmt = _wire_format(s)

    @property
    def tf_samples_out(self) -> int:
        """Output samples per transmission frame, at the output rate."""
        n = self.p.tf_samples
        if self._res_table is not None:
            n = n * self._res_table.plan.L // self._res_table.plan.M
        return n

    # ------------------------------------------------------------------
    def init_state(self):
        """Initial sequential state (a dict carried between batches): the
        time-interleaver histories and the TF index; with CFR the rotating
        MER symbol index, with the resampler its input carry."""
        dev = self.device
        state = {
            "ti_history": tuple(
                torch.zeros((15, n), dtype=fec.BIT_DTYPE, device=dev)
                for n in self._subch_ti_bits),
            "tf_index": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.settings.enable_cfr:
            # ref: src/OfdmGenerator.cpp:198
            state["mer_index"] = torch.zeros((), dtype=torch.int32,
                                             device=dev)
        if self._res_table is not None:
            h2 = 2 * self._res_table.plan.half
            state["res_carry"] = tuple(
                torch.zeros(h2, dtype=torch.float32, device=dev)
                for _ in range(2))
        return state

    def _bytes(self, x) -> torch.Tensor:
        """ETI payload bytes (numpy or tensor) as uint8 on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.uint8)
        return torch.as_tensor(np.ascontiguousarray(x, np.uint8),
                               device=self.device)

    # ------------------------------------------------------------------
    def _frontend_impl(self, fic_bytes, subch_bytes, ti_history):
        """Bit-domain FEC + carrier mapping: ETI payload bytes ->
        differential-modulated carrier symbols [B, nb_symbols, C] in
        interleaver-input order (see the deferred-FI note in __init__)."""
        p = self.p
        fic_bits = fec.unpack_bits(fic_bytes)
        fic_out = fec.fec_path(fic_bits, self._fic_prbs, self._fic_nbits,
                               *self._fic_punct)
        cif_parts = []
        new_hist = []
        for i in range(len(self.layout.subchannels)):
            bits = fec.unpack_bits(subch_bytes[i])
            pb = fec.fec_path(bits, self._subch_prbs[i], self._subch_nbits[i],
                              *self._subch_punct[i])
            ti, h = fec.time_interleave(pb, ti_history[i])
            cif_parts.append(ti)
            new_hist.append(h)
        cif = fec.assemble_cif(cif_parts, self._subch_offsets,
                               self._cif_filler)
        tf_bits = fec.block_partition(fic_out, cif, p.cif_count)

        q = ofdm.qpsk_phase_indices(tf_bits, p.nb_carriers)
        phases = ofdm.diff_modulate(q, self._ref_q_pre_t)
        return ofdm.phases_to_carriers(phases), tuple(new_hist)

    def frontend(self, fic_bytes, subch_bytes, ti_history):
        """The front end alone (for stage-level validation).  Returns the
        symbols in CARRIER order (the external contract) and the new
        time-interleaver history."""
        syms, new_hist = self._frontend_impl(
            self._bytes(fic_bytes), tuple(self._bytes(x) for x in subch_bytes),
            ti_history)
        return (tuple(ofdm.freq_interleave(x, self._inv_perm_t)
                      for x in syms), new_hist)

    def _ofdm_symbols_impl(self, fic_bytes, subch_bytes, ti_history):
        """The front end and the all-zero NULL symbol ahead of each TF:
        the OFDM backend's input [B, S, C] (interleaver-input order) and
        the new time-interleaver history."""
        p = self.p
        B = fic_bytes.shape[0] // p.cif_count
        data_syms, new_hist = self._frontend_impl(
            fic_bytes, subch_bytes, ti_history)               # [B, 76, C]
        zero = torch.zeros((B, 1, p.nb_carriers), dtype=torch.float32,
                           device=self.device)
        return tuple(torch.cat([zero, d], dim=1) for d in data_syms), new_hist

    def ofdm_symbols(self, fic_bytes, subch_bytes, ti_history):
        """The OFDM backend's input for one batch (for stage-level
        validation): symbol planes [B, S, C] in interleaver-input order,
        NULL symbol included, and the new time-interleaver history."""
        with torch.no_grad():
            return self._ofdm_symbols_impl(
                self._bytes(fic_bytes),
                tuple(self._bytes(x) for x in subch_bytes), ti_history)

    def _cfr_stats(self, kstats, mer_index):
        """Batch statistics from the CFR kernel's per-symbol lanes
        (dabmod_tpu's modulator.py:571-628): clip counts and PAPR before and
        after CFR over the data symbols (the all-zero NULL symbol is
        excluded), and the in-loop MER (ETSI ETR 290 Annex C) of one
        rotating symbol per TF: TF b inspects symbol (mer_index + 1 + b)
        mod S, and symbol 0 (NULL) gives no measurement
        (ref: src/OfdmGenerator.cpp:234-273).  Returns (stats, the next
        mer_index)."""
        B, S, _ = kstats.shape
        K = ofdm_kernel
        n_data = (S - 1) * self.p.spacing
        stats = {
            "cfr_clip": kstats[..., K.ST_NCLIP].sum(dim=1).to(torch.int32),
            "cfr_errclip": kstats[..., K.ST_NERRCLIP].sum(dim=1).to(
                torch.int32),
        }
        for key, pk, pw in (("papr_before_cfr", K.ST_PEAK_BEFORE,
                             K.ST_POW_BEFORE),
                            ("papr_after_cfr", K.ST_PEAK_AFTER,
                             K.ST_POW_AFTER)):
            peak = kstats[:, 1:, pk].amax(dim=1)
            mean = kstats[:, 1:, pw].sum(dim=1) / n_data
            stats[key] = 10.0 * torch.log10(peak / mean)
        rows = torch.arange(B, device=kstats.device)
        mer_idx = (mer_index + 1 + rows) % S
        num = kstats[rows, mer_idx, K.ST_POW_BEFORE]
        den = kstats[rows, mer_idx, K.ST_MER_DEN]
        mer = torch.where(
            den > 0, 10.0 * torch.log10(num / torch.clamp(den, min=1e-30)),
            90.0)                                   # clamp, ref :269-271
        stats["mer_db"] = torch.clamp(mer, max=90.0)
        stats["mer_valid"] = mer_idx > 0
        return stats, ((mer_index + B) % S).to(torch.int32)

    def _modulate_impl(self, fic_bytes, subch_bytes, state,
                       constant_gain: float, var_k: float):
        p = self.p
        s = self.settings
        symbols, new_hist = self._ofdm_symbols_impl(
            fic_bytes, subch_bytes, state["ti_history"])      # [B, S, C]
        B = symbols[0].shape[0]
        new_state = {"ti_history": new_hist,
                     "tf_index": state["tf_index"] + B}
        stats = {}

        # the hand-written OFDM kernels on the card (the plain versions on
        # the CPU): composed carrier->bin gather + IFFT, and with CFR one
        # clip / error-clip iteration and its per-symbol statistics
        if s.enable_cfr:
            td, kstats = ofdm_kernel.ofdm_cfr_backend(
                symbols, self._ofdm_table, s.cfr_clip, s.cfr_error_clip)
            stats, new_state["mer_index"] = self._cfr_stats(
                kstats, state["mer_index"])
        else:
            td = ofdm_kernel.ofdm_backend(symbols, self._ofdm_table)

        gains = ofdm.compute_gain(td, s.gain_mode, var_k) * constant_gain
        iq = ofdm.guard_interval_unwindowed(td, p.null_size, p.sym_size,
                                            gains=gains)      # planes [B, tf]

        if self._res_table is not None:
            # the polyphase resampler on the flat stream; its carry links
            # one batch to the next
            flat, carry = resampler_kernel.resample(
                tuple(x.reshape(-1) for x in iq), state["res_carry"],
                self._res_table)
            iq = tuple(x.reshape(B, -1) for x in flat)
            new_state["res_carry"] = carry

        if self._wire_fmt == "s16":
            # packed int32 words, byte-identical to interleaved s16 pairs
            out, stats["num_clipped"] = pack_s16_planes(iq[0], iq[1])
            return out, new_state, stats
        if not s.device_interleave:
            return iq, new_state, stats
        return planes_to_pairs(iq), new_state, stats

    def modulate(self, fic_bytes, subch_bytes, state):
        """Run one batch.  fic_bytes [T, fic_len] uint8, subch_bytes tuple of
        [T, framesize] uint8 with T a multiple of cif_count (numpy arrays or
        tensors).  Returns (output, new_state, stats):

        * f32 planes (re, im) [B, tf_samples_out] with
          device_interleave=False;
        * f32 pairs [B, tf_samples_out, 2] with device_interleave=True;
        * int32 s16 wire words [B, tf_samples_out] for an s16 output, with
          stats["num_clipped"].

        With CFR, stats also holds per TF [B]: "cfr_clip" and "cfr_errclip"
        (int32 counts), "papr_before_cfr", "papr_after_cfr" and "mer_db"
        (float32 dB) and "mer_valid" (bool).
        """
        fic = self._bytes(fic_bytes)
        if fic.shape[0] % self.p.cif_count:
            raise ValueError(f"{fic.shape[0]} ETI frames is not a multiple "
                             f"of {self.p.cif_count} CIFs per TF")
        s = self.settings
        # float32 scalars, as dabmod_tpu passes them (jnp.float32)
        constant_gain = float(np.float32(s.normalise * s.digital_gain))
        var_k = float(np.float32(s.gain_mode_variance))
        with torch.no_grad():
            return self._modulate_impl(
                fic, tuple(self._bytes(x) for x in subch_bytes), state,
                constant_gain, var_k)

    def modulate_eti(self, batch: EtiFrameBatch, state):
        """Convenience: modulate a parsed ETI batch."""
        return self.modulate(batch.fic, tuple(batch.subchannels), state)


def state_from_numpy(state_np, device) -> dict:
    """The JAX modulator's state as the port's: `state_np` holds
    "ti_history" (a tuple of [15, n] {0,1} arrays, one per sub-channel) and
    "tf_index", and with CFR "mer_index", with the polyphase resampler
    "res_carry" (a (re, im) tuple of [2*half] float32 arrays), as numpy
    arrays (np.asarray of dabmod_tpu's state).  With the tables both
    packages build, this is all that makes them compute the same signal
    from the same point of a stream."""
    device = resolve_device(device)

    def scalar(key):
        return torch.tensor(int(np.asarray(state_np[key])),
                            dtype=torch.int32, device=device)
    state = {
        "ti_history": tuple(
            torch.as_tensor(np.asarray(h).astype(np.uint8), device=device)
            for h in state_np["ti_history"]),
        "tf_index": scalar("tf_index"),
    }
    if "mer_index" in state_np:
        state["mer_index"] = scalar("mer_index")
    if "res_carry" in state_np:
        state["res_carry"] = tuple(
            torch.tensor(np.asarray(c), dtype=torch.float32, device=device)
            for c in state_np["res_carry"])
    return state


def make_default_layout(mode: int = 1,
                        subch_specs=((0, 24, 0x22),)) -> EnsembleLayout:
    params = tuple(tables.SubchannelParams(sad, stl * 8, tpl)
                   for sad, stl, tpl in subch_specs)
    mid = {1: 1, 2: 2, 3: 3, 4: 0}[mode]
    return EnsembleLayout(mid, len(params), 128 if mid == 3 else 96,
                          params, tuple(range(len(params))))
