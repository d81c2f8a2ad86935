"""The DAB modulator on PyTorch (port of dabmod_tpu/models/modulator.py, the
float chain).

One call modulates a batch of transmission frames:

    out, state, stats = Modulator(layout, settings).modulate(
        fic_bytes, subch_bytes, state)

The mode- and ensemble-dependent tables are built in NumPy at construction
and held as tensors on the modulator's device.  The sequential state is
the time interleaver's 15-CIF history per sub-channel and the TF index (the
TII every-other-TF toggle), with CFR the rotating MER symbol index, and
with a resampler its carry: a dict of tensors carried from one batch to
the next.

The chain, in dabmod_tpu's order: FEC and carrier mapping -> NULL symbol
(with TII) -> CIC equalizer -> OFDM backend (the hand-written K1, or K2
with one CFR iteration and its statistics) -> gain -> guard interval
(plain or windowed) -> FIR -> resampler (K3, the plain polyphase form, or
the frequency-domain form) -> DPD (polynomial or LUT) -> wire format (f32
planes, f32 pairs, s16, u8 or s8).  TM I-IV.  FIR taps and DPD
coefficients are tensors passed to each step, so a hot swap
(update_fir_taps, update_dpd) replaces tensors and rebuilds nothing.

The two fixed-point engines branch off after the NULL symbol, as in
dabmod_tpu: fft_engine=kiss runs the reference's KISS int16 transform and
the Q1.14 guard interval bit for bit (ops/kiss_fixed.py, int32 torch ops)
into s16 wire words; fft_engine=dexter ends on the device at Q1.14 carrier
symbols [2, B, S, C] (int32), and `host_backend` (io/dexter_fft.py) runs
the FPGA FFT accelerator chain on them on the host.
"""
from __future__ import annotations

import collections
import logging
import os

import numpy as np
import torch

from .. import tables
from ..config import ModSettings
from ..eti import EnsembleLayout, EtiFrameBatch
from ..ops import fec, fft, kiss_fixed, ofdm, ofdm_kernel, resampler_kernel
from ..ops.cplx import planes_from_complex, planes_to_pairs
from ..ops.filters import (PLAIN_BLOCK, PolyphasePlan, ResamplerPlan,
                           cic_equalizer_taps, fir_filter, format_convert,
                           memless_lut, memless_poly, pack_bytes,
                           pack_s16_planes, resample, resample_poly)

BASE_RATE = 2_048_000        # the modulator's native sample rate

log = logging.getLogger("dabmod_tpu_torch.modulator")


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card.  Without one this raises: the CPU runs
    only when the caller asks for it with device="cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the modulator runs on the CUDA card by "
            "default; pass device='cpu' to run it on the CPU")
    return dev


def resampler_route(s: ModSettings, spacing: int):
    """(route, plan) of the resampler for s.output_rate, or None at
    2.048 MS/s; chosen from the settings alone, as dabmod_tpu chooses
    (its modulator.py:159-198):

    * resampler_mode "auto" takes the polyphase resampler at or above
      2.048 MS/s and the frequency-domain one below;
    * "kernel": a polyphase plan with 128-sample frames that K3 takes
      (M divides 128, 2*half <= 128), through resampler_kernel.resample;
    * "poly": any other polyphase plan, with dabmod_tpu's framing for its
      XLA form (32 samples rounded up to a multiple of M; 512 at
      2.5 MS/s), through the plain form filters.resample_poly;
    * "fft": the frequency-domain resampler (filters.resample) with
      transforms of `spacing`-based resolution."""
    if s.output_rate == BASE_RATE:
        return None
    mode = s.resampler_mode
    if mode not in ("auto", "poly", "fft"):
        raise ValueError(f"unknown resampler_mode {mode!r}")
    if mode == "auto":
        mode = "poly" if s.output_rate >= BASE_RATE else "fft"
    if mode == "fft":
        return "fft", ResamplerPlan.create(BASE_RATE, s.output_rate, spacing)
    plan = PolyphasePlan.create(BASE_RATE, s.output_rate)
    if resampler_kernel.supports(plan):
        return "kernel", plan
    return "poly", PolyphasePlan.create(BASE_RATE, s.output_rate,
                                        block=PLAIN_BLOCK)


def _wire_format(s: ModSettings):
    """Wire-format selection of dabmod_tpu (src/DabMod.cpp:450-466): file
    and ZMQ convert to their integer format, the sc16-native SDR devices
    (BladeRF, Dexter) always take s16.  None = float output."""
    if not s.device_format_conversion:
        return None
    if s.output == "file" and s.file_output_format in ("s16", "u8", "s8"):
        return s.file_output_format
    if s.output == "zmq" and s.zmq_output_format in ("s16", "u8", "s8"):
        return s.zmq_output_format
    if s.output in ("bladerf", "dexter"):
        return "s16"
    return None


def _cic_ratio(s: ModSettings) -> int:
    """The CIC equalizer's decimation ratio, 0 when dabmod_tpu builds no
    taps (ref: src/DabModulator.cpp:154-176)."""
    if not s.cic_eq_clock_rate:
        return 0
    ratio = s.cic_eq_clock_rate // s.output_rate // 4
    use = (ratio & 1) if s.cic_eq_clock_rate == 400_000_000 else True
    return ratio if use and ratio > 0 else 0


class Modulator:
    """Modulator for one (mode, ensemble layout, settings) triple, with its
    tables on one device (default: the CUDA card)."""

    def __init__(self, layout: EnsembleLayout,
                 settings: ModSettings | None = None, device=None):
        self.layout = layout
        self.settings = s = settings or ModSettings()
        # fft_engine=kiss|dexter: the reference's fixed-point configuration
        # -- Q1.14 output, no GainControl, and the float-only back-end
        # stages rejected (src/DabModulator.cpp:144-263)
        self._kiss = s.fft_engine == "kiss"
        self._dexter = s.fft_engine == "dexter"
        if self._kiss or self._dexter:
            if s.filter_taps_file:
                raise ValueError("fixed point doesn't support fir filter")
            if s.poly_coef_file:
                raise ValueError("fixed point doesn't support predistortion")
            if s.output_rate != BASE_RATE:
                raise ValueError("fixed point doesn't support resampler")
            if s.enable_cfr:
                raise ValueError("fixed point doesn't support CFR")
            if s.output in ("soapy", "lime", "bladerf"):
                # these drivers re-scale float samples themselves and have
                # no native fixed-point stream path
                # (ref: src/DabMod.cpp:306,326,337)
                raise ValueError(f"{s.output} fixed_point unsupported")
        fft.set_precision(s.fft_precision)
        self.device = dev = resolve_device(device)
        mode = s.dab_mode if s.dab_mode else layout.dab_mode
        self.mode = mode
        self.p = p = tables.mode_params(mode)
        ov = s.ofdm_window_overlap
        if ov and not 0 < ov <= p.sym_size - p.spacing:
            # dabmod_tpu fails in its first modulate instead
            raise ValueError(
                f"ofdm_window_overlap={ov}: outside 1..{p.sym_size - p.spacing}"
                f", the guard interval of TM {mode}")

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
        # in interleaver-INPUT order, the carrier-order constants (phase
        # reference, TII, CIC) are pre-permuted to match, and the
        # permutation rides the OFDM kernel's composed carrier->bin gather.
        carrier_of_pre = np.argsort(self._inv_perm)
        self._ref_q_pre = ref_q[carrier_of_pre]
        self._bin_src_pre = self._inv_perm[bm_src]
        self._ref_q_pre_t = t(self._ref_q_pre, torch.int32)
        self._inv_perm_t = t(self._inv_perm, torch.int64)
        self._ofdm_table = ofdm_kernel.make_table(
            self._bin_src_pre, self._bin_valid, dev)

        # --- TII in the NULL symbol (raises ValueError outside TM I, II) ---
        self._tii_vec = None
        if s.tii_enable:
            tii = tables.tii_symbol(mode, s.tii_comb, s.tii_pattern,
                                    s.tii_old_variant)
            self._tii_vec = planes_from_complex(tii[carrier_of_pre], dev)

        # --- CIC equalizer (deprecated USRP1/2 path,
        #     ref: src/DabModulator.cpp:154-176, src/CicEqualizer.cpp) ---
        self._cic_taps = None
        ratio = _cic_ratio(s)
        if ratio:
            taps = cic_equalizer_taps(
                p.nb_carriers, p.spacing * s.output_rate / 2_048_000.0, ratio)
            self._cic_taps = t(taps[carrier_of_pre])

        # --- FIR ---
        self._fir_taps = None
        if s.filter_taps_file:
            self._fir_taps = np.asarray(
                tables.DEFAULT_FIR_TAPS if s.filter_taps_file == "default"
                else load_fir_taps(s.filter_taps_file))

        # --- resampler: the route is fixed here, from the plan ---
        self._res_route, self._res_plan = (
            resampler_route(s, p.spacing) or (None, None))
        self._res_table = self._res_matrix = None
        if self._res_route == "kernel":
            self._res_table = resampler_kernel.make_table(self._res_plan, dev)
        elif self._res_route == "poly":
            self._res_matrix = t(self._res_plan.matrix)

        # --- DPD ---
        self._poly_am = self._poly_pm = None
        self._lut = self._lut_scale = None
        if s.poly_coef_file:
            kind, data = load_dpd_file(s.poly_coef_file)
            if kind == "poly":
                self._poly_am, self._poly_pm = (np.asarray(a) for a in data)
            else:
                self._lut_scale, self._lut = float(data[0]), np.asarray(
                    data[1])

        # FIR taps and DPD coefficients enter each step as tensors: a
        # reload swaps them (the reference's mutex-guarded coefficient
        # swap, src/FIRFilter.cpp:137-140, src/MemlessPoly.cpp:192-199).
        # Which of them exist is fixed here; a reload that changes a shape
        # or the DPD kind needs a new Modulator, as in the reference.
        self._runtime_params = self._make_runtime_params()

        self._wire_fmt = _wire_format(s)
        if self._kiss:
            # the kiss configuration's wire format is complexfix: Q1.14
            # int16 pairs, in memory the same as interleaved s16
            self._wire_fmt = "s16"

        # the host back end the runtime's fetch thread applies to the
        # fetched output (None for the chains that end on the device): for
        # dexter the device emits Q1.14 symbols [2, B, S, C] and the chain
        # makes the s16 wire (accelerator + wide GI + FormatConverter)
        self.host_backend = None
        if self._dexter:
            from ..io import dexter_fft
            try:
                import iio as _iio  # noqa: PLC0415
            except ImportError:
                _iio = None
            if _iio is None or not hasattr(_iio, "Context"):
                log.warning("fft_engine=dexter: vendor libiio absent -- "
                            "using the software accelerator model")
                _iio = dexter_fft.MockFftAcceleratorIio(p.spacing)
            self.host_backend = dexter_fft.DexterOfdmChain(
                p, s.ofdm_window_overlap, iio_module=_iio)
            self._wire_fmt = "s16"

        # f32 planes contract (ModSettings.device_interleave): the runtime's
        # fetch thread interleaves the pairs on the host
        self.emits_planes = (self._wire_fmt is None
                             and not s.device_interleave)

        # per-stage debug tap (the reference's --enable-trace node dumps,
        # src/Flowgraph.cpp:62-70,177-194): None except inside
        # modulate_traced
        self._tap = None

    # ------------------------------------------------------------------
    def _param(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, np.float32), device=self.device)

    def _make_runtime_params(self) -> dict:
        rp = {}
        if self._fir_taps is not None:
            rp["fir_taps"] = self._param(self._fir_taps)
        if self._poly_am is not None:
            rp["poly_am"] = self._param(self._poly_am)
            rp["poly_pm"] = self._param(self._poly_pm)
        if self._lut is not None:
            rp["lut"] = self._param(self._lut)
            rp["lut_scale"] = self._param(np.float32(self._lut_scale))
        return rp

    def update_fir_taps(self, taps) -> bool:
        """Swap in new FIR taps.  Returns False when the tap count differs
        from this modulator's (a new Modulator is needed)."""
        taps = np.asarray(taps, np.float32)
        if self._fir_taps is None or taps.shape != self._fir_taps.shape:
            return False
        self._fir_taps = taps
        self._runtime_params = dict(self._runtime_params,
                                    fir_taps=self._param(taps))
        return True

    def update_dpd(self, kind: str, data) -> bool:
        """Swap in new DPD coefficients: kind "poly" with (am, pm), or
        "lut" with (scalefactor, lut [32, 2]).  Returns False when the kind
        or a shape differs from this modulator's."""
        if kind == "poly":
            am, pm = (np.asarray(a, np.float32) for a in data)
            if self._poly_am is None or am.shape != self._poly_am.shape \
                    or pm.shape != self._poly_pm.shape:
                return False
            self._poly_am, self._poly_pm = am, pm
            self._runtime_params = dict(self._runtime_params,
                                        poly_am=self._param(am),
                                        poly_pm=self._param(pm))
            return True
        scalefactor, lut = data
        lut = np.asarray(lut)
        if self._lut is None or lut.shape != self._lut.shape:
            return False
        self._lut, self._lut_scale = lut, float(scalefactor)
        self._runtime_params = dict(
            self._runtime_params, lut=self._param(lut),
            lut_scale=self._param(np.float32(scalefactor)))
        return True

    def refresh_runtime_params(self) -> bool:
        """Re-read the taps and coefficient files named in the settings
        (when a cached modulator is taken again).  Returns False if their
        contents no longer fit this modulator's shapes."""
        ok = True
        s = self.settings
        if s.filter_taps_file and self._fir_taps is not None:
            taps = (tables.DEFAULT_FIR_TAPS
                    if s.filter_taps_file == "default"
                    else load_fir_taps(s.filter_taps_file))
            ok = self.update_fir_taps(taps) and ok
        if s.poly_coef_file and (self._poly_am is not None
                                 or self._lut is not None):
            kind, data = load_dpd_file(s.poly_coef_file)
            ok = self.update_dpd(kind, data) and ok
        return ok

    # ------------------------------------------------------------------
    @property
    def tf_samples_out(self) -> int:
        """Output samples per transmission frame, at the output rate."""
        n = self.p.tf_samples
        if self._res_plan is not None:
            n = n * self._res_plan.L // self._res_plan.M
        return n

    def init_state(self):
        """Initial sequential state (a dict carried between batches): the
        time-interleaver histories and the TF index; with CFR the rotating
        MER symbol index, with a polyphase resampler its input carry
        ("res_carry", planes), with the frequency-domain one its input and
        overlap-add tails ("res_in_tail", "res_out_tail", pairs)."""
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
        plan = self._res_plan
        if self._res_route == "fft":
            state["res_in_tail"] = torch.zeros(
                (plan.fft_in // 2, 2), dtype=torch.float32, device=dev)
            state["res_out_tail"] = torch.zeros(
                (plan.fft_out // 2, 2), dtype=torch.float32, device=dev)
        elif plan is not None:
            state["res_carry"] = tuple(
                torch.zeros(2 * plan.half, dtype=torch.float32, device=dev)
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
        self._t("fec", tf_bits)

        q = ofdm.qpsk_phase_indices(tf_bits, p.nb_carriers)
        self._t("qpsk_map", q)
        phases = ofdm.diff_modulate(q, self._ref_q_pre_t)
        self._t("diff_mod", phases)
        carriers = ofdm.phases_to_carriers(phases)
        self._t("carriers", carriers)
        return carriers, tuple(new_hist)

    def frontend(self, fic_bytes, subch_bytes, ti_history):
        """The front end alone (for stage-level validation).  Returns the
        symbols in CARRIER order (the external contract) and the new
        time-interleaver history."""
        syms, new_hist = self._frontend_impl(
            self._bytes(fic_bytes), tuple(self._bytes(x) for x in subch_bytes),
            ti_history)
        return (tuple(ofdm.freq_interleave(x, self._inv_perm_t)
                      for x in syms), new_hist)

    def _ofdm_symbols_impl(self, fic_bytes, subch_bytes, ti_history,
                           tf_index):
        """The front end and the NULL symbol ahead of each TF, with TII in
        every other TF's NULL symbol and the CIC taps applied: the OFDM
        backend's input [B, S, C] (interleaver-input order) and the new
        time-interleaver history."""
        p = self.p
        B = fic_bytes.shape[0] // p.cif_count
        data_syms, new_hist = self._frontend_impl(
            fic_bytes, subch_bytes, ti_history)               # [B, 76, C]
        if self._tii_vec is not None:
            # TII in the NULL symbol of the TFs with an even index
            # (ref: src/TII.cpp:241-243)
            tf_idx = tf_index + torch.arange(B, dtype=torch.int32,
                                             device=self.device)
            insert = (tf_idx % 2 == 0).to(torch.float32)[:, None]
            null_row = tuple(v[None, :] * insert for v in self._tii_vec)
        else:
            zero = torch.zeros((B, p.nb_carriers), dtype=torch.float32,
                               device=self.device)
            null_row = (zero, zero)
        symbols = tuple(torch.cat([n[:, None], d], dim=1)
                        for n, d in zip(null_row, data_syms))
        if self._cic_taps is not None:
            symbols = tuple(x * self._cic_taps for x in symbols)
        self._t("tii_null", symbols)
        return symbols, new_hist

    def ofdm_symbols(self, fic_bytes, subch_bytes, ti_history, tf_index=0):
        """The OFDM backend's input for one batch (for stage-level
        validation): symbol planes [B, S, C] in interleaver-input order,
        NULL symbol included, and the new time-interleaver history.
        `tf_index` (the state's) decides which NULL symbols carry TII."""
        with torch.no_grad():
            return self._ofdm_symbols_impl(
                self._bytes(fic_bytes),
                tuple(self._bytes(x) for x in subch_bytes), ti_history,
                tf_index)

    def _cfr_stats(self, kstats, mer_index):
        """Batch statistics from the CFR kernel's per-symbol lanes
        (dabmod_tpu's modulator.py:571-628): clip counts and PAPR before and
        after CFR over the data symbols (the NULL symbol is excluded), and
        the in-loop MER (ETSI ETR 290 Annex C) of one rotating symbol per
        TF: TF b inspects symbol (mer_index + 1 + b) mod S, and symbol 0
        (NULL) gives no measurement (ref: src/OfdmGenerator.cpp:234-273).
        Returns (stats, the next mer_index)."""
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

    def _resample(self, iq, state, new_state):
        """The resampler on the flat stream of the batch, by the route
        fixed at construction; its carry links one batch to the next."""
        B = iq[0].shape[0]
        flat = tuple(x.reshape(-1) for x in iq)
        if self._res_route == "fft":
            # the pair-domain frequency-domain resampler
            y, new_state["res_in_tail"], new_state["res_out_tail"] = \
                resample(planes_to_pairs(flat), self._res_plan,
                         state["res_in_tail"], state["res_out_tail"])
            return tuple(y[:, k].reshape(B, -1) for k in (0, 1))
        if self._res_route == "kernel":
            y, carry = resampler_kernel.resample(flat, state["res_carry"],
                                                 self._res_table)
        else:
            y, carry = resample_poly(flat, self._res_plan,
                                     state["res_carry"], self._res_matrix)
        new_state["res_carry"] = carry
        return tuple(x.reshape(B, -1) for x in y)

    def _q14(self, symbols):
        """Carrier-order Q1.14 integer planes of the OFDM symbols: the
        deferred frequency interleave restored, then rint(x * 16384)
        (torch.round rounds half to even, as jnp.rint does)."""
        return tuple(
            torch.round(ofdm.freq_interleave(x, self._inv_perm_t)
                        * 16384.0).to(torch.int32) for x in symbols)

    def _dexter_symbols(self, symbols):
        """fft_engine=dexter: the transform belongs to the FPGA FFT
        accelerator, so the device's job ends at Q1.14 carrier symbols
        [2, B, S, C] int32; host_backend does the rest
        (src/DabModulator.cpp:214-277)."""
        out = torch.stack(self._q14(symbols))
        self._t("dexter_quantise", out)
        return out

    def _kiss_chain(self, symbols):
        """fft_engine=kiss: the whole back end in exact int16 arithmetic,
        bit-identical to the reference's KISS chain (per-stage rounding
        and all), into packed int32 wire words [B, tf_samples]."""
        p = self.p
        bins = ofdm.to_bins_slices(self._q14(symbols), p.nb_carriers,
                                   p.spacing)
        td = kiss_fixed.kiss_fft_fixed(*bins, inverse=True)
        self._t("kiss_ifft", td)
        ov = self.settings.ofdm_window_overlap
        if ov:
            iq = kiss_fixed.guard_interval_windowed_fixed(
                td, p.null_size, p.sym_size, ov)
        else:
            iq = ofdm.guard_interval_unwindowed(td, p.null_size, p.sym_size)
        self._t("guard_interval", iq)
        # (im << 16) | (re & 0xFFFF), written without a shift of a negative
        # value: im * 2**16 stays within int32 for every int16 im
        return iq[1] * 65536 + (iq[0] & 0xFFFF)

    def _modulate_impl(self, fic_bytes, subch_bytes, state,
                       constant_gain: float, var_k: float, rp: dict):
        p = self.p
        s = self.settings
        symbols, new_hist = self._ofdm_symbols_impl(
            fic_bytes, subch_bytes, state["ti_history"],
            state["tf_index"])                                # [B, S, C]
        B = symbols[0].shape[0]
        new_state = {"ti_history": new_hist,
                     "tf_index": state["tf_index"] + B}
        if self._dexter:
            return self._dexter_symbols(symbols), new_state, {}
        if self._kiss:
            return self._kiss_chain(symbols), new_state, {
                # the reference's kiss chain has no FormatConverter (and so
                # no clip counter); the stat stays for RC parity
                "num_clipped": torch.zeros((), dtype=torch.int32,
                                           device=self.device)}
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
        self._t("ofdm_ifft", td)

        gains = ofdm.compute_gain(td, s.gain_mode, var_k) * constant_gain
        self._t("gain", gains)
        if s.ofdm_window_overlap:
            iq = ofdm.guard_interval_windowed(
                td, p.null_size, p.sym_size, s.ofdm_window_overlap,
                gains=gains)                                  # planes [B, tf]
        else:
            iq = ofdm.guard_interval_unwindowed(td, p.null_size, p.sym_size,
                                                gains=gains)
        self._t("guard_interval", iq)

        if "fir_taps" in rp:
            iq = fir_filter(iq, rp["fir_taps"])
            self._t("fir", iq)

        if self._res_route is not None:
            iq = self._resample(iq, state, new_state)
            self._t("resampler", iq)

        if "poly_am" in rp:
            iq = memless_poly(iq, rp["poly_am"], rp["poly_pm"])
            self._t("dpd", iq)
        elif "lut" in rp:
            iq = memless_lut(iq, rp["lut"], rp["lut_scale"])
            self._t("dpd", iq)

        if self._wire_fmt == "s16":
            # packed int32 words, byte-identical to interleaved s16 pairs
            out, stats["num_clipped"] = pack_s16_planes(iq[0], iq[1])
            self._t("format_convert", out)
            return out, new_state, stats
        if self._wire_fmt is None and not s.device_interleave:
            return iq, new_state, stats
        out = planes_to_pairs(iq)
        if self._wire_fmt is not None:
            # u8 / s8 bytes, four to an int32 word
            out, stats["num_clipped"] = format_convert(out, self._wire_fmt)
            out = pack_bytes(out)
            self._t("format_convert", out)
        return out, new_state, stats

    def modulate(self, fic_bytes, subch_bytes, state):
        """Run one batch.  fic_bytes [T, fic_len] uint8, subch_bytes tuple of
        [T, framesize] uint8 with T a multiple of cif_count (numpy arrays or
        tensors).  Returns (output, new_state, stats):

        * f32 planes (re, im) [B, tf_samples_out] with
          device_interleave=False;
        * f32 pairs [B, tf_samples_out, 2] with device_interleave=True;
        * int32 wire words for an integer output, with stats["num_clipped"]:
          [B, tf_samples_out] for s16 (one (re, im) pair a word),
          [B, tf_samples_out / 2] for u8 and s8 (four bytes a word);
          fft_engine=kiss gives s16 words too (num_clipped 0);
        * fft_engine=dexter: Q1.14 carrier symbols [2, B, S, C] int32, for
          `host_backend`, and no stats.

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
                constant_gain, var_k, self._runtime_params)

    def modulate_eti(self, batch: EtiFrameBatch, state):
        """Convenience: modulate a parsed ETI batch."""
        return self.modulate(batch.fic, tuple(batch.subchannels), state)

    # ------------------------------------------------------------------
    def _t(self, name, value):
        """Stage tap: returns at once unless modulate_traced installed a
        collector."""
        if self._tap is not None:
            self._tap(name, value)

    # taps whose arrays live in interleaver-input order (deferred FI, see
    # __init__): restored to carrier order at dump time so the files
    # compare byte for byte with dabmod_tpu's and the reference's dumps
    _PRE_ORDER_TAPS = frozenset(
        {"qpsk_map", "diff_mod", "carriers", "tii_null"})

    def modulate_traced(self, fic_bytes, subch_bytes, state, trace_dir):
        """modulate() with every stage's output appended raw to
        `<idx>-<stage>.dat` files in `trace_dir`: the analogue of the
        reference's --enable-trace per-node dumps
        (src/Flowgraph.cpp:62-70,177-194), under dabmod_tpu's stage names
        and in its byte layout, so the two packages compare stage by stage.

        * (re, im) plane tuples are written as interleaved pairs; the
          deferred-FI stages are restored to carrier order first
          (_PRE_ORDER_TAPS); the FEC bits are written as int32, dabmod_tpu's
          bit type.
        * Files are TRUNCATED on this Modulator's first write (like the
          reference's "wb" fopen at flowgraph construction) and appended
          per batch thereafter; each tap is written as it fires.
        * The `ofdm_ifft` tap is the OFDM generator's output, after CFR
          when CFR is on.
        """
        os.makedirs(trace_dir, exist_ok=True)
        if not hasattr(self, "_trace_opened"):
            self._trace_opened = set()
        counter = [0]

        def host(x):
            a = x.cpu().numpy()
            return a.astype(np.int32) if a.dtype == np.uint8 else a

        def dump(name, v):
            idx = counter[0]
            counter[0] += 1
            v = tuple(host(x) for x in v) if isinstance(v, tuple) else host(v)
            if name in self._PRE_ORDER_TAPS:
                v = (tuple(x[..., self._inv_perm] for x in v)
                     if isinstance(v, tuple) else v[..., self._inv_perm])
            a = np.stack(v, axis=-1) if isinstance(v, tuple) else v
            path = os.path.join(trace_dir, f"{idx:02d}-{name}.dat")
            mode = "ab" if path in self._trace_opened else "wb"
            self._trace_opened.add(path)
            with open(path, mode) as f:
                f.write(np.ascontiguousarray(a).tobytes())

        self._tap = dump
        try:
            return self.modulate(fic_bytes, subch_bytes, state)
        finally:
            self._tap = None


def state_from_numpy(state_np, device) -> dict:
    """The JAX modulator's state as the port's: `state_np` holds
    "ti_history" (a tuple of [15, n] {0,1} arrays, one per sub-channel) and
    "tf_index", and with CFR "mer_index", with the polyphase resampler
    "res_carry" (a (re, im) tuple of [2*half] float32 arrays), with the
    frequency-domain one "res_in_tail" and "res_out_tail" ([n, 2] float32
    pairs), as numpy arrays (np.asarray of dabmod_tpu's state).  With the
    tables both packages build, this is all that makes them compute the
    same signal from the same point of a stream."""
    device = resolve_device(device)

    def scalar(key):
        return torch.tensor(int(np.asarray(state_np[key])),
                            dtype=torch.int32, device=device)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    state = {
        "ti_history": tuple(
            torch.as_tensor(np.asarray(h).astype(np.uint8), device=device)
            for h in state_np["ti_history"]),
        "tf_index": scalar("tf_index"),
    }
    if "mer_index" in state_np:
        state["mer_index"] = scalar("mer_index")
    if "res_carry" in state_np:
        state["res_carry"] = tuple(f32(c) for c in state_np["res_carry"])
    for key in ("res_in_tail", "res_out_tail"):
        if key in state_np:
            state[key] = f32(state_np[key])
    return state


# ---------------------------------------------------------------------------
# Modulator cache: RC parameter flips that change the modulator (tii
# enable, cfr clip, windowlen, gain mode, ...) take back a modulator built
# before instead of building its tables again.  Keyed by (layout, every
# setting Modulator.__init__ reads, the device); values passed to each
# step (digital gain, variance, FIR taps and DPD coefficient *contents*)
# are not in the key.
# ---------------------------------------------------------------------------

_MODULATOR_CACHE: "collections.OrderedDict[tuple, Modulator]" = \
    collections.OrderedDict()
_MODULATOR_CACHE_MAX = 8


def modulator_signature(layout: EnsembleLayout, s: ModSettings,
                        device=None) -> tuple:
    """Everything a Modulator depends on: dabmod_tpu's key
    (models/modulator.py:844-866, less ofdm_backend, which the port does
    not have) and the device.  Keep in sync with Modulator.__init__."""
    ntaps = 0
    if s.filter_taps_file:
        taps = (tables.DEFAULT_FIR_TAPS if s.filter_taps_file == "default"
                else load_fir_taps(s.filter_taps_file))
        ntaps = int(np.asarray(taps).size)
    dpd_sig = ()
    if s.poly_coef_file:
        kind, data = load_dpd_file(s.poly_coef_file)
        dpd_sig = ((kind, tuple(np.asarray(data[0]).shape),
                    tuple(np.asarray(data[1]).shape)) if kind == "poly"
                   else (kind, len(data[1])))
    return (layout, s.dab_mode, s.fft_precision, s.fft_engine,
            s.ofdm_window_overlap, s.gain_mode,
            s.enable_cfr, s.cfr_clip, s.cfr_error_clip,
            s.tii_enable, s.tii_comb, s.tii_pattern, s.tii_old_variant,
            s.cic_eq_clock_rate, s.output_rate, s.resampler_mode,
            s.device_format_conversion, s.device_interleave,
            s.output, s.file_output_format, s.zmq_output_format,
            ntaps, dpd_sig, str(resolve_device(device)))


def get_modulator(layout: EnsembleLayout, settings: ModSettings,
                  device=None) -> Modulator:
    """Build or reuse a Modulator (a least-recently-used cache of 8).  On a
    hit the instance is re-pointed at the live settings object (key
    equality guarantees every field it was built from matches), re-reads
    its taps and coefficient files so a change of their contents since it
    was parked is picked up, and has cache_hit set."""
    key = modulator_signature(layout, settings, device)
    m = _MODULATOR_CACHE.get(key)
    if m is not None:
        _MODULATOR_CACHE.move_to_end(key)
        m.settings = settings
        m.refresh_runtime_params()
        m.cache_hit = True
        return m
    m = Modulator(layout, settings, device)
    m.cache_hit = False
    _MODULATOR_CACHE[key] = m
    while len(_MODULATOR_CACHE) > _MODULATOR_CACHE_MAX:
        _MODULATOR_CACHE.popitem(last=False)
    return m


def clear_modulator_cache():
    _MODULATOR_CACHE.clear()


def make_default_layout(mode: int = 1,
                        subch_specs=((0, 24, 0x22),)) -> EnsembleLayout:
    params = tuple(tables.SubchannelParams(sad, stl * 8, tpl)
                   for sad, stl, tpl in subch_specs)
    mid = {1: 1, 2: 2, 3: 3, 4: 0}[mode]
    return EnsembleLayout(mid, len(params), 128 if mid == 3 else 96,
                          params, tuple(range(len(params))))


# ---------------------------------------------------------------------------
# Coefficient files (copies of dabmod_tpu/models/modulator.py:905-946)
# ---------------------------------------------------------------------------


def load_fir_taps(path: str) -> np.ndarray:
    """Taps file format: first line count, then one float per line
    (ref: src/FIRFilter.cpp:95-134)."""
    with open(path) as f:
        toks = f.read().split()
    n = int(toks[0])
    taps = np.array([float(t) for t in toks[1:1 + n]], dtype=np.float32)
    if taps.size != n:
        raise ValueError(f"taps file {path}: expected {n} taps, got {taps.size}")
    return taps


def load_poly_coefs(path: str):
    """Poly DPD coefficient file (format indicator 1)."""
    kind, data = load_dpd_file(path)
    if kind != "poly":
        raise ValueError("expected a poly coefficient file (format 1)")
    return data


def load_dpd_file(path: str):
    """DPD coefficient file: format 1 = odd poly with 2x5 coefs, format 2 =
    32-entry complex LUT with scale factor
    (ref: src/MemlessPoly.cpp:110-232)."""
    with open(path) as f:
        toks = f.read().split()
    kind = int(toks[0])
    if kind == 1:
        n = int(toks[1])
        if n != 5:
            raise ValueError("expected 5 AM and 5 PM coefficients")
        vals = [float(t) for t in toks[2:2 + 10]]
        return "poly", (np.array(vals[:5], np.float32),
                        np.array(vals[5:], np.float32))
    if kind == 2:
        scalefactor = float(toks[1])
        vals = [float(t) for t in toks[2:2 + 64]]
        if len(vals) != 64:
            raise ValueError("expected 32 complex LUT entries")
        lut = np.array(vals, np.float32).reshape(32, 2)
        return "lut", (scalefactor, lut)
    raise ValueError(f"unknown DPD coefficient file format {kind}")
