"""Streaming runtime: the supervisor loop around the modulator (the port of
dabmod_tpu/runtime.py).

Mirror of the reference's launch_modulator / run_modulator state machine
(src/DabMod.cpp:365-738): FP-0 alignment before starting, FCT continuity
check with restart-keeping-input, ensemble reconfiguration detection with
pipeline rebuild, and per-batch timestamp tracking.  The reference runs one
24 ms ETI frame at a time; this runtime accumulates `batch_tf`
transmission frames and runs them as one device step.

The steady-state loop is a pipeline of three threads and the card:

  [main thread]   read + parse batch N+1 | stage its ETI bytes in pinned
                  host memory and copy them to the card (non_blocking) |
                  launch modulate N+1 | enqueue the copy of its output (and
                  stats) into pinned host memory (non_blocking) and record a
                  CUDA event after it
  [card]          copy in, compute and copy out batch N, in stream order
  [fetch thread]  wait on batch N-1's event, then read its host arrays
                  (and run the dexter host chain on them)
  [writer thread] write batch N-2 to the sink

so no thread but the main one touches the card: the fetch thread waits on
an event and reads host memory only, and an RC change that needs a new
modulator is built on the main thread.  On the CPU the same code runs with
plain tensors and no event.  This is the analogue of the reference's
PipelinedModCodec worker threads (src/ModPlugin.cpp:76-154).
"""
from __future__ import annotations

import collections
import enum
import json
import logging
import os
import queue as queue_mod
import threading
import time

import numpy as np
import torch

from . import tables
from .config import GAIN_MODES, ModSettings
from .eti import EnsembleReconfigured, EtiError, parse_eti_frames
from .io.fic_decoder import FICDecoder
from .io.outputs import F32_FORMATS, open_output
from .io.readers import open_input
from .models import (Modulator, get_modulator, load_dpd_file, load_fir_taps,
                     resolve_device)
from .rc import ParameterError, RemoteControllable, rcs
from .timestamps import TimestampDecoder

log = logging.getLogger("dabmod_tpu_torch")


class RunResult(enum.Enum):
    FAILURE = 0
    NORMAL_END = 1
    AGAIN = 2
    RECONFIGURE = 3


# RC controller fault poll cadence in ETI frames (ref: src/DabMod.cpp:721-723
# polls every 250 frames unconditionally)
RC_FAULT_POLL_FRAMES = 250


class ModRuntime:
    """The runtime for one settings object on one device (`None`: the CUDA
    card; without one this raises, as the modulator does)."""

    def __init__(self, settings: ModSettings, device=None):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.settings = settings
        # f32 file sinks take the planes contract: the device skips the
        # interleave and the fetch thread assembles the pairs
        # (ModSettings.device_interleave)
        if (settings.output == "file"
                and settings.file_output_format in F32_FORMATS):
            settings.device_interleave = False
        self.reader = open_input(settings)
        try:
            self.output = open_output(settings)
        except BaseException:
            self.reader.close()
            raise
        self.ts_decoder = TimestampDecoder(settings.tist_offset)
        self._stop = threading.Event()
        # delaymanagement management=dynamic: the offset lives in a file
        # that operators rewrite at runtime; re-read on mtime change
        # (the reference's old-syntax offset management, warned about at
        # src/ConfigParser.cpp:456-459, which this build keeps functional)
        self._dyn_offset_mtime: float | None = None
        self.modulator: Modulator | None = None
        self.state = None
        self.num_restarts = 0
        self.framecount = 0
        self._pending = np.empty((0, 6144), np.uint8)
        self._last_fct = -1
        self._aligned = False
        self._rebuild = False
        self._t0 = None
        self._frames_timed = 0
        self.last_stats = {}
        self._next_fault_poll = RC_FAULT_POLL_FRAMES
        self._frames_since_clip_poll = RC_FAULT_POLL_FRAMES
        self._frames_since_stats_poll = RC_FAULT_POLL_FRAMES
        # seconds spent in each part of the pipeline, summed over the run:
        # on the main thread, staging the ETI bytes in and launching their
        # copy, modulate's host time, taking pinned buffers for the output
        # and launching the copy out; on the fetch thread, the wait for the
        # card and the host work after it (the planes' interleave, the
        # dexter chain); on the writer thread, the sink writes
        self.timings = dict.fromkeys(
            ("stage_in_s", "modulate_s", "pin_alloc_s", "copy_out_s",
             "fetch_wait_s", "fetch_s", "write_s"), 0.0)
        # dispatch -> [fetch thread: wait for the card, host arrays] ->
        # [writer thread: output.write]; depth 4 keeps enough batches in
        # flight to overlap the fetch of one with the write of another
        self._out_queue: queue_mod.Queue = queue_mod.Queue(maxsize=4)
        self._write_queue: queue_mod.Queue = queue_mod.Queue(maxsize=4)
        self._writer_fault: BaseException | None = None
        self._fetcher = threading.Thread(target=self._fetch_loop,
                                         daemon=True, name="output-fetch")
        self._fetcher.start()
        self._writer = threading.Thread(target=self._writer_loop,
                                        daemon=True, name="output-writer")
        self._writer.start()
        self._clip_ratios = collections.deque(maxlen=256)
        self._errclip_ratios = collections.deque(maxlen=256)
        self._mers = collections.deque(maxlen=256)
        self._enrol_rc()
        if settings.rc_telnet_port:
            rcs.add_telnet(settings.rc_telnet_port)
        if settings.rc_zmq_endpoint:
            rcs.add_zmq(settings.rc_zmq_endpoint)
        if settings.events_endpoint:
            from .events import EventLogHandler, events
            events.bind(settings.events_endpoint)
            log.addHandler(EventLogHandler())
        # LogTracer-style breadcrumb file (ref: lib/Log.h:103-117)
        self._trace = open(settings.log_trace_file, "a") \
            if settings.log_trace_file else None

    # ------------------------------------------------------------------
    # Remote control surface (ref: the RC_ADD_PARAMETER registrations in
    # GainControl/OfdmGenerator/GuardIntervalInserter/TII/FIRFilter/
    # MemlessPoly/DabModulator/TimestampDecoder)
    def _enrol_rc(self):
        s = self.settings

        def setter(attr, conv=float, rebuild=False):
            def f(value):
                setattr(s, attr, conv(value))
                if rebuild:
                    self._rebuild = True
            return f

        def boolconv(v):
            return v.strip() not in ("0", "false", "False", "")

        gain = RemoteControllable("gain")
        gain.add_parameter("digital", "Digital Gain",
                           lambda: s.digital_gain, setter("digital_gain"))

        def set_gainmode(v):
            if v.lower() not in GAIN_MODES:
                raise ParameterError(f"invalid gainmode {v}")
            s.gain_mode = GAIN_MODES[v.lower()]
            self._rebuild = True
        gain.add_parameter("mode", "Gainmode (fix|max|var)",
                           lambda: ("fix", "max", "var")[s.gain_mode],
                           set_gainmode)
        gain.add_parameter("var", "Variance setting for gainmode var "
                           "(default: 4)", lambda: s.gain_mode_variance,
                           setter("gain_mode_variance"))
        rcs.enrol(gain)

        ofdm_rc = RemoteControllable("ofdm")

        def cfr_setter(attr, conv=float):
            inner = setter(attr, conv, rebuild=True)

            def f(value):
                inner(value)
                # clear the PAPR/MER accumulators on CFR changes
                # (ref: src/OfdmGenerator.cpp:383-394 myPaprClearRequest)
                self._clip_ratios.clear()
                self._errclip_ratios.clear()
                self._mers.clear()
            return f

        ofdm_rc.add_parameter("cfr", "Enable crest factor reduction",
                              lambda: int(s.enable_cfr),
                              cfr_setter("enable_cfr", boolconv))
        ofdm_rc.add_parameter("clip", "CFR: Clip to amplitude",
                              lambda: s.cfr_clip,
                              cfr_setter("cfr_clip"))
        ofdm_rc.add_parameter("errorclip", "CFR: Limit error",
                              lambda: s.cfr_error_clip,
                              cfr_setter("cfr_error_clip"))
        ofdm_rc.add_parameter(
            "clip_stats", "CFR: statistics (clip ratio, errorclip ratio)",
            self._clip_stats)
        ofdm_rc.add_parameter("papr", "PAPR measurements (before CFR, "
                              "after CFR)", self._papr_stats)
        rcs.enrol(ofdm_rc)

        guard = RemoteControllable("guardinterval")
        guard.add_parameter("windowlen", "Window length for OFDM windowng "
                            "[0 to disable]", lambda: s.ofdm_window_overlap,
                            setter("ofdm_window_overlap", int, rebuild=True))
        rcs.enrol(guard)

        tii = RemoteControllable("tii")
        tii.add_parameter("enable", "enable TII [0-1]",
                          lambda: int(s.tii_enable),
                          setter("tii_enable", boolconv, rebuild=True))
        tii.add_parameter("comb", "TII comb number [0-23]",
                          lambda: s.tii_comb,
                          setter("tii_comb", int, rebuild=True))
        tii.add_parameter("pattern", "TII pattern number [0-69]",
                          lambda: s.tii_pattern,
                          setter("tii_pattern", int, rebuild=True))
        tii.add_parameter("old_variant", "select old TII variant for old "
                          "(buggy) receivers [0-1]",
                          lambda: int(s.tii_old_variant),
                          setter("tii_old_variant", boolconv, rebuild=True))
        rcs.enrol(tii)

        if s.filter_taps_file:
            fir = RemoteControllable("firfilter")
            fir.add_parameter(
                "ntaps", "(Read-only) number of filter taps.",
                lambda: (self.modulator._fir_taps.shape[0]
                         if self.modulator is not None
                         and self.modulator._fir_taps is not None else 0))

            def set_tapsfile(v):
                # same tap count: swap the tensor the step takes (the
                # reference's mutex swap, FIRFilter.cpp:316-324); another
                # count: a new modulator, like the reference's
                # PipelinedModCodec restart
                s.filter_taps_file = str(v)
                taps = (tables.DEFAULT_FIR_TAPS if v == "default"
                        else load_fir_taps(str(v)))
                if not (self.modulator is not None
                        and self.modulator.update_fir_taps(taps)):
                    self._rebuild = True
                else:
                    log.info("FIR taps hot-swapped (%d taps, no rebuild)",
                             len(taps))
            fir.add_parameter(
                "tapsfile", "Filename containing filter taps. When written "
                "to, the new file gets automatically loaded.",
                lambda: s.filter_taps_file, set_tapsfile)
            rcs.enrol(fir)

        if s.poly_coef_file:
            def set_coeffile(v):
                # same kind + shape: swap the coefficient tensors the step
                # takes (the reference's mutex swap,
                # src/MemlessPoly.cpp:192-231)
                s.poly_coef_file = str(v)
                kind, data = load_dpd_file(str(v))
                if not (self.modulator is not None
                        and self.modulator.update_dpd(kind, data)):
                    self._rebuild = True
                else:
                    log.info("DPD %s coefficients hot-swapped "
                             "(no rebuild)", kind)
            poly = RemoteControllable("poly")
            poly.add_parameter("coeffile", "Filename containing poly "
                               "coefficients; reloaded when written to.",
                               lambda: s.poly_coef_file, set_coeffile)
            rcs.enrol(poly)

        mod = RemoteControllable("modulator")
        mod.add_parameter("rate", "(Read-only) IQ output samplerate",
                          lambda: s.output_rate)
        mod.add_parameter("num_clipped_samples", "(Read-only) Number of "
                          "samples clipped in last frame during format "
                          "conversion", lambda: getattr(
                              self.output, "num_clipped_samples", 0))
        mod.add_parameter("fct", "(Read-only) most recent ETI frame "
                          "characterisation count",
                          lambda: max(self._last_fct, 0))
        mod.add_parameter("frames", "(Read-only) ETI frames modulated",
                          lambda: self.framecount)
        mod.add_parameter("num_restarts", "(Read-only) modulator restart "
                          "counter", lambda: self.num_restarts)
        rcs.enrol(mod)

        self.fic_decoder = FICDecoder()
        ens = RemoteControllable("ensemble")
        ens.add_parameter(
            "info", "(Read-only) decoded ensemble/services information",
            lambda: json.dumps(self.fic_decoder.ensemble.to_json()))
        rcs.enrol(ens)

        tist = RemoteControllable("tist")
        tist.add_parameter("offset", "TIST offset [s]",
                           lambda: self.ts_decoder.offset_s,
                           lambda v: setattr(self.ts_decoder, "offset_s",
                                             float(v)))
        tist.add_parameter("timestamp", "FCT and timestamp [s]",
                           lambda: str(self.ts_decoder.timestamp().fct)
                           + " " + str(self.ts_decoder.timestamp()
                                       .as_seconds()))
        rcs.enrol(tist)

    # ------------------------------------------------------------------
    # Moving the ETI bytes in and the output out
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """ETI payload bytes [T, n] uint8 onto the modulator's device.  On
        the card: copied once into pinned host memory and from there by a
        non_blocking copy on the current stream, so the main thread does
        not wait for the card to drain the previous batch (a pageable
        copy would).  PyTorch's caching host allocator hands the pinned
        block out again only after that copy has run on the card."""
        if not self._cuda:
            return torch.from_numpy(np.ascontiguousarray(arr))
        pinned = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
        pinned.numpy()[...] = arr
        return pinned.to(self.device, non_blocking=True)

    def _download(self, x: torch.Tensor) -> torch.Tensor:
        """A non_blocking copy of a device tensor into pinned host memory,
        readable once the event recorded after it has completed; on the
        CPU the tensor itself."""
        if not self._cuda:
            return x
        t0 = time.perf_counter()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.timings["pin_alloc_s"] += time.perf_counter() - t0
        host.copy_(x, non_blocking=True)
        return host

    # ------------------------------------------------------------------
    # Output threads: the wait for the card, the host back end and the
    # sink write happen here, never on the dispatch path.
    def _fetch_loop(self):
        """Stage 1: wait for a batch's copy off the card, hand host arrays
        on.  Touches no CUDA tensor: it waits on the batch's event and
        reads the pinned host copies."""
        while True:
            item = self._out_queue.get()
            if item is None or isinstance(item, threading.Event):
                self._write_queue.put(item)          # forward sentinel
                if item is None:
                    return
                continue
            iq, stats, ready, hb, meta, T, n_cells = item
            if self._writer_fault is not None:
                continue                             # drain after a fault
            try:
                t0 = time.perf_counter()
                if ready is not None:
                    ready.synchronize()
                t1 = time.perf_counter()
                self.timings["fetch_wait_s"] += t1 - t0
                stats = {k: v.numpy() for k, v in stats.items()}
                if stats:
                    # CFR/MER statistics, folded into the RC accumulators
                    # at the RC poll cadence (as dabmod_tpu samples them)
                    self.last_stats = stats
                    self._frames_since_stats_poll += T
                    if (self._frames_since_stats_poll
                            >= RC_FAULT_POLL_FRAMES):
                        self._frames_since_stats_poll = 0
                        self._note_stats(stats, n_cells)
                if isinstance(iq, tuple):
                    # planes contract: interleave here, at the same host
                    # boundary where the reference's FormatConverter
                    # assembles wire bytes
                    re = iq[0].numpy().reshape(len(meta), -1)
                    im = iq[1].numpy().reshape(len(meta), -1)
                    arr = np.empty((*re.shape, 2), np.float32)
                    arr[..., 0] = re
                    arr[..., 1] = im
                else:
                    arr = iq.numpy()
                    if hb is not None:
                        # fft_engine=dexter: the FFT-accelerator chain
                        # (transform + wide GI + s16) on the fetched Q1.14
                        # symbols (io/dexter_fft.py)
                        arr = hb(arr)
                        self.output.num_clipped_samples = hb.num_clipped
                self.timings["fetch_s"] += time.perf_counter() - t1
                # `iq` rides along: the pinned host memory `arr` may view
                # stays referenced until the writer has written it
                self._write_queue.put((arr, meta, T, iq))
                if "num_clipped" in stats:
                    # the device's FormatConverter clip counter, sampled at
                    # the RC poll cadence (as dabmod_tpu samples it)
                    self._frames_since_clip_poll += T
                    if self._frames_since_clip_poll >= RC_FAULT_POLL_FRAMES:
                        self._frames_since_clip_poll = 0
                        self.output.num_clipped_samples = int(
                            stats["num_clipped"])
            except BaseException as e:               # noqa: BLE001
                log.error("output fetch failed: %s", e)
                self._writer_fault = e

    def _writer_loop(self):
        """Stage 2: push fetched host arrays into the sink."""
        while True:
            item = self._write_queue.get()
            if item is None:
                return
            if isinstance(item, threading.Event):   # flush barrier
                item.set()
                continue
            arr, meta, T, _keep = item
            if self._writer_fault is not None:
                continue
            try:
                t0 = time.perf_counter()
                self.output.write(arr, meta)
                self.timings["write_s"] += time.perf_counter() - t0
                self._tracepoint("output,write %d" % T)
            except BaseException as e:               # noqa: BLE001
                log.error("output writer failed: %s", e)
                self._writer_fault = e

    def _flush_output(self):
        """Barrier: wait until every dispatched batch has been written."""
        ev = threading.Event()
        self._out_queue.put(ev)
        ev.wait()
        if self._writer_fault is not None:
            e, self._writer_fault = self._writer_fault, None
            raise e

    def close(self):
        self._flush_output()
        self._out_queue.put(None)
        self._fetcher.join(timeout=5)
        self._writer.join(timeout=5)
        self.reader.close()
        self.output.close()
        if self._trace is not None:
            self._trace.close()

    def _note_stats(self, stats, n):
        """Fold one batch's stats (host arrays) into the bounded RC
        accumulators (the reference's myClipRatios/myErrorClipRatios/myMERs
        deques, src/OfdmGenerator.cpp:277-300).  `n` is the batch's OFDM
        cell count (samples before GI insertion), the clip-ratio
        denominator."""
        if "cfr_clip" in stats:
            self._clip_ratios.append(float(stats["cfr_clip"].sum()) / n)
            self._errclip_ratios.append(
                float(stats["cfr_errclip"].sum()) / n)
        if "mer_db" in stats:
            self._mers.extend(
                stats["mer_db"][stats["mer_valid"]].tolist())

    def _clip_stats(self):
        if not self._clip_ratios or not self._mers:
            return "No stats available"
        clip = float(np.mean(self._clip_ratios))
        err = float(np.mean(self._errclip_ratios))
        mer = float(np.mean(self._mers))
        # format per src/OfdmGenerator.cpp:437-441
        return (f"Statistics : {clip * 100:.6f}% samples clipped, "
                f"{err * 100:.6f}% errors clipped. "
                f"MER after CFR: {mer:.6f} dB")

    def _papr_stats(self):
        st = self.last_stats
        before = (f"{float(st['papr_before_cfr'].mean()):.6f}"
                  if "papr_before_cfr" in st else "N/A")
        after = (f"{float(st['papr_after_cfr'].mean()):.6f}"
                 if "papr_after_cfr" in st else "N/A")
        return f"PAPR [dB]: {before}, {after}"

    # ------------------------------------------------------------------
    def _ensure_modulator(self, layout):
        if self._rebuild and self.modulator is not None:
            old_state = self.state
            old_layout = self.modulator.layout
            try:
                self.modulator = get_modulator(layout, self.settings,
                                               self.device)
            except Exception as e:      # noqa: BLE001
                # a bad RC-supplied setting (e.g. malformed coef file) must
                # not take down the transmitter; keep the previous pipeline
                # (the reference invalidates the settings and carries on,
                # src/MemlessPoly.cpp:226-231)
                log.error("pipeline rebuild failed, keeping previous "
                          "configuration: %s", e)
                self._rebuild = False
                return
            log.info("RC parameter change; pipeline %s",
                     "reused from the modulator cache"
                     if getattr(self.modulator, "cache_hit", False)
                     else "rebuilt")
            new_state = self.modulator.init_state()
            if old_layout == layout and old_state is not None:
                # keep the time-interleaver history across the rebuild
                new_state["ti_history"] = old_state["ti_history"]
                new_state["tf_index"] = old_state["tf_index"]
            self.state = new_state
            self._rebuild = False
            return
        if self.modulator is None or self.modulator.layout != layout:
            if self.modulator is not None:
                log.warning("ensemble layout changed; rebuilding pipeline")
            self.modulator = get_modulator(layout, self.settings,
                                           self.device)
            self.state = self.modulator.init_state()
            self._rebuild = False

    def stop(self):
        """Ask the run loop to end after the current batch (the reference's
        SIGINT handler plays this role, src/DabMod.cpp:87-97)."""
        self._stop.set()

    def _poll_dynamic_offset(self):
        """Re-read the delaymanagement dynamic offset file when it changes
        (management=dynamic), without a restart."""
        path = self.settings.tist_dynamic_offset_file
        if not path:
            return
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return
        if mtime == self._dyn_offset_mtime:
            return
        self._dyn_offset_mtime = mtime
        try:
            with open(path) as f:
                offset = float(f.read().split()[0])
        except (OSError, ValueError, IndexError) as e:
            log.warning("dynamic offset file %s unreadable: %s", path, e)
            return
        if offset != self.ts_decoder.offset_s:
            log.info("delaymanagement: dynamic offset now %f s", offset)
            self.ts_decoder.offset_s = offset

    def _drop_until_fp0(self):
        """Do not start the pipeline before frame phase 0, so all blocks are
        properly aligned (ref: src/DabMod.cpp:683-692).  Operates on raw
        pending frames via the FC header byte."""
        if self._aligned or self._pending.shape[0] == 0:
            return
        fp = (self._pending[:, 6] >> 5) & 0x7
        zeros = np.nonzero(fp == 0)[0]
        if zeros.size == 0:
            self._pending = self._pending[:0]
            return
        self._pending = self._pending[int(zeros[0]):]
        self._aligned = True

    def _check_continuity(self, batch):
        """FCT continuity over the batch (ref: src/DabMod.cpp:694-707)."""
        fct = batch.fct.astype(np.int64)
        first = fct[0] if self._last_fct < 0 else (self._last_fct + 1) % 250
        expected = (first + np.arange(len(fct))) % 250
        ok = fct == expected
        if not np.all(ok):
            bad = int(np.nonzero(~ok)[0][0])
            raise FctDiscontinuity(
                f"ETI FCT discontinuity, expected {expected[bad]} "
                f"received {fct[bad]}", bad)
        self._last_fct = int(fct[-1])

    def run_batches(self, max_batches: int | None = None) -> RunResult:
        """Run up to max_batches through the pipelined loop, then drain the
        output writer so callers observe a fully-written sink."""
        result = self._run_batches_inner(max_batches)
        try:
            self._flush_output()
        except BaseException as e:       # noqa: BLE001
            log.error("output write failed: %s", e)
            return RunResult.FAILURE
        return result

    def _run_batches_inner(self, max_batches: int | None = None) -> RunResult:
        s = self.settings
        batches_done = 0
        while max_batches is None or batches_done < max_batches:
            if self._stop.is_set():
                return RunResult.NORMAL_END
            self._poll_dynamic_offset()
            # peek at layout with one frame if we have none pending
            need_probe = self._pending.shape[0] == 0
            probe = self.reader.read_batch(4 if need_probe else 0)
            if probe.size:
                self._pending = np.concatenate([self._pending, probe])
            self._drop_until_fp0()
            if self._pending.shape[0] == 0:
                if probe.size == 0:
                    return RunResult.NORMAL_END
                continue
            try:
                head = parse_eti_frames(self._pending[:1])
            except EtiError as e:
                log.error("ETI parse error: %s", e)
                return RunResult.FAILURE
            layout = head.layout
            self._ensure_modulator(layout)
            C = self.modulator.p.cif_count
            need = s.batch_tf * C

            while self._pending.shape[0] < need:
                more = self.reader.read_batch(need - self._pending.shape[0])
                if more.size == 0:
                    break
                self._pending = np.concatenate([self._pending, more])

            T = (self._pending.shape[0] // C) * C
            if T == 0:
                return RunResult.NORMAL_END
            raw, self._pending = self._pending[:T], self._pending[T:]

            try:
                batch = parse_eti_frames(raw)
            except EnsembleReconfigured:
                # replay frame-by-frame on next run with a fresh pipeline
                self._pending = np.concatenate([raw, self._pending])
                self.modulator = None
                return RunResult.RECONFIGURE

            try:
                self._check_continuity(batch)
            except FctDiscontinuity as e:
                log.warning("%s", e.args[0])
                # requeue the frames from the discontinuity on; the restart
                # realigns to FP 0 there (the reference restarts its whole
                # flowgraph at this point, src/DabMod.cpp:694-707)
                self._pending = np.concatenate(
                    [raw[e.args[1]:], self._pending])
                self._aligned = False
                self._last_fct = -1
                return RunResult.AGAIN

            # one timestamp per *transmission frame* (its earliest ETI
            # frame's), from the MNSC decode
            # (ref: src/output/SDR.cpp:135-201)
            tf_ts = self.ts_decoder.update_eti_batch(
                batch.fp, batch.mnsc, batch.tist_pps, batch.fct, C)

            # feed the FIC decoder for ensemble info (RC `ensemble info`)
            self.fic_decoder.process(batch.fic[0].tobytes())

            self._tracepoint("modulate,dispatch %d" % T)
            t0 = time.perf_counter()
            fic = self._upload(batch.fic)
            subs = tuple(self._upload(x) for x in batch.subchannels)
            t1 = time.perf_counter()
            if self.settings.trace_dir:
                # per-stage .dat dumps (the reference's --enable-trace
                # node files): synchronises on every stage -- debug only
                iq, self.state, stats = self.modulator.modulate_traced(
                    fic, subs, self.state, self.settings.trace_dir)
            else:
                iq, self.state, stats = self.modulator.modulate(
                    fic, subs, self.state)
            t2 = time.perf_counter()
            iq = (tuple(self._download(x) for x in iq)
                  if isinstance(iq, tuple) else self._download(iq))
            stats = {k: self._download(v) for k, v in stats.items()}
            ready = None
            if self._cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            self.timings["stage_in_s"] += t1 - t0
            self.timings["modulate_s"] += t2 - t1
            # pin_alloc_s was counted inside this span, by _download
            self.timings["copy_out_s"] += time.perf_counter() - t2
            meta = [(int(batch.fct[i * C]), tf_ts[i])
                    for i in range(len(tf_ts))]
            p = self.modulator.p
            n_cells = (T // C) * p.spacing * (p.nb_symbols + 1)
            self._out_queue.put((iq, stats, ready,
                                 self.modulator.host_backend, meta, T,
                                 n_cells))
            self.framecount += T
            if self._t0 is None:
                self._t0 = time.perf_counter()
            self._frames_timed += T
            batches_done += 1
            if self.framecount >= self._next_fault_poll:
                rcs.check_faults()
                self._next_fault_poll = self.framecount + RC_FAULT_POLL_FRAMES
            if self._writer_fault is not None:
                return RunResult.FAILURE
        return RunResult.NORMAL_END

    def _tracepoint(self, msg: str):
        if self._trace is not None:
            self._trace.write("%d,%s\n" % (time.monotonic_ns() // 1000, msg))

    def process_rate(self):
        """(ETI frames, seconds) from the end of the first dispatch to now,
        or None before it; an ETI frame is 24 ms of signal."""
        if self._t0 is None or self._frames_timed <= 0:
            return None
        return self._frames_timed, time.perf_counter() - self._t0

    def log_process_time(self):
        """Throughput summary, the fused-pipeline analogue of the per-node
        timing table (ref: src/Flowgraph.cpp:248-267)."""
        rate = self.process_rate()
        if rate is None or rate[1] <= 0:
            return
        frames, dt = rate
        frames_s = frames / dt
        log.info("processed %d ETI frames in %.2f s: %.1f frames/s "
                 "(%.1fx real-time)", frames, dt, frames_s,
                 frames_s * 0.024)

    # ------------------------------------------------------------------
    def run(self, max_batches: int | None = None) -> int:
        """Supervisor: restart on AGAIN/RECONFIGURE like the reference's
        while(run_again) loop (src/DabMod.cpp:517-587)."""
        stalled = 0
        last_framecount = -1
        while True:
            result = self.run_batches(max_batches)
            if result == RunResult.NORMAL_END:
                return 0
            if result == RunResult.FAILURE:
                return 1
            self.num_restarts += 1
            # a restart discards pipeline state, like the reference tearing
            # down and rebuilding its flowgraph (src/DabMod.cpp:520-536)
            if self.modulator is not None:
                self.state = self.modulator.init_state()
            stalled = stalled + 1 if self.framecount == last_framecount else 0
            last_framecount = self.framecount
            if stalled > 100:
                log.error("restart loop making no progress; giving up")
                return 1
            log.info("restarting modulator (%s, restart #%d)",
                     result.name, self.num_restarts)


class FctDiscontinuity(EtiError):
    """args = (message, index_of_first_bad_frame_in_batch)."""
