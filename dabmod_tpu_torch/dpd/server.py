"""DPDCE control service: the reference's dpdce daemon surface.

The reference's python/dpdce.py runs as a long-lived service whose GUI
drives it over yamlrpc UDP with the methods trigger_run / reset / adapt /
restore_dump / get_results / calibrate (python/dpdce.py:411-440).  This
module provides the same method surface over the wire-compatible
dabmod_tpu_torch.rc.yamlrpc transport, wrapping this framework's
measurement and model components.

`measure` and `adapt` are injectable so tests (and the in-process GUI) can
drive the full command surface without a live SDR feedback port.

The port's copy of dabmod_tpu/dpd/server.py; its default coefficient file
and dump directory lie in tempfile.gettempdir() (TMPDIR), not in /tmp.
"""
from __future__ import annotations

import logging
import os
import queue
import tempfile
import threading
import time

import numpy as np

from ..rc.yamlrpc import Socket
from . import Adapt, ExtractStatistic, Measure, Poly
from .dpdce import DEFAULT_COEF_PATH, adapt_iteration, normalise_burst
from .heuristics import get_learning_rate
from .model_lut import Lut

log = logging.getLogger("dabmod_tpu_torch.dpdce")


class DpdceServer:
    """yamlrpc-driven adaptation engine (ref: python/dpdce.py:135,400-440).

    States mirror the reference's engine: Idle -> Measure -> Adapt ->
    Idle, with every result published through get_results."""

    def __init__(self, control_port: int, rc_endpoint: str = "",
                 feedback_host: str = "127.0.0.1", feedback_port: int = 0,
                 samples_per_burst: int = 40960, model_kind: str = "poly",
                 coef_path: str = DEFAULT_COEF_PATH,
                 dump_dir: str = tempfile.gettempdir(), measure=None,
                 adapt=None):
        self.sock = Socket(bind_port=control_port, timeout=0.3)
        self.port = self.sock.port
        self.measure = measure or Measure(feedback_host, feedback_port,
                                          samples_per_burst)
        self.adapt = adapt or Adapt(rc_endpoint, coef_path)
        self.model_kind = model_kind
        self.dump_dir = dump_dir
        self._new_model()
        self.iteration = 0
        self._seq = 0
        self.results = {"state": "Idle", "summary": ["Idle"],
                        "statistic": "", "model": model_kind, "seq": 0}
        self._cmds: queue.Queue = queue.Queue()
        self._running = True
        self._worker = threading.Thread(target=self._work_loop, daemon=True,
                                        name="dpdce-worker")
        self._server = threading.Thread(target=self._serve_loop, daemon=True,
                                        name="dpdce-rpc")
        self._worker.start()
        self._server.start()

    def _new_model(self):
        self.model = (Lut(learning_rate=1.0) if self.model_kind == "lut"
                      else Poly(learning_rate_am=0.4, learning_rate_pm=0.4))

    # ------------------------------------------------------------ rpc loop
    def _serve_loop(self):
        while self._running:
            try:
                addr, msg_id, method, params = self.sock.receive_request()
            except TimeoutError:
                continue
            except (ValueError, OSError) as e:
                log.warning("yamlrpc receive error: %s", e)
                continue
            # command dispatch mirrors python/dpdce.py:424-440
            if method in ("trigger_run", "reset", "adapt", "restore_dump",
                          "calibrate"):
                self._cmds.put((method, params))
                self.sock.send_success_response(addr, msg_id, None)
            elif method == "get_results":
                self.sock.send_success_response(addr, msg_id,
                                                dict(self.results))
            else:
                self.sock.send_error_response(addr, msg_id,
                                              "request not understood")

    # --------------------------------------------------------- worker side
    def _work_loop(self):
        while self._running:
            try:
                method, params = self._cmds.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                if method == "trigger_run":
                    self._run_iteration()
                elif method == "reset":
                    self._reset()
                elif method == "adapt":
                    self.adapt.set_predistorter(self.model.get_dpd_data())
                    self._publish("Idle", "Pushed current model")
                elif method == "restore_dump":
                    self._restore_dump(params)
                elif method == "calibrate":
                    self._calibrate()
            except Exception as e:      # noqa: BLE001 -- status, not crash
                log.error("dpdce %s failed: %s", method, e)
                self._publish("Idle", f"{method} failed: {e}")

    def _publish(self, state: str, message: str, **extra):
        # bound each entry: the whole results dict must fit one yamlrpc
        # datagram (rc/yamlrpc.UDP_PACKETSIZE) or the client truncates
        message = message[:120]
        summary = list(self.results.get("summary", []))[-9:] + [message]
        self._seq += 1
        self.results = {**self.results, "state": state, "summary": summary,
                        "seq": self._seq, **extra}

    def _measure_burst(self):
        tx, _tx_ts, rx, _rx_ts = self.measure.get_samples()
        return normalise_burst(tx, rx)

    def _run_iteration(self):
        self._publish("Measure", f"iteration {self.iteration}: measuring")
        txn, rxn = self._measure_burst()
        self._dump(txn, rxn)
        lr = get_learning_rate(self.iteration)
        result = adapt_iteration(self.model, self.model_kind, lr, txn, rxn)
        if result["state"] == "too_few_bins":
            self._publish("Idle",
                          f"too few amplitude bins ({result['bins']})")
            return
        result.pop("state")
        self._publish("Adapt", f"iteration {self.iteration}: adapting")
        self.adapt.set_predistorter(self.model.get_dpd_data())
        self.iteration += 1
        self._publish("Idle",
                      f"iteration {self.iteration - 1}: residual "
                      f"{result['residual']:.3e}",
                      iteration=self.iteration - 1, **result)

    def _reset(self):
        """Back to the identity predistorter (ref: python/dpdce.py:424-427
        'reset' branch resets statistics and model)."""
        self._new_model()
        self.iteration = 0
        self.adapt.set_predistorter(self.model.get_dpd_data())
        self._publish("Idle", "Reset to identity model", residual=None,
                      iteration=0)

    def _dump_path(self, dump_id: str) -> str:
        # dump ids are millisecond timestamps; reject anything else so a
        # crafted restore_dump request cannot traverse out of dump_dir
        # (the control socket is unauthenticated localhost UDP)
        if not str(dump_id).isdigit():
            raise ValueError(f"invalid dump id {dump_id!r}")
        return os.path.join(self.dump_dir, f"dpdce_dump_{dump_id}.npz")

    DUMPS_KEPT = 20

    def _dump(self, txn, rxn) -> str:
        dump_id = str(int(time.time() * 1000))
        np.savez(self._dump_path(dump_id), tx=txn, rx=rxn)
        self.results = {**self.results, "last_dump_id": dump_id}
        self._dump_ids = getattr(self, "_dump_ids", []) + [dump_id]
        # keep a bounded history; a long-running service must not fill TMPDIR
        while len(self._dump_ids) > self.DUMPS_KEPT:
            old = self._dump_ids.pop(0)
            try:
                os.remove(self._dump_path(old))
            except OSError:
                pass
        return dump_id

    def _restore_dump(self, params):
        """Re-train from a stored burst (ref: python/dpdce.py:428-431)."""
        dump_id = (params or {}).get("dump_id",
                                     self.results.get("last_dump_id"))
        if not dump_id:
            raise RuntimeError("no dump available")
        d = np.load(self._dump_path(str(dump_id)))
        txn, rxn = d["tx"], d["rx"]
        # one shared adaptation step (same guards + lr policy as the
        # engines -- a third training copy would drift)
        result = adapt_iteration(self.model, self.model_kind,
                                 get_learning_rate(self.iteration), txn, rxn)
        if result["state"] != "adapted":
            raise RuntimeError(f"dump {dump_id} unusable: {result}")
        self._publish("Idle", f"restored dump {dump_id}",
                      restored_dump=str(dump_id), **{
                          k: v for k, v in result.items() if k != "state"})

    def _calibrate(self):
        """One measurement pass reporting the TX/RX alignment quality
        (ref: python/dpdce.py:435-438 runs a calibration measurement)."""
        txn, rxn = self._measure_burst()
        n = min(txn.size, rxn.size)
        ph = float(np.angle(np.sum(np.conj(txn[:n]) * rxn[:n])))
        gain = float(np.sqrt(np.mean(np.abs(rxn[:n]) ** 2)
                             / (np.mean(np.abs(txn[:n]) ** 2) or 1.0)))
        self._publish("Idle",
                      f"calibration: phase {np.degrees(ph):.1f} deg, "
                      f"gain {gain:.3f}",
                      calibration={"phase_deg": float(np.degrees(ph)),
                                   "rx_tx_gain": gain})

    def stop(self):
        self._running = False
        self._server.join(timeout=2)
        self._worker.join(timeout=2)
        self.sock.close()
