"""DPD computation engine CLI (port of python/dpdce.py workflow,
python/README.md:25-60):

    measure aligned TX/RX burst -> extract binned statistics -> fit the
    memoryless polynomial -> push coefficients via remote control -> repeat.

Run against a modulator with an SDR output exposing the feedback port:

    python -m dabmod_tpu_torch.dpd.dpdce --rc tcp://localhost:9400 \
        --feedback-port 50055 --iterations 10

The port's copy of dabmod_tpu/dpd/dpdce.py; its default coefficient file
lies in tempfile.gettempdir() (TMPDIR), not in /tmp.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import numpy as np

from . import Adapt, ExtractStatistic, Measure, Poly
from .align import align_tx_rx
from .heuristics import get_learning_rate
from .measure import normalise_rx, phase_align_rx
from .model_lut import Lut

log = logging.getLogger("dpdce")

DEFAULT_COEF_PATH = os.path.join(tempfile.gettempdir(), "dabmod_tpu_poly.coef")


def normalise_burst(tx: np.ndarray, rx: np.ndarray):
    """Time-align (integer + fractional lag), peak-normalise and
    phase-align a measured TX/RX pair; raises on an empty/invalid burst
    (the caller decides whether to retry).  The time alignment is NOT
    optional on real hardware: the RX path has fixed group delay, and
    per-sample statistics on unaligned bursts are meaningless
    (ref: python/dpd/Measure.py:87-103 always aligns)."""
    if tx.size == 0 or not (np.all(np.isfinite(tx))
                            and np.all(np.isfinite(rx)) and np.any(rx)):
        raise ValueError("empty/invalid feedback burst")
    tx, rx = align_tx_rx(tx, rx)
    if tx.size == 0:
        raise ValueError("empty burst after alignment")
    peak = float(np.abs(tx).max()) or 1.0
    txn, rxn = tx / peak, rx / peak
    return txn, phase_align_rx(txn, normalise_rx(txn, rxn))


def adapt_iteration(model, model_kind: str, lr: float,
                    txn: np.ndarray, rxn: np.ndarray) -> dict:
    """One shared adaptation step: train `model` on the normalised burst and
    return the result record, or a 'too_few_bins' record.  Used by both the
    fixed-iteration engine below and the yamlrpc service (dpd/server.py) so
    the two engines cannot drift."""
    if model_kind == "lut":
        model.learning_rate = lr
        model.train(txn, rxn)
        resid = float(np.mean(np.abs(model.apply(txn) - txn) ** 2))
        return {"state": "adapted", "residual": resid, "lr": lr}
    es = ExtractStatistic(peak_amplitude=1.0)
    tx_avg, rx_avg, ph = es.extract(txn, rxn)
    if tx_avg.size < 8:
        return {"state": "too_few_bins", "bins": int(tx_avg.size)}
    model.learning_rate_am = model.learning_rate_pm = lr
    model.train(tx_avg, rx_avg, ph)
    resid = float(np.mean((model.am_am(rx_avg) - tx_avg) ** 2))
    return {"state": "adapted", "residual": resid, "lr": lr,
            "bins": int(tx_avg.size),
            "coefs_am": np.round(model.coefs_am, 6).tolist(),
            "coefs_pm": np.round(model.coefs_pm, 6).tolist()}


def run_engine(rc_endpoint: str, feedback_host: str, feedback_port: int,
               iterations: int = 10, samples_per_burst: int = 40960,
               coef_path: str = DEFAULT_COEF_PATH,
               learning_rate: float | None = None,
               sleep_s: float = 0.1, model_kind: str = "poly",
               status_cb=None, stop_event=None):
    """Closed adaptation loop.  `model_kind` selects the polynomial or
    LUT predistorter; with learning_rate=None the reference's annealing
    schedule (Heuristics.get_learning_rate) is used.  `status_cb(dict)` is
    invoked after each iteration (the GUI's DPD panel consumes it) and
    `stop_event` aborts the loop early (threading.Event)."""
    measure = Measure(feedback_host, feedback_port, samples_per_burst)
    adapt = Adapt(rc_endpoint, coef_path)
    fixed_lr = learning_rate
    model = (Lut(learning_rate=fixed_lr or 1.0) if model_kind == "lut"
             else Poly(learning_rate_am=fixed_lr or 0.4,
                       learning_rate_pm=fixed_lr or 0.4))

    def report(**kw):
        if status_cb is not None:
            status_cb({"model": model_kind, **kw})

    for i in range(iterations):
        if stop_event is not None and stop_event.is_set():
            break
        lr = fixed_lr if fixed_lr is not None else get_learning_rate(i)
        tx, tx_ts, rx, rx_ts = measure.get_samples()
        try:
            txn, rxn = normalise_burst(tx, rx)
        except ValueError:
            log.warning("empty/invalid burst, retrying")
            report(iteration=i, state="empty_burst")
            time.sleep(sleep_s)
            continue
        result = adapt_iteration(model, model_kind, lr, txn, rxn)
        if result["state"] == "too_few_bins":
            log.warning("iteration %d: not enough bins (%d)", i,
                        result["bins"])
            report(iteration=i, **result)
            time.sleep(sleep_s)
            continue
        adapt.set_predistorter(model.get_dpd_data())
        log.info("iteration %d: residual %.3e%s", i, result["residual"],
                 f", coefs {result['coefs_am']}"
                 if "coefs_am" in result else "")
        report(iteration=i, **result)
        time.sleep(sleep_s)
    return model


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--rc", default="tcp://localhost:9400")
    ap.add_argument("--feedback-host", default="127.0.0.1")
    ap.add_argument("--feedback-port", type=int, default=50055)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--samples", type=int, default=40960)
    ap.add_argument("--lr", type=float, default=None,
                    help="fixed learning rate (default: annealing schedule)")
    ap.add_argument("--model", choices=("poly", "lut"), default="poly")
    ap.add_argument("--control-port", type=int, default=0,
                    help="run as a yamlrpc-controlled service on this UDP "
                         "port instead of a fixed iteration count "
                         "(ref: python/dpdce.py:135)")
    args = ap.parse_args(argv)
    if args.control_port:
        from .server import DpdceServer  # noqa: PLC0415
        srv = DpdceServer(args.control_port, rc_endpoint=args.rc,
                          feedback_host=args.feedback_host,
                          feedback_port=args.feedback_port,
                          samples_per_burst=args.samples,
                          model_kind=args.model)
        log.info("dpdce service listening on yamlrpc udp %d", srv.port)
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            srv.stop()
        return
    run_engine(args.rc, args.feedback_host, args.feedback_port,
               args.iterations, args.samples, learning_rate=args.lr,
               model_kind=args.model)


if __name__ == "__main__":
    main()
