"""The port's Eraser-lockset race detector (dabmod_tpu_torch/utils/
racecheck.py, a copy of dabmod_tpu/utils/racecheck.py): the cases of
tests/test_racecheck.py, run on the port's copy and, for the integration
cases, on the port's SdrOutput (dabmod_tpu_torch/io/sdr.py), whose
push-overflow path must keep its lock discipline under concurrent
producers while a deliberate violation of it is caught.

The port's io/sdr.py looks threading.Lock and threading.Condition up when
an SdrOutput is built, so the patched factories reach it.
"""
import threading
import time

import numpy as np

from dabmod_tpu_torch.utils import racecheck


class Plain:
    def __init__(self):
        self.counter = 0
        self.other = 0


def _run_threads(n, fn):
    ts = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def test_detects_unsynchronized_read_modify_write():
    det = racecheck.Detector()
    obj = det.track_class(Plain, ["counter"])()

    def worker(_):
        for _i in range(200):
            obj.counter = obj.counter + 1
    _run_threads(4, worker)
    assert det.reports, "unsynchronized counter must be reported"
    assert det.reports[0].attr == "counter"
    assert len(det.reports[0].threads) >= 2


def test_lock_discipline_passes():
    det = racecheck.Detector()
    obj = det.track_class(Plain, ["counter"])()
    lock = racecheck.TrackedLock()

    def worker(_):
        for _i in range(200):
            with lock:
                obj.counter = obj.counter + 1
    _run_threads(4, worker)
    assert det.reports == []
    assert obj.counter == 800


def test_read_only_sharing_is_not_a_race():
    det = racecheck.Detector()
    obj = det.track_class(Plain, ["counter"])()
    obj.counter = 42              # single-writer initialisation

    seen = []

    def reader(_):
        seen.append(obj.counter)
    _run_threads(4, reader)
    assert det.reports == []
    assert seen == [42] * 4


def test_benign_annotation_suppresses_reports():
    det = racecheck.Detector()
    det.annotate_benign("counter")
    obj = det.track_class(Plain, ["counter"])()

    def worker(_):
        for _i in range(100):
            obj.counter += 1
    _run_threads(4, worker)
    assert det.reports == []


def test_one_report_per_attribute():
    det = racecheck.Detector()
    obj = det.track_class(Plain, ["counter", "other"])()

    def worker(_):
        for _i in range(100):
            obj.counter += 1
            obj.other += 1
    _run_threads(4, worker)
    assert len(det.reports) == 2
    assert {r.attr for r in det.reports} == {"counter", "other"}


def test_tracked_lock_works_with_condition():
    # io/sdr.py uses threading.Condition; wait() must restore the lockset
    lock = racecheck.TrackedLock()
    cond = threading.Condition(lock)
    hits = []

    def waiter():
        with cond:
            cond.wait_for(lambda: hits, timeout=5)
            hits.append("woken-holding" if racecheck._held() else "bad")
    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    with cond:
        hits.append("go")
        cond.notify_all()
    t.join()
    assert "woken-holding" in hits


# ---------------------------------------------------------------- real code
def _make_sdr_output(det, monkeypatch):
    lock_f, rlock_f = racecheck.tracked_lock_factory()
    monkeypatch.setattr(threading, "Lock", lock_f)
    monkeypatch.setattr(threading, "RLock", rlock_f)
    from dabmod_tpu_torch.io import sdr

    class NullDevice:
        def transmit_frame(self, *a, **kw):
            pass

        def get_real_secs(self):
            return 0.0

        def close(self):
            pass

    cls = det.track_class(sdr.SdrOutput, ["queue_overflows"])
    return cls(NullDevice(), sync=False)


def test_sdr_push_overflow_lock_discipline(monkeypatch):
    """The evict-one-then-put overflow path (io/sdr.py _enqueue) is
    documented as atomic under _enqueue_lock; concurrent producers driving
    the queue past capacity must produce zero lockset violations."""
    det = racecheck.Detector()
    out = _make_sdr_output(det, monkeypatch)
    assert isinstance(out._enqueue_lock, racecheck.TrackedLock)
    frame = np.zeros((16, 2), np.float32)

    def producer(i):
        for _k in range(300):
            out.write(frame, ts=None)
    _run_threads(4, producer)
    out.close()
    assert det.reports == [], det.reports
    assert out.queue_overflows > 0   # the contended path actually ran


def test_sdr_overflow_counter_race_is_caught(monkeypatch):
    """Deliberate violation of the same invariant: bumping the overflow
    counter outside _enqueue_lock must be reported."""
    det = racecheck.Detector()
    out = _make_sdr_output(det, monkeypatch)

    def rogue(_):
        for _k in range(300):
            out.queue_overflows += 1     # not holding _enqueue_lock
    _run_threads(4, rogue)
    out.close()
    assert any(r.attr == "queue_overflows" for r in det.reports)
