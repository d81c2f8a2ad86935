"""Eraser-style lockset race detector for the host runtime (TSAN analogue).

The reference project runs its multithreaded C++ runtime under
ThreadSanitizer in CI; the TPU framework's *device* path is pure/functional
(data races are impossible by construction), but its host runtime is still
a set of cooperating threads (output fetch/writer pipeline, SDR queue,
telnet/ZMQ RC servers, GPSDO/underflow monitors).  This module provides the
corresponding dynamic checker for that host layer: the classic Eraser
lockset algorithm [Savage et al., SOSP'97] over instrumented attributes.

How it works
------------
* ``tracked_lock_factory()`` patches-in replacements for
  ``threading.Lock``/``RLock`` that record, per thread, the set of locks
  currently held.
* ``track_class(cls, attrs)`` subclasses ``cls`` so that every read/write
  of the watched attributes -- including the object's *own* internal
  accesses -- feeds the per-(object, attribute) state machine:

      virgin -> exclusive(first thread) -> shared / shared-modified

  Once an attribute is written by more than one thread, its candidate
  lockset is intersected with the accessor's held locks on every access;
  an empty intersection is reported as a race.
* Hand-off patterns that are safe through happens-before but carry no
  common lock (queue-mediated publication) are declared via
  ``annotate_benign`` -- the same role as TSAN suppressions.

Python's GIL keeps individual attribute loads/stores atomic, so what this
detector surfaces are *atomicity violations* (check-then-act without the
protecting lock) -- exactly the bug class the locks in io/sdr.py and
rc/__init__.py exist to prevent, and the one the GIL does NOT rule out.

Used by tests/test_racecheck.py, which runs the SDR queue and RC registry
under concurrent load with the detector armed.

The port's copy of dabmod_tpu/utils/racecheck.py (tests/test_torch_racecheck.py
runs it on the port's io/sdr.py).
"""
from __future__ import annotations

import threading
import traceback

_tls = threading.local()


def _held() -> frozenset:
    return frozenset(getattr(_tls, "locks", ()))


def _push(lock_id):
    locks = getattr(_tls, "locks", None)
    if locks is None:
        locks = _tls.locks = []
    locks.append(lock_id)


def _pop(lock_id):
    locks = getattr(_tls, "locks", [])
    if lock_id in locks:
        locks.reverse()
        locks.remove(lock_id)
        locks.reverse()


class TrackedLock:
    """threading.Lock/RLock stand-in that maintains the thread's lockset."""

    def __init__(self, inner=None):
        self._inner = inner if inner is not None else threading.RLock()

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            _push(id(self))
        return got

    def release(self):
        _pop(id(self))
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # Condition-variable compatibility (io/sdr.py uses Condition, whose
    # wait() temporarily releases the underlying lock)
    def _is_owned(self):
        return self._inner._is_owned() if hasattr(self._inner, "_is_owned") \
            else self._inner.locked()

    def _release_save(self):
        _pop(id(self))
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        _push(id(self))


def tracked_lock_factory():
    """Factories suitable for monkeypatching ``threading.Lock``/``RLock``
    (the originals are captured now, so the patch can't recurse)."""
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    return (lambda: TrackedLock(orig_lock()),
            lambda: TrackedLock(orig_rlock()))


class RaceReport:
    def __init__(self, attr: str, threads, stack: str):
        self.attr = attr
        self.threads = tuple(threads)
        self.stack = stack

    def __repr__(self):
        return f"RaceReport({self.attr!r}, threads={self.threads})"


# per-(id(obj), attr): [state, owner_thread, candidate_lockset, threads_seen]
_VIRGIN, _EXCLUSIVE, _SHARED, _SHARED_MOD = range(4)


class Detector:
    """One detector instance == one analysis session (tests make their own
    so parallel test runs don't share state)."""

    def __init__(self):
        self._state: dict = {}
        self._benign: set = set()
        self.reports: list[RaceReport] = []
        self._guard = threading.Lock()

    def annotate_benign(self, attr: str):
        """Suppress reports for `attr` (happens-before via queue hand-off,
        counters that tolerate torn read-modify-write, etc.)."""
        self._benign.add(attr)

    def _on_access(self, key, attr, is_write):
        if attr in self._benign:
            return
        tid = threading.get_ident()
        held = _held()
        with self._guard:
            st = self._state.get(key)
            if st is None:
                self._state[key] = [_EXCLUSIVE, tid, None, {tid}, False]
                return
            state, owner, lockset, threads, reported = st
            threads.add(tid)
            if reported:
                return                # one report per (object, attribute)
            if state == _EXCLUSIVE:
                if tid == owner:
                    return
                st[0] = _SHARED_MOD if is_write else _SHARED
                st[2] = held
                state = st[0]
                if state == _SHARED:
                    return
            else:
                st[2] = held if st[2] is None else (st[2] & held)
                if state == _SHARED and is_write:
                    st[0] = _SHARED_MOD
                    state = _SHARED_MOD
            if state == _SHARED_MOD and not st[2]:
                st[4] = True
                self.reports.append(RaceReport(
                    attr, threads, "".join(traceback.format_stack(limit=8))))

    def track_class(self, cls, attrs):
        """Subclass `cls` whose watched-attribute accesses (internal ones
        included) feed the detector."""
        watched = frozenset(attrs)
        det = self

        class Tracked(cls):
            def __getattribute__(self, name):
                if name in watched:
                    det._on_access((id(self), name), name, False)
                return super().__getattribute__(name)

            def __setattr__(self, name, value):
                if name in watched:
                    det._on_access((id(self), name), name, True)
                super().__setattr__(name, value)

        Tracked.__name__ = f"Tracked{cls.__name__}"
        return Tracked
