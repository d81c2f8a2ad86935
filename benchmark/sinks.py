"""Where the program's output goes in a run: the benchmark's own sink
objects.  Each stamps the time a transmission frame (TF) reaches it,
follows the TFs' order by their FCT and keeps a seeded sample of the TFs of
the window for the comparison with the plain reference.

* `BatchSink` takes the file output's place and discards each batch: the
  runtime's writer thread calls `write(batch, [(fct, timestamp)] per TF)`.
* `RadioDevice` is an `SdrDevice` for the port's own `SdrOutput`: its
  device thread calls `transmit_frame(samples, timestamp)` once a TF and
  copies the samples once into a reused buffer, as a radio's driver
  copies them into its own.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

FCT_PERIOD = 250


class TfLog:
    """The TFs that reached the sink: each one's index in the stream
    (unwrapped from its first ETI frame's FCT, the stream starting at
    frame 0), its arrival on time.monotonic(), the frames lost before
    it, and a reservoir sample of those that `in_window` accepts."""

    def __init__(self, cif_count: int, keep: int, seed: int):
        self.cif = cif_count
        self.keep = keep
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.arrivals: list[tuple[int, float]] = []    # (TF index, time)
        self.lost: list[tuple[int, int]] = []          # (first frame, n)
        self.disorder = 0
        self.sample: dict[int, np.ndarray] = {}
        self.seen_in_window = 0
        self.in_window = None                          # (tf, t) -> bool
        self._last_frame = None
        self._lock = threading.Lock()

    def add(self, fct: int, t: float, samples: np.ndarray):
        """One TF whose first ETI frame has `fct`, arrived at t."""
        self.add_batch(fct, 1, t, samples[None])

    def add_batch(self, fct: int, n: int, t: float, samples: np.ndarray):
        """n consecutive TFs (samples [n, ...]), the first one's first ETI
        frame with `fct`, arrived together at t.  A batch whose TFs do not
        follow one another counts as out of order."""
        with self._lock:
            if self._last_frame is None:
                frame = fct                            # stream starts at 0
                if frame:
                    self.lost.append((0, frame))
            else:
                step = (fct - self._last_frame) % FCT_PERIOD
                if step == 0:
                    self.disorder += n
                    return
                frame = self._last_frame + step
                if step > self.cif:
                    self.lost.append((self._last_frame + self.cif,
                                      step - self.cif))
            if frame % self.cif:
                self.disorder += 1
            self._last_frame = frame + self.cif * (n - 1)
            tf0 = frame // self.cif
            self.arrivals.extend((tf0 + i, t) for i in range(n))
            if self.in_window is None:
                return
            for i in range(n):
                if self.in_window(tf0 + i, t):
                    self._offer(tf0 + i, samples[i])

    def _offer(self, tf: int, samples: np.ndarray):
        """Reservoir sampling (Algorithm R): a uniform sample of the
        window's TFs, drawn from the seed."""
        self.seen_in_window += 1
        if len(self.sample) < self.keep:
            self.sample[tf] = samples.copy()
            return
        j = int(self.rng.integers(0, self.seen_in_window))
        if j < self.keep:
            del self.sample[sorted(self.sample)[j]]
            self.sample[tf] = samples.copy()

    def lost_frames(self, lo: int | None = None, hi: int | None = None):
        """Frames lost, all of them or those with index in [lo, hi)."""
        n = 0
        for first, count in self.lost:
            a, b = first, first + count
            if lo is not None:
                a, b = max(a, lo), min(b, hi)
            n += max(0, b - a)
        return n


class BatchSink:
    """In the file output's place, the end of the line: each batch's TFs
    logged as they arrive, the sampled ones copied, and the batch then
    discarded: no file or socket cost (a copy of every batch made the
    sink's own memory traffic the bottleneck of a bulk run, not the
    program)."""

    num_clipped_samples = 0

    def __init__(self, log: TfLog, host_range=contextlib.nullcontext):
        self.log = log
        self.host_range = host_range

    def write(self, iq, metadata=None):
        with self.host_range("bench.sink.write"):
            arr = np.asarray(iq)
            t = time.monotonic()
            fcts = [int(fct) for fct, _ts in metadata]
            if all((b - a) % FCT_PERIOD == self.log.cif
                   for a, b in zip(fcts, fcts[1:])):
                self.log.add_batch(fcts[0], len(fcts), t, arr)
            else:
                for i, fct in enumerate(fcts):
                    self.log.add(fct, t, arr[i])

    def close(self):
        pass


def radio_device(log: TfLog, host_range=contextlib.nullcontext):
    """A `dabmod_tpu_torch.io.sdr.SdrDevice` standing in for the radio;
    `host_range(name)` is the context its work runs in (a profiler range
    in a traced run)."""
    from dabmod_tpu_torch.io.sdr import SdrDevice

    class RadioDevice(SdrDevice):
        def __init__(self):
            self._buf = None
            self.frames = 0

        def tune(self, lo_offset, frequency):
            self.lo_offset, self.frequency = lo_offset, frequency

        def transmit_frame(self, samples, ts):
            with host_range("bench.sink.transmit_frame"):
                t = time.monotonic()
                arr = np.asarray(samples)
                if self._buf is None or self._buf.shape != arr.shape \
                        or self._buf.dtype != arr.dtype:
                    self._buf = np.empty_like(arr)
                np.copyto(self._buf, arr)
                log.add(int(ts.fct), t, self._buf)
                self.frames += 1

        def get_run_statistics(self):
            return {"frames": self.frames}

    return RadioDevice()
