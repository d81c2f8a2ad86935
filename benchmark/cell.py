"""One run of one cell: the configuration and the traffic mix, found by name
in configs/ and traffic/, drive dabmod_tpu_torch's ModRuntime.run_batches,
the loop that `python -m dabmod_tpu_torch.cli <ini>` runs, with the
benchmark's sink in place of the output.

  set-up   the input made from the seed (an ETI file for a closed loop, the
           generator process for an open one), the INI written and parsed
           by the port, ModRuntime built, its first steps run (kernels
           built or loaded, the batch size's graph captured)
  window   run_seconds of the loop; with tracing, a stretch of it under
           torch.profiler
  check    the program freed, then the plain reference renders a seeded
           sample of the window's TFs from the same frames
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

import streams
import devtrace
from sinks import BatchSink, TfLog, radio_device

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)

# a stream's TFs due in the window are waited for this long past its close
LATE_WAIT_S = 60.0


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def load_reader(name: str):
    """The per-layer metric reader metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cif_count(cfg: dict) -> int:
    """ETI frames (CIFs) a transmission frame, from the configuration's
    transmission mode."""
    from reference import dab
    return dab.MODES[cfg["reference"]["mode"]].cif_count


def reference_module(cfg: dict):
    """The plain reference that the configuration names under
    "reference_module": the module reference/<name>.py, reference/chain.py
    where the key is absent.  It defines Chain(settings, device,
    precision), whose render(frames, first_tf, keep=1) gives the wire
    samples [keep, n, 2], and CONTROL_PRECISION, the precision of its
    control."""
    name = cfg.get("reference_module", "chain")
    if not (isinstance(name, str) and name.isidentifier()
            and os.path.isfile(os.path.join(BENCH, "reference",
                                            name + ".py"))):
        raise ValueError(f"configuration {cfg.get('name')!r}: "
                         f"reference_module {name!r} names no module of "
                         "reference/")
    mod = importlib.import_module("reference." + name)
    if not hasattr(mod, "Chain") or not hasattr(mod, "CONTROL_PRECISION"):
        raise ValueError(f"configuration {cfg.get('name')!r}: reference/"
                         f"{name}.py defines no Chain or CONTROL_PRECISION")
    return mod


def reference_chain(cfg: dict, device, precision: str):
    """The configuration's plain reference, built on its settings at
    `precision`."""
    return reference_module(cfg).Chain(reference_settings(cfg), device,
                                       precision)


def reference_settings(cfg: dict) -> dict:
    """The configuration's settings for the plain reference."""
    from reference import dab
    s = dict(cfg["reference"])
    if s.get("fir") == "default":
        s["fir"] = dab.DEFAULT_FIR_TAPS
    return s


class Generator:
    """The open loop's sender process (generator.py)."""

    def __init__(self, cfg_name: str, seed: int, n_frames: int, kind: str):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(BENCH, "generator.py"),
             "--config", os.path.join(BENCH, "configs", cfg_name + ".json"),
             "--seed", str(seed), "--frames", str(n_frames),
             "--kind", kind],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def wait_port(self) -> int:
        line = self.proc.stdout.readline().split()
        if len(line) != 2 or line[0] != "PORT":
            raise RuntimeError(f"generator did not start: {line}")
        return int(line[1])

    def go(self, t0: float):
        self.proc.stdin.write(f"GO {t0!r}\n")
        self.proc.stdin.flush()

    def report(self, timeout: float = 30.0) -> dict:
        try:
            out, _ = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            return {}
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        return json.loads(lines[-1]) if lines else {}

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def write_ini(path: str, sections: dict):
    with open(path, "w") as f:
        for sec, kv in sections.items():
            f.write(f"[{sec}]\n")
            for k, v in kv.items():
                f.write(f"{k}={v}\n")


class Cell:
    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 t_process: float, device: str = "cuda",
                 traffic_overrides: dict | None = None, e2e=()):
        self.cfg = load_json("configs", cell["config"])
        self.traffic = {**load_json("traffic", cell["traffic"]),
                        **(traffic_overrides or {})}
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.t_process = t_process
        self.device = device
        self.ensemble = [tuple(e) for e in self.cfg["ensemble"]]
        self.cif = cif_count(self.cfg)
        self.open_loop = self.traffic["loop"] == "open"
        self.gen = None
        self.steps = 0
        self.trace_at = (math.inf, math.inf)
        # step_card_ms_per_tf: CUDA events at each step of an untraced
        # window, (start, end, TFs) a step
        self.card_clock = "step_card_ms_per_tf" in e2e and not trace
        self.step_clock = []
        self._replay_at = None
        self._unhook = None
        self.tmp = tempfile.mkdtemp(prefix="dabmod_bench_")
        if self.open_loop:
            t = self.traffic
            self.n_frames = math.ceil(
                (t["warm_s"] + seconds + t["tail_s"])
                * t["rate_frames_per_s"])
            self.gen = Generator(cell["config"], seed, self.n_frames,
                                 t["kind"])

    # -- set-up ----------------------------------------------------------
    def _settings(self):
        from dabmod_tpu_torch.config import parse_ini
        t, cfg = self.traffic, self.cfg
        ini = {k: dict(v) for k, v in cfg["ini"].items()}
        ini["modulator"]["batch_tf"] = str(t["batch_tf"])
        inp = dict(t["input"])
        if self.open_loop:
            inp["source"] = f"tcp://127.0.0.1:{self.gen.wait_port()}"
        else:
            path = os.path.join(self.tmp, "input.eti")
            self.frames = streams.make_frames(self.seed, t["file_frames"],
                                              self.ensemble)
            self.frames.tofile(path)
            inp["source"] = path
        ini = {"input": inp, **ini}
        if "fileoutput" in ini:
            ini["fileoutput"]["filename"] = os.devnull
        if "poly" in ini:
            coef = os.path.join(self.tmp, "poly.coef")
            c = cfg["poly_coefs"]
            with open(coef, "w") as f:
                f.write("1\n5\n" + "".join(f"{v!r}\n"
                                            for v in c["am"] + c["pm"]))
            ini["poly"]["polycoeffile"] = coef
        path = os.path.join(self.tmp, "mod.ini")
        write_ini(path, ini)
        return parse_ini(path)

    def _install_sink(self, rt):
        from dabmod_tpu_torch.io.sdr import SdrOutput
        self.log = TfLog(self.cif, self.traffic["check_tfs"], self.seed)
        rt.output.close()
        if self.traffic["sink"] == "sdr":
            s = rt.settings
            rt.output = SdrOutput(radio_device(self.log, self._range),
                                  sync=False, sample_rate=s.output_rate)
        else:
            rt.output = BatchSink(self.log, self._range)

    def _wrap_reader(self, rt):
        """Counts the frames the program reads, on the main thread, and
        starts and stops the profiler there at the traced stretch."""
        import torch
        reader = rt.reader
        inner = reader.read_batch
        self.read_log = []                      # (time, frames so far)
        self.frames_read = 0
        self.prof = None
        self.prof_state = "off"

        def read_batch(n):
            now = time.monotonic()
            if self.trace:
                self._profiler_tick(now, rt, torch)
            with self._range("bench.reader.read_batch"):
                got = inner(n)
            self.frames_read += len(got)
            self.read_log.append((time.monotonic(), self.frames_read))
            return got
        reader.read_batch = read_batch

    def _range(self, name: str):
        """A host range of the benchmark's around a call into a layer,
        recorded in the traced run only."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def _wrap_step(self, rt):
        m = rt.modulator
        inner = m.modulate
        self.steps = 0
        if self.card_clock:
            self._hook_replay()

        def modulate(fic, subch, state):
            start = card_event() if self.card_clock else None
            self._replay_at = None
            with self._range("bench.step.modulate"):
                out = inner(fic, subch, state)
            if start is not None:
                # from the step's first graph launch where it replays one:
                # the input copies before it, and the card's wait for the
                # host to enqueue them, are left out
                self.step_clock.append((self._replay_at or start,
                                        card_event(),
                                        fic.shape[0] // self.cif))
            self.steps += 1
            return out
        m.modulate = modulate

    def _hook_replay(self):
        """An event recorded on the stream as each step launches its first
        CUDA graph (torch.cuda.CUDAGraph.replay, undone by cleanup)."""
        import torch
        cls = torch.cuda.CUDAGraph
        own = cls.__dict__.get("replay")
        inner = cls.replay

        def replay(graph, *args, **kwargs):
            if self._replay_at is None:
                self._replay_at = card_event()
            return inner(graph, *args, **kwargs)
        cls.replay = replay

        def unhook():
            if own is None:
                del cls.replay
            else:
                cls.replay = own
        self._unhook = unhook

    def _profiler_tick(self, now, rt, torch):
        if self.prof_state == "off" and now >= self.trace_at[0]:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device != "cpu":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.prof_state = "on"
            self.prof_t0 = time.monotonic()
            self.prof_snap = (dict(rt.timings), self.steps)
        elif self.prof_state == "on" and now >= self.trace_at[1]:
            if self.device != "cpu":
                torch.cuda.synchronize()
            # the stretch ends here: stop() then spends seconds collecting
            self.prof_t1 = time.monotonic()
            t0, s0 = self.prof_snap
            self.prof_delta = ({k: rt.timings[k] - t0[k] for k in t0},
                               self.steps - s0)
            self.prof.stop()
            self.prof_state = "done"

    def setup(self):
        import torch
        from dabmod_tpu_torch.runtime import ModRuntime
        settings = self._settings()
        self.rate = settings.output_rate
        if self.device != "cpu":
            # every kernel library built (the first run in a checkout) or
            # found before anything is timed
            from dabmod_tpu_torch.ops import build
            build.build()
        if self.trace:
            self._warm_profiler(torch)
        self.rt = rt = ModRuntime(settings, device=self.device)
        self._install_sink(rt)
        self._wrap_reader(rt)
        if self.open_loop:
            self._warm_step(rt, torch)
        else:
            rt.run_batches(self.traffic["warm_batches"])
            self._wrap_step(rt)
        if self.device != "cpu":
            torch.cuda.synchronize()
        return rt

    def _warm_profiler(self, torch):
        """The profiler's first start initialises CUPTI, which takes
        seconds: done here, so that the traced stretch starts on time."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(8, device=self.device).sum().item()

    def _warm_step(self, rt, torch):
        """A live stream's batch size captured before the stream starts:
        the modulator the runtime will take from the port's modulator cache
        (get_modulator, the same settings), run once on the stream's first
        TF."""
        from dabmod_tpu_torch.eti import parse_eti_frames
        from dabmod_tpu_torch.models import get_modulator
        batch = parse_eti_frames(self.input_frames(
            0, self.cif * self.traffic["batch_tf"]))
        m = get_modulator(batch.layout, rt.settings, rt.device)
        m.modulate(batch.fic, tuple(batch.subchannels), m.init_state())

    # -- window ----------------------------------------------------------
    def run(self) -> dict:
        import torch
        rt = self.setup()
        t = self.traffic
        if self.open_loop:
            t0 = time.monotonic() + 0.05
            self.t_start = t0 + t["warm_s"]
            self.t_end = self.t_start + self.seconds
            C = self.cif
            period = 1.0 / t["rate_frames_per_s"]
            # TF k is due when its last ETI frame is; the window's TFs are
            # those due in [t_start, t_end)
            self.due = lambda tf: t0 + (C * tf + C - 1) * period
            k_lo = 0
            while self.due(k_lo) < self.t_start:
                k_lo += 1
            k_hi = k_lo
            while self.due(k_hi) < self.t_end:
                k_hi += 1
            self.window_tfs = (k_lo, k_hi)
            self.log.in_window = lambda tf, _t: k_lo <= tf < k_hi
            self.gen.go(t0)
            # the step is wrapped once the first batch has built the
            # modulator: until then it is set-up's (a warm-up of warm_s)
            stopper = threading.Thread(target=self._stop_open, args=(rt,),
                                       daemon=True)
        else:
            self.t_start = time.monotonic()
            self.t_end = self.t_start + self.seconds
            self.log.in_window = \
                lambda _tf, at: self.t_start <= at <= self.t_end
            stopper = threading.Thread(target=self._stop_closed,
                                       args=(rt,), daemon=True)
        if self.trace:
            a = self.t_start + max(0.25 * self.seconds,
                                   0.5 * self.seconds - t["trace_s"] / 2)
            self.trace_at = (a, a + t["trace_s"])
        self.setup_s = self.t_start - self.t_process
        self.timings_start = dict(rt.timings)
        cpu0 = host_cpu()
        stopper.start()
        self.result = rt.run_batches(None)
        stopper.join()
        cpu1 = host_cpu()
        self.host_cpu = {k: round(cpu1[k] - cpu0[k], 3) for k in cpu0}
        self.timings_window = {k: rt.timings[k] - self.timings_start[k]
                               for k in self.timings_start}
        if self.device != "cpu":
            torch.cuda.synchronize()
        return self.collect()

    def _stop_closed(self, rt):
        time.sleep(max(0.0, self.t_end - time.monotonic()))
        rt.stop()

    def _stop_open(self, rt):
        # wrap the step once the first batch has been issued
        while rt.modulator is None and time.monotonic() < self.t_start:
            time.sleep(0.005)
        if rt.modulator is not None:
            self._wrap_step(rt)
        k_lo, k_hi = self.window_tfs
        deadline = self.t_end + LATE_WAIT_S
        while time.monotonic() < deadline:
            arrived = self.log.arrivals
            if arrived and arrived[-1][0] >= k_hi - 1:
                break
            time.sleep(0.02)
        rt.stop()

    # -- results ---------------------------------------------------------
    def collect(self) -> dict:
        import torch
        res = {"frames_read": self.frames_read}
        arrivals = self.log.arrivals
        C = self.cif
        if self.open_loop:
            k_lo, k_hi = self.window_tfs
            lat = latencies_ms(arrivals, self.due, k_lo, k_hi)
            res.update(attempted=(k_hi - k_lo) * C,
                       failed=(k_hi - k_lo - len(lat)) * C, latencies=lat)
            if lat:
                res["latency_p50_ms"] = statistics.median(lat)
                res["latency_p95_ms"] = float(np.percentile(lat, 95))
        else:
            in_win = [tf for tf, at in arrivals
                      if self.t_start <= at <= self.t_end]
            res["frames_per_s"] = C * len(in_win) / self.seconds
            # the frames the program took in the window
            before = [n for at, n in self.read_log if at < self.t_start]
            during = [n for at, n in self.read_log if at <= self.t_end]
            lo = before[-1] if before else 0
            hi = during[-1] if during else lo
            res.update(attempted=hi - lo,
                       failed=self.log.lost_frames(lo, hi))
        if self.step_clock:
            # each step's span on the card's own clock: from its graph's
            # launch (or its start) to its last operation
            ms = sum(a.elapsed_time(b) for a, b, _ in self.step_clock)
            tfs = sum(n for _, _, n in self.step_clock)
            res["step_card_ms_per_tf"] = ms / tfs
        res["lost_frames"] = self.log.lost_frames() + C * self.log.disorder
        res["run_result"] = self.result.name
        if self.device != "cpu":
            res["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        if self.trace and self.prof_state == "done":
            timings, batches = self.prof_delta
            res["trace"] = devtrace.summarise(
                self.prof.events(), self.prof_t1 - self.prof_t0,
                threading.get_native_id(), batches, timings)
        return res

    def close(self):
        """Ends the program and the generator, frees the card."""
        rt, self.rt = getattr(self, "rt", None), None
        if rt is not None:
            rt.close()
        if self.gen is not None:
            self.gen_report = self.gen.report()
            self.gen.stop()
        del rt
        from dabmod_tpu_torch.models import clear_modulator_cache
        clear_modulator_cache()
        gc.collect()
        if self.device != "cpu":
            import torch
            torch.cuda.empty_cache()

    def cleanup(self):
        if self._unhook is not None:
            self._unhook()
            self._unhook = None
        if self.gen is not None:
            self.gen.stop()
        shutil.rmtree(self.tmp, ignore_errors=True)

    # -- the comparison --------------------------------------------------
    def input_frames(self, first: int, last: int) -> np.ndarray:
        """The stream's ETI frames [first, last)."""
        if self.open_loop:
            if not hasattr(self, "frames"):
                self.frames = streams.make_frames(self.seed, self.n_frames,
                                                  self.ensemble)
            return self.frames[first:last]
        n = self.frames.shape[0]
        return self.frames[np.arange(first, last) % n]


def card_event():
    """A CUDA event that keeps time, recorded on the current stream (the
    one the runtime issues the step on)."""
    import torch
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def host_cpu() -> dict:
    """CPU seconds so far: this process's and its main thread's."""
    return {"process_s": time.process_time(),
            "main_thread_s": time.thread_time()}


def latencies_ms(arrivals, due, k_lo: int, k_hi: int) -> list:
    """The on-air delay of each TF k_lo <= k < k_hi that arrived: its
    arrival at the radio less the due time of its last ETI frame (due(k)),
    ms, sorted.  A TF that arrived twice counts at its first arrival."""
    got = {}
    for tf, at in arrivals:
        if k_lo <= tf < k_hi and tf not in got:
            got[tf] = at
    return sorted(1e3 * (at - due(tf)) for tf, at in got.items())


def compare(program: np.ndarray, ref: np.ndarray, wire: str) -> dict:
    """The gaps of one TF's wire samples [n, 2] from the reference's."""
    if wire == "s16":
        p = program.view(np.int16).reshape(-1, 2).astype(np.float64)
        r = ref.astype(np.float64)
        d = p - r
        return {"max_lsb": float(np.abs(d).max()),
                "rms_lsb": float(np.sqrt(np.mean(d * d)))}
    p = program.reshape(-1, 2).astype(np.float64)
    r = ref.astype(np.float64)
    d = p - r
    return {"max_rel": float(np.abs(d).max() / np.abs(r).max()),
            "rms_rel": float(np.sqrt(np.mean(d * d) / np.mean(r * r)))}


def judge(cell: Cell, samples: dict, device: str,
          precision: str = "f64") -> dict:
    """Render each sampled TF with the plain reference and compare; the
    largest gap of each kind over the sample."""
    chain = reference_chain(cell.cfg, device, precision)
    wire = cell.cfg["reference"]["wire"]
    worst = {}
    for tf, prog in sorted(samples.items()):
        first = max(0, tf - 5)
        ref = chain.render(cell.input_frames(cell.cif * first,
                                             cell.cif * (tf + 1)),
                           first)[0].cpu().numpy()
        for k, v in compare(prog, ref, wire).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
