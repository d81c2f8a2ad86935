"""bench_gpu.py's multi-rank modes, the port's counterparts of
tools/bench_scaling.py (--scaling: --worlds over parallel.launch.spawn,
--hosts over separate processes joined by parallel.init_distributed) and
tools/measure_ti_collectives.py (--collectives), on the CPU over gloo at a
small size: the 2-sub-channel ensemble, 2 TFs a rank.

What a CPU run can show: the ranks join and exchange, every rank's output
equals the unsharded step's (max_abs_diff 0.0 on the CPU, whose plain
versions give the same bits at any batch size) and its state to the bit;
what the exchanges carry (parallel.EXCHANGES per coupling), held against
the collectives of dabmod_tpu's compiled sharded step; the arithmetic of
the rows.  No time of a CPU run is a device figure, and no row of one has
an efficiency.
"""
import json
import re
import subprocess
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_gpu
from dabmod_tpu.config import ModSettings as JSettings
from dabmod_tpu.eti import parse_eti_frames as j_parse
from dabmod_tpu.eti import synth_eti_batch as j_synth
from dabmod_tpu.models import Modulator as JModulator
from dabmod_tpu.models import make_default_layout as j_layout
from dabmod_tpu.parallel import sharding as jsharding
from dabmod_tpu_torch.config import ModSettings
from dabmod_tpu_torch.models import Modulator, make_default_layout
from dabmod_tpu_torch.parallel import sharding

BENCH_SPECS = ((0, 24, 0x22), (48, 48, 0x02))
RUN = dict(config="base", batch_per_rank=2, steps=2, runs=2, device="cpu",
           backend="gloo", traced=1, timeout_s=120)
# CFR, K3's plan (its plain form here) and s16 words, which count
# num_clipped: the three couplings of the step, at 2 TFs a rank
CFR_4M096_S16 = ("2sub cfr 4.096M s16", "bench",
                 dict(enable_cfr=True, cfr_clip=12.0, cfr_error_clip=3.0,
                      output_rate=4_096_000, output="file",
                      file_output_format="s16"), 4)


def _no_children():
    import multiprocessing as mp
    assert not mp.active_children()


# ---------------------------------------------------------------------------
# --scaling
# ---------------------------------------------------------------------------

def test_hosts_join_through_init_distributed():
    """--hosts 2 --chips-per-host 1: two separate processes joined by
    init_distributed at a free port, each rank's TFs equal to the
    unsharded step's on the CPU and its state to the bit."""
    rec = bench_gpu.run_hosts(torch, (2,), 1, **RUN)
    (row,) = rec["rows"]
    assert (row["world"], row["hosts"], row["chips_per_host"]) == (2, 2, 1)
    assert row["launcher"] == "init_distributed"
    assert row["backend"] == "gloo" and not row["captured"]
    assert [r["rank"] for r in row["ranks"]] == [0, 1]
    assert row["elementwise_ok"] and row["state_equal"]
    assert row["max_abs_diff"] == 0.0
    # every rank carries the all-reduced figures
    for key in ("slowest_step_ms", "max_abs_diff", "elementwise_ok"):
        assert len({r[key] for r in row["ranks"]}) == 1
    assert row["step_ms"] == max(r["step_ms"]["median"]
                                 for r in row["ranks"])
    assert row["efficiency"] is None and row["note"] == bench_gpu.CPU_NOTE
    assert row["nccl_ms_per_step"] is None
    assert rec["device"]["name"] == "cpu"
    json.dumps(rec)


def test_worlds_spawned_and_in_process():
    """--worlds 1,2: world 1 in this process (no group, the unsharded
    step timed beside it), world 2 spawned; both equal to the unsharded
    step."""
    rec = bench_gpu.run_scaling(torch, (1, 2), **RUN)
    one, two = rec["rows"]
    assert (one["world"], one["launcher"], one["backend"]) == (
        1, "in process", None)
    assert (two["world"], two["launcher"], two["backend"]) == (
        2, "spawn", "gloo")
    assert "unsharded_samples_per_s" in one
    assert "unsharded_samples_per_s" not in two
    for row in (one, two):
        assert row["elementwise_ok"] and row["max_abs_diff"] == 0.0
        assert row["efficiency"] is None
        assert row["tfs_per_step"] == 2 * row["world"]
        # the wrappers' plain versions count no launch; one eager step a
        # checked batch
        assert all(r["eager_calls"] == bench_gpu.SCALING_BATCHES
                   and r["graphs"] == [] for r in row["ranks"])
    _no_children()


def test_a_killed_worker_ends_the_run(monkeypatch):
    """A worker killed once it has joined the group makes the parent
    raise well within its timeout, with the workers' stderr, and leaves
    no worker running."""
    procs = []
    real = subprocess.Popen

    def popen(cmd, **kw):
        p = real(cmd, **kw)
        procs.append((p, kw["stderr"].name))
        return p
    monkeypatch.setattr(bench_gpu.subprocess, "Popen", popen)

    def kill_rank_1():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if len(procs) == 2:
                p, err = procs[1]
                with open(err) as f:
                    if "joined" in f.read():
                        p.kill()
                        return
            time.sleep(0.02)
    t = threading.Thread(target=kill_rank_1, daemon=True)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank 1 exited with -9.*rank 1 stderr"):
        bench_gpu.run_hosts(torch, (2,), 1, **dict(RUN, timeout_s=60))
    assert time.monotonic() - t0 < 60
    t.join(timeout=5)
    assert len(procs) == 2 and all(p.poll() is not None for p, _ in procs)
    assert procs[1][0].returncode < 0          # the one killed


def _rank(world, tfs, tf_samples_out, step_ms, device):
    return {"rank": 0, "world": world, "device": device, "backend": "nccl",
            "captured": True, "config": "c", "tfs": tfs,
            "tf_samples_out": tf_samples_out, "out_rate": 0,
            "batch_per_rank": tfs // world, "clock": "cuda events",
            "step_ms": {"median": step_ms}, "slowest_step_ms": step_ms,
            "slowest_host_issue_ms": 0.1, "slowest_nccl_ms_per_step": 0.0,
            "max_abs_diff": 0.0, "diff_over_tol": 0.0, "state_equal": True,
            "elementwise_ok": True, "unsharded_step_ms": None}


@pytest.mark.parametrize("tf_samples_out", [196_608, 393_216])
def test_samples_and_efficiency_are_bench_scalings(tf_samples_out):
    """samples/s and efficiency on given rows: bench_scaling.py's formula
    (:111, 148-151: B * 196608 / dt, samples_per_s / (n * base)) with the
    samples a TF the config emits (x2 at 4.096 MS/s); None where ranks
    share a card."""
    steps = {1: 2.0, 2: 2.1, 4: 2.3}
    rows = [bench_gpu.scaling_row(
        [dict(_rank(n, 24 * n, tf_samples_out, steps[n], f"cuda:{r}"),
              rank=r) for r in range(n)]) for n in steps]
    shared = bench_gpu.scaling_row(
        [dict(_rank(2, 48, tf_samples_out, 2.2, "cuda:0"), rank=r)
         for r in range(2)])
    bench_gpu.with_efficiency(rows + [shared])
    base = None
    for row, n in zip(rows, steps):
        B, dt = 24 * n, steps[n] / 1e3
        jax_sps = B * 196608 / dt
        assert row["jax_tool_samples_per_s"] == pytest.approx(jax_sps)
        assert row["samples_per_s"] == pytest.approx(
            jax_sps * tf_samples_out / 196608)
        base = base or row["samples_per_s"]
        assert row["efficiency"] == pytest.approx(
            row["samples_per_s"] / (n * base))
        assert row["efficiency"] == pytest.approx(steps[1] / steps[n])
    assert shared["efficiency"] is None and "note" in shared
    # --hosts 1,2 --chips-per-host 2: per host, against the 1-host row
    # (bench_scaling.py:222-227: samples_per_s / (hosts * base))
    hosts = bench_gpu.with_efficiency([
        bench_gpu.scaling_row(
            [dict(_rank(2 * h, 48 * h, tf_samples_out, steps[2 * h],
                        f"cuda:{r}"), rank=r) for r in range(2 * h)],
            hosts=h) for h in (1, 2)])
    assert hosts[1]["efficiency"] == pytest.approx(
        hosts[1]["samples_per_s"] / (2 * hosts[0]["samples_per_s"]))


def test_more_ranks_than_cards_raises(monkeypatch):
    """NCCL takes one card a rank: a world or H x C larger than the cards
    raises before any process starts, naming the cards it needs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls = [(lambda: bench_gpu.run_scaling(torch, (1, 2)), 2),
             (lambda: bench_gpu.run_hosts(torch, (1, 2), 2), 4),
             (lambda: bench_gpu.run_collectives(torch, world=4,
                                                backend="nccl"), 4)]
    for call, n in calls:
        with pytest.raises(RuntimeError, match=f"{n} ranks over NCCL need "
                           f"{n} CUDA cards, one a rank; 1 present"):
            call()
    _no_children()


def test_every_multi_rank_path_raises_without_a_card():
    assert not torch.cuda.is_available()
    calls = [
        lambda: bench_gpu.run_scaling(torch, (1,)),
        lambda: bench_gpu.run_hosts(torch, (1,)),
        lambda: bench_gpu.run_collectives(torch),
        lambda: bench_gpu.run_collectives(torch, world=2, backend="gloo"),
        lambda: bench_gpu.main(["--scaling"]),
        lambda: bench_gpu.main(["--scaling", "--hosts", "1"]),
        lambda: bench_gpu.main(["--collectives", "--full"]),
        lambda: bench_gpu.main(["--scaling-worker", "--hosts", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
    _no_children()


# ---------------------------------------------------------------------------
# --collectives and the per-coupling record
# ---------------------------------------------------------------------------

def test_exchange_counts_per_coupling_add_up_to_the_totals():
    """EXCHANGES keeps its totals and, per coupling, the collectives,
    buffer bytes, the last tail's shape and dtype and, when timing, the
    spans; reset clears both."""
    counts = sharding.ExchangeCounts()
    counts.reset(timing=True)
    ti = torch.zeros((15, 9216), dtype=torch.uint8)
    for coupling, tail, nbytes, span in (
            ("time_interleave", ti, 2 * ti.numel(), (0.0, 0.002)),
            ("num_clipped", torch.zeros((), dtype=torch.int32), 8,
             (0.0, 0.001)),
            ("time_interleave", ti, 2 * ti.numel(), (1.0, 1.003))):
        counts._count(coupling, tail, nbytes, span)
    c = counts.couplings
    assert (counts.collectives, counts.buffer_bytes) == (3, 4 * 138240 + 8)
    assert sum(x.collectives for x in c.values()) == counts.collectives
    assert sum(x.buffer_bytes for x in c.values()) == counts.buffer_bytes
    assert (c["time_interleave"].collectives, c["time_interleave"].tail_shape,
            c["time_interleave"].dtype) == (2, (15, 9216), "torch.uint8")
    assert c["num_clipped"].tail_shape == ()
    assert c["time_interleave"].ms() == pytest.approx(5.0)
    assert counts.ms() == pytest.approx(6.0)
    counts.reset()
    assert (counts.collectives, counts.buffer_bytes, counts.spans,
            counts.couplings) == (0, 0, None, {})


@pytest.fixture(scope="module")
def collectives():
    """--collectives at world 2 over gloo on the CPU: "base 2sub" (16
    TFs) and CFR_4M096_S16."""
    rec = bench_gpu.run_collectives(
        torch, world=2, backend="gloo", device="cpu", steps=1, runs=1,
        traced=1, configs=[bench_gpu.COLLECTIVE_CONFIGS[0], CFR_4M096_S16],
        timeout_s=120)
    return {r["config"]: r for r in rec["configs"]}


_COLLECTIVE = re.compile(r"=\s*(.*?)\s+(all-gather|collective-permute|"
                         r"all-reduce|all-to-all|reduce-scatter)"
                         r"(?:-start)?\(")
_BYTES = {"s32": 4, "u32": 4, "f32": 4, "s8": 1, "u8": 1, "pred": 1}


def _hlo_collectives(text) -> list:
    """The collectives of compiled HLO text, each with its result's shape
    (every array's, for a tuple) and bytes (a tuple's summed)."""
    out = []
    for line in text.splitlines():
        m = _COLLECTIVE.search(line)
        if m:
            shapes = [(dt, [int(d) for d in dims.split(",") if d])
                      for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]",
                                                 m.group(1))]
            out.append({"kind": m.group(2),
                        "shape": (shapes[0][1] if len(shapes) == 1
                                  else [s for _, s in shapes]),
                        "bytes": sum(_BYTES[dt] * int(np.prod(s))
                                     for dt, s in shapes)})
    return out


def _jax_step_collectives(world, n_tf=16):
    """The collectives of dabmod_tpu's compiled sharded step at
    make_mesh(world), the 2-sub-channel ensemble, default settings, n_tf
    TFs (measure_ti_collectives.py:92-100)."""
    m = JModulator(j_layout(1, subch_specs=BENCH_SPECS),
                   JSettings(dab_mode=1))
    b = j_parse(j_synth(n_tf * 4, mode=1, subch_specs=BENCH_SPECS))
    sm = jsharding.ShardedModulator(m, jsharding.make_mesh(world))
    fic = sm._put(b.fic)
    subs = tuple(sm._put(x) for x in b.subchannels)
    compiled = sm._step.lower(fic, subs, sm.init_state(), jnp.float32(1.0),
                              jnp.float32(1.0)).compile()
    return _hlo_collectives(compiled.as_text())


@pytest.mark.parametrize("world", [2, 8])
def test_jax_ti_payload_is_the_compiled_steps(world):
    """bench_gpu.jax_ti_payload lists what dabmod_tpu's compiled step
    holds: at world 2 one collective-permute a sub-channel, at world 8 (8
    CIF rows a device, fewer than 15) two, and the tuple all-reduce of the
    new histories with its true bytes (measure_ti_collectives.py reads 0
    there)."""
    hlo = _jax_step_collectives(world)
    want = bench_gpu.jax_ti_payload((3072, 6144), 16 * 4, world)
    assert hlo == want
    assert want[-1]["kind"] == "all-reduce"
    assert want[-1]["bytes"] == 4 * 15 * (3072 + 6144) == 552_960


def test_ti_tail_holds_the_jax_permutes_elements(collectives):
    """At world 2, B=16, each rank's TI tail holds, sub-channel by
    sub-channel, as many elements as the collective-permutes of JAX's
    compiled step ([15, 3072] and [15, 6144]), in one all_reduce; the
    bytes are EXCHANGES' (world x the uint8 tail)."""
    rec = collectives["base 2sub"]
    assert set(rec["couplings"]) == {"time_interleave"}
    ti = rec["couplings"]["time_interleave"]
    permutes = [c["shape"] for c in _jax_step_collectives(2)
                if c["kind"] == "collective-permute"]
    widths = rec["ranks"][0]["subchannel_ti_bits"]
    rows = ti["tail_shape"][0]
    assert ti["tail_shape"] == [rows, sum(widths)]
    assert [[rows, n] for n in widths] == permutes
    assert ti["dtype"] == "torch.uint8" and ti["collectives_per_step"] == 1
    assert ti["buffer_bytes_per_step"] == 2 * ti["tail_elements"]
    assert ti["ring_bytes_per_rank"] == ti["buffer_bytes_per_step"]
    assert ti["same_every_step"]
    assert rec["total_buffer_bytes_per_step"] == 2 * 15 * 9216
    assert rec["mb_per_s_realtime"] == pytest.approx(
        rec["total_buffer_bytes_per_step"] / (16 * 0.096) / 1e6)
    assert rec["jax_ti_payload"] == bench_gpu.jax_ti_payload(
        widths, 16 * 4, 2)


def test_cfr_resampler_and_s16_couplings(collectives):
    """With CFR and s16 words one num_clipped element; at 4.096 MS/s the
    resampler's tail is 2*half input samples of each plane; every rank
    gives the same; the severed step and the eager step both timed."""
    rec = collectives[CFR_4M096_S16[0]]
    m = Modulator(make_default_layout(1, BENCH_SPECS),
                  ModSettings(dab_mode=1, output_rate=4_096_000),
                  device="cpu")
    c = rec["couplings"]
    assert set(c) == {"time_interleave", "resampler", "num_clipped"}
    assert c["num_clipped"]["tail_shape"] == []
    assert c["num_clipped"]["tail_elements"] == 1
    assert c["num_clipped"]["dtype"] == "torch.int32"
    assert c["resampler"]["tail_shape"] == [2, 2 * m._res_plan.half]
    assert c["resampler"]["dtype"] == "torch.float32"
    # 2 TFs a rank: 8 CIF rows of TI tail
    assert c["time_interleave"]["tail_shape"] == [8, 9216]
    assert all(r["couplings"].keys() == c.keys() for r in rec["ranks"])
    assert rec["resampler_route"] == "kernel"
    assert rec["eager_step_ms"] > 0 and rec["severed_eager_ms"] > 0
    assert rec["captured_step_ms"] is None
    assert rec["severed_captured_ms"] is None
    assert rec["note"] == bench_gpu.CPU_NOTE
    _no_children()
