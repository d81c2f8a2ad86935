"""The live traffic's schedule, the latency it is measured from, the TF
log of the sinks, and the streams the generator sends."""
import json
import subprocess
import sys
import time

import numpy as np

from conftest import BENCH

import cell
import generator
import streams
from sinks import TfLog


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def test_schedule_stays_absolute_when_the_consumer_stalls():
    """A send that blocks 0.5 s delays the frames due meanwhile; they go
    out at once after it, and the frames after them at their own due
    times: the schedule never slides."""
    clock = FakeClock()
    sent = []

    def send(pkt):
        sent.append((pkt, clock.t))
        if pkt == 5:
            clock.t += 0.5                 # the receiver stops reading

    late = generator.send_on_schedule(list(range(60)), 10.0, send,
                                      clock=clock, sleep=clock.sleep)
    due = [10.0 + i * streams.FRAME_S for i in range(60)]
    at = [t for _, t in sent]
    assert at[:6] == due[:6]
    stalled = [i for i in range(6, 60) if at[i] > due[i]]
    assert stalled == list(range(6, 6 + len(stalled))) and stalled
    assert all(at[i] == at[6] for i in stalled)     # a burst, at once
    after = stalled[-1] + 1
    assert at[after:] == due[after:]
    assert max(late) >= 0.5 - 1e-9 and late[-1] == 0.0


def test_schedule_stops_when_the_receiver_closes():
    def send(pkt):
        if pkt == 3:
            raise BrokenPipeError
    clock = FakeClock()
    assert len(generator.send_on_schedule(list(range(9)), 0.0, send,
                                          clock=clock,
                                          sleep=clock.sleep)) == 3


def test_latency_runs_from_the_due_time_of_the_tfs_last_frame():
    t0, period = 100.0, 0.024

    def due(tf):
        return t0 + (4 * tf + 3) * period
    # TF k reaches the radio 8 ms after its last frame was due, TF 5 late
    arrivals = [(k, due(k) + 0.008 + (0.5 if k == 5 else 0.0))
                for k in range(10)] + [(5, 999.0)]
    lat = cell.latencies_ms(arrivals, due, 2, 8)
    assert len(lat) == 6
    np.testing.assert_allclose(lat[:5], 8.0, atol=1e-6)
    assert abs(lat[-1] - 508.0) < 1e-6


def test_tf_log_unwraps_fct_and_counts_losses():
    log = TfLog(4, keep=3, seed=1)
    log.in_window = lambda tf, t: True
    x = np.zeros((24, 2))
    log.add_batch(0, 24, 1.0, np.zeros((24, 8)))       # TFs 0-23
    log.add_batch(96 % 250, 10, 2.0, np.zeros((10, 8)))  # 24-33
    log.add(144 % 250, 3.0, x)                          # TF 36: 2 lost
    log.add(148 % 250, 3.1, x)
    for k in range(38, 70):                             # past FCT 249
        log.add((4 * k) % 250, 4.0, x)
    tfs = [tf for tf, _ in log.arrivals]
    assert tfs == list(range(34)) + list(range(36, 70))
    assert log.lost == [(136, 8)] and log.lost_frames() == 8
    assert log.lost_frames(0, 140) == 4 and log.disorder == 0
    assert len(log.sample) == 3 and log.seen_in_window == len(tfs)


def test_tf_log_sample_is_seeded():
    def run(seed):
        log = TfLog(4, keep=5, seed=seed)
        log.in_window = lambda tf, t: tf >= 10
        for k in range(200):
            log.add((4 * k) % 250, float(k), np.full(4, k))
        return sorted(log.sample)
    assert run(3) == run(3) and run(3) != run(4)
    assert all(tf >= 10 for tf in run(3))


def test_make_frames_is_prefix_stable_and_well_formed():
    ens = [(0, 24, 0x22), (48, 48, 0x02)]
    a = streams.make_frames(2**31 + 5, 300, ens)
    b = streams.make_frames(2**31 + 5, 700, ens)
    np.testing.assert_array_equal(a, b[:300])
    assert list(a[:, 4][:5]) == [0, 1, 2, 3, 4] and a[250, 4] == 0
    assert list((a[:10, 6] >> 5)) == [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]
    from reference.chain import parse_eti
    fct, fp, mid, fic, subs = parse_eti(a)
    assert mid == 1 and [s[1].shape[1] for s in subs] == [192, 384]


def test_generator_serves_edi_that_the_port_decodes():
    """The generator process on a localhost port, its AF packets read by
    the port's EdiInput back into the same ETI payloads."""
    from dabmod_tpu_torch.io.edi import EdiInput
    cfg = f"{BENCH}/configs/r17_s16.json"
    proc = subprocess.Popen(
        [sys.executable, f"{BENCH}/generator.py", "--config", cfg,
         "--seed", "9", "--frames", "8", "--kind", "edi"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline().split()[1])
        inp = EdiInput(f"tcp://127.0.0.1:{port}")
        proc.stdin.write(f"GO {time.monotonic()!r}\n")
        proc.stdin.flush()
        got = np.concatenate([inp.read_batch(4), inp.read_batch(4)])
        inp.close()
        report = json.loads(proc.stdout.readline())
    finally:
        proc.kill()
        proc.wait()
    with open(cfg) as f:
        ens = [tuple(e) for e in json.load(f)["ensemble"]]
    want = streams.make_frames(9, 8, ens)
    off = 8 + 4 * len(ens) + 4
    n = 96 + sum(8 * stl for _, stl, _ in ens)
    np.testing.assert_array_equal(got[:, off:off + n], want[:, off:off + n])
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    assert report["sent"] == 8
