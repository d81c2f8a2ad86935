"""The live traffic's sender, a process of its own (NumPy only): serves the
stream over TCP on a free localhost port, as ODR-DabMux's ETI-over-TCP or
EDI-over-TCP output does, one ETI frame every 24 ms on an absolute
schedule that does not slow when the receiver does.

    python3 generator.py --config C.json --seed N --frames N --kind edi|eti

prints "PORT <port>" once it listens, then reads "GO <t0>" (a
time.monotonic() value) from its standard input and sends frame i at
t0 + 0.024 i.  It ends after the last frame, or when the receiver closes
the connection, and prints one JSON line: {"sent": frames sent, "late_s":
[each sent frame's send time less its due time]}."""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import streams  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--kind", choices=("edi", "eti"), required=True)
    a = ap.parse_args(argv)
    with open(a.config) as f:
        ensemble = [tuple(e) for e in json.load(f)["ensemble"]]
    frames = streams.make_frames(a.seed, a.frames, ensemble)
    if a.kind == "edi":
        packets = [streams.edi_packet(frames[i], i, ensemble, i)
                   for i in range(a.frames)]
    else:
        packets = [frames[i].tobytes() for i in range(a.frames)]
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    print(f"PORT {srv.getsockname()[1]}", flush=True)
    conn, _ = srv.accept()
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    srv.close()
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "GO":
        return 2
    try:
        late = send_on_schedule(packets, float(line[1]), conn.sendall)
    finally:
        conn.close()
    print(json.dumps({"sent": len(late), "late_s": late}), flush=True)
    return 0


def send_on_schedule(packets, t0: float, send, clock=time.monotonic,
                     sleep=time.sleep, period: float = streams.FRAME_S):
    """Send packet i at t0 + i * period, or at once where that time has
    passed: a stall delays the packets due during it, never the schedule
    of those after.  Returns each sent packet's lateness (s); stops when
    the receiver has closed."""
    late = []
    for i, pkt in enumerate(packets):
        due = t0 + i * period
        wait = due - clock()
        if wait > 0:
            sleep(wait)
        try:
            send(pkt)
        except OSError:
            break                         # the receiver closed
        late.append(round(clock() - due, 6))
    return late


if __name__ == "__main__":
    sys.exit(main())
