"""The port's web GUI, event publisher, yamlrpc transport and DPDCE
control service (dabmod_tpu_torch/gui.py, events.py, rc/yamlrpc.py and
dpd/server.py, copies of dabmod_tpu's): the cases of
tests/test_gui_events.py and tests/test_yamlrpc.py, run on the port's
copies, with ephemeral ports so that they run beside the originals; and
the malformed-datagram path of the port's yamlrpc, which imports yaml
where it parses (the one difference from dabmod_tpu/rc/yamlrpc.py).

Wire format per the reference's python/lib/yamlrpc.py; service command
surface per python/dpdce.py:411-440.
"""
import json
import os
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import yaml

from dabmod_tpu.rc import yamlrpc as j_yamlrpc
from dabmod_tpu_torch.dpd.server import DpdceServer
from dabmod_tpu_torch.rc import yamlrpc
from live_stream import free_port


# ------------------------------------------------------------------ GUI
class _LocalRc:
    """Adapter matching the ModRemoteControl client interface."""

    def __init__(self, reg):
        self.reg = reg

    def get_modules(self):
        return self.reg.list_modules()

    def show(self, module):
        return dict(self.reg.show(module))

    def set_param_value(self, module, param, value):
        self.reg.set_param(module, param, value)


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def test_gui_rc_roundtrip():
    from dabmod_tpu_torch.gui import make_handler
    from dabmod_tpu_torch.rc import RemoteControllable, RemoteControllers

    reg = RemoteControllers()
    c = RemoteControllable("gain")
    state = {"digital": 1.0}
    c.add_parameter("digital", "Digital Gain", lambda: state["digital"],
                    lambda v: state.__setitem__("digital", float(v)))
    reg.enrol(c)

    httpd, port = _serve(make_handler(_LocalRc(reg)))
    try:
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=5).read()
        assert b"dabmod-tpu" in page
        data = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/rc", timeout=5).read())
        assert data == {"gain": {"digital": "1.0"}}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/rc/set?controllable=gain"
            f"&param=digital&value=2.5", method="POST")
        urllib.request.urlopen(req, timeout=5)
        assert state["digital"] == 2.5
    finally:
        httpd.shutdown()


def test_event_sender_pubsub():
    zmq = pytest.importorskip("zmq")
    from dabmod_tpu_torch.events import EventSender

    ep = f"tcp://127.0.0.1:{free_port()}"
    sender = EventSender()
    sender.bind(ep)
    ctx = zmq.Context.instance()
    sub = ctx.socket(zmq.SUB)
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    sub.setsockopt(zmq.RCVTIMEO, 5000)
    sub.connect(ep)
    time.sleep(0.3)   # late-joiner grace
    sender.send("underrun", {"count": 3})
    name, payload = sub.recv_multipart()
    assert name == b"underrun"
    assert json.loads(payload) == {"count": 3}
    sub.close()
    sender.close()


def test_gui_stats_signal_and_dpd_panel():
    """Stats filter, spectrum/constellation endpoint against a live
    feedback server, and the DPD control panel start/status cycle."""
    from dabmod_tpu_torch.gui import DpdPanel, make_handler
    from dabmod_tpu_torch.io.sdr import DpdFeedbackServer, LoopbackSdrDevice
    from dabmod_tpu_torch.rc import (RemoteControllable, RemoteControllers,
                                     rcs)
    from dabmod_tpu_torch.timestamps import FrameTimestamp

    reg = RemoteControllers()
    c = RemoteControllable("sdr")
    state = {"underruns": 3, "txgain": 10.0}
    c.add_parameter("underruns", "underrun count",
                    lambda: state["underruns"], None)
    c.add_parameter("txgain", "TX gain", lambda: state["txgain"],
                    lambda v: state.__setitem__("txgain", float(v)))
    reg.enrol(c)

    # feedback server fed with a GI-less pi/4-DQPSK OFDM TX burst (16
    # symbols of 2048 bins, 512 active carriers)
    dev = LoopbackSdrDevice()
    server = DpdFeedbackServer(dev, port=0, sample_rate=2_048_000)
    rng = np.random.default_rng(0)
    n_sym, n_car = 16, 512
    q = rng.integers(0, 4, (n_sym, n_car)) * 2 + 1
    spec = np.zeros((n_sym, 2048), np.complex64)
    spec[:, 1:n_car + 1] = np.exp(1j * np.pi / 4 * np.cumsum(q, axis=0))
    tx = np.fft.ifft(spec, axis=1).ravel().astype(np.complex64)
    iq = np.stack([tx.real, tx.imag], axis=-1).astype(np.float32)
    ts = FrameTimestamp(valid=True, seconds=500, pps=0)
    dev.transmit_frame(iq, ts)
    stop_feed = threading.Event()

    def feeder():
        while not stop_feed.is_set():
            server.set_tx_frame(iq, ts)
            time.sleep(0.02)

    threading.Thread(target=feeder, daemon=True).start()

    # zmq RC so the DPD panel's Adapt can connect (poly controllable)
    pytest.importorskip("zmq")
    pstate = {"coeffile": ""}
    poly_rc = RemoteControllable("poly")
    poly_rc.add_parameter("coeffile", "coef file",
                          lambda: pstate["coeffile"],
                          lambda v: pstate.__setitem__("coeffile", v))
    rcs.enrol(poly_rc)
    ep = f"tcp://127.0.0.1:{free_port()}"
    rcs.add_zmq(ep)

    panel = DpdPanel(ep, "127.0.0.1", server.port)
    httpd, port = _serve(make_handler(_LocalRc(reg), panel,
                                      ("127.0.0.1", server.port)))
    try:
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/stats", timeout=5).read())
        assert stats == {"sdr": {"underruns": "3"}}

        sig = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/signal", timeout=10).read())
        assert len(sig["spectrum_db"]) >= 256
        assert len(sig["const_i"]) > 100
        # differential constellation should cluster on the 4 odd-eighth
        # turns: no point near angle 0
        ang = np.angle(np.asarray(sig["const_i"])
                       + 1j * np.asarray(sig["const_q"]))
        dist = np.abs(ang % (np.pi / 2) - np.pi / 4)
        assert float(np.median(dist)) < 0.2

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/dpd/start?iterations=2&kind=poly",
            method="POST")
        assert json.loads(urllib.request.urlopen(req, timeout=5).read())["ok"]
        deadline = time.time() + 20
        while time.time() < deadline:
            st = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/dpd/status", timeout=5).read())
            if not st["running"] and st["history"]:
                break
            time.sleep(0.2)
        assert st["history"], "DPD engine reported no iterations"
    finally:
        stop_feed.set()
        httpd.shutdown()
        server.stop()
        rcs.shutdown()
        rcs.remove("poly")


# ------------------------------------------------------------ wire format
def test_request_wire_format():
    data = yamlrpc.request(7, "get_results", {"a": 1})
    y = yaml.safe_load(data.decode())
    assert y == {"yamlrpc": "2.0", "method": "get_results",
                 "params": {"a": 1}, "id": 7}
    assert data == j_yamlrpc.request(7, "get_results", {"a": 1})


def test_response_wire_formats():
    ok = yaml.safe_load(yamlrpc.response_success(3, [1, 2]).decode())
    assert ok == {"yamlrpc": "2.0", "result": [1, 2], "id": 3}
    err = yaml.safe_load(yamlrpc.response_error(4, "nope").decode())
    assert err == {"yamlrpc": "2.0", "error": "nope", "id": 4}
    note = yaml.safe_load(yamlrpc.notification("ping", None).decode())
    assert note == {"yamlrpc": "2.0", "method": "ping", "params": None}


@pytest.mark.parametrize("data", [b"{unclosed: [", b"- a list\n",
                                  b"yamlrpc: '1.0'\nid: 1\n"])
def test_malformed_datagram_raises_value_error(data):
    """_parse imports yaml itself (the port's difference from dabmod_tpu);
    a malformed, foreign or wrong-version datagram still raises the
    ValueError the serve loops catch, with dabmod_tpu's message."""
    with pytest.raises(ValueError) as got:
        yamlrpc._parse(data)
    with pytest.raises(ValueError) as want:
        j_yamlrpc._parse(data)
    assert str(got.value) == str(want.value)


def test_socket_roundtrip_and_errors():
    srv = yamlrpc.Socket(bind_port=0, timeout=0.5)
    cli = yamlrpc.Socket(bind_port=0, timeout=2.0)
    try:
        msg_id = cli.send_request(srv.port, "echo", {"x": 1})
        addr, rid, method, params = srv.receive_request()
        assert (rid, method, params) == (msg_id, "echo", {"x": 1})
        srv.send_success_response(addr, rid, {"x": 1})
        assert cli.receive_response(msg_id) == {"x": 1}

        # error responses raise ResponseError on the client
        msg_id = cli.send_request(srv.port, "bad", None)
        addr, rid, _, _ = srv.receive_request()
        srv.send_error_response(addr, rid, "request not understood")
        with pytest.raises(yamlrpc.ResponseError, match="not understood"):
            cli.receive_response(msg_id)

        # mismatched response id is rejected
        msg_id = cli.send_request(srv.port, "echo", None)
        addr, rid, _, _ = srv.receive_request()
        srv.send_success_response(addr, rid + 1000, None)
        with pytest.raises(ValueError, match="id does not match"):
            cli.receive_response(msg_id)
    finally:
        srv.close()
        cli.close()


def test_socket_timeout():
    cli = yamlrpc.Socket(bind_port=0, timeout=0.2)
    try:
        with pytest.raises(TimeoutError):
            cli.receive_response(1)
    finally:
        cli.close()


# ----------------------------------------------------------- DPDCE service
class FakeMeasure:
    """Synthetic feedback: a weakly compressive PA over a noise burst."""

    def __init__(self, n=8192, seed=0):
        self.n = n
        self.rng = np.random.default_rng(seed)

    def get_samples(self):
        tx = (self.rng.standard_normal(self.n)
              + 1j * self.rng.standard_normal(self.n)).astype(np.complex64)
        tx *= 0.25 / np.abs(tx).max()
        a = np.abs(tx)
        rx = tx * (1.0 - 0.3 * a ** 2)        # AM/AM compression
        return tx, None, rx.astype(np.complex64), None


class FakeAdapt:
    def __init__(self):
        self.pushed = []

    def set_predistorter(self, data):
        self.pushed.append(data)


def _wait(cli, port, pred, timeout=8.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        res = cli.call_rpc_method(port, "get_results", {})
        if pred(res):
            return res
        time.sleep(0.05)
    raise AssertionError(f"timed out; last results: {res}")


@pytest.fixture
def service(tmp_path):
    adapt = FakeAdapt()
    srv = DpdceServer(0, measure=FakeMeasure(), adapt=adapt,
                      dump_dir=str(tmp_path))
    cli = yamlrpc.Socket(bind_port=0, timeout=2.0)
    yield srv, cli, adapt
    cli.close()
    srv.stop()


def test_service_trigger_run_and_results(service):
    srv, cli, adapt = service
    res = cli.call_rpc_method(srv.port, "get_results", {})
    assert res["state"] == "Idle"
    assert cli.call_rpc_method(srv.port, "trigger_run", {}) is None
    res = _wait(cli, srv.port,
                lambda r: r.get("iteration") == 0 and r["state"] == "Idle")
    assert res["residual"] is not None and res["bins"] >= 8
    assert len(adapt.pushed) == 1
    # the fitted AM/AM polynomial must react to the synthetic compression
    assert res["coefs_am"][0] != 1.0 or any(c != 0 for c in
                                            res["coefs_am"][1:])


def test_service_reset_and_adapt(service):
    srv, cli, adapt = service
    cli.call_rpc_method(srv.port, "trigger_run", {})
    _wait(cli, srv.port, lambda r: r.get("iteration") == 0)
    cli.call_rpc_method(srv.port, "reset", {})
    res = _wait(cli, srv.port,
                lambda r: "Reset to identity model" in r["summary"])
    assert res["iteration"] == 0
    # reset pushes the identity predistorter (run + reset = 2 pushes)
    assert len(adapt.pushed) == 2
    cli.call_rpc_method(srv.port, "adapt", {})
    _wait(cli, srv.port,
          lambda r: "Pushed current model" in r["summary"])
    assert len(adapt.pushed) == 3


def test_service_restore_dump(service):
    srv, cli, adapt = service
    cli.call_rpc_method(srv.port, "trigger_run", {})
    res = _wait(cli, srv.port, lambda r: r.get("iteration") == 0)
    dump_id = res["last_dump_id"]
    cli.call_rpc_method(srv.port, "restore_dump", {"dump_id": dump_id})
    res = _wait(cli, srv.port,
                lambda r: r.get("restored_dump") == str(dump_id))
    assert any("restored dump" in s for s in res["summary"])


def test_service_calibrate(service):
    srv, cli, adapt = service
    cli.call_rpc_method(srv.port, "calibrate", {})
    res = _wait(cli, srv.port, lambda r: "calibration" in r)
    assert res["calibration"]["rx_tx_gain"] == pytest.approx(1.0, abs=0.2)
    assert abs(res["calibration"]["phase_deg"]) < 5.0


def test_service_unknown_method(service):
    srv, cli, adapt = service
    with pytest.raises(yamlrpc.ResponseError, match="not understood"):
        cli.call_rpc_method(srv.port, "frobnicate", {})


def test_gui_remote_dpd_panel(service):
    """The GUI's RemoteDpdPanel drives the service like the reference GUI
    drives dpdce (python/gui/api.py:96-163)."""
    from dabmod_tpu_torch.gui import RemoteDpdPanel
    srv, cli, adapt = service
    panel = RemoteDpdPanel(srv.port)
    assert panel.start(iterations=2, kind="poly")
    deadline = time.time() + 15
    while time.time() < deadline and len(panel.history) < 2:
        time.sleep(0.1)
    panel.stop()
    assert len(panel.history) >= 2
    assert [h["iteration"] for h in list(panel.history)[:2]] == [0, 1]
    assert all(h["state"] == "Idle" for h in panel.history)
    assert len(adapt.pushed) >= 2


def test_service_dump_pruning(tmp_path):
    adapt = FakeAdapt()
    srv = DpdceServer(0, measure=FakeMeasure(), adapt=adapt,
                      dump_dir=str(tmp_path))
    srv.DUMPS_KEPT = 3
    cli = yamlrpc.Socket(bind_port=0, timeout=2.0)
    try:
        for i in range(5):
            cli.call_rpc_method(srv.port, "trigger_run", {})
            _wait(cli, srv.port, lambda r, i=i: r.get("iteration") == i)
        dumps = [f for f in os.listdir(tmp_path) if f.startswith("dpdce_")]
        assert len(dumps) == 3
    finally:
        cli.close()
        srv.stop()


def test_service_refuses_a_dump_id_outside_its_directory(service):
    """_dump_path's check against path traversal is kept: restore_dump of
    an id that is not a millisecond timestamp publishes a failure and
    reads nothing."""
    srv, cli, adapt = service
    cli.call_rpc_method(srv.port, "restore_dump",
                        {"dump_id": "../../etc/passwd"})
    res = _wait(cli, srv.port, lambda r: any(
        "restore_dump failed" in s for s in r["summary"]))
    assert "invalid dump id" in res["summary"][-1]
    assert "restored_dump" not in res
    with pytest.raises(ValueError, match="invalid dump id"):
        srv._dump_path("1/../2")
