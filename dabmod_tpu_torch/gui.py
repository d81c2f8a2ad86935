"""Web GUI: a small HTTP server exposing the remote control, live signal
plots and a DPD engine control panel (role of the reference's CherryPy GUI,
python/gui.py + python/gui/api.py:17-163 -- RC parameter browser, DPD
trigger/adapt/reset/results RPC, spectrum/constellation views).

Pages:
  rc      -- parameter browser with setters (RC list/show/set)
  stats   -- modulator statistics snapshot (showjson across modules)
  signal  -- spectrum + pi/4-DQPSK differential constellation computed
             server-side from a TX burst fetched off the DPD feedback port
  dpd     -- start/stop the DPD computation engine, residual trend

Run standalone against a modulator's ZMQ RC:

    python -m dabmod_tpu_torch.gui --rc tcp://localhost:9400 --port 8099 \
        --feedback 127.0.0.1:50055

The port's copy of dabmod_tpu/gui.py.
"""
from __future__ import annotations

import argparse
import collections
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>dabmod-tpu</title>
<style>
 body { font-family: sans-serif; margin: 2em; }
 table { border-collapse: collapse; }
 td, th { border: 1px solid #ccc; padding: 4px 10px; }
 input { width: 8em; }
 nav a { margin-right: 1.2em; }
 canvas { border: 1px solid #ccc; margin-right: 1em; }
 .err { color: #a00; }
</style></head>
<body>
<h1>dabmod-tpu</h1>
<nav>
 <a href="#" onclick="show('rc')">remote control</a>
 <a href="#" onclick="show('stats')">stats</a>
 <a href="#" onclick="show('signal')">signal</a>
 <a href="#" onclick="show('dpd')">dpd</a>
</nav>
<div id="rc">loading...</div>
<div id="stats" style="display:none"></div>
<div id="signal" style="display:none">
  <p><button onclick="grabSignal()">capture burst</button>
     <span id="sigmsg"></span></p>
  <canvas id="spec" width="520" height="260"></canvas>
  <canvas id="const" width="260" height="260"></canvas>
</div>
<div id="dpd" style="display:none">
  <p>
   iterations <input id="dpd_iters" value="10"/>
   model <select id="dpd_kind"><option>poly</option><option>lut</option>
   </select>
   <button onclick="dpdStart()">start</button>
   <button onclick="dpdStop()">stop</button>
   <span id="dpdmsg"></span>
  </p>
  <canvas id="resid" width="520" height="200"></canvas>
  <pre id="dpdlog"></pre>
</div>
<script>
let current = 'rc';
function show(tab) {
  for (const t of ['rc', 'stats', 'signal', 'dpd'])
    document.getElementById(t).style.display = (t === tab) ? '' : 'none';
  current = tab;
  refresh();
}
async function refresh() {
  if (current === 'rc') await refreshRc();
  if (current === 'stats') await refreshStats();
  if (current === 'dpd') await refreshDpd();
}
async function refreshRc() {
  const r = await fetch('/api/rc');
  const mods = await r.json();
  let html = '';
  for (const [mod, params] of Object.entries(mods)) {
    html += `<h2>${mod}</h2><table>`;
    for (const [p, v] of Object.entries(params)) {
      html += `<tr><td>${p}</td><td>${v}</td>
        <td><input id="${mod}.${p}"/>
        <button onclick="setp('${mod}','${p}')">set</button></td></tr>`;
    }
    html += '</table>';
  }
  document.getElementById('rc').innerHTML = html;
}
async function refreshStats() {
  const r = await fetch('/api/stats');
  const mods = await r.json();
  let html = '<h2>modulator statistics</h2><table>';
  for (const [mod, params] of Object.entries(mods))
    for (const [p, v] of Object.entries(params))
      html += `<tr><td>${mod}</td><td>${p}</td><td>${v}</td></tr>`;
  html += '</table>';
  document.getElementById('stats').innerHTML = html;
}
async function setp(mod, p) {
  const v = document.getElementById(mod + '.' + p).value;
  await fetch(`/api/rc/set?controllable=${mod}&param=${p}&value=` +
              encodeURIComponent(v), {method: 'POST'});
  refresh();
}
function plotLine(id, ys, ymin, ymax, color) {
  const c = document.getElementById(id), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  if (!ys || !ys.length) return;
  g.strokeStyle = color; g.beginPath();
  for (let i = 0; i < ys.length; i++) {
    const x = i / (ys.length - 1) * c.width;
    const y = c.height - (ys[i] - ymin) / (ymax - ymin) * c.height;
    if (i === 0) g.moveTo(x, y); else g.lineTo(x, y);
  }
  g.stroke();
}
function plotScatter(id, xs, ys, lim) {
  const c = document.getElementById(id), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  g.fillStyle = '#06c';
  for (let i = 0; i < xs.length; i++) {
    const x = (xs[i] / lim * 0.5 + 0.5) * c.width;
    const y = (0.5 - ys[i] / lim * 0.5) * c.height;
    g.fillRect(x, y, 2, 2);
  }
}
async function grabSignal() {
  document.getElementById('sigmsg').textContent = 'capturing...';
  const r = await fetch('/api/signal');
  const d = await r.json();
  if (d.error) {
    document.getElementById('sigmsg').innerHTML =
      `<span class="err">${d.error}</span>`;
    return;
  }
  document.getElementById('sigmsg').textContent =
    `${d.n_samples} samples @ ${d.sample_rate} S/s`;
  const lo = Math.min(...d.spectrum_db), hi = Math.max(...d.spectrum_db);
  plotLine('spec', d.spectrum_db, lo - 3, hi + 3, '#06c');
  plotScatter('const', d.const_i, d.const_q, d.const_lim);
}
async function dpdStart() {
  const iters = document.getElementById('dpd_iters').value;
  const kind = document.getElementById('dpd_kind').value;
  const r = await fetch(`/api/dpd/start?iterations=${iters}&kind=${kind}`,
                        {method: 'POST'});
  const d = await r.json();
  document.getElementById('dpdmsg').textContent = JSON.stringify(d);
}
async function dpdStop() {
  await fetch('/api/dpd/stop', {method: 'POST'});
}
async function refreshDpd() {
  const r = await fetch('/api/dpd/status');
  const d = await r.json();
  document.getElementById('dpdmsg').textContent =
    d.running ? 'running' : 'idle';
  const resids = d.history.filter(h => 'residual' in h)
                          .map(h => Math.log10(h.residual));
  if (resids.length) {
    plotLine('resid', resids, Math.min(...resids) - 0.2,
             Math.max(...resids) + 0.2, '#c60');
  }
  document.getElementById('dpdlog').textContent =
    d.history.slice(-12).map(JSON.stringify).join('\\n');
}
refresh();
setInterval(refresh, 5000);
</script>
</body></html>
"""

# RC parameters treated as statistics for the stats page (counters and
# measurements, same quantities the reference GUI's stats page shows)
_STAT_PARAMS = ("underruns", "overflows", "late", "frames", "fct",
                "clip_stats", "papr", "mer", "gpsdo_num_sv", "queue")


def compute_signal_view(samples: np.ndarray, sample_rate: int,
                        fft_size: int = 2048, n_points: int = 512):
    """Spectrum (averaged periodogram, dB) + pi/4-DQPSK differential
    constellation from a burst of complex samples (the role of the
    reference's doc/time-freq-plot.py and python/dpd/old/show_spectrum.py)."""
    x = np.asarray(samples, np.complex64)
    n_blocks = max(1, min(32, x.size // fft_size))
    blocks = x[:n_blocks * fft_size].reshape(n_blocks, fft_size)
    win = np.hanning(fft_size).astype(np.float32)
    spec = np.fft.fftshift(
        np.mean(np.abs(np.fft.fft(blocks * win, axis=1)) ** 2, axis=0))
    spec_db = 10.0 * np.log10(np.maximum(spec, 1e-12))
    spec_db -= spec_db.max()
    # decimate for display (max-pool keeps spectral peaks visible)
    step = max(1, fft_size // n_points)
    spec_db = spec_db[:fft_size // step * step].reshape(-1, step).max(axis=1)

    # differential constellation: carrier-wise product of consecutive FFT
    # blocks; pi/4-DQPSK collapses into 4 clusters even without symbol sync
    f = np.fft.fft(blocks, axis=1)
    mag = np.abs(f).mean(axis=0)
    used = mag > (mag.max() * 0.3)
    z = (f[1:, used] * np.conj(f[:-1, used])).ravel()
    if z.size:
        z = z / (np.abs(z).mean() or 1.0)
        z = z[:4096]
    lim = 3.0
    return {
        "sample_rate": sample_rate,
        "n_samples": int(x.size),
        "spectrum_db": [round(float(v), 2) for v in spec_db],
        "const_i": [round(float(v), 3) for v in z.real],
        "const_q": [round(float(v), 3) for v in z.imag],
        "const_lim": lim,
    }


class DpdPanel:
    """Background DPD engine runner for the GUI (the reference drives the
    separate dpdce.py process over YAML-RPC, python/gui/api.py:96-163;
    here the engine runs in-process on demand)."""

    def __init__(self, rc_endpoint: str, feedback_host: str,
                 feedback_port: int):
        self.rc_endpoint = rc_endpoint
        self.feedback = (feedback_host, feedback_port)
        self.history = collections.deque(maxlen=200)
        self._thread = None
        self._stop = threading.Event()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, iterations: int, kind: str) -> bool:
        if self.running or not self.feedback[1]:
            return False
        from .dpd.dpdce import run_engine
        self._stop.clear()

        def work():
            try:
                run_engine(self.rc_endpoint, self.feedback[0],
                           self.feedback[1], iterations=iterations,
                           model_kind=kind, status_cb=self.history.append,
                           stop_event=self._stop)
            except Exception as e:              # noqa: BLE001
                self.history.append({"state": "error", "error": str(e)})

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def stop(self):
        self._stop.set()


class RemoteDpdPanel:
    """Drives a separate `dpdce --control-port` service over yamlrpc --
    the reference's GUI<->DPDCE process split (python/gui/api.py:52,96-163).
    Same surface as DpdPanel so make_handler doesn't care which it got."""

    def __init__(self, dpdce_port: int):
        self.dpdce_port = dpdce_port
        self.history = collections.deque(maxlen=200)
        self._thread = None
        self._stop = threading.Event()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, iterations: int, kind: str) -> bool:
        if self.running:
            return False
        from .rc.yamlrpc import ResponseError, Socket
        self._stop.clear()

        def work():
            cli = Socket(0, timeout=5.0)
            try:
                res = cli.call_rpc_method(self.dpdce_port, "get_results", {})
                seq = res.get("seq", 0)
                # the service's model is fixed at its startup (--model);
                # surface a mismatch instead of silently training the
                # other model
                if res.get("model") and res["model"] != kind:
                    self.history.append({
                        "state": "error",
                        "error": f"dpdce service runs model "
                                 f"'{res['model']}', not '{kind}' -- "
                                 f"restart it with --model {kind}"})
                    return
                for _ in range(iterations):
                    if self._stop.is_set():
                        break
                    cli.call_rpc_method(self.dpdce_port, "trigger_run", {})
                    # wait until the service publishes a fresh Idle result
                    # (success or failure) for this command
                    for _ in range(600):
                        res = cli.call_rpc_method(self.dpdce_port,
                                                  "get_results", {})
                        if res.get("seq", 0) > seq \
                                and res.get("state") == "Idle":
                            seq = res["seq"]
                            self.history.append(res)
                            break
                        if self._stop.is_set():
                            break
                        time.sleep(0.1)
            except (ResponseError, TimeoutError, OSError, ValueError) as e:
                self.history.append({"state": "error", "error": str(e)})
            finally:
                cli.close()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def stop(self):
        self._stop.set()


def make_handler(rc, dpd_panel: DpdPanel | None = None,
                 feedback: tuple[str, int] | None = None,
                 sample_rate: int = 2_048_000):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _rc_snapshot(self, stats_only: bool):
            out = {}
            for mod in rc.get_modules():
                params = rc.show(mod)
                if stats_only:
                    params = {p: v for p, v in params.items()
                              if any(s in p for s in _STAT_PARAMS)}
                if params:
                    out[mod] = params
            return out

        def do_GET(self):
            try:
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, _PAGE, "text/html")
                elif self.path.startswith("/api/stats"):
                    self._send(200, json.dumps(self._rc_snapshot(True)))
                elif self.path.startswith("/api/rc"):
                    self._send(200, json.dumps(self._rc_snapshot(False)))
                elif self.path.startswith("/api/signal"):
                    if not feedback or not feedback[1]:
                        self._send(503, json.dumps(
                            {"error": "no DPD feedback port configured"}))
                        return
                    from .dpd.measure import Measure
                    meas = Measure(feedback[0], feedback[1], 32768)
                    tx, _, _, _ = meas.get_samples()
                    self._send(200, json.dumps(
                        compute_signal_view(tx, sample_rate)))
                elif self.path.startswith("/api/dpd/status"):
                    if dpd_panel is None:
                        self._send(503, json.dumps(
                            {"error": "no DPD panel"}))
                        return
                    self._send(200, json.dumps(
                        {"running": dpd_panel.running,
                         "history": list(dpd_panel.history)}))
                else:
                    self._send(404, "{}")
            except Exception as e:              # noqa: BLE001
                self._send(500, json.dumps({"error": str(e)}))

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(parsed.query)
            try:
                if parsed.path == "/api/rc/set":
                    rc.set_param_value(q["controllable"][0], q["param"][0],
                                       q["value"][0])
                    self._send(200, '{"ok": true}')
                elif parsed.path == "/api/dpd/start":
                    if dpd_panel is None:
                        self._send(503, json.dumps(
                            {"error": "no DPD panel"}))
                        return
                    ok = dpd_panel.start(
                        int(q.get("iterations", ["10"])[0]),
                        q.get("kind", ["poly"])[0])
                    self._send(200, json.dumps({"ok": ok}))
                elif parsed.path == "/api/dpd/stop":
                    if dpd_panel is not None:
                        dpd_panel.stop()
                    self._send(200, '{"ok": true}')
                else:
                    self._send(404, "{}")
            except Exception as e:              # noqa: BLE001
                self._send(500, json.dumps({"error": str(e)}))

        def log_message(self, fmt, *args):      # quiet
            pass

    return Handler


def serve(rc_endpoint: str, port: int, feedback: str = "",
          sample_rate: int = 2_048_000, dpdce_port: int = 0):
    from .rc.client import ModRemoteControl
    rc = ModRemoteControl(rc_endpoint)
    fb = None
    panel = None
    if feedback:
        host, fport = feedback.rsplit(":", 1)
        fb = (host or "127.0.0.1", int(fport))
        panel = DpdPanel(rc_endpoint, fb[0], fb[1])
    if dpdce_port:
        # reference-style split: the GUI drives a separate dpdce service
        panel = RemoteDpdPanel(dpdce_port)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", port),
        make_handler(rc, panel, fb, sample_rate))
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rc", default="tcp://localhost:9400")
    ap.add_argument("--port", type=int, default=8099)
    ap.add_argument("--feedback", default="",
                    help="host:port of the modulator's DPD feedback server")
    ap.add_argument("--sample-rate", type=int, default=2_048_000)
    ap.add_argument("--dpdce-port", type=int, default=0,
                    help="drive a separate `dpdce --control-port` service "
                         "over yamlrpc instead of the in-process engine")
    args = ap.parse_args(argv)
    httpd = serve(args.rc, args.port, args.feedback, args.sample_rate,
                  args.dpdce_port)
    print(f"GUI on http://127.0.0.1:{args.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
