"""Remote-control plane: parameter registry + telnet and ZMQ-REP frontends.

Mirror of lib/RemoteControl.{h,cpp}: every controllable module enrols named
parameters in a global registry `rcs`; a telnet line server (human) and a ZMQ
REP socket (machine, same grammar: ping/list/show/showjson/get/set) mutate
them at runtime.

The port's copy of dabmod_tpu/rc/__init__.py.  Its `rcs` is a registry of
its own, apart from dabmod_tpu's, so the two packages can run side by side
in one process.
"""
from __future__ import annotations

import json
import logging
import socketserver
import threading

log = logging.getLogger("dabmod_tpu_torch.rc")


class ParameterError(Exception):
    pass


class RemoteControllable:
    """Base for modules exposing RC parameters.

    Subclasses call add_parameter(name, help, getter, setter); read-only
    parameters pass setter=None.
    """

    def __init__(self, name: str):
        self._rc_name = name
        self._params: dict[str, tuple[str, object, object]] = {}

    @property
    def rc_name(self) -> str:
        return self._rc_name

    def add_parameter(self, name: str, help_text: str, getter, setter=None):
        self._params[name] = (help_text, getter, setter)

    def parameter_descriptions(self):
        return [(n, h) for n, (h, _, _) in self._params.items()]

    def get_parameter(self, name: str) -> str:
        if name not in self._params:
            raise ParameterError(
                f"Parameter '{name}' is not exported by controllable "
                f"{self._rc_name}")
        _, getter, _ = self._params[name]
        return str(getter())

    def set_parameter(self, name: str, value: str):
        if name not in self._params:
            raise ParameterError(
                f"Parameter '{name}' is not exported by controllable "
                f"{self._rc_name}")
        _, _, setter = self._params[name]
        if setter is None:
            raise ParameterError(f"Parameter '{name}' is read-only")
        setter(value)

    def get_all_values(self) -> dict:
        out = {}
        for n, (_, getter, _) in self._params.items():
            try:
                out[n] = getter()
            except Exception as e:      # noqa: BLE001 - report, don't crash
                out[n] = f"error: {e}"
        return out


class RemoteControllers:
    """Global registry (the reference's singleton `rcs`, lib/Globals.cpp:36)."""

    def __init__(self):
        self.controllables: list[RemoteControllable] = []
        self._servers: list = []

    def enrol(self, c: RemoteControllable):
        self.remove(c.rc_name)
        self.controllables.append(c)

    def remove(self, name: str):
        self.controllables = [c for c in self.controllables
                              if c.rc_name != name]

    def _find(self, name: str) -> RemoteControllable:
        for c in self.controllables:
            if c.rc_name == name:
                return c
        raise ParameterError(f"Module '{name}' not found")

    def get_param(self, module: str, param: str) -> str:
        return self._find(module).get_parameter(param)

    def set_param(self, module: str, param: str, value: str):
        self._find(module).set_parameter(param, value)

    def list_modules(self):
        return [c.rc_name for c in self.controllables]

    def show(self, module: str):
        c = self._find(module)
        return [(n, c.get_parameter(n)) for n, _ in
                c.parameter_descriptions()]

    def show_json(self, module: str) -> str:
        return json.dumps({module: self._find(module).get_all_values()})

    # ------------------------------------------------------------------
    def add_telnet(self, port: int):
        srv = TelnetRC(self, port)
        srv.start()
        self._servers.append(srv)
        return srv

    def add_zmq(self, endpoint: str):
        srv = ZmqRC(self, endpoint)
        srv.start()
        self._servers.append(srv)
        return srv

    def shutdown(self):
        for s in self._servers:
            s.stop()
        self._servers.clear()

    def check_faults(self):
        """Restart dead server threads (ref: src/DabMod.cpp:719-723,
        lib/RemoteControl.cpp restart path)."""
        for s in self._servers:
            if not s.alive():
                log.warning("RC server %s died; restarting", s)
                s.stop()
                s.start()


rcs = RemoteControllers()


HELP_TEXT = (
    "The following commands are supported:\n"
    "  list\n"
    "    * Lists the modules that are loaded and their parameters\n"
    "  show MODULE\n"
    "    * Lists all parameters and their values from module MODULE\n"
    "  get MODULE PARAMETER\n"
    "    * Gets the value for the specified PARAMETER from module MODULE\n"
    "  set MODULE PARAMETER VALUE\n"
    "    * Sets the value for the PARAMETER ofr module MODULE\n"
    "  quit\n"
    "    * Terminate this session\n"
    "\n")


def dispatch_line(registry: RemoteControllers, line: str) -> tuple[str, bool]:
    """Telnet command dispatch (ref: lib/RemoteControl.cpp:288-390).
    Returns (reply, keep_session)."""
    cmd = line.split()
    if not cmd:
        return "", True
    if cmd[0] == "help":
        return HELP_TEXT, True
    if cmd[0] == "list":
        if len(cmd) != 1:
            return "Too many arguments for command 'list'", True
        out = []
        for c in registry.controllables:
            out.append(c.rc_name)
            for n, h in c.parameter_descriptions():
                out.append(f"\t{n} : {h}")
        return "\n".join(out) + "\n", True
    if cmd[0] == "show":
        if len(cmd) != 2:
            return "Incorrect parameters for command 'show'", True
        try:
            return "".join(f"{n}: {v}\n"
                           for n, v in registry.show(cmd[1])), True
        except ParameterError as e:
            return str(e), True
    if cmd[0] == "get":
        if len(cmd) != 3:
            return "Incorrect parameters for command 'get'", True
        try:
            return registry.get_param(cmd[1], cmd[2]), True
        except ParameterError as e:
            return str(e), True
    if cmd[0] == "set":
        if len(cmd) >= 4:
            try:
                registry.set_param(cmd[1], cmd[2], " ".join(cmd[3:]))
                return "ok", True
            except ParameterError as e:
                return str(e), True
            except Exception:               # noqa: BLE001
                return "Error: Invalid parameter value. ", True
        return "Incorrect parameters for command 'set'", True
    if cmd[0] == "quit":
        return "Goodbye", False
    return "Message not understood", True


class TelnetRC:
    """Line-oriented RC server on localhost (ref: lib/RemoteControl.cpp:288)."""

    def __init__(self, registry: RemoteControllers, port: int):
        self.registry = registry
        self.port = port
        self._server = None
        self._thread = None

    def start(self):
        registry = self.registry

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                self.wfile.write(b"Enter 'help' for help\r\n")
                while True:
                    line = self.rfile.readline()
                    if not line:
                        break
                    reply, keep = dispatch_line(
                        registry, line.decode("utf-8", "replace").strip())
                    self.wfile.write(reply.encode() + b"\r\n")
                    if not keep:
                        break

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("127.0.0.1", self.port), Handler)
        if self.port == 0:
            self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="rc-telnet")
        self._thread.start()

    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class ZmqRC:
    """ZMQ REP frontend (ref: lib/RemoteControl.cpp:497-590,
    doc/README-RC.md:37-62)."""

    def __init__(self, registry: RemoteControllers, endpoint: str):
        self.registry = registry
        self.endpoint = endpoint
        self._thread = None
        self._stop = threading.Event()

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="rc-zmq")
        self._thread.start()

    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None

    def _serve(self):
        import zmq
        ctx = zmq.Context.instance()
        sock = ctx.socket(zmq.REP)
        sock.bind(self.endpoint)
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        try:
            while not self._stop.is_set():
                if not poller.poll(200):
                    continue
                parts = [p.decode("utf-8", "replace")
                         for p in sock.recv_multipart()]
                sock.send_multipart(
                    [p.encode() for p in self._handle(parts)])
        finally:
            sock.close(0)

    def _handle(self, parts: list[str]) -> list[str]:
        reg = self.registry
        try:
            cmd = parts[0] if parts else ""
            if cmd == "ping":
                return ["ok"]
            if cmd == "list":
                return ["ok"] + reg.list_modules()
            if cmd == "show" and len(parts) == 2:
                return ["ok"] + [f"{n}: {v}" for n, v in reg.show(parts[1])]
            if cmd == "showjson" and len(parts) == 2:
                return ["ok", reg.show_json(parts[1])]
            if cmd == "get" and len(parts) == 3:
                return [reg.get_param(parts[1], parts[2])]
            if cmd == "set" and len(parts) == 4:
                reg.set_param(parts[1], parts[2], parts[3])
                return ["ok"]
            return ["fail", "Unsupported command. commands: list, show, "
                            "get, set"]
        except ParameterError as e:
            return ["fail", str(e)]
        except Exception as e:              # noqa: BLE001
            return ["fail", str(e)]
