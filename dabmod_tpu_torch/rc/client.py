"""ZMQ remote-control client (port of python/lib/zmqrc.py ModRemoteControl;
the port's copy of dabmod_tpu/rc/client.py)."""
from __future__ import annotations


class ModRemoteControl:
    def __init__(self, endpoint: str, timeout_s: float = 5.0):
        import zmq
        self._zmq = zmq
        self._endpoint = endpoint
        self._timeout_ms = int(timeout_s * 1000)
        self._ctx = zmq.Context.instance()
        self.sock = self._make_socket()

    def _make_socket(self):
        sock = self._ctx.socket(self._zmq.REQ)
        sock.setsockopt(self._zmq.LINGER, 0)
        sock.setsockopt(self._zmq.RCVTIMEO, self._timeout_ms)
        sock.connect(self._endpoint)
        return sock

    def _req(self, *parts: str) -> list[str]:
        try:
            self.sock.send_multipart([p.encode() for p in parts])
            return [p.decode() for p in self.sock.recv_multipart()]
        except self._zmq.ZMQError:
            # a REQ socket that timed out (or was used after one) is
            # stuck in its state machine; recreate it so the next call
            # works once the modulator is back (the reference's zmqrc
            # client has the same recv timeout semantics)
            self.sock.close(0)
            self.sock = self._make_socket()
            raise

    def ping(self) -> bool:
        return self._req("ping") == ["ok"]

    def get_modules(self) -> list[str]:
        rep = self._req("list")
        if rep[:1] != ["ok"]:
            raise RuntimeError(f"rc list failed: {rep}")
        return rep[1:]

    def show(self, module: str) -> dict[str, str]:
        rep = self._req("show", module)
        if rep[:1] != ["ok"]:
            raise RuntimeError(f"rc show failed: {rep}")
        out = {}
        for line in rep[1:]:
            k, _, v = line.partition(": ")
            out[k] = v
        return out

    def get_param_value(self, module: str, param: str) -> str:
        rep = self._req("get", module, param)
        if rep[0] == "fail":
            raise RuntimeError(f"rc get failed: {rep[1:]}")
        return rep[0]

    def set_param_value(self, module: str, param: str, value: str):
        rep = self._req("set", module, param, str(value))
        if rep[0] != "ok":
            raise RuntimeError(f"rc set failed: {rep}")

    def close(self):
        self.sock.close()
