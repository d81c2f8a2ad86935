"""yamlrpc: JSON-RPC 2.0 shaped messages serialized as YAML over UDP.

Wire-compatible with the reference's GUI <-> DPDCE control transport
(python/lib/yamlrpc.py): datagrams are YAML mappings carrying
``yamlrpc: '2.0'`` plus either method/params/id (request), result/id
(success) or error/id (failure).  Localhost-only by design, 2048-byte
datagrams.

The port's copy of dabmod_tpu/rc/yamlrpc.py, with one difference: yaml is
imported inside _dump and _parse, not at the top, so that dpd/server.py and
gui.py import on a machine without PyYAML.
"""
from __future__ import annotations

import socket

UDP_PACKETSIZE = 2048
YAMLRPC_VERSION = "2.0"


class ResponseError(Exception):
    """The peer answered with an error response."""

    def __init__(self, message):
        super().__init__(message)
        self.message = message


def _dump(fields: dict) -> bytes:
    import yaml
    return yaml.safe_dump({"yamlrpc": YAMLRPC_VERSION, **fields}).encode()


def request(request_id: int, method: str, params) -> bytes:
    return _dump({"method": method, "params": params, "id": request_id})


def response_success(request_id: int, result) -> bytes:
    return _dump({"result": result, "id": request_id})


def response_error(request_id: int, error) -> bytes:
    return _dump({"error": error, "id": request_id})


def notification(method: str, params) -> bytes:
    return _dump({"method": method, "params": params})


def _parse(data: bytes) -> dict:
    import yaml
    try:
        y = yaml.safe_load(data.decode(errors="replace"))
    except yaml.YAMLError as e:
        # surface malformed datagrams as ValueError: serve loops catch
        # that (yaml.YAMLError is a plain Exception subclass, and one
        # port-scan datagram must not kill the RPC thread)
        raise ValueError(f"Malformed yamlrpc datagram: {e}") from None
    if not isinstance(y, dict) or "yamlrpc" not in y:
        raise ValueError("Message is not yamlrpc")
    if y["yamlrpc"] != YAMLRPC_VERSION:
        raise ValueError("Invalid yamlrpc version")
    return y


class Socket:
    """One UDP endpoint usable as client (call_rpc_method) or server
    (receive_request / send_*_response)."""

    def __init__(self, bind_port: int = 0, timeout: float = 3.0):
        self.socket = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # bind_port=0 binds an ephemeral port (client sockets need one to
        # receive responses; servers learn it from .port)
        self.socket.bind(("127.0.0.1", bind_port))
        self.socket.settimeout(timeout)
        self._last_request_id = 0

    @property
    def port(self) -> int:
        return self.socket.getsockname()[1]

    def close(self):
        self.socket.close()

    # ----------------------------------------------------------- client
    def send_request(self, dest_port: int, method: str, params) -> int:
        self._last_request_id += 1
        self.socket.sendto(request(self._last_request_id, method, params),
                           ("127.0.0.1", dest_port))
        return self._last_request_id

    def receive_response(self, expected_msg_id: int):
        # drop stale datagrams (responses to requests that already timed
        # out) instead of erroring: one late reply must not desync every
        # subsequent RPC on this socket
        while True:
            try:
                data, _addr = self.socket.recvfrom(UDP_PACKETSIZE)
            except socket.timeout:
                raise TimeoutError("no yamlrpc response") from None
            y = _parse(data)
            if "id" not in y:
                raise ValueError("Response is missing id")
            if y["id"] != expected_msg_id:
                if isinstance(y["id"], int) and y["id"] < expected_msg_id:
                    continue                     # stale, discard
                raise ValueError("Response id does not match request")
            if "result" in y:
                return y["result"]
            if "error" in y:
                raise ResponseError(y["error"])
            raise ValueError("response carries neither result nor error")

    def call_rpc_method(self, dest_port: int, method: str, params):
        return self.receive_response(
            self.send_request(dest_port, method, params))

    # ----------------------------------------------------------- server
    def receive_request(self):
        """Returns (addr, msg_id, method, params); raises TimeoutError on
        an idle socket so serve loops can poll a stop flag."""
        try:
            data, addr = self.socket.recvfrom(UDP_PACKETSIZE)
        except socket.timeout as to:
            raise TimeoutError(f"Timeout: {to}") from None
        y = _parse(data)
        try:
            return addr, y["id"], y["method"], y["params"]
        except KeyError:
            raise ValueError("Incomplete message") from None

    def send_success_response(self, addr, msg_id: int, result):
        self.socket.sendto(response_success(msg_id, result), addr)

    def send_error_response(self, addr, msg_id: int, error):
        self.socket.sendto(response_error(msg_id, error), addr)
