"""Event publishing: ZMQ PUB of JSON events + a log backend
(port of src/Events.{h,cpp} EventSender / LogToEventSender).

Wire format matches the reference: two-part messages
[event_name][json payload], consumable by doc/receive_events.py-style
subscribers.

The port's copy of dabmod_tpu/events.py (zmq is imported when an endpoint
is bound).
"""
from __future__ import annotations

import json
import logging


class EventSender:
    def __init__(self):
        self._socket = None

    def bind(self, endpoint: str):
        import zmq
        ctx = zmq.Context.instance()
        self._socket = ctx.socket(zmq.PUB)
        self._socket.bind(endpoint)

    def send(self, event_name: str, detail: dict):
        if self._socket is None:
            return
        self._socket.send_multipart(
            [event_name.encode(), json.dumps(detail).encode()])

    def close(self):
        if self._socket is not None:
            self._socket.close(0)
            self._socket = None


events = EventSender()


class EventLogHandler(logging.Handler):
    """Forwards warning+ log records as events, like LogToEventSender."""

    def emit(self, record):
        if record.levelno >= logging.WARNING:
            events.send(record.levelname.lower(),
                        {"message": record.getMessage()})
