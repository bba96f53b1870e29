"""The ``/healthz`` endpoint (the port of :mod:`dpwa_tpu.health.endpoint`):
a stdlib HTTP/1.0 responder on a daemon thread and a port of its own
(``health.healthz_port``; 0 lets the OS pick), serving a node's
:meth:`~dpwa_tpu_torch.parallel.tcp.TcpTransport.health_snapshot` as JSON::

    $ curl http://127.0.0.1:<port>/healthz

``/membership``, ``/trust`` and ``/flowctl`` serve that sub-document (or
``{"error": "<plane> disabled"}``), ``/wire`` the wire plane's (which the
port's snapshot never holds: ``{"error": "wire plane disabled"}``), and
every other path, ``/metrics``, ``/incidents`` and ``/flightdump``
included, the whole snapshot, as the reference answers when those routes
are not wired.  It faces untrusted input: one bounded ``recv``, a timeout
a connection, and anything unparseable served the whole snapshot.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Callable

# Routes serving one sub-document of the snapshot, and the name of its plane.
_SUBDOCUMENTS = (
    (b" /membership", "membership", "membership disabled"),
    (b" /trust", "trust", "trust disabled"),
    (b" /flowctl", "flowctl", "flowctl disabled"),
    (b" /wire", "wire", "wire plane disabled"),
)


class HealthzServer:
    """Serves ``snapshot_fn()`` as JSON to any HTTP client."""

    def __init__(self, snapshot_fn: Callable[[], dict], host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 2.0):
        self._snapshot_fn = snapshot_fn
        self._request_timeout_s = max(0.05, float(request_timeout_s))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
            self._sock.listen(8)
        except OSError:
            self._sock.close()
            raise
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name=f"dpwa-torch-healthz:{self.port}", daemon=True
        )
        self._thread.start()

    def _document(self, request_line: bytes) -> bytes:
        try:
            doc = self._snapshot_fn()
            for route, key, error in _SUBDOCUMENTS:
                if route in request_line:
                    doc = doc.get(key) or {"error": error}
                    break
            return json.dumps(doc).encode()
        except Exception:  # the endpoint outlives a failing snapshot
            return b'{"error": "snapshot failed"}'

    def _serve(self) -> None:
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                conn.settimeout(self._request_timeout_s)
                raw = b""
                try:
                    raw = conn.recv(4096)
                except OSError:
                    pass
                body = self._document(raw.split(b"\r\n", 1)[0])
                conn.sendall(
                    b"HTTP/1.0 200 OK\r\nContent-Type: application/json\r\n"
                    b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                    b"Connection: close\r\n\r\n" + body
                )
            except OSError:
                pass
            finally:
                conn.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
