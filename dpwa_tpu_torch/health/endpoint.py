"""The ``/healthz`` endpoint (the port of :mod:`dpwa_tpu.health.endpoint`):
a stdlib HTTP/1.0 responder on a daemon thread and a port of its own
(``health.healthz_port``; 0 lets the OS pick), serving a node's
:meth:`~dpwa_tpu_torch.parallel.tcp.TcpTransport.health_snapshot` as JSON::

    $ curl http://127.0.0.1:<port>/healthz

``/membership``, ``/trust`` and ``/flowctl`` serve that sub-document (or
``{"error": "<plane> disabled"}``), ``/wire`` the wire plane's.  With a
``metrics_fn`` (``obs.metrics``) ``/metrics`` serves its Prometheus text;
``extra_routes`` (a path to a callable map, the longest path matched first)
serve more JSON documents: the transport wires ``/incidents`` and
``/flightdump`` there.  Every other path, and those routes when not wired,
gets the whole snapshot.  It faces untrusted input: one bounded ``recv``, a
timeout a connection, anything unparseable served the whole snapshot, and
no route or snapshot that raises can kill it.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Callable, Mapping, Optional

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
                 metrics_fn: Optional[Callable[[], str]] = None, request_timeout_s: float = 2.0,
                 extra_routes: Optional[Mapping[str, Callable[[], dict]]] = None):
        self._snapshot_fn = snapshot_fn
        self._metrics_fn = metrics_fn
        # Longest path first, so "/incidents" wins over a "/inc" route.
        self._extra_routes = sorted((extra_routes or {}).items(), key=lambda kv: -len(kv[0]))
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

    def _document(self, request_line: bytes) -> tuple:
        """``(content type, body)`` for one request line."""
        if self._metrics_fn is not None and b" /metrics" in request_line:
            try:
                text = self._metrics_fn()
            except Exception:  # the endpoint outlives a failing collector
                text = ""
            return b"text/plain; version=0.0.4; charset=utf-8", text.encode()
        for route, fn in self._extra_routes:
            if b" " + route.encode() in request_line:
                try:
                    doc = fn()
                    if not isinstance(doc, dict):
                        doc = {"result": doc}
                    return b"application/json", json.dumps(doc).encode()
                except Exception:  # the endpoint outlives a failing route
                    return b"application/json", b'{"error": "route failed"}'
        try:
            doc = self._snapshot_fn()
            for route, key, error in _SUBDOCUMENTS:
                if route in request_line:
                    doc = doc.get(key) or {"error": error}
                    break
            return b"application/json", json.dumps(doc).encode()
        except Exception:  # the endpoint outlives a failing snapshot
            return b"application/json", b'{"error": "snapshot failed"}'

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
                ctype, body = self._document(raw.split(b"\r\n", 1)[0])
                conn.sendall(
                    b"HTTP/1.0 200 OK\r\nContent-Type: " + ctype + b"\r\n"
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
