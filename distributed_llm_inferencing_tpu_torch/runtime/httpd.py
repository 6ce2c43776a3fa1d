"""Minimal JSON-over-HTTP service base (stdlib only), own copy.

The wire shape of the reference's ``runtime/httpd.py``: JSON bodies,
structured error responses, 405 for a known path under the wrong method,
bearer-token auth on every route (``auth_key``: 401 without
``Authorization: Bearer <key>``), raw ``(bytes, content_type)`` answers,
``(status, payload, headers)`` triples, handlers that take the request
(``_request``) to stream their own answer (``jsonl_stream``,
``sse_stream``, ``binary_stream``), and a shutdown that also closes kept-alive client
sockets. Its tracing, fault injection and in-flight cap join with the
port's tracing subsystem.
"""

from __future__ import annotations

import inspect
import json
import re
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional


class Route:
    def __init__(self, method: str, pattern: str, fn: Callable):
        self.method = method
        self.regex = re.compile("^" + re.sub(
            r"<(\w+)>", r"(?P<\1>[^/]+)", pattern) + "/?$")
        self.fn = fn
        self.wants_request = _wants_request(fn)


class JsonHTTPService:
    """Register handlers; serve with ThreadingHTTPServer.

    Handler signature: fn(body: dict, **path_params) -> (status, payload),
    -> (status, payload, headers), or -> payload (200 implied). A payload
    of type (bytes, content_type) is sent raw. A handler with a
    ``_request`` parameter gets the request handler, and may write the
    answer itself (``jsonl_stream``, ``sse_stream``).
    """

    def __init__(self, name: str, auth_key: Optional[str] = None):
        self.name = name
        self.auth_key = auth_key
        self.routes: List[Route] = []
        self._server: Optional[_TrackingHTTPServer] = None

    def add(self, method: str, pattern: str, fn: Callable):
        self.routes.append(Route(method, pattern, fn))

    def make_handler(service):
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def handle(self):
                try:
                    super().handle()
                except (BrokenPipeError, ConnectionResetError):
                    pass   # the client went away mid-answer

            def _send_json(self, status: int, payload, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_raw(self, status: int, data: bytes, ctype: str):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _authorized(self) -> bool:
                if not service.auth_key:
                    return True
                hdr = self.headers.get("Authorization", "")
                return hdr == f"Bearer {service.auth_key}"

            def _drain_body(self):
                # keep-alive: an unread body would be parsed as the next
                # request line on this connection
                n = int(self.headers.get("Content-Length") or 0)
                while n > 0:
                    chunk = self.rfile.read(min(n, 1 << 16))
                    if not chunk:
                        break
                    n -= len(chunk)

            def _dispatch(self, method: str):
                path = self.path.partition("?")[0]
                if not self._authorized():
                    self._drain_body()
                    return self._send_json(
                        401, {"status": "error", "message": "unauthorized"})
                allowed = set()
                for r in service.routes:
                    m = r.regex.match(path)
                    if not m:
                        continue
                    if r.method != method:
                        allowed.add(r.method)
                        continue
                    body = {}
                    n = int(self.headers.get("Content-Length") or 0)
                    if method == "POST" and n:
                        try:
                            body = json.loads(self.rfile.read(n) or b"{}")
                        except json.JSONDecodeError:
                            return self._send_json(
                                400, {"status": "error",
                                      "message": "invalid JSON body"})
                    kw = m.groupdict()
                    if r.wants_request:
                        kw["_request"] = self
                    try:
                        result = r.fn(body, **kw)
                    except _Streaming:
                        return   # the handler wrote the answer
                    except Exception as e:   # structured 500
                        return self._send_json(
                            500, {"status": "error", "message": str(e)})
                    hdrs = None
                    if (isinstance(result, tuple) and len(result) == 3
                            and isinstance(result[0], int)
                            and isinstance(result[2], dict)):
                        status, payload, hdrs = result
                    elif (isinstance(result, tuple) and len(result) == 2
                            and isinstance(result[0], int)):
                        status, payload = result
                    else:
                        status, payload = 200, result
                    if isinstance(payload, tuple):   # (bytes, content_type)
                        return self._send_raw(status, *payload)
                    return self._send_json(status, payload, hdrs)
                self._drain_body()
                if allowed:
                    return self._send_json(
                        405, {"status": "error",
                              "message": f"method {method} not allowed for "
                                         f"{path}"},
                        {"Allow": ", ".join(sorted(allowed))})
                self._send_json(404, {"status": "error",
                                      "message": "not found"})

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

        return Handler

    def serve(self, host: str, port: int, background: bool = False
              ) -> ThreadingHTTPServer:
        self._server = _TrackingHTTPServer((host, port), self.make_handler())
        self._server.daemon_threads = True
        if background:
            threading.Thread(target=self._server.serve_forever,
                             daemon=True).start()
        else:
            self._server.serve_forever()
        return self._server

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    def shutdown(self):
        """Stop serving, close the listener and every live client
        connection: a kept-alive client (a master's pooled session) must
        see the server gone, as it would after the process died."""
        srv, self._server = self._server, None
        if srv:
            srv.shutdown()
            srv.server_close()
            srv.close_client_connections()


class _TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that remembers its client sockets, so shutdown
    can close kept-alive connections, not only the listener."""

    def __init__(self, *a, **kw):
        self._client_socks: set = set()
        self._client_socks_lock = threading.Lock()
        super().__init__(*a, **kw)

    def get_request(self):
        sock, addr = super().get_request()
        with self._client_socks_lock:
            self._client_socks.add(sock)
        return sock, addr

    def shutdown_request(self, request):
        with self._client_socks_lock:
            self._client_socks.discard(request)
        super().shutdown_request(request)

    def close_client_connections(self):
        with self._client_socks_lock:
            socks = list(self._client_socks)
            self._client_socks.clear()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class _Streaming(Exception):
    """Raised by a handler that wrote its answer itself."""


def _wants_request(fn) -> bool:
    try:
        return "_request" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def jsonl_stream(request_handler, events):
    """Write a chunked JSON-lines answer from an iterator of dict events,
    one object per line, flushed as produced. Chunked framing delimits
    the body, so the connection stays kept alive for the caller's pool."""
    request_handler.send_response(200)
    request_handler.send_header("Content-Type", "application/jsonlines")
    request_handler.send_header("Transfer-Encoding", "chunked")
    request_handler.end_headers()
    try:
        for ev in events:
            data = json.dumps(ev).encode() + b"\n"
            request_handler.wfile.write(
                f"{len(data):x}\r\n".encode() + data + b"\r\n")
            request_handler.wfile.flush()
        request_handler.wfile.write(b"0\r\n\r\n")
        request_handler.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        # the caller went away: the producers still finish, so their
        # results land in the idempotency cache for the retry
        request_handler.close_connection = True
    raise _Streaming()


def binary_stream(request_handler, chunks,
                  content_type="application/octet-stream"):
    """Write a chunked binary answer from an iterator of byte chunks: the
    KV-transfer twin of ``jsonl_stream`` (runtime/kvwire.py frames ride it
    out of ``POST /kv_fetch``). Chunked framing delimits the body, so the
    peer's pooled keep-alive session gets its connection back."""
    request_handler.send_response(200)
    request_handler.send_header("Content-Type", content_type)
    request_handler.send_header("Transfer-Encoding", "chunked")
    request_handler.end_headers()
    try:
        for data in chunks:
            if not data:
                continue
            request_handler.wfile.write(
                f"{len(data):x}\r\n".encode() + data + b"\r\n")
            request_handler.wfile.flush()
        request_handler.wfile.write(b"0\r\n\r\n")
        request_handler.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        # the fetching peer went away mid-transfer: it recomputes
        request_handler.close_connection = True
    raise _Streaming()


def sse_stream(request_handler, events):
    """Write a server-sent-events answer from an iterator of dict events;
    the connection closes at the end (no length)."""
    request_handler.send_response(200)
    request_handler.send_header("Content-Type", "text/event-stream")
    request_handler.send_header("Cache-Control", "no-cache")
    request_handler.send_header("Connection", "close")
    request_handler.end_headers()
    try:
        for ev in events:
            request_handler.wfile.write(
                f"data: {json.dumps(ev)}\n\n".encode())
            request_handler.wfile.flush()
    except (BrokenPipeError, ConnectionResetError):
        pass
    raise _Streaming()
