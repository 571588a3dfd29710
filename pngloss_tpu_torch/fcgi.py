"""From-scratch FastCGI responder — the reference sidecar's actual wire
protocol.  The Go service is driven by a front server speaking FastCGI
over a unix socket (`fcgi.Serve(listener, ...)`,
website/pnglossapi.go:91-124); a stock nginx `fastcgi_pass
unix:/run/pngloss.sock;` block therefore expects FCGI records, not HTTP.
This module implements the responder side of the FastCGI 1.0 spec —
BEGIN_REQUEST / PARAMS / STDIN in, STDOUT / END_REQUEST out — and routes
every request through the existing `website.Handler`, so the two
transports (HTTP-over-UDS, the default; FCGI via `--fcgi`) share one
implementation of the endpoints.

Kept deliberately minimal, matching how the reference is deployed:
  * RESPONDER role only (the only role Go's fcgi package serves);
    BEGIN_REQUEST for any other role answers END_REQUEST/UNKNOWN_ROLE.
  * No connection multiplexing: one request at a time per connection; a
    concurrent BEGIN_REQUEST on the same connection answers
    CANT_MPX_CONN (this is what nginx expects — it never multiplexes).
  * Keep-alive off: the connection closes after END_REQUEST even if the
    client sets FCGI_KEEP_CONN, which the spec permits and nginx
    handles by reconnecting.
  * Management records: GET_VALUES answered (MPXS_CONNS=0 etc.); other
    management types answered with UNKNOWN_TYPE per spec.

The port's own copy of ``pngloss_tpu/fcgi.py``: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import io
import socket
import struct
import threading

# record types (FastCGI spec 1.0, section 8)
FCGI_BEGIN_REQUEST = 1
FCGI_ABORT_REQUEST = 2
FCGI_END_REQUEST = 3
FCGI_PARAMS = 4
FCGI_STDIN = 5
FCGI_STDOUT = 6
FCGI_STDERR = 7
FCGI_GET_VALUES = 9
FCGI_GET_VALUES_RESULT = 10
FCGI_UNKNOWN_TYPE = 11

FCGI_RESPONDER = 1
FCGI_KEEP_CONN = 1

# protocolStatus values for END_REQUEST
FCGI_REQUEST_COMPLETE = 0
FCGI_CANT_MPX_CONN = 1
FCGI_UNKNOWN_ROLE = 3

_HEADER = struct.Struct(">BBHHBx")   # version, type, requestId, clen, plen


def _pack_record(rtype: int, request_id: int, content: bytes) -> bytes:
    # pad content to a multiple of 8 as the spec recommends
    pad = -len(content) % 8
    return (_HEADER.pack(1, rtype, request_id, len(content), pad)
            + content + b"\x00" * pad)


def _pack_pairs(pairs: dict[str, str]) -> bytes:
    out = bytearray()
    for k, v in pairs.items():
        kb, vb = k.encode(), v.encode()
        for n in (len(kb), len(vb)):
            if n < 128:
                out.append(n)
            else:
                out += struct.pack(">I", n | 0x80000000)
        out += kb + vb
    return bytes(out)


def _parse_pairs(data: bytes) -> dict[str, str]:
    """Decode the FCGI name-value stream (1- or 4-byte lengths)."""
    params: dict[str, str] = {}
    i, n = 0, len(data)
    while i < n:
        lens = []
        for _ in range(2):
            if i >= n:
                return params
            ln = data[i]
            if ln < 128:
                i += 1
            else:
                if i + 4 > n:
                    return params
                ln = struct.unpack(">I", data[i:i + 4])[0] & 0x7FFFFFFF
                i += 4
            lens.append(ln)
        kl, vl = lens
        if i + kl + vl > n:
            return params
        params[data[i:i + kl].decode("latin-1")] = \
            data[i + kl:i + kl + vl].decode("latin-1")
        i += kl + vl
    return params


class _CapturedBytesIO(io.BytesIO):
    """BytesIO that snapshots its contents on close: depending on the
    handler's write path (makefile vs socketserver._SocketWriter via
    sendall) the buffer may or may not be closed by finish()."""

    _snapshot = b""

    def close(self):
        self._snapshot = self.getvalue()
        super().close()

    @property
    def value(self) -> bytes:
        return self._snapshot if self.closed else self.getvalue()


class _FakeConnection:
    """Just enough of a socket for BaseHTTPRequestHandler: makefile()
    for buffered modes, sendall() for socketserver's unbuffered
    _SocketWriter write path (wbufsize == 0, the http.server default)."""

    def __init__(self, request_bytes: bytes):
        self._rfile = io.BytesIO(request_bytes)
        self.wfile = _CapturedBytesIO()

    def makefile(self, mode, *a, **kw):
        return self._rfile if "r" in mode else self.wfile

    def sendall(self, data):
        self.wfile.write(data)

    def close(self):
        pass


def _cgi_request_to_http(params: dict[str, str], body: bytes) -> bytes:
    """Synthesize the HTTP/1.0 request the website Handler understands
    from CGI meta-variables (REQUEST_URI preferred — nginx always sets
    it; SCRIPT_NAME+QUERY_STRING as the spec-level fallback)."""
    method = params.get("REQUEST_METHOD", "GET")
    uri = params.get("REQUEST_URI")
    if not uri:
        uri = params.get("SCRIPT_NAME", "/") + params.get("PATH_INFO", "")
        qs = params.get("QUERY_STRING", "")
        if qs:
            uri += "?" + qs
    lines = [f"{method} {uri} HTTP/1.0"]
    if "CONTENT_TYPE" in params:
        lines.append("Content-Type: " + params["CONTENT_TYPE"])
    lines.append(f"Content-Length: {len(body)}")
    for k, v in params.items():
        if k.startswith("HTTP_") and k not in (
                "HTTP_CONTENT_TYPE", "HTTP_CONTENT_LENGTH"):
            lines.append(k[5:].replace("_", "-").title() + ": " + v)
    return "\r\n".join(lines).encode("latin-1") + b"\r\n\r\n" + body


def _http_response_to_cgi(response: bytes) -> bytes:
    """HTTP/1.0 response bytes -> CGI response: the status line becomes a
    `Status:` header (what the front server expects on FCGI STDOUT)."""
    head, sep, body = response.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    status = b"200 OK"
    if lines and lines[0].startswith(b"HTTP/"):
        parts = lines[0].split(b" ", 1)
        if len(parts) == 2:
            status = parts[1]
        lines = lines[1:]
    out = [b"Status: " + status]
    out += [ln for ln in lines
            if not ln.lower().startswith((b"connection:", b"date:"))]
    return b"\r\n".join(out) + b"\r\n\r\n" + body


class FCGIServer:
    """Threaded accept loop serving FastCGI on an already-bound,
    listening socket; requests route through `handler_class` (the
    website's BoundHandler).  API mirrors socketserver enough for the
    existing callers/tests: serve_forever() / shutdown()."""

    def __init__(self, sock: socket.socket, handler_class):
        self.socket = sock
        self.handler_class = handler_class
        self.server_address = sock.getsockname()
        self._shut = threading.Event()

    # -- per-connection protocol ------------------------------------
    def _read_record(self, conn) -> tuple[int, int, bytes] | None:
        hdr = b""
        while len(hdr) < 8:
            chunk = conn.recv(8 - len(hdr))
            if not chunk:
                return None
            hdr += chunk
        _ver, rtype, req_id, clen, plen = _HEADER.unpack(hdr)
        need = clen + plen
        buf = b""
        while len(buf) < need:
            chunk = conn.recv(need - len(buf))
            if not chunk:
                return None
            buf += chunk
        return rtype, req_id, buf[:clen]

    @staticmethod
    def _graceful_close(conn) -> None:
        """End a connection that may still have unread inbound records:
        a bare close() would RST and the peer could lose the response we
        just sent — send EOF, drain, then close."""
        try:
            conn.shutdown(socket.SHUT_WR)
            while conn.recv(65536):
                pass
        except OSError:
            pass

    def _run_request(self, conn, req_id: int, params: dict[str, str],
                     body: bytes) -> None:
        fake = _FakeConnection(_cgi_request_to_http(params, body))
        try:
            self.handler_class(fake, ("unix", 0), self)
            response = fake.wfile.value
        except Exception:
            response = (b"HTTP/1.0 500 Internal Server Error\r\n"
                        b"Content-Type: text/plain\r\n\r\ninternal error")
        cgi = _http_response_to_cgi(response)
        # stream STDOUT in <=32 KiB records, then the end-of-stream
        # record, then END_REQUEST
        for i in range(0, len(cgi), 32768):
            conn.sendall(_pack_record(FCGI_STDOUT, req_id, cgi[i:i + 32768]))
        conn.sendall(_pack_record(FCGI_STDOUT, req_id, b""))
        conn.sendall(_pack_record(
            FCGI_END_REQUEST, req_id,
            struct.pack(">IB3x", 0, FCGI_REQUEST_COMPLETE)))

    def _handle_connection(self, conn) -> None:
        try:
            active_id = None
            params_buf = b""
            stdin_buf = b""
            params_done = False
            while True:
                rec = self._read_record(conn)
                if rec is None:
                    return
                rtype, req_id, content = rec
                if req_id == 0:
                    # management records
                    if rtype == FCGI_GET_VALUES:
                        asked = _parse_pairs(content)
                        vals = {k: v for k, v in {
                            "FCGI_MAX_CONNS": "8",
                            "FCGI_MAX_REQS": "8",
                            "FCGI_MPXS_CONNS": "0",
                        }.items() if k in asked}
                        conn.sendall(_pack_record(
                            FCGI_GET_VALUES_RESULT, 0, _pack_pairs(vals)))
                    else:
                        conn.sendall(_pack_record(
                            FCGI_UNKNOWN_TYPE, 0,
                            struct.pack(">B7x", rtype)))
                    continue
                if rtype == FCGI_BEGIN_REQUEST:
                    role, _flags = struct.unpack(">HB5x", content)
                    if active_id is not None:
                        conn.sendall(_pack_record(
                            FCGI_END_REQUEST, req_id,
                            struct.pack(">IB3x", 0, FCGI_CANT_MPX_CONN)))
                        continue
                    if role != FCGI_RESPONDER:
                        conn.sendall(_pack_record(
                            FCGI_END_REQUEST, req_id,
                            struct.pack(">IB3x", 0, FCGI_UNKNOWN_ROLE)))
                        self._graceful_close(conn)
                        return
                    active_id = req_id
                elif req_id != active_id:
                    continue                     # stale/unknown request id
                elif rtype == FCGI_ABORT_REQUEST:
                    conn.sendall(_pack_record(
                        FCGI_END_REQUEST, req_id,
                        struct.pack(">IB3x", 0, FCGI_REQUEST_COMPLETE)))
                    self._graceful_close(conn)   # keep-alive off
                    return
                elif rtype == FCGI_PARAMS:
                    if content:
                        params_buf += content
                    else:
                        params_done = True
                elif rtype == FCGI_STDIN:
                    if content:
                        stdin_buf += content
                    elif params_done:
                        self._run_request(conn, active_id,
                                          _parse_pairs(params_buf),
                                          stdin_buf)
                        return                   # keep-alive off
                    else:
                        return                   # STDIN ended before PARAMS
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- accept loop --------------------------------------------------
    def serve_forever(self) -> None:
        self.socket.settimeout(0.5)
        while not self._shut.is_set():
            try:
                conn, _ = self.socket.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.settimeout(600)
            threading.Thread(target=self._handle_connection, args=(conn,),
                             daemon=True).start()

    def shutdown(self) -> None:
        self._shut.set()
        try:
            self.socket.close()
        except OSError:
            pass
