"""HTTP frontend on the port — the counterpart of ``pngloss_tpu/website.py``,
the rebuild of the reference's Go FastCGI service
(website/pnglossapi.go). Same endpoints and behaviors; compression is an
in-process call into the port's pipeline on ``device`` or over ``mesh``:

  POST {prefix}compress.cgi    multipart fields: file | url | sum224, plus
                               strength / bleed / strip. Stores the original
                               content-addressed by SHA-224 (1296-slot disk
                               store, pnglossapi.go:443-514), compresses, and
                               returns the full result page (the Go
                               pageMarkup template, pnglossapi.go:572-654).
  GET  {prefix}compressed.cgi  query: sum224 (base64url) / strength / bleed /
                               strip -> image/png bytes (10-entry in-memory
                               result cache, pnglossapi.go:516-560).
  GET  {prefix}[index.html] / style.css / example.html / david[-sNN].png
                               static site; the example images are
                               compressed by the port from ``example_source``
                               (the reference suite's david.png, found in
                               ``$PNGLOSS_SUITE_DIR``; 404 without it).

The endpoints, limits, original store, multipart parsing, URL checks and
transports are copies of ``pngloss_tpu.website``'s (the port imports
nothing of the JAX package). Concurrency is capped at 2 in-flight requests
per endpoint (pnglossapi.go:50-51); image dimensions at 3000x3000
(pnglossapi.go:239-251). Each server gets its own request gates, result
cache and example-image cache, so two servers in one process share
nothing. Concurrent requests call the pipeline from several threads at
once; on CUDA they queue on each device's current stream and give the
bytes a call made alone gives.

Usage: python -m pngloss_tpu_torch.website [--port 8117] [--store DIR]
       [--socket PATH] [--fcgi]

Transports: HTTP on 127.0.0.1:PORT (default), HTTP over a unix socket
(--socket PATH; nginx `proxy_pass http://unix:PATH;`), or FastCGI records
(--fcgi, ``pngloss_tpu_torch/fcgi.py``; nginx `fastcgi_pass unix:PATH;`).

Runs on CUDA; ``make_server`` raises, and ``main`` exits 2, with a message
that names CUDA when it is not available.
"""

from __future__ import annotations

import argparse
import base64
import binascii
import hashlib
import os
import re
import stat
import struct
import sys
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

MAX_DIMENSION = 3000
MAX_CONCURRENT = 2
MAX_CACHED = 10
MAX_FIELD_LENGTHS = {
    "file": 20 * 1024 * 1024, "url": 2083, "sum224": 40,
    "strength": 3, "bleed": 5, "strip": 1,
}
_ENCODE_STD = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
_EXAMPLES = ("david-s20.png", "david-s40.png")


class OriginalsOnDisk:
    """Content-addressed original store: sum224 mod 1296 -> 2-char slot file
    plus a full-hash index entry (simplified from pnglossapi.go:443-514 —
    the slot file disambiguates via an adjacent .sum file)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        os.makedirs(prefix, exist_ok=True)
        self.lock = threading.Lock()

    def _path(self, sum224: bytes) -> str:
        mod = int.from_bytes(sum224, "big") % (len(_ENCODE_STD) ** 2)
        name = _ENCODE_STD[mod // len(_ENCODE_STD)] + _ENCODE_STD[mod % len(_ENCODE_STD)]
        name = name.replace("/", "_").replace("+", "-")
        return os.path.join(self.prefix, name)

    def save(self, data: bytes, sum224: bytes) -> None:
        path = self._path(sum224)
        with self.lock:
            with open(path + ".png", "wb") as f:
                f.write(data)
            with open(path + ".sum", "wb") as f:
                f.write(sum224)

    def load(self, sum224: bytes) -> bytes | None:
        path = self._path(sum224)
        with self.lock:
            try:
                with open(path + ".sum", "rb") as f:
                    if f.read() != sum224:
                        return None
                with open(path + ".png", "rb") as f:
                    return f.read()
            except OSError:
                return None


class CompressedsInMemory:
    """Last-10 (sum224, strength, bleed, strip) -> bytes cache whose misses
    compress on the port's pipeline over ``mesh``."""

    def __init__(self, originals: OriginalsOnDisk, mesh):
        self.originals = originals
        self.mesh = mesh
        self.lock = threading.Lock()
        self.entries: list[tuple[tuple, bytes]] = []

    def compress(self, sum224: bytes, strength: int, bleed: int,
                 strip: int) -> bytes:
        from pngloss_tpu_torch import pipeline

        key = (sum224, strength, bleed, strip)
        with self.lock:
            for k, v in self.entries:
                if k == key:
                    return v
        original = self.originals.load(sum224)
        if original is None:
            raise FileNotFoundError("original not found")
        data = pipeline.compress_bytes(
            original, strength, bleed, strip=bool(strip), mesh=self.mesh)
        with self.lock:
            self.entries.append((key, data))
            del self.entries[:-MAX_CACHED]
        return data


def _url_allowed(url: str) -> bool:
    import urllib.parse

    return urllib.parse.urlsplit(url).scheme.lower() in ("http", "https")


def _http_opener():
    """An opener that can ONLY speak http/https — no FileHandler /
    FTPHandler / DataHandler, so a redirect cannot smuggle a file:// or
    data: target past the scheme check — with the redirect chain capped."""
    import urllib.request

    class _Redirects(urllib.request.HTTPRedirectHandler):
        max_redirections = 3

    opener = urllib.request.OpenerDirector()
    for handler in (urllib.request.HTTPHandler(),
                    urllib.request.HTTPSHandler(),
                    urllib.request.HTTPDefaultErrorHandler(),
                    _Redirects(),
                    urllib.request.HTTPErrorProcessor()):
        opener.add_handler(handler)
    return opener


def png_dimensions(data: bytes) -> tuple[int, int]:
    if len(data) < 24 or data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    return w, h


def parse_multipart(content_type: str, body: bytes) -> dict[str, bytes]:
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no boundary")
    boundary = m.group(1).encode()
    fields: dict[str, bytes] = {}
    for part in body.split(b"--" + boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, _, value = part.partition(b"\r\n\r\n")
        nm = re.search(rb'name="([^"]+)"', head)
        if not nm:
            continue
        name = nm.group(1).decode()
        limit = MAX_FIELD_LENGTHS.get(name)
        if limit is not None and len(value) <= limit:
            fields[name] = value
    return fields


def _example_source() -> str:
    """The reference suite's david.png in ``$PNGLOSS_SUITE_DIR``, or ""
    (no example images) when the variable is not set."""
    suite = os.environ.get("PNGLOSS_SUITE_DIR")
    return os.path.join(suite, "david.png") if suite else ""


class Handler(BaseHTTPRequestHandler):
    """The endpoints; ``make_server`` binds each server's own store,
    caches, gates and ``mesh`` on a subclass."""

    server_version = "pngloss-tpu-torch-web"
    originals: OriginalsOnDisk
    compresseds: CompressedsInMemory
    prefix = "/"
    mesh: tuple
    _gates: dict
    _example_cache: dict
    _example_lock: threading.Lock
    example_source = _example_source()

    def log_message(self, *a):  # quiet
        pass

    def _error(self, code: int, msg: str) -> None:
        self.send_error(code, msg)

    def _send(self, data: bytes, ctype: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _static(self, name: str) -> bool:
        """Front page, stylesheet, example page and the example's images
        (index.html / style.css / example.html in the reference site; the
        example images are compressed by the port from
        ``example_source``)."""
        from pngloss_tpu_torch import webassets

        if name in ("", "index.html"):
            self._send(webassets.index_page(self.prefix).encode(),
                       "text/html; charset=utf-8")
        elif name == "style.css":
            self._send(webassets.STYLE_CSS.encode(), "text/css")
        elif name == "example.html":
            self._send(webassets.example_page().encode(),
                       "text/html; charset=utf-8")
        elif name == "david.png" or name in _EXAMPLES:
            if not os.path.exists(self.example_source):
                self._error(404, "example image unavailable")
                return True
            # the first compressed-example hit runs a real compression:
            # serialize generation (concurrent hits would duplicate the
            # work) and count it against the image gate so it cannot
            # starve the service. Cached hits skip the lock so they never
            # queue behind a slow generation.
            data = self._example_cache.get(name)
            if data is not None:
                self._send(data, "image/png")
                return True
            with self._example_lock:
                data = self._example_cache.get(name)
                if data is None:
                    with open(self.example_source, "rb") as fh:
                        data = fh.read()
                    if name != "david.png":
                        if not self._gates["image"].acquire(timeout=600):
                            self._error(503, "busy")
                            return True
                        try:
                            from pngloss_tpu_torch import pipeline

                            data = pipeline.compress_bytes(
                                data, int(name[7:9]), 2, mesh=self.mesh)
                        finally:
                            self._gates["image"].release()
                    self._example_cache[name] = data
            self._send(data, "image/png")
        else:
            return False
        return True

    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path.startswith(self.prefix) and self._static(
                path[len(self.prefix):]):
            return
        if path != self.prefix + "compressed.cgi":
            return self._error(404, "not found")
        if not self._gates["image"].acquire(blocking=False):
            return self._error(503, "server busy")
        try:
            params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
            try:
                sum224 = base64.urlsafe_b64decode(params.get("sum224", ""))
                if len(sum224) != 28:
                    return self._error(400, "bad sum")
                strength = int(params["strength"])
                bleed = int(params["bleed"])
                strip = int(params["strip"])
                assert 0 <= strength < 128 and 1 <= bleed < 32768 and strip in (0, 1)
            except (KeyError, ValueError, AssertionError):
                return self._error(400, "bad query")
            try:
                data = self.compresseds.compress(sum224, strength, bleed, strip)
            except Exception:
                return self._error(500, "compression failed")
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        finally:
            self._gates["image"].release()

    def do_POST(self):
        path = self.path.partition("?")[0]
        if path != self.prefix + "compress.cgi":
            return self._error(404, "not found")
        if not self._gates["page"].acquire(blocking=False):
            return self._error(503, "server busy")
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length > 21 * 1024 * 1024:
                return self._error(413, "too large")
            body = self.rfile.read(length)
            try:
                fields = parse_multipart(
                    self.headers.get("Content-Type", ""), body)
            except ValueError:
                return self._error(400, "bad multipart")

            file_data = fields.get("file")
            if not file_data and "sum224" in fields:
                try:
                    sum224 = base64.urlsafe_b64decode(fields["sum224"])
                except (ValueError, binascii.Error):
                    return self._error(400, "bad sum")
                file_data = self.originals.load(sum224)
                if file_data is None:
                    return self._error(404, "unknown sum224")
            elif not file_data and "url" in fields:
                try:
                    url = fields["url"].decode()
                except UnicodeDecodeError:
                    return self._error(400, "bad url")
                # http/https only, like the reference's Go client.Get
                # (pnglossapi.go:189) — urlopen would happily serve
                # file:///etc/... or internal ftp otherwise
                if not _url_allowed(url):
                    return self._error(400, "bad url scheme")
                try:
                    with _http_opener().open(url, timeout=10) as r:
                        file_data = r.read(MAX_FIELD_LENGTHS["file"] + 1)
                except Exception:
                    return self._error(502, "fetch failed")
            if not file_data:
                return self._error(400, "missing file")

            try:
                w, h = png_dimensions(file_data)
            except ValueError:
                return self._error(400, "not a PNG")
            if w > MAX_DIMENSION or h > MAX_DIMENSION:
                return self._error(400, "image too large")

            try:
                strength = int(fields.get("strength", b"19"))
                bleed = int(fields.get("bleed", b"2"))
                strip = int(fields.get("strip", b"0"))
                # same bounds as the GET path: bleed=0 divides by zero
                # in Sierra diffusion, and a bad result would be cached
                # and the original persisted
                assert 0 <= strength < 128 and 1 <= bleed < 32768 \
                    and strip in (0, 1)
            except (ValueError, AssertionError):
                return self._error(400, "bad parameters")

            sum224 = hashlib.sha224(file_data).digest()
            self.originals.save(file_data, sum224)
            encoded = base64.urlsafe_b64encode(sum224).decode()
            try:
                data = self.compresseds.compress(sum224, strength, bleed, strip)
            except Exception:
                return self._error(500, "compression failed")

            from pngloss_tpu_torch import webassets

            page = webassets.result_page(
                self.prefix, sum224=encoded, strength=strength, bleed=bleed,
                strip=strip, in_size=len(file_data), out_size=len(data),
                width=w, height=h).encode()
            self._send(page, "text/html; charset=utf-8")
        finally:
            self._gates["page"].release()


class _UnixHTTPServer(ThreadingHTTPServer):
    """HTTP over an AF_UNIX socket — the deployment contract of the
    reference's FastCGI-on-unix-socket sidecar (pnglossapi.go:91-124):
    a front server (nginx `proxy_pass http://unix:/path;`) owns the
    public port and proxies to the socket."""

    address_family = __import__("socket").AF_UNIX

    def server_bind(self):
        # only ever unlink a stale SOCKET: a typo'd --socket pointing at a
        # regular file must not silently delete it (bind then fails loudly
        # with EADDRINUSE/ENOTSOCK instead)
        try:
            st = os.stat(self.server_address)
        except OSError:
            st = None
        if st is not None and stat.S_ISSOCK(st.st_mode):
            os.unlink(self.server_address)
        super().server_bind()
        self.server_name = "unix"
        self.server_port = 0

    def get_request(self):
        # AF_UNIX accept() returns '' as client address; BaseHTTPServer
        # expects a (host, port) pair for logging
        sock, _ = self.socket.accept()
        return sock, ("unix", 0)


def _bind_listener(port: int, unix_socket: str | None):
    """A bound+listening socket for the FCGI transport, with the same
    stale-socket-only unlink guard as _UnixHTTPServer.server_bind."""
    import socket as socket_mod

    if unix_socket:
        try:
            st = os.stat(unix_socket)
        except OSError:
            st = None
        if st is not None and stat.S_ISSOCK(st.st_mode):
            os.unlink(unix_socket)
        sock = socket_mod.socket(socket_mod.AF_UNIX)
        sock.bind(unix_socket)
    else:
        sock = socket_mod.socket(socket_mod.AF_INET)
        sock.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", port))
    sock.listen(16)
    return sock


def make_server(port: int = 8117, store: str | None = None,
                prefix: str = "/", unix_socket: str | None = None,
                fcgi: bool = False, *, device="cuda", mesh=None):
    """A server whose handler compresses on ``device``, or over ``mesh``
    (which, when given, replaces ``device``): HTTP on 127.0.0.1:port,
    HTTP over ``unix_socket``, or FastCGI records (``fcgi``) on either.
    ``store`` defaults to ``pngloss_store`` in the temp directory. Raises
    ``CudaUnavailableError`` when CUDA is asked for and not available."""
    from pngloss_tpu_torch.parallel import resolve_mesh

    mesh = resolve_mesh(device, mesh)
    if store is None:
        store = os.path.join(tempfile.gettempdir(), "pngloss_store")
    originals = OriginalsOnDisk(store)
    handler = type("BoundHandler", (Handler,), dict(
        originals=originals,
        compresseds=CompressedsInMemory(originals, mesh),
        prefix=prefix,
        mesh=mesh,
        _gates={"page": threading.Semaphore(MAX_CONCURRENT),
                "image": threading.Semaphore(MAX_CONCURRENT)},
        _example_cache={},
        _example_lock=threading.Lock(),
    ))
    if fcgi:
        from pngloss_tpu_torch.fcgi import FCGIServer

        return FCGIServer(_bind_listener(port, unix_socket), handler)
    if unix_socket:
        return _UnixHTTPServer(unix_socket, handler)
    return ThreadingHTTPServer(("127.0.0.1", port), handler)


def main(argv=None, *, device="cuda", mesh=None) -> int:
    from pngloss_tpu_torch.ops import CudaUnavailableError

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8117)
    ap.add_argument("--socket", default=None, metavar="PATH",
                    help="serve HTTP over this unix socket instead of a "
                         "TCP port (behind nginx: proxy_pass "
                         "http://unix:PATH;)")
    ap.add_argument("--fcgi", action="store_true",
                    help="speak the FastCGI record protocol instead of "
                         "HTTP (behind nginx: fastcgi_pass unix:PATH;)")
    ap.add_argument("--store", default=None,
                    help="directory of the original store (default: "
                         "pngloss_store in the temp directory)")
    args = ap.parse_args(argv)
    try:
        srv = make_server(args.port, args.store, unix_socket=args.socket,
                          fcgi=args.fcgi, device=device, mesh=mesh)
    except CudaUnavailableError as e:
        print(f"pngloss-tpu-torch-web: {e}", file=sys.stderr)
        return 2
    proto = "fcgi" if args.fcgi else "http"
    where = f"unix:{args.socket}" if args.socket else f"127.0.0.1:{args.port}"
    print(f"serving {proto} on {where}", flush=True)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
