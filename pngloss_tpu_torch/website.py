"""HTTP frontend on the port — the counterpart of ``pngloss_tpu/website.py``.

The endpoints, limits, original store, multipart parsing, URL checks and
transports are ``pngloss_tpu.website``'s and ``pngloss_tpu.fcgi``'s own,
imported (neither imports JAX). Two places there call the JAX pipeline,
and are overridden here to call the port's on ``device`` or over ``mesh``:
``CompressedsInMemory.compress`` (the compressed.cgi result cache) and the
compressed example images of ``Handler._static``.

Each server gets its own request gates (2 in-flight requests per
endpoint), result cache and example-image cache, so two servers in one
process, or a JAX one beside a port one, share nothing. Concurrent
requests call the pipeline from several threads at once; on CUDA they
queue on each device's current stream and give the bytes a call made
alone gives.

Usage: python -m pngloss_tpu_torch.website [--port 8117] [--store DIR]
       [--socket PATH] [--fcgi]

Runs on CUDA; ``make_server`` raises, and ``main`` exits 2, with a message
that names CUDA when it is not available.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
from http.server import ThreadingHTTPServer

from pngloss_tpu import website as _web
from pngloss_tpu.website import (  # noqa: F401  (re-exported)
    MAX_CACHED,
    MAX_CONCURRENT,
    MAX_DIMENSION,
    MAX_FIELD_LENGTHS,
    OriginalsOnDisk,
    _bind_listener,
    _http_opener,
    _UnixHTTPServer,
    _url_allowed,
    parse_multipart,
    png_dimensions,
)

_EXAMPLES = ("david-s20.png", "david-s40.png")


class CompressedsInMemory(_web.CompressedsInMemory):
    """Last-10 (sum224, strength, bleed, strip) -> bytes cache whose misses
    compress on the port's pipeline over ``mesh``."""

    def __init__(self, originals: OriginalsOnDisk, mesh):
        super().__init__(originals)
        self.mesh = mesh

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


class Handler(_web.Handler):
    """``pngloss_tpu.website.Handler`` whose compressed example images
    come from the port's pipeline over ``mesh``."""

    server_version = "pngloss-tpu-torch-web"
    mesh: tuple

    def _static(self, name: str) -> bool:
        if name not in _EXAMPLES:
            return super()._static(name)
        if not os.path.exists(self.example_source):
            self._error(404, "example image unavailable")
            return True
        # serialise generation and count it against the image gate, as
        # the JAX handler does; cached hits skip the lock
        data = self._example_cache.get(name)
        if data is not None:
            self._send(data, "image/png")
            return True
        with self._example_lock:
            data = self._example_cache.get(name)
            if data is None:
                with open(self.example_source, "rb") as fh:
                    data = fh.read()
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
        return True


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
        from pngloss_tpu.fcgi import FCGIServer

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
