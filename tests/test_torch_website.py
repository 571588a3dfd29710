"""The port's website (``pngloss_tpu_torch.website``) on the CPU: the
endpoints of ``pngloss_tpu.website`` with bytes equal to
``pngloss_tpu.pipeline.compress_bytes``, over HTTP, a unix socket and
FastCGI, and a served request that loads no JAX module."""

import base64
import hashlib
import http.client
import os
import socket
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pngloss_tpu import pipeline as jax_pipeline
from pngloss_tpu.codec import encode
from pngloss_tpu.fcgi import (
    FCGI_BEGIN_REQUEST,
    FCGI_END_REQUEST,
    FCGI_PARAMS,
    FCGI_STDIN,
    FCGI_STDOUT,
    _pack_pairs,
    _pack_record,
)
from pngloss_tpu_torch import website
from pngloss_tpu_torch.ops import CudaUnavailableError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png(seed: int) -> bytes:
    rgba = np.random.default_rng(seed).integers(0, 256, (8, 8, 4), np.uint8)
    rgba[..., 3] = 255
    return encode(rgba, row_filters=None)


def _multipart(fields):
    boundary = "XtorchboundaryX"
    body = b""
    for name, value in fields.items():
        body += (f"--{boundary}\r\n"
                 f'Content-Disposition: form-data; name="{name}"'
                 "\r\n\r\n").encode()
        body += value + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _post(url, fields):
    body, ctype = _multipart(fields)
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=300)


def _sum(data: bytes) -> str:
    return base64.urlsafe_b64encode(hashlib.sha224(data).digest()).decode()


def _get_query(data: bytes, strength=19, bleed=2, strip=0) -> str:
    return (f"compressed.cgi?sum224={_sum(data)}&strength={strength}"
            f"&bleed={bleed}&strip={strip}")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    example = tmp_path_factory.mktemp("ex") / "david.png"
    example.write_bytes(_png(50))
    srv = website.make_server(port=0, store=str(
        tmp_path_factory.mktemp("store")), device="cpu")
    srv.RequestHandlerClass.example_source = str(example)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv, example
    srv.shutdown()
    t.join(timeout=30)


def test_post_get_and_cache(served, monkeypatch):
    url, srv, _ = served
    img = _png(51)
    page = _post(f"{url}/compress.cgi", {
        "file": img, "strength": b"19", "bleed": b"2", "strip": b"0"})
    assert page.status == 200
    text = page.read().decode()
    assert "compressed.cgi?sum224=" in text and 'width="8" height="8"' in text
    want = jax_pipeline.compress_bytes(img, 19, 2)
    assert urllib.request.urlopen(
        f"{url}/{_get_query(img)}", timeout=300).read() == want

    # a second GET is a cache hit: no pipeline call
    from pngloss_tpu_torch import pipeline

    calls = []
    real = pipeline.compress_bytes
    monkeypatch.setattr(pipeline, "compress_bytes",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    assert urllib.request.urlopen(
        f"{url}/{_get_query(img)}", timeout=300).read() == want
    assert calls == []
    # recompress by sum224 only, at another strength: a miss
    resp = _post(f"{url}/compress.cgi", {
        "sum224": _sum(img).encode(), "strength": b"40", "bleed": b"2",
        "strip": b"0"})
    assert resp.status == 200 and len(calls) == 1
    assert urllib.request.urlopen(
        f"{url}/{_get_query(img, 40)}", timeout=300).read() \
        == jax_pipeline.compress_bytes(img, 40, 2)
    assert len(calls) == 1


def test_concurrent_posts(served):
    url, _, _ = served
    imgs = [_png(52), _png(53)]
    got: dict = {}

    def post(k):
        _post(f"{url}/compress.cgi", {
            "file": imgs[k], "strength": b"30", "bleed": b"2",
            "strip": b"0"}).read()
        got[k] = urllib.request.urlopen(
            f"{url}/{_get_query(imgs[k], 30)}", timeout=300).read()

    threads = [threading.Thread(target=post, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert got == {k: jax_pipeline.compress_bytes(imgs[k], 30, 2)
                   for k in (0, 1)}


def test_rejects_bad_parameters_and_urls(served):
    url, _, _ = served
    img = _png(54)
    for fields in ({"strength": b"19", "bleed": b"0"},
                   {"strength": b"255", "bleed": b"2"},
                   {"strength": b"19", "bleed": b"2", "strip": b"7"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/compress.cgi", {"file": img, "strip": b"0",
                                          **fields})
        assert e.value.code == 400
    for bad in (b"file:///nonexistent/a.png", b"ftp://127.0.0.1/a.png",
                b"data:image/png;base64,AAAA"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/compress.cgi", {"url": bad, "strength": b"19",
                                          "bleed": b"2", "strip": b"0"})
        assert e.value.code == 400, bad
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/compressed.cgi?sum224=xx", timeout=30)
    assert e.value.code == 400


def test_static_pages_and_examples(served):
    url, _, example = served
    page = urllib.request.urlopen(f"{url}/", timeout=30).read().decode()
    assert "compress.cgi" in page and "example.html" in page
    assert urllib.request.urlopen(f"{url}/david.png", timeout=30).read() \
        == example.read_bytes()
    for s in (20, 40):
        data = urllib.request.urlopen(f"{url}/david-s{s}.png",
                                      timeout=300).read()
        assert data == jax_pipeline.compress_bytes(example.read_bytes(), s, 2)


def test_servers_share_no_state(tmp_path):
    a = website.make_server(port=0, store=str(tmp_path / "a"), device="cpu")
    b = website.make_server(port=0, store=str(tmp_path / "b"), device="cpu")
    try:
        ha, hb = a.RequestHandlerClass, b.RequestHandlerClass
        assert ha._gates is not hb._gates
        assert ha._example_cache is not hb._example_cache
        assert ha.compresseds is not hb.compresseds
        assert ha.mesh == (torch.device("cpu"),)
    finally:
        a.server_close()
        b.server_close()


def test_without_cuda_names_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError, match="CUDA is not available"):
        website.make_server(port=0, store=str(tmp_path / "s"))


def test_unix_socket(tmp_path):
    path = str(tmp_path / "web.sock")
    srv = website.make_server(store=str(tmp_path / "s"), unix_socket=path,
                              device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        class UDSConnection(http.client.HTTPConnection):
            def connect(self):
                self.sock = socket.socket(socket.AF_UNIX)
                self.sock.connect(path)

        conn = UDSConnection("unix")
        conn.request("GET", "/")
        resp = conn.getresponse()
        assert resp.status == 200 and b"pngloss" in resp.read()
    finally:
        srv.shutdown()
        t.join(timeout=30)


def _fcgi(path, params, body=b""):
    """One FastCGI responder request; returns (headers, body)."""
    s = socket.socket(socket.AF_UNIX)
    s.settimeout(300)
    s.connect(path)
    s.sendall(_pack_record(FCGI_BEGIN_REQUEST, 1, struct.pack(">HB5x", 1, 0))
              + _pack_record(FCGI_PARAMS, 1, _pack_pairs(params))
              + _pack_record(FCGI_PARAMS, 1, b""))
    for i in range(0, len(body), 32768):
        s.sendall(_pack_record(FCGI_STDIN, 1, body[i:i + 32768]))
    s.sendall(_pack_record(FCGI_STDIN, 1, b""))
    buf = b""
    while True:
        data = s.recv(65536)
        if not data:
            break
        buf += data
    s.close()
    out, ended = b"", False
    while buf:
        _v, rtype, _rid, clen, plen = struct.unpack(">BBHHBx", buf[:8])
        if rtype == FCGI_STDOUT:
            out += buf[8:8 + clen]
        ended |= rtype == FCGI_END_REQUEST
        buf = buf[8 + clen + plen:]
    assert ended
    head, _, payload = out.partition(b"\r\n\r\n")
    headers = dict(line.decode().split(": ", 1)
                   for line in head.split(b"\r\n"))
    return headers, payload


def test_fcgi_round_trip(tmp_path):
    path = str(tmp_path / "fcgi.sock")
    srv = website.make_server(store=str(tmp_path / "s"), unix_socket=path,
                              fcgi=True, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        img = _png(55)
        body, ctype = _multipart({"file": img, "strength": b"19",
                                  "bleed": b"2", "strip": b"0"})
        headers, page = _fcgi(path, {
            "REQUEST_METHOD": "POST", "REQUEST_URI": "/compress.cgi",
            "CONTENT_TYPE": ctype, "CONTENT_LENGTH": str(len(body))}, body)
        assert headers["Status"].startswith("200") and b"compressed" in page
        headers, data = _fcgi(path, {"REQUEST_METHOD": "GET",
                                     "REQUEST_URI": "/" + _get_query(img)})
        assert headers["Status"].startswith("200")
        assert headers["Content-Type"] == "image/png"
        assert data == jax_pipeline.compress_bytes(img, 19, 2)
    finally:
        srv.shutdown()
        t.join(timeout=30)


SERVE_WITHOUT_JAX = r"""
import base64, hashlib, sys, threading, urllib.request
import numpy as np
from pngloss_tpu.codec import encode
from pngloss_tpu_torch import website

rgba = np.random.default_rng(56).integers(0, 256, (8, 8, 4), np.uint8)
img = encode(rgba, row_filters=None)
with open(sys.argv[2], "wb") as fh:
    fh.write(img)
srv = website.make_server(port=0, store=sys.argv[1], device="cpu")
srv.RequestHandlerClass.example_source = sys.argv[2]
threading.Thread(target=srv.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{srv.server_address[1]}"
b = "XnojaxX"
body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"\r\n\r\n"
        ).encode() + img + f"\r\n--{b}--\r\n".encode()
req = urllib.request.Request(url + "/compress.cgi", data=body, headers={
    "Content-Type": f"multipart/form-data; boundary={b}"})
assert urllib.request.urlopen(req, timeout=300).status == 200
s = base64.urlsafe_b64encode(hashlib.sha224(img).digest()).decode()
q = f"/compressed.cgi?sum224={s}&strength=19&bleed=2&strip=0"
assert urllib.request.urlopen(url + q, timeout=300).read()[:4] == b"\x89PNG"
assert urllib.request.urlopen(url + "/david-s20.png",
                              timeout=300).read()[:4] == b"\x89PNG"
srv.shutdown()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m.startswith(("pngloss_tpu.ops", "pngloss_tpu.pipeline",
                        "pngloss_tpu.parallel"))]
assert not bad, bad
print("served")
"""


def test_serving_loads_no_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_WITHOUT_JAX, str(tmp_path / "store"),
         str(tmp_path / "ex.png")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "served"
