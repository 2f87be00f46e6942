"""The port's Kaptive-Web client (``client.py``) vs the JAX package's, against one local HTTP server.

The server of ``tests/test_client.py``, on 127.0.0.1 (no outside network):
run submission as a multipart upload, run polling, a gzip-encoded JSONL
download, an API error with a ``detail`` and a refused connection.  Each call
goes through both clients in turn; the requests each sent and the answers each
got must agree.

Tolerance: exact.  The multipart bodies are compared with each client's
random boundary replaced by a fixed one.
"""

import gzip
import http.server
import json
import re
import threading

import pytest


class _ApiHandler(http.server.BaseHTTPRequestHandler):
    seen: list[dict] = []

    def log_message(self, *a):
        pass

    def _record(self, body: bytes):
        type(self).seen.append({
            "path": self.path,
            "method": self.command,
            "api_key": self.headers.get("X-API-Key"),
            "accept": self.headers.get("Accept"),
            "content_type": self.headers.get("Content-Type", ""),
            "body": body,
        })

    def _json(self, obj, code=200):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self._record(body)
        if self.path.startswith("/api/serotype/results/download/jsonl"):
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonl")
            self.send_header("Content-Encoding", "gzip")
            self.end_headers()
            self.wfile.write(gzip.compress(b'{"genome":"g1"}\n{"genome":"g2"}\n'))
        elif self.path.startswith("/api/serotype/bad"):
            self._json({"detail": "species not recognised"}, code=422)
        elif self.path.startswith("/api/serotype/"):
            self._json({"run_id": "run-123"})
        else:
            self._json({"detail": "not found"}, code=404)

    def do_GET(self):
        self._record(b"")
        if self.path.startswith("/api/serotype/runs/missing"):
            self.send_response(500)
            self.end_headers()
            self.wfile.write(b"not json")
        elif self.path.startswith("/api/serotype/runs/"):
            self._json({"run_id": self.path.rsplit("/", 1)[-1], "status": "complete"})
        else:
            self._json({"detail": "not found"}, code=404)


@pytest.fixture()
def api_server():
    _ApiHandler.seen = []
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _ApiHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", _ApiHandler.seen
    finally:
        server.shutdown()


def _clients(*args, **kwargs):
    import kaptive_tpu.client as jc

    import kaptive_tpu_torch.client as tc

    return (tc.KaptiveWebClient(*args, **kwargs), tc.KaptiveWebClientError), (
        jc.KaptiveWebClient(*args, **kwargs), jc.KaptiveWebClientError)


def _outcome(call, error_cls):
    try:
        return "ok", call()
    except error_cls as exc:
        return "error", str(exc)


def _fixed_boundary(request: dict) -> dict:
    m = re.search(r"boundary=(\w+)", request["content_type"])
    if m is None:
        return request
    b = m[1].encode()
    return {**request, "content_type": request["content_type"].replace(m[1], "B"),
            "body": request["body"].replace(b, b"B")}


def test_every_call_sends_and_answers_as_jax(api_server, tmp_path):
    base, seen = api_server
    for name, body in (("g1.fasta", b">c1\nACGT\n"), ("g2.fa", b">c1\nTTTT\n"), ("notes.txt", b"x")):
        (tmp_path / name).write_bytes(body)
    files = [str(tmp_path / n) for n in ("g1.fasta", "g2.fa", "notes.txt")]
    calls = [
        lambda c: c.submit_genomes("Klebsiella pneumoniae", files),
        lambda c: c.submit_genomes("bad", files[:1]),
        lambda c: c.get_run("run-123"),
        lambda c: c.get_run("missing"),
        lambda c: c.download_jsonl(["g1", "g2"]),
    ]
    (port, port_err), (jax, jax_err) = _clients("secret-key", base_url=base)
    for call in calls:
        seen.clear()
        got = _outcome(lambda: call(port), port_err)
        sent = [_fixed_boundary(r) for r in seen]
        seen.clear()
        want = _outcome(lambda: call(jax), jax_err)
        assert got == want
        assert sent == [_fixed_boundary(r) for r in seen]
    assert _outcome(lambda: calls[0](port), port_err) == ("ok", "run-123")
    assert _outcome(lambda: calls[1](port), port_err) == ("error", "HTTP 422: species not recognised")
    assert _outcome(lambda: calls[4](port), port_err) == ("ok", b'{"genome":"g1"}\n{"genome":"g2"}\n')


def test_connection_error_and_base_url_as_jax():
    (port, port_err), (jax, jax_err) = _clients("k", base_url="http://127.0.0.1:9")  # nothing listens
    got, want = _outcome(lambda: port.get_run("x"), port_err), _outcome(lambda: jax.get_run("x"), jax_err)
    assert got[0] == want[0] == "error" and "Network error" in got[1]
    assert got[1].split("(")[0] == want[1].split("(")[0]
    for url in ("http://h:1/", "http://h:1/api", "http://h:1/api/", "https://kaptive.example"):
        (p, _), (j, _) = _clients("k", url)
        assert p.base_url == j.base_url and p.api_key == j.api_key
