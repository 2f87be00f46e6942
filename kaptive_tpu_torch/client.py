r"""Client for the Kaptive-Web HTTP API.

Speaks the same wire protocol as the reference implementation
(``kaptive/client.py:27-183``): authenticated genome
submission via multipart upload, run polling, and gzip-compressed JSONL
download — implemented here as a thin class over small functional transport
helpers (stdlib urllib only).
"""

from __future__ import annotations

import gzip
import json
import secrets
from pathlib import Path
from typing import Any
from urllib import error as _uerr
from urllib import request as _ureq
from urllib.parse import quote


class KaptiveWebClientError(Exception):
    r"""Network failure or API-level error reported by the Kaptive-Web service."""


def _mime_of(path: str) -> str:
    import mimetypes

    guessed, _ = mimetypes.guess_type(path)
    return guessed or "application/octet-stream"


def _multipart(paths: list[str]) -> tuple[bytes, str]:
    r"""Frame files as one ``multipart/form-data`` payload under field ``files``."""
    boundary = secrets.token_hex(16)
    parts = []
    for p in paths:
        head = (
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="files"; filename="{Path(p).name}"\r\n'
            f"Content-Type: {_mime_of(p)}\r\n\r\n"
        )
        parts.append(head.encode() + Path(p).read_bytes() + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _decode(response) -> Any:
    r"""Read a urllib response: transparent gzip, JSON when declared, else bytes."""
    raw = response.read()
    meta = response.info()
    if meta.get("Content-Encoding") == "gzip":
        raw = gzip.decompress(raw)
    return json.loads(raw) if meta.get_content_type() == "application/json" else raw


def _http_detail(exc: _uerr.HTTPError) -> str:
    r"""Pull the API's ``detail`` field out of an error body, if it has one."""
    try:
        return json.loads(exc.read()).get("detail", str(exc))
    except Exception:
        return str(exc)


class KaptiveWebClient:
    r"""Kaptive-Web API connection: holds the key + root URL, issues typed calls."""

    def __init__(
        self, api_key: str, base_url: str = "http://127.0.0.1:8000"
    ) -> None:
        root = base_url.rstrip("/")
        self.base_url = root if root.endswith("/api") else f"{root}/api"
        self.api_key = api_key

    def _call(
        self,
        method: str,
        endpoint: str,
        payload: bytes | None = None,
        content_type: str | None = None,
    ) -> Any:
        headers = {"X-API-Key": self.api_key, "Accept": "application/json"}
        if content_type is not None:
            headers["Content-Type"] = content_type
        req = _ureq.Request(
            self.base_url + endpoint, data=payload, method=method, headers=headers
        )
        try:
            with _ureq.urlopen(req) as resp:
                return _decode(resp)
        except _uerr.HTTPError as exc:
            raise KaptiveWebClientError(f"HTTP {exc.code}: {_http_detail(exc)}") from None
        except _uerr.URLError as exc:
            raise KaptiveWebClientError(
                "Network error: Failed to connect to "
                f"{self.base_url}. Ensure you have an active internet "
                f"connection. ({exc.reason})"
            ) from None

    def submit_genomes(self, species: str, files: list[str]) -> str:
        r"""Upload assemblies for serotyping; returns the server's run id."""
        body, ctype = _multipart(files)
        return self._call("POST", f"/serotype/{quote(species)}", body, ctype).get("run_id")

    def get_run(self, run_id: str) -> dict[str, Any]:
        r"""Poll status/results for a previously submitted run."""
        return self._call("GET", f"/serotype/runs/{run_id}")

    def download_jsonl(self, genome_ids: list[str]) -> bytes:
        r"""Fetch the JSONL result payload for the given genome ids."""
        ids = json.dumps({"genome_ids": genome_ids}).encode()
        return self._call(
            "POST", "/serotype/results/download/jsonl", ids, "application/json"
        )
