"""The port's ``db/manager.py`` vs the JAX package's: fetch, the semver gate, install and the cache.

The raw-file layout of ``tests/test_db_manager_http.py``
(``<owner>/<repo>/<branch>/<db>.toml|.gbk``, seed 11, a 2-locus database) is
served by ``http.server`` on 127.0.0.1 (no outside network).  Each package
runs the same lifecycle against it, each with its own cache directory:
``install`` (fetch, compile, pickle and JSON sidecar), ``installed``,
``load``, ``get`` from the cache, the ``update`` semver gate at an equal and
at a newer remote version, ``add`` of a missing file, a refused connection,
``uninstall``.  The requests each made, the databases each compiled, the
sidecars each wrote and the errors each raised must agree; the port also
loads the JAX package's cached pickle.

Tolerance: exact.
"""

import http.server
import json
import threading
from functools import partial
from pathlib import Path

import numpy as np
import pytest
from synthetic import make_synthetic_db

OWNER, REPO, BRANCH, DBNAME = "testowner", "test-db-repo", "main", "TestDB"


class _LoggingHandler(http.server.SimpleHTTPRequestHandler):
    requests: list[str] = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        type(self).requests.append(self.path)
        super().do_GET()


def _managers():
    import kaptive_tpu.db as jdb
    import kaptive_tpu.db.models as jmodels

    import kaptive_tpu_torch.db as tdb
    import kaptive_tpu_torch.db.models as tmodels

    return {"port": (tdb.DatabaseManager, tmodels.DatabaseError), "jax": (jdb.DatabaseManager, jmodels.DatabaseError)}


@pytest.fixture()
def served(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    repo_dir = tmp_path / "www" / OWNER / REPO / BRANCH
    repo_dir.mkdir(parents=True)
    make_synthetic_db(repo_dir, rng, n_loci=2, genes_per_locus=3, name=DBNAME, keyword="http_db")
    toml_path = repo_dir / f"{DBNAME}.toml"
    toml_path.write_text(
        toml_path.read_text()
        .replace('owner = "example"', f'owner = "{OWNER}"')
        .replace('repo = "example-db"', f'repo = "{REPO}"')
    )
    handler = partial(_LoggingHandler, directory=str(tmp_path / "www"))
    _LoggingHandler.requests = []
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    monkeypatch.setenv("KAPTIVE_DB_RAW_BASE", f"http://127.0.0.1:{server.server_address[1]}")
    for manager, _ in _managers().values():
        monkeypatch.setitem(manager._KNOWN, "http_db", (OWNER, REPO, DBNAME))
    try:
        yield repo_dir, _LoggingHandler.requests
    finally:
        server.shutdown()


def _summary(db) -> dict:
    r"""What a compiled database holds, as plain values."""
    return {
        "metadata": {k: getattr(db.metadata, k) for k in db.metadata.FIELDS},
        "loci": tuple(db.loci.ids), "locus_seqs": db.loci.seqs.tobytes(),
        "genes": tuple(db.genes.ids), "gene_seqs": db.genes.seqs.tobytes(),
        "translations": db.translations.seqs.tobytes(), "serotypes": db.serotypes,
        "gene_locus_indices": db.gene_locus_indices.tolist(), "extra_genes": db.extra_genes.tolist(),
        "clusters": db.cluster_keys, "descriptions": db.description_keys,
    }


def _run(name, step, monkeypatch, tmp_path, requests):
    r"""``step(manager, error class)`` in package ``name`` with its own cache: ``(outcome, requests)``."""
    manager, error = _managers()[name]
    monkeypatch.setenv("KAPTIVE_DB_DIR", str(tmp_path / f"cache_{name}"))
    requests.clear()
    try:
        out = ("ok", step(manager, error))
    except error as exc:
        out = ("error", str(exc))
    return out, list(requests)


def _both(step, monkeypatch, tmp_path, requests):
    got = _run("port", step, monkeypatch, tmp_path, requests)
    want = _run("jax", step, monkeypatch, tmp_path, requests)
    assert got == want
    return got[0]


def test_lifecycle_equals_jax(served, monkeypatch, tmp_path):
    repo_dir, requests = served

    def run(step):
        return _both(step, monkeypatch, tmp_path, requests)

    installed = run(lambda m, e: _summary(m.install("http_db")))
    assert installed[1]["loci"][:2] == ("KL1", "KL2")
    assert run(lambda m, e: sorted(m.installed())) == ("ok", ["http_db"])
    assert run(lambda m, e: json.loads((Path(m._db_dir()) / "http_db.json").read_text()))[1]["version"] == "1.0.0"
    assert run(lambda m, e: _summary(m.load("http_db"))) == installed
    assert run(lambda m, e: _summary(m.get("http_db"))) == installed
    assert run(lambda m, e: [_summary(d) for d in m.update("http_db")]) == ("ok", [])
    assert run(lambda m, e: [_summary(d) for d in m.update("all")]) == ("ok", [])
    assert run(lambda m, e: m.install("http_db")) == ("ok", None)  # the cache is current
    toml_path = repo_dir / f"{DBNAME}.toml"
    toml_path.write_text(toml_path.read_text().replace('version = "1.0.0"', 'version = "1.2.3"'))
    newer = run(lambda m, e: [_summary(d) for d in m.update("http_db")])
    assert [d["metadata"]["version"] for d in newer[1]] == ["1.2.3"]
    # The gate reads the caller's metadata: at the remote's version nothing is compiled.
    assert run(lambda m, e: m.add(OWNER, REPO, DBNAME, local_meta=m.load("http_db").metadata)) == ("ok", None)
    run(lambda m, e: m.uninstall("http_db"))
    assert run(lambda m, e: m.installed()) == ("ok", [])
    outcome = run(lambda m, e: m.uninstall("http_db"))
    assert outcome == ("error", 'Database "http_db" has not been installed.')


def test_fetch_errors_equal_jax(served, monkeypatch, tmp_path):
    _, requests = served
    missing = _both(lambda m, e: m.add(OWNER, REPO, "NoSuchDB"), monkeypatch, tmp_path, requests)
    assert missing[0] == "error" and "Remote file not found" in missing[1]
    unknown = _both(lambda m, e: m.install("no_such_keyword"), monkeypatch, tmp_path, requests)
    assert unknown[0] == "error" and "is not a known database" in unknown[1]
    monkeypatch.setenv("KAPTIVE_DB_RAW_BASE", "http://127.0.0.1:9")  # nothing listens
    refused = {name: _run(name, lambda m, e: m.add(OWNER, REPO, DBNAME), monkeypatch, tmp_path, requests)[0]
               for name in ("port", "jax")}
    for kind, text in refused.values():
        assert kind == "error" and text.startswith("Network error: Failed to fetch http://127.0.0.1:9/")
    assert refused["port"][1].split("(")[0] == refused["jax"][1].split("(")[0]


def test_port_loads_the_jax_cache(served, monkeypatch, tmp_path):
    _, requests = served
    mgr = _managers()
    summaries = {}
    for name in ("port", "jax"):
        monkeypatch.setenv("KAPTIVE_DB_DIR", str(tmp_path / f"cache_{name}"))
        summaries[name] = _summary(mgr[name][0].install("http_db"))
    assert summaries["port"] == summaries["jax"]
    # The port reads the JAX package's pickle (through utils/state.py, importing none of it).
    monkeypatch.setenv("KAPTIVE_DB_DIR", str(tmp_path / "cache_jax"))
    requests.clear()
    assert _summary(mgr["port"][0].load("http_db")) == summaries["jax"]
    assert _summary(mgr["port"][0].get("http_db")) == summaries["jax"]
    assert requests == []
    from kaptive_tpu.db.manager import RemoteSource as JaxRemoteSource

    from kaptive_tpu_torch.db.manager import RemoteSource

    meta = mgr["port"][0].load("http_db").metadata
    for ext in ("toml", "gbk"):
        assert RemoteSource.for_metadata(meta).url(ext) == JaxRemoteSource.for_metadata(meta).url(ext)
