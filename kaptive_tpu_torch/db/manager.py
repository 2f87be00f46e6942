r"""Decentralised database lifecycle: fetch, version-gate, compile, cache.

Capability parity with ``kaptive/db/manager.py:32-558``:
official-DB registry, ``$KAPTIVE_DB_DIR``/``~/.kaptive`` cache of compiled
pickles with JSON metadata sidecars, threaded ``install``/``update`` with
semver gating against the remote TOML, ``add`` for arbitrary GitHub repos,
``reset``/``uninstall``, and the path-or-keyword auto-installing ``get``.

The architecture here differs from the reference: remote locations are
``RemoteSource`` records with URL templates, per-keyword cache state lives in
``_CacheSlot``, and install/update/add all funnel through one ``_refresh``
pipeline (probe TOML -> version gate -> fetch GenBank -> compile -> cache).
``$KAPTIVE_DB_RAW_BASE`` redirects fetches to a mirror or a test server.
"""

from __future__ import annotations

import json
import os
import pickle
import tomllib
import urllib.error
from collections.abc import Generator
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from tempfile import TemporaryDirectory
from typing import NamedTuple
from urllib.request import urlopen

from kaptive_tpu_torch.db.core import Database
from kaptive_tpu_torch.db.models import DatabaseError, DatabaseMetadata
from kaptive_tpu_torch.utils.state import loads_reference


class RemoteSource(NamedTuple):
    r"""A curator repository hosting one database as ``<name>.gbk`` + ``<name>.toml``."""

    owner: str
    repo: str
    name: str
    branch: str = "main"

    def url(self, ext: str) -> str:
        root = os.environ.get("KAPTIVE_DB_RAW_BASE", "https://raw.githubusercontent.com")
        return f"{root}/{self.owner}/{self.repo}/{self.branch}/{self.name}.{ext}"

    @classmethod
    def for_metadata(cls, meta: DatabaseMetadata) -> "RemoteSource":
        r"""Rebuild the source a cached database was originally fetched from."""
        return cls(meta.owner, meta.repo, Path(meta.genbank).with_suffix("").name, meta.branch)


def _download(url: str) -> bytes:
    try:
        with urlopen(url) as response:
            return response.read()
    except urllib.error.HTTPError as exc:
        if exc.code == 404:
            raise DatabaseError(
                f"Remote file not found: {url}\n"
                "Ensure the repository branch, name, and owner are correct."
            ) from exc
        raise DatabaseError(f"HTTP Error {exc.code} fetching {url}: {exc.reason}") from exc
    except urllib.error.URLError as exc:
        raise DatabaseError(
            f"Network error: Failed to fetch {url}. "
            f"Ensure you have an active internet connection. ({exc.reason})"
        ) from exc


class _CacheSlot:
    r"""Cache paths + sidecar access for one database keyword."""

    def __init__(self, kwd: str, root: Path) -> None:
        self.kwd = kwd
        self.pickle_path = root / f"{kwd}.pkl"
        self.sidecar_path = root / f"{kwd}.json"

    @property
    def present(self) -> bool:
        return self.pickle_path.is_file()

    def metadata(self) -> DatabaseMetadata | None:
        r"""Cheap version probe: sidecar if present, else unpickle."""
        if self.sidecar_path.is_file():
            return DatabaseMetadata.from_dict(json.loads(self.sidecar_path.read_text()))
        if self.present:
            return getattr(loads_reference(self.pickle_path.read_bytes()), "metadata", None)
        return None

    def read(self) -> Database:
        return loads_reference(self.pickle_path.read_bytes())

    def write(self, db: Database) -> int:
        self.sidecar_path.write_text(json.dumps(db.metadata.to_dict()))
        return self.pickle_path.write_bytes(
            pickle.dumps(db, protocol=pickle.HIGHEST_PROTOCOL)
        )

    def purge(self) -> None:
        self.pickle_path.unlink()
        self.sidecar_path.unlink(missing_ok=True)


def _compile_sources(name: str, gbk_raw: bytes, toml_raw: bytes) -> Database:
    r"""Materialise the fetched pair on disk and run the GenBank compiler."""
    with TemporaryDirectory() as tmp:
        stem = Path(tmp) / name
        stem.with_suffix(".gbk").write_bytes(gbk_raw)
        stem.with_suffix(".toml").write_bytes(toml_raw)
        return Database.from_genbank(stem.with_suffix(".gbk"))


class DatabaseManager:
    r"""Download, compile, and cache locus databases from curator GitHub repos."""

    # keyword -> (owner, repo, database stem); the official registry
    # (data mirrored from the curators' repos, ref db/manager.py:63-71).
    _KNOWN = {
        "kpsc_k": ("klebgenomics", "KpSC_surface_antigen_loci", "Klebsiella_pneumoniae_Species_Complex_K"),
        "kpsc_o": ("klebgenomics", "KpSC_surface_antigen_loci", "Klebsiella_pneumoniae_Species_Complex_O"),
        "kosc_k": ("klebgenomics", "KoSC-surface-antigen-loci", "Klebsiella_oxytoca_Species_Complex_K_locus_database"),
        "kosc_o": ("klebgenomics", "KoSC-surface-antigen-loci", "Klebsiella_oxytoca_Species_Complex_O_locus_database"),
        "ab_k": ("johannajkenyon", "Abaumannii_surface_polysaccharide_loci", "Acinetobacter_baumannii_K"),
        "ab_o": ("johannajkenyon", "Abaumannii_surface_polysaccharide_loci", "Acinetobacter_baumannii_OC"),
        "ecoli_kps": ("rgladstone", "EC-K-typing", "EC-K-typing_group2and3"),
    }

    # -- cache plumbing ---------------------------------------------------

    @classmethod
    def _db_dir(cls) -> Path:
        root = Path(os.environ.get("KAPTIVE_DB_DIR", Path.home() / ".kaptive"))
        root.mkdir(parents=True, exist_ok=True)
        return root

    @classmethod
    def _slot(cls, kwd: str, must_exist: bool = False) -> _CacheSlot:
        slot = _CacheSlot(kwd, cls._db_dir())
        if must_exist and not slot.present:
            raise DatabaseError(f'Database "{kwd}" has not been installed.')
        return slot

    # -- the shared fetch/compile pipeline --------------------------------

    @classmethod
    def _refresh(
        cls, source: RemoteSource, have: DatabaseMetadata | None = None
    ) -> Database | None:
        r"""Fetch + compile ``source`` unless the cache already has >= its version."""
        toml_raw = _download(source.url("toml"))
        remote = DatabaseMetadata.from_dict(tomllib.loads(toml_raw.decode("utf-8")))
        if have is None:
            have = cls._slot(remote.keyword).metadata()
        if have is not None and have.parsed_version >= remote.parsed_version:
            return None
        db = _compile_sources(source.name, _download(source.url("gbk")), toml_raw)
        cls.save(db)
        return db

    @classmethod
    def _refresh_many(
        cls, jobs: list[tuple[RemoteSource, DatabaseMetadata | None]]
    ) -> list[Database | None]:
        r"""Run several refreshes with the network phase overlapped in threads.

        Probe+download runs concurrently; the CPU-heavy compile runs serially
        on the main thread once each job's sources arrive.
        """

        def _probe(job: tuple[RemoteSource, DatabaseMetadata | None]):
            source, have = job
            toml_raw = _download(source.url("toml"))
            remote = DatabaseMetadata.from_dict(tomllib.loads(toml_raw.decode("utf-8")))
            if have is None:
                have = cls._slot(remote.keyword).metadata()
            if have is not None and have.parsed_version >= remote.parsed_version:
                return None
            return source.name, _download(source.url("gbk")), toml_raw

        with ThreadPoolExecutor() as pool:
            fetched = list(pool.map(_probe, jobs))
        out: list[Database | None] = []
        for item in fetched:
            if item is None:
                out.append(None)
            else:
                db = _compile_sources(*item)
                cls.save(db)
                out.append(db)
        return out

    @classmethod
    def _registry_source(cls, kwd: str) -> RemoteSource:
        spec = cls._KNOWN.get(kwd)
        if spec is None:
            raise DatabaseError(
                f'"{kwd}" is not a known database, choose from {list(cls._KNOWN.keys())}'
            )
        return RemoteSource(*spec)

    # -- public lifecycle API ---------------------------------------------

    @classmethod
    def known(cls) -> list[str]:
        r"""Keywords of the officially registered databases."""
        return list(cls._KNOWN.keys())

    @classmethod
    def installed(cls) -> list[str]:
        r"""Keywords with a compiled pickle in the cache."""
        return [p.stem for p in cls._db_dir().glob("*.pkl")]

    @classmethod
    def reset(cls) -> None:
        r"""Drop every cached pickle and sidecar."""
        for pattern in ("*.pkl", "*.json"):
            for stale in cls._db_dir().glob(pattern):
                stale.unlink()

    @classmethod
    def uninstall(cls, kwd: str) -> None:
        cls._slot(kwd, must_exist=True).purge()

    @classmethod
    def install(cls, kwd: str | list[str]) -> Database | list[Database | None] | None:
        r"""Install official databases by keyword ('all'/lists fetch concurrently)."""
        if kwd == "all":
            kwd = cls.known()
        if isinstance(kwd, list):
            return cls._refresh_many([(cls._registry_source(k), None) for k in kwd])
        return cls._refresh(cls._registry_source(kwd))

    @classmethod
    def update(cls, kwd: str | list[str] = "all") -> Generator[Database, None, None]:
        r"""Recompile installed databases whose remote version is newer."""
        targets = cls.installed() if kwd == "all" else kwd
        if isinstance(targets, str):
            targets = [targets]
        jobs = []
        for k in targets:
            cls._slot(k, must_exist=True)
            meta = cls._slot(k).metadata()
            jobs.append((RemoteSource.for_metadata(meta), meta))
        for db in cls._refresh_many(jobs):
            if db is not None:
                yield db

    @classmethod
    def add(
        cls,
        owner: str,
        repo_name: str,
        db_name: str,
        branch: str = "main",
        local_meta: DatabaseMetadata | None = None,
    ) -> Database | None:
        r"""Fetch + compile a database from any GitHub repository."""
        return cls._refresh(RemoteSource(owner, repo_name, db_name, branch), local_meta)

    @classmethod
    def load(cls, kwd: str) -> Database:
        return cls._slot(kwd, must_exist=True).read()

    @classmethod
    def save(cls, db: Database) -> int:
        return cls._slot(db.metadata.keyword).write(db)

    @classmethod
    def get(cls, file_or_keyword: str | Path) -> Database:
        r"""Resolve a direct ``.gbk``/``.pkl`` path (offline) or a keyword,
        auto-installing registered keywords that are not cached yet."""
        try:
            as_path = Path(file_or_keyword)
            if as_path.is_file():
                return Database.load(as_path)
        except (TypeError, ValueError, OSError):
            pass
        kwd = str(file_or_keyword)
        try:
            return cls.load(kwd)
        except DatabaseError:
            fresh = cls.install(kwd)
            if isinstance(fresh, list):
                fresh = fresh[0]
            # install() returns None when the cache was already current.
            return fresh if fresh is not None else cls.load(kwd)
