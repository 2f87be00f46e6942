"""The port's copies of the backend-neutral modules vs the JAX package's, on the same seeded inputs.

``Sequences.extract`` / ``translate``, ``Intervals``, ``GenomeAssembly.from_stream``,
``Database.from_genbank`` field by field, every function of the native host
library (the port's ``csrc/hostio.cpp`` against the JAX package's
``native/hostio.cpp``), report-row bytes, BLOSUM62 and the synthetic-database
builders.  Each side is built from the same numpy arrays or the same bytes.
State is carried across only as a pickle, by ``loads_reference``: a database
pickled by the JAX package (its gene index, JAX arrays and all, cached
inside) loads in a process where ``kaptive_tpu`` and jax are blocked and types
to the same rows.  Tolerance: exact.
"""

import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from synthetic import make_genome_from_locus, make_synthetic_db
from typing_panel import assert_same

ROOT = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)  # the test runs beside other test processes


def _both(path: str, name: str):
    """``(port, JAX)`` attribute ``name`` of the modules ``kaptive_tpu_torch.<path>`` and ``kaptive_tpu.<path>``."""
    import importlib

    return (getattr(importlib.import_module(f"kaptive_tpu_torch.{path}"), name),
            getattr(importlib.import_module(f"kaptive_tpu.{path}"), name))


def _random_dna_list(rng, n: int, lo: int, hi: int) -> list[bytes]:
    return [np.frombuffer(b"ACGTN", np.uint8)[rng.choice(5, int(rng.integers(lo, hi)), p=[.24, .24, .24, .24, .04])]
            .tobytes() for _ in range(n)]


def test_sequences_extract_and_translate():
    rng = np.random.default_rng(61)
    seqs = _random_dna_list(rng, 12, 60, 400)
    port, ref = (cls.from_bytes(seqs) for cls in _both("core.seq", "Sequences"))
    assert_same(port, ref)
    n = 40
    idx = rng.integers(0, len(seqs), n).astype(np.int32)
    lens = np.array([len(seqs[i]) for i in idx])
    starts = (rng.random(n) * lens * 0.5).astype(np.int32)
    ends = (starts + 1 + rng.random(n) * (lens - starts - 1)).astype(np.int32)
    strands = rng.choice(np.array([1, -1], np.int8), n)
    got, want = port.extract(idx, starts, ends, strands), ref.extract(idx, starts, ends, strands)
    assert_same(got, want)
    frames = rng.integers(0, 3, n)
    for kw in (dict(), dict(frames=frames), dict(frames=frames, to_stop=True)):
        assert_same(got.translate(**kw), want.translate(**kw))
    assert_same(got.translate().internal_stops, want.translate().internal_stops)
    assert got.to_fasta() == want.to_fasta()
    assert_same(got.unique(), want.unique())
    assert_same(got.to_dict(), want.to_dict())
    assert_same(type(got).concat([got, port]), type(want).concat([want, ref]))


def test_intervals():
    rng = np.random.default_rng(62)
    n = 200
    starts = rng.integers(0, 5000, n).astype(np.int32)
    ends = (starts + rng.integers(1, 400, n)).astype(np.int32)
    strands = rng.choice(np.array([1, -1, 0], np.int8), n)
    port, ref = (cls(starts, ends, strands) for cls in _both("core.interval", "Intervals"))
    assert_same(port, ref)
    groups = rng.integers(0, 4, n)
    order = rng.permutation(n).astype(np.int32)
    for call in (
        lambda x: x.cull_overlaps(order),
        lambda x: x.cull_overlaps(order, 0.3, group_by=groups, secondary_group_by=groups % 2),
        lambda x: x.cluster_spatial(),
        lambda x: x.cluster_spatial(25, group_by=groups),
        lambda x: x.cluster_sequential(50, group_by=np.sort(groups), enforce_strand=True),
        lambda x: x.shift(7),
        lambda x: x[order[:30]],
        lambda x: x.to_dict(),
    ):
        assert_same(call(port), call(ref))
    pieces = (np.array([0, 3000], np.int32), np.array([2800, 5500], np.int32), np.array([1, -1], np.int8))
    p_idx = (starts >= 3000).astype(np.int32)
    assert_same(port.arrange(p_idx, np.array([1, 0]), *pieces), ref.arrange(p_idx, np.array([1, 0]), *pieces))


def _piled(rng, n_groups: int, per: int, sites: int = 26):
    """``per`` hits a group piled on ``sites`` loci 3 kb apart, as family copies pile on a locus."""
    n = n_groups * per
    starts = rng.integers(0, sites, n) * 3000 + rng.integers(-200, 200, n)
    ends = starts + rng.integers(-5, 1500, n)
    return starts, ends, rng.permutation(n), dict(group_by=np.repeat(np.arange(n_groups), per))


def _at_the_threshold(frac: float):
    """Pairs (kept first, then the other) whose overlap is ``frac`` x the shorter length and one
    base either side, for several lengths of each; one group a pair."""
    rows = []
    for len_a in (10, 30, 33, 50, 70, 100, 1000):
        for len_b in (len_a, 50, 1000):
            edge = int(frac * min(len_a, len_b))
            for ov in (edge - 1, edge, edge + 1):
                rows += [(0, len_a), (len_a - ov, len_a - ov + len_b)]
    starts, ends = np.array(rows).T
    n = len(rows)
    return starts, ends, np.arange(n), dict(max_overlap_fraction=frac, group_by=np.arange(n) // 2)


def _cull_case(name: str, rng):
    """``(starts, ends, order, keyword arguments)`` of one parity case of the overlap cull."""
    if name == "score_ties":
        starts, ends, _, kw = _piled(rng, 3, 120)
        scores = rng.integers(0, 4, len(starts))
        return starts, ends, np.lexsort((-scores,)), kw
    if name == "empty_and_negative_lengths":
        starts, ends, order, kw = _piled(rng, 2, 150)
        ends[::7] = starts[::7]
        ends[3::11] = starts[3::11] - rng.integers(1, 50, len(starts[3::11]))
        return starts, ends, order, kw
    if name == "threshold_0.1":
        return _at_the_threshold(0.1)
    if name == "threshold_0.3":
        return _at_the_threshold(0.3)
    if name == "secondary_group_by":
        starts, ends, order, kw = _piled(rng, 4, 100)
        return starts, ends, order, dict(kw, max_overlap_fraction=0.3, secondary_group_by=rng.integers(0, 3, len(starts)))
    if name == "secondary_group_by_alone":
        starts, ends, order, _ = _piled(rng, 1, 200)
        return starts, ends, order, dict(secondary_group_by=rng.integers(0, 3, len(starts)))
    if name == "order_a_strict_subset":
        starts, ends, order, kw = _piled(rng, 3, 100)
        return starts, ends, order[: len(order) // 3], kw
    if name == "order_with_repeats_and_negative_indices":
        starts, ends, order, kw = _piled(rng, 2, 80)
        order = np.concatenate([order[:60] - len(order), order, order[:40]])
        return starts, ends, order, kw
    if name == "one_group_no_keys":
        starts, ends, order, _ = _piled(rng, 1, 300)
        return starts, ends, order, {}
    if name == "single_hit":
        return np.array([5]), np.array([90]), np.array([0]), {}
    if name == "empty":
        return np.zeros(0), np.zeros(0), np.zeros(0), {}
    if name == "batch_64_groups":
        return _piled(rng, 64, 300)
    raise KeyError(name)


@pytest.mark.parametrize("case", [
    "score_ties", "empty_and_negative_lengths", "threshold_0.1", "threshold_0.3", "secondary_group_by",
    "secondary_group_by_alone", "order_a_strict_subset", "order_with_repeats_and_negative_indices",
    "one_group_no_keys", "single_hit", "empty", "batch_64_groups",
])
def test_cull_overlaps_equals_jax(case):
    """The port's one C pass keeps the mask of the JAX package's greedy loop."""
    starts, ends, order, kw = _cull_case(case, np.random.default_rng(sum(map(ord, case))))
    strands = np.ones(len(starts), np.int8)
    port, ref = (cls(starts.astype(np.int32), ends.astype(np.int32), strands)
                 for cls in _both("core.interval", "Intervals"))
    order = np.asarray(order, dtype=np.int32)
    got, want = port.cull_overlaps(order, **kw), ref.cull_overlaps(order, **kw)
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    if case == "order_a_strict_subset":
        assert not got[np.setdiff1d(np.arange(len(starts)), order)].any()


def test_genome_assembly_from_stream():
    rng = np.random.default_rng(63)
    contigs = _random_dna_list(rng, 5, 200, 900)
    fasta = b"".join(b">ctg%d some description\n%s\n%s\n" % (i, c[:70], c[70:]) for i, c in enumerate(contigs))
    port, ref = (cls.from_stream(io.BytesIO(fasta), "asm") for cls in _both("core.genome", "GenomeAssembly"))
    assert port.id == ref.id == "asm" and port.id_map == ref.id_map and len(port) == len(ref)
    assert_same(port.contigs, ref.contigs)
    assert port["ctg3"] == ref["ctg3"] == contigs[3]
    got, want = port.get_minimizer_index(), ref.get_minimizer_index()
    assert type(got).__module__ == "kaptive_tpu_torch.ops.minimizer"
    for name in ("codes", "starts", "lengths"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("core_db")
    rng = np.random.default_rng(64)
    gbk, truth = make_synthetic_db(tmp, rng, n_loci=3, genes_per_locus=4)
    fasta = make_genome_from_locus(rng, truth, "KL3", sub_rate=0.01)
    (tmp / "g.fasta").write_bytes(fasta)
    port, ref = (cls.from_genbank(gbk) for cls in _both("db", "Database"))
    return port, ref, tmp, gbk


def _assert_databases_equal(got, want):
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    assert got.metadata.to_dict() == want.metadata.to_dict()
    for name in names:
        if name != "metadata" and not name.startswith("_"):
            assert_same(getattr(got, name), getattr(want, name), name)


def test_database_from_genbank_field_by_field(databases):
    port, ref, _, _ = databases
    assert type(port).__module__ == "kaptive_tpu_torch.db.core"
    _assert_databases_equal(port, ref)
    assert port.max_locus_length == ref.max_locus_length
    assert type(port.gene_index).__module__ == "kaptive_tpu_torch.ops.mapper"


def test_synthetic_builders_write_the_same_files(tmp_path):
    from torch_synthetic import make_synthetic_db as make_port_db

    for maker, sub in ((make_synthetic_db, "jax"), (make_port_db, "port")):
        (tmp_path / sub).mkdir()
        maker(tmp_path / sub, np.random.default_rng(9), n_loci=2, genes_per_locus=3)
    for name in ("TestDB.gbk", "TestDB.toml"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_blosum62_and_version():
    port, ref = (fn() for fn in _both("core.pairwise", "blosum62_matrix"))
    assert_same(port, ref)
    import kaptive_tpu_torch

    assert kaptive_tpu_torch.__version__


@pytest.fixture(scope="module")
def hostio_pair():
    from kaptive_tpu.native import hostio as ref

    from kaptive_tpu_torch.native import hostio as port

    assert port.LIBRARY.parent.name == "kaptive_tpu_torch" and port.LIBRARY.parent.parent.name == "build"
    return port, ref


def test_hostio_parse_fasta_and_encode(hostio_pair):
    port, ref = hostio_pair
    rng = np.random.default_rng(65)
    contigs = _random_dna_list(rng, 7, 1, 3000)
    fasta = b"".join(b">c%d\tdesc\r\n%s\r\n\n%s\n" % (i, c[:61], c[61:]) for i, c in enumerate(contigs))
    for data in (fasta, b"", b">only_header\n", fasta.lower()):
        assert port.parse_fasta_bytes(data) == ref.parse_fasta_bytes(data)
    assert [s for _, s in port.parse_fasta_bytes(fasta)] == contigs
    seq = np.frombuffer(b"".join(contigs) + b"acgtunRYKM-*", np.uint8)
    np.testing.assert_array_equal(port.encode_dna(seq), ref.encode_dna(seq))


@pytest.mark.parametrize("n_bad", [3, 40000], ids=["sparse-exceptions", "exceptions-overflow"])
def test_hostio_build_contig_stream(hostio_pair, n_bad):
    port, ref = hostio_pair
    rng = np.random.default_rng(66)
    seqs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 200_000)].copy()
    seqs[rng.integers(0, len(seqs), n_bad)] = ord("N")
    lengths = np.array([70_000, 1, 129_999], np.int64)
    offsets = np.array([0, 70_000, 70_001], np.int64)
    got = port.build_contig_stream(seqs, offsets, lengths, 14, 1 << 18, 32768)
    want = ref.build_contig_stream(seqs, offsets, lengths, 14, 1 << 18, 32768)
    for g, w in zip(got, want, strict=True):
        assert_same(g, w)
    assert (got[4] > 32768) == (n_bad == 40000)


def test_hostio_seed_anchors(hostio_pair, databases):
    """The AVX-512 and the scalar fill of the minimizer keys (positions cut to 32 bits in the port's copy)."""
    port, ref = hostio_pair
    db, _, tmp, _ = databases
    from kaptive_tpu_torch.core.genome import GenomeAssembly

    gi = db.gene_index
    ci = GenomeAssembly.from_file(tmp / "g.fasta").get_minimizer_index()
    for kw in (dict(), dict(cap_out=8),
               dict(bloom_words=gi.host_bloom, bloom_bits=27, bucket_starts=gi.host_buckets, bucket_shift=12)):
        got = port.seed_anchors(ci.codes, gi.k, gi.w, gi.minimizers.hashes, 64, **kw)
        want = ref.seed_anchors(ci.codes, gi.k, gi.w, gi.minimizers.hashes, 64, **kw)
        assert len(want[0]) > 50
        for g, w in zip(got, want, strict=True):
            assert_same(g, w)


def test_hostio_builds_once_under_concurrent_loads(tmp_path):
    """Two processes that find no library build it at once, each to a temporary
    name, and both load a whole library: nothing is left half-written."""
    script = (
        "import sys\n"
        "from pathlib import Path\n"
        "from kaptive_tpu_torch.native import hostio\n"
        "hostio.LIBRARY = Path(sys.argv[1]) / 'libkaptive_hostio.so'\n"
        "hostio.BUILD_DIR = Path(sys.argv[1])\n"
        "print(hostio.parse_fasta_bytes(b'>a\\nACGT\\n'))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        assert out.strip() == "[('a', b'ACGT')]"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libkaptive_hostio.so"]


def test_report_rows_equal_jax(databases):
    """One result, serialised once, read back by each package: KaptiveRow and Pha4geRow bytes agree."""
    port_db, _, tmp, _ = databases
    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.serotyping.cli import result_to_jsonl_bytes

    result = Serotyper(port_db, device="cpu")(tmp / "g.fasta")
    assert result.best_locus_name == "KL3"
    line = json.loads(result_to_jsonl_bytes(result))
    port_result, ref_result = (cls.from_dict(line) for cls in _both("serotyping.models", "SerotypingResult"))
    for row in ("KaptiveRow", "Pha4geRow"):
        port_row, ref_row = _both("serotyping.io", row)
        assert port_row.header() == ref_row.header()
        assert bytes(port_row.from_result(port_result)) == bytes(ref_row.from_result(ref_result))
        assert bytes(port_row.from_result(result)) == bytes(ref_row.from_result(ref_result))
    assert_same(port_result.to_dict(), ref_result.to_dict())


@pytest.mark.parametrize("path,name", [("core.seq", "Sequences"), ("core.interval", "Intervals"),
                                        ("core.alignment", "Alignments"), ("db", "Database")])
def test_loads_reference_round_trip(databases, path, name):
    """``pickle.dumps`` of a JAX-package object loads as the port's object of the same name, field for field."""
    from kaptive_tpu_torch.utils.state import loads_reference

    port_db, ref_db, tmp, _ = databases
    port_cls, ref_cls = _both(path, name)
    if name == "Database":
        assert ref_db.gene_index.device_table is not None  # a JAX GeneIndex, device arrays and all, in its cache
        ref_obj, port_obj = ref_db, port_db
    elif name == "Alignments":
        from kaptive_tpu.core.genome import GenomeAssembly as RefAssembly
        from kaptive_tpu.ops.mapper import map_genes_batch as ref_map

        from kaptive_tpu_torch.core.genome import GenomeAssembly
        from kaptive_tpu_torch.ops.mapper import map_genes_batch

        names = tuple(str(i) for i in range(len(ref_db.genes)))
        ref_obj = ref_map(ref_db.gene_index, [RefAssembly.from_file(tmp / "g.fasta")], names, seed_mode="host")[0]
        port_obj = map_genes_batch(port_db.gene_index, [GenomeAssembly.from_file(tmp / "g.fasta")], names,
                                   seed_mode="host", device="cpu")[0]
        assert len(ref_obj) > 0
    else:
        ref_obj = ref_db.genes if name == "Sequences" else ref_db.gene_intervals
        port_obj = port_db.genes if name == "Sequences" else port_db.gene_intervals
    assert type(ref_obj) is ref_cls and type(port_obj) is port_cls
    carried = loads_reference(pickle.dumps(ref_obj))
    assert type(carried) is port_cls
    again = loads_reference(pickle.dumps(port_obj))
    assert type(again) is port_cls
    if name == "Database":
        _assert_databases_equal(carried, ref_db)
        _assert_databases_equal(again, ref_db)
        assert carried._gene_index_cache == []  # dropped: rebuilt as the port's at first use
        assert type(carried.gene_index).__module__ == "kaptive_tpu_torch.ops.mapper"
    else:
        assert_same(carried, ref_obj)
        assert_same(again, ref_obj)


_TYPE_WITHOUT_THE_JAX_PACKAGE = r"""
import importlib.abc, json, sys

FOREIGN = ("jax", "jaxlib", "kaptive_tpu")


class BlockForeign(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FOREIGN:
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
        return None


sys.meta_path.insert(0, BlockForeign())
import torch

torch.set_num_threads(1)
from kaptive_tpu_torch.db import Database
from kaptive_tpu_torch.serotyping import KaptiveRow, Serotyper

db = Database.load(sys.argv[1])
row = bytes(KaptiveRow.from_result(Serotyper(db, device="cpu")(sys.argv[2])))
print(json.dumps({"row": row.decode(), "cache": len(db._gene_index_cache),
                  "foreign": sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)}))
"""


def test_jax_pickled_database_types_without_the_jax_package(databases):
    from kaptive_tpu.serotyping import Serotyper as RefSerotyper
    from kaptive_tpu.serotyping.io import KaptiveRow as RefRow

    _, ref_db, tmp, _ = databases
    assert ref_db.gene_index.device_table is not None
    ref_db.save(tmp / "jax_db.pkl")
    assert b"kaptive_tpu.ops.mapper" in (tmp / "jax_db.pkl").read_bytes()
    want = bytes(RefRow.from_result(RefSerotyper(ref_db)(tmp / "g.fasta")))
    proc = subprocess.run(
        [sys.executable, "-c", _TYPE_WITHOUT_THE_JAX_PACKAGE, str(tmp / "jax_db.pkl"), str(tmp / "g.fasta")],
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["foreign"] == []
    assert out["row"].encode() == want
    assert out["cache"] == 1  # the port's own gene index, built after the load
