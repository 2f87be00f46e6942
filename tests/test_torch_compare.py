"""The port's ``compare.py`` (``LocusComparator``) vs the JAX package's, exact.

The panels of ``tests/test_compare.py`` (seed 21: a 3-locus, 4-gene database):
all three loci, one locus against itself under two names, one locus alone and
no locus, plus a third copy whose proteins are mutated so the seeded DP sees
mismatches.  Each package compiles its own database from the same GenBank
file; the port's DP runs its plain PyTorch version (``device="cpu"``).
Tolerance: exact on every ``LocusComparisons`` field (edges, their
``PairwiseAlignments``, names, offsets, descriptions, states, intervals).
"""

import numpy as np
import pytest
import torch
from synthetic import make_synthetic_db
from typing_panel import assert_same

from kaptive_tpu import compare as jax_compare
from kaptive_tpu.db import Database as JaxDatabase

from kaptive_tpu_torch import compare as port_compare
from kaptive_tpu_torch.db import Database

torch.set_num_threads(1)  # the test runs beside other test processes


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    rng = np.random.default_rng(21)
    gbk, _ = make_synthetic_db(tmp_path_factory.mktemp("cmp_db"), rng, n_loci=3, genes_per_locus=4)
    return Database.from_genbank(gbk), JaxDatabase.from_genbank(gbk)


def _renamed(module, data, name, proteins=None):
    return module.LocusData(proteins if proteins is not None else data.proteins, name, data.backbone,
                            gene_descriptions=data.gene_descriptions)


def _mutated(sequences_cls, proteins, seed: int):
    """``proteins`` with every 23rd residue replaced (the same bytes for both packages)."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(len(proteins)):
        lo = int(proteins.offsets[p])
        seq = bytearray(proteins.seqs[lo : lo + int(proteins.lengths[p])].tobytes())
        for k in range(3, len(seq) - 1, 23):
            seq[k] = b"ARNDCQEGHILKMFPSTWYV"[int(rng.integers(0, 20))]
        out.append(bytes(seq))
    return sequences_cls.from_bytes(out)


def _inputs(module, db, sequences_cls, panel: str):
    if panel == "db-loci":
        return [db.get_locus_data(n) for n in ("KL1", "KL2", "KL3")]
    a = db.get_locus_data("KL1")
    if panel == "self":
        return [_renamed(module, a, "copy1"), _renamed(module, a, "copy2")]
    if panel == "mutated":
        return [_renamed(module, a, "copy1"), db.get_locus_data("KL2"),
                _renamed(module, a, "mutant", _mutated(sequences_cls, a.proteins, 5))]
    return {"single": [a], "empty": []}[panel]


@pytest.mark.parametrize("panel", ["db-loci", "self", "mutated", "single", "empty"])
def test_comparator_equals_jax(dbs, panel):
    from kaptive_tpu.core.seq import Sequences as JaxSequences

    from kaptive_tpu_torch.core.seq import Sequences

    db, jax_db = dbs
    got = port_compare.LocusComparator(aligner_kwargs={"device": "cpu"})(_inputs(port_compare, db, Sequences, panel))
    want = jax_compare.LocusComparator()(_inputs(jax_compare, jax_db, JaxSequences, panel))
    assert type(got) is port_compare.LocusComparisons
    assert_same(got, want)
    if panel == "self":
        assert len(got.edges) == 4 and (got.edges.alignments.pidents == 100.0).all()
    if panel == "mutated":
        assert len(got.edges) >= 3 and (got.edges.alignments.mismatches > 0).any()


def test_get_locus_data_equals_jax(dbs):
    db, jax_db = dbs
    for name in ("KL1", "KL3"):
        assert_same(db.get_locus_data(name), jax_db.get_locus_data(name))
    with pytest.raises(ValueError):
        db.get_locus_data("NOPE")


def test_comparator_validation_errors(dbs):
    from kaptive_tpu_torch.core.interval import Intervals

    a = dbs[0].get_locus_data("KL1")
    comparator = port_compare.LocusComparator(aligner_kwargs={"device": "cpu"})
    bad = Intervals(np.array([0], np.int32), np.array([10], np.int32), np.array([1], np.int8))
    with pytest.raises(ValueError, match="backbone length"):
        comparator([port_compare.LocusData(a.proteins, "bad", bad)])
    with pytest.raises(ValueError, match="gene_descriptions length"):
        comparator([port_compare.LocusData(a.proteins, "bad", a.backbone, gene_descriptions=["x"])])
