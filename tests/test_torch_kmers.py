"""The port's ``core/kmers.py`` vs the JAX package's: FracMinHash, randstrobes, seeds and the helpers.

Panels are those of ``tests/test_kmers.py``: 5,000 random bases with ten Ns
(seeds 0 and 1) and its reverse complement, three random proteins and their
~5% mutated copies in shuffled order (seed 5), a repeated protein, and the
hand-made ``Seeds`` batch.  Each package builds its own ``Sequences`` from the
same bytes; indexes, seeds and LUTs are compared field by field.

Tolerance: exact (record arrays, seeds, intervals and LUTs are integers).
"""

import dataclasses

import numpy as np
import pytest
from synthetic import random_dna, revcomp

AA = b"ARNDCQEGHILKMFPSTWYV"


def _both(name):
    import kaptive_tpu.core.kmers as jk

    import kaptive_tpu_torch.core.kmers as tk

    return getattr(tk, name), getattr(jk, name)


def _seqs(seqs):
    from kaptive_tpu.core.seq import Sequences as JaxSequences

    from kaptive_tpu_torch.core.seq import Sequences

    return Sequences.from_bytes(seqs), JaxSequences.from_bytes(seqs)


def _assert_fields_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


def _dna_panel(seed):
    rng = np.random.default_rng(seed)
    seq = bytearray(random_dna(rng, 5000))
    for i in rng.integers(0, len(seq), 10):
        seq[i] = ord("N")
    return bytes(seq)


def _protein_panel():
    rng = np.random.default_rng(5)
    prots = [bytes(AA[i] for i in rng.integers(0, len(AA), n)) for n in (120, 200, 150)]
    queries = []
    for i in [2, 0, 1]:
        p = bytearray(prots[i])
        for j in rng.integers(0, len(p), max(1, len(p) // 20)):
            p[j] = AA[rng.integers(0, len(AA))]
        queries.append(bytes(p))
    return prots, queries


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sort_by_hash", [False, True])
def test_fracminhash_build_equals_jax(seed, sort_by_hash):
    port_cls, jax_cls = _both("FracMinHashIndex")
    seq = _dna_panel(seed)
    port_seqs, jax_seqs = _seqs([seq, revcomp(seq), seq[:777]])
    got = port_cls.build(port_seqs, sort_by_hash=sort_by_hash)
    want = jax_cls.build(jax_seqs, sort_by_hash=sort_by_hash)
    assert len(want) > 50
    _assert_fields_equal(got, want)
    _assert_fields_equal(got.to_sorted(), want.to_sorted())
    for kw in (dict(k=15, scaled=10), dict(canonical=False, seed=7)):
        _assert_fields_equal(port_cls.build(port_seqs, **kw), jax_cls.build(jax_seqs, **kw))
    _assert_fields_equal(port_cls.empty(), jax_cls.empty())


def test_fracminhash_top_hits_equal_jax():
    port_cls, jax_cls = _both("FracMinHashIndex")
    targets = [_dna_panel(0), _dna_panel(1)]
    queries = [revcomp(targets[1]), targets[0][1000:4000]]
    (pt, jt), (pq, jq) = _seqs(targets), _seqs(queries)
    got = port_cls.build(pt, sort_by_hash=True).top_hits(pq)
    want = jax_cls.build(jt, sort_by_hash=True).top_hits(jq)
    _assert_fields_equal(got, want)
    assert list(got.target_indices) == [1, 0]


@pytest.mark.parametrize("sort_by_hash", [False, True])
def test_randstrobe_build_equals_jax(sort_by_hash):
    port_cls, jax_cls = _both("RandstrobeIndex")
    prots, queries = _protein_panel()
    (pt, jt) = _seqs(prots + queries)
    got = port_cls.build(pt, sort_by_hash=sort_by_hash)
    want = jax_cls.build(jt, sort_by_hash=sort_by_hash)
    assert len(want) > 100
    _assert_fields_equal(got, want)
    _assert_fields_equal(port_cls.empty(), jax_cls.empty())


@pytest.mark.parametrize("min_score", [0, 1, 5])
def test_randstrobe_top_hits_equal_jax(min_score):
    port_cls, jax_cls = _both("RandstrobeIndex")
    prots, queries = _protein_panel()
    (pt, jt), (pq, jq) = _seqs(prots), _seqs(queries)
    got = port_cls.build(pt, sort_by_hash=True).top_hits(pq, min_score=min_score)
    want = jax_cls.build(jt, sort_by_hash=True).top_hits(jq, min_score=min_score)
    _assert_fields_equal(got, want)
    if min_score == 1:
        assert list(got.target_indices) == [2, 0, 1]
    # Both refuse an unsorted target and a sorted query index alike.
    rep = [bytes(AA * 10)]
    (pr, jr) = _seqs(rep)
    for cls, s in ((port_cls, pr), (jax_cls, jr)):
        with pytest.raises(ValueError):
            cls.build(s, sort_by_hash=False).top_hits(s)
        with pytest.raises(ValueError):
            cls.build(s, sort_by_hash=True).top_hits(cls.build(s, sort_by_hash=True))


def test_seeds_container_equals_jax():
    port_cls, jax_cls = _both("Seeds")
    cols = (
        np.array([0, 1, 1, 2, 2, 2], dtype=np.uint32),
        np.array([2, 3, 4, 3, 3, 5], dtype=np.uint32),
        np.array([10, 5, 9, 9, 9, 1], dtype=np.uint32),
        np.array([-3, 0, 7, 2, 40, -1], dtype=np.int32),
    )
    got, want = port_cls(*cols), jax_cls(*cols)
    assert got[0] == want[0] and tuple(got[-1]) == tuple(want[-1])
    for g, w in ((got.top_hits(), want.top_hits()), (got.top_hits(0), want.top_hits(0)),
                 (got.top_hits(9), want.top_hits(9)), (got[1:4], want[1:4]),
                 (got.filter(cols[2] > 5), want.filter(cols[2] > 5)),
                 (port_cls.concat([got, got]), jax_cls.concat([want, want])),
                 (port_cls.empty(), jax_cls.empty())):
        _assert_fields_equal(g, w)
    q_len = np.array([30, 50, 20], dtype=np.int32)
    _assert_fields_equal(got.to_intervals(q_len), want.to_intervals(q_len))
    for kw in (dict(), dict(max_overlap_fraction=0.5), dict(priority_mask=cols[2] == 1)):
        _assert_fields_equal(got.cull_overlaps(q_len, **kw), want.cull_overlaps(q_len, **kw))
    (pq, jq), (pt, jt) = _seqs([b"AAAA", b"CCCCCC", b"GG"]), _seqs([b"T" * n for n in range(1, 7)])
    for g, w in zip(got.extract_sequences(pq, pt), want.extract_sequences(jq, jt), strict=True):
        _assert_fields_equal(g, w)


def test_luts_and_splitmix64_equal_jax():
    for name, args in (("mmseqs12_lut", ()), ("mmseqs12_lut", (9,)), ("dna_lut", ()), ("dna_lut", (7,)),
                       ("aa_lut", ()), ("aa_lut", (30,))):
        port_fn, jax_fn = _both(name)
        got, want = port_fn(*args), jax_fn(*args)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    port_fn, jax_fn = _both("splitmix64")
    x = np.random.default_rng(9).integers(0, 2**63, 1000, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    np.testing.assert_array_equal(port_fn(x), jax_fn(x))
    assert port_fn(x).dtype == np.uint64
