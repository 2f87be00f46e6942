"""The port's host-seeded mapper and protein aligner vs the JAX package's.

The port's GeneIndex is built over the JAX GeneIndex's arrays (the DB gene
table is the "weights" both compute on) and, independently, from the DB's
genes.  Mapping runs on the CPU (plain PyTorch DP) against the JAX package's
``map_genes_batch(..., seed_mode="host")``.  Tolerance: exact.
"""

import io

import numpy as np
import pytest
import torch
from swg_panels import AA
from typing_panel import assert_same, make_typing_panel

from kaptive_tpu.core.genome import GenomeAssembly
from kaptive_tpu.core.seq import Sequences

# One intra-op thread: the plain DP issues many tiny ops, and idle OpenMP
# workers spinning in several test processes at once starve the JAX side.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    db, genomes = make_typing_panel(tmp_path_factory.mktemp("torch_mapper"))
    assemblies = [GenomeAssembly.from_stream(io.BytesIO(f), n) for n, f in genomes]
    return db, assemblies


def test_gene_index_equals_jax(panel):
    from kaptive_tpu_torch.ops.mapper import GeneIndex

    db, _ = panel
    ref = db.gene_index
    for gi in (GeneIndex.from_reference(ref), GeneIndex.build(db.genes)):
        assert_same(gi.minimizers, ref.minimizers)
        for name in ("codes", "starts", "lengths", "host_buckets", "host_bloom"):
            np.testing.assert_array_equal(getattr(gi, name), getattr(ref, name), err_msg=name)
        assert (gi.k, gi.w) == (ref.k, ref.w)


def test_host_seed_chains_equal_jax(panel):
    from kaptive_tpu.ops.mapper import MapperParams as JaxParams
    from kaptive_tpu.ops.mapper import host_seed_chains as jax_chains

    from kaptive_tpu_torch.ops.mapper import GeneIndex, MapperParams, host_seed_chains
    from kaptive_tpu_torch.ops.minimizer import ContigIndex

    db, assemblies = panel
    gi = GeneIndex.from_reference(db.gene_index)
    for ga in assemblies:
        ci = ContigIndex.build(ga.contigs)
        np.testing.assert_array_equal(ci.codes, ga.get_minimizer_index().codes)
        got = host_seed_chains(gi, ci, MapperParams())
        want = jax_chains(db.gene_index, ga.get_minimizer_index(), JaxParams())
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_numpy_seeding_equals_native(panel):
    """Without a C++ compiler the port seeds with numpy: same contig stream, same chains."""
    from kaptive_tpu_torch.ops.mapper import (
        GeneIndex, MapperParams, chain_anchors, find_anchors, host_seed_chains,
    )
    from kaptive_tpu_torch.ops.minimizer import ContigIndex, concat_with_sentinels, encode_dna

    db, assemblies = panel
    gi = GeneIndex.from_reference(db.gene_index)
    params = MapperParams()
    for ga in assemblies:
        ci = ContigIndex.build(ga.contigs)
        c = ga.contigs
        flat, _ = concat_with_sentinels(encode_dna(c.seqs), c.offsets, c.lengths, gi.k)
        np.testing.assert_array_equal(flat, ci.codes)
        got = chain_anchors(*find_anchors(gi, ci.minimizers, params), gi.lengths, gi.k, params)
        want = host_seed_chains(gi, ci, params)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_map_genes_batch_equals_jax_host_mode(panel):
    from kaptive_tpu.ops.mapper import map_genes_batch as jax_map

    from kaptive_tpu_torch.ops.mapper import GeneIndex, map_genes_batch

    db, assemblies = panel
    names = tuple(str(i) for i in range(len(db.genes)))
    want = jax_map(db.gene_index, assemblies, names, seed_mode="host")
    got = map_genes_batch(GeneIndex.from_reference(db.gene_index), assemblies, names, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(w) > 0
        assert_same(g, w)


def test_device_seed_mode_is_not_ported(panel):
    from kaptive_tpu_torch.ops.mapper import GeneIndex, map_genes_batch

    db, assemblies = panel
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        map_genes_batch(GeneIndex.from_reference(db.gene_index), assemblies[:1], ("0",),
                        seed_mode="device", device="cpu")


@pytest.mark.parametrize("seeded", [False, True])
def test_pairwise_aligner_equals_jax(seeded):
    from kaptive_tpu.core.pairwise import PairwiseAligner as JaxAligner
    from kaptive_tpu.ops.swg import SwgLattice as JaxLattice

    from kaptive_tpu_torch.core.pairwise import PairwiseAligner
    from kaptive_tpu_torch.ops.swg import SwgLattice

    rng = np.random.default_rng(31 + seeded)
    alpha = np.frombuffer(AA, np.uint8)
    qs, ts = [], []
    for _ in range(40):
        a = alpha[rng.integers(0, 20, int(rng.integers(0, 220)))]
        if rng.random() < 0.7:
            b = a.copy()
            b[rng.random(len(b)) < 0.15] = alpha[rng.integers(0, 20)]
            b = np.concatenate([b[int(rng.integers(0, 10)):], alpha[rng.integers(0, 20, 5)]])
        else:
            b = alpha[rng.integers(0, 20, int(rng.integers(0, 260)))]
        qs.append(a.tobytes())
        ts.append(b.tobytes())
    queries, targets = Sequences.from_bytes(qs), Sequences.from_bytes(ts)
    seeds = None
    if seeded:
        seeds = type("Seeds", (), {"offsets": rng.integers(-6, 6, len(qs)).astype(np.int32)})()
    lattice_kw = dict(max_len=200, len_slack=50, batch=32, tail_batch=16)
    for lattice in (None, lattice_kw):
        got = PairwiseAligner(
            lattice=SwgLattice.for_max_len(**lattice) if lattice else None, device="cpu"
        )(queries, targets, seeds)
        want = JaxAligner(lattice=JaxLattice.for_max_len(**lattice) if lattice else None)(
            queries, targets, seeds
        )
        assert_same(got, want)
