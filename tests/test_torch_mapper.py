"""The port's mapper (host- and device-seeded) and protein aligner vs the JAX package's.

The port's GeneIndex is built over the JAX GeneIndex's arrays (the DB gene
table is the "weights" both compute on) and, independently, from the DB's
genes.  Mapping runs on the CPU (plain PyTorch scan and DP) against the JAX
package's ``map_genes_batch(..., seed_mode=...)``; the device mode's match
and chain stages are held to ``_match_rows_batch`` and ``_chain_batch`` on
their whole output buffers, and each host fallback of device mode to host
mode's alignments.  Tolerance: exact.
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


def test_device_tables_equal_jax(panel):
    from kaptive_tpu_torch.ops.mapper import GeneIndex

    db, _ = panel
    ref = db.gene_index
    for gi in (GeneIndex.from_reference(ref), GeneIndex.build(db.genes)):
        for got, want in zip(gi.device_table("cpu"), ref.device_table):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        bs, rl, iters = gi.device_lookup("cpu")
        want_bs, want_rl, want_iters = ref.device_lookup
        np.testing.assert_array_equal(bs.numpy(), np.asarray(want_bs))
        np.testing.assert_array_equal(rl.numpy(), np.asarray(want_rl))
        assert iters == want_iters
        np.testing.assert_array_equal(gi.device_bloom("cpu").numpy().view(np.uint32), np.asarray(ref.device_bloom))
        np.testing.assert_array_equal(gi.device_codes("cpu").numpy(), np.asarray(ref.device_codes))
        np.testing.assert_array_equal(gi.device_gene_lengths("cpu").numpy(), np.asarray(ref.device_gene_lengths))


def test_match_and_chain_stages_equal_jax(panel):
    """Scan -> match -> chain on the panel batch: every output buffer equals the JAX stages'."""
    import jax.numpy as jnp

    from kaptive_tpu.ops import mapper as jm
    from kaptive_tpu.ops.scan_pallas import pad_codes_for_scan_any, rowcompact_scan_xla

    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.minimizer import ContigIndex
    from kaptive_tpu_torch.ops.scan import rowcompact_scan

    db, assemblies = panel
    ref = db.gene_index
    gi = tm.GeneIndex.from_reference(ref)
    params = tm.MapperParams()
    indexes = [ContigIndex.build(ga.contigs) for ga in assemblies]
    L = max(len(ci.codes) for ci in indexes)
    padded = np.stack([pad_codes_for_scan_any(np.pad(ci.codes, (0, L - len(ci.codes)), constant_values=4))
                       for ci in indexes])
    starts = np.full((len(indexes), max(len(ci.starts) for ci in indexes)), 0x7FFFFFFF, np.int64)
    for b, ci in enumerate(indexes):
        starts[b, : len(ci.starts)] = ci.starts
    max_occ = min(params.max_occ, tm.DEVICE_MAX_OCC)

    h, a, c = rowcompact_scan_xla(jnp.asarray(padded), gi.k, gi.w)
    bs, rl, iters = ref.device_lookup
    want_anchors, want_counts = jm._match_rows_batch(
        h, a, c, *ref.device_table, bs, rl, ref.device_bloom,
        tm.CANDIDATE_CAP, tm.ANCHOR_CAP, iters, max_occ,
    )
    want_chains, want_counts2 = jm._chain_batch(
        want_anchors, want_counts, jnp.asarray(starts.astype(np.int32)), ref.device_gene_lengths,
        gi.k, tm.CHAIN_CAP, params.max_diag_drift, params.max_anchor_gap, params.min_anchors,
    )

    th, ta, tc = rowcompact_scan(torch.from_numpy(padded), gi.k, gi.w)
    bs_t, rl_t, iters_t = gi.device_lookup("cpu")
    anchors, counts = tm.match_rows_batch(
        th, ta, tc, *gi.device_table("cpu"), bs_t, rl_t, gi.device_bloom("cpu"),
        cap_cand=tm.CANDIDATE_CAP, cap_anchors=tm.ANCHOR_CAP, lookup_iters=iters_t, max_occ=max_occ,
    )
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(want_anchors))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert int(counts[2].min()) > 0  # every genome has anchors
    chains, counts2 = tm.chain_batch(
        anchors, counts, torch.from_numpy(starts), gi.device_gene_lengths("cpu"),
        k=gi.k, cap_chains=tm.CHAIN_CAP, max_diag_drift=params.max_diag_drift,
        max_anchor_gap=params.max_anchor_gap, min_anchors=params.min_anchors,
    )
    np.testing.assert_array_equal(chains.numpy(), np.asarray(want_chains))
    np.testing.assert_array_equal(counts2.numpy(), np.asarray(want_counts2))


@pytest.fixture(scope="module")
def jax_device_alignments(panel):
    from kaptive_tpu.ops.mapper import map_genes_batch as jax_map

    db, assemblies = panel
    names = tuple(str(i) for i in range(len(db.genes)))
    return jax_map(db.gene_index, assemblies, names, seed_mode="device")


def test_map_genes_batch_device_mode_equals_jax_and_host(panel, jax_device_alignments):
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.mapper import GeneIndex, map_genes_batch

    db, assemblies = panel
    names = tuple(str(i) for i in range(len(db.genes)))
    gi = GeneIndex.from_reference(db.gene_index)
    reset_metrics()
    got = map_genes_batch(gi, assemblies, names, seed_mode="device", device="cpu")
    counts = snapshot()
    assert counts.get("map.device_chained") == len(assemblies)
    assert counts.get("scan.plain.rowcompact") == 1
    assert not any(key.startswith(("map.host_fallback", "map.host_seed")) for key in counts)
    host = map_genes_batch(gi, assemblies, names, seed_mode="host", device="cpu")
    for g, w, h in zip(got, jax_device_alignments, host, strict=True):
        assert len(w) > 0
        assert_same(g, w)
        assert_same(g, h)


def _with_insert(fasta: bytes, at: int, insert: bytes) -> bytes:
    header, seq = fasta.split(b"\n", 1)
    return header + b"\n" + seq[:at] + insert + seq[at:]


FALLBACKS = {
    # cause: (counter, module constants to shrink, sequence to insert)
    "row_overflow": ("map.host_fallback.row_overflow", {}, b"A" * 400),
    "candidates": ("map.host_fallback.candidates", {"CANDIDATE_CAP": 8}, b""),
    "anchors": ("map.host_fallback.anchors", {"ANCHOR_CAP": 8}, b""),
    "chains": ("map.host_fallback.chains", {"CHAIN_CAP": 4}, b""),
    "dense_upload": ("map.dense_upload", {}, b"N" * 33000),
}


@pytest.mark.parametrize("cause", list(FALLBACKS))
def test_device_mode_fallbacks_keep_host_rows(panel, monkeypatch, cause):
    """Each overflow cause is counted and the genome's alignments equal host mode's."""
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.minimizer import EXC_CAP

    db, assemblies = panel
    counter, caps, insert = FALLBACKS[cause]
    genomes = [GenomeAssembly.from_stream(io.BytesIO(_with_insert(
        b">c1\n" + assemblies[0].contigs.seqs.tobytes() + b"\n", 2000, insert)), "g0"), assemblies[1]]
    assert cause != "dense_upload" or len(insert) > EXC_CAP
    for name, value in caps.items():
        monkeypatch.setattr(tm, name, value)
    names = tuple(str(i) for i in range(len(db.genes)))
    gi = tm.GeneIndex.from_reference(db.gene_index)
    reset_metrics()
    got = tm.map_genes_batch(gi, genomes, names, seed_mode="device", device="cpu")
    counts = snapshot()
    assert counts.get(counter, 0) >= 1, counts
    if cause == "dense_upload":
        assert counts.get("map.device_chained") == 2
    else:
        assert counts.get("map.host_chained", 0) >= 1
    host = tm.map_genes_batch(gi, genomes, names, seed_mode="host", device="cpu")
    for g, h in zip(got, host, strict=True):
        assert len(h) > 0
        assert_same(g, h)


def test_resolve_seed_mode(monkeypatch):
    from kaptive_tpu_torch.ops.mapper import resolve_seed_mode

    monkeypatch.delenv("KAPTIVE_SEED_MODE", raising=False)
    assert resolve_seed_mode() == "host"  # the native library builds here
    assert resolve_seed_mode("device") == "device"
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "device")
    assert resolve_seed_mode() == "device"
    assert resolve_seed_mode("host") == "host"
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "gpu")
    with pytest.raises(ValueError, match="seed mode"):
        resolve_seed_mode()


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
