"""The port's mapper (host- and device-seeded) and protein aligner vs the JAX package's.

Each package compiles its own database from the same GenBank file and parses
its own assemblies from the same FASTA bytes (``torch_panel``); no object
crosses between them.  Mapping runs on the CPU (plain PyTorch scan and DP) against the JAX
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
from torch_panel import make_typing_panels
from typing_panel import assert_same

# One intra-op thread: the plain DP issues many tiny ops, and idle OpenMP
# workers spinning in several test processes at once starve the JAX side.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    return make_typing_panels(tmp_path_factory.mktemp("torch_mapper"))


def test_gene_index_equals_jax(panel):
    from kaptive_tpu_torch.ops.mapper import GeneIndex

    ref = panel.jax_db.gene_index
    assert isinstance(panel.db.gene_index, GeneIndex)
    for gi in (panel.db.gene_index, GeneIndex.build(panel.db.genes)):
        assert_same(gi.minimizers, ref.minimizers)
        for name in ("codes", "starts", "lengths", "host_buckets", "host_bloom"):
            np.testing.assert_array_equal(getattr(gi, name), getattr(ref, name), err_msg=name)
        assert (gi.k, gi.w) == (ref.k, ref.w)


def test_host_seed_chains_equal_jax(panel):
    from kaptive_tpu.ops.mapper import MapperParams as JaxParams
    from kaptive_tpu.ops.mapper import host_seed_chains as jax_chains

    from kaptive_tpu_torch.ops.mapper import MapperParams, host_seed_chains
    from kaptive_tpu_torch.ops.minimizer import ContigIndex

    gi = panel.db.gene_index
    for ga, jax_ga in zip(panel.assemblies, panel.jax_assemblies, strict=True):
        ci = ga.get_minimizer_index()
        assert isinstance(ci, ContigIndex)
        np.testing.assert_array_equal(ci.codes, jax_ga.get_minimizer_index().codes)
        got = host_seed_chains(gi, ci, MapperParams())
        want = jax_chains(panel.jax_db.gene_index, jax_ga.get_minimizer_index(), JaxParams())
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_numpy_seeding_equals_native(panel):
    """The numpy encode, concat and anchor search give the native library's contig stream and chains."""
    from kaptive_tpu_torch.ops.mapper import MapperParams, chain_anchors, find_anchors, host_seed_chains
    from kaptive_tpu_torch.ops.minimizer import ContigIndex, concat_with_sentinels, encode_dna

    gi = panel.db.gene_index
    params = MapperParams()
    for ga in panel.assemblies:
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

    from kaptive_tpu_torch.ops.mapper import map_genes_batch

    names = panel.gene_names
    want = jax_map(panel.jax_db.gene_index, panel.jax_assemblies, names, seed_mode="host")
    got = map_genes_batch(panel.db.gene_index, panel.assemblies, names, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(w) > 0
        assert_same(g, w)


def test_device_tables_equal_jax(panel):
    from kaptive_tpu_torch.ops.mapper import GeneIndex

    ref = panel.jax_db.gene_index
    for gi in (panel.db.gene_index, GeneIndex.build(panel.db.genes)):
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

    ref = panel.jax_db.gene_index
    gi = panel.db.gene_index
    params = tm.MapperParams()
    indexes = [ContigIndex.build(ga.contigs) for ga in panel.assemblies]
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

    return jax_map(panel.jax_db.gene_index, panel.jax_assemblies, panel.gene_names, seed_mode="device")


def test_map_genes_batch_device_mode_equals_jax_and_host(panel, jax_device_alignments):
    from kaptive_tpu_torch.ops.mapper import map_genes_batch
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    assemblies, names, gi = panel.assemblies, panel.gene_names, panel.db.gene_index
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


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_device_seeding_chunks_give_the_same_alignments(panel, jax_device_alignments, chunk):
    """Scan, match and chain run in chunks of the batch: any chunk size gives the unchunked alignments."""
    from kaptive_tpu_torch.ops.mapper import MapperParams, _map_genes_device_seeded
    from kaptive_tpu_torch.ops.minimizer import ContigIndex
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    assemblies = [*panel.assemblies, panel.assemblies[0]][:4]
    want = [*jax_device_alignments, jax_device_alignments[0]][:4]
    indexes = [ContigIndex.build(ga.contigs) for ga in assemblies]
    reset_metrics()
    got = _map_genes_device_seeded(panel.db.gene_index, assemblies, indexes, panel.gene_names,
                                   MapperParams(), torch.device("cpu"), chunk=chunk)
    counts = snapshot()
    assert counts.get("scan.plain.rowcompact") == -(-4 // chunk)
    assert counts.get("map.device_chained") == 4
    for g, w in zip(got, want, strict=True):
        assert len(w) > 0
        assert_same(g, w)


def test_seeding_chunk_is_the_whole_batch_on_the_cpu():
    from kaptive_tpu_torch.ops.mapper import genome_footprint, seeding_chunk

    assert seeding_chunk(1 << 20, 7, torch.device("cpu")) == 7
    assert genome_footprint(1 << 21) > genome_footprint(1 << 20) > genome_footprint(0) > 0
    assert genome_footprint(1 << 20, 2) > genome_footprint(1 << 20)  # each shard's anchors are chained together


@pytest.mark.parametrize("seed_mode", ["host", "device"])
def test_map_genes_is_map_genes_batch_on_one_genome(panel, seed_mode):
    from kaptive_tpu.ops.mapper import map_genes as jax_map_genes

    from kaptive_tpu_torch.ops.mapper import map_genes, map_genes_batch

    ga, jax_ga = panel.assemblies[1], panel.jax_assemblies[1]
    got = map_genes(panel.db.gene_index, ga, panel.gene_names, seed_mode=seed_mode, device="cpu")
    want = map_genes_batch(panel.db.gene_index, [ga], panel.gene_names, seed_mode=seed_mode, device="cpu")[0]
    assert len(got) > 0
    assert_same(got, want)
    assert_same(got, jax_map_genes(panel.jax_db.gene_index, jax_ga, panel.gene_names))


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
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.minimizer import EXC_CAP
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    assemblies = panel.assemblies
    counter, caps, insert = FALLBACKS[cause]
    genomes = [GenomeAssembly.from_stream(io.BytesIO(_with_insert(
        b">c1\n" + assemblies[0].contigs.seqs.tobytes() + b"\n", 2000, insert)), "g0"), assemblies[1]]
    assert cause != "dense_upload" or len(insert) > EXC_CAP
    for name, value in caps.items():
        monkeypatch.setattr(tm, name, value)
    names, gi = panel.gene_names, panel.db.gene_index
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


def test_a_chain_overflow_falls_back_through_the_c_seed(panel, monkeypatch):
    """A genome whose raw chains overflow ``CHAIN_CAP`` is seeded again by the native C seed, not by
    numpy's minimizer scan: ``map.host_seed.native`` and ``map.host_fallback.chains`` are counted once
    a genome, and the alignments equal host mode's."""
    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.minimizer import ContigIndex
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    names, gi, assemblies = panel.gene_names, panel.db.gene_index, panel.assemblies
    want = tm.map_genes_batch(gi, assemblies, names, seed_mode="host", device="cpu")
    monkeypatch.setattr(tm, "CHAIN_CAP", 4)
    monkeypatch.setattr(ContigIndex, "minimizers", property(lambda self: pytest.fail("numpy minimizer scan")))
    reset_metrics()
    got = tm.map_genes_batch(gi, assemblies, names, seed_mode="device", device="cpu")
    counts = snapshot()
    n = len(assemblies)
    assert counts.get("map.host_fallback.chains") == counts.get("map.host_seed.native") == n, counts
    assert counts.get("map.host_chained") == n and "map.device_chained" not in counts
    for g, w in zip(got, want, strict=True):
        assert len(w) > 0
        assert_same(g, w)


FAMILY_RICH = {
    "name": "family_rich", "db_name": "Family_rich_synthetic", "organism": "Testus syntheticus", "taxon": 12345,
    "gene_nt": [2100, 2400], "spacer_nt": [80, 200], "tail_nt": 150,
    "family_identity": [0.99, 0.999],
    "loci": [{"name": f"KL{i}", "type": f"K{i}", "genes": ["famA", "famB", f"orf{i}"]} for i in range(1, 33)],
    "genome_nt": 20000, "id_threshold": 82.5,
}


def test_a_family_rich_genome_is_chained_on_the_device(tmp_path):
    """32 loci share two gene families at 99-99.9%, so a genome's one planted member of each anchors
    every copy: more anchors than the JAX package's 16,384, which device mode holds and chains
    itself, with host mode's alignments."""
    import sys
    from pathlib import Path

    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.db import Database
    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.minimizer import ContigIndex
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    bench = str(Path(__file__).resolve().parent.parent / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from kbench import gen

    rng_db, rng_asm = gen.seed_streams(2**31 + 21, 2)
    synthetic = gen.make_database(FAMILY_RICH, rng_db)
    gbk = tmp_path / "family_rich.gbk"
    gbk.write_text(synthetic.genbank)
    gbk.with_suffix(".toml").write_text(synthetic.toml)
    db = Database.from_genbank(gbk)
    clean = {"name": "clean", "sub_rate": 0.0, "split": "none"}
    asm = gen.make_assembly(rng_asm, "g0", clean, 1, synthetic.loci[3], FAMILY_RICH["genome_nt"])
    genome = GenomeAssembly.from_stream(io.BytesIO(asm.fasta), asm.name)

    ci = ContigIndex.build(genome.contigs)
    codes, starts = tm._batch_codes([ci], int(ci.codes.shape[0]), torch.device("cpu"))
    params = tm.MapperParams()
    _, counts = tm.seed_chunk(codes, starts, [(torch.device("cpu"), db.gene_index.seed_table("cpu"))],
                              db.gene_index, params)
    assert 1 << 14 < int(counts[2, 0]) <= tm.ANCHOR_CAP and int(counts[3, 0]) == 0
    names = tuple(str(i) for i in range(len(db.genes)))
    reset_metrics()
    [got] = tm.map_genes_batch(db.gene_index, [genome], names, params, seed_mode="device", device="cpu")
    seen = snapshot()
    assert seen.get("map.device_chained") == 1 and not any(k.startswith("map.host_") for k in seen), seen
    [want] = tm.map_genes_batch(db.gene_index, [genome], names, params, seed_mode="host", device="cpu")
    assert len(want) >= 64  # every copy of both families
    assert_same(got, want)

def test_resolve_seed_mode(monkeypatch):
    """``auto`` seeds on the card where the batch is mapped on a CUDA device, on the host on the CPU or
    with no device named (no card is needed to name a CUDA device); ``host`` and ``device`` override."""
    from kaptive_tpu_torch.ops.mapper import resolve_seed_mode

    monkeypatch.delenv("KAPTIVE_SEED_MODE", raising=False)
    assert resolve_seed_mode() == "host"
    assert resolve_seed_mode(device=None) == "host"
    assert resolve_seed_mode(device=torch.device("cpu")) == "host"
    assert resolve_seed_mode("auto", "cpu") == "host"
    assert resolve_seed_mode(device=torch.device("cuda")) == "device"
    assert resolve_seed_mode("auto", torch.device("cuda", 1)) == "device"
    assert resolve_seed_mode("device") == "device"
    assert resolve_seed_mode("host", torch.device("cuda")) == "host"
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "device")
    assert resolve_seed_mode() == "device"
    assert resolve_seed_mode(device=torch.device("cpu")) == "device"
    assert resolve_seed_mode("host") == "host"
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")
    assert resolve_seed_mode(device=torch.device("cuda")) == "host"
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "gpu")
    with pytest.raises(ValueError, match="seed mode"):
        resolve_seed_mode()
    with pytest.raises(ValueError, match="seed mode"):
        resolve_seed_mode(device=torch.device("cuda"))


@pytest.mark.parametrize("seeded", [False, True])
def test_pairwise_aligner_equals_jax(seeded):
    from kaptive_tpu.core.pairwise import PairwiseAligner as JaxAligner
    from kaptive_tpu.core.seq import Sequences as JaxSequences
    from kaptive_tpu.ops.swg import SwgLattice as JaxLattice

    from kaptive_tpu_torch.core.pairwise import PairwiseAligner
    from kaptive_tpu_torch.core.seq import Sequences
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
    jax_queries, jax_targets = JaxSequences.from_bytes(qs), JaxSequences.from_bytes(ts)
    seeds = None
    if seeded:
        seeds = type("Seeds", (), {"offsets": rng.integers(-6, 6, len(qs)).astype(np.int32)})()
    lattice_kw = dict(max_len=200, len_slack=50, batch=32, tail_batch=16)
    for lattice in (None, lattice_kw):
        got = PairwiseAligner(
            lattice=SwgLattice.for_max_len(**lattice) if lattice else None, device="cpu"
        )(queries, targets, seeds)
        want = JaxAligner(lattice=JaxLattice.for_max_len(**lattice) if lattice else None)(
            jax_queries, jax_targets, seeds
        )
        assert_same(got, want)


def _contig_fasta(seqs: list[bytes]) -> bytes:
    return b"".join(b">c%d\n%s\n" % (i + 1, s) for i, s in enumerate(seqs))


def _extension_genomes(panel, case: str) -> list:
    r"""The assemblies of an extension case: plus- and minus-strand chains, a draft
    of many contigs, windows clipped at a contig's ends, Ns past the sparse
    upload's capacity beside a sparse stream, and the whole panel as one batch."""
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.ops.mapper import MapperParams, host_seed_chains
    from kaptive_tpu_torch.ops.minimizer import EXC_CAP, ContigIndex

    clean, _, revcomp, split, n_heavy = panel.assemblies
    seq = clean.contigs.seqs.tobytes()

    def genome(name: str, contigs: list[bytes]):
        return GenomeAssembly.from_stream(io.BytesIO(_contig_fasta(contigs)), name)

    if case == "strands":
        return [clean, revcomp]
    if case == "draft":
        cuts = np.linspace(0, len(seq), 9).astype(int)
        return [genome("draft", [seq[a:b] for a, b in zip(cuts, cuts[1:])]), split]
    if case == "clipped":
        chains = host_seed_chains(panel.db.gene_index, ContigIndex.build(clean.contigs), MapperParams())
        lo, hi = int(chains["t_min"].min()) + 5, int(chains["t_max"].max()) - 5
        return [genome("clipped", [seq[lo:hi]]), split]
    if case == "n_dense":
        return [genome("n_dense", [seq[:2000] + b"N" * (EXC_CAP + 100) + seq[2000:]]), n_heavy]
    return list(panel.assemblies)


EXTENSION_CASES = ["strands", "draft", "clipped", "n_dense", "panel_batch"]


def _both_sweeps(panel, genomes, params, monkeypatch):
    r"""Host mode's merged specs and flattened stream as the extension sweep gets them,
    and the merged host-built problems of the same chains: ``(specs, flat, problems,
    device-built alignments, host-built alignments)``.  The host-built alignments run
    the problems' ragged streams through ``batched_swg_align`` (or its CIGAR form)."""
    from kaptive_tpu_torch.core.collections import cumulative_offsets
    from kaptive_tpu_torch.core.pairwise import batched_swg_align, batched_swg_align_cigars
    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.minimizer import ContigIndex

    gi, names = panel.db.gene_index, panel.gene_names
    seen: dict = {}
    launch = tm.launch_extension_dp_device

    def launch_seen(specs, gene_index, flat_codes, p, **kw):
        seen["specs"], seen["flat"] = specs, flat_codes
        return launch(specs, gene_index, flat_codes, p, **kw)

    monkeypatch.setattr(tm, "launch_extension_dp_device", launch_seen)
    got = tm.map_genes_batch(gi, genomes, names, params, seed_mode="host", device="cpu")
    indexes = [ContigIndex.build(ga.contigs) for ga in genomes]
    chains = [tm.host_seed_chains(gi, ci, params) for ci in indexes]
    chains = [ch if ch and len(ch["gene"]) else None for ch in chains]
    parts = [tm.build_extension_problems(ch, gi, ci, params) if ch is not None else None
             for ch, ci in zip(chains, indexes)]
    live = [p for p in parts if p is not None]
    problems = {key: np.concatenate([p[key] for p in live])
                for key in ("q_codes", "q_lengths", "t_codes", "t_lengths", "offsets", "k_locals")}
    problems["q_offsets"] = cumulative_offsets(problems["q_lengths"])
    problems["t_offsets"] = cumulative_offsets(problems["t_lengths"])
    args = [problems[key] for key in ("q_codes", "q_offsets", "q_lengths", "t_codes", "t_offsets", "t_lengths",
                                      "offsets", "k_locals")]
    kw = dict(matrix=tm._NT_MATRIX, gap_open=tm.NT_GAP_OPEN, gap_extend=tm.NT_GAP_EXTEND,
              lattice=params.lattice, device="cpu")
    if params.emit_cigars:
        res, cigars = batched_swg_align_cigars(*args, **kw)
    else:
        res, cigars = batched_swg_align(*args, **kw), None
    want = tm._batch_alignments(chains, parts, res, cigars, gi, genomes, indexes, names, params)
    return seen["specs"], seen["flat"], problems, got, want


@pytest.mark.parametrize("case", EXTENSION_CASES)
def test_device_gathered_problems_equal_host_built(panel, monkeypatch, case):
    """Every bucket's (query, target) matrices and scalars gathered on the device from
    the specs and the uploaded streams equal those gathered from the host-built problems."""
    from kaptive_tpu_torch.core.pairwise import gather_bucket
    from kaptive_tpu_torch.ops.mapper import MapperParams
    from kaptive_tpu_torch.ops.scan import PAD_POS
    from kaptive_tpu_torch.ops.swg import plan_swg_buckets
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    genomes = _extension_genomes(panel, case)
    reset_metrics()
    specs, flat, problems, _, _ = _both_sweeps(panel, genomes, MapperParams(), monkeypatch)
    counts = snapshot()
    gi = panel.db.gene_index
    if case == "strands":
        assert (specs["strand"] > 0).any() and (specs["strand"] < 0).any()
    if case == "draft":
        assert len(genomes[0].contigs.lengths) == 8
    if case == "clipped":
        # The clipped genome is first: one contig at flat position PAD_POS.
        first = specs["t_flat"] < flat.shape[0] // len(genomes)
        t_lo, clen = specs["t_flat"][first] - PAD_POS, int(genomes[0].contigs.lengths[0])
        assert (t_lo == 0).any() and (t_lo + specs["t_len"][first] == clen).any()
    assert counts.get("map.dense_upload", 0) == (case == "n_dense")
    for key, host_key in (("glen", "q_lengths"), ("t_len", "t_lengths"), ("offsets", "offsets"),
                          ("k_locals", "k_locals")):
        np.testing.assert_array_equal(specs[key], problems[host_key], err_msg=key)

    joint = np.maximum(np.maximum(specs["glen"], specs["t_len"]), 1)
    plan = plan_swg_buckets(joint, 2 * specs["k_locals"] + 3, None)
    gene_codes = gi.device_codes("cpu")
    q_data, t_data = torch.from_numpy(problems["q_codes"]), torch.from_numpy(problems["t_codes"])
    assert len(plan) > 0
    for sel, rows_max, w_pad, _ in plan:
        t_pad = w_pad + 2
        shape = dict(rows_max=rows_max, t_cols=rows_max + 2 * t_pad, t_pad=t_pad)

        def col(a):
            return torch.from_numpy(np.asarray(a)[sel].astype(np.int64))

        q_dev, t_dev = gather_bucket(
            gene_codes, flat, col(specs["q_start"]), col(specs["glen"]), col(specs["strand"]),
            col(specs["t_flat"]), col(specs["t_len"]), **shape,
        )
        host_cols = (col(problems["q_offsets"]), col(problems["q_lengths"]))
        q_host, t_host = gather_bucket(
            q_data, t_data, *host_cols, col(np.ones(len(joint))),
            col(problems["t_offsets"]), col(problems["t_lengths"]), **shape,
        )
        assert torch.equal(q_dev, q_host) and torch.equal(t_dev, t_host)
        # No strand (every query on the plus strand, as in a protein sweep) reads the same.
        q_plus, _ = gather_bucket(q_data, t_data, *host_cols, None, col(problems["t_offsets"]),
                                  col(problems["t_lengths"]), **shape)
        assert torch.equal(q_plus, q_host)


@pytest.mark.parametrize("emit_cigars", [False, True])
@pytest.mark.parametrize("case", EXTENSION_CASES)
def test_host_mode_alignments_equal_host_built_problems(panel, monkeypatch, case, emit_cigars):
    """Host mode's alignments (problems gathered on the device) equal, field for field,
    those of the same chains' problems built on the host (the mesh path's tail on one device)."""
    from kaptive_tpu_torch.ops.mapper import MapperParams

    genomes = _extension_genomes(panel, case)
    _, _, _, got, want = _both_sweeps(panel, genomes, MapperParams(emit_cigars=emit_cigars), monkeypatch)
    assert sum(len(w) for w in want) > 0
    assert_same(got, want)


@pytest.mark.parametrize("emit_cigars", [False, True])
@pytest.mark.parametrize("slots", [1, 2])
def test_extension_problems_are_built_on_the_device_whatever_the_mesh(panel, monkeypatch, slots, emit_cigars):
    """Every chain's problem is built on the device, on one device and on a mesh of more
    than one slot (which cuts the DP pairs over its slots); the mesh's alignments, CIGARs
    included, equal one device's field by field."""
    from kaptive_tpu_torch.ops.mapper import MapperParams, map_genes_batch
    from kaptive_tpu_torch.parallel import make_mesh
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.utils.profiling import reset_phases

    monkeypatch.setenv("KAPTIVE_PROFILE", "1")
    reset_phases()
    reset_metrics()
    params = MapperParams(emit_cigars=emit_cigars)
    mesh = make_mesh(devices=[torch.device("cpu")] * slots) if slots > 1 else None
    got = map_genes_batch(panel.db.gene_index, panel.assemblies, panel.gene_names, params,
                          seed_mode="host", device="cpu", mesh=mesh)
    counts = snapshot()
    reset_phases()
    assert all(len(g) > 0 for g in got)
    assert counts["map.problems.device"] == counts["map.chains"] > 0
    assert "map.problems.host" not in counts
    if mesh is not None:
        want = map_genes_batch(panel.db.gene_index, panel.assemblies, panel.gene_names, params,
                               seed_mode="host", device="cpu")
        assert_same(got, want)
    if emit_cigars:
        assert all(int(np.sum(g.cigars.lengths)) > 0 for g in got)
