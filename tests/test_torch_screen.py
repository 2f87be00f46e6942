"""Screen mode of the port (plain PyTorch, CPU) vs the JAX package's.

Panels: ``tests/test_parallel.py``'s 6-locus database and eight assemblies
(seed 31), plus an assembly whose code stream fills its 65,536-position
bucket exactly (no sentinel tail, so the scan's end guards decide) and one
with a 400-base poly-A run, whose scan rows hold more than 64 minimizers and
send it down the flat-scan path (``screen.overflow``).

Tolerances: the tallies, ``best`` and the flat scan's outputs exactly; the
float32 ``weighted`` scores to ``rtol=1e-6``, because the port's float32
matmul may sum in another order than XLA's CPU dot.
"""

import io

import numpy as np
import pytest
import torch
from scan_panels import multi_contig, poly_a, random_stream

from kaptive_tpu.core.genome import GenomeAssembly

torch.set_num_threads(1)

TRUE_LOCI = ["KL1", "KL2", "KL3", "KL4", "KL5", "KL6", "KL2", "KL4"]
BUCKET = 1 << 16


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    from synthetic import make_genome_from_locus, make_synthetic_db, random_dna

    from kaptive_tpu.db import Database

    rng = np.random.default_rng(31)
    gbk, truth = make_synthetic_db(tmp_path_factory.mktemp("screen_db"), rng, n_loci=6, genes_per_locus=5)
    db = Database.from_genbank(gbk)
    assemblies = [
        GenomeAssembly.from_stream(io.BytesIO(make_genome_from_locus(rng, truth, name, flank=1500)), f"g{i}")
        for i, name in enumerate(TRUE_LOCI)
    ]
    locus = truth["loci"]["KL5"]["seq"]
    head = random_dna(rng, 2000)
    fill = head + locus + random_dna(rng, BUCKET - len(head) - len(locus))
    poly = random_dna(rng, 1500) + b"A" * 400 + truth["loci"]["KL3"]["seq"] + random_dna(rng, 1500)
    extra = [GenomeAssembly.from_stream(io.BytesIO(b">c1\n%s\n" % seq), name)
             for name, seq in (("fills_bucket", fill), ("poly_a", poly))]
    return db, assemblies, extra


def _jax_screen(codes, tables, n_genes):
    import jax
    import jax.numpy as jnp

    from kaptive_tpu.parallel.screen import _tally_one, locus_screen_batch

    dev = [jnp.asarray(x) for x in (tables.table_hashes, tables.table_genes, tables.gene_locus_onehot,
                                     tables.expected_per_locus, tables.gene_minimizer_counts)]
    best, weighted = locus_screen_batch(jnp.asarray(codes), *dev, n_genes=n_genes)
    tallies = jax.vmap(lambda c: _tally_one(c, dev[0], dev[1], n_genes))(jnp.asarray(codes))
    return np.asarray(best), np.asarray(weighted), np.asarray(tallies)


def test_screen_tables_equal_jax(panel):
    from kaptive_tpu.parallel.screen import ScreenTables as JaxTables

    from kaptive_tpu_torch.ops.mapper import GeneIndex
    from kaptive_tpu_torch.parallel.screen import ScreenTables

    db, _, _ = panel
    got = ScreenTables.build(db, GeneIndex.build(db.genes))
    want = JaxTables.from_database(db)
    for name in ("table_hashes", "table_genes", "gene_locus_onehot", "expected_per_locus", "gene_minimizer_counts"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("batch", ["panel", "fills-bucket", "overflow"])
def test_locus_screen_batch_equals_jax(panel, batch):
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.mapper import GeneIndex
    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch

    db, assemblies, (fill, poly) = panel
    genomes = {"panel": assemblies, "fills-bucket": [fill, assemblies[0]], "overflow": [assemblies[2], poly]}[batch]
    tables = ScreenTables.build(db, GeneIndex.build(db.genes))
    codes = encode_assemblies_to_batch(genomes)
    assert codes.shape[1] == BUCKET
    if batch == "fills-bucket":
        assert (codes[0] < 4).all()  # no sentinel: the stream ends at the bucket's end
    n_genes = len(db.genes)
    reset_metrics()
    best, weighted, tallies = locus_screen_batch(torch.from_numpy(codes), tables, n_genes)
    counts = snapshot()
    want_best, want_weighted, want_tallies = _jax_screen(codes, tables, n_genes)
    np.testing.assert_array_equal(tallies.numpy(), want_tallies)
    np.testing.assert_array_equal(best.numpy(), want_best)
    np.testing.assert_allclose(weighted.numpy(), want_weighted, rtol=1e-6)
    assert weighted.dtype == torch.float32 and best.dtype == torch.int32
    assert counts.get("scan.plain.rowcompact") == 1
    assert counts.get("screen.overflow", 0) == (1 if batch == "overflow" else 0)
    if batch == "panel":
        assert [db.loci.ids[b] for b in best.tolist()] == TRUE_LOCI


def test_serotyper_screen_equals_jax(panel):
    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper

    from kaptive_tpu_torch.serotyping import Serotyper

    db, assemblies, extra = panel
    port = Serotyper(db, device="cpu")
    ref = JaxSerotyper(db)
    for genomes in (assemblies, [*extra, assemblies[5]]):
        got_asm, got_best, got_weighted = port.screen(genomes)
        want_asm, want_best, want_weighted = ref.screen(genomes)
        assert [a.id for a in got_asm] == [a.id for a in want_asm]
        assert got_best.dtype == want_best.dtype and got_weighted.dtype == want_weighted.dtype
        np.testing.assert_array_equal(got_best, want_best)
        np.testing.assert_allclose(got_weighted, want_weighted, rtol=1e-6)
    assert [db.loci.ids[b] for b in port.screen(assemblies)[1]] == TRUE_LOCI
    empty = port.screen([])
    assert empty[0] == [] and empty[2].shape == (0, len(db.loci))


@pytest.mark.parametrize("make", [lambda r: random_stream(r, 64), lambda r: multi_contig(r, 96), poly_a],
                         ids=["random", "multi-contig", "poly-a"])
def test_minimizer_scan_plain_equals_jax(make):
    from kaptive_tpu.ops.minimizer import minimizer_scan

    from kaptive_tpu_torch.ops.scan import minimizer_scan_plain

    codes = make(np.random.default_rng(4))
    codes[-3:] = np.random.default_rng(5).integers(0, 4, 3)  # valid bases up to the stream's end
    want = [np.asarray(x) for x in minimizer_scan(codes, 15, 10)]
    got = minimizer_scan_plain(torch.from_numpy(codes), 15, 10)
    for name, g, w in zip(("selected", "hashes", "strands"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64) if name == "hashes" else w, err_msg=name)
    batched = minimizer_scan_plain(torch.from_numpy(np.stack([codes, codes[::-1].copy()])), 15, 10)
    for g, single in zip(batched, got):
        assert torch.equal(g[0], single)
