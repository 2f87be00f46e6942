"""The port's mesh typing (plain PyTorch, CPU) vs its single-device path and the JAX package's mesh.

Panel: ``tests/test_parallel.py``'s 6-locus x 5-gene database and eight
assemblies (seed 31), each package building its side from the same GenBank
and FASTA bytes.  The port's mesh names the CPU eight times
(``make_mesh(devices=[cpu] * 8, ...)``); the JAX package's is its 8-device
CPU mesh (``tests/conftest.py``).

Tolerances: exact everywhere — shard cuts and table arrays, chains, SWG
results, tallies, ``best``, ``gene_states`` and KaptiveRow bytes — except the
JAX screen's float32 ``weighted`` scores, held to ``rtol=1e-6`` because the
port's float32 matmul may sum in another order than XLA's CPU dot.  The
port's sharded candidate and anchor counts are maxima over shards (each
shard applies the caps on its own), so they are held at or below the
single-device counts.
"""

import numpy as np
import pytest
import torch
from torch_panel import both_assemblies

torch.set_num_threads(1)  # the plain DP issues many tiny ops beside other test processes

TRUE_LOCI = ["KL1", "KL2", "KL3", "KL4", "KL5", "KL6", "KL2", "KL4"]
CPU = torch.device("cpu")
SHAPES = [(8, 1), (4, 2), (2, 4)]


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    from synthetic import make_genome_from_locus, make_synthetic_db

    from kaptive_tpu.db import Database as JaxDatabase

    from kaptive_tpu_torch.db import Database

    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("par_db")
    gbk, truth = make_synthetic_db(tmp, rng, n_loci=6, genes_per_locus=5)
    fastas = [make_genome_from_locus(rng, truth, name, flank=1500) for name in TRUE_LOCI]
    paths = []
    for i, fasta in enumerate(fastas):
        paths.append(tmp / f"g{i}.fasta")
        paths[-1].write_bytes(fasta)
    pairs = [both_assemblies(fasta, f"g{i}") for i, fasta in enumerate(fastas)]
    return dict(db=Database.from_genbank(gbk), jax_db=JaxDatabase.from_genbank(gbk), paths=paths,
                assemblies=[p for p, _ in pairs], jax_assemblies=[j for _, j in pairs])


def _mesh(shape):
    from kaptive_tpu_torch.parallel import make_mesh

    data, model = shape
    return make_mesh(devices=[CPU] * (data * model), model_parallel=model)


def _jax_mesh(shape):
    import jax

    from kaptive_tpu.parallel import make_mesh

    data, model = shape
    return make_mesh(data * model, model_parallel=model, devices=jax.devices("cpu"))


def _rows(results):
    from kaptive_tpu_torch.serotyping.io import KaptiveRow

    return [bytes(KaptiveRow.from_result(r)) for r in results]


def _jax_rows(results):
    from kaptive_tpu.serotyping.io import KaptiveRow

    return [bytes(KaptiveRow.from_result(r)) for r in results]


def test_make_mesh_shapes_and_refusals(monkeypatch):
    from kaptive_tpu_torch.parallel import make_mesh
    from kaptive_tpu_torch.utils.device import device_count, sharded

    mesh = make_mesh(devices=[CPU] * 8, model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2} and int(mesh.devices.size) == 8
    assert mesh.flat == [CPU] * 8 and mesh.slots_on(CPU) == 8
    assert (device_count(mesh), sharded(mesh)) == (8, True)
    assert (device_count(None), sharded(None)) == (1, False)
    assert (device_count(make_mesh(devices=[CPU])), sharded(make_mesh(devices=[CPU]))) == (1, False)
    assert make_mesh(4, devices=[CPU] * 8).shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(devices=[CPU] * 6, model_parallel=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=[torch.device("cuda", 0)] * 2)


@pytest.mark.parametrize("model", [1, 2, 4, 8])
def test_shard_cuts_and_table_equal_jax(panel, model):
    from kaptive_tpu.parallel.typing import ShardedGeneTable as JaxTable
    from kaptive_tpu.parallel.typing import shard_cuts as jax_cuts

    from kaptive_tpu_torch.parallel.typing import ShardedGeneTable, shard_cuts

    hashes = panel["db"].gene_index.minimizers.hashes
    np.testing.assert_array_equal(hashes, panel["jax_db"].gene_index.minimizers.hashes)
    assert shard_cuts(hashes, model) == jax_cuts(hashes, model)
    got = ShardedGeneTable.build(panel["db"].gene_index, model)
    want = JaxTable.build(panel["jax_db"].gene_index, model)
    assert (got.lookup_iters, got.model) == (want.lookup_iters, want.model)
    for name in ("hashes", "genes", "positions", "strands", "bucket_starts", "run_len", "bloom"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("model", [2, 3, 8, 16])
def test_shard_cuts_never_split_runs(panel, model):
    """``tests/test_multichip_balance.py``'s run-split check, on the panel's table and on a
    table of long runs where an even cut would land inside a run."""
    from kaptive_tpu_torch.parallel.typing import shard_cuts

    runs = np.repeat(np.arange(6, dtype=np.uint32), [7, 1, 30, 2, 9, 1])
    for h in (panel["db"].gene_index.minimizers.hashes, runs):
        cuts = shard_cuts(h, model)
        assert cuts[0] == 0 and cuts[-1] == len(h) and cuts == sorted(cuts)
        for c in cuts[1:-1]:
            if 0 < c < len(h):
                assert h[c] != h[c - 1], "cut splits a hash run"


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_sharded_chains_equal_single_device(panel, shape):
    from kaptive_tpu_torch.ops.mapper import (
        ANCHOR_CAP, CANDIDATE_CAP, CHAIN_CAP, MapperParams, _batch_codes, chain_batch, match_rows_batch,
    )
    from kaptive_tpu_torch.ops.minimizer import ContigIndex
    from kaptive_tpu_torch.ops.scan import rowcompact_scan
    from kaptive_tpu_torch.parallel.typing import ShardedGeneTable, sharded_scan_match_chain

    gi, p = panel["db"].gene_index, MapperParams()
    indexes = [ContigIndex.build(a.contigs) for a in panel["assemblies"]]
    L = max(len(ci.codes) for ci in indexes)
    codes, starts = _batch_codes(indexes, L, CPU)
    bucket_starts, run_len, iters = gi.device_lookup(CPU)
    anchors, match_counts = match_rows_batch(
        *rowcompact_scan(codes, gi.k, gi.w), *gi.device_table(CPU), bucket_starts, run_len, gi.device_bloom(CPU),
        cap_cand=CANDIDATE_CAP, cap_anchors=ANCHOR_CAP, lookup_iters=iters, max_occ=p.max_occ,
    )
    want_chains, want_counts = chain_batch(
        anchors, match_counts, starts, gi.device_gene_lengths(CPU), k=gi.k, cap_chains=CHAIN_CAP,
        max_diag_drift=p.max_diag_drift, max_anchor_gap=p.max_anchor_gap, min_anchors=p.min_anchors,
    )
    chains, counts = sharded_scan_match_chain(_mesh(shape), indexes, ShardedGeneTable.of(gi, shape[1]), gi, p,
                                              length=L)
    want_counts = want_counts.numpy()
    assert (want_counts[5] > 0).all()
    np.testing.assert_array_equal(chains, want_chains.numpy())
    np.testing.assert_array_equal(counts[[0, 3, 4, 5]], want_counts[[0, 3, 4, 5]])
    assert (counts[1:3] <= want_counts[1:3]).all() and (counts[2] > 0).all()


def test_sharded_banded_swg_equals_banded_swg():
    from swg_panels import NT, nt_matrix, random_swg_batch

    from kaptive_tpu_torch.ops.swg import banded_swg
    from kaptive_tpu_torch.parallel.typing import sharded_banded_swg

    rows_max, w_pad = 96, 128
    arrays = random_swg_batch(np.random.default_rng(8), NT, 32, rows_max, w_pad, seeded=True)
    args = [torch.from_numpy(a) for a in arrays]
    matrix = torch.from_numpy(nt_matrix().astype(np.int32))
    statics = dict(gap_open=4, gap_extend=2, rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    want = banded_swg(*args, matrix, **statics)
    for shape in SHAPES:
        got = sharded_banded_swg(_mesh(shape), *args, matrix, **statics)
        for field, g, w in zip(want._fields, got, want, strict=True):
            assert torch.equal(g, w), (shape, field)
    with pytest.raises(ValueError, match="does not split"):
        sharded_banded_swg(_mesh((3, 1)), *args, matrix, **statics)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{m}" for d, m in SHAPES])
def test_sharded_screen_equals_single_device(panel, shape):
    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch
    from kaptive_tpu_torch.parallel.screen import sharded_locus_screen
    from kaptive_tpu_torch.serotyping import Serotyper

    db = panel["db"]
    tables = ScreenTables.build(db, db.gene_index)
    codes = encode_assemblies_to_batch(panel["assemblies"])
    best, weighted, tallies = sharded_locus_screen(_mesh(shape), codes, tables)
    one_best, one_weighted, one_tallies = locus_screen_batch(torch.from_numpy(codes), tables, len(db.genes))
    assert torch.equal(tallies, one_tallies) and torch.equal(best, one_best) and torch.equal(weighted, one_weighted)
    assert [db.loci.ids[b] for b in best.tolist()] == TRUE_LOCI
    _, s_best, s_weighted = Serotyper(db, mesh=_mesh(shape)).screen(panel["assemblies"][:3])
    np.testing.assert_array_equal(s_best, one_best.numpy()[:3])
    np.testing.assert_array_equal(s_weighted, one_weighted.numpy()[:3])


def test_sharded_screen_equals_jax(panel):
    """The port's and the JAX package's sharded screens on a (4, 2) mesh, and the JAX
    single-device screen: ``best`` exact, ``weighted`` to rtol 1e-6."""
    import jax.numpy as jnp

    from kaptive_tpu.parallel.screen import ScreenTables as JaxTables
    from kaptive_tpu.parallel.screen import locus_screen_batch as jax_screen
    from kaptive_tpu.parallel.screen import sharded_locus_screen as jax_sharded_screen

    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, sharded_locus_screen

    db = panel["db"]
    codes = encode_assemblies_to_batch(panel["assemblies"])
    best, weighted, _ = sharded_locus_screen(_mesh((4, 2)), codes, ScreenTables.build(db, db.gene_index))
    jt = JaxTables.from_database(panel["jax_db"])
    want_best, want_weighted = jax_sharded_screen(_jax_mesh((4, 2)), codes, jt)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
    np.testing.assert_allclose(weighted.numpy(), np.asarray(want_weighted), rtol=1e-6)
    single_best, single_weighted = jax_screen(jnp.asarray(codes), *(jnp.asarray(x) for x in (
        jt.table_hashes, jt.table_genes, jt.gene_locus_onehot, jt.expected_per_locus, jt.gene_minimizer_counts,
    )), n_genes=len(db.genes))
    np.testing.assert_array_equal(best.numpy(), np.asarray(single_best))
    np.testing.assert_allclose(weighted.numpy(), np.asarray(single_weighted), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_single(panel):
    from kaptive_tpu.serotyping import Serotyper

    results = Serotyper(panel["jax_db"]).batch(panel["jax_assemblies"])
    assert [r.best_locus_name for r in results] == TRUE_LOCI
    return results


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{d}x{m}" for d, m in SHAPES])
def test_sharded_serotyper_equals_jax_sharded_and_single(panel, jax_single, shape):
    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper

    from kaptive_tpu_torch.serotyping import Serotyper
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    reset_metrics()
    got = Serotyper(panel["db"], mesh=_mesh(shape)).batch(panel["assemblies"])
    counts = snapshot()
    want = JaxSerotyper(panel["jax_db"], mesh=_jax_mesh(shape)).batch(panel["jax_assemblies"])
    assert [r.best_locus_name for r in got] == TRUE_LOCI
    assert _rows(got) == _jax_rows(want) == _jax_rows(jax_single)
    for g, w, s in zip(got, want, jax_single, strict=True):
        np.testing.assert_array_equal(g.gene_states, w.gene_states)
        np.testing.assert_array_equal(g.gene_states, s.gene_states)
    # Scanned once per data row (the row's slots share the CPU); the DP cut over all 8 slots.
    assert counts["scan.plain.rowcompact"] == shape[0]
    assert counts["map.device_chained"] == len(TRUE_LOCI)
    assert counts["swg.plain.fill"] % 8 == 0 and counts["swg.plain.fill"] == counts["swg.plain.traceback"]


def test_sharded_serotyper_uneven_batch(panel, jax_single):
    """A batch of 3 on a (4, 2) mesh: the last data row is padding."""
    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper

    from kaptive_tpu_torch.serotyping import Serotyper

    got = Serotyper(panel["db"], mesh=_mesh((4, 2))).batch(panel["assemblies"][:3])
    want = JaxSerotyper(panel["jax_db"], mesh=_jax_mesh((4, 2))).batch(panel["jax_assemblies"][:3])
    assert [r.best_locus_name for r in got] == TRUE_LOCI[:3]
    assert _rows(got) == _jax_rows(want) == _jax_rows(jax_single[:3])
    for g, w, s in zip(got, want, jax_single[:3], strict=True):
        np.testing.assert_array_equal(g.gene_states, w.gene_states)
        np.testing.assert_array_equal(g.gene_states, s.gene_states)


def test_stream_type_on_mesh_equals_single_device(panel):
    from kaptive_tpu_torch.parallel import stream_type
    from kaptive_tpu_torch.serotyping import Serotyper

    single = Serotyper(panel["db"], device="cpu").batch(panel["paths"])
    streamed = list(stream_type(Serotyper(panel["db"], mesh=_mesh((2, 4))), panel["paths"], batch_size=3))
    assert [r.genome for r in streamed] == [f"g{i}" for i in range(len(TRUE_LOCI))]
    assert _rows(streamed) == _rows(single)


def test_mesh_serotyper_lattices_split_evenly(panel):
    """Every DP bucket of a 3-slot mesh splits evenly: the lattice batches round to
    lcm(ceil(16 / 3) * 3, 8) = 72, as in the JAX package."""
    import jax

    from kaptive_tpu.parallel import make_mesh as jax_make_mesh
    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper

    from kaptive_tpu_torch.parallel import make_mesh
    from kaptive_tpu_torch.serotyping import Serotyper

    got = Serotyper(panel["db"], mesh=make_mesh(devices=[CPU] * 3))
    want = JaxSerotyper(panel["jax_db"], mesh=jax_make_mesh(3, devices=jax.devices("cpu")))
    for name in ("_protein_lattice", "_ext_lattice"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g.batch, g.tail_batch, g.widths, g.tiers) == (w.batch, w.tail_batch, w.widths, w.tiers), name
        assert g.batch % 3 == 0 and g.tail_batch % 3 == 0
    assert got.device == CPU and got.mesh.shape == {"data": 3, "model": 1}
