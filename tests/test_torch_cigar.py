"""CIGAR mode of the port (plain PyTorch, CPU) vs the JAX package's.

Three levels, each on seeded numpy panels fed unchanged to both packages:

- ``banded_swg_cigars`` vs ``banded_swg_lax_cigars``: every SwgResult field,
  the whole ``ops`` buffer (not only the valid prefix), ``n_ops`` and
  ``overflow``, on DNA with indels, BLOSUM62 protein pairs, a pair that
  emits more than 256 runs and pairs whose walk emits none;
- ``batched_swg_align_cigars`` vs the JAX one on ragged pairs, which the two
  packages bucket differently (the port by ``plan_swg_buckets``, the JAX
  package by power-of-two sizes), so equality holds per pair whatever its
  bucket;
- ``map_genes_batch(..., MapperParams(emit_cigars=True))`` vs the JAX
  package's in both seeding modes: the ``Alignments``, CIGARs included, and
  every statistic equal to count-only mode's.

Tolerance: exact (integer DP and run-length records).
"""

import io

import numpy as np
import pytest
import torch
from swg_panels import CIGAR_PANELS, cigar_panel, nt_matrix
from typing_panel import assert_same

from kaptive_tpu.core.genome import GenomeAssembly

# One intra-op thread: the plain DP issues many tiny ops, and idle OpenMP
# workers spinning in several test processes at once starve the JAX side.
torch.set_num_threads(1)


@pytest.mark.parametrize("kind", CIGAR_PANELS)
def test_banded_swg_cigars_equals_lax(kind):
    import jax.numpy as jnp

    from kaptive_tpu.ops.swg import MAX_CIGAR_OPS as JAX_CAP
    from kaptive_tpu.ops.swg import banded_swg_lax_cigars
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.swg import MAX_CIGAR_OPS, banded_swg_cigars

    assert MAX_CIGAR_OPS == JAX_CAP
    arrays, matrix, go, ge, rows_max, w_pad = cigar_panel(np.random.default_rng(sum(map(ord, kind))), kind)
    kw = dict(gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    want_res, want_ops, want_n, want_over = banded_swg_lax_cigars(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(matrix, dtype=jnp.int32), **kw
    )
    reset_metrics()
    got_res, got_ops, got_n, got_over = banded_swg_cigars(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(matrix), **kw
    )
    assert snapshot() == {"swg.plain.fill": 1, "swg.plain.traceback_cigar": 1}
    for field in want_res._fields:
        np.testing.assert_array_equal(getattr(got_res, field).numpy(), np.asarray(getattr(want_res, field)),
                                      err_msg=field)
    assert got_ops.dtype == torch.int32 and got_ops.shape == (len(arrays[0]), MAX_CIGAR_OPS)
    np.testing.assert_array_equal(got_ops.numpy().view(np.uint32), np.asarray(want_ops))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_over.numpy(), np.asarray(want_over))
    if kind == "overflow":
        assert bool(got_over[0]) and int(got_n[0]) == MAX_CIGAR_OPS and not got_over[1:].any()
    if kind == "no-op":
        assert got_n.tolist()[:3] == [0, 0, 0] and int(got_n[3]) == 1
    if kind == "nt-indels":
        kinds = got_ops.numpy() & 0xF
        assert (kinds[got_ops.numpy() != 0] == 1).any() and (kinds[got_ops.numpy() != 0] == 2).any()


def test_traceback_cigar_plain_matches_traceback_plain():
    """The CIGAR walk's statistics are the count-only walk's."""
    from kaptive_tpu_torch.ops.swg import fill_band_plain, traceback_cigar_plain, traceback_plain

    arrays, matrix, go, ge, rows_max, w_pad = cigar_panel(np.random.default_rng(2), "nt-indels")
    q, ql, t, tl, off, kl = (torch.from_numpy(a) for a in arrays)
    tb, *best = fill_band_plain(q, ql, t, tl, off, kl, torch.from_numpy(matrix),
                                gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)
    tr = dict(rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    plain = traceback_plain(tb, q, t, *best, off, **tr)
    with_cigar, ops, n_ops, _ = traceback_cigar_plain(tb, q, t, *best, off, **tr)
    for field, g, w in zip(plain._fields, with_cigar, plain):
        assert torch.equal(g, w), field
    # M/I/D run sums are the aligned spans.
    runs, kinds = ops >> 4, ops & 0xF
    m = (runs * (kinds == 0) * (ops != 0)).sum(1)
    assert torch.equal(m + (runs * (kinds == 1)).sum(1), plain.q_ends - plain.q_starts)
    assert torch.equal(m + (runs * (kinds == 2)).sum(1), plain.t_ends - plain.t_starts)


def test_kernel_cigar_capacity_is_max_cigar_ops():
    """The CUDA kernel's compiled-in run capacity is the Python buffer's width."""
    import re
    from pathlib import Path

    import kaptive_tpu_torch
    from kaptive_tpu_torch.ops.swg import MAX_CIGAR_OPS

    src = (Path(kaptive_tpu_torch.__file__).parent / "csrc" / "swg.cu").read_text()
    assert re.findall(r"constexpr int MAX_CIGAR_OPS = (\d+);", src) == [str(MAX_CIGAR_OPS)]


def _ragged(pairs):
    q = np.frombuffer(b"".join(a for a, _ in pairs), np.uint8)
    t = np.frombuffer(b"".join(b for _, b in pairs), np.uint8)
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    tl = np.array([len(b) for _, b in pairs], np.int32)
    return q, np.concatenate([[0], np.cumsum(ql)[:-1]]), ql, t, np.concatenate([[0], np.cumsum(tl)[:-1]]), tl


def test_batched_swg_align_cigars_equals_jax():
    from kaptive_tpu.core.pairwise import batched_swg_align_cigars as jax_align

    from kaptive_tpu_torch.core.pairwise import batched_swg_align_cigars
    from kaptive_tpu_torch.ops.swg import SwgLattice

    rng = np.random.default_rng(23)
    pairs = []
    for kind in ("nt-indels", "overflow", "no-op"):
        (q, ql, t, tl, _, _), *_ = cigar_panel(rng, kind)
        w_pad = (t.shape[1] - q.shape[1]) // 2
        pairs += [(q[p, : ql[p]].tobytes(), t[p, w_pad : w_pad + tl[p]].tobytes()) for p in range(len(ql))]
    q, qo, ql, t, to, tl = _ragged(pairs)
    n = len(pairs)
    offs = rng.integers(-4, 5, n).astype(np.int32)
    kls = rng.integers(12, 40, n).astype(np.int32)
    args = (q, qo, ql, t, to, tl, offs, kls, nt_matrix(), 4, 2)
    want_res, want_cig = jax_align(*args)
    assert (want_cig.lengths == 0).sum() > 3  # the overflowing and the empty walks
    for lattice in (None, SwgLattice.for_max_len(300, len_slack=64, widths=(128,), batch=8)):
        got_res, got_cig = batched_swg_align_cigars(*args, lattice=lattice, device="cpu")
        assert_same(got_res, want_res)
        assert_same(got_cig, want_cig)


@pytest.fixture(scope="module")
def cigar_genome(tmp_path_factory):
    """``tests/test_mapper.py``'s CIGAR panel: KL2 with 2% substitutions and 0.5% indels."""
    from synthetic import make_synthetic_db, mutate_dna, random_dna

    from kaptive_tpu.db import Database

    rng = np.random.default_rng(11)
    gbk, truth = make_synthetic_db(tmp_path_factory.mktemp("cigar"), rng, n_loci=3, genes_per_locus=4)
    db = Database.from_genbank(gbk)
    locus = mutate_dna(rng, truth["loci"]["KL2"]["seq"], sub_rate=0.02, indel_rate=0.005)
    contig = random_dna(rng, 4000) + locus + random_dna(rng, 4000)
    return db, GenomeAssembly.from_stream(io.BytesIO(b">c1\n%s\n" % contig), "cig")


@pytest.mark.parametrize("seed_mode", ["host", "device"])
def test_map_genes_batch_cigars_equal_jax(cigar_genome, seed_mode):
    from kaptive_tpu.ops.mapper import MapperParams as JaxParams
    from kaptive_tpu.ops.mapper import map_genes_batch as jax_map

    from kaptive_tpu_torch.ops.mapper import GeneIndex, MapperParams, map_genes_batch

    db, ga = cigar_genome
    names = tuple(str(i) for i in range(len(db.genes)))
    want = jax_map(db.gene_index, [ga], names, JaxParams(emit_cigars=True), seed_mode=seed_mode)[0]
    gi = GeneIndex.build(db.genes)
    got = map_genes_batch(gi, [ga], names, MapperParams(emit_cigars=True), seed_mode=seed_mode, device="cpu")[0]
    assert len(want) > 0 and want.cigars.lengths.sum() > len(want)  # gapped hits
    assert_same(got, want)
    plain = map_genes_batch(gi, [ga], names, MapperParams(), seed_mode=seed_mode, device="cpu")[0]
    for field in ("q_starts", "q_ends", "t_starts", "t_ends", "scores", "matches", "mismatches",
                  "strands", "q_name_ids", "t_name_ids", "qualities", "is_primary", "divergence"):
        np.testing.assert_array_equal(getattr(got, field), getattr(plain, field), err_msg=field)
    for r in range(len(got)):
        ops = got.cigars[r]
        runs, kinds = ops >> 4, ops & 0xF
        m = int(runs[kinds == 0].sum())
        assert m + int(runs[kinds == 1].sum()) == got.q_ends[r] - got.q_starts[r]
        assert m + int(runs[kinds == 2].sum()) == got.t_ends[r] - got.t_starts[r]


def test_mapper_params_field_order_equals_jax():
    import dataclasses

    from kaptive_tpu.ops.mapper import MapperParams as JaxParams

    from kaptive_tpu_torch.ops.mapper import MapperParams

    assert [f.name for f in dataclasses.fields(MapperParams)] == [f.name for f in dataclasses.fields(JaxParams)]
    assert MapperParams() == MapperParams(emit_cigars=False)


def test_device_mode_fallback_keeps_cigars(cigar_genome, monkeypatch):
    """A host-fallback genome in device mode keeps host mode's CIGARs."""
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops import mapper as tm

    db, ga = cigar_genome
    monkeypatch.setattr(tm, "ANCHOR_CAP", 8)
    names = tuple(str(i) for i in range(len(db.genes)))
    gi = tm.GeneIndex.build(db.genes)
    params = tm.MapperParams(emit_cigars=True)
    reset_metrics()
    got = tm.map_genes_batch(gi, [ga], names, params, seed_mode="device", device="cpu")[0]
    assert snapshot().get("map.host_fallback.anchors") == 1
    host = tm.map_genes_batch(gi, [ga], names, params, seed_mode="host", device="cpu")[0]
    assert len(host) > 0
    assert_same(got, host)

