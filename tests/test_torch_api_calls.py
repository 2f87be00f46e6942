"""The public calls that close the port's API gaps, held to the JAX package on the CPU.

``tests/test_torch_api.py`` pins that every JAX name exists and binds the
same; this file holds what the new names compute:

- ``ops/minimizer.py``: ``minimizer_scan`` on ``tests/scan_panels.py``
  (random streams, contig boundaries, the poly-A overflow run, the edge
  panels) against the JAX ``minimizer_scan``, batched and at other (k, w);
  ``build_minimizer_set(sort=False)`` and ``build_minimizer_set(device=...)``;
  ``concat_with_sentinels(pad_to_bucket=False)``; ``ContigIndex.device_codes``;
- ``bgc/kernels.py::architectural_viterbi`` on the panels of ``tests/test_bgc.py``;
- ``ops/swg.py``: ``pad_ragged_to_matrix``, ``SwgLattice.shapes`` /
  ``batches_for`` / ``width_for`` on the ``Serotyper``'s two lattices, the
  ``banded_swg_lax`` aliases;
- ``parallel/screen.py``: ``encode_assemblies_to_batch(pad_to=...)`` and
  ``ScreenTables.from_database``;
- the positional bindings that misbound: ``stream_type(s, g, 2, 1)`` gives
  the JAX package's records and ingests one batch ahead (a spy on the pool),
  ``batched_swg_align`` and ``PairwiseAligner`` take a positional mesh;
- ``ops/mapper.py::run_extension_dp_device`` and the ``GeneIndex.device_*``
  defaults; ``Serotyper(scoring_metric=...)``; ``utils.device_trace(trace_dir)``.

Tolerance: exact (integer outputs, Viterbi paths and scores on the same
float32 inputs, bytes); ``stream_type``'s records field by field.
"""

import io
import os

import numpy as np
import pytest
import torch
from scan_panels import EDGE_PANELS, KW_CASES, PANELS
from torch_panel import carried_database, make_typing_panels
from typing_panel import TRUTH, assert_same, make_typing_panel
from viterbi_panels import arch_panel

torch.set_num_threads(1)

SCAN_PANELS = {**PANELS, **EDGE_PANELS}


def _jax_scan(codes, k=15, w=10):
    from kaptive_tpu.ops.minimizer import minimizer_scan

    return [np.asarray(x) for x in minimizer_scan(codes, k, w)]


def _assert_scan_equal(got, want):
    for name, g, w in zip(("selected", "hashes", "strands"), got, want, strict=True):
        g = g.numpy()
        assert g.dtype == (np.int64 if name == "hashes" else np.bool_), name
        np.testing.assert_array_equal(g, w.astype(np.int64) if name == "hashes" else w, err_msg=name)


@pytest.mark.parametrize("panel", list(SCAN_PANELS))
def test_minimizer_scan_equals_jax(panel):
    from kaptive_tpu_torch.ops.minimizer import minimizer_scan
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    codes = SCAN_PANELS[panel](np.random.default_rng(6))
    want = _jax_scan(codes)
    reset_metrics()
    _assert_scan_equal(minimizer_scan(torch.from_numpy(codes)), want)
    assert snapshot() == {"scan.plain.flat": 1}
    _assert_scan_equal(minimizer_scan(codes), want)  # a numpy array is host data: the plain form
    if panel == "poly-a-overflow":
        assert want[0][5000:5386].all()  # every k-mer of the run ties, so each is selected


def test_minimizer_scan_batch_is_per_row():
    from kaptive_tpu_torch.ops.minimizer import minimizer_scan

    rng = np.random.default_rng(7)
    rows = [PANELS["random-1024"](rng)[:30_000], PANELS["poly-a-overflow"](rng)[:30_000]]
    rows.append(rows[0][::-1].copy())
    got = minimizer_scan(torch.from_numpy(np.stack(rows)))
    for i, row in enumerate(rows):
        _assert_scan_equal([x[i] for x in got], _jax_scan(row))


@pytest.mark.parametrize("k,w", KW_CASES, ids=[f"k{k}-w{w}" for k, w in KW_CASES])
def test_minimizer_scan_other_k_w_equals_jax(k, w):
    from kaptive_tpu_torch.ops.minimizer import minimizer_scan

    codes = PANELS["multi-contig-512"](np.random.default_rng(8))[:30_000]
    _assert_scan_equal(minimizer_scan(torch.from_numpy(codes), k, w), _jax_scan(codes, k, w))


def _genes(rng):
    from synthetic import random_dna

    seqs = [random_dna(rng, int(n)) for n in (900, 40, 2500, 14, 1200)]
    seqs[2] = seqs[2][:1000] + b"N" * 30 + seqs[2][1030:]
    return seqs


@pytest.mark.parametrize("kw", [dict(sort=False), dict(device="cpu"), dict(device="cpu", sort=False),
                                dict(k=11, w=5, sort=False)], ids=["sort-False", "cpu", "cpu-unsorted", "k11-w5"])
def test_build_minimizer_set_equals_jax(kw):
    from kaptive_tpu.core.seq import Sequences as JaxSequences
    from kaptive_tpu.ops.minimizer import build_minimizer_set as jax_build

    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.ops.minimizer import build_minimizer_set

    seqs = _genes(np.random.default_rng(9))
    got = build_minimizer_set(Sequences.from_bytes(seqs), **kw)
    jax_kw = {**kw, "device": True} if "device" in kw else kw  # the JAX device scan, on its CPU backend
    want = jax_build(JaxSequences.from_bytes(seqs), **jax_kw)
    assert len(want.hashes) > 100
    assert_same(got, want)
    assert_same(got, jax_build(JaxSequences.from_bytes(seqs), **{**jax_kw, "device": False}))


def test_build_minimizer_set_on_the_card_raises_without_one():
    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.ops.minimizer import build_minimizer_set

    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py holds the card's set to the host's")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_minimizer_set(Sequences.from_bytes([b"ACGT" * 50]), device=True)


def test_concat_with_sentinels_and_device_codes():
    from kaptive_tpu.ops.minimizer import concat_with_sentinels as jax_concat

    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.ops.minimizer import ContigIndex, concat_with_sentinels, encode_dna

    seqs = Sequences.from_bytes(_genes(np.random.default_rng(10)))
    codes = encode_dna(seqs.seqs)
    for pad in (False, True):
        got = concat_with_sentinels(codes, seqs.offsets, seqs.lengths, 15, pad_to_bucket=pad)
        want = jax_concat(codes, seqs.offsets, seqs.lengths, 15, pad_to_bucket=pad)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert len(got[0]) == 1 << 16 and len(concat_with_sentinels(codes, seqs.offsets, seqs.lengths, 15,
                                                                 False)[0]) < 6000
    ci = ContigIndex.build(seqs)
    on_cpu = ci.device_codes("cpu")
    assert on_cpu.dtype == torch.uint8 and np.array_equal(on_cpu.numpy(), ci.codes)
    assert ci.device_codes("cpu") is on_cpu


def _arch_cases():
    T = np.log(np.array([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [1e-9, 1e-9, 1.0]], dtype=np.float32))
    block = np.full((7, 3), -10.0, dtype=np.float32)
    block[:2, 0] = block[2:5, 1] = block[5:, 2] = 0.0
    cases = {"block": (block, T), "n1": (block[:1], T)}
    rng = np.random.default_rng(11)
    for S in (8, 28):
        em, trans, bounds = arch_panel(rng, [2, 17, 150], S)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            cases[f"S{S}_N{hi - lo}"] = (em[lo:hi], trans)
    return cases


ARCH_CASES = _arch_cases()


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_architectural_viterbi_equals_jax(case):
    import jax.numpy as jnp
    from kaptive_tpu.bgc.kernels import architectural_viterbi as jax_viterbi

    from kaptive_tpu_torch.bgc.kernels import architectural_viterbi
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    em, trans = ARCH_CASES[case]
    want_path, want_score = (np.asarray(x) for x in jax_viterbi(jnp.asarray(em), jnp.asarray(trans)))
    reset_metrics()
    path, score = architectural_viterbi(em, trans, device="cpu")
    assert snapshot() == {"viterbi.plain.arch": 1}
    assert path.dtype == torch.int32 and score.dtype == torch.float32 and score.dim() == 0
    np.testing.assert_array_equal(path.numpy(), want_path)
    assert score.item() == want_score.item()
    path_t, score_t = architectural_viterbi(torch.from_numpy(em), torch.from_numpy(trans), device="cpu")
    assert torch.equal(path_t, path) and torch.equal(score_t, score)
    if case == "block":
        assert path.tolist() == [0, 0, 1, 1, 1, 2, 2]


def test_architectural_viterbi_needs_a_row_and_defaults_to_the_card():
    from kaptive_tpu_torch.bgc.kernels import architectural_viterbi

    em, trans = ARCH_CASES["block"]
    with pytest.raises(ValueError, match="N >= 1"):
        architectural_viterbi(em[:0], trans, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            architectural_viterbi(em, trans)


def test_pad_ragged_to_matrix_and_plain_aliases_equal_jax():
    from kaptive_tpu.ops.swg import pad_ragged_to_matrix as jax_pad

    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.ops import swg

    seqs = Sequences.from_bytes([b"ACGT" * 30, b"", b"TTGCA", b"G" * 500])
    for width in (1, 64, 512):
        got = swg.pad_ragged_to_matrix(seqs.seqs, seqs.offsets, seqs.lengths, width, pad=3)
        want = jax_pad(seqs.seqs, seqs.offsets, seqs.lengths, width, pad=3)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert swg.banded_swg_lax is swg.banded_swg_plain
    assert swg.banded_swg_lax_cigars is swg.banded_swg_cigars_plain


@pytest.fixture(scope="module")
def panels(tmp_path_factory):
    return make_typing_panels(tmp_path_factory.mktemp("api_calls"))


def test_serotyper_lattices_equal_jax(panels):
    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper

    from kaptive_tpu_torch.serotyping import Serotyper

    port = Serotyper(panels.db, scoring_metric="coverage", device="cpu")
    ref = JaxSerotyper(panels.jax_db, scoring_metric="coverage")
    assert port.scoring_metric == ref.scoring_metric == "coverage"
    assert Serotyper(panels.db, device="cpu").scoring_metric == "scores"
    for name in ("_protein_lattice", "_ext_lattice"):
        got, want = getattr(port, name), getattr(ref, name)
        assert got.shapes() == want.shapes(), name
        assert len(got.shapes()) >= 2
        for w in (*got.widths, got.widths[0] + 1):
            assert got.batches_for(w) == want.batches_for(w)
        for need in (1, 128, 129, got.widths[-1], got.widths[-1] + 1):
            assert got.width_for(need) == want.width_for(need)


def test_screen_encode_and_tables_equal_jax(panels):
    from kaptive_tpu.parallel.screen import ScreenTables as JaxTables
    from kaptive_tpu.parallel.screen import encode_assemblies_to_batch as jax_encode

    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch

    for pad_to in (None, 1 << 17, 4096):
        got = encode_assemblies_to_batch(panels.assemblies, pad_to=pad_to)
        want = jax_encode(panels.jax_assemblies, pad_to=pad_to)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    got = ScreenTables.from_database(panels.db)
    want = JaxTables.from_database(panels.jax_db)
    for name in ("table_hashes", "table_genes", "gene_locus_onehot", "expected_per_locus", "gene_minimizer_counts"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_stream_type_binds_prefetch_batches_by_position(tmp_path, monkeypatch):
    from kaptive_tpu.parallel.pipeline import stream_type as jax_stream_type
    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper

    from kaptive_tpu_torch.parallel import pipeline
    from kaptive_tpu_torch.serotyping import Serotyper

    jax_db, genomes = make_typing_panel(tmp_path)
    fastas = [fasta for _, fasta in genomes] * 2  # ten genomes: batches of 1, 2, 2, 2, 2, 1
    names = [f"{name}_{i}" for i in range(2) for name, _ in genomes]

    class SpyPool(pipeline.ThreadPoolExecutor):
        pools: list = []

        def __init__(self, max_workers=None, **kw):
            super().__init__(max_workers=max_workers, **kw)
            self.max_workers, self.ingests = max_workers, 0
            type(self).pools.append(self)

        def submit(self, fn, *args, **kw):
            self.ingests += fn is pipeline._load_and_index
            return super().submit(fn, *args, **kw)

    monkeypatch.setattr(pipeline, "ThreadPoolExecutor", SpyPool)
    monkeypatch.setenv("KAPTIVE_SEED_MODE", "host")

    def handles():
        out = []
        for name, fasta in zip(names, fastas):
            h = io.BytesIO(fasta)
            h.name = f"{name}.fasta"
            out.append(h)
        return out

    serotyper = Serotyper(carried_database(jax_db), device="cpu")
    results = pipeline.stream_type(serotyper, handles(), 2, 1)  # JAX order: batch_size 2, prefetch_batches 1
    first = next(results)
    (ingest,) = [p for p in SpyPool.pools if p.ingests]
    # The consumer holds batch 0 while batch 1 maps: with one batch ahead, batches 0-3 are in the pool.
    assert ingest.ingests == 1 + 2 + 2 + 2
    assert ingest.max_workers == max(2, min(16, os.cpu_count() or 8))
    got = [first, *results]
    want = list(jax_stream_type(JaxSerotyper(jax_db), handles(), 2, 1))
    assert [r.best_locus_name for r in want] == TRUTH * 2
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert_same(g.to_dict(), w.to_dict(), f"result[{w.genome}]")
    SpyPool.pools.clear()
    list(pipeline.stream_type(serotyper, handles()[:6], 2, 0, 3))
    (ingest,) = [p for p in SpyPool.pools if p.ingests]
    assert ingest.max_workers == 3
    with pytest.raises(ValueError, match="prefetch_batches"):
        next(pipeline.stream_batches([io.BytesIO(fastas[0])], 2, -1))


def test_stream_batches_multi_device_skips_the_upload():
    from kaptive_tpu_torch.parallel.pipeline import stream_batches

    fasta = b">c1\n" + b"ACGT" * 500 + b"\n"
    uploaded = list(stream_batches([io.BytesIO(fasta)], 1, 0, 1, True, upload_to=torch.device("cpu")))
    ((ga, ci),) = uploaded[0]
    assert "native_pack" in ci._cache and not any(isinstance(k, tuple) for k in ci._cache)
    assert ga.contigs.lengths.tolist() == [2000]


def test_positional_mesh_binds_the_mesh(monkeypatch):
    from swg_panels import AA

    from kaptive_tpu_torch.core import pairwise
    from kaptive_tpu_torch.core.seq import Sequences
    from kaptive_tpu_torch.ops.swg import SwgLattice
    from kaptive_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(12)
    alpha = np.frombuffer(AA, np.uint8)
    qs = [alpha[rng.integers(0, 20, n)].tobytes() for n in (40, 90, 17, 60)]
    ts = [alpha[rng.integers(0, 20, n)].tobytes() for n in (45, 80, 17, 70)]
    q, t = Sequences.from_bytes(qs), Sequences.from_bytes(ts)
    n = len(qs)
    args = (q.seqs, q.offsets, q.lengths, t.seqs, t.offsets, t.lengths, np.zeros(n, np.int32),
            np.full(n, 40, np.int32), pairwise.blosum62_matrix().astype(np.int32), 11, 1)
    mesh = make_mesh(devices=["cpu", "cpu"])
    lattice = SwgLattice.for_max_len(128, batch=16)
    seen = []
    real = pairwise.launch_sweep

    def spy(*a, **kw):
        seen.append((kw.get("mesh"), kw["lattice"]))
        return real(*a, **kw)

    monkeypatch.setattr(pairwise, "launch_sweep", spy)
    sharded = pairwise.batched_swg_align(*args, mesh, lattice, device="cpu")
    plain = pairwise.batched_swg_align(*args, device="cpu")
    assert seen == [(mesh, lattice), (None, None)]
    assert_same(sharded, plain)
    seen.clear()
    aligner = pairwise.PairwiseAligner(11, 1, 20, mesh, lattice, device="cpu")
    assert (aligner.mesh, aligner.lattice) == (mesh, lattice)
    assert_same(aligner(q, t), pairwise.PairwiseAligner(device="cpu")(q, t))
    assert seen == [(mesh, lattice), (None, None)]
    with pytest.raises(TypeError):
        pairwise.PairwiseAligner(11, 1, 20, None, None, "cpu")  # device is keyword-only
    with pytest.raises(TypeError):
        pairwise.batched_swg_align_cigars(*args, lattice)  # its extras are keyword-only


def test_run_extension_dp_device_equals_jax(panels):
    import jax.numpy as jnp
    from kaptive_tpu.ops import mapper as jm
    from kaptive_tpu.ops.scan_pallas import pad_codes_for_scan_any as jax_pad

    from kaptive_tpu_torch.ops import mapper as tm
    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any

    ga, jax_ga = panels.assemblies[2], panels.jax_assemblies[2]
    gi, jgi = panels.db.gene_index, panels.jax_db.gene_index
    ci, jci = ga.get_minimizer_index(), jax_ga.get_minimizer_index()
    specs = tm.build_extension_specs(tm.host_seed_chains(gi, ci, tm.MapperParams()), gi, ci, tm.MapperParams(), 0)
    jspecs = jm.build_extension_specs(jm.host_seed_chains(jgi, jci, jm.MapperParams()), jgi, jci,
                                      jm.MapperParams(), 0)
    assert specs.keys() == jspecs.keys()
    for key in jspecs:
        np.testing.assert_array_equal(specs[key], jspecs[key], err_msg=key)
    flat = pad_codes_for_scan_any(ci.codes).reshape(-1)
    got = tm.run_extension_dp_device(specs, gi, flat, tm.MapperParams(), device="cpu")
    want = jm.run_extension_dp_device(jspecs, jgi, jnp.asarray(jax_pad(jci.codes).reshape(-1)), jm.MapperParams())
    assert len(want) == len(specs["gene"]) >= 5
    assert_same(got, want)
    assert torch.equal(gi.device_codes("cpu"), torch.from_numpy(gi.codes))
    if not torch.cuda.is_available():
        for accessor in (gi.device_codes, gi.device_table, gi.device_lookup, gi.device_bloom,
                         gi.device_gene_lengths, gi.seed_table):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                accessor()  # the card by default, and no fall-back to the CPU


def test_device_trace_writes_into_its_argument(tmp_path, monkeypatch):
    import kaptive_tpu_torch.utils as utils
    from kaptive_tpu_torch.utils import profiling

    assert utils.device_trace is profiling.device_trace and utils.phase_timer is profiling.phase_timer
    monkeypatch.setenv("KAPTIVE_TRACE_DIR", str(tmp_path / "from_env"))
    with utils.device_trace(tmp_path / "given") as path:
        torch.ones(8).sum()
    assert path.parent == tmp_path / "given" and path.is_file()
    assert not (tmp_path / "from_env").exists()
    monkeypatch.delenv("KAPTIVE_TRACE_DIR")
    with utils.device_trace() as nothing:
        pass
    assert nothing is None
