"""The port's BGC toolkit vs the JAX package's, on the CPU.

Each package compiles its own database from the same GenBank file and parses
its own assemblies from the same FASTA bytes; background proteins and
features go across as bytes and numpy arrays, never as objects.  Panels are
those of ``tests/test_bgc.py``: a planted locus and an alignment panel
(annotator), the block-recovery panel of the architectural decode, and the
train -> predict cycle.

Tolerances: the ORF calls, ``Genes`` fields, BED bytes, top hits, alignment
results, learned transitions, k-means labels, Viterbi paths and the
predictions' members are exact.  ``contextualize_features`` and
``archetype_emissions`` are held within ``rtol=1e-5, atol=1e-5``: their sums
(a prefix sum, a matrix product, row norms) run in another order than XLA's.
The trained centroids are held within ``rtol=1e-6, atol=1e-7`` (both go
through the same clustering in float64 and are cast to float32), and a
decode's score within ``rtol=1e-5`` where its emissions came through those
sums; on the same emissions the port's decode equals the JAX decode exactly.
"""

import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax_hostio import ensure_jax_hostio, jax_package_root
from synthetic import make_orf, make_synthetic_db, random_dna
from viterbi_panels import arch_panel

torch.set_num_threads(1)  # the plain decode issues many tiny ops
# The JAX package's host library, whole, before any xdist worker's first test parses FASTA with it
# (``tests/jax_hostio.py``: a worker that loaded it while another's g++ wrote it failed with
# "file too short" in ``test_annotator_equals_jax[planted-hmm-*]``).
ensure_jax_hostio()


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """``(port Database, JAX Database, truth, rng)`` compiled from the same GenBank file."""
    from kaptive_tpu.db import Database as JaxDatabase

    from kaptive_tpu_torch.db import Database

    rng = np.random.default_rng(17)
    gbk, truth = make_synthetic_db(tmp_path_factory.mktemp("torch_bgc"), rng, n_loci=3, genes_per_locus=6)
    return Database.from_genbank(gbk), JaxDatabase.from_genbank(gbk), truth, rng


def _assemblies(fasta: bytes, name: str):
    from kaptive_tpu.core.genome import GenomeAssembly as JaxAssembly

    from kaptive_tpu_torch.core.genome import GenomeAssembly

    return GenomeAssembly.from_stream(io.BytesIO(fasta), name), JaxAssembly.from_stream(io.BytesIO(fasta), name)


@pytest.fixture(scope="module")
def contigs(dbs):
    """The planted-locus contig (KL2, 2 kb flanks) and the alignment panel's two-contig assembly (KL1)."""
    _, _, truth, rng = dbs
    planted = b">c1\n%s\n" % (random_dna(rng, 2000) + truth["loci"]["KL2"]["seq"] + random_dna(rng, 2000))
    aligned = b">c1\n%s\n>c2\n%s\n" % (random_dna(rng, 1000) + truth["loci"]["KL1"]["seq"] + random_dna(rng, 1000),
                                      random_dna(rng, 700))
    return {"planted": planted, "aligned": aligned}


def _bed(result, tmp_path, hits_only: bool) -> bytes:
    path = tmp_path / f"out_{hits_only}.bed"
    result.write_bed(path, hits_only=hits_only)
    return path.read_bytes()


@pytest.mark.parametrize(("panel", "orf_method", "align"), [
    ("planted", "hmm", False), ("planted", "hmm", True), ("planted", "scan", False), ("planted", "scan", True),
    ("aligned", "hmm", True),
])
def test_annotator_equals_jax(dbs, contigs, tmp_path, panel, orf_method, align):
    from kaptive_tpu.bgc import Annotator as JaxAnnotator

    from kaptive_tpu_torch.bgc import Annotator
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    db, jax_db, _, _ = dbs
    ga, jax_ga = _assemblies(contigs[panel], "g")
    reset_metrics()
    got = Annotator(db, align=align, orf_method=orf_method, device="cpu")(ga)
    counts = snapshot()
    want = JaxAnnotator(jax_db, align=align, orf_method=orf_method)(jax_ga)

    assert len(got.genes) == len(want.genes) > 0
    for name in ("starts", "ends", "strands"):
        np.testing.assert_array_equal(getattr(got.genes.intervals, name), getattr(want.genes.intervals, name))
    for name in ("seqs", "offsets", "lengths"):
        np.testing.assert_array_equal(getattr(got.genes.translations, name), getattr(want.genes.translations, name))
    np.testing.assert_array_equal(got.genes.contig_indices, want.genes.contig_indices)
    np.testing.assert_array_equal(got.hits_mask, want.hits_mask)
    assert list(got.top_hit_names) == list(want.top_hit_names)
    np.testing.assert_array_equal(got.top_hit_scores, want.top_hit_scores)
    assert got.contig_names == want.contig_names
    locus = "KL2" if panel == "planted" else "KL1"
    assert any(locus in str(n) for n in got.top_hit_names[got.hits_mask])
    for hits_only in (True, False):
        assert _bed(got, tmp_path, hits_only) == _bed(want, tmp_path, hits_only)
    if align:
        assert got.alignments is not None and want.alignments is not None
        for name in ("scores", "matches", "mismatches", "gaps", "q_starts", "q_ends", "t_starts", "t_ends"):
            np.testing.assert_array_equal(getattr(got.alignments, name), getattr(want.alignments, name))
        assert (got.top_hit_scores[got.hits_mask] > 0).all()
        assert counts.get("swg.plain.fill", 0) > 0
    else:
        assert got.alignments is None and "swg.plain.fill" not in counts
    if orf_method == "hmm":
        assert counts.get("viterbi.plain.gene") == 1  # every strand of every contig in one decode
    else:
        assert "viterbi.plain.gene" not in counts


def test_planted_hmm_annotation_survives_a_jax_hostio_mid_build(tmp_path):
    """``test_annotator_equals_jax``'s planted/hmm cases in the state that failed them: in the
    first seconds of an xdist run another worker's g++ has created the JAX package's
    ``_hostio.so`` and not yet written it.  A copy of the JAX package holds an empty
    ``_hostio.so`` newer than its source (the JAX module alone then fails with "file too
    short"); the two cases run in a child pytest that imports that copy, and pass."""
    root = jax_package_root()
    shutil.copytree(root / "kaptive_tpu", tmp_path / "kaptive_tpu",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    (tmp_path / "native").mkdir()
    shutil.copy2(root / "native" / "hostio.cpp", tmp_path / "native" / "hostio.cpp")
    so = tmp_path / "kaptive_tpu" / "native" / "_hostio.so"
    so.touch()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(Path(__file__).resolve().parent.parent),
                                                        os.environ.get("PYTHONPATH", "")])}
    alone = subprocess.run([sys.executable, "-c", "import kaptive_tpu.native.hostio"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=120)
    assert alone.returncode != 0 and "file too short" in alone.stderr
    run = subprocess.run(
        [sys.executable, "-m", "pytest", str(Path(__file__).resolve()), "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "-k", "annotator_equals_jax and planted and hmm"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "2 passed" in run.stdout, run.stdout[-3000:] + run.stderr[-3000:]
    assert so.stat().st_size > 0  # the copy's library was the one built and loaded


def test_annotator_device_defaults_to_cuda(dbs):
    from kaptive_tpu_torch.bgc import Annotator

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Annotator(dbs[0])


def test_genes_container_and_orf_finder():
    from kaptive_tpu.bgc import find_orfs as jax_find_orfs
    from kaptive_tpu.bgc.orf import recover_frameshifts as jax_recover
    from kaptive_tpu.bgc.orf import resolve_overlaps as jax_resolve

    from kaptive_tpu_torch.bgc import Genes, find_orfs
    from kaptive_tpu_torch.bgc.orf import recover_frameshifts, resolve_overlaps

    assert len(Genes.empty()) == 0 and len(Genes.concat([])) == 0
    rng = np.random.default_rng(99)
    gene = make_orf(rng, 200)
    seq = random_dna(rng, 400) + gene[:300] + gene[301:] + random_dna(rng, 400)
    for min_codons in (20, 30):
        got, want = find_orfs(seq, min_codons), jax_find_orfs(seq, min_codons)
        assert [_orf_tuple(o) for o in got] == [_orf_tuple(o) for o in want] and want
        assert [_orf_tuple(o) for o in recover_frameshifts(resolve_overlaps(got))] == \
            [_orf_tuple(o) for o in jax_recover(jax_resolve(want))]


@pytest.mark.parametrize("n", [0, 1, 40, 3000])
def test_resolve_overlaps_equals_jax(n):
    """The vectorised overlap check keeps the JAX loop's ORFs, ties and order included."""
    from kaptive_tpu.bgc.orf import Orf as JaxOrf
    from kaptive_tpu.bgc.orf import resolve_overlaps as jax_resolve

    from kaptive_tpu_torch.bgc.orf import Orf, resolve_overlaps

    rng = np.random.default_rng(n)
    starts = rng.integers(0, 20 * n + 1, n)
    ends = starts + rng.choice([90, 93, 150, 300, 1200, 3000], n)  # equal lengths: ties in the greedy order
    strands = rng.choice([1, -1], n)
    got = resolve_overlaps([Orf(int(a), int(b), int(c), b"M") for a, b, c in zip(starts, ends, strands)])
    want = jax_resolve([JaxOrf(int(a), int(b), int(c), b"M") for a, b, c in zip(starts, ends, strands)])
    assert [_orf_tuple(o) for o in got] == [_orf_tuple(o) for o in want]
    assert n < 40 or 0 < len(got) < n


def _orf_tuple(orf):
    return (int(orf.start), int(orf.end), int(orf.strand), bytes(orf.translation))


def test_contextualize_and_emissions_within_float32():
    import jax.numpy as jnp
    from kaptive_tpu.bgc import kernels as jk

    from kaptive_tpu_torch.bgc import kernels as tk

    rng = np.random.default_rng(3)
    hashes = rng.integers(0, 2**63, 4000, dtype=np.uint64)
    seq_idx = np.sort(rng.integers(0, 40, 4000))
    feats = tk.vectorize_orfs(hashes, seq_idx, 40, 256)
    np.testing.assert_array_equal(feats, jk.vectorize_orfs(hashes, seq_idx, 40, 256))
    np.testing.assert_array_equal(tk.compute_record_offsets(seq_idx, 40), jk.compute_record_offsets(seq_idx, 40))
    centroids = rng.random((8, 256)).astype(np.float32)
    bg = rng.random(256).astype(np.float32)
    for window in (0, 1, 3):
        got = tk.contextualize_features(torch.from_numpy(feats), window)
        want = np.asarray(jk.contextualize_features(jnp.asarray(feats), window))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        em = tk.archetype_emissions(got, torch.from_numpy(centroids), torch.from_numpy(bg), -1.0)
        em_want = np.asarray(jk.archetype_emissions(jnp.asarray(want), jnp.asarray(centroids), jnp.asarray(bg), -1.0))
        assert em.dtype == torch.float32 and em.shape == (40, 8 + 3)
        np.testing.assert_allclose(em.numpy(), em_want, rtol=1e-5, atol=1e-5)


def _arch_cases():
    T = np.log(np.array([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [1e-9, 1e-9, 1.0]], dtype=np.float32))
    block = np.full((7, 3), -10.0, dtype=np.float32)
    block[:2, 0] = block[2:5, 1] = block[5:, 2] = 0.0
    cases = {"block": (block, T), "n0": (block[:0], T), "n1": (block[:1], T)}
    rng = np.random.default_rng(11)
    for S in (8, 28):
        em, trans, bounds = arch_panel(rng, [2, 17, 150], S)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            cases[f"S{S}_N{hi - lo}"] = (em[lo:hi], trans)
    return cases


ARCH_CASES = _arch_cases()


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_architectural_viterbi_equals_jax(case):
    from kaptive_tpu.bgc.kernels import architectural_viterbi_host as jax_viterbi

    from kaptive_tpu_torch.bgc.kernels import architectural_viterbi_host

    em, trans = ARCH_CASES[case]
    path, score = architectural_viterbi_host(em, trans, device="cpu")
    want_path, want_score = jax_viterbi(em, trans)
    assert path.dtype == np.int32
    np.testing.assert_array_equal(path, want_path)
    assert score == want_score or (np.isinf(score) and np.isinf(want_score))
    if case == "block":
        assert list(path) == [0, 0, 1, 1, 1, 2, 2]


def test_architectural_viterbi_batch_is_per_contig():
    """A ragged batch of contigs in one decode gives each contig's own decode."""
    from kaptive_tpu_torch.bgc.kernels import architectural_viterbi_batch
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    ems = [ARCH_CASES[c][0] for c in ("S28_N2", "S28_N17", "S28_N150")]
    trans = ARCH_CASES["S28_N2"][1]
    reset_metrics()
    batch = architectural_viterbi_batch([ems[2], ems[0][:1], ems[1], ems[0]], trans, device="cpu")
    assert snapshot().get("viterbi.plain.arch") == 1
    singles = [architectural_viterbi_batch([e], trans, device="cpu")[0] for e in (ems[2], ems[0][:1], ems[1], ems[0])]
    for (p, s), (ps, ss) in zip(batch, singles, strict=True):
        np.testing.assert_array_equal(p, ps)
        assert s == ss


@pytest.fixture(scope="module")
def trained(dbs):
    """Models trained by both packages on the same loci and background protein bytes."""
    from kaptive_tpu.bgc import ArchitecturalTrainer as JaxTrainer
    from kaptive_tpu.core.seq import BacterialTranslationTable
    from kaptive_tpu.core.seq import Sequences as JaxSequences

    from kaptive_tpu_torch.bgc import ArchitecturalTrainer
    from kaptive_tpu_torch.core.seq import Sequences

    db, jax_db, _, _ = dbs
    rng = np.random.default_rng(23)
    bg = [bytes(BacterialTranslationTable.translate(make_orf(rng, 150), to_stop=True)) for _ in range(20)]
    names = ("KL1", "KL2", "KL3")
    model = ArchitecturalTrainer(num_archetypes=5, feature_dim=256).train(
        [db.get_locus_data(n) for n in names], background_proteins=Sequences.from_bytes(bg))
    jax_model = JaxTrainer(num_archetypes=5, feature_dim=256).train(
        [jax_db.get_locus_data(n) for n in names], background_proteins=JaxSequences.from_bytes(bg))
    return model, jax_model, bg


def test_trained_model_equals_jax(trained, tmp_path):
    from kaptive_tpu.bgc import ArchitecturalModel as JaxModel

    from kaptive_tpu_torch.bgc import ArchitecturalModel

    model, jax_model, _ = trained
    assert model.centroids.shape == (5, 256) and model.transitions.shape == (8, 8)
    np.testing.assert_array_equal(model.transitions, jax_model.transitions)
    np.testing.assert_array_equal(model.bg_centroid, jax_model.bg_centroid)
    np.testing.assert_allclose(model.centroids, jax_model.centroids, rtol=1e-6, atol=1e-7)
    # An .npz saved by either package loads in the other.
    model.save(tmp_path / "port.npz")
    jax_model.save(tmp_path / "jax.npz")
    for got, want in ((JaxModel.load(tmp_path / "port.npz"), model), (ArchitecturalModel.load(tmp_path / "jax.npz"),
                                                                       jax_model)):
        for name in ("centroids", "bg_centroid", "transitions"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_minibatch_kmeans_equals_jax():
    """The built-in clustering (what runs where scikit-learn is absent) gives the JAX labels."""
    from kaptive_tpu.bgc.trainer import _minibatch_kmeans as jax_kmeans

    from kaptive_tpu_torch.bgc.trainer import _minibatch_kmeans

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(c, 0.3, (60, 32)) for c in range(4)]).astype(np.float32)
    labels, centroids = _minibatch_kmeans(x, 4)
    want_labels, want_centroids = jax_kmeans(x, 4)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(centroids, want_centroids)
    assert len(set(labels.tolist())) == 4


@pytest.fixture(scope="module")
def predicted(dbs, contigs, trained):
    """``predict_contig`` on a clean ORF stream and ``predict`` on the planted genome, both packages."""
    from kaptive_tpu.bgc import Annotator as JaxAnnotator
    from kaptive_tpu.bgc import ArchitecturalPredictor as JaxPredictor
    from kaptive_tpu.core.seq import Sequences as JaxSequences

    from kaptive_tpu_torch.bgc import Annotator, ArchitecturalPredictor
    from kaptive_tpu_torch.core.seq import Sequences

    db, jax_db, _, _ = dbs
    model, jax_model, bg = trained
    kl2 = db.get_locus_data("KL2").proteins
    kl2_bytes = [kl2.seqs[o: o + n].tobytes() for o, n in zip(kl2.offsets, kl2.lengths)]
    stream = bg[:4] + kl2_bytes + bg[4:8]
    pred, jax_pred = ArchitecturalPredictor(model, device="cpu"), JaxPredictor(jax_model)
    ga, jax_ga = _assemblies(contigs["planted"], "g")
    return {
        "contig": (pred.predict_contig(Sequences.from_bytes(stream)),
                   jax_pred.predict_contig(JaxSequences.from_bytes(stream))),
        "genome": (pred.predict(Annotator(db, device="cpu")(ga)), jax_pred.predict(JaxAnnotator(jax_db)(jax_ga))),
        "emissions": jax_pred._orf_emissions(JaxSequences.from_bytes(stream)),
        "transitions": jax_model.transitions,
    }


def test_predict_contig_equals_jax(predicted):
    from kaptive_tpu.bgc.kernels import architectural_viterbi_host as jax_viterbi

    from kaptive_tpu_torch.bgc.kernels import architectural_viterbi_host

    (path, score), (want_path, want_score) = predicted["contig"]
    np.testing.assert_array_equal(path, want_path)
    assert path[-1] == 7 and np.isfinite(score)
    np.testing.assert_allclose(score, want_score, rtol=1e-5)
    # On the JAX package's own emissions the decode is exact, score included.
    em, trans = predicted["emissions"], predicted["transitions"]
    got = architectural_viterbi_host(em, trans, device="cpu")
    want = jax_viterbi(em, trans)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_predict_equals_jax(predicted):
    got, want = predicted["genome"]
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.contig_names, want.contig_names)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5)
    for name in ("offsets", "lengths", "member_orfs", "member_states"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.member_proteins.seqs, want.member_proteins.seqs)
    for i in range(len(got)):
        name, _, orfs, states, proteins = got[i]
        assert len(orfs) == len(states) == len(proteins)
