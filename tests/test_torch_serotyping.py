"""The port's Serotyper and stream_type vs the JAX Serotyper, host- and device-seeded.

Both packages type the same FASTA files; the port's database is the JAX
package's carried across by its pickle (``loads_reference``), and a JAX
database object handed to the port's Serotyper is refused.  Both run in the
seeding mode ``KAPTIVE_SEED_MODE`` names; the port runs on the CPU (the plain
PyTorch scan and DP).  Tolerance: exact —
``SerotypingResult.to_dict()`` agrees field by field (NaN equals NaN) and the
22-column KaptiveRow bytes are identical.
"""

import io

import pytest
import torch
from torch_panel import carried_database
from typing_panel import TRUTH, assert_same, make_typing_panel

from kaptive_tpu.serotyping.io import KaptiveRow as JaxRow

from kaptive_tpu_torch.serotyping.io import KaptiveRow

# One intra-op thread: the plain DP issues many tiny ops, and idle OpenMP
# workers spinning in several test processes at once starve the JAX side.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_typing")
    db, genomes = make_typing_panel(tmp)
    paths = []
    for name, fasta in genomes:
        path = tmp / f"{name}.fasta"
        path.write_bytes(fasta)
        paths.append(path)
    return db, paths, carried_database(db)


@pytest.fixture(scope="module")
def jax_results(panel):
    """The JAX package's results, host-seeded: (batch, stream_type batch_size=2)."""
    from kaptive_tpu.parallel.pipeline import stream_type
    from kaptive_tpu.serotyping import Serotyper

    db, paths, _ = panel
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAPTIVE_SEED_MODE", "host")
        serotyper = Serotyper(db)
        batch = serotyper.batch(list(paths))
        streamed = list(stream_type(serotyper, list(paths), batch_size=2))
    return batch, streamed


@pytest.fixture(scope="module")
def jax_device_results(panel):
    """The JAX package's results, device-seeded: (batch, stream_type batch_size=2)."""
    from kaptive_tpu.parallel.pipeline import stream_type
    from kaptive_tpu.serotyping import Serotyper

    db, paths, _ = panel
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAPTIVE_SEED_MODE", "device")
        serotyper = Serotyper(db)
        batch = serotyper.batch(list(paths))
        streamed = list(stream_type(serotyper, list(paths), batch_size=2))
    return batch, streamed


@pytest.fixture(scope="module")
def port_serotyper(panel):
    from kaptive_tpu_torch.serotyping import Serotyper

    return Serotyper(panel[2], device="cpu")


def _assert_results_equal(got, want):
    assert [r.best_locus_name for r in want] == TRUTH
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g.to_dict(), w.to_dict(), f"result[{w.genome}]")
        assert bytes(KaptiveRow.from_result(g)) == bytes(JaxRow.from_result(w))


def test_batch_equals_jax(panel, jax_results, port_serotyper):
    _assert_results_equal(port_serotyper.batch(list(panel[1])), jax_results[0])


def test_stream_type_equals_jax(panel, jax_results, port_serotyper):
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.parallel.pipeline import stream_type

    reset_metrics()
    got = list(stream_type(port_serotyper, list(panel[1]), batch_size=2))
    _assert_results_equal(got, jax_results[1])
    counts = snapshot()
    # Every assembly was seeded on the ingest pool, and the DP ran the plain
    # version (CPU tensors), never a kernel.
    assert counts.get("map.host_seed.preseeded", 0) == len(got)
    assert counts.get("swg.plain.fill", 0) > 0
    assert "swg.cuda.fill" not in counts


def test_single_genome_call_and_stream_handles(panel, port_serotyper):
    """``Serotyper(genome)`` and a stream of in-memory handles type correctly."""
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.parallel.pipeline import stream_type

    paths = panel[1]
    one = port_serotyper(GenomeAssembly.from_file(paths[1]))
    assert one.best_locus_name == TRUTH[1]
    handles = [io.BytesIO(p.read_bytes()) for p in paths]
    got = [r.best_locus_name for r in stream_type(port_serotyper, handles, batch_size=3)]
    assert got == TRUTH


def test_serotyper_defaults_to_cuda(panel):
    """The default device is CUDA: without a card the constructor raises, never falls back."""
    from kaptive_tpu_torch.serotyping import Serotyper

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Serotyper(panel[2])


def test_serotyper_refuses_a_jax_database(panel):
    """Two classes share the name ``Database``: the other package's fails loudly, at construction."""
    from kaptive_tpu_torch.serotyping import Serotyper

    with pytest.raises(TypeError, match="kaptive_tpu_torch.db.Database"):
        Serotyper(panel[0], device="cpu")


def test_serotyper_options_after_mapper_params_are_keyword_only(panel):
    """The JAX ``Serotyper`` has ``scoring_metric`` sixth; the port has no such option, so a
    positional call in the JAX order raises instead of landing in ``min_gene_coverage``."""
    import inspect

    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper

    from kaptive_tpu_torch.serotyping import Serotyper

    assert list(inspect.signature(JaxSerotyper.__init__).parameters)[5:7] == ["mapper_params", "scoring_metric"]
    with pytest.raises(TypeError):
        Serotyper(panel[2], 1, 0.5, False, None, "identity", device="cpu")
    with pytest.raises(TypeError):
        Serotyper(panel[2], 1, 0.5, False, None, 0.3, device="cpu")
    serotyper = Serotyper(panel[2], 2, 0.6, True, None, min_gene_coverage=0.3, partial_edge_tolerance=7,
                          device="cpu")
    assert (serotyper.max_other_genes, serotyper.min_completeness, serotyper.allow_below_threshold,
            serotyper.min_gene_coverage, serotyper.partial_edge_tolerance) == (2, 0.6, True, 0.3, 7)


def _rows(results, row=KaptiveRow):
    return [bytes(row.from_result(r)) for r in results]


def test_device_mode_batch_equals_jax_and_host(panel, jax_results, jax_device_results, port_serotyper, monkeypatch):
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    monkeypatch.setenv("KAPTIVE_SEED_MODE", "device")
    reset_metrics()
    got = port_serotyper.batch(list(panel[1]))
    counts = snapshot()
    _assert_results_equal(got, jax_device_results[0])
    assert _rows(got) == _rows(jax_results[0], JaxRow)  # host-seeded rows, byte for byte
    assert counts.get("map.device_chained") == len(got)
    assert counts.get("scan.plain.rowcompact") == 1
    assert not any(key.startswith(("map.host_seed", "map.host_fallback")) for key in counts)


def test_device_seeding_span_counts_the_assemblies_seeded_on_the_device(panel, port_serotyper, monkeypatch):
    """A traced device-seeded batch opens one ``map.seed_device`` in ``type.map``, over the scan and
    match and the copy back; its counter ``map.device_seeded``, added once it closes, is the batch size,
    and no assembly is counted under ``map.host_fallback``."""
    from kaptive_tpu_torch.utils.profiling import recording, reset_phases

    monkeypatch.setenv("KAPTIVE_SEED_MODE", "device")
    monkeypatch.setenv("KAPTIVE_PROFILE", "1")
    reset_phases()
    try:
        got = port_serotyper.batch(list(panel[1]))
        spans = recording()[1]
    finally:
        reset_phases()
    assert [r.best_locus_name for r in got] == TRUTH
    [seed] = [s for s in spans if s.name == "map.seed_device"]
    assert seed.parent is not None and seed.parent.name == "type.map"
    assert seed.counts == {"map.device_seeded": len(got)}
    assert {s.name for s in spans if s.parent is seed} == {"map.scan_match", "map.scan_sync"}
    assert not any(s.name in ("map.seed", "map.chain") for s in spans)


def test_device_mode_stream_type_equals_jax(panel, jax_results, jax_device_results, port_serotyper, monkeypatch):
    """The ingest pool pre-uploads instead of pre-seeding: no chains are left on the indexes."""
    from kaptive_tpu_torch.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.parallel.pipeline import stream_type

    monkeypatch.setenv("KAPTIVE_SEED_MODE", "device")
    seen = []
    map_batch = port_serotyper.map_batch

    def spy(assemblies, indexes=None):
        seen.extend(indexes)
        return map_batch(assemblies, indexes)

    monkeypatch.setattr(port_serotyper, "map_batch", spy)
    reset_metrics()
    got = list(stream_type(port_serotyper, list(panel[1]), batch_size=2))
    counts = snapshot()
    _assert_results_equal(got, jax_device_results[1])
    assert _rows(got) == _rows(jax_results[1], JaxRow)
    assert len(seen) == len(got)
    for ci in seen:
        assert "host_chains" not in ci._cache
        assert ("device_inputs", "cpu") in ci._cache
    assert counts.get("map.device_chained") == len(got)
    assert not any(key.startswith("map.host_seed") for key in counts)


def test_the_cull_span_nests_in_decide_and_counts_hits_offered_and_kept(panel, port_serotyper, monkeypatch):
    """One ``decide.cull`` a batch, inside ``type.decide``; its counters, added once it closes, are
    the hits ``reconstruct_loci`` was handed and the hits it kept."""
    from kaptive_tpu_torch.serotyping import core
    from kaptive_tpu_torch.utils.profiling import recording, reset_phases

    seen = []
    reconstruct = core.reconstruct_loci

    def spy(db, hits, pick, n_asm):
        recon = reconstruct(db, hits, pick, n_asm)
        seen.append((len(hits), len(recon.hits)))
        return recon

    monkeypatch.setattr(core, "reconstruct_loci", spy)
    monkeypatch.setenv("KAPTIVE_PROFILE", "1")
    reset_phases()
    try:
        got = port_serotyper.batch(list(panel[1]))
        spans = [s for s in recording()[1] if s.name == "decide.cull"]
    finally:
        reset_phases()
    assert [r.best_locus_name for r in got] == TRUTH
    [(offered, kept)] = seen
    [span] = spans
    assert span.parent is not None and span.parent.name == "type.decide"
    assert span.parent.start <= span.start <= span.end <= span.parent.end
    assert span.counts == {"cull.items": offered, "cull.kept": kept}
    assert offered >= kept > 0
