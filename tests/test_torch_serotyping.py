"""The port's Serotyper and stream_type vs the JAX Serotyper, host- and device-seeded.

Both packages type the same assemblies against the same database, in the
seeding mode ``KAPTIVE_SEED_MODE`` names; the port runs on the CPU (the plain
PyTorch scan and DP).  Tolerance: exact —
``SerotypingResult.to_dict()`` agrees field by field (NaN equals NaN) and the
22-column KaptiveRow bytes are identical.
"""

import io

import pytest
import torch
from typing_panel import TRUTH, assert_same, make_typing_panel

from kaptive_tpu.serotyping.io import KaptiveRow

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
    return db, paths


@pytest.fixture(scope="module")
def jax_results(panel):
    """The JAX package's results, host-seeded: (batch, stream_type batch_size=2)."""
    from kaptive_tpu.parallel.pipeline import stream_type
    from kaptive_tpu.serotyping import Serotyper

    db, paths = panel
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

    db, paths = panel
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAPTIVE_SEED_MODE", "device")
        serotyper = Serotyper(db)
        batch = serotyper.batch(list(paths))
        streamed = list(stream_type(serotyper, list(paths), batch_size=2))
    return batch, streamed


@pytest.fixture(scope="module")
def port_serotyper(panel):
    from kaptive_tpu_torch.serotyping import Serotyper

    return Serotyper(panel[0], device="cpu")


def _assert_results_equal(got, want):
    assert [r.best_locus_name for r in want] == TRUTH
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g.to_dict(), w.to_dict(), f"result[{w.genome}]")
        assert bytes(KaptiveRow.from_result(g)) == bytes(KaptiveRow.from_result(w))


def test_batch_equals_jax(panel, jax_results, port_serotyper):
    _assert_results_equal(port_serotyper.batch(list(panel[1])), jax_results[0])


def test_stream_type_equals_jax(panel, jax_results, port_serotyper):
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

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
    from kaptive_tpu.core.genome import GenomeAssembly

    from kaptive_tpu_torch.parallel.pipeline import stream_type

    db, paths = panel
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
        Serotyper(panel[0])


def _rows(results):
    return [bytes(KaptiveRow.from_result(r)) for r in results]


def test_device_mode_batch_equals_jax_and_host(panel, jax_results, jax_device_results, port_serotyper, monkeypatch):
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    monkeypatch.setenv("KAPTIVE_SEED_MODE", "device")
    reset_metrics()
    got = port_serotyper.batch(list(panel[1]))
    counts = snapshot()
    _assert_results_equal(got, jax_device_results[0])
    assert _rows(got) == _rows(jax_results[0])  # host-seeded rows, byte for byte
    assert counts.get("map.device_chained") == len(got)
    assert counts.get("scan.plain.rowcompact") == 1
    assert not any(key.startswith(("map.host_seed", "map.host_fallback")) for key in counts)


def test_device_mode_stream_type_equals_jax(panel, jax_results, jax_device_results, port_serotyper, monkeypatch):
    """The ingest pool pre-uploads instead of pre-seeding: no chains are left on the indexes."""
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

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
    assert _rows(got) == _rows(jax_results[1])
    assert len(seen) == len(got)
    for ci in seen:
        assert "host_chains" not in ci._cache
        assert ("device_inputs", "cpu") in ci._cache
    assert counts.get("map.device_chained") == len(got)
    assert not any(key.startswith("map.host_seed") for key in counts)
