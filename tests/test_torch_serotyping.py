"""The port's Serotyper and stream_type vs the JAX Serotyper in host-seeded mode.

Both packages type the same assemblies against the same database; the port
runs on the CPU (the plain PyTorch DP).  Tolerance: exact —
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
