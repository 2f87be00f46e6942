"""Hopper kernels (banded SWG, CIGAR traceback, row-compact scan) vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
only torch, numpy and the port; ``tests/conftest.py`` imports jax and sets it
up for the JAX package's CPU tests, so run this file on the card's machine
with ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.

Tolerance: exact.  The DP is integer arithmetic; every SwgResult field and
every traceback byte on rows the query reaches must be equal; the CIGAR
traceback's whole ``ops`` buffers, ``n_ops`` and ``overflow`` too.  The scan's
``hashes``, ``aux`` and ``counts`` must be equal.  The screen's ``best`` and
tallies on the card equal the CPU's exactly, its float32 ``weighted`` scores
to ``rtol=1e-6``; the CLI on the card writes the in-process rows' bytes.
"""

import numpy as np
import pytest
import torch

from scan_panels import PANELS, random_stream
from swg_panels import AA, CIGAR_PANELS, NT, blosum_matrix, cigar_panel, nt_matrix, random_swg_batch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kaptive_tpu_torch.ops import swg_cuda

    swg_cuda.build()
    return torch.device("cuda", 0)


CASES = [
    # name, alphabet, matrix, gap_open, gap_extend, B, rows_max, w_pad, seeded, tie_heavy
    ("protein-unseeded", AA, blosum_matrix, 11, 1, 13, 384, 640, False, False),
    ("protein-seeded", AA, blosum_matrix, 11, 1, 8, 128, 128, True, False),
    ("nt-extension", NT, nt_matrix, 4, 2, 37, 1024, 512, True, False),
    ("nt-unseeded", NT, nt_matrix, 4, 2, 16, 256, 384, False, False),
    ("nt-repeats", NT, nt_matrix, 4, 2, 24, 256, 128, False, True),
    ("protein-repeats", AA, blosum_matrix, 11, 1, 9, 192, 256, True, True),
    ("wide-2048", NT, nt_matrix, 4, 2, 5, 320, 2048, False, False),
    ("wide-8192", AA, blosum_matrix, 11, 1, 3, 128, 8192, False, False),
    ("lanes-per-thread-4", AA, blosum_matrix, 11, 1, 4, 200, 1152, False, False),
    ("lanes-per-thread-8", NT, nt_matrix, 4, 2, 3, 96, 3072, True, False),
    ("idle-threads-4224", AA, blosum_matrix, 11, 1, 2, 96, 4224, False, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_equals_plain(device, case):
    from kaptive_tpu_torch.ops.swg import fill_band_plain, traceback_plain
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda, swg_traceback_cuda

    name, alphabet, matrix_fn, go, ge, B, rows_max, w_pad, seeded, ties = case
    rng = np.random.default_rng(sum(map(ord, name)))
    arrays = random_swg_batch(rng, alphabet, B, rows_max, w_pad, seeded=seeded, tie_heavy=ties)
    q, ql, t, tl, off, kl = (torch.from_numpy(a).to(device) for a in arrays)
    mat = as_kernel_matrix(torch.from_numpy(matrix_fn()), device)
    kw = dict(gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)

    tb_k, *best_k = swg_fill_cuda(q, ql, t, tl, off, kl, mat, **kw)
    tb_p, *best_p = fill_band_plain(q, ql, t, tl, off, kl, mat, **kw)
    for got, want in zip(best_k, best_p):
        assert torch.equal(got, want)
    rows = torch.arange(rows_max, device=device)[None, :, None] < ql.to(torch.int64)[:, None, None]
    assert torch.equal(torch.where(rows, tb_k, 0), torch.where(rows, tb_p, 0))

    tr = dict(rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    res_k = swg_traceback_cuda(tb_k, q, t, *best_k, off, **tr)
    res_p = traceback_plain(tb_p, q, t, *best_p, off, **tr)
    torch.cuda.synchronize()
    for f, got, want in zip(res_p._fields, res_k.unbind(0), res_p):
        assert torch.equal(got, want), f


def test_front_door_routes_cuda_to_kernels(device):
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.swg import banded_swg

    rng = np.random.default_rng(3)
    arrays = random_swg_batch(rng, NT, 7, 128, 128, seeded=True)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    reset_metrics()
    banded_swg(*args, torch.from_numpy(nt_matrix()).to(device),
               gap_open=4, gap_extend=2, rows_max=128, w_pad=128, t_pad=130)
    counts = snapshot()
    assert counts.get("swg.cuda.fill") == 1 and counts.get("swg.cuda.traceback") == 1
    assert "swg.plain.fill" not in counts and "swg.plain.traceback" not in counts


def test_fill_rejects_too_wide_band(device):
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda

    rng = np.random.default_rng(4)
    arrays = random_swg_batch(rng, NT, 2, 64, 16384, seeded=True)
    args = [torch.from_numpy(a).to(device) for a in arrays]
    with pytest.raises(ValueError, match="w_pad"):
        swg_fill_cuda(*args, as_kernel_matrix(nt_matrix(), device),
                      gap_open=4, gap_extend=2, rows_max=64, w_pad=16384)


@pytest.fixture(scope="module")
def scan_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from kaptive_tpu_torch.ops import scan_cuda

    scan_cuda.build()
    print(f"scan.cu ptxas: {scan_cuda.LIBRARY.ptxas_report()}")
    return torch.device("cuda", 0)


SCAN_CASES = [(name, B) for name in PANELS for B in (1, 3)] + [("bench-rows-45056", 1), ("bench-rows-45056", 3)]


@pytest.mark.parametrize("case", SCAN_CASES, ids=[f"{n}-B{b}" for n, b in SCAN_CASES])
def test_scan_kernel_equals_plain(scan_device, case):
    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any, rowcompact_scan_plain
    from kaptive_tpu_torch.ops.scan_cuda import rowcompact_scan_cuda

    name, B = case
    rng = np.random.default_rng(sum(map(ord, name)) + B)
    make = PANELS.get(name, lambda r: random_stream(r, 45056))
    codes = torch.from_numpy(np.stack([pad_codes_for_scan_any(make(rng)) for _ in range(B)])).to(scan_device)
    got = rowcompact_scan_cuda(codes, 15, 10)
    want = rowcompact_scan_plain(codes, 15, 10)
    torch.cuda.synchronize()
    for field, g, w in zip(("hashes", "aux", "counts"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert torch.equal(g, w), field
    if name == "poly-a-overflow":
        assert int(got[2].max()) > 64


def test_scan_front_door_routes_by_device(scan_device):
    """A CUDA tensor reaches only the kernel, a CPU tensor only the plain version."""
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.scan import pad_codes_for_scan_any, rowcompact_scan
    from kaptive_tpu_torch.ops.scan_cuda import rowcompact_scan_cuda

    codes = torch.from_numpy(pad_codes_for_scan_any(random_stream(np.random.default_rng(8), 96)))[None]
    reset_metrics()
    on_card = rowcompact_scan(codes.to(scan_device), 15, 10)
    assert snapshot() == {"scan.cuda.rowcompact": 1}
    reset_metrics()
    on_cpu = rowcompact_scan(codes, 15, 10)
    assert snapshot() == {"scan.plain.rowcompact": 1}
    for g, w in zip(on_card, on_cpu):
        assert torch.equal(g.cpu(), w)
    with pytest.raises(ValueError, match="CUDA"):
        rowcompact_scan_cuda(codes, 15, 10)


def test_device_seeded_serotyper_on_card_equals_host(scan_device, monkeypatch, tmp_path):
    """The typing panel on the card, device-seeded: KaptiveRow bytes equal host mode's,
    and the scan ran on the kernel only."""
    import io

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import TRUTH, make_typing_panel

    from kaptive_tpu.serotyping.io import KaptiveRow
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.parallel import stream_type
    from kaptive_tpu_torch.serotyping import Serotyper

    db, genomes = make_typing_panel(tmp_path)
    serotyper = Serotyper(db, device="cuda")

    def rows(mode):
        monkeypatch.setenv("KAPTIVE_SEED_MODE", mode)
        batch = serotyper.batch([io.BytesIO(f) for _, f in genomes])
        streamed = list(stream_type(serotyper, [io.BytesIO(f) for _, f in genomes], batch_size=2))
        assert [r.best_locus_name for r in batch] == TRUTH
        return [bytes(KaptiveRow.from_result(r)) for r in batch + streamed]

    host = rows("host")
    reset_metrics()
    device = rows("device")
    counts = snapshot()
    assert device == host
    assert counts.get("scan.cuda.rowcompact", 0) > 0 and "scan.plain.rowcompact" not in counts
    assert counts.get("swg.cuda.fill", 0) > 0 and "swg.plain.fill" not in counts
    assert counts.get("map.device_chained") == 2 * len(genomes)


@pytest.mark.parametrize("kind", CIGAR_PANELS)
def test_cigar_kernel_equals_plain(device, kind):
    from kaptive_tpu_torch.ops.swg import fill_band_plain, traceback_cigar_plain
    from kaptive_tpu_torch.ops.swg_cuda import as_kernel_matrix, swg_fill_cuda, swg_traceback_cigar_cuda

    arrays, matrix, go, ge, rows_max, w_pad = cigar_panel(np.random.default_rng(sum(map(ord, kind))), kind)
    q, ql, t, tl, off, kl = (torch.from_numpy(a).to(device) for a in arrays)
    mat = as_kernel_matrix(torch.from_numpy(matrix), device)
    tb, *best = swg_fill_cuda(q, ql, t, tl, off, kl, mat, gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad)
    # Both walks read the kernel's traceback bits (the fill is held to its plain version above).
    tr = dict(rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    out, ops, n_ops, overflow = swg_traceback_cigar_cuda(tb, q, t, *best, off, **tr)
    res_p, ops_p, n_p, over_p = traceback_cigar_plain(tb, q, t, *best, off, **tr)
    torch.cuda.synchronize()
    for f, got, want in zip(res_p._fields, out.unbind(0), res_p):
        assert torch.equal(got, want), f
    assert ops.dtype == ops_p.dtype and torch.equal(ops, ops_p)
    assert torch.equal(n_ops, n_p) and torch.equal(overflow, over_p)
    if kind == "overflow":
        assert bool(overflow[0]) and not overflow[1:].any()


def test_cigar_front_door_routes_cuda_to_kernels(device):
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot

    from kaptive_tpu_torch.ops.swg import banded_swg_cigars

    arrays, matrix, go, ge, rows_max, w_pad = cigar_panel(np.random.default_rng(9), "nt-indels")
    kw = dict(gap_open=go, gap_extend=ge, rows_max=rows_max, w_pad=w_pad, t_pad=w_pad + 2)
    reset_metrics()
    on_card = banded_swg_cigars(*(torch.from_numpy(a).to(device) for a in arrays),
                                torch.from_numpy(matrix).to(device), **kw)
    assert snapshot() == {"swg.cuda.fill": 1, "swg.cuda.traceback_cigar": 1}
    reset_metrics()
    on_cpu = banded_swg_cigars(*(torch.from_numpy(a) for a in arrays), torch.from_numpy(matrix), **kw)
    assert snapshot() == {"swg.plain.fill": 1, "swg.plain.traceback_cigar": 1}
    for got, want in zip([*on_card[0], *on_card[1:]], [*on_cpu[0], *on_cpu[1:]]):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("seed_mode", ["host", "device"])
def test_mapper_cigars_on_card_equal_cpu(scan_device, seed_mode, tmp_path):
    import io

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import assert_same, make_typing_panel

    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.ops.mapper import GeneIndex, MapperParams, map_genes_batch

    db, genomes = make_typing_panel(tmp_path)
    assemblies = [GenomeAssembly.from_stream(io.BytesIO(f), n) for n, f in genomes]
    gi = GeneIndex.build(db.genes)
    names = tuple(str(i) for i in range(len(db.genes)))
    params = MapperParams(emit_cigars=True)
    reset_metrics()
    got = map_genes_batch(gi, assemblies, names, params, seed_mode=seed_mode, device="cuda")
    counts = snapshot()
    assert counts.get("swg.cuda.traceback_cigar", 0) > 0 and "swg.plain.traceback_cigar" not in counts
    want = map_genes_batch(gi, assemblies, names, params, seed_mode=seed_mode, device="cpu")
    assert_same(got, want)
    assert sum(int(a.cigars.lengths.sum()) for a in got) > 0


def test_screen_on_card_equals_cpu(scan_device, tmp_path):
    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import TRUTH, make_typing_panel

    from kaptive_tpu.utils.metrics import reset_metrics, snapshot
    from kaptive_tpu_torch.ops.mapper import GeneIndex
    from kaptive_tpu_torch.parallel.screen import ScreenTables, encode_assemblies_to_batch, locus_screen_batch
    from kaptive_tpu_torch.serotyping import Serotyper

    db, genomes = make_typing_panel(tmp_path)
    # A 400-base poly-A run before the KL3 locus: its scan rows hold more than
    # 64 minimizers, so the card re-tallies that genome from the flat plain scan.
    revcomp = dict(genomes)["revcomp"]
    genomes.append(("poly_a", revcomp[:4] + b"A" * 400 + revcomp[4:]))
    paths = []
    for name, fasta in genomes:
        (path := tmp_path / f"{name}.fasta").write_bytes(fasta)
        paths.append(path)
    reset_metrics()
    assemblies, best, weighted = Serotyper(db, device="cuda").screen(paths)
    counts = snapshot()
    assert counts.get("scan.cuda.rowcompact") == 1 and "scan.plain.rowcompact" not in counts
    assert counts.get("screen.overflow") == 1
    reset_metrics()
    _, best_cpu, weighted_cpu = Serotyper(db, device="cpu").screen(paths)
    assert snapshot().get("screen.overflow") == 1
    np.testing.assert_array_equal(best, best_cpu)
    np.testing.assert_allclose(weighted, weighted_cpu, rtol=1e-6)
    assert [db.loci.ids[b] for b in best[:2]] == TRUTH[:2]
    codes = torch.from_numpy(encode_assemblies_to_batch(assemblies))
    tables = ScreenTables.build(db, GeneIndex.build(db.genes))
    best_card, _, tallies_card = locus_screen_batch(codes.to(scan_device), tables, len(db.genes))
    best_plain, _, tallies_cpu = locus_screen_batch(codes, tables, len(db.genes))
    assert torch.equal(tallies_card.cpu(), tallies_cpu)
    assert torch.equal(best_card.cpu(), best_plain)


def test_cli_on_card_equals_in_process_rows(scan_device, tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path

    import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
    from typing_panel import make_typing_panel

    from kaptive_tpu.serotyping.io import KaptiveRow
    from kaptive_tpu_torch.serotyping import Serotyper

    db, genomes = make_typing_panel(tmp_path)
    paths = []
    for name, fasta in genomes:
        (path := tmp_path / f"{name}.fasta").write_bytes(fasta)
        paths.append(str(path))
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    want = KaptiveRow.header() + b"".join(bytes(KaptiveRow.from_result(r))
                                          for r in Serotyper(db, device="cuda").batch(paths))
    for mode in ("host", "device"):
        out = tmp_path / f"{mode}.tsv"
        proc = subprocess.run(
            [sys.executable, "-m", "kaptive_tpu_torch.cli", "type", str(tmp_path / "TestDB.gbk"), *paths,
             "-o", str(out), "--device", "cuda", "--seed-mode", mode, "--batch-size", "2",
             *(["--precompile"] if mode == "device" else [])],
            cwd=tmp_path, env=env, capture_output=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
        assert out.read_bytes() == want, mode
