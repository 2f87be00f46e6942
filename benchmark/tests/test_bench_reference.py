r"""The plain reference: its dynamic programs against brute force, and its verdict on the port at a tiny size."""

from __future__ import annotations

import time

import numpy as np
import pytest

from kbench.harness import run_cell
from reference.align import BLOSUM62, NT_GAP, NT_MATRIX, PROTEIN_GAP, affine_scores, gapless_optima, translate

NEG = -(10**9)


def _brute(q, t, m, go, ge, local):
    n, k = len(q), len(t)
    H = np.full((n + 1, k + 1), NEG)
    E = np.full((n + 1, k + 1), NEG)
    F = np.full((n + 1, k + 1), NEG)
    H[0, 0] = 0
    for j in range(1, k + 1):
        H[0, j] = 0 if local else -(go + ge * j)
    for i in range(1, n + 1):
        H[i, 0] = 0 if local else -(go + ge * i)
        for j in range(1, k + 1):
            E[i, j] = max(H[i, j - 1] - go - ge, E[i, j - 1] - ge)
            F[i, j] = max(H[i - 1, j] - go - ge, F[i - 1, j] - ge)
            H[i, j] = max(H[i - 1, j - 1] + m[q[i - 1], t[j - 1]], E[i, j], F[i, j], 0 if local else NEG)
    return H.max() if local else H[n, k]


def _brute_gapless(q, t, m):
    best, idents = 0, set()
    for d in range(-len(q), len(t) + 1):
        cells = [(i, i + d) for i in range(len(q)) if 0 <= i + d < len(t)]
        for a in range(len(cells)):
            for b in range(a, len(cells)):
                seg = cells[a : b + 1]
                score = sum(m[q[i], t[j]] for i, j in seg)
                ident = float(np.float32(sum(q[i] == t[j] for i, j in seg) * 100.0 / len(seg)))
                if score > best:
                    best, idents = score, {ident}
                elif score == best and score > 0:
                    idents.add(ident)
    return best, idents


@pytest.mark.parametrize("trial", range(30))
def test_dynamic_programs_equal_brute_force(trial):
    rng = np.random.default_rng(trial)
    n, k = int(rng.integers(1, 11)), int(rng.integers(1, 11))
    q, t = rng.integers(0, 4, n), rng.integers(0, 4, k)
    for local in (True, False):
        assert affine_scores([q], [t], NT_MATRIX, NT_GAP, local, "cpu")[0] == _brute(q, t, NT_MATRIX, *NT_GAP, local)
    qp, tp = rng.integers(0, 20, n), rng.integers(0, 20, k)
    assert affine_scores([qp], [tp], BLOSUM62, PROTEIN_GAP, True, "cpu")[0] == _brute(qp, tp, BLOSUM62, *PROTEIN_GAP, True)
    top, idents = gapless_optima(qp, tp, BLOSUM62)
    want_top, want = _brute_gapless(qp, tp, BLOSUM62)
    assert top == want_top and (idents == want or top <= 0)


def test_translation_is_the_standard_code():
    assert translate(np.array([0, 3, 2, 3, 2, 2, 3, 0, 0]), to_stop=False) == b"MW*"
    assert translate(np.array([0, 3, 2, 3, 2, 2, 3, 0, 0, 1]), to_stop=True) == b"MW"


@pytest.mark.parametrize("cell", ["tiny.single", "tiny.stream"])
def test_the_reference_agrees_with_the_port_on_the_cpu(tiny_root, cell):
    out = run_cell(tiny_root, cell, 2**31 + 101, 6.0, False, "cpu", time.perf_counter())
    assert out.line["correct"], out.notes
    assert out.checked and all(v == 0 for v, _ in out.checks.values())
    assert list(out.line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_a_traced_run_reads_the_phases(tiny_root):
    # Long enough on the CPU for the stretch (half the window, from a quarter of the way in) to hold requests.
    out = run_cell(tiny_root, "tiny.single", 17, 16.0, True, "cpu", time.perf_counter())
    assert out.line["correct"]
    metrics = out.line["metrics"]
    assert {"map.map_ms.single", "dp.dp_ms.single", "decide.decide_ms.single"} <= set(metrics)
    assert "device.idle_pct.single" not in metrics  # nothing ran on a device: the reader finds nothing
    assert out.line["device"]["window_s"] > 0
