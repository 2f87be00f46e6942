r"""``correct`` comes out false for the control and for every fault the cells can have.

The control is the program's output with each hit's protein identity taken
from the nucleotide alignment instead (the protein DP left out).  The
faults are planted under the timed path, in this process, while the rest of
a run (everything but the look for a card) goes as ``run.py`` drives it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

from kbench.harness import run_cell
from reference.judge import judge

SEED = 2**31 + 77


def test_the_control_fails_and_the_program_passes(tiny_root):
    out = run_cell(tiny_root, "tiny.single", SEED, 6.0, False, "cpu", time.perf_counter())
    assert out.line["correct"]
    control = judge(out.checked, out.genes, out.id_threshold, "cpu", control=True)
    assert control.counts["pident_off"] > 0


def _state_unchanged(monkeypatch):
    r"""The mapping step returns no alignments: the state it should build is left as it came."""
    from kaptive_tpu_torch.serotyping import core

    def map_batch(self, genomes, indexes=None):
        assemblies, alns = _real_map(self, genomes, indexes)
        return assemblies, [a[np.zeros(len(a), dtype=bool)] for a in alns]

    _real_map = core.Serotyper.map_batch
    monkeypatch.setattr(core.Serotyper, "map_batch", map_batch)


def _half_batch(monkeypatch):
    r"""Half of a batch is typed; its results stand in for the other half."""
    from kaptive_tpu_torch.serotyping import core

    real = core.Serotyper.finish_batch

    def finish_batch(self, assemblies, alns_list):
        half = max(1, len(assemblies) // 2)
        done = real(self, assemblies[:half], alns_list[:half])
        return [done[i % half] for i in range(len(assemblies))]

    monkeypatch.setattr(core.Serotyper, "finish_batch", finish_batch)


def _answer_altered(monkeypatch):
    r"""One match fewer in one pair of every protein DP sweep, where the DP produces it: the pair
    with the most matches, a planted gene's (the first pair may be a hit the result drops)."""
    from kaptive_tpu_torch.core import pairwise

    real = pairwise.PairwiseAligner.__call__

    def call(self, *args, **kw):
        res = real(self, *args, **kw)
        if len(res) == 0:
            return res
        matches = res.matches.copy()
        i = int(np.argmax(matches))
        matches[i] = max(matches[i] - 1, 0)
        return dataclasses.replace(res, matches=matches)

    monkeypatch.setattr(pairwise.PairwiseAligner, "__call__", call)


@pytest.mark.parametrize(
    "fault, cell",
    [(_state_unchanged, "tiny.single"), (_half_batch, "tiny.stream"), (_answer_altered, "tiny.single")],
    ids=["state_unchanged", "half_batch", "answer_altered"],
)
def test_every_fault_makes_correct_false(tiny_root, monkeypatch, fault, cell):
    fault(monkeypatch)
    # Long enough on the CPU for the stream's second batch, the first of four assemblies.
    out = run_cell(tiny_root, cell, SEED, 16.0, False, "cpu", time.perf_counter())
    assert not out.line["correct"], out.line["checks"]
