r"""BGC locus prediction: Viterbi decoding of architectural states per contig, on the card.

The port of ``kaptive_tpu/bgc/predictor.py`` (capability parity with
``kaptive/bgc/predictor.py``: the ``BGCPredictions`` container :32-128 and
``ArchitecturalPredictor`` :131-241), in this repo's flat-ragged SoA idiom:
predicted loci live in one flat member table (ORF index / decoded state /
protein per member row) with per-locus offsets, instead of the reference's
per-locus list-of-arrays.  Smoothing, emissions and the Viterbi decode run
on the predictor's device; every contig of an annotated genome is decoded in
one launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import numpy.typing as npt
import torch

from kaptive_tpu_torch.bgc.annotate import AnnotationResult
from kaptive_tpu_torch.bgc.kernels import (
    archetype_emissions,
    architectural_viterbi_batch,
    contextualize_features,
    vectorize_orfs,
)
from kaptive_tpu_torch.bgc.models import ArchitecturalModel
from kaptive_tpu_torch.core.collections import as_bytes_array, cumulative_offsets
from kaptive_tpu_torch.core.kmers import RandstrobeIndex
from kaptive_tpu_torch.core.seq import Sequences
from kaptive_tpu_torch.utils.device import resolve_device


@dataclass(slots=True, frozen=True)
class BGCPredictions:
    r"""Predicted BGC loci in flat-ragged layout.

    One logical row per predicted locus (``contig_names``/``scores``); the
    member ORFs of all loci share three flat arrays (``member_orfs``,
    ``member_states``, ``member_proteins``) addressed through
    ``offsets``/``lengths``.  Scalar indexing yields the same 5-tuple view the
    reference exposes, so downstream consumers are layout-agnostic.
    """

    contig_names: npt.NDArray[np.bytes_]
    scores: npt.NDArray[np.float32]
    offsets: npt.NDArray[np.int32]
    lengths: npt.NDArray[np.int32]
    member_orfs: npt.NDArray[np.uint32]
    member_states: npt.NDArray[np.int32]
    member_proteins: Sequences

    def __len__(self) -> int:
        return len(self.scores)

    def _span(self, row: int) -> slice:
        lo = int(self.offsets[row])
        return slice(lo, lo + int(self.lengths[row]))

    def __getitem__(self, item: Any) -> Any:
        if isinstance(item, (int, np.integer)):
            row = int(item) + (len(self) if item < 0 else 0)
            if not 0 <= row < len(self):
                raise IndexError("locus row out of range")
            span = self._span(row)
            return (
                self.contig_names[row].decode(),
                float(self.scores[row]),
                self.member_orfs[span],
                self.member_states[span],
                self.member_proteins[span],
            )
        rows = np.arange(len(self))[item]
        take = np.concatenate(
            [np.arange(self._span(r).start, self._span(r).stop) for r in rows]
        ) if len(rows) else np.empty(0, dtype=np.int64)
        kept_lengths = self.lengths[rows]
        return BGCPredictions(
            contig_names=self.contig_names[rows],
            scores=self.scores[rows],
            offsets=cumulative_offsets(kept_lengths),
            lengths=kept_lengths,
            member_orfs=self.member_orfs[take],
            member_states=self.member_states[take],
            member_proteins=self.member_proteins[take]
            if len(take)
            else Sequences.empty(),
        )

    @classmethod
    def empty(cls) -> "BGCPredictions":
        return cls(
            contig_names=np.empty(0, dtype="S1"),
            scores=np.empty(0, dtype=np.float32),
            offsets=np.empty(0, dtype=np.int32),
            lengths=np.empty(0, dtype=np.int32),
            member_orfs=np.empty(0, dtype=np.uint32),
            member_states=np.empty(0, dtype=np.int32),
            member_proteins=Sequences.empty(),
        )

    @classmethod
    def concat(cls, batches) -> "BGCPredictions":
        batches = [b for b in batches]
        if not batches:
            return cls.empty()
        lengths = np.concatenate([b.lengths for b in batches])
        return cls(
            contig_names=np.concatenate(
                [as_bytes_array(b.contig_names) for b in batches]
            ),
            scores=np.concatenate([b.scores for b in batches]),
            offsets=cumulative_offsets(lengths),
            lengths=lengths,
            member_orfs=np.concatenate([b.member_orfs for b in batches]),
            member_states=np.concatenate([b.member_states for b in batches]),
            member_proteins=Sequences.concat([b.member_proteins for b in batches]),
        )


class _LocusSink:
    r"""Accumulates per-contig decode results into the flat-ragged arrays."""

    def __init__(self) -> None:
        self.names: list[bytes] = []
        self.scores: list[float] = []
        self.orf_runs: list[npt.NDArray[np.uint32]] = []
        self.state_runs: list[npt.NDArray[np.int32]] = []
        self.protein_runs: list[Sequences] = []

    def add(
        self,
        contig: str,
        score: float,
        orfs: npt.NDArray[np.integer],
        states: npt.NDArray[np.int32],
        proteins: Sequences,
    ) -> None:
        self.names.append(contig.encode())
        self.scores.append(score)
        self.orf_runs.append(orfs.astype(np.uint32))
        self.state_runs.append(states)
        self.protein_runs.append(proteins)

    def finish(self) -> BGCPredictions:
        if not self.names:
            return BGCPredictions.empty()
        lengths = np.array([len(r) for r in self.orf_runs], dtype=np.int32)
        return BGCPredictions(
            contig_names=np.array(self.names, dtype=np.bytes_),
            scores=np.array(self.scores, dtype=np.float32),
            offsets=cumulative_offsets(lengths),
            lengths=lengths,
            member_orfs=np.concatenate(self.orf_runs),
            member_states=np.concatenate(self.state_runs),
            member_proteins=Sequences.concat(self.protein_runs),
        )


class ArchitecturalPredictor:
    r"""Decodes BGC architectural state paths over ORF randstrobe features on ``device``.

    Pipeline per contig (ref ``bgc/predictor.py:167-200``): randstrobe
    featurisation -> window smoothing -> centroid emissions (+ novelty state)
    -> contig-edge neutralisation -> max-plus Viterbi.  ``device`` defaults to
    ``"cuda"`` and raises when no card is present; the CPU is used only when
    asked for.
    """

    def __init__(
        self,
        model: ArchitecturalModel,
        window_size: int = 1,
        novelty_score: float = -1.0,
        *,
        device: str | torch.device = "cuda",
    ) -> None:
        self.model = model
        self.window_size = window_size
        self.novelty_score = novelty_score
        self.dim = model.centroids.shape[1]
        self.num_states = model.transitions.shape[0]
        self.device = resolve_device(device)
        self._centroids = torch.from_numpy(model.centroids).to(self.device)
        self._bg_centroid = torch.from_numpy(model.bg_centroid).to(self.device)

    def _orf_emissions(self, proteins: Sequences) -> torch.Tensor | None:
        r"""Emission matrix (orfs x states) on the device, or None when nothing featurises."""
        strobes = RandstrobeIndex.build(proteins, sort_by_hash=False)
        if len(strobes) == 0:
            return None
        feats = vectorize_orfs(
            strobes.records["hash"], strobes.records["seq_idx"], len(proteins), self.dim
        )
        smoothed = contextualize_features(torch.from_numpy(feats).to(self.device), self.window_size)
        em = archetype_emissions(smoothed, self._centroids, self._bg_centroid, self.novelty_score)
        # First/last genes on a contig may be truncated at the assembly edge:
        # give them flat emissions so the decode is driven by their neighbours
        # (ref :194-197).
        em[[0, -1], :] = 0.0
        return em

    def _decode(self, streams: list[Sequences]) -> list[tuple[npt.NDArray[np.int32], float]]:
        r"""Viterbi state path + log-score of each contig's ORF stream, all in one launch."""
        out: list = [(np.zeros(0, dtype=np.int32), float("-inf"))] * len(streams)
        ems, rows = [], []
        for i, proteins in enumerate(streams):
            if len(proteins) == 0:
                continue
            em = self._orf_emissions(proteins)
            if em is None:
                out[i] = (np.zeros(len(proteins), dtype=np.int32), float("-inf"))
                continue
            ems.append(em)
            rows.append(i)
        for i, decoded in zip(rows, architectural_viterbi_batch(ems, self.model.transitions, device=self.device)):
            out[i] = decoded
        return out

    def predict_contig(self, proteins: Sequences) -> tuple[npt.NDArray[np.int32], float]:
        r"""Viterbi state path + log-score for one contig's ORF stream."""
        return self._decode([proteins])[0]

    def predict(self, annotation: AnnotationResult) -> BGCPredictions:
        r"""Decode every contig of an annotated genome; keep contigs whose path
        visits any interior (BGC) state."""
        sink = _LocusSink()
        genes = annotation.genes
        contigs = []
        for c_idx, c_name in enumerate(annotation.contig_names):
            on_contig = np.flatnonzero(genes.contig_indices == c_idx)
            if on_contig.size:
                contigs.append((c_name, genes.translations[on_contig]))
        for (c_name, proteins), (path, score) in zip(contigs, self._decode([p for _, p in contigs])):
            if not np.isfinite(score):
                continue
            inside = np.flatnonzero((path > 0) & (path + 1 < self.num_states))
            if inside.size:
                sink.add(c_name, score, inside, path[inside], proteins[inside])
        return sink.finish()
