r"""Trainer for BGC architectural models: archetype clustering + transition learning.

Capability parity with ``kaptive/bgc/trainer.py:35-166``
(same smoothing weights and structural constraints, so trained models decode
identically), restructured around vectorised transition counting
(``np.add.at`` over state bigrams instead of a per-gene Python walk), a
data-table of smoothing boosts, and a built-in mini-batch k-means fallback so
training works without the optional sklearn dependency.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from kaptive_tpu_torch.bgc.kernels import vectorize_orfs
from kaptive_tpu_torch.bgc.models import ArchitecturalModel
from kaptive_tpu_torch.compare import LocusData
from kaptive_tpu_torch.core.kmers import RandstrobeIndex
from kaptive_tpu_torch.core.seq import Sequences


def _featurize(seqs: Sequences, dim: int) -> np.ndarray:
    r"""Randstrobe bag-of-hashes feature matrix, one row per sequence."""
    strobes = RandstrobeIndex.build(seqs, sort_by_hash=False)
    return vectorize_orfs(strobes.records["hash"], strobes.records["seq_idx"], len(seqs), dim)


def _minibatch_kmeans(x: np.ndarray, k: int, seed: int = 42, iters: int = 50, batch: int = 256):
    r"""Dependency-free mini-batch k-means fallback (k-means++ init)."""
    rng = np.random.default_rng(seed)
    n = len(x)
    # k-means++ initialisation
    centroids = np.empty((k, x.shape[1]), dtype=np.float64)
    centroids[0] = x[rng.integers(n)]
    d2 = np.sum((x - centroids[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        centroids[i] = x[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((x - centroids[i]) ** 2, axis=1))
    counts = np.ones(k)
    for _ in range(iters):
        sel = rng.integers(0, n, min(batch, n))
        xb = x[sel]
        dists = ((xb[:, None, :] - centroids[None, :, :]) ** 2).sum(axis=2)
        assign = np.argmin(dists, axis=1)
        for j, a in zip(sel, assign):
            counts[a] += 1
            centroids[a] += (x[j] - centroids[a]) / counts[a]
    dists = ((x[:, None, :] - centroids[None, :, :]) ** 2).sum(axis=2)
    return np.argmin(dists, axis=1), centroids


def _cluster(x: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    r"""(labels, centroids) via sklearn MiniBatchKMeans, or the built-in fallback."""
    try:
        from sklearn.cluster import MiniBatchKMeans
    except ImportError:
        return _minibatch_kmeans(x, k)
    km = MiniBatchKMeans(n_clusters=k, random_state=42, n_init="auto")
    return km.fit_predict(x), km.cluster_centers_


class ArchitecturalTrainer:
    r"""Learns archetype centroids and state transitions from known BGC loci.

    State layout: ``PRE=0``, archetypes ``1..K``, ``NOVEL=K+1``, absorbing
    ``POST=K+2`` (ref ``bgc/trainer.py:95-124``).
    """

    def __init__(self, num_archetypes: int = 25, feature_dim: int = 1024,
                 partial_edge_tolerance: float = 5.0) -> None:
        self.num_archetypes = num_archetypes
        self.feature_dim = feature_dim
        self.partial_edge_tolerance = partial_edge_tolerance

    def _count_transitions(
        self, loci: Sequence[LocusData], gene_states: np.ndarray
    ) -> np.ndarray:
        r"""Accumulate PRE -> genes -> POST bigram counts for every locus."""
        k = self.num_archetypes
        pre, post = 0, k + 2
        counts = np.zeros((k + 3, k + 3), dtype=np.float32)
        done = 0
        for locus in loci:
            n = len(locus.proteins)
            if n == 0:
                continue
            walk = np.empty(n + 2, dtype=np.int64)
            walk[0], walk[1:-1], walk[-1] = pre, gene_states[done : done + n], post
            np.add.at(counts, (walk[:-1], walk[1:]), 1.0)
            done += n
        return counts

    def _smooth(self, counts: np.ndarray) -> np.ndarray:
        r"""Laplace smoothing plus the structural boosts of the reference
        parameterisation (self-loops, NOVEL coupling, contig-edge entry/exit)."""
        k = self.num_archetypes
        pre, novel, post = 0, k + 1, k + 2
        genes = slice(1, novel)
        boosts: tuple[tuple[tuple, float], ...] = (
            ((pre, pre), 100.0),
            ((post, post), 100.0),
            ((genes, novel), 5.0),
            ((novel, genes), 5.0),
            ((novel, novel), 10.0),
            ((pre, genes), self.partial_edge_tolerance),
            ((genes, post), self.partial_edge_tolerance),
        )
        smoothed = counts + 0.1
        for where, weight in boosts:
            smoothed[where] += weight
        return smoothed

    def train(
        self,
        loci: Sequence[LocusData],
        background_proteins: Sequences | None = None,
    ) -> ArchitecturalModel:
        core = _featurize(Sequences.concat([locus.proteins for locus in loci]), self.feature_dim)
        if background_proteins is not None and len(background_proteins) > 0:
            bg_centroid = _featurize(background_proteins, self.feature_dim).mean(axis=0)
        else:
            bg_centroid = np.zeros(self.feature_dim, dtype=np.float32)

        labels, centroids = _cluster(core, self.num_archetypes)

        counts = self._count_transitions(loci, labels + 1)  # state 0 is PRE
        smoothed = self._smooth(counts)
        log_probs = np.log(smoothed / smoothed.sum(axis=1, keepdims=True))
        # POST absorbs: no way out once the cluster has ended.
        post = self.num_archetypes + 2
        log_probs[post, :], log_probs[post, post] = -np.inf, 0.0

        as_f32 = lambda arr: np.ascontiguousarray(arr.astype(np.float32))  # noqa: E731
        return ArchitecturalModel(
            centroids=as_f32(centroids),
            bg_centroid=as_f32(bg_centroid),
            transitions=as_f32(log_probs),
        )
