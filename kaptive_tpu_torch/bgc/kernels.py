r"""BGC featurisation, smoothing, emissions and Viterbi decoding on the card.

The port of ``kaptive_tpu/bgc/kernels.py``: the L2-normalised
bag-of-strobemer histogram (numpy, as there), the sliding-window mean over
adjacent ORFs as a prefix sum, the archetype emissions as one float32
``(N, D) x (D, K)`` matrix product with TF32 switched off (the JAX package
leaves this product to XLA, outside any kernel), and the max-plus Viterbi
with a forced end in POST: the hand-written Hopper kernel
(:func:`kaptive_tpu_torch.ops.viterbi.arch_viterbi`) for every contig with an
ORF; a contig without one has no rows to decode and is answered on the host.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from kaptive_tpu_torch.ops.viterbi import arch_viterbi
from kaptive_tpu_torch.utils.device import resolve_device


def compute_record_offsets(seq_indices: np.ndarray, num_seqs: int) -> np.ndarray:
    r"""Per-sequence start offsets into (seq-ordered) strobemer records (ref kmers :1158-1184)."""
    return np.searchsorted(seq_indices, np.arange(num_seqs + 1)).astype(np.int64)


def vectorize_orfs(
    hashes: np.ndarray, seq_indices: np.ndarray, num_seqs: int, feature_dim: int
) -> np.ndarray:
    r"""L2-normalised bag-of-strobemer feature matrix (N, D) via scatter-add."""
    if num_seqs == 0:
        return np.zeros((0, feature_dim), dtype=np.float32)
    rows = np.asarray(seq_indices, dtype=np.int64)
    cols = (np.asarray(hashes, dtype=np.uint64) % np.uint64(feature_dim)).astype(np.int64)
    feats = np.zeros((num_seqs, feature_dim), dtype=np.float32)
    np.add.at(feats, (rows, cols), 1.0)
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    return np.divide(feats, norms, out=feats, where=norms > 0)


def contextualize_features(features: torch.Tensor, window_size: int) -> torch.Tensor:
    r"""Sliding-window mean over adjacent ORFs via prefix sums."""
    n, d = features.shape
    cs = torch.cat([features.new_zeros((1, d)), torch.cumsum(features, dim=0)])
    idx = torch.arange(n, device=features.device)
    lo = (idx - window_size).clamp(min=0)
    hi = (idx + window_size + 1).clamp(max=n)
    return (cs[hi] - cs[lo]) / (hi - lo)[:, None].to(features.dtype)


@contextmanager
def _full_float32():
    r"""float32 matrix products in full float32 on the card (TF32 off) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def archetype_emissions(
    features: torch.Tensor, centroids: torch.Tensor, bg_centroid: torch.Tensor, novelty_score: float
) -> torch.Tensor:
    r"""Log-emissions (N, K+3): background, K archetypes, NOVEL, POST — distance expansion."""
    n = features.shape[0]
    # -||x - c||^2 = -(|x|^2 - 2 x.c + |c|^2)
    x2 = torch.sum(features * features, dim=1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=1)[None, :]
    with _full_float32():
        xc = torch.matmul(features, centroids.T)
    arche = -(x2 - 2.0 * xc + c2)
    bg = -torch.sum((features - bg_centroid[None, :]) ** 2, dim=1)
    emissions = torch.cat(
        [
            bg[:, None],  # PRE
            arche,  # archetypes 1..K
            torch.full((n, 1), novelty_score, dtype=torch.float32, device=features.device),  # NOVEL
            bg[:, None],  # POST
        ],
        dim=1,
    )
    return emissions.to(torch.float32)


def architectural_viterbi(emissions, transitions, *, device: str | torch.device = "cuda"):
    r"""Max-plus Viterbi over one contig's (N, S) ORF emission rows, forced to end in POST.

    Returns ``(path int32 (N,), max log-probability float32 scalar)`` as tensors
    on ``device``: one launch of ``arch_viterbi_kernel<R>`` on a card
    (:func:`kaptive_tpu_torch.ops.viterbi.arch_viterbi`), the plain form on
    the CPU.  ``emissions`` and ``transitions`` are numpy arrays or tensors;
    the matrix needs a row.
    """
    dev = resolve_device(device)
    em = torch.as_tensor(emissions).to(dev, torch.float32).contiguous()
    if em.dim() != 2 or em.shape[0] == 0:
        raise ValueError(f"architectural_viterbi: expected (N >= 1, S) emissions, got {tuple(em.shape)}")
    trans = torch.as_tensor(transitions).to(dev, torch.float32).contiguous()
    bounds = torch.tensor([0, em.shape[0]], dtype=torch.int64, device=dev)
    path, scores = arch_viterbi(em, trans, bounds)
    return path, scores[0]


def architectural_viterbi_batch(
    emissions: list, transitions: np.ndarray, *, device: str | torch.device = "cuda",
) -> list[tuple[np.ndarray, float]]:
    r"""Max-plus Viterbi of each (N, S) emission matrix (numpy or tensors),
    forced to end in POST: ``[(path int32 (N,), max log-probability)]``.

    Matrices with a row are decoded in one launch on ``device`` (one row is
    the first transition plus the emission, ending in POST); an empty matrix
    has no rows to launch on and is answered on the host.
    """
    dev = resolve_device(device)
    trans = np.ascontiguousarray(transitions, dtype=np.float32)
    out: list = [None] * len(emissions)
    batch = []
    for i, em in enumerate(emissions):
        if em.shape[0] == 0:
            out[i] = (np.zeros(0, dtype=np.int32), float("-inf"))
        else:
            batch.append(i)
    if batch:
        ems = [emissions[i] if isinstance(emissions[i], torch.Tensor) else torch.from_numpy(emissions[i])
               for i in batch]
        bounds = torch.from_numpy(np.cumsum([0] + [len(e) for e in ems]))
        paths, scores = arch_viterbi(
            torch.cat([e.to(dev, torch.float32) for e in ems]).contiguous(),
            torch.from_numpy(trans).to(dev), bounds.to(dev),
        )
        paths, scores = paths.cpu().numpy(), scores.cpu().numpy()
        for i, lo, hi, score in zip(batch, bounds[:-1].tolist(), bounds[1:].tolist(), scores):
            out[i] = (paths[lo:hi], float(score))
    return out


def architectural_viterbi_host(
    emissions, transitions: np.ndarray, *, device: str | torch.device = "cuda",
) -> tuple[np.ndarray, float]:
    r"""One emission matrix's Viterbi path and score (:func:`architectural_viterbi_batch` of one)."""
    return architectural_viterbi_batch([emissions], transitions, device=device)[0]
