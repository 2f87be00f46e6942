r"""Frameshift-tolerant gene-finding HMM (FragGeneScan-class), decoded on the card.

The port of ``kaptive_tpu/bgc/genefinder.py``: a 7-state codon-phase HMM
whose insertion and deletion states keep a gene intact across
sequencing-error frameshifts, with codon-usage emissions estimated from the
reference database's own genes.

States (per strand): ``N`` (noncoding), ``C0/C1/C2`` (codon phase), and
``I0/I1/I2`` (inserted base after phase p).  Indel tolerance comes from

- insertions: ``Cp -> Ip`` (open), ``Ip -> Ip`` (extend), ``Ip -> C(p+1)``
  (resume) — an extra genomic base inside a codon;
- deletions: ``Cp -> C(p+2)%3`` — a lost genomic base, phase advances two in
  one step.

Emissions: completing a codon (entering ``C2``) scores the codon's log-odds
(coding codon-usage vs uniform background); in-frame stop codons are
forbidden inside a gene (−∞), so genes are maximal stop-free codon runs —
the probabilistic generalisation of ORF calling.  Gene entry earns a bonus on
a table-11 start codon and gene exit on a following in-frame stop, but both
remain *possible* without one so genes running off contig edges are still
called (FragGeneScan behaviour).

A strand's work has three halves: the emission arrays on the host
(:func:`_strand_inputs`), the Viterbi decode (:func:`_decode`: every strand of
a batch in one launch of :func:`kaptive_tpu_torch.ops.viterbi.gene_viterbi`,
the hand-written Hopper kernel on a card, the plain PyTorch form on the CPU),
and segment extraction, start-codon refinement and frame-corrected
translation (inserted bases dropped, deleted bases restored as ``N``/``X``)
on the host (:func:`_strand_runs`).  The states equal the JAX package's
exactly.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from kaptive_tpu_torch.bgc.orf import Orf
from kaptive_tpu_torch.core.seq import BacterialTranslationTable
from kaptive_tpu_torch.ops import minimizer
from kaptive_tpu_torch.ops.viterbi import gene_viterbi
from kaptive_tpu_torch.utils.device import resolve_device

BIG = 1.0e9

# State indices.
N, C0, C1, C2, I0, I1, I2 = range(7)

# Codon ids (c0*16 + c1*4 + c2 over A=0 C=1 G=2 T=3).
STOP_IDS = (48, 50, 56)  # TAA TAG TGA
# NCBI table 11 start codons: TTG CTG ATT ATC ATA ATG GTG.
TABLE11_START_IDS = (62, 30, 15, 13, 12, 14, 46)

_DNA_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _DNA_LUT[_c] = _i
    _DNA_LUT[_c + 32] = _i

_NT = np.frombuffer(b"ACGTN", dtype=np.uint8)


@dataclass(frozen=True, slots=True)
class GeneHmmParams:
    r"""Log-space HMM parameters (natural log)."""

    codon_logodds: np.ndarray  # (64,) coding codon log-odds vs background
    entry: float = -9.0  # N -> C0 at a non-start codon (edge/partial genes)
    start_bonus: float = 3.0  # added to entry on a table-11 start codon
    exit_stop: float = -2.0  # C2 -> N right before an in-frame stop codon
    exit_other: float = -15.0  # C2 -> N anywhere else (rare, e.g. truncations)
    indel: float = -8.0  # insertion open / deletion transition
    ins_extend: float = -1.0  # insertion extension
    coding_bonus: float = 0.25  # per-codon reward, folded into the codon emission
    # What makes the decode robust is the CONTENT term, exactly as in
    # FragGeneScan: with emissions learned from real (codon-biased) genes
    # (:meth:`from_sequences`), wrong-frame and intergenic codons score
    # negative per codon, so (a) after a sequencing-error indel the in-frame
    # continuation outscores exiting at the first wrong-frame stop by tens of
    # logits — the gene stays ONE call — and (b) merging across a spacer
    # bleeds score and never pays.  With :meth:`uniform` emissions (no codon
    # bias, e.g. random synthetic genes) the transition costs alone leave only
    # ~1-logit margins and behaviour degrades toward a plain ORF caller —
    # which is the information-theoretic limit: frames of random-codon genes
    # are statistically indistinguishable, for FragGeneScan too.

    @classmethod
    def from_sequences(cls, dna_seqs, **kw) -> "GeneHmmParams":
        r"""Estimate codon usage from a ragged DNA :class:`Sequences` batch
        (e.g. ``db.genes``) — the database's own genes are the best available
        model of the coding statistics the annotator will meet.

        The indel cost auto-adapts to the measured bias strength (unless
        given explicitly): with strong codon bias wrong-frame content scores
        negative, so a cheap indel (-8) safely buys frameshift tolerance;
        with weak/no bias (e.g. random synthetic genes) frames are
        statistically indistinguishable and a cheap indel would let the
        decode cross stop codons and swallow neighbouring genes — the indel
        is priced out (-12) and the HMM degrades gracefully toward a plain
        ORF caller, exactly the information-theoretic limit FragGeneScan
        shares."""
        counts = np.ones(64, dtype=np.float64)  # Laplace
        seqs, offsets, lengths = dna_seqs.seqs, dna_seqs.offsets, dna_seqs.lengths
        for i in range(len(offsets)):
            codes = _DNA_LUT[seqs[offsets[i] : offsets[i] + lengths[i]]]
            n_cod = len(codes) // 3
            if n_cod == 0:
                continue
            c = codes[: n_cod * 3].reshape(-1, 3).astype(np.int64)
            ok = (c < 4).all(axis=1)
            ids = c[ok, 0] * 16 + c[ok, 1] * 4 + c[ok, 2]
            counts += np.bincount(ids, minlength=64)
        freqs = counts / counts.sum()
        logodds = np.log(freqs * 64.0).astype(np.float32)
        logodds[list(STOP_IDS)] = -BIG  # stops cannot occur inside a gene
        nonstop = logodds[logodds > -1e8]
        bias_strength = -float(nonstop.mean())  # ~0 uniform, >0.5 real genomes
        if "indel" not in kw:
            kw["indel"] = -8.0 if bias_strength >= 0.4 else -12.0
        return cls(codon_logodds=logodds, **kw)

    @classmethod
    def uniform(cls, **kw) -> "GeneHmmParams":
        r"""No codon-usage preference: genes are scored purely by stop-free
        run length (the HMM generalisation of a plain ORF scan).  Without a
        content signal the indel states are priced high (see
        :meth:`from_sequences`)."""
        logodds = np.zeros(64, dtype=np.float32)
        logodds[list(STOP_IDS)] = -BIG
        kw.setdefault("indel", -12.0)
        return cls(codon_logodds=logodds, **kw)


class _Strand(NamedTuple):
    r"""One strand before its decode: its codes, in-frame stop marks and the
    three float32 decode inputs, padded to the bucket length."""

    codes: np.ndarray
    is_stop: np.ndarray
    codemit: np.ndarray
    entry_b: np.ndarray
    exit_b: np.ndarray


def _strand_inputs(codes: np.ndarray, params: GeneHmmParams) -> _Strand | None:
    r"""The host half before the decode (None when the strand is shorter than a codon).

    ``codemit[i]`` is the emission collected on entering ``C2`` at position
    ``i`` (codon at ``[i-2, i+1)``, with the per-codon coding bonus folded
    in); ``entry_b[i]`` / ``exit_b[i]`` are the N->C0 / C2->N transition
    scores at position ``i`` (start/stop context folded in).
    """
    L = len(codes)
    if L < 3:
        return None
    c = codes.astype(np.int64)
    valid3 = np.zeros(L, dtype=bool)
    cod_id = np.zeros(L, dtype=np.int64)
    v = (c[:-2] < 4) & (c[1:-1] < 4) & (c[2:] < 4)
    valid3[: L - 2] = v
    cod_id[: L - 2] = np.where(v, c[:-2] * 16 + c[1:-1] * 4 + c[2:], 0)

    is_stop = valid3 & np.isin(cod_id, STOP_IDS)
    is_start = valid3 & np.isin(cod_id, TABLE11_START_IDS)
    lo = np.where(valid3, params.codon_logodds[cod_id] + params.coding_bonus, -BIG)

    # The padded length: what the JAX package pads to so that its jitted
    # decode compiles once per size class.  The pad is kept because it is
    # also part of the decode: it blocks NEW gene entry (entry = -BIG) but
    # lets an in-flight coding path continue for free (codon emission 0), so
    # every coding/indel state has a zero-cost continuation through the pad,
    # exactly as the unpadded decode lets a contig-end-truncated gene end in a
    # coding state at no charge.  (A -BIG pad emission would strand such
    # paths and silently drop genes running into the contig break.)
    Lp = minimizer.bucket_length(L, minimum=1 << 12)
    codemit = np.zeros(Lp, dtype=np.float32)
    codemit[: min(2, L)] = -BIG
    codemit[2:L] = lo[:-2]
    entry_b = np.full(Lp, -BIG, dtype=np.float32)
    entry_b[:L] = params.entry + params.start_bonus * is_start
    exit_b = np.full(Lp, params.exit_other, dtype=np.float32)
    exit_b[:L] = np.where(is_stop, params.exit_stop, params.exit_other)
    return _Strand(codes, is_stop, codemit, entry_b, exit_b)


def _decode(strands: list[_Strand], params: GeneHmmParams, device: torch.device) -> list[np.ndarray]:
    r"""The decode of every strand in one launch: each strand's (L,) int8 states."""
    if not strands:
        return []
    bounds = np.cumsum([0] + [len(s.codemit) for s in strands])

    def flat(field: str) -> torch.Tensor:
        return torch.from_numpy(np.concatenate([getattr(s, field) for s in strands])).to(device)

    states = gene_viterbi(
        flat("codemit"), flat("entry_b"), flat("exit_b"), torch.from_numpy(bounds).to(device),
        indel=params.indel, ins_extend=params.ins_extend,
    ).cpu().numpy()
    return [states[lo: lo + len(s.codes)] for lo, s in zip(bounds[:-1], strands)]


def _strand_runs(strand: _Strand, states: np.ndarray, min_codons: int) -> list[tuple[int, int, bytes]]:
    r"""The host half after the decode: (start, end, corrected translation) with
    coordinates on this strand's orientation.  ``end`` INCLUDES a directly
    following in-frame stop codon when present (the six-frame Orf
    convention); the translation never includes the stop."""
    codes, is_stop = strand.codes, strand.is_stop
    L = len(codes)
    coding = states != N
    if not coding.any():
        return []
    # Maximal coding runs (vectorised edge detection).
    d = np.diff(coding.astype(np.int8))
    run_starts = np.flatnonzero(d == 1) + 1
    run_ends = np.flatnonzero(d == -1) + 1
    if coding[0]:
        run_starts = np.concatenate(([0], run_starts))
    if coding[-1]:
        run_ends = np.concatenate((run_ends, [L]))
    in_codon = (states >= C0) & (states <= C2)

    genes = []
    for s, e in zip(run_starts.tolist(), run_ends.tolist()):
        pos = np.flatnonzero(in_codon[s:e])
        if len(pos) < 3 * min_codons:
            continue
        # Frame-corrected nucleotide stream: keep bases consumed in C states;
        # restore each deletion (phase skip C_p -> C_{(p+2)%3}) as one 'N'
        # placed before the base that follows it.  ``orig``: genomic position
        # of each corrected base (deleted placeholders borrow the following
        # base's position).
        phases = states[s + pos].astype(np.int64) - C0
        deleted = np.zeros(len(pos), dtype=bool)
        deleted[1:] = phases[1:] == (phases[:-1] + 2) % 3
        slots = np.arange(len(pos)) + np.cumsum(deleted)
        arr = np.empty(len(pos) + int(deleted.sum()), dtype=np.uint8)
        arr[slots] = codes[s + pos]
        arr[slots[deleted] - 1] = 4
        orig = np.repeat(s + pos, 1 + deleted)
        # Refine the gene start to the first table-11 start codon within the
        # leading 30 codons of the corrected frame (FragGeneScan-style start
        # refinement; partial/edge genes without one keep the raw boundary).
        trim = 0
        max_scan = min(30, len(arr) // 3 - min_codons)
        for k in range(max(max_scan, 0)):
            cstart = arr[3 * k : 3 * k + 3]
            if (cstart < 4).all() and (
                cstart[0] * 16 + cstart[1] * 4 + cstart[2]
            ) in TABLE11_START_IDS:
                trim = 3 * k
                break
        arr = arr[trim:]
        gene_start = int(orig[trim]) if trim < len(orig) else s + int(pos[0])
        n_cod = len(arr) // 3
        translation = bytes(BacterialTranslationTable.translate(_NT[arr[: n_cod * 3]]))
        end = s + int(pos[-1]) + 1
        # Include the terminating stop codon in the interval when present
        # (matching the six-frame Orf convention).
        if end + 3 <= L and is_stop[end] and (states[end] == N):
            end += 3
        genes.append((gene_start, end, translation))
    return genes


def _strand_genes(
    codes: np.ndarray, params: GeneHmmParams, min_codons: int, *, device: str | torch.device = "cuda",
) -> list[tuple[int, int, bytes]]:
    r"""Decode one strand; returns (start, end, corrected translation) with
    coordinates on this strand's orientation (see :func:`_strand_runs`)."""
    strand = _strand_inputs(codes, params)
    if strand is None:
        return []
    (states,) = _decode([strand], params, resolve_device(device))
    return _strand_runs(strand, states, min_codons)


def _both_strands(seq: bytes) -> tuple[np.ndarray, np.ndarray]:
    fwd = _DNA_LUT[np.frombuffer(seq, dtype=np.uint8)]
    rc = _DNA_LUT[np.frombuffer(seq.translate(BacterialTranslationTable._COMP)[::-1], dtype=np.uint8)]
    return fwd, rc


def find_genes_hmm_batch(
    seqs: list[bytes], params: GeneHmmParams | None = None, min_codons: int = 30,
    *, device: str | torch.device = "cuda", pool: ThreadPoolExecutor | None = None,
) -> list[list[Orf]]:
    r""":func:`find_genes_hmm` of every sequence, with both strands of all of
    them decoded in one launch.  The host halves before and after the decode
    run on ``pool`` when one is given; the output order does not depend on it."""
    params = params or GeneHmmParams.uniform()
    dev = resolve_device(device)
    run = pool.map if pool is not None else map
    called = [i for i, seq in enumerate(seqs) if len(seq) >= 3 * min_codons]
    strands = list(run(
        lambda codes: _strand_inputs(codes, params),
        [codes for i in called for codes in _both_strands(seqs[i])],
    ))
    live = [s for s in strands if s is not None]
    decoded = iter(_decode(live, params, dev))
    states = [next(decoded) if s is not None else None for s in strands]
    runs = list(run(
        lambda pair: _strand_runs(*pair, min_codons) if pair[0] is not None else [],
        list(zip(strands, states)),
    ))
    out: list[list[Orf]] = [[] for _ in seqs]
    for j, i in enumerate(called):
        n = len(seqs[i])
        orfs = [Orf(s, e, 1, t) for s, e, t in runs[2 * j]]
        orfs += [Orf(n - e, n - s, -1, t) for s, e, t in runs[2 * j + 1]]
        orfs.sort(key=lambda o: (o.start, o.end))
        out[i] = orfs
    return out


def find_genes_hmm(
    seq: bytes, params: GeneHmmParams | None = None, min_codons: int = 30,
    *, device: str | torch.device = "cuda",
) -> list[Orf]:
    r"""HMM gene calling on both strands on ``device``; forward-strand coordinates.

    Drop-in alternative to :func:`kaptive_tpu_torch.bgc.orf.find_orfs` that
    keeps genes intact across 1-2 bp indels.  Both strands are decoded in one
    launch.
    """
    return find_genes_hmm_batch([seq], params, min_codons, device=device)[0]
