r"""The comparison that decides ``correct``.

For every assembly the harness planted one locus, and where the mix says so
extra genes in its flanks, so it knows each planted gene: the ORF, where it
lies in which contig, on which strand, and where a contig break cuts it.
The program's result and report row are judged gene by gene against what
this module works out again from those generated inputs alone:

- ``missing_genes``: a planted gene that lies whole in one contig and has no
  hit of its id on that contig and strand over it;
- ``ext_short``: a planted gene's hit whose extent scores below the best
  local alignment of the gene against its planted place (nucleotide
  scoring 2 / -4, gaps 4 + 2 a base).  The hit's extent is scored by the
  best global alignment of the gene's aligned part against the contig's
  aligned part, so any optimal extent the program picks among ties scores
  exactly the best.  A hit of another locus's gene is optimal only within
  the band of the chain the program seeded, which the result does not
  hold (a chance seed of a diverged copy off its main diagonal gives a
  short hit where the main diagonal scores more), so its extent is not
  judged;
- ``pident_off``: a hit's protein identity that no optimal local alignment
  of its translation (from the hit's frame, cut at the first stop) with the
  gene's protein (BLOSUM62, gaps 11 + 1 a residue) gives: the reference
  lists the identity of every best-scoring ungapped alignment (all of them
  when the best alignment has no gap, as planted genes and family copies,
  made by substitution alone, nearly always have); a hit whose best
  alignment has a gap is left undecided and counted apart;
- ``row_faults``: a cell of the report row that disagrees: the assembly,
  the locus, the type (the phenotype that ``reference.phenotype`` works out
  from what was planted), a whole planted gene listed as missing, its
  ``gene,identity%,coverage%[,state]`` entry among the expected genes in the
  locus, or for an extra gene among the extra genes, with the coverage and
  the state worked out here; and an extra gene listed that was not planted.

Every hit of a planted gene is judged, and a sample drawn from the seed of
the hits of other loci's genes (``OTHER_HITS`` an assembly), on their
protein identity: the copies of the conserved families that map, the
protein DP and decide handle for every locus.  Nothing of the program is imported; its
outputs are only read, to judge them.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from reference.align import (
    BLOSUM62,
    NT_GAP,
    NT_MATRIX,
    PROTEIN_GAP,
    affine_scores,
    gapless_optima,
    protein_codes,
    translate,
)

PAD = 64  # bases around a planted gene that its best local alignment may use
OTHER_HITS = 64  # hits of other loci's genes judged an assembly, drawn from the seed
EDGE_TOLERANCE = 5  # Kaptive's partial-edge tolerance
STATE_TAGS = {"partial": b",partial", "truncated": b",truncated", "novel": b",below_id_threshold", "normal": b""}


@dataclass
class Verdict:
    counts: dict[str, int] = field(
        default_factory=lambda: {"missing_genes": 0, "ext_short": 0, "pident_off": 0, "row_faults": 0}
    )
    genes: int = 0
    hits: int = 0
    other_hits: int = 0
    undecided: int = 0
    notes: list[str] = field(default_factory=list)

    def add(self, key: str, note: str) -> None:
        self.counts[key] += 1
        if len(self.notes) < 20:
            self.notes.append(f"{key}: {note}")


@dataclass
class _Hit:
    name: str  # assembly
    gene: object  # gen.Gene
    extra: bool  # a planted extra gene: its row entry is among the extra genes
    whole: bool  # a planted gene whole in one contig: its report row entry is judged
    planted: bool  # a planted gene's hit: its extent is judged
    h: int  # row of the result's gene hits
    q: tuple[int, int]
    t: tuple[int, int]
    contig: np.ndarray
    orf: np.ndarray
    region: tuple[int, int]  # the contig stretch a planted gene's best local alignment may use


def _orient(codes: np.ndarray, strand: int) -> np.ndarray:
    return codes if strand > 0 else (3 - codes)[::-1]


def _codes(seq: bytes) -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    return lut[np.frombuffer(seq, np.uint8)]


def _pieces(asm, lo: int, hi: int):
    r"""``(contig, start, end, whole)`` of each part of the gene planted at ``[lo, hi)`` that a contig holds."""
    out = []
    for c in range(len(asm.contig_starts) - 1):
        a, b = max(lo, int(asm.contig_starts[c])), min(hi, int(asm.contig_starts[c + 1]))
        if a < b:
            base = int(asm.contig_starts[c])
            out.append((c, a - base, b - base, a == lo and b == hi))
    return out


def _detail_entries(cell: bytes) -> dict[bytes, list[bytes]]:
    out: dict[bytes, list[bytes]] = {}
    for entry in filter(None, cell.split(b";")):
        out.setdefault(entry.split(b",", 1)[0], []).append(entry)
    return out


def _other_hits(asm, gh, ids, genes, rng) -> list[_Hit]:
    r"""Up to ``OTHER_HITS`` hits of ``asm``'s result whose gene is not of the planted locus,
    drawn by ``rng``."""
    planted = {g.gene_id.encode() for g, _, _ in asm.planted_genes()}
    rows = np.flatnonzero([gid not in planted for gid in ids])
    if len(rows) > OTHER_HITS:
        rows = np.sort(rng.choice(rows, OTHER_HITS, replace=False))
    out = []
    for h in rows:
        gene = genes[bytes(ids[h])]
        c = int(gh.t_indices[h])
        contig = asm.genome[asm.contig_starts[c] : asm.contig_starts[c + 1]]
        t = (int(gh.t_starts[h]), int(gh.t_ends[h]))
        q = (int(gh.q_starts[h]), int(gh.q_ends[h]))
        # Oriented by the hit's strand: where the program found the copy, not where its locus lays it.
        oriented = replace(gene, strand=int(gh.strands[h]))
        out.append(_Hit(asm.name, oriented, False, False, False, int(h), q, t, contig, _codes(gene.orf), t))
    return out


def judge(checked, genes: dict, id_threshold: float, device, rng=None, control: bool = False,
          phenotypes: dict[str, str] | None = None) -> Verdict:
    r"""Judge ``checked``, a list of ``(assembly, result, row_bytes, header)``; ``genes`` holds every
    gene of the database by its id, ``rng`` draws the sample of other loci's hits (none without),
    and ``phenotypes`` gives each assembly's phenotype by its name (its locus's type without).

    With ``control`` the program's protein identities are replaced by the
    nucleotide identity of each hit (the protein DP left out), and only
    ``pident_off`` is counted: the run that shows the comparison can fail.
    """
    v = Verdict()
    hits: list[_Hit] = []
    for asm, result, row, header in checked:
        cells = dict(zip(header.rstrip(b"\n").split(b"\t"), row.rstrip(b"\n").split(b"\t")))
        gh = result.gene_hits
        ids = np.asarray(gh.gene_ids)
        if not control:
            for key, want in (
                (b"Assembly", asm.name.encode()),
                (b"Best match locus", asm.locus.name.encode()),
                (b"Best match type", (phenotypes or {}).get(asm.name, asm.locus.serotype).encode()),
            ):
                if cells.get(key) != want:
                    v.add("row_faults", f"{asm.name} {key.decode()} {cells.get(key)!r} != {want!r}")
            missing = set(filter(None, cells.get(b"Missing expected genes", b"").split(b";")))
            extra_ids = {g.gene_id.encode() for g in asm.extras}
            for gid in _detail_entries(cells.get(b"Extra genes, details", b"")):
                if gid not in extra_ids:
                    v.add("row_faults", f"{asm.name} extra gene {gid!r} listed, not planted")
        for gene, lo, hi in asm.planted_genes():
            v.genes += 1
            orf = _codes(gene.orf)
            extra = gene in asm.extras
            for c, a, b, whole in _pieces(asm, lo, hi):
                contig = asm.genome[asm.contig_starts[c] : asm.contig_starts[c + 1]]
                rows = np.flatnonzero(
                    (ids == gene.gene_id.encode()) & (np.asarray(gh.t_indices) == c)
                    & (np.asarray(gh.strands) == gene.strand)
                    & (np.asarray(gh.t_starts) < b) & (np.asarray(gh.t_ends) > a)
                )
                if whole and len(rows) == 0:
                    v.add("missing_genes", f"{asm.name} {gene.gene_id} contig {c} [{a}, {b})")
                if whole and not control and gene.gene_id.encode() in missing:
                    v.add("row_faults", f"{asm.name} {gene.gene_id} listed as missing")
                for h in rows:
                    q = (int(gh.q_starts[h]), int(gh.q_ends[h]))
                    t = (int(gh.t_starts[h]), int(gh.t_ends[h]))
                    region = (max(0, min(a - PAD, t[0])), min(len(contig), max(b + PAD, t[1])))
                    hits.append(_Hit(asm.name, gene, extra, whole, True, int(h), q, t, contig, orf, region))
    v.hits = len(hits)
    if rng is not None:
        for asm, result, row, header in checked:
            others = _other_hits(asm, result.gene_hits, np.asarray(result.gene_hits.gene_ids), genes, rng)
            v.other_hits += len(others)
            hits += others
    if not hits:
        return v

    # Extension: a planted gene's hit's extent against the gene's best local alignment there.
    ext = [x for x in hits if x.planted]
    best = affine_scores(
        [x.orf for x in ext],
        [_orient(x.contig[x.region[0] : x.region[1]], x.gene.strand) for x in ext],
        NT_MATRIX, NT_GAP, local=True, device=device,
    )
    claimed = affine_scores(
        [x.orf[x.q[0] : x.q[1]] for x in ext],
        [_orient(x.contig[x.t[0] : x.t[1]], x.gene.strand) for x in ext],
        NT_MATRIX, NT_GAP, local=False, device=device,
    )
    # Protein: the hit's translation against the gene's protein (stop included, as the database keeps it).
    queries, targets = [], []
    for x in hits:
        seq = _orient(x.contig[x.t[0] : x.t[1]], x.gene.strand)
        queries.append(protein_codes(translate(seq[(-x.q[0]) % 3 :], to_stop=True)))
        targets.append(protein_codes(translate(x.orf, to_stop=False)))
    prot_best = affine_scores(queries, targets, BLOSUM62, PROTEIN_GAP, local=True, device=device)

    by_asm = {asm.name: (asm, result, row, header) for asm, result, row, header in checked}
    for k, x in enumerate(hits):
        asm, result, row, header = by_asm[x.name]
        gh = result.gene_hits
        where = f"{x.name} {x.gene.gene_id} q[{x.q[0]}, {x.q[1]}) t[{x.t[0]}, {x.t[1]})"
        if x.planted and claimed[k] < best[k]:  # planted hits come first in ``hits``
            v.add("ext_short", f"{where}: its extent scores {claimed[k]}, the best local alignment {best[k]}")
        if control:
            span = min(x.q[1] - x.q[0], x.t[1] - x.t[0])
            seq = _orient(x.contig[x.t[0] : x.t[1]], x.gene.strand)[:span]
            ident = float(np.float32(np.count_nonzero(seq == x.orf[x.q[0] : x.q[0] + span]) * 100.0 / max(span, 1)))
        else:
            ident = float(np.float32(result.protein_identities[x.h]))
        if len(queries[k]) == 0:
            allowed = {0.0}
        else:
            top, allowed = gapless_optima(queries[k], targets[k], BLOSUM62)
            if top != prot_best[k]:
                v.undecided += 1  # a gapped alignment is optimal: the reference names no identity
                allowed = None
        if allowed is not None and ident not in allowed:
            v.add("pident_off", f"{where}: identity {ident} not among {sorted(allowed)[:6]}")
        if control or not x.whole:
            continue
        # The report row's entry for this whole gene.
        cov = float(np.float32(np.clip(len(queries[k]) * 3.0 / len(x.orf) * 100.0, 0.0, 100.0)))
        glen = len(x.orf)
        fwd = x.gene.strand > 0
        head = x.q[0] if fwd else glen - x.q[1]
        tail = glen - x.q[1] if fwd else x.q[0]
        partial = (x.t[0] <= EDGE_TOLERANCE and head > 0) or (x.t[1] >= len(x.contig) - EDGE_TOLERANCE and tail > 0)
        state = "partial" if partial else "truncated" if cov < 90.0 else "novel" if ident < id_threshold else "normal"
        want = b"%s,%.2f%%,%.2f%%" % (x.gene.gene_id.encode(), ident, cov) + STATE_TAGS[state]
        cells = dict(zip(header.rstrip(b"\n").split(b"\t"), row.rstrip(b"\n").split(b"\t")))
        column = b"Extra genes, details" if x.extra else b"Expected genes in locus, details"
        entries = _detail_entries(cells.get(column, b""))
        if want not in entries.get(x.gene.gene_id.encode(), []):
            v.add("row_faults", f"{where}: row entry {entries.get(x.gene.gene_id.encode())} lacks {want!r}")
        if float(np.float32(gh.coverages[x.h])) != cov:
            v.add("row_faults", f"{where}: coverage {gh.coverages[x.h]} != {cov}")
    return v
