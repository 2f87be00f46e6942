r"""The phenotype that a database's rules give each assembly, worked out from what was planted.

A plain re-implementation of the rule semantics that the repository's
database-curation document states for a TOML ``[phenotype_logic]`` table,
written from that text and nothing of the program:

- a rule's ``loci``, ``extra_genes`` and ``inactive_genes`` are ``fnmatch``
  patterns (``*``, ``?``, ``[...]``), matched case-sensitively against the
  database's locus names and gene clusters;
- a rule fires for an assembly when one of its ``loci`` patterns matches the
  best-match locus; when every cluster its ``extra_genes`` patterns match is
  active, a gene of it found NORMAL or PARTIAL; and, where its
  ``inactive_genes`` patterns match any cluster, when at least one of those
  that the locus holds is inactive: missing, TRUNCATED or NOVEL;
- of the replacement rules that fire (``as_suffix`` false, the default), the
  one of the highest ``priority`` (default 50) names the phenotype, the first
  in the table on a tie; where none fires, the locus's type does;
- the suffix rules that fire append their names to it in descending
  priority, in the table's order on a tie.

Which clusters are active comes from the planting truth alone: the planted
locus's genes and the planted extra genes, each read from the bases the
generator wrote.  A gene that a contig break cuts runs off a contig edge, so
it is PARTIAL and active.  A gene whole in one contig is TRUNCATED where its
translation from its start reaches a stop before 90% of its length (a
knocked-out gene reaches one at half its length), NOVEL where its protein
identity to the database's protein is under the database's threshold, else
NORMAL.  A cluster nothing was planted of is inactive.
"""

from __future__ import annotations

from dataclasses import dataclass
from fnmatch import fnmatchcase

import numpy as np

from reference.align import translate
from reference.judge import _codes, _orient

TRUNCATED_BELOW = 0.90  # a gene's translated share of its length below which it is TRUNCATED


@dataclass(frozen=True)
class Rule:
    name: str
    loci: tuple[str, ...]
    extra_genes: tuple[str, ...]
    inactive_genes: tuple[str, ...]
    priority: int
    as_suffix: bool


def rules_of(table: dict) -> list[Rule]:
    r"""The rules of a ``[phenotype_logic]`` table, in its order."""
    return [
        Rule(
            name,
            tuple(spec.get("loci", ())),
            tuple(spec.get("extra_genes", ())),
            tuple(spec.get("inactive_genes", ())),
            int(spec.get("priority", 50)),
            bool(spec.get("as_suffix", False)),
        )
        for name, spec in table.items()
    ]


def _matching(patterns, names) -> set[str]:
    return {n for n in names if any(fnmatchcase(n, p) for p in patterns)}


def phenotype(rules: list[Rule], locus: str, base: str, clusters, expected: set[str], active: set[str]) -> str:
    r"""The phenotype of an assembly whose best-match locus is ``locus`` of type ``base``: ``clusters``
    are every cluster of the database, ``expected`` the clusters the locus holds, ``active`` those
    found NORMAL or PARTIAL."""
    fired = []
    for rule in rules:
        if not any(fnmatchcase(locus, p) for p in rule.loci):
            continue
        if not _matching(rule.extra_genes, clusters) <= active:
            continue
        named = _matching(rule.inactive_genes, clusters)
        if named and not (named & expected) - active:
            continue
        fired.append(rule)
    out = base
    replacing = [r for r in fired if not r.as_suffix]
    if replacing:
        out = max(replacing, key=lambda r: r.priority).name  # ``max`` keeps the first of equals
    for rule in sorted((r for r in fired if r.as_suffix), key=lambda r: -r.priority):  # a stable sort
        out += rule.name
    return out


def gene_active(asm, gene, lo: int, hi: int, id_threshold: float) -> bool:
    r"""Whether the gene planted at ``[lo, hi)`` of ``asm.genome`` is found NORMAL or PARTIAL."""
    edges = asm.contig_starts
    c = int(np.searchsorted(edges, lo, side="right")) - 1
    if hi > int(edges[c + 1]):
        return True  # cut by a contig break: PARTIAL
    planted = translate(_orient(asm.genome[lo:hi], gene.strand), to_stop=True)
    if len(planted) * 3 < TRUNCATED_BELOW * (hi - lo):
        return False  # TRUNCATED
    own = translate(_codes(gene.orf), to_stop=False)[: len(planted)]
    same = np.count_nonzero(np.frombuffer(planted, np.uint8) == np.frombuffer(own, np.uint8))
    return same * 100.0 >= id_threshold * max(len(planted), 1)  # else NOVEL


def expected_phenotypes(pool, db, cfg: dict) -> list[str]:
    r"""Each pool entry's phenotype: its planted locus's type where the configuration states no rules."""
    rules = rules_of(cfg.get("phenotype_logic", {}))
    if not rules:
        return [asm.locus.serotype for asm in pool]
    clusters = {g.cluster for locus in db.loci for g in locus.genes} | {g.cluster for g in db.extra}
    out = []
    for asm in pool:
        active = {
            g.cluster for g, lo, hi in asm.planted_genes() if gene_active(asm, g, lo, hi, float(cfg["id_threshold"]))
        }
        expected = {g.cluster for g in asm.locus.genes}
        out.append(phenotype(rules, asm.locus.name, asm.locus.serotype, clusters, expected, active))
    return out
