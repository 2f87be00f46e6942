r"""Synthetic surface-antigen locus databases and assemblies with known truth, made from a seed.

A frozen, extended copy of the repository's test generators (random ORFs,
substitutions, spacer + alternating-strand gene loci, one planted locus in
random flanks, the clean / diverged / fragmented / draft compositions),
vectorised with numpy and widened to the shape of the public locus
databases: gene lengths over a configurable range, and conserved gene
families whose members in every locus are drawn at a configurable nucleotide
identity to one family root, with no stop codon created inside the ORF.

Configuration keys (``benchmark/configs/<name>.json``):

- ``n_loci``, ``genes_per_locus``, ``families_5p``, ``families_3p``: loci
  ``KL1``... of type ``K1``..., each the 5' families, its own ORFs, the 3'
  families.  Used where ``loci`` is absent.
- ``loci`` (optional): the roster, a list of ``{name, type, genes: [cluster,
  ...]}``.  A cluster named in more than one locus is a family, its members
  drawn from one root; a cluster named in one locus is that locus's own ORF.
- ``family_identity``: a family member's nucleotide identity to its root,
  uniform in the range; ``cluster_identity`` (optional, ``{cluster: [lo,
  hi]}``) gives a family its own range, for variant loci whose shared genes
  are nearly identical.
- ``gene_nt``, ``spacer_nt``, ``tail_nt``: the ORFs' lengths (the roots' the
  range's evenly spaced quantiles, each own ORF's uniform in codons), the
  spacer before each gene, the tail after the last; genes alternate strands.
- ``extra_genes`` (optional): a list of ``{cluster, nt}``, ORFs drawn after
  the loci, each written as a GenBank record of its own whose note reads
  ``Extra genes: <cluster>`` (genes typed outside any locus).
- ``phenotype_logic`` (optional): the rules, written as they stand into the
  TOML's ``[phenotype_logic]`` table; ``antigen`` and ``pathway`` (optional)
  the TOML's strings, by default a capsule's.

Traffic keys of a class (``benchmark/traffic/<name>.json``), besides its
``weight``, ``sub_rate``, ``contigs``, ``split`` and ``min_contig_nt``:

- ``extra_sets`` (optional): a list of ``{genes: [cluster, ...], share}``.
  ``round(share * n)`` of the class's ``n`` assemblies, drawn from the seed,
  carry the whole set: each gene at the class's ``sub_rate``, on a strand
  drawn from the seed, at least half a flank away from the locus, before
  the assembly is cut into contigs.
- ``knockout`` (optional): ``{cluster, share}``.  In ``round(share * n)`` of
  the class's assemblies, drawn from the seed, the planted locus's first
  gene of that cluster, where it has one, carries a stop codon at
  ``KNOCK_AT`` of its codons.

Where these optional keys are absent nothing is drawn for them, so a
configuration and a mix without them give the inputs they gave before the
keys existed.  Everything is a pure function of the configuration, the
traffic mix and a ``numpy.random.Generator``; nothing here imports the
program.  The GenBank and TOML texts are written as plain text.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# Codons as 3-digit base-4 numbers; TAA, TAG, TGA are the stops.
_STOP_IDS = (3 * 16 + 0 * 4 + 0, 3 * 16 + 0 * 4 + 2, 3 * 16 + 2 * 4 + 0)
_SENSE = np.array([c for c in range(64) if c not in _STOP_IDS], dtype=np.uint8)
_TAA = np.array([3, 0, 0], dtype=np.uint8)
_ATG = np.array([0, 3, 2], dtype=np.uint8)
_CODES = np.zeros(256, dtype=np.uint8)
_CODES[BASES] = np.arange(4, dtype=np.uint8)
KNOCK_AT = 0.5  # a knocked-out gene's stop codon, as a fraction of its codons
EXTRA_GAP = 100  # bases at least between two extra genes planted in one assembly


def seed_streams(seed: int, n: int) -> list[np.random.Generator]:
    r"""``n`` independent generators from one seed of any size or sign."""
    root = np.random.SeedSequence(int(seed) % (1 << 64))
    return [np.random.default_rng(s) for s in root.spawn(n)]


def random_codes(rng: np.random.Generator, n: int) -> np.ndarray:
    r"""``n`` uniform bases as codes 0..3."""
    return np.frombuffer(rng.bytes(n), dtype=np.uint8) & 3


def to_bytes(codes: np.ndarray) -> bytes:
    return BASES[codes].tobytes()


def to_codes(seq: bytes) -> np.ndarray:
    return _CODES[np.frombuffer(seq, dtype=np.uint8)]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def random_orf(rng: np.random.Generator, n_codons: int) -> np.ndarray:
    r"""ATG, ``n_codons - 2`` uniform sense codons, TAA (as codes)."""
    sense = _SENSE[rng.integers(0, len(_SENSE), n_codons - 2)]
    digits = np.stack([sense // 16, (sense // 4) % 4, sense % 4], axis=1).reshape(-1)
    return np.concatenate([_ATG, digits.astype(np.uint8), _TAA])


def substitute(rng: np.random.Generator, codes: np.ndarray, rate: float) -> np.ndarray:
    r"""Each base replaced by one of the three others with probability ``rate``."""
    out = codes.copy()
    if rate <= 0:
        return out
    hit = rng.random(len(codes)) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()), dtype=np.uint8)) & 3
    return out


def diverge_orf(rng: np.random.Generator, orf: np.ndarray, identity: float) -> np.ndarray:
    r"""A family member: ``orf`` with ``round((1 - identity) * len)`` distinct
    substitutions inside its first and last codon, every codon that became a
    stop put back as it was."""
    n = len(orf)
    n_sub = int(round((1.0 - identity) * n))
    pos = 3 + rng.choice(n - 6, size=n_sub, replace=False)
    out = orf.copy()
    out[pos] = (out[pos] + rng.integers(1, 4, n_sub, dtype=np.uint8)) & 3
    cod = out.reshape(-1, 3).astype(np.int64)
    ids = cod[:, 0] * 16 + cod[:, 1] * 4 + cod[:, 2]
    stop = np.isin(ids, _STOP_IDS)
    stop[-1] = False
    out.reshape(-1, 3)[stop] = orf.reshape(-1, 3)[stop]
    return out


@dataclass(frozen=True)
class Gene:
    gene_id: str  # the database's id: ``<locus>_<nn>_<cluster>``
    cluster: str
    start: int  # 0-based, half-open, in locus coordinates
    end: int
    strand: int
    orf: bytes  # the ORF in its own (coding) orientation


@dataclass(frozen=True)
class Locus:
    name: str
    serotype: str
    seq: np.ndarray  # codes
    genes: tuple[Gene, ...]


@dataclass(frozen=True)
class SyntheticDatabase:
    genbank: str
    toml: str
    loci: tuple[Locus, ...]
    roots: dict[str, bytes]  # each conserved family's root ORF
    extra: tuple[Gene, ...] = ()  # the ``Extra genes`` records' genes, in record coordinates


def _span(rng: np.random.Generator, lo_hi) -> int:
    lo, hi = lo_hi
    return int(rng.integers(lo, hi + 1))


def _draw_roots(cfg: dict, fams: list[str], rng: np.random.Generator) -> dict[str, np.ndarray]:
    r"""One root ORF a family.  The roots' lengths are the range's evenly spaced quantiles in an order
    drawn from the seed: every locus holds a member of each family it names, so a length drawn at
    random would change every seed's work."""
    lo_codons, hi_codons = (x // 3 for x in cfg["gene_nt"])
    spread = [lo_codons + (hi_codons - lo_codons) * (2 * i + 1) // (2 * len(fams)) for i in range(len(fams))]
    return {f: random_orf(rng, spread[i]) for f, i in zip(fams, rng.permutation(len(fams)))}


def _draw_locus(cfg: dict, rng, name: str, serotype: str, clusters: list[str], roots: dict) -> Locus:
    r"""A locus of ``clusters`` in order: a spacer before each gene, a family member for a cluster
    with a root, else an ORF of its own, strands alternating, then the tail."""
    lo_codons, hi_codons = (x // 3 for x in cfg["gene_nt"])
    identity = cfg.get("cluster_identity", {})
    parts, genes, pos = [], [], 0
    for gi, cluster in enumerate(clusters):
        spacer = random_codes(rng, _span(rng, cfg["spacer_nt"]))
        parts.append(spacer)
        pos += len(spacer)
        if cluster in roots:
            id_lo, id_hi = identity.get(cluster, cfg["family_identity"])
            orf = diverge_orf(rng, roots[cluster], float(rng.uniform(id_lo, id_hi)))
        else:
            orf = random_orf(rng, _span(rng, (lo_codons, hi_codons)))
        strand = 1 if gi % 2 == 0 else -1
        parts.append(orf if strand == 1 else revcomp_codes(orf))
        genes.append(Gene(f"{name}_{gi + 1:02}_{cluster}", cluster, pos, pos + len(orf), strand, to_bytes(orf)))
        pos += len(orf)
    parts.append(random_codes(rng, cfg["tail_nt"]))
    return Locus(name, serotype, np.concatenate(parts), tuple(genes))


def make_database(cfg: dict, rng: np.random.Generator) -> SyntheticDatabase:
    r"""The configuration's locus database: the ``loci`` roster where the configuration has one,
    else ``n_loci`` loci of ``genes_per_locus`` genes, the ``families_5p`` first and the
    ``families_3p`` last, each a member of its family, the genes between each locus's own; then
    the ``extra_genes`` records."""
    if "loci" in cfg:
        roster = [(e["name"], e["type"], list(e["genes"])) for e in cfg["loci"]]
        named = [c for _, _, clusters in roster for c in dict.fromkeys(clusters)]
        fams = [c for c in dict.fromkeys(named) if named.count(c) > 1]
    else:
        fam5, fam3 = list(cfg["families_5p"]), list(cfg["families_3p"])
        n_own = cfg["genes_per_locus"] - len(fam5) - len(fam3)
        if n_own < 0:
            raise ValueError("more family genes than genes a locus")
        roster = [
            (f"KL{li + 1}", f"K{li + 1}", fam5 + [f"orf{li + 1}_{j + 1}" for j in range(n_own)] + fam3)
            for li in range(cfg["n_loci"])
        ]
        fams = fam5 + fam3
    roots = _draw_roots(cfg, fams, rng)
    loci = tuple(_draw_locus(cfg, rng, name, serotype, clusters, roots) for name, serotype, clusters in roster)
    extra = tuple(_draw_extra(cfg, rng, spec) for spec in cfg.get("extra_genes", ()))
    return SyntheticDatabase(_genbank(loci, extra), _toml(cfg), loci, {f: to_bytes(r) for f, r in roots.items()},
                             tuple(g for g, _ in extra))


def _draw_extra(cfg: dict, rng, spec: dict) -> tuple[Gene, np.ndarray]:
    r"""An ``Extra genes`` record: a spacer, the gene's ORF of ``spec["nt"]`` bases, the tail.  The
    program names an extra gene by its cluster alone."""
    spacer = random_codes(rng, _span(rng, cfg["spacer_nt"]))
    orf = random_orf(rng, spec["nt"] // 3)
    gene = Gene(spec["cluster"], spec["cluster"], len(spacer), len(spacer) + len(orf), 1, to_bytes(orf))
    return gene, np.concatenate([spacer, orf, random_codes(rng, cfg["tail_nt"])])


def _record(out: list[str], name: str, seq_codes: np.ndarray, notes: list[str], genes) -> None:
    seq = to_bytes(seq_codes).decode().lower()
    out.append(f"LOCUS       {name} {len(seq)} bp    DNA     linear   UNA")
    out.append("FEATURES             Location/Qualifiers")
    out.append(f"     {'source':<16}1..{len(seq)}")
    for note in notes:
        out.append(f'                     /note="{note}"')
    for g in genes:
        loc = f"{g.start + 1}..{g.end}"
        out.append(f"     {'CDS':<16}{loc if g.strand > 0 else f'complement({loc})'}")
        out.append(f'                     /gene="{g.cluster}"')
        out.append(f'                     /product="protein {g.cluster}"')
    out.append("ORIGIN")
    for i in range(0, len(seq), 60):
        chunk = seq[i : i + 60]
        out.append(f"{i + 1:>9} " + " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10)))
    out.append("//")


def _genbank(loci, extra=()) -> str:
    out: list[str] = []
    for locus in loci:
        _record(out, locus.name, locus.seq, [f"locus: {locus.name}", f"type: {locus.serotype}"], locus.genes)
    for gene, seq in extra:
        _record(out, gene.cluster, seq, [f"Extra genes: {gene.cluster}"], [gene])
    return "\n".join(out) + "\n"


def _toml_value(value) -> str:
    r"""``value`` as TOML: strings and keys as JSON writes them (its escapes are TOML's), lists as
    arrays, mappings as inline tables."""
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, list):
        return "[" + ", ".join(_toml_value(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{ " + ", ".join(f"{json.dumps(k)} = {_toml_value(v)}" for k, v in value.items()) + " }"
    raise TypeError(f"no TOML form for {value!r}")


def _toml(cfg: dict) -> str:
    name = cfg["db_name"]
    text = f'''name = "{name}"
keyword = "{cfg['name']}"
genbank = "{name}.gbk"
organism = "{cfg['organism']}"
taxon = {cfg['taxon']}
antigen = "{cfg.get('antigen', 'Capsular polysaccharide')}"
pathway = "{cfg.get('pathway', 'Wzx/Wzy-dependent')}"
version = "1.0.0"
id_threshold = {cfg['id_threshold']}
doi = ["synthetic"]
owner = "benchmark"
repo = "synthetic"
branch = "main"
[contact]
"Benchmark" = "benchmark@example.org"
'''
    if "phenotype_logic" in cfg:  # the rules as they stand, in their order (the first wins a tie)
        text += "[phenotype_logic]\n" + "".join(
            f"{json.dumps(rule)} = {_toml_value(spec)}\n" for rule, spec in cfg["phenotype_logic"].items()
        )
    return text


# --- assemblies ---------------------------------------------------------


@dataclass(frozen=True)
class Assembly:
    name: str
    kind: str
    locus: Locus
    fasta: bytes
    genome: np.ndarray  # the whole genome's codes, contigs concatenated
    locus_start: int  # the planted locus's offset in ``genome``
    contig_starts: np.ndarray  # (n_contigs + 1,) offsets into ``genome``
    extras: tuple[Gene, ...] = ()  # the extra genes planted: ``start``, ``end`` and ``strand`` in ``genome``
    knocked: str | None = None  # the id of the locus gene that carries a stop codon at ``KNOCK_AT``

    def planted_genes(self) -> list[tuple[Gene, int, int]]:
        r"""Every planted gene with its start and end in ``genome``: the locus's, then the extra genes."""
        return [(g, self.locus_start + g.start, self.locus_start + g.end) for g in self.locus.genes] + [
            (g, g.start, g.end) for g in self.extras
        ]


def _pieces(rng, rule: str, n: int, total: int, cut: int, min_nt: int) -> np.ndarray:
    r"""Contig start offsets (with ``total`` appended) for a split rule."""
    if rule == "none" or n == 1:
        return np.array([0, total])
    if rule == "at_locus_middle":
        return np.array([0, cut, total])
    if rule == "even":  # bench.py's draft: equal pieces, the last takes the rest
        step = total // n
        return np.array([j * step for j in range(n)] + [total])
    if rule == "random":  # uniform breaks, every piece at least ``min_nt``
        spare = total - n * min_nt
        cuts = np.sort(rng.integers(0, spare + 1, n - 1))
        lengths = np.diff(np.concatenate([[0], cuts, [spare]])) + min_nt
        return np.concatenate([[0], np.cumsum(lengths)])
    raise ValueError(f"unknown split rule {rule!r}")


def _knock_out(planted: np.ndarray, gene: Gene) -> None:
    r"""Write a stop codon into ``planted`` (locus coordinates) at ``KNOCK_AT`` of ``gene``'s codons,
    in its coding orientation."""
    c = int(KNOCK_AT * (len(gene.orf) // 3))
    if gene.strand > 0:
        planted[gene.start + 3 * c : gene.start + 3 * c + 3] = _TAA
    else:
        planted[gene.end - 3 * c - 3 : gene.end - 3 * c] = revcomp_codes(_TAA)


def _plant_extras(rng, genome: np.ndarray, locus_lo: int, locus_hi: int, genes, sub_rate: float) -> tuple[Gene, ...]:
    r"""Write each of ``genes`` into ``genome`` over random flank, at ``sub_rate``, on a strand drawn
    from ``rng``: in the outer half of a flank, at least ``EXTRA_GAP`` bases from each other."""
    rooms = [(0, locus_lo // 2), (locus_hi + (len(genome) - locus_hi + 1) // 2, len(genome))]
    placed: list[Gene] = []
    for gene in genes:
        codes = substitute(rng, to_codes(gene.orf), sub_rate)
        strand = 1 if rng.integers(0, 2) == 0 else -1
        n = len(codes)
        fits = [(a, b - n) for a, b in rooms if b - n > a]
        for _ in range(100):
            x = int(rng.integers(0, sum(b - a for a, b in fits)))
            for a, b in fits:
                if x < b - a:
                    pos = a + x
                    break
                x -= b - a
            if all(pos + n + EXTRA_GAP <= g.start or g.end + EXTRA_GAP <= pos for g in placed):
                break
        else:
            raise ValueError(f"no room in the flanks for extra gene {gene.gene_id}")
        genome[pos : pos + n] = codes if strand > 0 else revcomp_codes(codes)
        placed.append(replace(gene, start=pos, end=pos + n, strand=strand))
    return tuple(placed)


def make_assembly(rng, name: str, kind: dict, n_contigs: int, locus: Locus, genome_nt: int,
                  extras: tuple[Gene, ...] = (), knockout: str | None = None) -> Assembly:
    r"""One assembly: ``locus`` with the class's substitutions between random
    flanks, ``genome_nt`` bases in all, cut into contigs by the class's rule.
    The locus's first gene of cluster ``knockout`` (where it has one) gets a
    stop codon, and ``extras`` are planted in the flanks before the cut."""
    planted = substitute(rng, locus.seq, kind["sub_rate"])
    target = next((g for g in locus.genes if g.cluster == knockout), None) if knockout else None
    if target is not None:
        _knock_out(planted, target)
    left = (genome_nt - len(planted)) // 2
    right = genome_nt - len(planted) - left
    genome = np.concatenate([random_codes(rng, left), planted, random_codes(rng, right)])
    placed = _plant_extras(rng, genome, left, left + len(planted), extras, kind["sub_rate"]) if extras else ()
    starts = _pieces(rng, kind["split"], n_contigs, len(genome), left + len(planted) // 2, kind.get("min_contig_nt", 1))
    text = BASES[genome].tobytes()
    fasta = b"".join(
        b">c%d\n%s\n" % (j + 1, text[starts[j] : starts[j + 1]]) for j in range(len(starts) - 1)
    )
    return Assembly(name, kind["name"], locus, fasta, genome, left, starts, placed,
                    target.gene_id if target is not None else None)


def contig_counts(kind: dict, n: int) -> list[int]:
    r"""Contig counts of a class's ``n`` assemblies: evenly spread over its range,
    so every seed types the same set of sizes."""
    lo, hi = kind["contigs"]
    if n == 1:
        return [lo]
    return [int(round(lo + (hi - lo) * i / (n - 1))) for i in range(n)]


def make_pool(traffic: dict, db: SyntheticDatabase, genome_nt: int, rng) -> list[Assembly]:
    r"""The traffic's pool: ``pool_size`` assemblies, each class's share as its
    weight says, in an order and with planted loci drawn from ``rng``."""
    classes = traffic["classes"]
    weights = np.array([c["weight"] for c in classes], dtype=np.float64)
    n = traffic["pool_size"]
    counts = np.floor(weights / weights.sum() * n).astype(int)
    counts[: n - counts.sum()] += 1
    slots = [(c, k) for c, cnt in zip(classes, counts) for k in contig_counts(c, int(cnt))]
    order = rng.permutation(len(slots))
    extras, knockouts = _draw_marks(rng, classes, [slots[s][0] for s in order], db)
    pool = []
    for i, s in enumerate(order):
        kind, n_contigs = slots[s]
        locus = db.loci[int(rng.integers(0, len(db.loci)))]
        pool.append(make_assembly(rng, f"a{i:03d}", kind, n_contigs, locus, genome_nt, extras[i], knockouts[i]))
    return pool


def _draw_marks(rng, classes: list[dict], kinds: list[dict], db: SyntheticDatabase):
    r"""Which assemblies (in pool order, of the classes ``kinds``) carry which extra genes and
    which knockout: ``round(share * n)`` of a class's ``n``, drawn from ``rng`` for the classes
    that name them and for no other."""
    extras: list[tuple[Gene, ...]] = [()] * len(kinds)
    knockouts: list[str | None] = [None] * len(kinds)
    by_cluster = {g.cluster: g for g in db.extra}
    for kind in classes:
        mine = [i for i, k in enumerate(kinds) if k is kind]

        def drawn(share: float) -> list[int]:
            return [mine[j] for j in rng.permutation(len(mine))[: round(share * len(mine))]]

        for spec in kind.get("extra_sets", ()):
            genes = tuple(by_cluster[c] for c in spec["genes"])
            for i in drawn(spec["share"]):
                extras[i] += tuple(g for g in genes if g not in extras[i])
        if "knockout" in kind:
            for i in drawn(kind["knockout"]["share"]):
                knockouts[i] = kind["knockout"]["cluster"]
    return extras, knockouts


def gene_table(db: SyntheticDatabase) -> dict[bytes, Gene]:
    r"""Every gene of the database by its id, as the program's results name it."""
    return {g.gene_id.encode(): g for g in [g for locus in db.loci for g in locus.genes] + list(db.extra)}
