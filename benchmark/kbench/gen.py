r"""Synthetic K-locus databases and assemblies with known truth, made from a seed.

A frozen, extended copy of the repository's test generators (random ORFs,
substitutions, spacer + alternating-strand gene loci, one planted locus in
random flanks, the clean / diverged / fragmented / draft compositions),
vectorised with numpy and widened to the shape of the public K-locus
databases: gene lengths over a configurable range, and conserved gene
families whose members in every locus are drawn at a configurable nucleotide
identity to one family root, with no stop codon created inside the ORF.

Everything is a pure function of the configuration, the traffic mix and a
``numpy.random.Generator``; nothing here imports the program.  The GenBank
and TOML texts are written as plain text.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# Codons as 3-digit base-4 numbers; TAA, TAG, TGA are the stops.
_STOP_IDS = (3 * 16 + 0 * 4 + 0, 3 * 16 + 0 * 4 + 2, 3 * 16 + 2 * 4 + 0)
_SENSE = np.array([c for c in range(64) if c not in _STOP_IDS], dtype=np.uint8)
_TAA = np.array([3, 0, 0], dtype=np.uint8)
_ATG = np.array([0, 3, 2], dtype=np.uint8)


def seed_streams(seed: int, n: int) -> list[np.random.Generator]:
    r"""``n`` independent generators from one seed of any size or sign."""
    root = np.random.SeedSequence(int(seed) % (1 << 64))
    return [np.random.default_rng(s) for s in root.spawn(n)]


def random_codes(rng: np.random.Generator, n: int) -> np.ndarray:
    r"""``n`` uniform bases as codes 0..3."""
    return np.frombuffer(rng.bytes(n), dtype=np.uint8) & 3


def to_bytes(codes: np.ndarray) -> bytes:
    return BASES[codes].tobytes()


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


def _span(rng: np.random.Generator, lo_hi) -> int:
    lo, hi = lo_hi
    return int(rng.integers(lo, hi + 1))


def make_database(cfg: dict, rng: np.random.Generator) -> SyntheticDatabase:
    r"""The configuration's locus database: ``n_loci`` loci of ``genes_per_locus``
    genes, the ``families_5p`` first and the ``families_3p`` last, each a
    member of its family; the genes between are each locus's own."""
    lo_codons, hi_codons = (x // 3 for x in cfg["gene_nt"])
    fam5, fam3 = list(cfg["families_5p"]), list(cfg["families_3p"])
    n_own = cfg["genes_per_locus"] - len(fam5) - len(fam3)
    if n_own < 0:
        raise ValueError("more family genes than genes a locus")
    # The roots' lengths are the range's evenly spaced quantiles in an order drawn from the seed:
    # every locus holds a member of each, so a length drawn at random would change every seed's work.
    fams = fam5 + fam3
    spread = [lo_codons + (hi_codons - lo_codons) * (2 * i + 1) // (2 * len(fams)) for i in range(len(fams))]
    roots = {f: random_orf(rng, spread[i]) for f, i in zip(fams, rng.permutation(len(fams)))}
    id_lo, id_hi = cfg["family_identity"]
    loci = []
    for li in range(cfg["n_loci"]):
        name, serotype = f"KL{li + 1}", f"K{li + 1}"
        clusters = fam5 + [f"orf{li + 1}_{j + 1}" for j in range(n_own)] + fam3
        parts, genes, pos = [], [], 0
        for gi, cluster in enumerate(clusters):
            spacer = random_codes(rng, _span(rng, cfg["spacer_nt"]))
            parts.append(spacer)
            pos += len(spacer)
            if cluster in roots:
                orf = diverge_orf(rng, roots[cluster], float(rng.uniform(id_lo, id_hi)))
            else:
                orf = random_orf(rng, _span(rng, (lo_codons, hi_codons)))
            strand = 1 if gi % 2 == 0 else -1
            parts.append(orf if strand == 1 else revcomp_codes(orf))
            genes.append(Gene(f"{name}_{gi + 1:02}_{cluster}", cluster, pos, pos + len(orf), strand, to_bytes(orf)))
            pos += len(orf)
        parts.append(random_codes(rng, cfg["tail_nt"]))
        loci.append(Locus(name, serotype, np.concatenate(parts), tuple(genes)))
    return SyntheticDatabase(_genbank(loci), _toml(cfg), tuple(loci), {f: to_bytes(r) for f, r in roots.items()})


def _genbank(loci) -> str:
    out: list[str] = []
    for locus in loci:
        seq = to_bytes(locus.seq).decode().lower()
        out.append(f"LOCUS       {locus.name} {len(seq)} bp    DNA     linear   UNA")
        out.append("FEATURES             Location/Qualifiers")
        out.append(f"     {'source':<16}1..{len(seq)}")
        out.append(f'                     /note="locus: {locus.name}"')
        out.append(f'                     /note="type: {locus.serotype}"')
        for g in locus.genes:
            loc = f"{g.start + 1}..{g.end}"
            out.append(f"     {'CDS':<16}{loc if g.strand > 0 else f'complement({loc})'}")
            out.append(f'                     /gene="{g.cluster}"')
            out.append(f'                     /product="protein {g.cluster}"')
        out.append("ORIGIN")
        for i in range(0, len(seq), 60):
            chunk = seq[i : i + 60]
            out.append(f"{i + 1:>9} " + " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10)))
        out.append("//")
    return "\n".join(out) + "\n"


def _toml(cfg: dict) -> str:
    name = cfg["db_name"]
    return f'''name = "{name}"
keyword = "{cfg['name']}"
genbank = "{name}.gbk"
organism = "{cfg['organism']}"
taxon = {cfg['taxon']}
antigen = "Capsular polysaccharide"
pathway = "Wzx/Wzy-dependent"
version = "1.0.0"
id_threshold = {cfg['id_threshold']}
doi = ["synthetic"]
owner = "benchmark"
repo = "synthetic"
branch = "main"
[contact]
"Benchmark" = "benchmark@example.org"
'''


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


def make_assembly(rng, name: str, kind: dict, n_contigs: int, locus: Locus, genome_nt: int) -> Assembly:
    r"""One assembly: ``locus`` with the class's substitutions between random
    flanks, ``genome_nt`` bases in all, cut into contigs by the class's rule."""
    planted = substitute(rng, locus.seq, kind["sub_rate"])
    left = (genome_nt - len(planted)) // 2
    right = genome_nt - len(planted) - left
    genome = np.concatenate([random_codes(rng, left), planted, random_codes(rng, right)])
    starts = _pieces(rng, kind["split"], n_contigs, len(genome), left + len(planted) // 2, kind.get("min_contig_nt", 1))
    text = BASES[genome].tobytes()
    fasta = b"".join(
        b">c%d\n%s\n" % (j + 1, text[starts[j] : starts[j + 1]]) for j in range(len(starts) - 1)
    )
    return Assembly(name, kind["name"], locus, fasta, genome, left, starts)


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
    pool = []
    for i, s in enumerate(order):
        kind, n_contigs = slots[s]
        locus = db.loci[int(rng.integers(0, len(db.loci)))]
        pool.append(make_assembly(rng, f"a{i:03d}", kind, n_contigs, locus, genome_nt))
    return pool


def gene_table(db: SyntheticDatabase) -> dict[bytes, Gene]:
    r"""Every gene of the database by its id, as the program's results name it."""
    return {g.gene_id.encode(): g for locus in db.loci for g in locus.genes}
