"""Phenotype rules that fire and extra genes that are found: the port against the JAX package.

On ``o_panel``'s O-shaped database and assemblies (variant loci, an ``Extra
genes`` record of two genes planted away from the locus on either strand and
across a contig break, a ``wzm`` knockout, four rules with ``α``/``β`` in their
names), both packages compile the same GenBank and TOML bytes and type the
same FASTA bytes; the port runs on the CPU.  Exact:
``SerotypingResult.to_dict()``, the ``Extra genes, details`` cells and the
whole ``KaptiveRow`` bytes, host- and device-seeded; and each phenotype is the
one the benchmark's plain reference (``benchmark/reference/phenotype.py``)
works out from what was planted.
"""

import io

import pytest
import torch
from o_panel import CONFIG, WANT, make_o_panel
from reference.phenotype import expected_phenotypes
from typing_panel import assert_same

from kaptive_tpu.serotyping.io import KaptiveRow as JaxRow

from kaptive_tpu_torch.serotyping.io import KaptiveRow

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    from kaptive_tpu.db import Database as JaxDatabase

    from kaptive_tpu_torch.db import Database

    db, pool, gbk = make_o_panel(tmp_path_factory.mktemp("o_panel"))
    return db, pool, Database.from_genbank(gbk), JaxDatabase.from_genbank(gbk)


def _jax_results(panel, mode):
    from kaptive_tpu.core.genome import GenomeAssembly
    from kaptive_tpu.serotyping import Serotyper

    _, pool, _, jax_db = panel
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAPTIVE_SEED_MODE", mode)
        return Serotyper(jax_db).batch([GenomeAssembly.from_stream(io.BytesIO(a.fasta), a.name) for a in pool])


def _port_results(panel, mode):
    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.serotyping import Serotyper

    _, pool, port_db, _ = panel
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAPTIVE_SEED_MODE", mode)
        return Serotyper(port_db, device="cpu").batch(
            [GenomeAssembly.from_stream(io.BytesIO(a.fasta), a.name) for a in pool]
        )


@pytest.fixture(scope="module")
def results(panel):
    r"""``{mode: (port results, JAX results)}`` for host and device seeding."""
    return {mode: (_port_results(panel, mode), _jax_results(panel, mode)) for mode in ("host", "device")}


def test_the_panel_plants_what_each_rule_asks_for(panel):
    db, pool, port_db, _ = panel
    assert expected_phenotypes(pool, db, CONFIG) == WANT
    assert int(port_db.extra_genes.sum()) == 2 and port_db.loci.ids[-1] == "Extra_genes"
    assert pool[2].extras[0].start < int(pool[2].contig_starts[1]) < pool[2].extras[0].end  # cut
    assert {g.strand for a in pool for g in a.extras} == {1, -1}


@pytest.mark.parametrize("mode", ["host", "device"])
def test_rows_equal_jax_where_the_rules_fire(results, mode):
    got, want = results[mode]
    assert [r.phenotype for r in want] == WANT
    for g, w in zip(got, want, strict=True):
        assert_same(g.to_dict(), w.to_dict(), f"result[{w.genome}]")
        assert bytes(KaptiveRow.from_result(g)) == bytes(JaxRow.from_result(w))


@pytest.mark.parametrize("mode", ["host", "device"])
def test_extra_genes_details_equal_jax_and_name_every_planted_gene(panel, results, mode):
    _, pool, _, _ = panel
    got, want = results[mode]
    for asm, g, w in zip(pool, got, want, strict=True):
        cell = KaptiveRow.from_result(g).Extra_genes_details
        assert cell == JaxRow.from_result(w).Extra_genes_details
        named = {entry.split(b",")[0] for entry in cell.split(b";") if entry}
        assert named == {x.cluster.encode() for x in asm.extras}, asm.name


def test_host_and_device_seeding_give_the_same_rows(results):
    host, device = results["host"][0], results["device"][0]
    assert [bytes(KaptiveRow.from_result(r)) for r in host] == [bytes(KaptiveRow.from_result(r)) for r in device]


def test_phenotypes_are_the_references_and_utf8_names_reach_the_row(panel, results):
    db, pool, _, _ = panel
    got = results["host"][0]
    assert [r.phenotype for r in got] == expected_phenotypes(pool, db, CONFIG)
    assert [r.best_locus_name for r in got] == [a.locus.name for a in pool]
    row = bytes(KaptiveRow.from_result(got[2]))
    assert "OL2α.1".encode() in row and "O1αβ,2β".encode() in row


def test_a_chance_match_of_an_extra_gene_is_not_listed(panel):
    r"""A 40-base piece of ``wbbY`` (7% of it) in the flank of an assembly that carries no ``wbbY``:
    the port drops the hit, the JAX package lists ``wbbY`` as truncated (ROADMAP, Queue A, F11);
    every other column of the row but the truncated genes' is the same."""
    import numpy as np
    from o_panel import gen

    from kaptive_tpu.core.genome import GenomeAssembly as JaxAssembly
    from kaptive_tpu.serotyping import Serotyper as JaxSerotyper

    from kaptive_tpu_torch.core.genome import GenomeAssembly
    from kaptive_tpu_torch.serotyping import Serotyper

    db, pool, port_db, jax_db = panel
    asm = pool[5]  # OL4, carrying wbbZ only
    wbby = next(g for g in db.extra if g.cluster == "wbbY")
    genome = asm.genome.copy()
    genome[1000:1040] = gen.to_codes(wbby.orf[300:340])  # wbbZ lies at 2000-2450
    fasta = b">c1\n%s\n>c2\n%s\n" % tuple(
        gen.BASES[genome[a:b]].tobytes() for a, b in zip(asm.contig_starts[:-1], asm.contig_starts[1:])
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAPTIVE_SEED_MODE", "host")
        [got] = Serotyper(port_db, device="cpu").batch([GenomeAssembly.from_stream(io.BytesIO(fasta), "chance")])
        [want] = JaxSerotyper(jax_db).batch([JaxAssembly.from_stream(io.BytesIO(fasta), "chance")])
    got_row, want_row = KaptiveRow.from_result(got), JaxRow.from_result(want)
    assert want_row.Extra_genes_details.startswith(b"wbbY,") and b"wbbY" in want_row.Extra_genes_details
    assert got_row.Extra_genes_details == b"wbbZ,100.00%,99.33%"
    assert [e for e in want_row.Extra_genes_details.split(b";") if not e.startswith(b"wbbY,")] == [
        got_row.Extra_genes_details
    ]
    assert got_row.Truncated_genes_details == b"" and want_row.Truncated_genes_details.startswith(b"wbbY,")
    for column in KaptiveRow.COLUMNS:
        if column not in ("Extra_genes_details", "Truncated_genes_details"):
            assert getattr(got_row, column) == getattr(want_row, column), column
    assert int(np.count_nonzero(got.gene_hits.is_extra)) == 1
