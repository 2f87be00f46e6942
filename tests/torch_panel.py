"""Both packages' sides of the typing panel, each built from the same bytes.

``make_typing_panels`` compiles the panel's GenBank file once with each
package's ``Database.from_genbank`` and parses each genome's FASTA bytes once
with each package's ``GenomeAssembly``, so no object of one package is handed
to the other.  ``carried_database`` takes the other road: it pickles the JAX
package's database and loads it as the port's through ``loads_reference``.
"""

import io
import pickle
from dataclasses import dataclass

from typing_panel import make_typing_panel


@dataclass(frozen=True)
class TypingPanels:
    db: object  # kaptive_tpu_torch Database
    assemblies: list  # kaptive_tpu_torch GenomeAssembly
    jax_db: object  # kaptive_tpu Database
    jax_assemblies: list  # kaptive_tpu GenomeAssembly

    @property
    def gene_names(self) -> tuple:
        return tuple(str(i) for i in range(len(self.db.genes)))


def both_assemblies(fasta: bytes, name: str):
    """``(port assembly, JAX assembly)`` parsed from the same FASTA bytes."""
    from kaptive_tpu.core.genome import GenomeAssembly as JaxAssembly

    from kaptive_tpu_torch.core.genome import GenomeAssembly

    return (GenomeAssembly.from_stream(io.BytesIO(fasta), name),
            JaxAssembly.from_stream(io.BytesIO(fasta), name))


def carried_database(jax_db):
    """The port's ``Database`` carried across from the JAX package's by its pickle."""
    from kaptive_tpu_torch.utils.state import loads_reference

    return loads_reference(pickle.dumps(jax_db))


def make_typing_panels(tmp_path) -> TypingPanels:
    """The seed-5 typing panel on both sides: each package compiles the same
    GenBank file and parses the same FASTA bytes."""
    from kaptive_tpu_torch.db import Database

    jax_db, genomes = make_typing_panel(tmp_path)
    db = Database.from_genbank(next(tmp_path.glob("*.gbk")))
    pairs = [both_assemblies(fasta, name) for name, fasta in genomes]
    return TypingPanels(db, [p for p, _ in pairs], jax_db, [j for _, j in pairs])
