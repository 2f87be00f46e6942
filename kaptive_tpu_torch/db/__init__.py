r"""Reference database: compile (GenBank+TOML -> packed SoA), cache, lifecycle.

Capability parity with ``kaptive/db``.
"""

from kaptive_tpu_torch.db.core import Database
from kaptive_tpu_torch.db.manager import DatabaseManager
from kaptive_tpu_torch.db.models import DatabaseError, DatabaseMetadata, Phenotype, Phenotypes

__all__ = [
    "Database",
    "DatabaseError",
    "DatabaseManager",
    "DatabaseMetadata",
    "Phenotype",
    "Phenotypes",
]
