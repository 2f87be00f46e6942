r"""Command line of the port: ``kaptive-tpu-torch {db,type,convert}``.

The JAX package's command framework (:class:`kaptive_tpu.cli.Cli`), its
``db`` and ``convert`` commands and its output writers are reused as they are;
``type`` is the port's (:mod:`kaptive_tpu_torch.serotyping.cli`).  Run as the
``kaptive-tpu-torch`` console script or ``python -m kaptive_tpu_torch.cli``::

    python -m kaptive_tpu_torch.cli type db.gbk a.fasta b.fasta -o out.tsv            # on the card
    python -m kaptive_tpu_torch.cli type db.gbk a.fasta --device cpu -o out.tsv       # plain PyTorch

The port is imported before anything of :mod:`kaptive_tpu`, so the process
never imports jax.
"""

from __future__ import annotations

import kaptive_tpu_torch  # noqa: F401  (first: keeps the JAX package's jax imports out)
from kaptive_tpu.cli import Cli


def main() -> None:
    r"""Entry point for the ``kaptive-tpu-torch`` console script."""
    from kaptive_tpu.db.cli import Database
    from kaptive_tpu.serotyping.cli import Convert

    from kaptive_tpu_torch.serotyping.cli import Type

    with Cli(
        description="🦠 kaptive-tpu-torch: in silico serotyping of surface antigen loci on an NVIDIA GPU.",
        epilog="📚 The PyTorch/CUDA port of kaptive-tpu, with the capabilities of Kaptive 3.",
    ) as app:
        for command_cls in (Database, Type, Convert):
            app.mount(command_cls())
        app.dispatch()


if __name__ == "__main__":
    main()
