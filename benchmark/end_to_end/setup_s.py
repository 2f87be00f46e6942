r"""Seconds from the process's start to the first timed request: imports, database made and loaded, pool made, warm-up."""


def read(run):
    return run.setup_s
