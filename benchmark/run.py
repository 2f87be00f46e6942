r"""Benchmark of ``kaptive_tpu_torch`` on one card: one run of one cell.

    python3 benchmark/run.py --workload kpsc_k.single --seed 7 --seconds 51 --trace 0

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and, with
``--trace 1``, ``breakdown``), ``checks`` last; the numbers compared, each
beside its limit, are also the last lines of standard error.  Exits with a
code other than 0, printing no result, when there is no card, when the
program is not the checkout's own, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]
# Kernel caches of the program and of PyTorch stay at fixed places in the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def cell_env(workload: str) -> dict[str, str]:
    r"""The environment the cell's mix names (``env``), read before any library starts its threads."""
    try:
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        cell = next(w for w in spec["workloads"] if w["name"] == workload)
        traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    except (OSError, ValueError, StopIteration, KeyError):
        return {}  # the harness reports what is missing
    return {k: str(v) for k, v in traffic.get("env", {}).items()}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.update(cell_env(args.workload))

    import torch

    from kbench.harness import HarnessError, print_outcome, run_cell
    from kbench.modcheck import forbidden_loaded

    try:
        import kaptive_tpu_torch
        from kaptive_tpu_torch.utils.device import require_cuda

        if not Path(kaptive_tpu_torch.__file__).resolve().is_relative_to(ROOT):
            raise HarnessError(f"kaptive_tpu_torch comes from {kaptive_tpu_torch.__file__}, not this checkout")
        device = require_cuda()
        if torch.cuda.device_count() < 1:
            raise HarnessError("no CUDA device")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        print(f"# host CPUs {os.cpu_count()}; card {smi.stdout.strip() or torch.cuda.get_device_name(device)}",
              file=sys.stderr, flush=True)
        out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), str(device), T_PROCESS)
        found = forbidden_loaded()
        if found:
            raise HarnessError(f"forbidden modules were loaded: {', '.join(found)}")
    except HarnessError as exc:
        print(f"benchmark: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    print_outcome(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
