r"""The readings that set the limits of ``correct``: the program's and the control's, over many seeds.

    python3 benchmark/control.py --workload kpsc_k.single --seconds 20 --seeds 11 12 13

For each seed, one run of the cell as ``run.py`` makes it (its own window,
its own sample), then the same judgement twice: of the program's outputs,
and of the control's, which is the program's outputs with each hit's
protein identity replaced by the nucleotide identity of the hit (the
protein DP left out, the step a faster change would be tempted to take).
Prints one JSON line a seed and, last, the largest program reading and the
smallest control reading of every number compared.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def readings(root: Path, workload: str, seeds: list[int], seconds: float, device: str) -> dict:
    from kbench.harness import CHECKS, run_cell
    from reference.judge import judge

    per_seed = []
    for seed in seeds:
        t0 = time.perf_counter()
        out = run_cell(root, workload, seed, seconds, False, device, t0)
        control = judge(out.checked, out.genes, out.id_threshold, device, control=True)
        rec = {
            "seed": seed,
            "correct": out.line["correct"],
            "attempted": out.line["attempted"],
            "program": {k: v for k, (v, _) in out.checks.items()},
            "control": control.counts,
            "control_notes": control.notes[:3],
            "program_notes": out.notes[-3:],
        }
        print(json.dumps(rec), flush=True)
        per_seed.append(rec)
    return {
        "workload": workload,
        "seeds": seeds,
        "program_max": {k: max(r["program"][k] for r in per_seed) for k in CHECKS},
        "control_min": {k: min(r["control"][k] for r in per_seed) for k in per_seed[0]["control"]},
        "program_correct": all(r["correct"] for r in per_seed),
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    from run import cell_env

    os.environ.update(cell_env(args.workload))
    from kaptive_tpu_torch.utils.device import require_cuda

    device = str(require_cuda())
    print(json.dumps(readings(ROOT, args.workload, args.seeds, args.seconds, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
