r"""What ``run.py`` does about the card: no result without one; on one, a tiny cell's control readings."""

from __future__ import annotations

import subprocess
import sys

import pytest
from conftest import ROOT


def test_no_card_means_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", "kpsc_k.single",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card(tiny_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import control

    r = control.readings(tiny_root, "tiny.single", [2**31 + 1, 2**31 + 2, 2**31 + 3], 4.0, "cuda")
    assert r["program_correct"]
    assert r["control_min"]["pident_off"] > 0
