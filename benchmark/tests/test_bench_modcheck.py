r"""The module check compares top-level names whole: the JAX package fails, the port passes."""

from __future__ import annotations

import subprocess
import sys

from conftest import BENCH, ROOT

from kbench.modcheck import forbidden_loaded


def test_rejects_jax_and_the_jax_package_and_accepts_the_port():
    assert forbidden_loaded(["kaptive_tpu"]) == ["kaptive_tpu"]
    assert forbidden_loaded(["kaptive_tpu.ops.swg", "numpy"]) == ["kaptive_tpu"]
    assert forbidden_loaded(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_loaded(["kaptive_tpu_torch", "kaptive_tpu_torch.ops.swg", "jaxtyping", "kaptive_tpux"]) == []


def test_the_harness_and_the_reference_load_no_forbidden_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]; "
        "import kbench.harness, kbench.gen, kbench.trace, reference.judge, reference.align; "
        "import kaptive_tpu_torch.serotyping, kaptive_tpu_torch.parallel.pipeline; "
        "from kbench.modcheck import forbidden_loaded; print(forbidden_loaded())"
    ) % (str(BENCH), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_no_harness_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in {"jax", "jaxlib", "flax", "kaptive_tpu"}, (path, line)
