"""The port's public API is the JAX package's: every name, and every call binds the same.

For every public function, class and method of every ``kaptive_tpu/**/*.py``,
read with ``ast`` (the JAX package is never imported here), the port's module
of the same relative path is imported and read with ``inspect.signature``, so
re-exports count.  Four rules:

1. the port has the name;
2. every JAX parameter exists there by name;
3. a parameter that JAX lets a caller pass by position sits at the same index
   in the port, or is keyword-only there: a positional call in the JAX order
   then binds the same or raises, and never misbinds;
4. every port-only parameter is keyword-only, or comes after all of JAX's,
   and has a default.

A class is read as its constructor (an explicit ``__init__``, or the fields of
a dataclass or ``NamedTuple``); a package's ``__init__.py`` re-exports count
as its names.  ``ops/scan_pallas.py`` and
``ops/swg_pallas.py`` have no same-named port module: :data:`MODULE_MAP`
names where their contents live.

Every difference that stays is one row of :data:`EXCEPTIONS`: the JAX name,
what the port does instead, and the reason, which is an item of
``ROADMAP.md``'s "Code not to port" or a device program whose signature takes
``jax.Array``s.  A row that no longer matches a difference fails the test, so
the table cannot outlive what it excuses.
"""

from __future__ import annotations

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "kaptive_tpu"

# JAX module (relative path) -> the port's modules that hold its contents, searched in order.
MODULE_MAP = {
    "ops/scan_pallas.py": ("ops.scan", "ops.scan_cuda"),
    "ops/swg_pallas.py": ("ops.swg", "ops.swg_cuda"),
}

# The two reasons a difference may stay.
NOT_TO_PORT = "ROADMAP.md, Code not to port"
DEVICE_PROGRAM = "a device program whose signature takes jax.Arrays"

# "module:qualname" -> (what the port does instead, reason).  A row excuses every gap of that name.
EXCEPTIONS = {
    # Device programs: the JAX signature passes the arrays of a jitted or shard_map'd program.
    "parallel/screen.py:locus_screen_batch": (
        "locus_screen_batch(codes, tables, n_genes): a (B, L) tensor and the ScreenTables, on the codes' device",
        f"{DEVICE_PROGRAM} (the jitted screen over the five table arrays)",
    ),
    "parallel/typing.py:sharded_scan_match_chain": (
        "sharded_scan_match_chain(mesh, indexes, table, gene_index, params, *, length): the mesh's rows "
        "unpack, scan, match and chain through ops/mapper.py::seed_chunk",
        f"{DEVICE_PROGRAM} (the shard_map'd scan, match and chain over packed arrays and static capacities)",
    ),
    "ops/swg.py:banded_swg_lax_cigars": (
        "banded_swg_cigars_plain: the run capacity is the constant MAX_CIGAR_OPS, which the CIGAR kernel "
        "compiles in",
        f"{DEVICE_PROGRAM} (cap_ops sizes the XLA while-loop's run buffer, a jit static)",
    ),
    # The interpret-mode switch and the Pallas -> XLA degrade choose between TPU implementations.
    "ops/swg.py:banded_swg": (
        "no `impl` switch: a CUDA tensor runs the Hopper kernels, a CPU tensor the plain form",
        f"{NOT_TO_PORT}: the interpret-mode switch and the Pallas -> XLA degrade",
    ),
    "ops/scan_pallas.py:default_device_is_tpu": (
        "none: a tensor's device picks the path",
        f"{NOT_TO_PORT}: the Pallas -> XLA degrade and KAPTIVE_SCAN_IMPL",
    ),
    "ops/scan_pallas.py:supports_pallas_scan": (
        "none: the Hopper scan takes any row count",
        f"{NOT_TO_PORT}: the Pallas -> XLA degrade and KAPTIVE_SCAN_IMPL",
    ),
    "ops/scan_pallas.py:rowcompact_scan_xla": (
        "ops/scan.py::rowcompact_scan_plain (CPU) and rowcompact_scan (the front door)",
        f"{NOT_TO_PORT}: the Pallas -> XLA degrade and KAPTIVE_SCAN_IMPL",
    ),
    "ops/scan_pallas.py:pad_codes_for_scan": (
        "ops/scan.py::pad_codes_for_scan_any (any multiple of 128 rows)",
        f"{NOT_TO_PORT}: jit-key padding (the Pallas kernel's multiple of its 1024-row tile)",
    ),
    "ops/scan_pallas.py:compact_lanes": (
        "ops/scan.py::compact_lanes(selected, payloads, out_slots): a rank-by-cumsum scatter over the last axis",
        f"{DEVICE_PROGRAM} (the Pallas butterfly network over `lanes` of a VMEM tile)",
    ),
    "ops/scan_pallas.py:rowcompact_scan_tpu": (
        "ops/scan.py::rowcompact_scan -> ops/scan_cuda.py::rowcompact_scan_cuda (csrc/scan.cu)",
        f"{DEVICE_PROGRAM} (the Pallas launch)",
    ),
    "ops/swg_pallas.py:banded_swg_pallas": (
        "ops/swg.py::banded_swg -> ops/swg_cuda.py (csrc/swg.cu)",
        f"{DEVICE_PROGRAM} (the Pallas launch)",
    ),
    "ops/swg_pallas.py:pallas_compatible": (
        "none: the Hopper fill takes every band width and every int32 matrix (warp, wide, cluster and segmented forms)",
        f"{NOT_TO_PORT}: the Pallas -> XLA degrade",
    ),
    "ops/swg_pallas.py:pairs_for": (
        "ops/swg.py::SwgLattice (the lattice's pair batch)",
        f"{NOT_TO_PORT}: jit-key padding (pairs a Pallas grid step)",
    ),
    "ops/swg_pallas.py:compress_matrix": (
        "ops/swg_cuda.py::as_kernel_matrix (the full matrix: int8 in shared memory, or int32 in device memory)",
        f"{DEVICE_PROGRAM} (the Pallas kernel's compressed VMEM score table)",
    ),
    "ops/swg_pallas.py:compress_matrix_cached": (
        "ops/swg_cuda.py::as_kernel_matrix",
        f"{DEVICE_PROGRAM} (the Pallas kernel's compressed VMEM score table)",
    ),
    # The set of compiled DP shapes: eager PyTorch compiles no program per shape.
    "utils/metrics.py:record_shape": (
        "none: the work a sweep launches is counted per span (dp.cells_launched, utils/profiling.py)",
        f"{NOT_TO_PORT}: the compiled-shape set",
    ),
    "utils/metrics.py:shapes": (
        "none: the port compiles no program per shape",
        f"{NOT_TO_PORT}: the compiled-shape set",
    ),
    "utils/metrics.py:reset_metrics": (
        "reset_metrics(): every counter cleared; there is no compiled-shape set to keep",
        f"{NOT_TO_PORT}: the compiled-shape set",
    ),
}


# ---------------------------------------------------------------------------- the JAX side, by ast


class Param:
    __slots__ = ("name", "kind", "has_default")

    def __init__(self, name: str, kind, has_default: bool) -> None:
        self.name, self.kind, self.has_default = name, kind, has_default


P = inspect.Parameter


def _ast_params(fn: ast.FunctionDef | ast.AsyncFunctionDef, drop_first: bool) -> list[Param]:
    a = fn.args
    positional = [*a.posonlyargs, *a.args]
    n_default = len(a.defaults)
    out = []
    for i, arg in enumerate(positional):
        kind = P.POSITIONAL_ONLY if i < len(a.posonlyargs) else P.POSITIONAL_OR_KEYWORD
        out.append(Param(arg.arg, kind, i >= len(positional) - n_default))
    if a.vararg:
        out.append(Param(a.vararg.arg, P.VAR_POSITIONAL, True))
    for arg, default in zip(a.kwonlyargs, a.kw_defaults):
        out.append(Param(arg.arg, P.KEYWORD_ONLY, default is not None))
    if a.kwarg:
        out.append(Param(a.kwarg.arg, P.VAR_KEYWORD, True))
    return out[1:] if drop_first else out


def _decorators(node) -> set[str]:
    names = set()
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        names.add(d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", ""))
    return names


def _kw_only(cls: ast.ClassDef) -> bool:
    for d in cls.decorator_list:
        if isinstance(d, ast.Call) and any(
            kw.arg == "kw_only" and getattr(kw.value, "value", False) is True for kw in d.keywords
        ):
            return True
    return False


def _field_params(cls: ast.ClassDef, classes: dict[str, ast.ClassDef]) -> list[Param]:
    r"""The constructor of a dataclass or NamedTuple: the fields of its bases of the same module,
    then its own annotated fields, in order."""
    out = []
    for b in cls.bases:
        if isinstance(b, ast.Name) and b.id in classes:
            out.extend(_field_params(classes[b.id], classes))
    kind = P.KEYWORD_ONLY if _kw_only(cls) else P.POSITIONAL_OR_KEYWORD
    for st in cls.body:
        if not isinstance(st, ast.AnnAssign) or not isinstance(st.target, ast.Name):
            continue
        if "ClassVar" in ast.unparse(st.annotation):
            continue
        v = st.value
        if isinstance(v, ast.Call) and getattr(v.func, "id", "") in ("field", "soa"):
            if any(kw.arg == "init" and getattr(kw.value, "value", True) is False for kw in v.keywords):
                continue
            has_default = any(kw.arg in ("default", "default_factory") for kw in v.keywords)
        else:
            has_default = v is not None
        out.append(Param(st.target.id, kind, has_default))
    return out


def _public(name: str) -> bool:
    return not name.startswith("_")


def jax_api() -> list[tuple[str, str, str, list[Param] | None]]:
    r"""``(relative path, qualname, kind, params)`` for every public function, class and method
    of the JAX package; ``params`` is None where there is no signature to hold (a property, a
    class without a constructor of its own)."""
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        tree = ast.parse(path.read_text())
        classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and path.name == "__init__.py" and node.level == 0:
                # A package's re-exports are its API; their signatures are held where they are defined.
                out.extend((rel, a.asname or a.name, "re-export", None) for a in node.names
                           if _public(a.asname or a.name) and (node.module or "").startswith("kaptive_tpu"))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
                out.append((rel, node.name, "function", _ast_params(node, False)))
            elif isinstance(node, ast.ClassDef) and _public(node.name):
                bases = {ast.unparse(b) for b in node.bases}
                init = next((n for n in node.body if isinstance(n, ast.FunctionDef) and n.name == "__init__"), None)
                if init is not None:
                    params = _ast_params(init, True)
                elif "dataclass" in _decorators(node) or "NamedTuple" in bases:
                    params = _field_params(node, classes)
                else:
                    params = None
                out.append((rel, node.name, "class", params))
                for m in node.body:
                    if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) or not _public(m.name):
                        continue
                    decos = _decorators(m)
                    if "property" in decos or "cached_property" in decos:
                        out.append((rel, f"{node.name}.{m.name}", "property", None))
                    else:
                        out.append((rel, f"{node.name}.{m.name}", "method",
                                    _ast_params(m, "staticmethod" not in decos)))
    return out


# ---------------------------------------------------------------------------- the port, by inspect


def port_modules(rel: str) -> list:
    names = MODULE_MAP.get(rel)
    if names is None:
        stem = rel[: -len(".py")].replace("/", ".")
        names = ("" if stem == "__init__" else stem.removesuffix(".__init__"),)
    return [importlib.import_module("kaptive_tpu_torch" + (f".{n}" if n else "")) for n in names]


def _resolve(mods: list, qualname: str):
    for mod in mods:
        obj, owner = mod, None
        for part in qualname.split("."):
            owner, obj = obj, inspect.getattr_static(obj, part, None)
            if obj is None:
                break
        else:
            return owner, obj
    return None, None


def port_params(owner, obj, kind: str) -> list[Param]:
    if kind == "class":
        sig = inspect.signature(obj)
    elif isinstance(obj, staticmethod):
        sig = inspect.signature(obj.__func__)
    elif isinstance(obj, classmethod):
        sig = inspect.signature(obj.__func__)
        sig = sig.replace(parameters=list(sig.parameters.values())[1:])
    elif kind == "method":
        sig = inspect.signature(obj)
        sig = sig.replace(parameters=list(sig.parameters.values())[1:])
    else:
        sig = inspect.signature(obj)
    return [Param(p.name, p.kind, p.default is not P.empty or p.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD))
            for p in sig.parameters.values()]


def binding_gaps(jax: list[Param], port: list[Param]) -> list[str]:
    r"""What breaks rules 2-4 for one signature (rule 1 is the caller's)."""
    gaps = []
    by_name = {p.name: (i, p) for i, p in enumerate(port)}
    port_var_kw = any(p.kind is P.VAR_KEYWORD for p in port)
    positional = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)
    for i, p in enumerate(jax):
        if p.kind is P.VAR_POSITIONAL:
            if not any(q.kind is P.VAR_POSITIONAL for q in port):
                gaps.append(f"*{p.name}: the port takes no extra positional arguments")
            continue
        if p.kind is P.VAR_KEYWORD:
            if not port_var_kw:
                gaps.append(f"**{p.name}: the port takes no extra keywords")
            continue
        if p.name not in by_name:
            if not (p.kind is P.KEYWORD_ONLY and port_var_kw):
                gaps.append(f"{p.name}: missing")
            continue
        j, q = by_name[p.name]
        if p.kind in positional and q.kind is not P.KEYWORD_ONLY and j != i:
            gaps.append(f"{p.name}: position {i} in JAX, {j} in the port")
        if p.kind in positional and q.kind is P.POSITIONAL_ONLY and p.kind is not P.POSITIONAL_ONLY:
            gaps.append(f"{p.name}: positional-only in the port")
        if p.has_default and not q.has_default:
            gaps.append(f"{p.name}: has a default in JAX, none in the port")
    jax_names = {p.name for p in jax}
    last_jax = max((by_name[p.name][0] for p in jax if p.name in by_name), default=-1)
    for j, q in enumerate(port):
        if q.name in jax_names or q.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD):
            continue
        if q.kind is not P.KEYWORD_ONLY and j < last_jax:
            gaps.append(f"{q.name}: port-only, positional before a JAX parameter")
        if not q.has_default:
            gaps.append(f"{q.name}: port-only without a default")
    return gaps


def api_gaps() -> dict[str, list[str]]:
    r"""``"module:qualname" -> [gaps]`` over the whole JAX package."""
    out: dict[str, list[str]] = {}
    for rel, qualname, kind, params in jax_api():
        key = f"{rel}:{qualname}"
        owner, obj = _resolve(port_modules(rel), qualname)
        if obj is None:
            out[key] = ["missing"]
            continue
        if kind == "property":
            # A JAX property may be a port method (the port's accessors name a device):
            # then it has to be callable with no argument.
            if inspect.isfunction(obj) and any(not p.has_default for p in port_params(owner, obj, "method")):
                out[key] = ["a property in JAX, a method with a required parameter in the port"]
            continue
        if params is None:
            continue
        gaps = binding_gaps(params, port_params(owner, obj, kind))
        if gaps:
            out[key] = gaps
    return out


# ---------------------------------------------------------------------------- the tests


def test_every_jax_call_binds_the_same_in_the_port():
    gaps = api_gaps()
    unexcused = {k: v for k, v in gaps.items() if k not in EXCEPTIONS}
    assert not unexcused, "port API gaps:\n" + "\n".join(f"  {k}: {'; '.join(v)}" for k, v in sorted(unexcused.items()))


def test_every_exception_row_excuses_a_real_gap():
    gaps = api_gaps()
    stale = sorted(k for k in EXCEPTIONS if k not in gaps)
    assert not stale, f"rows that excuse nothing: {stale}"


def test_every_exception_row_names_a_reason_and_a_replacement():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert "Code not to port" in roadmap
    for key, (instead, reason) in EXCEPTIONS.items():
        assert instead.strip(), key
        assert reason.startswith((NOT_TO_PORT, DEVICE_PROGRAM)), (key, reason)
        assert "not needed" not in (instead + reason).lower(), key


def test_the_walk_sees_the_whole_jax_package():
    api = jax_api()
    modules = {rel for rel, *_ in api}
    assert {"ops/minimizer.py", "parallel/pipeline.py", "core/pairwise.py", "ops/scan_pallas.py"} <= modules
    names = {f"{rel}:{q}" for rel, q, *_ in api}
    assert "ops/minimizer.py:minimizer_scan" in names
    assert "ops/minimizer.py:ContigIndex.device_codes" in names
    assert "serotyping/core.py:Serotyper" in names
    assert "parallel/screen.py:ScreenTables.from_database" in names


@pytest.mark.parametrize(
    ("jax", "port", "expect"),
    [
        # The F3 shape: a JAX parameter dropped in the port shifts the next one.
        (["a", "b", "prefetch=2", "workers=None"], ["a", "b", "workers=None"], "position 3 in JAX, 2"),
        # A port-only parameter placed before a JAX one.
        (["a", "mesh=None", "lattice=None"], ["a", "lattice=None", "device=None", "mesh=None"], "position"),
        (["a"], ["a", "b"], "port-only without a default"),
        (["a", "b=1"], ["a", "b"], "has a default in JAX"),
        (["a", "b"], ["a", "*", "b", "c=1"], None),
        (["a", "b"], ["a", "b", "c=1", "*", "d=2"], None),
    ],
)
def test_the_binding_rule(jax, port, expect):
    def params(spec):
        out, kw = [], False
        for s in spec:
            if s == "*":
                kw = True
                continue
            name, _, default = s.partition("=")
            out.append(Param(name, P.KEYWORD_ONLY if kw else P.POSITIONAL_OR_KEYWORD, bool(default)))
        return out

    gaps = binding_gaps(params(jax), params(port))
    if expect is None:
        assert gaps == []
    else:
        assert any(expect in g for g in gaps), gaps
