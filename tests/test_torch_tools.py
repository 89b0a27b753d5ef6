"""The port's compare tools (``polychase_tpu_torch/*_compare.py``) and its
route tables (``polychase_tpu_torch/crossover.py``) run only on a CUDA
card, so no test runs them; these tests read each tool's source and
check that every name it imports from ``chip_smoke.py`` or the port, and
every attribute it takes from a module it imported, exists on the CPU.  A
rename in ``chip_smoke.py`` or the port that a tool missed fails here.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "polychase_tpu_torch"
TOOLS = sorted([p.stem for p in (ROOT / PACKAGE).glob("*_compare.py")]
               + ["crossover"])


def _chip_smoke() -> types.ModuleType:
    mod = sys.modules.get("chip_smoke")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return mod


def _module(name: str) -> types.ModuleType:
    return _chip_smoke() if name == "chip_smoke" else importlib.import_module(
        name)


def _absolute(node: ast.ImportFrom) -> str:
    if not node.level:
        return node.module
    base = PACKAGE.rsplit(".", node.level - 1)[0]
    return f"{base}.{node.module}" if node.module else base


def _bound_names(tree: ast.AST) -> set:
    """Names the source assigns or takes as arguments anywhere: an alias
    of the same name may be shadowed there, so its attributes go
    unchecked."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, ast.arg):
            out.add(node.arg)
    return out


def _fallbacks(tree: ast.AST) -> set:
    """The import nodes in the handlers of ``try: ... except ImportError``:
    a tool's fallback for an older checkout, which this one need not
    satisfy."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try):
            for h in node.handlers:
                if (isinstance(h.type, ast.Name)
                        and h.type.id in ("ImportError",
                                          "ModuleNotFoundError")):
                    out |= {id(n) for b in h.body for n in ast.walk(b)}
    return out


def test_the_tools_are_found():
    assert {"crossover", "k1_compare", "k5_compare", "k6_compare",
            "refine_compare", "segments_compare"} <= set(TOOLS)


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_names_resolve(tool):
    """Every ``import``/``from ... import`` of chip_smoke or the port in the
    tool resolves, and so does every ``alias.attr`` on a module alias
    (outside a fallback for older checkouts)."""
    tree = ast.parse((ROOT / PACKAGE / f"{tool}.py").read_text())
    aliases, missing = {}, []
    fallbacks = _fallbacks(tree)
    for node in ast.walk(tree):
        if id(node) in fallbacks:
            continue
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "chip_smoke" or a.name.startswith(PACKAGE):
                    _module(a.name)
                    aliases[a.asname or a.name] = a.name
        elif isinstance(node, ast.ImportFrom):
            src = _absolute(node)
            if src != "chip_smoke" and not src.startswith(PACKAGE):
                continue
            mod = _module(src)
            for a in node.names:
                if hasattr(mod, a.name):
                    value = getattr(mod, a.name)
                else:
                    try:
                        value = importlib.import_module(f"{src}.{a.name}")
                    except ModuleNotFoundError:
                        missing.append(f"{src}.{a.name}")
                        continue
                if isinstance(value, types.ModuleType):
                    aliases[a.asname or a.name] = value.__name__
    shadowed = _bound_names(tree)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in aliases
                and node.value.id not in shadowed
                and not hasattr(_module(aliases[node.value.id]), node.attr)):
            missing.append(f"{aliases[node.value.id]}.{node.attr} "
                           f"(line {node.lineno})")
    assert not missing, f"{tool} names what does not exist: {missing}"
