#!/usr/bin/env python3
"""Generate polychase_tpu_torch/polychase_core.pyi from the port's live
``polychase_core`` by introspection.

The class and signature writers are those of ``scripts/generate_stubs.py``
(the JAX package's generator), loaded from its file; only the module
introspected and the output path differ.  Nothing here imports jax.

Run from the repo root:  python scripts/generate_stubs_torch.py
The stub is checked in; tests/test_torch_packaging.py asserts that it stays
in sync with the module's ``__all__``.
"""

import importlib.util
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "polychase_tpu_torch", "polychase_core.pyi")


def _writers():
    spec = importlib.util.spec_from_file_location(
        "_generate_stubs", os.path.join(ROOT, "scripts", "generate_stubs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._sig, mod._class_stub


def main() -> str:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import polychase_tpu_torch.polychase_core as pc

    sig, class_stub = _writers()
    out = [
        '"""Typing stubs for the port\'s polychase_core (generated — do not '
        'edit).',
        "",
        "Regenerate with:  python scripts/generate_stubs_torch.py",
        '"""',
        "",
        "from enum import Enum",
        "from typing import Any",
        "",
        "import numpy as np",
        "",
    ]
    for name in sorted(pc.__all__):
        obj = getattr(pc, name)
        if inspect.isclass(obj):
            class_stub(name, obj, out)
        elif callable(obj):
            out.append(f"def {name}{sig(obj)}: ...")
            out.append("")
        else:
            out.append(f"{name}: Any")
            out.append("")
    return "\n".join(out).rstrip() + "\n"


if __name__ == "__main__":
    text = main()
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT} ({len(text.splitlines())} lines)")
