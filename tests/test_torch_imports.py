"""The port stands alone: importing every module of src/repro_torch/ pulls
in neither JAX nor any module of the reference package, and chip_smoke.py
imports neither.  Checked in a fresh interpreter, so nothing this test
process already imported can hide an edge."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax_or_reference():
    mods = port_modules()
    assert len(mods) >= 30 and "repro_torch.store.object_store" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True, stdin=subprocess.DEVNULL)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_names(tree: ast.AST) -> set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_chip_smoke_imports_neither():
    names = _imported_names(ast.parse((ROOT / "chip_smoke.py").read_text()))
    assert "repro_torch.store" in names and "torch" in names
    assert not any(n == "jax" or n.startswith(("jax.", "repro."))
                   or n == "repro" for n in names), sorted(names)


def test_port_sources_import_neither():
    for path in sorted(PORT.rglob("*.py")):
        names = _imported_names(ast.parse(path.read_text()))
        assert not any(n == "jax" or n.startswith(("jax.", "repro."))
                       or n == "repro" for n in names), (path, names)
