"""The benchmark measures the port alone: no module of perfbench/ but
the one test that holds the reference to the JAX package imports JAX or
the JAX package (compared by whole top-level names: ``repro_torch`` is
the port, ``repro`` the JAX package), a run loads neither, and a run
refuses to print a result without a card or without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_TEST = "test_perfbench_jax_reference.py"


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(p for p in HERE.rglob("*.py") if p.name != JAX_TEST)
    assert len(files) > 20
    for path in files:
        assert not top_level_imports(path) & FORBIDDEN, path
        assert "benchmarks" not in top_level_imports(path), path
    assert "repro" in top_level_imports(HERE / JAX_TEST)
    assert "repro_torch" in top_level_imports(HERE / "deploy.py") | \
        top_level_imports(HERE / "harness.py")


def test_a_run_loads_neither(tmp_path):
    code = ("import json, sys, time\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from perfbench import harness, tiny\n"
            "res = tiny.run('rgw-degraded-read')\n"
            "print(json.dumps([res['correct'], harness.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         stdin=subprocess.DEVNULL, cwd=tmp_path)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def _run(cwd: Path, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "hdfs-repair",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
        stdin=subprocess.DEVNULL)


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _run(ROOT, env)
    assert res.returncode != 0 and res.stdout == ""
    alone = tmp_path / "checkout"
    alone.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    shutil.copytree(HERE, alone / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(alone, env)
    assert res.returncode != 0 and res.stdout == ""
    assert "repro_torch" in res.stderr
