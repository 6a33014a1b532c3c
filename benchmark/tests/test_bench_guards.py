"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
no port code in the references. Checked by a scan of every file, and in a
process that runs a cell and then looks at ``sys.modules``."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
BANNED = {"jax", "jaxlib", "flax", "symphonia_tpu"}


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args and (
                isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


FILES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert "symphonia_tpu_torch" not in tops
    assert tops <= {"__future__", "hashlib", "numpy", "torch"}


def test_a_run_loads_no_jax(small_root):
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark import harness
r = harness.run("librispeech_flac.bulk", 9, 0.5, False, time.perf_counter(),
                device="cpu", root=Path({str(small_root)!r}))
assert r["correct"], r
bad = harness.banned_modules()
print("BANNED", bad)
sys.exit(1 if bad else 0)
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "BANNED []" in p.stdout


def test_banned_names_are_whole(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "symphonia_tpu_torch_like", object())
    assert "symphonia_tpu_torch_like" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.banned_modules() == ["jax.numpy"]
