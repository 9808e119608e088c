"""The benchmark loads neither JAX nor the JAX package, its reference
loads nothing of the program, and ``run.py`` refuses to run without a
card.  Module names are compared by their whole top-level name:
``repro_torch`` is not ``repro``."""
import ast
import os
import subprocess
import sys

import pytest

from chipbench import harness

HERE = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    """Top-level names of every module a file imports (relative imports
    as ``.``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
            if node.module == "chipbench" or (node.module or "").startswith("chipbench."):
                names |= {f"chipbench.{a.name}" for a in node.names}
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert "repro_torch" not in names
    assert {n for n in names if n.startswith("chipbench.")} <= {"chipbench.weights"}
    assert (names - {"."}) <= {"__future__", "math", "dataclasses", "numpy", "torch",
                               "chipbench", "chipbench.weights"}


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro_torch_fake" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in harness.foreign_modules()


def test_the_reference_loads_with_the_program_and_jax_blocked():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'repro', 'repro_torch'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import chipbench.reference, chipbench.flops, chipbench.trace\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_run_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                          "olmoe_1b_7b.prefill_4x4k", "--seed", str(2**31 + 7),
                          "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_run_refuses_an_unknown_workload():
    out = subprocess.run([sys.executable, "chipbench/run.py", "--workload", "nothing",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
