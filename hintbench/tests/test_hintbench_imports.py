"""Nothing the benchmark runs imports JAX or the JAX package, compared by
top-level module name whole (``hint_tpu_torch`` is the program, not
``hint_tpu``), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from hintbench.lib.spec import HERE, ROOT
from hintbench.run import FORBIDDEN, loaded_forbidden


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        found = set(_imports(path)) & set(FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert not set(_imports(path)) & {"hint_tpu_torch", "hintbench", "jax", "hint_tpu"}, path


def test_the_guard_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["hint_tpu_torch_x"] = sys
        assert "hint_tpu" not in loaded_forbidden()
        sys.modules["hint_tpu.ops"] = sys
        assert "hint_tpu" in loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_cell_loads_no_forbidden_module():
    """A whole tiny training run in a fresh interpreter leaves no module of
    JAX or the JAX package loaded."""
    code = ("import sys, torch; sys.path.insert(0, %r); "
            "from hintbench.tests.conftest import tiny_cell; import hintbench.run as R; "
            "R.run_cell(tiny_cell('rcinn4-train'), 3, 0.5, False, torch.device('cpu'), strict=False); "
            "print(R.loaded_forbidden())") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """No card: exit code 2 and no line on standard output. A directory
    that holds only BENCHMARK.json and the benchmark fails too."""
    import shutil

    import torch

    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(ROOT / "hintbench/run.py"), "--workload", "rcinn4-train",
                              "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                             cwd=ROOT, timeout=300)
        assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "hintbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "hintbench/run.py", "--workload", "rcinn4-train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
