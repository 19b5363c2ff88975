"""Nothing the benchmark runs imports JAX or the JAX package: neither in
its sources, nor in a process that has imported what ``run.py`` imports."""
import ast
import subprocess
import sys

from benchmarks import harness
from benchmarks.tests.tiny import BENCH


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["kinet_tpu_torch", "kinet_tpu_torch.ops",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["kinet_tpu.models", "jax", "flax.linen",
                                      "jaxlib.xla"]) == ["flax", "jax", "jaxlib",
                                                         "kinet_tpu"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad = harness.forbidden_modules(names)
            assert not bad, f"{path}: imports {bad}"


def test_what_run_imports_loads_no_jax():
    """A process that imports the harness and every loop (and with them
    the program) holds none of the forbidden top-level names."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmarks import harness, check, control\n"
            "import importlib, pathlib\n"
            "for p in pathlib.Path(%r).glob('loops/*.py'):\n"
            "    importlib.import_module('benchmarks.loops.' + p.stem)\n"
            "print(harness.forbidden_modules())\n") % (str(BENCH.parent),
                                                        str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_run_refuses_without_a_card_and_prints_no_result():
    """``run.py`` on a machine without CUDA exits with another code than 0
    and prints nothing on standard output (a CPU-only machine here; the
    test is moot where a card is present)."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "mot17.s4", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
