"""kinet_tpu_torch stands alone: it imports neither JAX nor flax nor any
module of the JAX package kinet_tpu, and chip_smoke.py neither, nor the
test helper it loads (tests/_ref_state_dict.py)."""
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "kinet_tpu_torch"

_IMPORT_CHECK = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None  # any import of them now raises ImportError
import kinet_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    kinet_tpu_torch.__path__, "kinet_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
sys.path.insert(0, "tests")
import _ref_state_dict  # chip_smoke.py loads it for phase H
leaked = [k for k in sys.modules if k == "kinet_tpu" or k.startswith("kinet_tpu.")]
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_jax():
    # a fresh interpreter: this one has imported jax already (conftest)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert res.returncode == 0, res.stderr
    # every submodule was imported, parallel/ (mesh, tp, sp) and the host
    # tools (tools/*, utils/plot_utils) included
    assert int(res.stdout.split()[-1]) >= 74


_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|flax|optax|kinet_tpu)(?![\w])",
    re.MULTILINE,
)


def test_no_source_imports_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tests" / "_ref_state_dict.py"]
    assert len(files) >= 77
    offenders = [
        f"{f.relative_to(REPO)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not offenders, offenders
