"""Builds the port's CUDA sources (``ops/csrc/*.cu``) into shared libraries.

Each ``<name>.cu`` becomes ``build/kinet_tpu_torch/lib<name>-<hash>.so`` at
the root of the checkout, compiled by ``nvcc`` for Hopper (``sm_90a``) with a
plain C interface and loaded with ``ctypes``. The hash covers the sources,
the shared headers and the flags, so an edited kernel is rebuilt and a built
one is reused. Nothing is built at import: the first launch of a kernel, or
an explicit ``build_all()``, starts one ``nvcc`` per missing library, all in
parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kinet_tpu_torch"
KERNELS = (
    "msda_fwd", "msda_raw_pool_fwd", "msda_bwd", "msda_raw_pool_bwd",
    "gather_rows",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of kinet_tpu_torch are built with "
        "the CUDA toolkit on the machine that has the GPU"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(ptxas_info: bool = False) -> dict[str, str]:
    """Compiles every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns the compiler's messages per
    built kernel (``ptxas_info`` adds registers, spills and shared memory).
    Raises RuntimeError if any build fails."""
    missing = [n for n in KERNELS if not library_path(n).exists()]
    if not missing:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in missing:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if ptxas_info:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    messages, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        messages[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return messages


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all()
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
