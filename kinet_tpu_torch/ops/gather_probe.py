"""Column-wise row gather, ``out[i, j] = tbl[idx[i, j], j]``: the CUDA
kernel ``csrc/gather_rows.cu`` with its plain PyTorch version beside it.

Replaces the Pallas probe kernel ``scripts/pallas_gather_probe.py::run``
(``jnp.take_along_axis(tbl, idx, axis=0)`` over one VMEM block, a probe of
the TPU's in-kernel gather rate). Index semantics follow take_along_axis in
JAX: a negative index counts from the end, an index still outside [0, R)
gives NaN.

``gather_rows`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, adding one to ``gather_rows.launches``, or
raises. ``torch.gather(tbl, 0, idx)`` computes the same function for valid
indices; the probe times it as a yardstick and the port does not call it.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def _check(tbl: torch.Tensor, idx: torch.Tensor):
    if tbl.dim() != 2 or tuple(idx.shape) != tuple(tbl.shape):
        raise ValueError(
            f"tbl must be [R, C] and idx the same shape, got "
            f"{tuple(tbl.shape)} and {tuple(idx.shape)}"
        )
    if tbl.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"tbl must be float32 and idx int32, got "
                        f"{tbl.dtype} and {idx.dtype}")
    if idx.device != tbl.device:
        raise ValueError(f"idx is on {idx.device}, tbl on {tbl.device}")


def gather_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: an explicit flat index ``row * C + column``."""
    _check(tbl, idx)
    r, c = tbl.shape
    rows = idx.long()
    rows = torch.where(rows < 0, rows + r, rows)
    inside = (rows >= 0) & (rows < r)
    cols = torch.arange(c, device=tbl.device)[None, :]
    flat = rows.clamp(0, max(r - 1, 0)) * c + cols
    out = tbl.reshape(-1)[flat.reshape(-1)].view(r, c)
    return torch.where(inside, out, torch.full_like(out, float("nan")))


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = tbl[idx[i, j], j]`` for tbl [R, C] float32 and idx
    [R, C] int32."""
    if tbl.device.type == "cpu":
        return gather_rows_plain(tbl, idx)
    if tbl.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {tbl.device}")
    _check(tbl, idx)
    r, c = tbl.shape
    tbl, idx = tbl.contiguous(), idx.contiguous()
    out = torch.empty_like(tbl)
    if out.numel() == 0:
        return out
    fn = cuda_build.load("gather_rows").gather_rows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(tbl.device):
        stream = torch.cuda.current_stream(tbl.device).cuda_stream
        rc = fn(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), r, c, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {rc}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
