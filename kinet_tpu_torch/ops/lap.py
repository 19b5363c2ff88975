"""Linear sum assignment on the host (port of ``kinet_tpu/ops/lap.py``).

The JAX package solves the assignment on the device inside its jitted step;
the reference calls ``scipy.optimize.linear_sum_assignment`` on the host,
and so does the port: the cost matrix is copied to the host (one
device-to-host copy per match) and solved exactly.

``solve_lsap_masked(cost [B, N, M], row_valid [B, N])`` keeps the JAX
function's contract: N <= M, padded rows (row_valid False) take no column
and get -1; the result is an exact optimum over the valid rows (ties may
resolve differently than the JAX solver's). The JAX version gives padded
rows a flat cost, which adds the same constant to every assignment and so
leaves the valid rows' optimum unchanged.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def solve_lsap(cost: np.ndarray) -> np.ndarray:
    """Exact LSAP on one [N, M] cost matrix, N <= M. Returns col4row [N]."""
    n, m = cost.shape
    if n > m:
        raise ValueError(f"solve_lsap requires N <= M, got {cost.shape}")
    rows, cols = linear_sum_assignment(cost)
    out = np.full(n, -1, np.int64)
    out[rows] = cols
    return out


def solve_lsap_masked(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """[B, N, M] cost, [B, N] bool -> col4row [B, N] int64 on cost's device,
    -1 at padded rows."""
    c = cost.detach().float().cpu().numpy()
    valid = row_valid.detach().cpu().numpy().astype(bool)
    b, n, m = c.shape
    if n > m:
        raise ValueError(f"solve_lsap_masked requires N <= M, got {c.shape}")
    out = np.full((b, n), -1, np.int64)
    for i in range(b):
        rows = np.flatnonzero(valid[i])
        if rows.size:
            out[i, rows] = solve_lsap(c[i, rows])
    return torch.from_numpy(out).to(cost.device)
