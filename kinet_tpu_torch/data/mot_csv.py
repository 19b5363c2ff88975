"""MOTChallenge csv rows as numpy (the port's copy of the csv reader of
``kinet_tpu/native/__init__.py::parse_mot_csv``; the port builds no native
library).

A row is ``frame, id, x, y, w, h[, conf, ...]``: rows with fewer than 6
fields are skipped, and conf is 1.0 where a row has only 6.
"""
from __future__ import annotations

import csv

import numpy as np


def parse_mot_csv(path: str) -> np.ndarray:
    """[N, 7] float32: frame, id, x, y, w, h, conf of every row of ``path``."""
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 6:
                vals = [float(v) for v in row[:6]]
                conf = float(row[6]) if len(row) > 6 else 1.0
                rows.append(vals + [conf])
    return np.asarray(rows, np.float32).reshape(-1, 7)
