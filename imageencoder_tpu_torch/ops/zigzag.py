"""Zig-zag scan order for any square block size.

The port's copy of imageencoder_tpu/ops/zigzag.py::zigzag_order, the
ordering rule of the reference (algo.cpp:33-87): cells sorted by
x + y and, within a diagonal, by y where x - y is odd, else by x.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def zigzag_order(n: int) -> np.ndarray:
    """Flat row-major indices in zig-zag emission order, int32 [n*n]."""
    cells = []
    for i in range(n * n):
        x, y = i % n, i // n
        cells.append((x + y, y if (x - y) & 1 else x, i))
    cells.sort(key=lambda c: (c[0], c[1]))
    return np.array([c[2] for c in cells], dtype=np.int32)
