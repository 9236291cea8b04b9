"""Quality / throughput metrics (PSNR, compression ratio, Mpix/s).

The port's copy of imageencoder_tpu/utils/metrics.py.
"""

from __future__ import annotations

import numpy as np


def psnr(a, b, peak: float = 255.0) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def compression_ratio(encoded_bytes: int, raw_bytes: int) -> float:
    return encoded_bytes / raw_bytes


def mpix_per_s(pixels: int, seconds: float) -> float:
    return pixels / seconds / 1e6
