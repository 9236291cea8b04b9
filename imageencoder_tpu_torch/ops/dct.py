"""The f64 DCT tables of the reference's exact transform order.

The port's copy of what it uses from imageencoder_tpu/ops/dct.py.  The
reference computes a naive 2-D DCT per block in f64 (algo.cpp:309-363)
with C(0) = 0.5 and C(u) = 1/sqrt(2), correct for 4x4 only; ``norm=
"ortho"`` scales properly for any size.  Bit parity with it needs:

  * the cosines from glibc's ``cos`` (what the reference binary calls),
    through ctypes, with the argument evaluated in the reference's order
    ((2i+1) * u) * (M_PI_2 / n);
  * forward weights W[(i,j), (u,v)] = cos[u,i] * cos[v,j] as one f64
    product, and the scale C(u) * C(v) applied after the sum;
  * inverse weights W[(u,v), (i,j)] = ((C(u) * C(v)) * cos[u,i]) * cos[v,j],
    left to right (algo.cpp:352-355).

The kernels (csrc/transform.cuh) and their plain versions
(ops/cuda_encode.py, ops/video_pipeline.py, ops/cuda_decode.py)
accumulate these weights in the reference's order: acc = 0; acc = acc +
x[c] * w[c] for c = 0..K-1.  The decode's host copies are here too:
:func:`idct2_exact` (the numpy loop), :func:`inverse_transform` and
:func:`clamp_to_u8`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def dct_matrix(n: int, norm: str = "reference") -> np.ndarray:
    """The DCT-II basis matrix D (f64, numpy's cos), rows scaled by C(u):
    what the coefficient bounds of ops/cuda_encode.py are taken over."""
    u = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    d = np.cos((2.0 * i + 1.0) * u * (np.pi / 2.0 / n))
    if norm == "reference":
        c = np.where(u == 0, 0.5, np.sqrt(0.5))
    elif norm == "ortho":
        c = np.where(u == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return d * c


@lru_cache(maxsize=1)
def _libm():
    lib = ctypes.CDLL("libm.so.6")
    lib.cos.restype = ctypes.c_double
    lib.cos.argtypes = [ctypes.c_double]
    return lib


@lru_cache(maxsize=None)
def _cos_table(n: int) -> np.ndarray:
    """cos((2i+1) * u * pi/(2n)) from glibc, [u, i], in the reference's
    argument order (algo.cpp:318)."""
    factor = (np.pi / 2.0) / float(n)  # M_PI_2 / double(size)
    cos = _libm().cos
    t = np.empty((n, n), dtype=np.float64)
    for u in range(n):
        for i in range(n):
            t[u, i] = cos(float((2 * i + 1) * u) * factor)
    return t


def _c_factors(n: int, norm: str) -> np.ndarray:
    if norm == "reference":
        return np.where(np.arange(n) == 0, 0.5, np.sqrt(0.5))
    return np.where(np.arange(n) == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))


@lru_cache(maxsize=None)
def _fwd_weights(n: int, norm: str) -> tuple[np.ndarray, np.ndarray]:
    """(W f64 [K, K], scale f64 [K]): W[i*n + j, u*n + v] =
    cos[u, i] * cos[v, j], and C(u) * C(v)."""
    cos = _cos_table(n)
    w = np.empty((n * n, n * n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            w[i * n + j] = np.multiply.outer(cos[:, i], cos[:, j]).ravel()
    c = _c_factors(n, norm)
    return w, np.multiply.outer(c, c).ravel()


@lru_cache(maxsize=None)
def _inv_weights(n: int, norm: str) -> np.ndarray:
    """W f64 [K, K]: W[u*n + v, i*n + j] = ((C(u)*C(v)) * cos[u,i]) *
    cos[v,j]."""
    cos = _cos_table(n)
    c = _c_factors(n, norm)
    w = np.empty((n * n, n * n), dtype=np.float64)
    for u in range(n):
        for v in range(n):
            cc = c[u] * c[v]
            w[u * n + v] = np.multiply.outer(cc * cos[u, :], cos[v, :]).ravel()
    return w


def idct2_exact(coeffs: np.ndarray, norm: str = "reference") -> np.ndarray:
    """The reference's inverse DCT (algo.cpp:343-363) on f64 [..., B, B]:
    for each output sample, acc = 0, then acc += y[k] * W[k] for k =
    0..K-1 in row-major order, one rounded multiply and one rounded add
    a step."""
    n = coeffs.shape[-1]
    w = _inv_weights(n, norm)
    flat = np.ascontiguousarray(coeffs, dtype=np.float64).reshape(-1, n * n)
    acc = np.zeros_like(flat)
    tmp = np.empty_like(flat)
    for k in range(n * n):
        np.multiply(flat[:, k, None], w[k][None, :], out=tmp)
        acc += tmp
    return acc.reshape(coeffs.shape)


def inverse_transform(coeffs, quant, norm: str = "reference") -> np.ndarray:
    """Quantized coefficients [N, B, B] -> f64 samples, 128 added back and
    not yet clamped (Block.cpp:163-177): one f64 multiply by the quant
    entry, then the exact inverse."""
    y = np.asarray(coeffs).astype(np.float64) * np.asarray(quant, np.float64)
    return idct2_exact(y, norm) + 128.0


def clamp_to_u8(x) -> np.ndarray:
    """uint8(std::clamp(x, 0., 255.)): C++ truncates a double to uint8,
    which for values in [0, 255] is the floor (Block.cpp:100-107)."""
    return np.floor(np.clip(x, 0.0, 255.0)).astype(np.uint8)
