"""Quantization matrices and their wire serialization.

The port's copy of imageencoder_tpu/utils/quant.py::QuantMatrix (parity
with dc::MatrixReader), writer and reader: the wire form is a 5-bit width, then size * size
unsigned values of that width (MatrixReader.cpp:145-158), the width being
the largest ffs over the entries (:182-190).
"""

from __future__ import annotations

import numpy as np

SIZE_LEN_BITS = 5


def ffs(x) -> np.ndarray:
    """32 - clz(x) for x > 0 and 0 for x == 0, element-wise: the number of
    bits in the binary form of non-negative integers."""
    return np.frexp(np.asarray(x, dtype=np.float64))[1].astype(np.int32)


class QuantMatrix:
    """A [size, size] quantization matrix of unsigned integers."""

    def __init__(self, matrix):
        matrix = np.asarray(matrix, dtype=np.uint32)
        if matrix.ndim != 2 or matrix.shape[0] != matrix.shape[1]:
            raise ValueError(f"expected a square matrix, got {matrix.shape}")
        self.matrix = matrix

    @property
    def size(self) -> int:
        return self.matrix.shape[0]

    def max_bit_length(self) -> int:
        """Bits for the widest entry (MatrixReader.cpp:182-190)."""
        return int(np.max(ffs(self.matrix)))

    def write(self, writer) -> None:
        """Serialize into a BitWriter: the 5-bit width, then the values."""
        w = self.max_bit_length()
        writer.put(SIZE_LEN_BITS, w)
        for v in self.matrix.ravel():
            writer.put(w, int(v))

    @classmethod
    def from_bitstream(cls, reader, size: int = 4) -> "QuantMatrix":
        """Read the wire form from a BitReader (MatrixReader.cpp:46-57)."""
        w = reader.get(SIZE_LEN_BITS)
        vals = [reader.get(w) for _ in range(size * size)]
        return cls(np.array(vals, dtype=np.uint32).reshape(size, size))

    def as_float(self, dtype=np.float64) -> np.ndarray:
        return self.matrix.astype(dtype)


def quant_from_numpy(matrix) -> QuantMatrix:
    """The port's QuantMatrix of a numpy array, such as the ``matrix`` of
    imageencoder_tpu's QuantMatrix: the state carried across from the JAX
    package."""
    return QuantMatrix(np.array(matrix, dtype=np.uint32))
