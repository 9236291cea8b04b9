"""Bit-width helpers of the wire format, in numpy.

The port's copy of imageencoder_tpu/utils/bits.py::shift_signed.
"""

from __future__ import annotations

import numpy as np


def shift_signed(value, src_bits):
    """Sign-extend the low ``src_bits`` bits of ``value`` to int32,
    element-wise; src_bits == 0 yields 0 (reading 0 bits yields 0).
    Reference utils.hpp:266-269 (<< (bits - b), then an arithmetic >>)."""
    v = np.asarray(value).astype(np.int64)
    b = np.asarray(src_bits).astype(np.int64)
    v = v & ((np.int64(1) << b) - 1)
    sign_bit = np.where(b > 0, np.int64(1) << np.maximum(b - 1, 0),
                        np.zeros_like(b))
    out = np.where((v & sign_bit) != 0, v - (sign_bit << 1), v)
    return out.astype(np.int32)
