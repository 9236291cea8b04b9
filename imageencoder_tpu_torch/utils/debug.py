"""Debug observability (the reference's LOG_LOCAL hooks, batched).

The port's copy of imageencoder_tpu/utils/debug.py, which prints the same
text.  The reference compiles per-block dump helpers behind LOG_LOCAL —
printZigzag/printRLE/printExpanded/printMatrix (Block.cpp:521-612) and
Huffman printDict/printTree (Huffman.cpp:404-418).  These are their
tensor-era equivalents: they format any block of a batched tensor, or a
whole Huffman dictionary, for stream debugging.  The forward transform of
:func:`dump_block_pipeline` is the plain K5 (ops/cuda_encode.py), the
exact f64 transform of the JAX package's ops/dct.py::forward_transform.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.zigzag import zigzag_order
from .quant import ffs


def bits_needed(v: int) -> int:
    """Minimal signed two's-complement bit width (>= 1) of the int16 value
    ``v`` (reference utils.hpp:226-243; the JAX package's
    utils/bits.py::bits_needed of one value)."""
    v = int(np.int32(v))
    return (v if v >= 0 else -v - 1).bit_length() + 1


def format_matrix(block, title: str = "matrix") -> str:
    """One block [B,B] as the reference's printMatrix layout."""
    block = np.asarray(block)
    lines = [f"{title} ({block.shape[0]}x{block.shape[1]}):"]
    for row in block:
        lines.append("  " + " ".join(f"{v:6g}" for v in row))
    return "\n".join(lines)


def format_zigzag(block) -> str:
    """Coefficients of one [B,B] block in zig-zag order (printZigzag)."""
    block = np.asarray(block)
    b = block.shape[-1]
    vals = block.reshape(-1)[zigzag_order(b)]
    return "zigzag: " + " ".join(f"{v:g}" for v in vals)


def format_rle(coeffs_zz) -> str:
    """One block's zig-zag coefficients as the reference's RLE dump
    (printRLE): (zeroes, bits)(data) tuples plus the info head."""
    coeffs_zz = np.asarray(coeffs_zz).ravel()
    entries = []
    zeroes = 0
    max_bits = 0
    count = 0
    for v in coeffs_zz:
        if v == 0:
            zeroes += 1
            continue
        nb = bits_needed(int(v))
        entries.append((zeroes, nb, int(v)))
        max_bits = max(max_bits, nb)
        count += zeroes + 1
        zeroes = 0
    head_bits = max(max_bits, int(ffs(count)), 1)
    lines = [f"info: data_bits={head_bits} data={count}"]
    lines += [f"  ({z}, {nb})({d})" for z, nb, d in entries]
    return "\n".join(lines)


def format_huffman_dict(entries) -> str:
    """Huffman dictionary as printDict: 'symbol: codeword (len)'."""
    lines = ["huffman dict:"]
    for sym, word, length in sorted(entries):
        lines.append(f"  0x{sym:02X}: {word:0{length}b} ({length})")
    return "\n".join(lines)


def dump_block_pipeline(img_block, quant, norm: str = "reference") -> str:
    """Full per-block trace: pixels -> DCT -> quantized -> RLE (the
    reference's LOG_LOCAL flow for one block)."""
    from ..ops.cuda_encode import quantize_image_plain

    img_block = np.asarray(img_block, dtype=np.uint8)
    b = img_block.shape[-1]
    coeffs = quantize_image_plain(torch.from_numpy(img_block.copy()),
                                  np.asarray(quant, np.float64), b,
                                  norm).numpy()
    czz = coeffs.reshape(-1)[zigzag_order(b)]
    return "\n".join([
        format_matrix(img_block, "pixels"),
        format_matrix(coeffs, "quantized coefficients"),
        format_rle(czz),
    ])
