"""Block tensor to image.

The port's copy of imageencoder_tpu/ops/blockify.py::deblockify: blocks
come in row-major block order, the reference's emission order
(ImageBase.cpp:175-241).  It works on numpy arrays and torch tensors.
"""

from __future__ import annotations


def deblockify(blocks, h: int, w: int):
    """[N, B, B] -> [H, W], N = (H / B) * (W / B) in row-major order."""
    n, b, b2 = blocks.shape
    if b != b2 or h % b or w % b or n != (h // b) * (w // b):
        raise ValueError(f"{n} blocks of {b}x{b2} do not tile {h}x{w}")
    by, bx = h // b, w // b
    return blocks.reshape(by, bx, b, b).swapaxes(1, 2).reshape(h, w)
