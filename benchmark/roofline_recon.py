"""The least device time of a closed-loop (recon) video encode, counted
from its shapes as roofline.py counts the raw encode's:

  * bytes: each input pixel read once and each stream byte written once;
  * f64 operations: 544 a 4x4 block for the forward transform and quantize
    of every frame's blocks, and 560 a block (the dequantization, the
    inverse, the + 128 and the prediction's add) for each P-frame whose
    reconstruction a later frame of its GOP reads: the last frame of a
    GOP is never read again, and an I-frame is never reconstructed;
  * integer operations: the search's byte SADs (``search_levels(merange)``
    levels of 9 candidates of a 16x16 macroblock, four to an instruction)
    and the residual's subtraction, a pixel of every P-frame.

:func:`video_encode_recon` is the whole request's bound; :func:`chain` the
recon chain's alone (K5, the search and the recon step: no bytes, the
larger of the f64 and integer terms), which ``recon_roofline`` reads.
"""

from __future__ import annotations

from .roofline import (BLOCK, F64_PER_BLOCK, F64_PREDICTION, MACRO,
                       MER_CANDIDATES, SAD_BYTES_PER_OP, bound, p_frames,
                       search_levels)

F64_RECONSTRUCT = F64_PER_BLOCK + F64_PREDICTION  # 560


def reconstructed_frames(frames: int, gop: int) -> int:
    """P-frames whose reconstruction a later frame reads: every frame but
    each GOP's first and last."""
    gop = max(1, gop)
    return sum(1 for f in range(frames)
               if f % gop and f % gop != gop - 1 and f + 1 < frames)


def ops(frames: int, height: int, width: int, gop: int,
        merange: int) -> tuple[int, float]:
    """(f64 operations, integer operations) of the encode."""
    blocks_per_frame = (height // BLOCK) * (width // BLOCK)
    f64 = (frames * blocks_per_frame * F64_PER_BLOCK
           + reconstructed_frames(frames, gop) * blocks_per_frame
           * F64_RECONSTRUCT)
    n_p = p_frames(frames, gop)
    n_macro = (height // MACRO) * (width // MACRO)
    sads = (n_p * n_macro * search_levels(merange) * MER_CANDIDATES
            * MACRO * MACRO)
    return f64, sads / SAD_BYTES_PER_OP + n_p * height * width


def video_encode_recon(frames: int, height: int, width: int, gop: int,
                       merange: int, stream_bytes: float) -> dict:
    """A recon-reference video encode to a stream of ``stream_bytes``."""
    f64, ints = ops(frames, height, width, gop, merange)
    return bound(frames * height * width + stream_bytes, f64, ints)


def chain(frames: int, height: int, width: int, gop: int,
          merange: int) -> dict:
    """The recon chain's bound: its f64 and integer terms alone."""
    return bound(0, *ops(frames, height, width, gop, merange))
