"""The least device time a request needs, counted from its shapes.

The work is what the request's inputs need, whatever kernels implement
it, so a fusion or a split of kernels leaves the count as it is:

  * bytes: each input pixel read once and each output byte written once
    (an encode's stream; a decode's stream read and its frames written),
    at the HBM rate;
  * f64 operations: the transform's multiplies and adds, 544 a 4x4 block
    (forward: 16 x 16 products and sums, the scale and the quant
    division; inverse: the dequantization, 16 x 16 products and sums and
    the + 128), 16 more a block where a decode adds a prediction;
  * integer operations: the motion search's byte SADs (four to one 32-bit
    instruction, as ``__vabsdiffu4`` takes them) and the residual's
    subtraction, a pixel of every P-frame.

The least time is the largest of the three bounds.  The kernels compute
the transform in exact order with no fused multiply-add, one rounded
operation an instruction, so against a peak that counts an FMA as two
operations their f64 share can reach 50% at most.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12  # FP64 outside the tensor cores, an FMA as two
# GH100 has as many INT32 lanes as FP64 lanes an SM (64): one 32-bit
# integer instruction a lane a clock is the FP64 FMA rate.
INT32_OPS_PER_S = F64_OPS_PER_S / 2
SAD_BYTES_PER_OP = 4

BLOCK = 4
MACRO = 16
F64_PER_BLOCK = 544
F64_PREDICTION = 16
MER_CANDIDATES = 9


def search_levels(merange: int) -> int:
    """The descent's steps: merange // 2, // 4, ... 1."""
    n, m = 0, merange // 2
    while m > 0:
        n, m = n + 1, m // 2
    return n


def p_frames(frames: int, gop: int) -> int:
    return sum(1 for f in range(frames) if f % max(1, gop))


def bound(bytes_moved: float, f64_ops: float, int_ops: float) -> dict:
    """Each bound in seconds, the least time and what sets it."""
    times = {"hbm": bytes_moved / HBM_BYTES_PER_S,
             "f64": f64_ops / F64_OPS_PER_S,
             "int": int_ops / INT32_OPS_PER_S}
    by = max(times, key=times.get)
    return {**times, "least_s": times[by], "by": by}


def image_encode(batch: int, height: int, width: int,
                 stream_bytes: float) -> dict:
    """A batch of images encoded to streams of ``stream_bytes`` in all."""
    pixels = batch * height * width
    return bound(pixels + stream_bytes,
                 pixels // (BLOCK * BLOCK) * F64_PER_BLOCK, 0)


def video_encode(frames: int, height: int, width: int, gop: int,
                 merange: int, stream_bytes: float) -> dict:
    """A raw-reference video encode to a stream of ``stream_bytes``."""
    pixels = frames * height * width
    n_p = p_frames(frames, gop)
    n_macro = (height // MACRO) * (width // MACRO)
    sads = (n_p * n_macro * search_levels(merange) * MER_CANDIDATES
            * MACRO * MACRO)
    residual = n_p * height * width
    return bound(pixels + stream_bytes,
                 pixels // (BLOCK * BLOCK) * F64_PER_BLOCK,
                 sads / SAD_BYTES_PER_OP + residual)


def video_decode(frames: int, height: int, width: int, gop: int,
                 stream_bytes: float) -> dict:
    """A video decode of a stream of ``stream_bytes`` into its frames."""
    pixels = frames * height * width
    blocks = pixels // (BLOCK * BLOCK)
    p_blocks = p_frames(frames, gop) * (height * width) // (BLOCK * BLOCK)
    return bound(stream_bytes + pixels,
                 blocks * F64_PER_BLOCK + p_blocks * F64_PREDICTION, 0)
