"""K6 and K7: motion search and motion-compensated prediction on the card.

The counterparts of imageencoder_tpu/ops/pallas_motion.py (sad_maps_pallas
with the descent of video_pipeline.sad_motion_search, and
predict_translate_pallas).  On a CUDA tensor :func:`motion_search` and
:func:`predict` launch csrc/motion.cu; on a CPU tensor they run the plain
versions of ops/motion.py.  K6 searches each macroblock directly and
builds no SAD maps; the vectors equal the plain descent's bit for bit.
K6 reads the frames as 32-bit words and 16-byte vectors, so their data
must start 16-byte aligned: frames of a contiguous [F, H, W] tensor with
H * W a multiple of 256 do.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .motion import MACRO, motion_search_plain, predict_plain  # noqa: F401


def _check_frames(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or x.dtype != torch.uint8:
        raise TypeError(f"{name}: expected u8 [F, H, W] frames, got "
                        f"{x.dtype} {tuple(x.shape)}")
    _, h, w = x.shape
    if h % MACRO or w % MACRO:
        raise ValueError(f"{name}: frames {h}x{w} are not a multiple of the "
                         f"{MACRO}-pixel macroblock")


def motion_search(cur: torch.Tensor, ref: torch.Tensor,
                  merange: int) -> torch.Tensor:
    """2D-log search of every macroblock of cur[f] in ref[f]: u8 [F, H, W]
    each -> int32 [F, Nmb, 2] vectors as (x, y)."""
    _check_frames(cur, "cur")
    if ref.shape != cur.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != cur {tuple(cur.shape)}")
    if cur.device.type == "cpu":
        return motion_search_plain(cur, ref, merange)
    dev = cur.device
    build.require(cur, "cur", torch.uint8, 3, dev)
    build.require(ref, "ref", torch.uint8, 3, dev)
    build.require_aligned(cur, "cur")
    build.require_aligned(ref, "ref")
    f, h, w = cur.shape
    out = torch.empty((f, (h // MACRO) * (w // MACRO), 2), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        code = build.library().ie_motion_search(
            cur.data_ptr(), ref.data_ptr(), f, h, w, int(merange),
            out.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_motion_search")
    motion_search.launches += 1
    return out


motion_search.launches = 0


def predict(ref: torch.Tensor, mvec: torch.Tensor) -> torch.Tensor:
    """Motion-compensated prediction: ref u8 [F, H, W] and mvec int32
    [F, Nmb, 2] -> u8 [F, H, W], each macroblock copied from its clamped
    window."""
    _check_frames(ref, "ref")
    f, h, w = ref.shape
    want = (f, (h // MACRO) * (w // MACRO), 2)
    if tuple(mvec.shape) != want:
        raise ValueError(f"mvec {tuple(mvec.shape)} != {want}")
    if ref.device.type == "cpu":
        return predict_plain(ref, mvec)
    dev = ref.device
    build.require(ref, "ref", torch.uint8, 3, dev)
    build.require(mvec, "mvec", torch.int32, 3, dev)
    out = torch.empty_like(ref)
    with torch.cuda.device(dev):
        code = build.library().ie_predict(
            ref.data_ptr(), mvec.data_ptr(), f, h, w, out.data_ptr(),
            build.stream_ptr(dev))
    build.check(code, "ie_predict")
    predict.launches += 1
    return out


predict.launches = 0
