"""K6 and K7: motion search and motion-compensated prediction on the card.

The counterparts of imageencoder_tpu/ops/pallas_motion.py (sad_maps_pallas
with the descent of video_pipeline.sad_motion_search, and
predict_translate_pallas).  On a CUDA tensor the wrappers launch
csrc/motion.cu; on a CPU tensor they run the plain versions of
ops/motion.py.  K6 searches each macroblock directly and builds no SAD
maps; the vectors equal the plain descent's bit for bit.

The encode paths run the search with the prediction as its epilogue, one
launch for both kernels: :func:`search_predict` (the recon path: vectors
and the predicted frame) and :func:`search_residual` (the raw path: a
whole video in, its vectors and the int16 residual stack that K1 reads
out).  :func:`motion_search` (K6 alone) and :func:`predict` (K7 alone,
the vectors given) stay beside them; the video decode
(models/video.py::decode_frames) runs K7 alone on the vectors it reads
from the stream.

The sharded video encode (parallel/video_sharding.py) runs both on a
stripe of the frames: :func:`search_residual_stripe` (a chunk's stripe and
its haloed reference stack, the chunk's first global frame picking its
P-frames) and :func:`search_predict_stripe` (the haloed reconstruction
carry).  Their positions are clamped in global rows, so a stripe's vectors
are the whole frame's; ops/motion.py's module docstring describes the
stripe.

The kernels read the frames as 32-bit words and 16-byte vectors, so their
data must start 16-byte aligned: frames of a contiguous [F, H, W] tensor
with H * W a multiple of 256 do.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .motion import (MACRO, motion_search_plain, p_frames,  # noqa: F401
                     predict_plain, search_steps)


def _check_frames(x: torch.Tensor, name: str) -> None:
    if x.dim() != 3 or x.dtype != torch.uint8:
        raise TypeError(f"{name}: expected u8 [F, H, W] frames, got "
                        f"{x.dtype} {tuple(x.shape)}")
    _, h, w = x.shape
    if h % MACRO or w % MACRO:
        raise ValueError(f"{name}: frames {h}x{w} are not a multiple of the "
                         f"{MACRO}-pixel macroblock")


def _check_pair(cur: torch.Tensor, ref: torch.Tensor) -> None:
    """What the search takes: cur and ref u8 [F, H, W] of one shape, and
    on the card contiguous and 16-byte aligned."""
    _check_frames(cur, "cur")
    if ref.shape != cur.shape:
        raise ValueError(f"ref {tuple(ref.shape)} != cur {tuple(cur.shape)}")
    if cur.device.type == "cpu":
        return
    for name, x in (("cur", cur), ("ref", ref)):
        build.require(x, name, torch.uint8, 3, cur.device)
        build.require_aligned(x, name)


def _vectors(n_frames: int, h: int, w: int, dev) -> torch.Tensor:
    return torch.empty((n_frames, (h // MACRO) * (w // MACRO), 2),
                       dtype=torch.int32, device=dev)


def motion_search(cur: torch.Tensor, ref: torch.Tensor,
                  merange: int) -> torch.Tensor:
    """2D-log search of every macroblock of cur[f] in ref[f]: u8 [F, H, W]
    each -> int32 [F, Nmb, 2] vectors as (x, y)."""
    _check_pair(cur, ref)
    if cur.device.type == "cpu":
        return motion_search_plain(cur, ref, merange)
    dev = cur.device
    f, h, w = cur.shape
    out = _vectors(f, h, w, dev)
    with torch.cuda.device(dev):
        code = build.library().ie_motion_search(
            cur.data_ptr(), ref.data_ptr(), f, h, w, int(merange),
            out.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_motion_search")
    motion_search.launches += 1
    return out


motion_search.launches = 0


def predict(ref: torch.Tensor, mvec: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Motion-compensated prediction: ref u8 [F, H, W] and mvec int32
    [F, Nmb, 2] -> u8 [F, H, W] (into ``out`` where given), each
    macroblock copied from its window at its vector, clamped into the
    frame.  Vectors may take any int32 value.  Each of the three may be a
    view of every k-th frame (``x[k::gop]``): a frame's own data must be
    contiguous, and on the card its pixels start 16-byte aligned."""
    _check_frames(ref, "ref")
    f, h, w = ref.shape
    want = (f, (h // MACRO) * (w // MACRO), 2)
    if tuple(mvec.shape) != want:
        raise ValueError(f"mvec {tuple(mvec.shape)} != {want}")
    if out is not None and out.shape != ref.shape:
        raise ValueError(f"out {tuple(out.shape)} != ref "
                         f"{tuple(ref.shape)}")
    if ref.device.type == "cpu":
        pred = predict_plain(ref, mvec)
        return pred if out is None else out.copy_(pred)
    dev = ref.device
    if out is None:
        out = torch.empty_like(ref, memory_format=torch.contiguous_format)
    for name, x in (("ref", ref), ("out", out)):
        build.require_frames(x, name, torch.uint8, 3, dev)
        build.require_aligned(x, name)
        if x.stride(0) % 16:
            raise ValueError(f"{name}: frames must start 16 bytes apart")
    build.require_frames(mvec, "mvec", torch.int32, 3, dev)
    with torch.cuda.device(dev):
        code = build.library().ie_predict(
            ref.data_ptr(), ref.stride(0), mvec.data_ptr(), mvec.stride(0),
            f, h, w, out.data_ptr(), out.stride(0), build.stream_ptr(dev))
    build.check(code, "ie_predict")
    predict.launches += 1
    return out


predict.launches = 0


def search_predict_plain(cur: torch.Tensor, ref: torch.Tensor,
                         merange: int):
    """The plain version of :func:`search_predict`, on any device: the
    plain search, then the plain prediction at its vectors."""
    mvec = motion_search_plain(cur, ref, merange)
    return mvec, predict_plain(ref, mvec)


def search_predict(cur: torch.Tensor, ref: torch.Tensor, merange: int):
    """K6 with K7 as its epilogue: cur, ref u8 [F, H, W] -> (int32
    [F, Nmb, 2] vectors, u8 [F, H, W] prediction of cur[f] from ref[f] at
    them), in one launch."""
    _check_pair(cur, ref)
    if cur.device.type == "cpu":
        return search_predict_plain(cur, ref, merange)
    dev = cur.device
    f, h, w = cur.shape
    mvec = _vectors(f, h, w, dev)
    pred = torch.empty_like(cur)
    with torch.cuda.device(dev):
        code = build.library().ie_search_predict(
            cur.data_ptr(), ref.data_ptr(), f, h, w, int(merange),
            mvec.data_ptr(), pred.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_search_predict")
    search_predict.launches += 1
    return mvec, pred


search_predict.launches = 0


def search_residual_plain(frames: torch.Tensor, gop: int, merange: int):
    """The plain version of :func:`search_residual`, on any device: the
    P-frames selected, searched in and predicted from the frames before
    them, and cur - pred put on their rows of the int16 stack."""
    f, h, w = frames.shape
    x = frames.to(torch.int16)
    p_idx = p_frames(f, gop)
    if not p_idx:
        return _vectors(0, h, w, frames.device), x.reshape(f * h, w)
    pi = torch.tensor(p_idx, device=frames.device)
    cur = frames.index_select(0, pi)
    ref = frames.index_select(0, pi - 1)
    mvec, pred = search_predict_plain(cur, ref, merange)
    x.index_copy_(0, pi, cur.to(torch.int16) - pred)
    return mvec, x.reshape(f * h, w)


def search_residual(frames: torch.Tensor, gop: int, merange: int):
    """The raw-reference front of a video, in one launch: frames u8
    [F, H, W] in GOPs of ``gop`` -> (int32 [P, Nmb, 2] vectors of the P
    frames (f % gop != 0), each searched in the raw frame before it, and
    the int16 [F*H, W] stack K1 reads: the pixels on an I-frame's rows,
    cur - pred on a P-frame's)."""
    _check_frames(frames, "frames")
    if gop < 1:
        raise ValueError(f"gop must be at least 1, got {gop}")
    if frames.device.type == "cpu":
        return search_residual_plain(frames, gop, merange)
    dev = frames.device
    build.require(frames, "frames", torch.uint8, 3, dev)
    build.require_aligned(frames, "frames")
    f, h, w = frames.shape
    mvec = _vectors(len(p_frames(f, gop)), h, w, dev)
    stack = torch.empty((f * h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        code = build.library().ie_search_residual(
            frames.data_ptr(), f, h, w, int(merange), int(gop),
            mvec.data_ptr(), stack.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_search_residual")
    search_residual.launches += 1
    return mvec, stack


search_residual.launches = 0


# ---- on a stripe (the sharded video encode) ----

def _check_stripe(cur: torch.Tensor, ref: torch.Tensor, row0: int,
                  halo: int, h_glob: int, merange: int) -> None:
    """cur u8 [F, h, W], rows row0 .. row0 + h - 1 of frames h_glob tall,
    and ref u8 [F, h + 2 * halo, W] holding every row the search reaches:
    +-span around the stripe, clipped to the frame."""
    _check_frames(cur, "cur")
    f, h, w = cur.shape
    if ref.dim() != 3 or ref.dtype != torch.uint8 or tuple(ref.shape) != (
            f, h + 2 * halo, w):
        raise ValueError(f"ref: expected u8 [{f}, {h + 2 * halo}, {w}], got "
                         f"{ref.dtype} {tuple(ref.shape)}")
    span = sum(search_steps(merange))
    if (row0 < 0 or halo < 0 or row0 + h > h_glob or h_glob % MACRO
            or row0 - halo > max(0, row0 - span)
            or row0 + h + halo < min(h_glob, row0 + h + span)):
        raise ValueError(f"a stripe of rows {row0}..{row0 + h} of "
                         f"{h_glob} with a halo of {halo} does not hold the "
                         f"search's reach of {span} rows")
    if cur.device.type == "cpu":
        return
    for name, x in (("cur", cur), ("ref", ref)):
        build.require(x, name, torch.uint8, 3, cur.device)
        build.require_aligned(x, name)


def search_predict_stripe_plain(cur, ref, row0: int, halo: int, h_glob: int,
                                merange: int):
    """The plain version of :func:`search_predict_stripe`, on any device."""
    mvec = motion_search_plain(cur, ref, merange, row0, halo, h_glob)
    return mvec, predict_plain(ref, mvec, row0, halo, h_glob)


def search_predict_stripe(cur: torch.Tensor, ref: torch.Tensor, row0: int,
                          halo: int, h_glob: int, merange: int):
    """:func:`search_predict` on a stripe: cur u8 [F, h, W] (rows row0 ..
    row0 + h - 1 of frames h_glob rows tall) searched in ref u8
    [F, h + 2 * halo, W] (from global row row0 - halo), positions clamped
    in global rows -> (int32 [F, Nmb, 2] vectors, u8 [F, h, W]
    prediction), in one launch."""
    _check_stripe(cur, ref, row0, halo, h_glob, merange)
    if cur.device.type == "cpu":
        return search_predict_stripe_plain(cur, ref, row0, halo, h_glob,
                                           merange)
    dev = cur.device
    f, h, w = cur.shape
    mvec = _vectors(f, h, w, dev)
    pred = torch.empty_like(cur)
    with torch.cuda.device(dev):
        code = build.library().ie_search_predict_stripe(
            cur.data_ptr(), ref.data_ptr(), f, h, w, row0, halo, h_glob,
            int(merange), mvec.data_ptr(), pred.data_ptr(),
            build.stream_ptr(dev))
    build.check(code, "ie_search_predict_stripe")
    search_predict_stripe.launches += 1
    return mvec, pred


search_predict_stripe.launches = 0


def search_residual_stripe_plain(cur, ref, row0: int, halo: int, h_glob: int,
                                 f0: int, gop: int, merange: int):
    """The plain version of :func:`search_residual_stripe`, on any
    device."""
    f, h, w = cur.shape
    x = cur.to(torch.int16)
    p_idx = p_frames(f, gop, f0)
    if not p_idx:
        return _vectors(0, h, w, cur.device), x.reshape(f * h, w)
    pi = torch.tensor(p_idx, device=cur.device)
    c = cur.index_select(0, pi)
    mvec, pred = search_predict_stripe_plain(c, ref.index_select(0, pi), row0,
                                             halo, h_glob, merange)
    x.index_copy_(0, pi, c.to(torch.int16) - pred)
    return mvec, x.reshape(f * h, w)


def search_residual_stripe(cur: torch.Tensor, ref: torch.Tensor, row0: int,
                           halo: int, h_glob: int, f0: int, gop: int,
                           merange: int):
    """:func:`search_residual` on a stripe of a chunk of frames, in one
    launch: cur u8 [F, h, W], global frames f0 .. f0 + F - 1 (rows row0 ..
    row0 + h - 1 of frames h_glob rows tall); ref u8 [F, h + 2 * halo, W],
    frame f's reference from global row row0 - halo (the raw frame before
    it, and for f = 0 the previous chunk's last frame; never read for an
    I-frame, (f0 + f) % gop == 0) -> (int32 [P, Nmb, 2] vectors of the
    chunk's P-frames in order, int16 [F*h, W]: the pixels on I rows,
    cur - pred on P rows)."""
    if gop < 1:
        raise ValueError(f"gop must be at least 1, got {gop}")
    if f0 < 0:
        raise ValueError(f"f0 must be at least 0, got {f0}")
    _check_stripe(cur, ref, row0, halo, h_glob, merange)
    if cur.device.type == "cpu":
        return search_residual_stripe_plain(cur, ref, row0, halo, h_glob, f0,
                                            gop, merange)
    dev = cur.device
    f, h, w = cur.shape
    mvec = _vectors(len(p_frames(f, gop, f0)), h, w, dev)
    stack = torch.empty((f * h, w), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        code = build.library().ie_search_residual_stripe(
            cur.data_ptr(), ref.data_ptr(), f, h, w, row0, halo, h_glob,
            int(merange), int(f0), int(gop), mvec.data_ptr(),
            stack.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_search_residual_stripe")
    search_residual_stripe.launches += 1
    return mvec, stack


search_residual_stripe.launches = 0
