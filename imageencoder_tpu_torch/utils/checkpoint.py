"""GOP-granular checkpoint / resume for long video encodes on a device.

The port's counterpart of imageencoder_tpu/utils/checkpoint.py.  Every GOP
starts with an I-frame and its P-frames reference frames of the same GOP
only, so a GOP's payload is a self-contained bit string: it is encoded on
the device at start bit 0 (as the port's long-video chunks are,
models/video.py), saved, and later spliced behind the header.

Layout of a checkpoint directory, the JAX package's:
    meta.json                 the job: width, height, gop, merange, rle,
                              frames, ref_mode, norm, backend
    gop_{i:06d}.seg           a GOP's payload bytes
    gop_{i:06d}.json          {"nbits": its bit length, "crc32": ...}

``backend`` is "numpy": the port's numerics are the JAX package's numpy
backend's, so a directory either package wrote with that backend resumes
in the other.  A segment whose CRC32 or length does not match its record
is encoded again; a directory of another job is refused.  The stream
equals a straight ``encode_video`` of the same job.
"""

from __future__ import annotations

import json
import pathlib
import zlib

import torch

from ..models.headers import VideoParams
from ..models.image import BLOCK_SIZE
from ..models.video import check_video, mvec_bits, split_yuv420, video_header
from ..ops import bitpack
from ..ops.device_pack import host_total, stream_bytes, to_device
from ..ops.huffman import huffman_encode
from ..ops.video_pipeline import (make_encode_video_packed,
                                  make_encode_video_packed_recon)
from .device import resolve_device
from .logger import Logger
from .quant import QuantMatrix

BACKEND = "numpy"  # the JAX package's backend whose numerics the port has


def gop_slices(n_frames: int, gop: int) -> list[tuple[int, int]]:
    """[start, end) frame ranges of the GOPs."""
    gop = max(1, gop)
    return [(s, min(s + gop, n_frames)) for s in range(0, n_frames, gop)]


def read_segment(seg_p: pathlib.Path, info_p: pathlib.Path):
    """(bytes, bits) of a saved segment, or None where it is missing or
    fails its CRC32 or length check."""
    if not (seg_p.exists() and info_p.exists()):
        return None
    raw = seg_p.read_bytes()
    try:
        info = json.loads(info_p.read_text())
        nbits = int(info["nbits"])
        ok = (info["crc32"] == zlib.crc32(raw)
              and len(raw) == (nbits + 7) // 8)
    except (ValueError, KeyError, TypeError):
        ok = False
    return (raw, nbits) if ok else None


def gop_encoder(gop: int, merange: int, block_size: int, use_rle: bool,
                norm: str, ref_mode: str):
    """The device video encode a GOP's payload goes through
    (ops/video_pipeline.py), for the given job."""
    factory = (make_encode_video_packed if ref_mode == "raw"
               else make_encode_video_packed_recon)
    return factory(max(1, gop), merange, mvec_bits(merange), block_size,
                   use_rle, norm)


def encode_gop_payload(fn, frames: torch.Tensor,
                       quant: QuantMatrix) -> tuple[bytes, int]:
    """One GOP's payload, u8 frames [F, H, W] on the device through
    ``fn`` (:func:`gop_encoder`) at start bit 0: (its bytes, its bits).
    The JAX package's utils/checkpoint.py::_encode_gop_payload."""
    words, total = fn(frames, quant.as_float(), 0, None)
    nbits = host_total(total)
    return stream_bytes(words, nbits), nbits


def encode_video_checkpointed(data: bytes, width: int, height: int,
                              quant: QuantMatrix, use_rle: bool, gop: int,
                              merange: int, ckpt_dir: str,
                              use_huffman: bool = True,
                              norm: str = "reference",
                              ref_mode: str = "raw",
                              block_size: int = BLOCK_SIZE,
                              device="cuda") -> bytes:
    """models.video.encode_video on ``device``, resumable at GOP
    granularity through ``ckpt_dir``.  Raises ValueError where the
    directory holds another job."""
    check_video(width, height, gop, ref_mode, block_size)
    dev = resolve_device(device)
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    frames = split_yuv420(data, width, height)
    n_frames = len(frames)
    meta = {"width": width, "height": height, "gop": gop,
            "merange": merange, "rle": int(use_rle), "frames": n_frames,
            "ref_mode": ref_mode, "norm": norm, "backend": BACKEND}
    meta_p = d / "meta.json"
    if meta_p.exists():
        old = json.loads(meta_p.read_text())
        if old != meta:
            raise ValueError(f"checkpoint dir {ckpt_dir} holds a different "
                             f"job: {old} != {meta}")
    else:
        meta_p.write_text(json.dumps(meta))

    fn = gop_encoder(gop, merange, block_size, use_rle, norm, ref_mode)
    frames_d: torch.Tensor | None = None
    segments = []
    for i, (s, e) in enumerate(gop_slices(n_frames, gop)):
        seg_p, info_p = d / f"gop_{i:06d}.seg", d / f"gop_{i:06d}.json"
        got = read_segment(seg_p, info_p)
        if got is None:
            if seg_p.exists() or info_p.exists():
                Logger.write(f"[checkpoint] segment {i} failed validation; "
                             f"re-encoding GOP")
            if frames_d is None:
                frames_d = to_device(frames, dev)
            got = encode_gop_payload(fn, frames_d[s:e], quant)
            seg_p.write_bytes(got[0])
            info_p.write_text(json.dumps({"nbits": got[1],
                                          "crc32": zlib.crc32(got[0])}))
        segments.append(got)
    return splice_gops(segments, n_frames, width, height, quant, use_rle,
                       gop, merange, use_huffman, dev)


def splice_gops(segments, n_frames: int, width: int, height: int,
                quant: QuantMatrix, use_rle: bool, gop: int, merange: int,
                use_huffman: bool, device) -> bytes:
    """The stream of a video from its GOPs' payloads [(bytes, bits), ...]
    in order: the header, the payloads spliced on the host behind it, then
    with Huffman ops/huffman.py::huffman_encode on ``device`` (on a card
    K3, the dict kernel and K4)."""
    writer = video_header(quant, use_rle, width, height,
                          VideoParams(n_frames, max(1, gop), merange),
                          use_huffman)
    inner = bitpack.concat_bit_segments(
        [(writer.getvalue(), writer.position)] + list(segments))
    return huffman_encode(inner, device) if use_huffman else inner
