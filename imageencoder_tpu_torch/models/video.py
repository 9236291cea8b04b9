"""Video encode on a torch device.

The counterpart of imageencoder_tpu/models/video.py::encode_video with
backend="jax" (models/video.py:223-328): the same signature, header and
semantics, and streams byte-identical to its backend="numpy".  The host
writes the header bits exactly as the JAX package does
(models/headers.py); the device runs the motion search, the transform
and the pack, which with Huffman counts the byte histogram
(ops/video_pipeline.py), then the dict and the payload pack
(ops/huffman.py).  Only the video decode still lives in the JAX
package: imageencoder_tpu.models.video.decode_video(backend="fast") reads
these streams (the port decodes images, models/image.py::decode_image).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitpack
from ..ops.bitpack import BitWriter
from ..ops.device_pack import (header_to_words, host_total, stream_bytes,
                               to_device)
from ..ops.huffman import huffman_encode, huffman_encode_from_hist
from ..ops.motion import MACRO
from ..ops.video_pipeline import (make_encode_video_packed,
                                  make_encode_video_packed_recon)
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.quant import QuantMatrix
from .headers import VideoParams, write_image_header, write_video_params
from .image import BLOCK_SIZE

MAX_FRAMES_PER_CALL = 32  # longer videos go in GOP-aligned chunks


def mvec_bits(merange: int) -> int:
    """MVEC_BIT_SIZE = bits_needed(int16(merange)) (VideoBase.cpp:42): the
    minimal signed two's-complement width of the value."""
    v = int(np.int16(merange))
    return (v if v >= 0 else -v - 1).bit_length() + 1


def split_yuv420(data: bytes, width: int, height: int) -> np.ndarray:
    """u8 [F, H, W] Y planes of a YUV420p byte stream; UV bytes and a
    trailing partial frame are skipped (VideoBase.cpp:39-40)."""
    y_size = width * height
    frame_size = y_size + y_size // 2
    n = len(data) // frame_size
    arr = np.frombuffer(data, dtype=np.uint8, count=n * frame_size)
    return arr.reshape(n, frame_size)[:, :y_size].reshape(
        n, height, width).copy()


def video_header(quant: QuantMatrix, use_rle: bool, width: int, height: int,
                 params: VideoParams, use_huffman: bool) -> BitWriter:
    """The stream's leading bits: a '0' flag bit without Huffman, the
    image header, then the video parameters."""
    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)
    write_image_header(writer, quant, use_rle, width, height)
    write_video_params(writer, params)
    return writer


def encode_video(data: bytes, width: int, height: int, quant: QuantMatrix,
                 use_rle: bool, gop: int, merange: int,
                 use_huffman: bool = True, norm: str = "reference",
                 ref_mode: str = "raw", block_size: int = BLOCK_SIZE,
                 device="cuda") -> bytes:
    """Encode a YUV420p byte stream to the reference video wire format on
    ``device``.  Only Y is coded; UV bytes are skipped.

    ref_mode "raw" predicts every P-frame from the raw frame before it (the
    shipped reference binaries); "recon" from that frame's reconstruction
    (the reference source).  The stream is byte-identical to
    imageencoder_tpu.models.video.encode_video(..., backend="numpy").
    """
    frames = split_yuv420(data, width, height)
    return encode_frames(frames, width, height, quant, use_rle, gop, merange,
                         use_huffman, norm, ref_mode, block_size, device)


def encode_frames(frames, width: int, height: int, quant: QuantMatrix,
                  use_rle: bool, gop: int, merange: int,
                  use_huffman: bool = True, norm: str = "reference",
                  ref_mode: str = "raw", block_size: int = BLOCK_SIZE,
                  device="cuda") -> bytes:
    """:func:`encode_video` of Y planes u8 [F, H, W] (a numpy array or a
    tensor, which may already lie on ``device``)."""
    if ref_mode not in ("raw", "recon"):
        raise ValueError(f"unknown ref_mode {ref_mode!r}")
    gop = max(1, gop)
    if width % block_size or height % block_size or MACRO % block_size:
        raise ValueError(f"video {width}x{height} does not tile into "
                         f"{block_size}-pixel blocks and {MACRO}-pixel "
                         f"macroblocks")
    if (width % MACRO or height % MACRO) and gop > 1:
        # P-frames of such a video desync the reference's decoder: blocks
        # outside every macroblock never get a record (models/video.py).
        raise ValueError(
            f"video dimensions must be multiples of {MACRO} "
            f"(got {width}x{height}); the reference silently produces "
            f"undecodable streams for these when gop > 1")
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, device=dev)
    if frames.dtype != torch.uint8 or frames.dim() != 3 or tuple(
            frames.shape[1:]) != (height, width):
        raise TypeError(f"expected u8 [F, {height}, {width}] frames, got "
                        f"{frames.dtype} {tuple(frames.shape)}")
    frames = frames.contiguous()
    n_frames = frames.shape[0]
    writer = video_header(quant, use_rle, width, height,
                          VideoParams(n_frames, gop, merange), use_huffman)
    if n_frames == 0:
        # Input shorter than one frame: a header-only stream, like the
        # reference (frame_count = filesize / frame_size).
        inner = writer.getvalue()
        return huffman_encode(inner, dev) if use_huffman else inner

    factory = (make_encode_video_packed if ref_mode == "raw"
               else make_encode_video_packed_recon)
    qf = quant.as_float()
    mb = mvec_bits(merange)
    if n_frames <= MAX_FRAMES_PER_CALL:
        fn = factory(gop, merange, mb, block_size, use_rle, norm,
                     with_hist=use_huffman)
        header = to_device(header_to_words(writer.getvalue()).view(np.int32),
                           dev)
        with profiling.stage("device video encode"):
            got = fn(frames, qf, writer.position, header)
        if use_huffman:
            with profiling.stage("huffman"):
                return huffman_encode_from_hist(*got)
        words, total = got
        return stream_bytes(words, host_total(total))

    # Long videos: GOP-aligned chunks (GOPs are independent) encoded at bit
    # 0 and spliced after the header on the host, then Huffman over the
    # whole stream on ``dev`` (K3, the dict kernel and K4 on a card).
    chunk = max(gop, (MAX_FRAMES_PER_CALL // gop) * gop)
    fn = factory(gop, merange, mb, block_size, use_rle, norm)
    segments = [(writer.getvalue(), writer.position)]
    with profiling.stage("device video encode"):
        for s in range(0, n_frames, chunk):
            words, total = fn(frames[s:s + chunk], qf, 0, None)
            total = host_total(total)
            segments.append((stream_bytes(words, total), total))
    inner = bitpack.concat_bit_segments(segments)
    if use_huffman:
        with profiling.stage("huffman"):
            return huffman_encode(inner, dev)
    return inner
