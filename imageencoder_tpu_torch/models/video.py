"""Video encode and decode on a torch device.

:func:`encode_video` is the counterpart of imageencoder_tpu/models/
video.py::encode_video with backend="jax" (models/video.py:223-328): the
same signature, header and semantics, and streams byte-identical to its
backend="numpy".  The host writes the header bits exactly as the JAX
package does (models/headers.py); the device runs the motion search, the
transform and the pack, which with Huffman counts the byte histogram
(ops/video_pipeline.py), then the dict and the payload pack
(ops/huffman.py).

:func:`decode_video` is the counterpart of decode_video with
backend="numpy", the exact f64 engine (models/video.py:584-676): its
frames are equal byte for byte.  The host parses the dict and the header
and uploads the stream once; then the card runs the Huffman decode, one
walk over the whole video's records, the vector read, and frame k of
every GOP at once: the block decode of the I-frames, then for each
k >= 1 the prediction from frame k - 1 (K7) and the block decode of the
residual onto it (ops/cuda_decode.py), with nothing read back.
:func:`parse_video_stream`, :func:`iter_parsed_frames` and
:func:`assemble_yuv420` are the port's copies of the JAX package's host
front half and output assembly.

:class:`VideoEncoder` and :class:`VideoDecoder` are the drivers the CLI
runs (the JAX package's, models/video.py:680-742), with a ``device`` in
place of its ``backend`` and ``workers``: the card decodes every GOP at
once.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import bitpack, cuda_decode, cuda_encode, cuda_motion, cuda_pack
from ..ops.bitpack import BitReader, BitWriter
from ..ops.device_pack import (header_to_words, host_total,
                               packed_words_bound, stream_bytes, to_device)
from ..ops.huffman import (Tail, huffman_decode, huffman_encode,
                           huffman_encode_from_hist, payload_words)
from ..ops.motion import MACRO
from ..ops.video_pipeline import (make_encode_video_packed,
                                  make_encode_video_packed_recon)
from ..utils import profiling
from ..utils.bits import shift_signed
from ..utils.device import resolve_device
from ..utils.exceptions import StreamFormatError
from ..utils.logger import Logger
from ..utils.quant import QuantMatrix
from .headers import (VideoParams, read_image_header, read_video_params,
                      write_image_header, write_video_params)
from .image import BLOCK_SIZE, parse_stream, upload, walk_block_offsets

# The JAX package's frames a call (a TPU memory bound): the pass of the
# plain versions, and a rank's of the sharded encode.
MAX_FRAMES_PER_CALL = 32
UV_FILL = 0x80  # dc::VIDEO_UV_FILL (Frame.hpp:12): decoded U and V
# A pass's small device tensors: the header words, the totals, the byte
# histogram, the dict table, K1's overflow flag.
PASS_SMALL_BYTES = 1 << 16
INDEX_LIMIT = 1 << 31  # a 32-bit signed index's range
GRID_Z_LIMIT = 65535  # the search's frames a launch (its grid z)


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


def check_video(width: int, height: int, gop: int, ref_mode: str,
                block_size: int = BLOCK_SIZE) -> None:
    """Raise ValueError on a video the encode does not take."""
    if ref_mode not in ("raw", "recon"):
        raise ValueError(f"unknown ref_mode {ref_mode!r}")
    if width % block_size or height % block_size or MACRO % block_size:
        raise ValueError(f"video {width}x{height} does not tile into "
                         f"{block_size}-pixel blocks and {MACRO}-pixel "
                         f"macroblocks")
    if (width % MACRO or height % MACRO) and max(1, gop) > 1:
        # P-frames of such a video desync the reference's decoder: blocks
        # outside every macroblock never get a record (models/video.py).
        raise ValueError(
            f"video dimensions must be multiples of {MACRO} "
            f"(got {width}x{height}); the reference silently produces "
            f"undecodable streams for these when gop > 1")


@lru_cache(maxsize=None)
def _record_words(block_size: int, norm: str, residual: bool) -> int:
    return (cuda_encode.video_lw if residual else cuda_encode.frontend_lw)(
        block_size, norm)


def _tile_sums_bytes(n_records: int) -> int:
    """Bytes of K2's and K4's i64 tile sums over n records (the library's
    ie_pack_*_scratch): a tile holds at least 256 records and a group of
    8 tiles takes one sum more, so two sums a 256 records bound them."""
    return 16 * (n_records // 256 + 1)


def _pass_stream(n_frames: int, h: int, w: int, gop: int, ref_mode: str,
                 block_size: int, norm: str):
    """(P-frames, macroblocks a frame, records, register words a record)
    of one pass over n_frames frames, as the pass packs them."""
    b = block_size
    n_p = n_frames - -(-n_frames // gop)
    n_macro = (h // MACRO) * (w // MACRO) if n_p else 0
    records = n_frames * ((h // b) * (w // b) + n_macro)
    return n_p, n_macro, records, _record_words(
        b, norm, ref_mode == "recon" or n_p > 0)


def pass_bytes(n_frames: int, h: int, w: int, gop: int, ref_mode: str,
               use_huffman: bool, block_size: int = BLOCK_SIZE,
               norm: str = "reference") -> int:
    """Device bytes that one pass of :func:`encode_frames` over n_frames
    u8 frames [h, w] already on the card allocates, from the sizes its
    buffers are allocated with, summed as if all were live at once (the
    front's buffers are freed before the Huffman tail allocates):

      raw: the int16 residual stack (none without a P-frame: K1 then
        reads the frames), K1's register files and lengths (lw + 1 words
        a block, cuda_encode.video_lw or frontend_lw);
      recon: the int32 coefficients and the record lengths, and the
        prediction and reconstruction frames of frame k of every GOP;
      both: the vectors, the stream words (packed_words_bound) and their
        tile sums, with Huffman K4's payload (payload_words) and its tile
        sums, the wire buffer (cuda_pack.wire_capacity), and
        PASS_SMALL_BYTES."""
    gop = max(1, gop)
    hw, n_micro = h * w, (h // block_size) * (w // block_size)
    n_p, n_macro, records, lw = _pass_stream(n_frames, h, w, gop, ref_mode,
                                             block_size, norm)
    if ref_mode == "raw":
        front = (2 * hw * n_frames if n_p else 0) + \
            4 * (lw + 1) * n_micro * n_frames
    else:
        front = 4 * (hw + n_micro) * n_frames + \
            2 * hw * len(range(1, n_frames, gop))
    n_words = packed_words_bound(records, lw)
    total = (front + 8 * n_p * n_macro + 4 * n_words
             + _tile_sums_bytes(records) + cuda_pack.wire_capacity(1, n_words)
             + PASS_SMALL_BYTES)
    if use_huffman:
        total += 4 * payload_words(n_words) + _tile_sums_bytes(
            -(-n_words // 4))
    return total


def frames_per_pass(h: int, w: int, gop: int, ref_mode: str,
                    use_huffman: bool, block_size: int = BLOCK_SIZE,
                    device="cuda", norm: str = "reference",
                    free: int | None = None) -> int:
    """The frames of one device pass of :func:`encode_frames`: a whole
    number of GOPs, at least one.  On a card the most whose
    :func:`pass_bytes` fit in half of ``free`` (by default the card's free
    memory and what the caching allocator holds unused), and whose every
    32-bit index on the path stays in range:

      records (the pass's vector and block records) below 2^31: K2's and
        K4 pack_coeffs' cursors (unsigned record, frame and P-frame
        indices), K5's and the recon step's unsigned block indices, and
        the tile-sum counts the library returns as an int;
      with Huffman, the inner stream's bytes (at most 4 words of
        packed_words_bound) below 2^31: the int32 bins of the byte
        histogram that K2 and K4 pack_coeffs count and the dict kernel
        reads;
      the frames, at most 65535: the search's grid z of a raw pass (a
        recon pass's, its GOPs, are fewer).

    K1, K4 pack_payload, the wire emit and the Tail index in 64 bits.
    Elsewhere the JAX package's 32 frames, in GOPs."""
    gop = max(1, gop)
    if torch.device(device).type != "cuda":
        return max(gop, (MAX_FRAMES_PER_CALL // gop) * gop)
    if free is None:
        free = torch.cuda.mem_get_info(device)[0] + (
            torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))

    def fits(n: int) -> bool:
        _, _, records, lw = _pass_stream(n, h, w, gop, ref_mode, block_size,
                                         norm)
        return (records < INDEX_LIMIT
                and not (use_huffman and 4 * packed_words_bound(records, lw)
                         >= INDEX_LIMIT)
                and pass_bytes(n, h, w, gop, ref_mode, use_huffman,
                               block_size, norm) <= free // 2)

    lo, hi = 1, GRID_Z_LIMIT // gop  # GOPs
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid * gop):
            lo = mid
        else:
            hi = mid - 1
    return lo * gop


def encode_frames(frames, width: int, height: int, quant: QuantMatrix,
                  use_rle: bool, gop: int, merange: int,
                  use_huffman: bool = True, norm: str = "reference",
                  ref_mode: str = "raw", block_size: int = BLOCK_SIZE,
                  device="cuda") -> bytes:
    """:func:`encode_video` of Y planes u8 [F, H, W] (a numpy array or a
    tensor, which may already lie on ``device``)."""
    check_video(width, height, gop, ref_mode, block_size)
    gop = max(1, gop)
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
    budget = frames_per_pass(height, width, gop, ref_mode, use_huffman,
                             block_size, dev, norm)
    if n_frames <= budget:
        profiling.count("encode_passes", 1)
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
        return Tail(words[None], total.reshape(1), read=True).finish()[0]

    # Past the budget: GOP-aligned chunks (GOPs are independent) encoded at
    # bit 0 and spliced after the header on the host, then Huffman over the
    # whole stream on ``dev`` (K3, the dict kernel and K4 on a card).
    profiling.count("encode_passes", -(-n_frames // budget))
    fn = factory(gop, merange, mb, block_size, use_rle, norm)
    segments = [(writer.getvalue(), writer.position)]
    with profiling.stage("device video encode"):
        for s in range(0, n_frames, budget):
            words, total = fn(frames[s:s + budget], qf, 0, None)
            with profiling.stage("wait"):
                total = host_total(total)
            segments.append((stream_bytes(words, total), total))
    with profiling.stage("splice"):
        inner = bitpack.concat_bit_segments(segments)
    if use_huffman:
        with profiling.stage("huffman"):
            return huffman_encode(inner, dev)
    return inner


# ---- decode: the host's copies ----

def read_vector_fields(packed: bytes, pos: int, n_macro: int,
                       mb: int) -> np.ndarray:
    """A P-frame's vectors: 2 * n_macro signed ``mb``-bit fields from bit
    ``pos`` of the bytes, zero past their end; int32 [n_macro, 2] as (x,
    y)."""
    nb = 2 * n_macro * mb
    b0 = pos // 8
    local = np.unpackbits(np.frombuffer(
        packed[b0:(pos + nb + 7) // 8], dtype=np.uint8))
    offs = (pos - b0 * 8) + np.arange(2 * n_macro, dtype=np.int64) * mb
    raw = bitpack.read_fields(local, offs,
                              np.full(2 * n_macro, mb, dtype=np.int64))
    return shift_signed(raw, mb).reshape(n_macro, 2)


def parse_video_header(data: bytes, block_size: int = BLOCK_SIZE):
    """The host's Huffman stage and header parse: (payload, quant,
    use_rle, params, width, height, first record bit).  The whole payload
    is decoded on the host (the card path head-decodes only the header:
    models/image.py::parse_stream)."""
    if not data:
        raise StreamFormatError("empty stream")
    if data[0] & 0x80:  # the Huffman flag bit (MSB-first)
        payload, start = huffman_decode(data), 0
    else:
        payload, start = bytes(data), 1
    reader = BitReader(payload[:65536], position=start)
    quant, use_rle, width, height = read_image_header(reader, block_size)
    params = read_video_params(reader)
    return payload, quant, use_rle, params, width, height, reader.position


def walk_frames(payload: bytes, pos: int, n_frames: int, n_micro: int,
                gop: int, vbits: int, use_rle: bool,
                block_size: int = BLOCK_SIZE):
    """The frame loop of the host's walk from bit ``pos``: yields (vector
    start bit, record start bit, (offsets, data bits, counts), end bit) a
    frame, a P-frame's (f % gop != 0) records after its ``vbits`` bits of
    vectors."""
    for f in range(n_frames):
        vstart = pos
        if f % gop:
            pos += vbits
        *records, end = walk_block_offsets(None, pos, n_micro, use_rle,
                                           block_size, packed=payload)
        yield vstart, pos, tuple(records), end
        pos = end


def iter_parsed_frames(payload: bytes, params: VideoParams, use_rle: bool,
                       width: int, height: int, pos: int,
                       block_size: int = BLOCK_SIZE):
    """The host's record-layout walk, one frame at a time: yields (vectors
    int32 [Nmb, 2] or None for an I-frame, record start bit, (offsets,
    data bits, counts)).  A P-frame's 2 * Nmb vector fields come first."""
    mb = mvec_bits(params.merange)
    n_micro = (width // block_size) * (height // block_size)
    n_macro = (width // MACRO) * (height // MACRO)
    gop = max(1, params.gop)
    frames = walk_frames(payload, pos, params.frame_count, n_micro, gop,
                         2 * n_macro * mb, use_rle, block_size)
    for f, (vstart, start, records, _) in enumerate(frames):
        mv = read_vector_fields(payload, vstart, n_macro, mb) if f % gop \
            else None
        yield mv, start, records


def parse_video_stream(data: bytes, block_size: int = BLOCK_SIZE):
    """The host's front half of a video decode: (payload, quant, use_rle,
    params, width, height, parsed), parsed[f] = (vectors or None, record
    start bit, (offsets, data bits, counts))."""
    (payload, quant, use_rle, params, width, height,
     pos) = parse_video_header(data, block_size)
    parsed = list(iter_parsed_frames(payload, params, use_rle, width,
                                     height, pos, block_size))
    return payload, quant, use_rle, params, width, height, parsed


def assemble_yuv420(frames, width: int, height: int) -> bytes:
    """Y planes u8 [F, H, W] (a list or an array) and the 0x80 U and V
    fill, as YUV420p bytes."""
    y_size = width * height
    fs = y_size + y_size // 2
    out = np.empty(len(frames) * fs, np.uint8)
    ov = out.reshape(len(frames), fs)
    ov[:, y_size:] = UV_FILL
    for i, fr in enumerate(frames):
        ov[i, :y_size] = np.asarray(fr).reshape(-1)
    return out.tobytes()


# ---- decode on the device ----

def plan_video(data: bytes, block_size: int = BLOCK_SIZE,
               pinned: bool = False) -> dict:
    """The host's part of a video decode (models/image.py::parse_stream
    with the video parameters; pinned=True stages the stream in pinned
    memory, for a copy to a card), and what the frames need: ``n_macro``,
    ``mb`` (the vector field width) and ``vbits`` (a P-frame's vector
    bits, 0 where the video has no P-frame).  Raises StreamFormatError
    where a P-frame cannot be predicted: frames that are no multiple of
    the 16-pixel macroblock (the host decoder fails on them too)."""
    plan = parse_stream(data, block_size, video=True, pinned=pinned)
    params, w, h = plan["params"], plan["w"], plan["h"]
    has_p = params.frame_count > 1 and params.gop > 1
    if has_p and (w % MACRO or h % MACRO):
        raise StreamFormatError(
            f"video {w}x{h} has P-frames but is no multiple of the "
            f"{MACRO}-pixel macroblock")
    n_macro = (w // MACRO) * (h // MACRO)
    mb = mvec_bits(params.merange)
    plan.update(n_macro=n_macro, mb=mb,
                vbits=2 * n_macro * mb if has_p else 0)
    return plan


def decode_into(plan: dict, views: dict, y: torch.Tensor,
                motioncomp: bool = True, norm: str = "reference",
                block_size: int = BLOCK_SIZE,
                gops: tuple[int, int] | None = None) -> torch.Tensor:
    """The device's part of a video decode, on the uploaded stream
    (models/image.py::upload), into ``y`` (u8 [F, H, W] on the views'
    device; its frames may lie apart, as in a YUV420 buffer): D1 (with
    Huffman), D2 over the whole video, the vector read, then frame k of
    every GOP at once: D3 on the I-frames; for k >= 1 K7 from frame k - 1
    and D3 of the residual onto it (with motioncomp=False the frame is
    the prediction).  With ``gops`` = (g0, g1) only GOPs g0 .. g1 - 1 are
    decoded, into ``y`` [their frames, H, W] (the walk and the vector read
    still cover the whole stream: parallel/video_sharding.py).  Nothing is
    read back."""
    params = plan["params"]
    n_frames, gop = params.frame_count, max(1, params.gop)
    n_micro, w, h = plan["n_blocks"], plan["w"], plan["h"]
    fr0, fr1 = (0, n_frames) if gops is None else (
        gops[0] * gop, min(gops[1] * gop, n_frames))
    if fr1 <= fr0 or n_micro == 0:
        return y
    payload, nbytes = views["stream"], views["nbytes"]
    if plan["huffman"]:
        payload, nbytes = cuda_decode.huffman_decode(
            payload, nbytes, plan["dict_end"], views["table"],
            plan["max_len"], plan["cap"],
            chunk_bits=cuda_decode.CHUNK_BITS_HUFFMAN_VIDEO)
    offs, dbits, counts, _, vstart, _ = cuda_decode.walk_video(
        payload, nbytes, plan["start"], n_frames, n_micro, gop,
        plan["vbits"], plan["use_rle"], block_size)
    recs = [r.view(n_frames, n_micro)[fr0:fr1] for r in (offs, dbits, counts)]
    quant = views["quant"]
    cuda_decode.decode_blocks(payload, nbytes, *(r[0::gop] for r in recs),
                              quant, block_size, norm, h, w, out=y[0::gop])
    if not plan["vbits"]:
        return y
    mvec = cuda_decode.read_vectors(payload, nbytes, vstart, gop,
                                    plan["n_macro"], plan["mb"])[fr0:fr1]
    for k in range(1, min(gop, fr1 - fr0)):
        ref = y[k - 1::gop][:len(range(k, fr1 - fr0, gop))]
        if not motioncomp:
            cuda_motion.predict(ref, mvec[k::gop], out=y[k::gop])
            continue
        pred = cuda_motion.predict(ref, mvec[k::gop])
        cuda_decode.decode_blocks(
            payload, nbytes, *(r[k::gop] for r in recs), quant, block_size,
            norm, h, w, pred=pred, out=y[k::gop])
    return y


def _planned(data: bytes, block_size: int, device):
    dev = resolve_device(device)
    with profiling.stage("parse"):
        plan = plan_video(data, block_size, pinned=dev.type == "cuda")
    views = None
    if plan["params"].frame_count and plan["n_blocks"]:
        with profiling.stage("upload"):
            views = upload(plan, dev)
    return dev, plan, views


def decode_frames(data: bytes, motioncomp: bool = True,
                  norm: str = "reference", block_size: int = BLOCK_SIZE,
                  device="cuda") -> torch.Tensor:
    """:func:`decode_video`'s Y planes: u8 [F, H, W] on ``device``, left
    there (no wait for the device)."""
    dev, plan, views = _planned(data, block_size, device)
    y = torch.empty((plan["params"].frame_count, plan["h"], plan["w"]),
                    dtype=torch.uint8, device=dev)
    with profiling.stage("device decode"):
        return decode_into(plan, views, y, motioncomp, norm, block_size)


def decode_video(data: bytes, motioncomp: bool = True,
                 norm: str = "reference", block_size: int = BLOCK_SIZE,
                 device="cuda"):
    """Decode a video stream on ``device``: (YUV420p bytes, VideoParams,
    (width, height)), frame for frame as
    imageencoder_tpu.models.video.decode_video(data, motioncomp, norm,
    backend="numpy", block_size=block_size).  U and V are 0x80.

    The frames go into one u8 [F, 1.5 * H * W] buffer on the device, U
    and V filled there, and come to the host in one copy, the call's one
    wait.  Raises StreamFormatError on an empty stream, a Huffman dict
    that no code tree represents, frames that are no multiple of the
    block, or P-frames that are no multiple of the 16-pixel macroblock
    (before anything runs on the device); ValueError on a Huffman stream
    without a dict.  A stream of no frames launches nothing."""
    dev, plan, views = _planned(data, block_size, device)
    params, w, h = plan["params"], plan["w"], plan["h"]
    n, y_size = params.frame_count, w * h
    if n == 0:
        return b"", params, (w, h)
    buf = torch.empty((n, y_size + y_size // 2), dtype=torch.uint8,
                      device=dev)
    with profiling.stage("device decode"):
        buf[:, y_size:] = UV_FILL
        decode_into(plan, views, buf[:, :y_size].view(n, h, w), motioncomp,
                    norm, block_size)
    with profiling.stage("copy"):
        if dev.type == "cuda":
            host = torch.empty(buf.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(buf, non_blocking=True)
            profiling.count("bytes_down", host.nbytes)
            with profiling.stage("wait"):
                torch.cuda.current_stream(dev).synchronize()
            buf = host
        return buf.numpy().tobytes(), params, (w, h)


@dataclass
class VideoEncoder:
    """Driver mirroring dc::VideoEncoder (VideoEncoder.cpp): a YUV420p file
    in, its stream out."""

    source_file: str
    dest_file: str
    width: int
    height: int
    use_rle: bool
    quant: QuantMatrix
    gop: int
    merange: int
    use_huffman: bool = True
    ref_mode: str = "raw"
    norm: str = "reference"
    block_size: int = BLOCK_SIZE
    device: str = "cuda"

    def process(self) -> bool:
        with open(self.source_file, "rb") as f:
            data = f.read()
        Logger.write("[VideoEncoder] Processing video...")
        self._raw_size = len(data)
        self._result = encode_video(data, self.width, self.height, self.quant,
                                    self.use_rle, self.gop, self.merange,
                                    use_huffman=self.use_huffman,
                                    norm=self.norm, ref_mode=self.ref_mode,
                                    block_size=self.block_size,
                                    device=self.device)
        return True

    def save_result(self) -> None:
        with open(self.dest_file, "wb") as f:
            f.write(self._result)
        ratio = len(self._result) / max(self._raw_size, 1) * 100
        Logger.write(f"[VideoEncoder] Encoded size: {len(self._result)} bytes"
                     f" => Ratio: {ratio:.2f}%")


@dataclass
class VideoDecoder:
    """Driver mirroring dc::VideoDecoder (VideoDecoder.cpp): a stream in,
    its YUV420p frames out."""

    source_file: str
    dest_file: str
    motioncomp: bool = True
    norm: str = "reference"
    block_size: int = BLOCK_SIZE
    device: str = "cuda"

    def process(self) -> bool:
        with open(self.source_file, "rb") as f:
            data = f.read()
        Logger.write("[VideoDecoder] Processing video...")
        self._result, self._params, _ = decode_video(
            data, motioncomp=self.motioncomp, norm=self.norm,
            block_size=self.block_size, device=self.device)
        return True

    def save_result(self) -> None:
        with open(self.dest_file, "wb") as f:
            f.write(self._result)
        Logger.write(f"[VideoDecoder] Decoded size: {len(self._result)} bytes")
