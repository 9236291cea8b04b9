"""Still-image encode and decode on a torch device, and their drivers.

:func:`encode_image` is the counterpart of imageencoder_tpu/models/
image.py::encode_image with backend="jax" (models/image.py:73-113).  The
host writes the header bits exactly as the JAX package does
(models/headers.py); the device runs the transform and the pack, which
with Huffman counts the byte histogram (ops/pipeline.py), then the dict
and the payload pack (ops/huffman.py), and the host waits once before it
copies the stream.

:func:`encode_blocks` is the fields form of the encode (models/image.py:
40-70): tiles in, their wire fields out, for a caller's own packer.

:func:`decode_image` is the counterpart of decode_image with
backend="numpy", the exact f64 engine (models/image.py:331-397): its
pixels are equal.  The host parses the dict and the header and uploads
the stream once; then the card runs the Huffman decode, the offset walk
and the block decode (ops/cuda_decode.py, D1-D3) with nothing read back.
:func:`walk_block_offsets` and :func:`extract_block_coeffs` are the
port's copies of the JAX package's host walk and extraction.

:class:`ImageEncoder` and :class:`ImageDecoder` are the drivers the CLI
runs (the JAX package's, models/image.py:484-539), with a ``device`` in
place of its ``backend``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import cuda_decode
from ..ops import huffman as huffman_ops
from ..ops.bitpack import BitReader, BitWriter, read_fields, to_bits
from ..ops.dct import clamp_to_u8, inverse_transform
from ..ops.device_pack import header_to_words, to_device
from ..ops.huffman import Tail, huffman_encode_from_hist
from ..ops.pipeline import (make_encode_fields_from_blocks,
                            make_encode_packed, make_encode_packed_hist)
from ..ops.zigzag import zigzag_order
from ..utils import profiling
from ..utils.bits import shift_signed
from ..utils.device import resolve_device
from ..utils.exceptions import FileReadError, StreamFormatError
from ..utils.logger import Logger
from ..utils.quant import QuantMatrix
from .headers import (read_image_header, read_video_params,
                      write_image_header)

BLOCK_SIZE = 4


def stream_header(quant: QuantMatrix, use_rle: bool, w: int, h: int,
                  use_huffman: bool, device):
    """The stream's leading bits, written on the host as the JAX package
    writes them: (start_bit, header words int32 [HEADER_WORDS] on
    ``device``).  With use_huffman=False a '0' flag bit leads them."""
    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)  # no-Huffman flag leads the stream directly
    write_image_header(writer, quant, use_rle, w, h)
    header = to_device(header_to_words(writer.getvalue()).view(np.int32),
                       device)
    return writer.position, header


def encode_image(img, quant: QuantMatrix, use_rle: bool = True,
                 use_huffman: bool = False, norm: str = "reference",
                 block_size: int = BLOCK_SIZE, device="cuda") -> bytes:
    """Encode a [H, W] uint8 image (numpy array or tensor) to the reference
    wire format on ``device``.

    The stream is byte-identical to
    imageencoder_tpu.encode_image(img, quant, ..., backend="numpy").
    With use_huffman=False it leads with a '0' flag bit; with True the
    inner stream is Huffman-coded, or stored raw after a '0' bit when that
    is not smaller.
    """
    dev = resolve_device(device)
    img_t = torch.as_tensor(img, device=dev)
    if img_t.dtype != torch.uint8 or img_t.dim() != 2:
        raise TypeError(f"expected a [H, W] uint8 image, got "
                        f"{img_t.dtype} {tuple(img_t.shape)}")
    h, w = img_t.shape
    if h % block_size or w % block_size:
        raise ValueError(f"image {h}x{w} is not a multiple of the "
                         f"{block_size}-pixel block")

    args = (img_t.contiguous(), quant.as_float(),
            *stream_header(quant, use_rle, w, h, use_huffman, dev))

    if use_huffman:
        with profiling.stage("device encode+pack+hist"):
            got = make_encode_packed_hist(block_size, use_rle, norm)(*args)
        with profiling.stage("huffman"):
            return huffman_encode_from_hist(*got)
    with profiling.stage("device encode+pack"):
        words, total = make_encode_packed(block_size, use_rle, norm)(*args)
        return Tail(words[None], total.reshape(1)).finish()[0]


def encode_blocks(blocks_u8, quant: QuantMatrix, use_rle: bool,
                  norm: str = "reference", device="cuda"):
    """[N, B, B] u8 tiles (numpy or a tensor) -> (field values, field
    nbits) int32 numpy arrays [N, B*B + 2]: the transform, the stats and
    the fields on ``device`` (ops/pipeline.py::
    make_encode_fields_from_blocks), ready for a bit packer; equal to
    imageencoder_tpu.models.image.encode_blocks(..., backend="numpy")."""
    dev = resolve_device(device)
    blocks = torch.as_tensor(blocks_u8, device=dev)
    fn = make_encode_fields_from_blocks(blocks.shape[-1], use_rle, norm)
    vals, nbits = fn(blocks.contiguous(), quant.as_float())
    return vals.cpu().numpy(), nbits.cpu().numpy()


def walk_block_offsets(bits: np.ndarray | None, start_bit: int,
                       n_blocks: int, use_rle: bool,
                       block_size: int = BLOCK_SIZE,
                       packed: bytes | None = None):
    """The offset walk over the variable-length block records: (payload
    offsets int64 [N], data bits int32 [N], counts int32 [N], end bit).

    A record is 4 bits of width b, then with RLE b bits of count (else
    count = B*B), then b*count bits of fields; a count past B*B is kept as
    read.  Reads past the end give zero bits.  ``bits`` (a bit vector) may
    be None when ``packed`` (the bytes) is given.  A loop of byte-window
    reads, each field at most 15 bits; the serial chain the card walks in
    parallel (ops/cuda_decode.walk_offsets).
    """
    if packed is None:
        packed = np.packbits(bits).tobytes()
    data = bytes(packed) + b"\0\0\0"  # a window starting in the stream
    k = block_size * block_size

    def get(p: int, n: int) -> int:
        if n == 0:
            return 0
        window = int.from_bytes(data[p >> 3:(p >> 3) + 3], "big")
        return (window >> (24 - (p & 7) - n)) & ((1 << n) - 1)

    offs = np.empty(n_blocks, dtype=np.int64)
    dbits = np.empty(n_blocks, dtype=np.int32)
    counts = np.empty(n_blocks, dtype=np.int32)
    pos = start_bit
    for i in range(n_blocks):
        b = get(pos, 4)
        pos += 4
        if use_rle:
            ln = get(pos, b)
            pos += b
        else:
            ln = k
        offs[i] = pos
        dbits[i] = b
        counts[i] = ln
        pos += b * ln
    return offs, dbits, counts, pos


def coeffs_from_records(bits: np.ndarray, offs, dbits, counts,
                        block_size: int = BLOCK_SIZE) -> np.ndarray:
    """Each record's fields, sign-extended and put back from zig-zag into
    row-major order: int32 [N, B, B].  Field j of record i is dbits[i]
    bits at offs[i] + j * dbits[i], for j < min(counts[i], B*B); the rest
    are 0, as are bits past the end."""
    k = block_size * block_size
    n_blocks = len(offs)
    offs = np.asarray(offs, np.int64)
    dbits = np.asarray(dbits, np.int32)
    counts = np.asarray(counts, np.int32)
    j = np.arange(k, dtype=np.int64)[None, :]
    live = j < counts[:, None]
    field_offs = offs[:, None] + j * dbits[:, None].astype(np.int64)
    field_bits = np.where(live, dbits[:, None], 0)
    raw = read_fields(bits, field_offs.ravel(), field_bits.ravel())
    coeffs_zz = shift_signed(raw.reshape(n_blocks, k),
                             np.maximum(dbits[:, None], 1)) * live
    flat = np.zeros((n_blocks, k), dtype=np.int32)
    flat[:, zigzag_order(block_size)] = coeffs_zz
    return flat.reshape(n_blocks, block_size, block_size)


def extract_block_coeffs(bits: np.ndarray | None, start_bit: int,
                         n_blocks: int, use_rle: bool,
                         block_size: int = BLOCK_SIZE,
                         packed: bytes | None = None):
    """The host's front half of the decode, the offset walk and the field
    extraction: (coefficients int32 [N, B, B] row-major, end bit)."""
    if packed is None:
        packed = np.packbits(bits).tobytes()
    if bits is None:
        bits = to_bits(packed)
    offs, dbits, counts, end = walk_block_offsets(
        None, start_bit, n_blocks, use_rle, block_size, packed=packed)
    return coeffs_from_records(bits, offs, dbits, counts, block_size), end


def blocks_from_records(bits: np.ndarray, offs, dbits, counts, quant,
                        norm: str = "reference", block_size: int = BLOCK_SIZE,
                        residual: bool = False) -> np.ndarray:
    """The records' blocks: u8 [N, B, B] pixels, or with residual=True the
    exact f64 inverse + 128 unclamped (what a P-frame adds onto its
    prediction).  ``quant`` is the f64 matrix [B, B]."""
    coeffs = coeffs_from_records(bits, offs, dbits, counts, block_size)
    px = inverse_transform(coeffs, quant, norm)
    return px if residual else clamp_to_u8(px)


def decode_blocks(bits: np.ndarray | None, start_bit: int, n_blocks: int,
                  quant: QuantMatrix, use_rle: bool, norm: str = "reference",
                  block_size: int = BLOCK_SIZE, residual: bool = False,
                  packed: bytes | None = None):
    """Parse and inverse-transform n_blocks records from ``start_bit``:
    ([N, B, B] u8, end bit), or with residual=True the raw f64 inverse
    with its + 128 and no clamp (the P-frame residual).  The JAX
    package's decode_blocks with backend="numpy"; ``bits`` may be None
    when ``packed`` is given."""
    if packed is None:
        packed = np.packbits(bits).tobytes()
    if bits is None:
        bits = to_bits(packed)
    offs, dbits, counts, end = walk_block_offsets(
        None, start_bit, n_blocks, use_rle, block_size, packed=packed)
    return blocks_from_records(bits, offs, dbits, counts, quant.as_float(),
                               norm, block_size, residual), end


def header_bytes(block_size: int, video: bool = False) -> int:
    """Payload bytes that hold any image header: a 5-bit quant width, B*B
    entries of up to 31 bits, the RLE bit and two 15-bit dims; a video's
    three 15-bit parameters after them."""
    return (5 + block_size * block_size * 31 + 1 + 30 + 45 * video
            + 7) // 8


def parse_stream(data: bytes, block_size: int = BLOCK_SIZE,
                 video: bool = False) -> dict:
    """The host's part of a decode: the dict (if any), the image header
    (with video=True the video parameters after it) and the layout of the
    one upload.  Nothing runs on a device.

    Returns a dict with ``huffman``, ``quant``, ``use_rle``, ``w``, ``h``,
    ``start`` (the header's end bit in the payload), ``n_blocks`` (a
    frame's), ``params`` (a video's VideoParams, else None) and
    ``staging`` (numpy uint8: the stream's byte count as int64, the quant
    matrix f64 [B*B] row-major, the decode table with Huffman, the stream
    zero-padded), with each part's (offset, length) under ``parts``; with
    Huffman also ``dict_end``, ``max_len`` and ``cap`` (the decoded
    payload's capacity in bytes)."""
    if not data:
        raise StreamFormatError("empty stream")
    data = bytes(data)
    out = {"huffman": bool(data[0] & 0x80)}
    if out["huffman"]:
        entries, dict_end = huffman_ops.parse_dict_bytes(data)
        if not entries:
            raise ValueError("huffman_decode called on a stream without a "
                             "dict")
        huffman_ops.validate_dict_entries(entries)
        table, max_len, min_len = huffman_ops.decode_table(entries)
        head = huffman_ops.head_decode(data, dict_end, table, max_len,
                                       header_bytes(block_size, video))
        reader = BitReader(head, position=0)
        out.update(dict_end=dict_end, max_len=max_len,
                   cap=cuda_decode.payload_capacity(
                       8 * len(data) - dict_end, min_len))
    else:
        table = None
        reader = BitReader(data[:65536], position=1)
    quant, use_rle, w, h = read_image_header(reader, block_size)
    params = read_video_params(reader) if video else None
    if (w % block_size or h % block_size) and (
            params is None or params.frame_count):
        raise StreamFormatError(f"image {w}x{h} is not a multiple of the "
                                f"{block_size}-pixel block")
    out.update(quant=quant, use_rle=use_rle, w=w, h=h, params=params,
               start=reader.position,
               n_blocks=(w // block_size) * (h // block_size))
    parts = [("nbytes", np.array([len(data), 0], np.int64)),
             ("quant", quant.as_float().reshape(-1)),
             ("table", table),
             ("stream", np.frombuffer(data, np.uint8))]
    layout, pos = {}, 0
    for name, arr in parts:
        if arr is None:
            continue
        layout[name] = (pos, arr.nbytes)
        pos += -(-arr.nbytes // 16) * 16 + (16 if name == "stream" else 0)
    staging = np.zeros(pos, np.uint8)
    for name, arr in parts:
        if arr is not None:
            off, n = layout[name]
            staging[off:off + n] = np.ascontiguousarray(arr).reshape(
                -1).view(np.uint8)
    out.update(staging=staging, parts=layout)
    return out


def upload(plan: dict, device) -> dict:
    """The staging buffer on ``device`` (to a card one pinned copy that
    does not wait) and its parts as typed views: ``nbytes`` int64 [1],
    ``quant`` f64 [B*B], ``table`` int16 [2**L] with Huffman, ``stream``
    uint8."""
    buf = to_device(plan["staging"], device)
    dtypes = {"nbytes": torch.int64, "quant": torch.float64,
              "table": torch.int16, "stream": torch.uint8}
    views = {}
    for name, (off, n) in plan["parts"].items():
        views[name] = buf[off:off + n].view(dtypes[name])
    views["nbytes"] = views["nbytes"][:1]
    return views


def decode_uploaded(plan: dict, views: dict, norm: str = "reference",
                    block_size: int = BLOCK_SIZE) -> torch.Tensor:
    """The device's part of a decode: D1 (with Huffman), D2 and D3 on the
    uploaded stream, nothing read back.  [H, W] uint8 on the views'
    device."""
    payload, nbytes = views["stream"], views["nbytes"]
    if plan["huffman"]:
        payload, nbytes = cuda_decode.huffman_decode(
            payload, nbytes, plan["dict_end"], views["table"],
            plan["max_len"], plan["cap"])
    offs, dbits, counts, _ = cuda_decode.walk_offsets(
        payload, nbytes, plan["start"], plan["n_blocks"], plan["use_rle"],
        block_size)
    return cuda_decode.decode_blocks(payload, nbytes, offs, dbits, counts,
                                     views["quant"], block_size, norm,
                                     plan["h"], plan["w"])


def decode_image(data: bytes, norm: str = "reference",
                 block_size: int = BLOCK_SIZE, device="cuda") -> torch.Tensor:
    """Decode a reference-format stream to a [H, W] uint8 tensor on
    ``device``, pixel for pixel as imageencoder_tpu.decode_image(data,
    norm, backend="numpy", block_size).

    Raises StreamFormatError on an empty stream, a Huffman dict that no
    code tree represents (before anything runs on the device) or
    dimensions that are no multiple of the block; ValueError on a
    Huffman stream without a dict.
    """
    dev = resolve_device(device)
    with profiling.stage("parse"):
        plan = parse_stream(data, block_size)
    with profiling.stage("upload"):
        views = upload(plan, dev)
    with profiling.stage("device decode"):
        return decode_uploaded(plan, views, norm, block_size)


def read_raw(path: str, size: int) -> np.ndarray:
    """The u8 bytes of a raw file that must hold ``size`` of them; raises
    FileReadError otherwise (the reference exits at read time,
    ImageBase.cpp:22-27)."""
    data = np.fromfile(path, dtype=np.uint8)
    if data.size != size:
        raise FileReadError(f"{path}: {data.size} bytes, expected {size}")
    return data


@dataclass
class ImageEncoder:
    """Driver mirroring dc::ImageEncoder (ImageEncoder.cpp): a raw u8 file
    of width x height pixels in, its stream out."""

    source_file: str
    dest_file: str
    width: int
    height: int
    use_rle: bool
    quant: QuantMatrix
    use_huffman: bool = True
    norm: str = "reference"
    block_size: int = BLOCK_SIZE
    device: str = "cuda"

    def process(self) -> bool:
        img = read_raw(self.source_file, self.width * self.height)
        Logger.write("[ImageEncoder] Processing image...")
        self._result = encode_image(img.reshape(self.height, self.width),
                                    self.quant, self.use_rle,
                                    use_huffman=self.use_huffman,
                                    norm=self.norm,
                                    block_size=self.block_size,
                                    device=self.device)
        return True

    def save_result(self) -> None:
        with open(self.dest_file, "wb") as f:
            f.write(self._result)
        raw = self.width * self.height
        Logger.write(f"[ImageEncoder] Encoded size: {len(self._result)} bytes"
                     f" => Ratio: {len(self._result) / raw * 100:.2f}%")


@dataclass
class ImageDecoder:
    """Driver mirroring dc::ImageDecoder (ImageDecoder.cpp): a stream in,
    its raw u8 pixels out."""

    source_file: str
    dest_file: str
    norm: str = "reference"
    block_size: int = BLOCK_SIZE
    device: str = "cuda"

    def process(self) -> bool:
        with open(self.source_file, "rb") as f:
            data = f.read()
        Logger.write("[ImageDecoder] Processing image...")
        self._result = decode_image(data, norm=self.norm,
                                    block_size=self.block_size,
                                    device=self.device).cpu().numpy()
        return True

    def save_result(self) -> None:
        self._result.tofile(self.dest_file)
        Logger.write(f"[ImageDecoder] Decoded size: {self._result.size} bytes")
