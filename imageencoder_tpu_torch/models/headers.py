"""Stream headers, written on the host.

The port's copy of imageencoder_tpu/models/headers.py: the writers, and
the readers the decoder parses a stream's header with.

Image header (ImageEncoder.cpp:84-94):
    [5-bit quant width][size^2 quant values][1-bit rle][15-bit w][15-bit h]
Video parameters follow the dims (VideoEncoder.cpp:65-73):
    [15-bit frame_count][15-bit gop][15-bit merange]
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.quant import QuantMatrix

RLE_BITS = 1
DIM_BITS = 15


def write_image_header(writer, quant, use_rle: bool, width: int,
                       height: int) -> None:
    quant.write(writer)
    writer.put(RLE_BITS, int(use_rle))
    writer.put(DIM_BITS, width)
    writer.put(DIM_BITS, height)


def read_image_header(reader, block_size: int = 4):
    """(quant, use_rle, width, height) from a BitReader at the header."""
    quant = QuantMatrix.from_bitstream(reader, block_size)
    use_rle = bool(reader.get(RLE_BITS))
    width = reader.get(DIM_BITS)
    height = reader.get(DIM_BITS)
    return quant, use_rle, width, height


@dataclass
class VideoParams:
    frame_count: int
    gop: int
    merange: int


def write_video_params(writer, p: VideoParams) -> None:
    writer.put(DIM_BITS, p.frame_count)
    writer.put(DIM_BITS, p.gop)
    writer.put(DIM_BITS, p.merange)


def read_video_params(reader) -> VideoParams:
    return VideoParams(frame_count=reader.get(DIM_BITS),
                       gop=reader.get(DIM_BITS),
                       merange=reader.get(DIM_BITS))
