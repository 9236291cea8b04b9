"""Stream headers, written on the host.

The port's copy of the writers of imageencoder_tpu/models/headers.py.

Image header (ImageEncoder.cpp:84-94):
    [5-bit quant width][size^2 quant values][1-bit rle][15-bit w][15-bit h]
Video parameters follow the dims (VideoEncoder.cpp:65-73):
    [15-bit frame_count][15-bit gop][15-bit merange]
"""

from __future__ import annotations

from dataclasses import dataclass

RLE_BITS = 1
DIM_BITS = 15


def write_image_header(writer, quant, use_rle: bool, width: int,
                       height: int) -> None:
    quant.write(writer)
    writer.put(RLE_BITS, int(use_rle))
    writer.put(DIM_BITS, width)
    writer.put(DIM_BITS, height)


@dataclass
class VideoParams:
    frame_count: int
    gop: int
    merange: int


def write_video_params(writer, p: VideoParams) -> None:
    writer.put(DIM_BITS, p.frame_count)
    writer.put(DIM_BITS, p.gop)
    writer.put(DIM_BITS, p.merange)
