"""The device image encode: pixels -> packed stream words (+ histogram).

The counterpart of imageencoder_tpu/ops/pipeline.py's make_encode_packed
and make_encode_packed_hist.  On the card the path is two kernels with
nothing waiting on the host between them:

    K1 encode_locals  (ops/cuda_encode.py)  pixels -> register files
    K2 pack_locals    (ops/cuda_pack.py)    register files -> stream words
                                            (two launches), and with the
                                            histogram the byte counts that
                                            K3 took in the JAX package

The host-built header words are OR'd into the first HEADER_WORDS words, so
the words are the complete inner stream.

The fields API (the JAX package's ops/pipeline.py:72-146) gives the wire
fields of the blocks instead of the packed stream: :func:`transform_quantize`
(K5 on the card, then the zig-zag gather) and :func:`fields_from_coeffs`
(ops/rle.py's torch ops, which the JAX package runs in XLA outside any
Pallas kernel), and the factories :func:`make_encode_fields` and
:func:`make_encode_fields_from_blocks`.  The sharded encode step
(parallel/sharding.py) runs them on each shard.
"""

from __future__ import annotations

import torch

from . import cuda_encode, cuda_pack, rle
from .device_pack import packed_words_bound
from .zigzag import zigzag_order


def transform_quantize(img: torch.Tensor, quant, block_size: int = 4,
                       norm: str = "reference") -> torch.Tensor:
    """[H, W] u8 -> int32 [N, K] quantized coefficients in zig-zag order,
    blocks in row-major order: K5 (cuda_encode.quantize_image) writes them
    in place, then a gather puts each block's in zig-zag order.  Equal to
    imageencoder_tpu.ops.dct.forward_transform_quantize_zz, the host
    engine's exact f64 transform."""
    coeffs = cuda_encode.quantize_image(img, quant, block_size, norm)
    zz = cuda_encode.device_constant(zigzag_order(block_size), img.device)
    return cuda_encode._blocks(coeffs, block_size)[:, zz]


def fields_from_coeffs(coeffs_zz: torch.Tensor, use_rle: bool):
    """[N, K] zig-zag coefficients -> (vals int32 [N, K+2], nbits int32
    [N, K+2]): the 4-bit width, the count (RLE only) and the payload
    fields of each block (ops/rle.py), unused slots of width 0."""
    stats = rle.block_stats(coeffs_zz, use_rle)
    vals, nbits = rle.block_fields(coeffs_zz, stats, use_rle)
    return vals.to(torch.int32), nbits.to(torch.int32)


def make_encode_fields(block_size: int = 4, use_rle: bool = True,
                       norm: str = "reference"):
    """f(img u8 [H, W], quant [B, B]) -> (vals, nbits) int32 [N, K+2]."""

    def encode_fields(img, quant):
        return fields_from_coeffs(
            transform_quantize(img, quant, block_size, norm), use_rle)

    return encode_fields


def make_encode_fields_from_blocks(block_size: int = 4, use_rle: bool = True,
                                   norm: str = "reference"):
    """:func:`make_encode_fields` over tiles u8 [N, B, B]: the tiles in
    order are the block rows of the image [N*B, B], so the same step
    takes them."""
    fields = make_encode_fields(block_size, use_rle, norm)

    def encode_fields(blocks, quant):
        n, b, b2 = blocks.shape
        if b != block_size or b2 != block_size:
            raise ValueError(f"expected [N, {block_size}, {block_size}] "
                             f"tiles, got {tuple(blocks.shape)}")
        return fields(blocks.reshape(n * b, b), quant)

    return encode_fields


def make_encode_packed(block_size: int = 4, use_rle: bool = True,
                       norm: str = "reference", with_hist: bool = False):
    """f(img u8 [H, W], quant [B, B], start_bit, header_words int32 [64])
    -> (words int32 [packed_words_bound(N, lw)], total_bits int64 0-d
    tensor, -1 where K1 refused a record: K2 refuses it too), and with
    ``with_hist`` the stream's byte histogram int32 [256] after them."""
    def encode_packed(img, quant, start_bit: int, header_words):
        local, lens, _ = cuda_encode.encode_locals(img, quant, block_size,
                                                   use_rle, norm)
        pack = cuda_pack.pack_locals_hist if with_hist else \
            cuda_pack.pack_locals
        return pack(local, lens, start_bit,
                    packed_words_bound(*local.shape),
                    prefix=header_words)

    return encode_packed


def make_encode_packed_hist(block_size: int = 4, use_rle: bool = True,
                            norm: str = "reference"):
    """make_encode_packed plus the byte histogram of the stream:
    f(...) -> (words, total_bits, hist int32 [256])."""
    return make_encode_packed(block_size, use_rle, norm, with_hist=True)
