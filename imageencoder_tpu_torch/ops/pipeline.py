"""The device image encode: pixels -> packed stream words (+ histogram).

The counterpart of imageencoder_tpu/ops/pipeline.py's make_encode_packed
and make_encode_packed_hist.  On the card the path is three kernels with
nothing waiting on the host between them:

    K1 encode_locals  (ops/cuda_encode.py)   pixels -> register files
    K2 pack_locals    (ops/cuda_pack.py)     register files -> stream words
    K3 byte_histogram (ops/cuda_kernels.py)  words -> Huffman statistics

The host-built header words are OR'd into the first HEADER_WORDS words, so
the words are the complete inner stream.
"""

from __future__ import annotations

import torch

from . import cuda_encode, cuda_kernels, cuda_pack
from .device_pack import packed_words_bound


def stream_byte_histogram(words: torch.Tensor,
                          total_bits: torch.Tensor) -> torch.Tensor:
    """int32 [257]: slot 0 total_bits, slots 1..256 the byte histogram, so
    the host reads both in one device-to-host copy."""
    hist = cuda_kernels.byte_histogram(words, total_bits)
    return torch.cat([total_bits.reshape(1).to(torch.int32), hist])


def make_encode_packed(block_size: int = 4, use_rle: bool = True,
                       norm: str = "reference"):
    """f(img u8 [H, W], quant [B, B], start_bit, header_words int32 [64])
    -> (words int32 [9N + 64], total_bits int64 0-d tensor, -1 where K1
    refused a record: K2 refuses it too)."""
    k = block_size * block_size

    def encode_packed(img, quant, start_bit: int, header_words):
        local, lens, _ = cuda_encode.encode_locals(img, quant, block_size,
                                                   use_rle, norm)
        return cuda_pack.pack_locals(
            local, lens, start_bit,
            packed_words_bound(local.shape[0], k + 2), prefix=header_words)

    return encode_packed


def make_encode_packed_hist(block_size: int = 4, use_rle: bool = True,
                            norm: str = "reference"):
    """make_encode_packed plus the byte histogram of the stream:
    f(...) -> (words, meta int32 [257])."""
    base = make_encode_packed(block_size, use_rle, norm)

    def encode_packed_hist(img, quant, start_bit: int, header_words):
        words, total = base(img, quant, start_bit, header_words)
        return words, stream_byte_histogram(words, total)

    return encode_packed_hist
