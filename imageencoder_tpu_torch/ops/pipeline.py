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
"""

from __future__ import annotations

from . import cuda_encode, cuda_pack
from .device_pack import packed_words_bound


def make_encode_packed(block_size: int = 4, use_rle: bool = True,
                       norm: str = "reference", with_hist: bool = False):
    """f(img u8 [H, W], quant [B, B], start_bit, header_words int32 [64])
    -> (words int32 [9N + 64], total_bits int64 0-d tensor, -1 where K1
    refused a record: K2 refuses it too), and with ``with_hist`` the
    stream's byte histogram int32 [256] after them."""
    k = block_size * block_size

    def encode_packed(img, quant, start_bit: int, header_words):
        local, lens, _ = cuda_encode.encode_locals(img, quant, block_size,
                                                   use_rle, norm)
        pack = cuda_pack.pack_locals_hist if with_hist else \
            cuda_pack.pack_locals
        return pack(local, lens, start_bit,
                    packed_words_bound(local.shape[0], k + 2),
                    prefix=header_words)

    return encode_packed


def make_encode_packed_hist(block_size: int = 4, use_rle: bool = True,
                            norm: str = "reference"):
    """make_encode_packed plus the byte histogram of the stream:
    f(...) -> (words, total_bits, hist int32 [256])."""
    return make_encode_packed(block_size, use_rle, norm, with_hist=True)
