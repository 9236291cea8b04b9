"""Still-image encode on a torch device.

The counterpart of imageencoder_tpu/models/image.py::encode_image with
backend="jax" (models/image.py:73-113).  The host writes the header bits
exactly as the JAX package does (models/headers.py); the device runs the
transform and the pack, which with Huffman counts the byte histogram
(ops/pipeline.py), then the dict and the payload pack (ops/huffman.py),
and the host waits once before it copies the stream.  Decoding stays on the JAX package's
host engine: imageencoder_tpu.decode_image(backend="fast") reads these
streams.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bitpack import BitWriter
from ..ops.device_pack import (header_to_words, host_total, stream_bytes,
                               to_device)
from ..ops.huffman import huffman_encode_from_hist
from ..ops.pipeline import make_encode_packed, make_encode_packed_hist
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.quant import QuantMatrix
from .headers import write_image_header

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
        return stream_bytes(words, host_total(total))
