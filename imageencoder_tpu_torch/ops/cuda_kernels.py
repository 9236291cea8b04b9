"""K3: the byte histogram of a packed word stream.

The counterpart of imageencoder_tpu/ops/pallas_kernels.py's
byte_histogram (the tile DCT there, K5, is ops/cuda_encode.py's
quantize_image).  Bytes are taken in stream order, ``w>>24, w>>16, w>>8,
w&0xFF``, and only the first ``ceil(total_bits / 8)`` count.  The encode
paths count their histogram in the packer that writes the stream
(ops/cuda_pack.py, ``pack_locals_hist`` and ``pack_coeffs_hist``); this
kernel runs for a stream that arrives packed (the spliced chunks of a
long video, a header-only stream), and its plain version is theirs.  ``total_bits`` is a tensor on the words'
device, so on the card the histogram follows the pack with nothing waiting
on the host.  On a CUDA tensor :func:`byte_histogram` launches
csrc/histogram.cu; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .device_pack import words_to_u8


def byte_histogram_plain(words: torch.Tensor,
                         total_bits: torch.Tensor) -> torch.Tensor:
    """The plain version of K3, on any device: int32 [256]."""
    dev = words.device
    nbytes = (total_bits.reshape(()).to(torch.int64) + 7) // 8
    data = words_to_u8(words)
    idx = torch.arange(data.shape[0], device=dev)
    routed = torch.where(idx < nbytes, data, 256)  # past the stream: bin 256
    hist = torch.zeros(257, dtype=torch.int64, device=dev)
    hist.index_add_(0, routed, torch.ones_like(routed))
    return hist[:256].to(torch.int32)


def byte_histogram(words: torch.Tensor,
                   total_bits: torch.Tensor) -> torch.Tensor:
    """Histogram of the stream's first ceil(total_bits / 8) bytes.

    words: int32 [W] (u32 bits); total_bits: integer tensor of one element
    on the same device.  Returns int32 [256].
    """
    if words.device.type == "cpu":
        return byte_histogram_plain(words, total_bits)
    dev = words.device
    build.require(words, "words", torch.int32, 1, dev)
    total = total_bits.reshape(1).to(torch.int64).contiguous()
    build.require(total, "total_bits", torch.int64, 1, dev)
    hist = torch.zeros(256, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().ie_byte_histogram(
            words.data_ptr(), words.shape[0], total.data_ptr(),
            hist.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_byte_histogram")
    byte_histogram.launches += 1
    return hist


byte_histogram.launches = 0
