"""K3: the byte histogram of a packed word stream.

The counterpart of imageencoder_tpu/ops/pallas_kernels.py's
byte_histogram (the tile DCT there, K5, is ops/cuda_encode.py's
quantize_image).  Bytes are taken in stream order, ``w>>24, w>>16, w>>8,
w&0xFF``, and only the first ``ceil(total_bits / 8)`` count.  The encode
paths count their histogram in the packer that writes the stream
(ops/cuda_pack.py, ``pack_locals_hist`` and ``pack_coeffs_hist``); this
kernel runs for a stream that arrives packed (the spliced chunks of a
long video, a header-only stream), and its plain version is theirs.
``total_bits`` is a tensor on the words' device, so on the card the
histogram follows the pack with nothing waiting on the host.
:func:`byte_histogram_rows` counts a window of bytes in each row of a
batch of word rows, in one launch: the sharded encode's segments
(parallel/sharding.py), whose counted bytes are not the bytes a packer
stores.  On a CUDA tensor the wrappers launch csrc/histogram.cu; on a CPU
tensor they run the plain versions.
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


def byte_histogram_rows_plain(words: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor) -> torch.Tensor:
    """The plain version of the windowed K3, on any device: int32 [R, 256]."""
    dev = words.device
    data = torch.stack([words_to_u8(row) for row in words])  # [R, 4W]
    idx = torch.arange(data.shape[1], device=dev)[None, :]
    live = (idx >= lo.to(torch.int64)[:, None]) & (
        idx < hi.to(torch.int64)[:, None])
    routed = torch.where(live, data, 256)  # outside the window: bin 256
    hist = torch.zeros((data.shape[0], 257), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, routed, torch.ones_like(routed))
    return hist[:, :256].to(torch.int32)


def byte_histogram_rows(words: torch.Tensor, lo: torch.Tensor,
                        hi: torch.Tensor) -> torch.Tensor:
    """Histogram of the bytes [lo[r], hi[r]) of each row r of ``words``
    (int32 [R, W], u32 bits; bytes in stream order within a row), with
    ``lo`` and ``hi`` int64 [R] on the words' device: int32 [R, 256].  One
    launch for all the rows."""
    if words.dim() != 2 or lo.shape != (words.shape[0],) or (
            hi.shape != lo.shape):
        raise ValueError(f"expected words [R, W] and windows [R], got "
                         f"{tuple(words.shape)}, {tuple(lo.shape)} and "
                         f"{tuple(hi.shape)}")
    if words.device.type == "cpu":
        return byte_histogram_rows_plain(words, lo, hi)
    dev = words.device
    build.require(words, "words", torch.int32, 2, dev)
    lo = lo.to(torch.int64).contiguous()
    hi = hi.to(torch.int64).contiguous()
    build.require(lo, "lo", torch.int64, 1, dev)
    build.require(hi, "hi", torch.int64, 1, dev)
    r, w = words.shape
    hist = torch.zeros((r, 256), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().ie_byte_histogram_rows(
            words.data_ptr(), w, r, lo.data_ptr(), hi.data_ptr(),
            hist.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_byte_histogram_rows")
    byte_histogram_rows.launches += 1
    return hist


byte_histogram_rows.launches = 0
