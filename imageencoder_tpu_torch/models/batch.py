"""Batched and streamed image serving on a torch device.

The counterpart of imageencoder_tpu/models/batch.py, the production
serving path: one call per image pays the host's launch and copy costs
per image, a batch pays them once.

:func:`encode_image_batch` stacks B same-shape images into one [B*H, W]
image, so that K1's row-major blocks are image-major, and runs each
kernel once for the whole batch: K1, K2 over B streams (each in its own
row of words from the shared header's end bit: no word holds bits of two
images, and no pseudo-record stands between them, unlike the TPU path's
gap and pad records), then with Huffman the dict kernel and K4
pack_payload over B streams, then the wire emit (every stream's bytes in
wire order in one buffer on the device).  The host waits once for the B
streams' lengths and at most once for their one copy
(ops/huffman.py::Tail), whatever B is.

:func:`encode_image_stream` is a pipeline over an iterable of images:
image i + depth is uploaded and launched before image i is finished, and
each image's copy is chained after the previous image's, so the host
waits once per image (and once more at the end of the stream).

:func:`decode_image_batch` issues each stream's decode (models/image.py:
parse, one upload, D1-D3) with no wait between streams, so the host's
parse of stream i + 1 overlaps the card's decode of stream i; the pixels
stay on the device.

Every stream equals imageencoder_tpu.encode_image(..., backend="numpy")
of its image, and every image decode_image(..., backend="numpy") of its
stream.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..ops import cuda_encode, cuda_pack
from ..ops.device_pack import packed_words_bound, to_device
from ..ops.huffman import Tail, huffman_launch
from ..ops.pipeline import make_encode_packed, make_encode_packed_hist
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.quant import QuantMatrix
from .image import (BLOCK_SIZE, decode_uploaded, parse_stream,
                    stream_header, upload)


def on_device(x, dev: torch.device) -> torch.Tensor:
    """u8 pixels (a numpy array or a tensor) on ``dev``; from the host
    through pinned memory by a copy that does not wait.  A tensor already
    on a device of ``dev``'s type stays there, or moves card to card."""
    if isinstance(x, torch.Tensor):
        if x.device.type == dev.type:
            return x.to(dev).contiguous()
        x = x.numpy()
    return to_device(np.ascontiguousarray(x), dev)


def _check(imgs: torch.Tensor, ndim: int, block_size: int) -> None:
    if imgs.dtype != torch.uint8 or imgs.dim() != ndim:
        kind = "[B, H, W]" if ndim == 3 else "[H, W]"
        raise TypeError(f"expected {kind} uint8 images, got {imgs.dtype} "
                        f"{tuple(imgs.shape)}")
    h, w = imgs.shape[-2:]
    if h % block_size or w % block_size:
        raise ValueError(f"image {h}x{w} is not a multiple of the "
                         f"{block_size}-pixel block")


def launch_batch(imgs: torch.Tensor, quant: QuantMatrix, use_rle: bool,
                 use_huffman: bool, norm: str, block_size: int) -> Tail:
    """The device half of a batch encode of u8 [B, H, W] on the device:
    K1 once on the stacked images, K2 over the B streams, with Huffman
    the dict kernel and K4 over them; the lengths' copy started, then the
    wire emit.  Nothing waits."""
    b, h, w = imgs.shape
    dev = imgs.device
    start_bit, header = stream_header(quant, use_rle, w, h, use_huffman,
                                      dev)
    local, lens, _ = cuda_encode.encode_locals(
        imgs.reshape(b * h, w), quant.as_float(), block_size, use_rle, norm)
    n = local.shape[0] // b
    n_words = packed_words_bound(n, local.shape[1])
    args = (local.view(b, n, local.shape[1]), lens.view(b, n), start_bit,
            n_words,
            header)
    if use_huffman:
        return huffman_launch(*cuda_pack.pack_locals_hist_batch(*args))
    return Tail(*cuda_pack.pack_locals_batch(*args), read=True)


def encode_image_batch(imgs, quant: QuantMatrix, use_rle: bool = True,
                       use_huffman: bool = True, norm: str = "reference",
                       block_size: int = BLOCK_SIZE,
                       device="cuda") -> list[bytes]:
    """Encode a batch of same-shape images, u8 [B, H, W] (a numpy array or
    a tensor), on ``device``: one stream per image, each byte-identical to
    imageencoder_tpu.encode_image(img, quant, ..., backend="numpy")."""
    dev = resolve_device(device)
    with profiling.stage("upload"):
        imgs = on_device(imgs, dev)
    _check(imgs, 3, block_size)
    if imgs.shape[0] == 0:
        return []
    with profiling.stage("device batch encode"):
        tail = launch_batch(imgs, quant, use_rle, use_huffman, norm,
                            block_size)
    with profiling.stage("copy"):
        return tail.finish()


def encode_image_stream(imgs, quant: QuantMatrix, use_rle: bool = True,
                        use_huffman: bool = True, norm: str = "reference",
                        block_size: int = BLOCK_SIZE, depth: int = 2,
                        device="cuda"):
    """Pipelined streaming encode of an iterable of same-shape u8 [H, W]
    images: yields one stream per image, in input order, each
    byte-identical to encode_image(img, ...).

    Up to ``depth`` (at least 1) images are launched ahead of the one
    being finished.  An image's lengths are copied after the previous
    image's stream, so the one wait for them also covers that copy: one
    wait per image, and one at the end.  The streams' bytes come through
    depth + 1 pinned buffers, each reused by image i + depth + 1 after
    image i's bytes were read from it, that is after its copy's event
    fired.
    """
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")
    dev = resolve_device(device)
    slots: list[torch.Tensor | None] = [None] * (depth + 1)
    launched: collections.deque = collections.deque()  # (index, tail)
    copied = None  # the tail copied last, its bytes not yet returned
    fn = shape = None

    def advance():
        """Copy the oldest launched image's stream; return the bytes of
        the one copied before it (None for the first)."""
        nonlocal copied
        i, tail = launched.popleft()
        tail.copy(slots[i % len(slots)])  # the one wait, for its lengths
        slots[i % len(slots)] = tail.buffer
        if launched:
            launched[0][1].read_lengths()  # queued after this copy
        done, copied = copied, tail
        return None if done is None else done.result()[0]  # no wait

    for i, img in enumerate(imgs):
        img = on_device(img, dev)
        _check(img, 2, block_size)
        if shape is None:
            shape = tuple(img.shape)
            h, w = shape
            start_bit, header = stream_header(quant, use_rle, w, h,
                                              use_huffman, dev)
            fn = (make_encode_packed_hist if use_huffman
                  else make_encode_packed)(block_size, use_rle, norm)
        elif tuple(img.shape) != shape:
            raise ValueError(f"stream images must share a shape: "
                             f"{tuple(img.shape)} != {shape}")
        if len(launched) == depth:
            got = advance()
            if got is not None:
                yield got
        got = fn(img, quant.as_float(), start_bit, header)
        if use_huffman:
            tail = huffman_launch(*got, read=False)
        else:
            tail = Tail(got[0][None], got[1].reshape(1))
        if not launched:
            tail.read_lengths()  # the head of the chain
        launched.append((i, tail))
    while launched:
        got = advance()
        if got is not None:
            yield got
    if copied is not None:
        yield copied.result()[0]


def decode_image_batch(streams, norm: str = "reference",
                       block_size: int = BLOCK_SIZE,
                       device="cuda") -> list[torch.Tensor]:
    """Decode many streams on ``device``: u8 [H, W] tensors left there,
    each equal to imageencoder_tpu.decode_image(stream, norm,
    backend="numpy", block_size=block_size).  Each stream is parsed,
    uploaded and decoded in turn, with no wait for the device between
    them."""
    dev = resolve_device(device)
    out = []
    for data in streams:
        with profiling.stage("parse"):
            plan = parse_stream(data, block_size, pinned=dev.type == "cuda")
        with profiling.stage("upload"):
            views = upload(plan, dev)
        with profiling.stage("device decode"):
            out.append(decode_uploaded(plan, views, norm, block_size))
    return out
