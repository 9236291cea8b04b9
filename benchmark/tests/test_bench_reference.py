"""The reference (benchmark/reference/) against the port's plain path at
tiny sizes: its streams byte for byte and its frames pixel for pixel.
The test calls both; the reference never calls the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import content
from benchmark.reference import codec, huffman

from conftest import QUANT


def _port_quant():
    from imageencoder_tpu_torch import QuantMatrix

    return QuantMatrix(np.array(QUANT, dtype=np.uint32))


@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("huff", [True, False])
@pytest.mark.parametrize("shape", [(32, 48), (64, 128)])
def test_image_streams_equal_the_port(rle, huff, shape):
    from imageencoder_tpu_torch import encode_image

    pool = content.image_pool(4, *shape, seed=11, device="cpu",
                              noise_every=2)
    for img in pool:
        assert codec.encode_image(img, QUANT, rle, huff) == encode_image(
            img, _port_quant(), rle, huff, device="cpu")


def test_batch_streams_equal_the_port():
    from imageencoder_tpu_torch import encode_image_batch

    pool = content.image_pool(8, 32, 64, seed=12, device="cpu",
                              noise_every=4)
    got = encode_image_batch(pool[2:6], _port_quant(), device="cpu")
    assert got == [codec.encode_image(img, QUANT) for img in pool[2:6]]


@pytest.mark.parametrize("huff", [True, False])
@pytest.mark.parametrize("frames,gop", [(6, 4), (9, 4), (5, 1)])
def test_video_streams_and_frames_equal_the_port(huff, frames, gop):
    from imageencoder_tpu_torch import decode_frames
    from imageencoder_tpu_torch.models.video import encode_frames

    clip = content.video_clips(1, frames, 48, 64, seed=13, device="cpu")[0]
    video = codec.encode_video(clip, QUANT, True, gop, 16, huff)
    assert video.data == encode_frames(clip, 64, 48, _port_quant(), True,
                                       gop, 16, huff, device="cpu")
    assert torch.equal(codec.decode_video(video, "cpu"),
                       decode_frames(video.data, device="cpu"))


def test_vectors_move_with_the_content():
    """The clips move (2, 3) px a frame: the search finds vectors."""
    clip = content.video_clips(1, 5, 48, 64, seed=14, device="cpu")[0]
    video = codec.encode_video(clip, QUANT, True, 4, 16)
    assert any(int(v.abs().sum()) for v in video.vectors.values())


def test_dict_limits_deep_histograms_to_15_bits():
    counts = [0] * 256
    for s in range(40):
        counts[s] = 2 ** min(s, 30)  # a depth far past 15
    _, codes, lengths = huffman.code_table(counts)
    assert max(lengths) == huffman.MAX_CODE_LEN
    assert sum(2.0 ** -ln for ln in lengths if ln) <= 1.0


def test_fallback_when_huffman_does_not_shrink():
    """Two symbols in equal measure: the codes are 1 bit, so a dict and a
    short stream are larger than the bytes; the stream is [0][bytes]."""
    inner = torch.tensor([0, 255, 0, 255], dtype=torch.uint8)
    out = codec.huffman_wrap(inner)
    assert len(out) == 5 and out[0] >> 7 == 0
    bits = int.from_bytes(out, "big") >> 7
    assert bits.to_bytes(4, "big") == bytes(inner.tolist())
