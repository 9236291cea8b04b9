"""Images of zero blocks (0 x W, H x 0, 0 x 0) through the port on the CPU,
against the JAX package at tolerance 0:

  * their streams, Huffman on and off, decode through decode_image,
    decode_image_batch and the ImageDecoder driver to the empty image
    decode_image(backend="numpy") returns (decode_image_sharded in a gloo
    world: tests/test_torch_video_sharded.py);
  * a stream cut anywhere inside its header decodes, or is refused, as
    the JAX package decodes or refuses it: the same shape, or the same
    exception type;
  * encode_image_batch and encode_image_stream of zero-block images give
    the JAX package's encode_image_batch streams, each its encode_image.
"""

import numpy as np
import pytest

import torch

import imageencoder_tpu
from imageencoder_tpu.models import batch as jax_batch
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch as port
from imageencoder_tpu_torch.models.image import ImageDecoder

QM = QuantMatrix(np.full((4, 4), 8, np.uint32))
QP = port.quant_from_numpy(QM.matrix)
SHAPES = [(0, 16), (16, 0), (0, 0)]


def stream(shape, huff: bool) -> bytes:
    return imageencoder_tpu.encode_image(np.zeros(shape, np.uint8), QM,
                                         use_huffman=huff, backend="numpy")


def outcome(fn, data):
    """("ok", shape) of what fn(data) returns, or ("raises", its type)."""
    try:
        return "ok", tuple(np.asarray(fn(data)).shape)
    except Exception as e:  # noqa: BLE001 - the type is compared
        return "raises", type(e).__name__


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("huff", [True, False])
def test_encode_image_equals_host_engine(shape, huff):
    assert port.encode_image(np.zeros(shape, np.uint8), QP, use_huffman=huff,
                             device="cpu") == stream(shape, huff)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("huff", [True, False])
def test_decode_entry_points_return_the_empty_image(shape, huff, tmp_path):
    data = stream(shape, huff)
    want = imageencoder_tpu.decode_image(data, backend="numpy")
    assert want.shape == shape and want.dtype == np.uint8
    got = port.decode_image(data, device="cpu")
    assert tuple(got.shape) == shape and got.dtype == torch.uint8
    batch = port.decode_image_batch([data, data], device="cpu")
    assert [tuple(x.shape) for x in batch] == [shape, shape]
    src, dst = tmp_path / "in.enc", tmp_path / "out.raw"
    src.write_bytes(data)
    drv = ImageDecoder(str(src), str(dst), device="cpu")
    assert drv.process()
    drv.save_result()
    assert dst.read_bytes() == want.tobytes() == b""


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("huff", [True, False])
def test_streams_cut_inside_the_header_match_the_host_engine(shape, huff):
    """Every cut of a zero-block stream, all header: the same shape, or
    the same exception, as the JAX package; the cuts that read a
    dimension as 0 decode to an empty image."""
    data = stream(shape, huff)
    empties = 0
    for cut in range(len(data) + 1):
        want = outcome(lambda d: imageencoder_tpu.decode_image(
            d, backend="numpy"), data[:cut])
        got = outcome(lambda d: port.decode_image(d, device="cpu").numpy(),
                      data[:cut])
        assert got == want, cut
        empties += want[0] == "ok" and 0 in want[1]
    assert empties


@pytest.mark.parametrize("shape", [(2, 0, 16), (2, 16, 0), (3, 0, 0)],
                         ids=str)
@pytest.mark.parametrize("huff", [True, False])
def test_batch_and_stream_encode_zero_block_images(shape, huff):
    imgs = np.zeros(shape, np.uint8)
    want = jax_batch.encode_image_batch(imgs, QM, use_huffman=huff)
    assert list(want) == [stream(shape[1:], huff)] * shape[0]
    assert port.encode_image_batch(imgs, QP, use_huffman=huff,
                                   device="cpu") == list(want)
    assert list(port.encode_image_stream(imgs, QP, use_huffman=huff,
                                         device="cpu")) == list(want)
