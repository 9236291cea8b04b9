"""The port's serving path on the CPU: encode_image_batch,
encode_image_stream and decode_image_batch (imageencoder_tpu_torch.models
.batch) against the JAX package's exact engine,
imageencoder_tpu.encode_image / decode_image(backend="numpy"), and the
batched plain versions of K2, the dict kernel and K4 pack_payload against
their single-stream plain versions, stream by stream.

The JAX package's own batch encode computes in f32 off a TPU and is not
the parity target; its decode_image_batch(backend="numpy") is."""

import numpy as np
import pytest

import torch

import imageencoder_tpu
from imageencoder_tpu.models import batch as jax_batch
from imageencoder_tpu.utils.quant import QuantMatrix
import imageencoder_tpu_torch as port
from imageencoder_tpu_torch.models import batch
from imageencoder_tpu_torch.ops import (cuda_encode, cuda_kernels, cuda_pack,
                                        dict_table, huffman)

from tests.test_torch_image import JPEG4, quant_for, smooth_image


def images(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.stack([smooth_image(h, w, seed + k) for k in range(b)])


def host_streams(imgs, quant: QuantMatrix, **kw) -> list[bytes]:
    return [imageencoder_tpu.encode_image(img, quant, backend="numpy", **kw)
            for img in imgs]


@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize("use_huffman", [True, False])
@pytest.mark.parametrize("use_rle", [True, False])
@pytest.mark.parametrize("block_size,norm,h,w", [
    (4, "reference", 32, 48), (8, "ortho", 64, 48)])
def test_batch_equals_host_engine_and_single_encodes(b, use_huffman, use_rle,
                                                     block_size, norm, h, w):
    imgs = images(b, h, w, b + h)
    quant = quant_for(block_size)
    kw = dict(use_rle=use_rle, use_huffman=use_huffman, norm=norm,
              block_size=block_size)
    got = port.encode_image_batch(imgs, port.quant_from_numpy(quant.matrix),
                                  device="cpu", **kw)
    assert got == host_streams(imgs, quant, **kw)
    assert got == [port.encode_image(img, port.quant_from_numpy(quant.matrix),
                                     device="cpu", **kw) for img in imgs]


def test_batch_mixes_fallback_and_coded_streams():
    """Three smooth images are Huffman-coded, the noise image takes the
    raw-copy fallback, in one batch: each stream decides alone."""
    imgs = np.concatenate([images(3, 64, 48, 1), np.random.default_rng(9)
                           .integers(0, 256, (1, 64, 48), np.uint8)])
    quant = QuantMatrix(np.array(JPEG4, np.uint32))
    got = port.encode_image_batch(imgs, port.quant_from_numpy(quant.matrix),
                                  use_rle=False, device="cpu")
    assert got == host_streams(imgs, quant, use_rle=False, use_huffman=True)
    assert [bool(s[0] & 0x80) for s in got] == [True, True, True, False]


def test_batch_takes_tensors_and_empty_batches():
    imgs = images(2, 32, 48, 4)
    q = port.quant_from_numpy(JPEG4)
    want = port.encode_image_batch(imgs, q, device="cpu")
    assert port.encode_image_batch(torch.from_numpy(imgs), q,
                                   device="cpu") == want
    assert port.encode_image_batch(imgs[:0], q, device="cpu") == []
    with pytest.raises(ValueError, match="multiple"):
        port.encode_image_batch(imgs[:, :30], q, device="cpu")
    with pytest.raises(TypeError):
        port.encode_image_batch(imgs[0], q, device="cpu")


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("extra", [0, 1, "one"])
@pytest.mark.parametrize("use_huffman", [True, False])
def test_stream_gives_the_streams_in_order(depth, extra, use_huffman):
    """Input lengths 1, depth and depth + 1."""
    n = 1 if extra == "one" else depth + extra
    imgs = images(n, 32, 48, 10 * depth)
    q = port.quant_from_numpy(JPEG4)
    got = port.encode_image_stream(iter(imgs), q, use_huffman=use_huffman,
                                   depth=depth, device="cpu")
    assert not isinstance(got, list)
    assert list(got) == host_streams(imgs, QuantMatrix(
        np.array(JPEG4, np.uint32)), use_huffman=use_huffman)


def test_stream_rejects_a_bad_depth_and_mixed_shapes():
    q = port.quant_from_numpy(JPEG4)
    with pytest.raises(ValueError, match="depth"):
        list(port.encode_image_stream(images(2, 32, 48), q, depth=0,
                                      device="cpu"))
    mixed = [smooth_image(32, 48, 0), smooth_image(48, 32, 1)]
    with pytest.raises(ValueError, match="share a shape"):
        list(port.encode_image_stream(mixed, q, device="cpu"))


@pytest.mark.parametrize("use_huffman", [True, False])
def test_decode_batch_equals_host_decode_batch(use_huffman):
    imgs = images(4, 32, 48, 7)
    streams = host_streams(imgs, QuantMatrix(np.array(JPEG4, np.uint32)),
                           use_huffman=use_huffman)
    got = port.decode_image_batch(streams, device="cpu")
    want = jax_batch.decode_image_batch(streams, backend="numpy")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)
    assert port.decode_image_batch([], device="cpu") == []


# ---- the batched plain versions against the single-stream ones ----

def batch_locals(b: int, h: int = 32, w: int = 48):
    quant = np.array(JPEG4, np.float64)
    got = [cuda_encode.encode_locals(torch.from_numpy(img), quant)
           for img in images(b, h, w, 3)]
    return (torch.stack([g[0] for g in got]),
            torch.stack([g[1] for g in got]))


@pytest.mark.parametrize("hist", [True, False])
def test_pack_locals_batch_plain_is_the_plain_version_per_stream(hist):
    local, lens = batch_locals(3)
    prefix = torch.tensor([-1, -(1 << 20)], dtype=torch.int32)
    batch_fn, single = ((cuda_pack.pack_locals_hist_batch_plain,
                         cuda_pack.pack_locals_hist_plain) if hist else
                        (cuda_pack.pack_locals_batch_plain,
                         cuda_pack.pack_locals_plain))
    got = batch_fn(local, lens, 44, 1000, prefix)
    wrapper = (cuda_pack.pack_locals_hist_batch if hist
               else cuda_pack.pack_locals_batch)
    assert all(torch.equal(a, b) for a, b in zip(
        got, wrapper(local, lens, 44, 1000, prefix)))
    assert got[0].shape == (3, 1000) and got[1].shape == (3,)
    for k in range(3):
        one = single(local[k], lens[k], 44, 1000, prefix)
        assert all(torch.equal(a[k], b) for a, b in zip(got, one))


def test_dict_batch_plain_is_the_plain_version_per_stream():
    words, totals, hists = cuda_pack.pack_locals_hist_batch(
        *batch_locals(4), 12, 1000)
    totals[2] = -1  # a refused stream: no dict
    got = huffman.build_dict_batch_plain(hists, totals)
    assert torch.equal(got, huffman.build_dict_batch(hists, totals))
    assert got.shape == (4, dict_table.TABLE_WORDS)
    for k in range(4):
        assert torch.equal(got[k], huffman.build_dict_plain(hists[k],
                                                            totals[k]))
    assert dict_table.fields(got[2])["fallback"] == 1
    with pytest.raises(ValueError):
        huffman.build_dict_batch(hists[0], totals)


def test_pack_payload_batch_plain_is_the_plain_version_per_stream():
    words, totals, hists = cuda_pack.pack_locals_hist_batch(
        *batch_locals(3), 12, 1000)
    assert torch.equal(hists[1], cuda_kernels.byte_histogram_plain(
        words[1], totals[1]))
    tables = huffman.build_dict_batch(hists, totals)
    n = huffman.payload_words(1000)
    got = cuda_pack.pack_payload_batch_plain(words, tables, n)
    assert all(torch.equal(a, b) for a, b in zip(
        got, cuda_pack.pack_payload_batch(words, tables, n)))
    for k in range(3):
        one = cuda_pack.pack_payload_plain(words[k], tables[k], n)
        assert torch.equal(got[0][k], one[0])
        assert int(got[1][k]) == int(one[1])


def test_tail_reads_a_batch_as_single_encodes_do():
    """huffman_launch over a batch and Tail.finish give each stream's
    Huffman tail, as huffman_encode_from_hist does for one."""
    words, totals, hists = cuda_pack.pack_locals_hist_batch(
        *batch_locals(3), 12, 1000)
    got = huffman.huffman_launch(words, totals, hists).finish()
    assert got == [huffman.huffman_encode_from_hist(w, t, h)
                   for w, t, h in zip(words, totals, hists)]
    raw = huffman.Tail(words, totals)
    raw.read_lengths()
    assert raw.finish() == [bytes(np.asarray(w[:(int(t) + 31) // 32]).astype(
        ">u4").tobytes()[:(int(t) + 7) // 8]) for w, t in zip(words, totals)]


def test_launch_batch_stacks_the_images_block_rows():
    """K1 on [B*H, W] gives the images' records one after another."""
    imgs = images(3, 32, 48, 2)
    quant = np.array(JPEG4, np.float64)
    stacked = cuda_encode.encode_locals(
        torch.from_numpy(imgs).reshape(96, 48), quant)
    for k, img in enumerate(imgs):
        one = cuda_encode.encode_locals(torch.from_numpy(img), quant)
        n = one[0].shape[0]
        assert torch.equal(stacked[0][k * n:(k + 1) * n], one[0])
        assert torch.equal(stacked[1][k * n:(k + 1) * n], one[1])
    tail = batch.launch_batch(torch.from_numpy(imgs),
                              port.quant_from_numpy(JPEG4), True, False,
                              "reference", 4)
    assert tail.words.shape[1] % 4 == 0
