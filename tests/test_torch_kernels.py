"""K3 port (imageencoder_tpu_torch/ops/cuda_kernels.py) against the JAX
package, on the CPU, where the wrapper runs its plain version: the byte
histogram equals pallas_kernels.byte_histogram(..., interpret=True) and
pipeline.stream_byte_histogram, with ragged byte counts."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from imageencoder_tpu.ops import pipeline as jax_pipeline
from imageencoder_tpu.ops.pallas_kernels import byte_histogram
from imageencoder_tpu_torch.ops import cuda_kernels
from imageencoder_tpu_torch.ops import pipeline as torch_pipeline


def random_words(seed: int, nwords: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # A skewed byte distribution, as packed streams have.
    return (rng.integers(0, 2 ** 32, nwords, dtype=np.uint64)
            & 0x0FFF3FFF).astype(np.uint32)


@pytest.mark.parametrize("seed,nwords,tail", [(0, 10000, 3), (1, 4096, 0),
                                              (2, 100, 1)])
def test_byte_histogram_matches_pallas(seed, nwords, tail):
    words = random_words(seed, nwords)
    nbytes = nwords * 4 - tail
    want = np.asarray(byte_histogram(jnp.asarray(words), nbytes,
                                     interpret=True))
    # A total that is not a whole number of bytes still counts its last one.
    total = torch.tensor(8 * nbytes - 5, dtype=torch.int64)
    got = cuda_kernels.byte_histogram(torch.from_numpy(words.view(np.int32)),
                                      total)
    assert got.dtype == torch.int32 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("total_bits", [0, 1, 8 * 777 + 3, 32 * 2048])
def test_stream_byte_histogram_matches_jax(total_bits):
    words = random_words(5, 2048)
    want = np.asarray(jax_pipeline.stream_byte_histogram(
        jnp.asarray(words), jnp.int32(total_bits)))
    got = torch_pipeline.stream_byte_histogram(
        torch.from_numpy(words.view(np.int32)),
        torch.tensor(total_bits, dtype=torch.int64))
    assert got.dtype == torch.int32 and got.shape == (257,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_byte_order_is_big_endian():
    """Byte 0 of the stream is the top byte of word 0, whatever the
    host's endianness."""
    words = torch.tensor([0x01020304], dtype=torch.int64)
    hist = cuda_kernels.byte_histogram(words.to(torch.int32),
                                       torch.tensor(8))  # one byte only
    assert hist[1].item() == 1 and int(hist.sum()) == 1
