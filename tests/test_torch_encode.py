"""K1 port (imageencoder_tpu_torch/ops/cuda_encode.py) against the JAX
package, on the CPU, where the wrapper runs its plain version.

  * transform_quantize_zz equals the host engine's exact f64 transform
    (imageencoder_tpu.ops.dct.forward_transform_quantize_zz) bit for bit,
    and is within the documented f32 tie class of the JAX f32 transform;
  * locals_from_coeffs, fed the TPU kernel's own f32 Kronecker
    coefficients, gives register files and lengths bit-equal to
    pallas_encode.encode_locals(..., interpret=True) on the live records.

Inputs are seeded numpy images and QuantMatrix(np.array(...)) matrices.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from imageencoder_tpu.ops import rle as jax_rle
from imageencoder_tpu.ops.blockify import blockify
from imageencoder_tpu.ops.dct import dct_matrix, forward_transform_quantize_zz
from imageencoder_tpu.ops.pallas_encode import (blockify_columns,
                                                encode_locals, frontend_lw,
                                                frontend_matrices)
from imageencoder_tpu.ops.pipeline import transform_quantize
from imageencoder_tpu.ops.zigzag import zigzag_order
from imageencoder_tpu.utils.quant import QuantMatrix
from imageencoder_tpu_torch.ops import cuda_encode
from imageencoder_tpu_torch.ops import rle as torch_rle

JPEG4 = [[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
         [14, 17, 22, 29]]


def quant_for(b: int, kind: str) -> QuantMatrix:
    if kind == "ones":
        return QuantMatrix(np.ones((b, b), np.uint32))
    if kind == "large":
        return QuantMatrix(np.full((b, b), 500, np.uint32))
    if b == 4:
        return QuantMatrix(np.array(JPEG4, np.uint32))
    i, j = np.indices((b, b))
    return QuantMatrix((1 + 2 * (i + j)).astype(np.uint32))


def image(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w)) // 2 + 64).astype(np.uint8)


def kron_coeffs(img, qv, b, norm):
    """The TPU kernel's f32 coefficient definition (the recipe of
    tests/test_pallas_encode.py): [N, K] zig-zag order."""
    a, bz, zz = frontend_matrices(b, norm)
    n = (img.shape[0] // b) * (img.shape[1] // b)
    x = blockify_columns(jnp.asarray(img), b, n)
    m = jnp.dot(jnp.asarray(a), x, precision=jax.lax.Precision.HIGHEST)
    y = jnp.dot(jnp.asarray(bz), m, precision=jax.lax.Precision.HIGHEST)
    qzz = jnp.asarray(qv, jnp.float32).reshape(-1)[jnp.asarray(zz)]
    z = y / qzz[:, None]
    t = jnp.trunc(z)
    inc = jnp.where(jnp.abs(z - t) >= 0.5,
                    jnp.where(z >= 0.0, 1.0, -1.0), 0.0)
    return np.asarray((t + inc).astype(jnp.int32).T)


CASES = [  # h, w, use_rle, block size, norm, quant
    (64, 64, True, 4, "reference", "jpeg"),
    (64, 64, False, 4, "reference", "jpeg"),
    (20, 24, True, 4, "reference", "jpeg"),   # not a multiple of a chunk
    (64, 64, True, 8, "ortho", "jpeg"),
    (32, 32, True, 4, "reference", "ones"),
    (32, 32, False, 4, "reference", "large"),
]


@pytest.mark.parametrize("h,w,use_rle,b,norm,qkind", CASES)
def test_transform_quantize_zz_equals_exact_host(h, w, use_rle, b, norm,
                                                 qkind):
    img = image(h, w, h * 100 + w)
    quant = quant_for(b, qkind)
    want = forward_transform_quantize_zz(blockify(img, b), quant.as_float(),
                                         norm, zigzag_order(b))
    got = cuda_encode.transform_quantize_zz(torch.from_numpy(img),
                                            quant.as_float(), b, norm)
    np.testing.assert_array_equal(got.numpy(), want)


def test_transform_rounds_half_away_from_zero():
    """Exact .5 quotients round away from zero (torch.round would take
    the even neighbour): a block whose pixels sum to 128*16 +- 10 has DC
    = +-2.5 under the reference norm and quant 1."""
    img = np.full((4, 8), 128, np.uint8)
    img[0, 0] = 138
    img[0, 4] = 118
    quant = QuantMatrix(np.ones((4, 4), np.uint32))
    got = cuda_encode.transform_quantize_zz(torch.from_numpy(img),
                                            quant.as_float(), 4, "reference")
    assert got[0, 0].item() == 3 and got[1, 0].item() == -3
    want = forward_transform_quantize_zz(blockify(img, 4), quant.as_float(),
                                         "reference", zigzag_order(4))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,norm", [(4, "reference"), (8, "ortho")])
def test_transform_within_f32_tie_class_of_jax(b, norm):
    """The JAX f32 transform differs from the exact one only at rounding
    ties (tests/test_pallas_encode.py:86-97)."""
    img = np.random.default_rng(7).integers(0, 256, (64, 64), np.uint8)
    quant = quant_for(b, "jpeg")
    qv = quant.as_float(np.float32)
    dm = jnp.asarray(np.asarray(dct_matrix(b, norm), np.float32))
    jax_cz = np.asarray(transform_quantize(jnp.asarray(img), jnp.asarray(qv),
                                           dm, b))
    got = cuda_encode.transform_quantize_zz(torch.from_numpy(img),
                                            quant.as_float(), b, norm).numpy()
    diff = np.abs(got.astype(np.int64) - jax_cz)
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 0.005


@pytest.mark.parametrize("h,w,use_rle,b,norm,qkind", CASES)
def test_locals_from_coeffs_match_pallas_kernel(h, w, use_rle, b, norm,
                                                qkind):
    img = image(h, w, h * 100 + w)
    qv = quant_for(b, qkind).as_float(np.float32)
    lw = frontend_lw(b, norm)
    locs, n = encode_locals(jnp.asarray(img), qv, b, use_rle, norm,
                            interpret=True)
    locs = np.asarray(locs)
    cz = kron_coeffs(img, qv, b, norm).copy()
    words, lens = cuda_encode.locals_from_coeffs(torch.from_numpy(cz),
                                                 use_rle, lw)
    assert words.shape == (n, lw) and words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  locs[:lw, :n].T)
    np.testing.assert_array_equal(lens.numpy(), locs[lw, :n].astype(np.int32))


@pytest.mark.parametrize("use_rle", [True, False])
def test_block_stats_and_fields_match_jax_rle(use_rle):
    """Crafted rows for the stats' corner cases: all zero (ffs(0) clamp),
    last coefficient nonzero after a zero (the trailing strip), a full
    block with no gap, negative extremes."""
    k = 16
    rows = np.zeros((6, k), np.int32)
    rows[1, 15] = 3                       # strip: only the last is nonzero
    rows[2, [0, 5, 15]] = [-7, 1, -1]     # strip after a gap
    rows[3, :] = np.arange(1, k + 1)      # full, no gap
    rows[4, [0, 14]] = [-1024, 1023]      # last-but-one nonzero
    rows[5, 0] = 1
    rng = np.random.default_rng(3)
    rows = np.concatenate([rows, rng.integers(-40, 41, (50, k)) *
                           (rng.random((50, k)) < 0.3)]).astype(np.int32)
    want = jax_rle.block_stats(rows, use_rle)
    got = torch_rle.block_stats(torch.from_numpy(rows), use_rle)
    for key in ("data_bits", "count", "n_payload", "total_bits"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    wv, wb = jax_rle.block_fields(rows, want, use_rle)
    gv, gb = torch_rle.block_fields(torch.from_numpy(rows), got, use_rle)
    np.testing.assert_array_equal(gb.numpy(), wb)
    np.testing.assert_array_equal(gv.numpy(), wv)


def test_encode_locals_on_cpu_runs_the_plain_version():
    img = image(16, 24, 1)
    quant = quant_for(4, "jpeg").as_float()
    before = cuda_encode.encode_locals.launches
    words, lens, overflow = cuda_encode.encode_locals(torch.from_numpy(img),
                                                      quant)
    assert cuda_encode.encode_locals.launches == before
    assert overflow.tolist() == [0]
    cz = cuda_encode.transform_quantize_zz(torch.from_numpy(img), quant)
    pw, pl = cuda_encode.locals_from_coeffs(cz, True, frontend_lw(4,
                                                                  "reference"))
    assert torch.equal(words, pw) and torch.equal(lens, pl)
