"""K1: the encode front end, pixels -> per-block register files.

The counterpart of imageencoder_tpu/ops/pallas_encode.py.  For an [H, W]
u8 image it returns, per B x B block in row-major block order, the block's
record as a register file of ``lw = frontend_lw(B, norm)`` MSB-first words
(int32 [N, lw], the u32 bits) and its bit length (int32 [N]).
ops/cuda_pack.pack_locals concatenates them into the stream.

On a CUDA tensor :func:`encode_locals` launches the kernel in
csrc/encode.cu; on a CPU tensor it runs the plain version, which has two
stages that the tests check apart:

  * :func:`transform_quantize_zz`: the f64 DCT in the reference's exact
    order (ops/dct.py::dct2_exact), quantize and round half away from
    zero, in zig-zag order;
  * :func:`locals_from_coeffs`: RLE stats, wire fields and register files.

Unlike the TPU kernel, which computes the transform in f32 and differs from
the host engine at rounding ties, both stages are exact: the stream equals
encode_image(backend="numpy") byte for byte.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from imageencoder_tpu.ops.dct import _fwd_weights
from imageencoder_tpu.ops.pallas_encode import frontend_lw
from imageencoder_tpu.ops.zigzag import zigzag_order

from ..kernels import build
from . import device_pack, rle


@lru_cache(maxsize=None)
def encode_tables(block_size: int, norm: str):
    """(wz f64 [K, K], scale_z f64 [K]): the forward weights W[c, uv] and
    C(u)C(v) scales of ops/dct.py::_fwd_weights with their coefficient
    axis in zig-zag order, so coefficients come out in wire order with each
    one's arithmetic unchanged."""
    w, scale = _fwd_weights(block_size, norm)
    zz = zigzag_order(block_size)
    return np.ascontiguousarray(w[:, zz]), np.ascontiguousarray(scale[zz])


def _quant_zz(quant, block_size: int, device) -> torch.Tensor:
    """Quant matrix [B, B] (array-like) -> f64 [K] in zig-zag order on
    ``device``."""
    q = np.asarray(quant, np.float64).reshape(-1)[zigzag_order(block_size)]
    return torch.as_tensor(q, device=device)


def _blocks(img: torch.Tensor, block_size: int) -> torch.Tensor:
    """[H, W] -> [N, B*B] row-major blocks in row-major block order."""
    b = block_size
    h, w = img.shape
    return (img.reshape(h // b, b, w // b, b).permute(0, 2, 1, 3)
            .reshape(-1, b * b))


def transform_quantize_zz(img: torch.Tensor, quant, block_size: int = 4,
                          norm: str = "reference") -> torch.Tensor:
    """[H, W] u8 -> int32 [N, K] quantized coefficients in zig-zag order.

    Each coefficient is acc = 0; acc = acc + x[c] * w[c] for c = 0..K-1
    (a rounded multiply, then a rounded add: torch runs them as two ops),
    then * scale, / quant and round half away from zero: bit-identical to
    imageencoder_tpu.ops.dct.forward_transform_quantize_zz.
    """
    dev = img.device
    wz, scale_z = encode_tables(block_size, norm)
    wz = torch.as_tensor(wz, device=dev)
    x = _blocks(img, block_size).to(torch.float64) - 128.0
    acc = torch.zeros_like(x)
    for c in range(x.shape[1]):
        acc = acc + x[:, c:c + 1] * wz[c]
    y = acc * torch.as_tensor(scale_z, device=dev)
    z = y / _quant_zz(quant, block_size, dev)
    t = torch.trunc(z)
    d = z - t
    r = torch.where((d >= 0.5) | (d <= -0.5),
                    torch.where(z >= 0.0, t + 1.0, t - 1.0), t)
    return r.to(torch.int32)


def locals_from_coeffs(coeffs_zz: torch.Tensor, use_rle: bool, lw: int):
    """[N, K] zig-zag coefficients -> (register files int32 [N, lw],
    record lengths int32 [N])."""
    stats = rle.block_stats(coeffs_zz, use_rle)
    vals, nbits = rle.block_fields(coeffs_zz, stats, use_rle)
    local, lens = device_pack.register_files(vals, nbits, lw)
    return device_pack.as_int32(local), lens.to(torch.int32)


def encode_locals_plain(img: torch.Tensor, quant, block_size: int = 4,
                        use_rle: bool = True, norm: str = "reference"):
    """The plain version of K1, on any device."""
    cz = transform_quantize_zz(img, quant, block_size, norm)
    return locals_from_coeffs(cz, use_rle, frontend_lw(block_size, norm))


def encode_locals(img: torch.Tensor, quant, block_size: int = 4,
                  use_rle: bool = True, norm: str = "reference"):
    """[H, W] u8 image -> (register files int32 [N, lw], lengths int32 [N]).

    A CPU image runs the plain version; a CUDA image launches K1.
    """
    h, w = img.shape
    if h % block_size or w % block_size:
        raise ValueError(f"image {h}x{w} is not a multiple of the "
                         f"{block_size}-pixel block")
    if img.device.type == "cpu":
        return encode_locals_plain(img, quant, block_size, use_rle, norm)
    if block_size not in (4, 8):
        raise ValueError(f"the K1 kernel takes 4x4 or 8x8 blocks, not "
                         f"{block_size}x{block_size}")
    dev = img.device
    build.require(img, "img", torch.uint8, 2, dev)
    tables = _device_tables(block_size, norm, dev)
    quant_z = _quant_zz(quant, block_size, dev)
    lw = frontend_lw(block_size, norm)
    n = (h // block_size) * (w // block_size)
    out_words = torch.empty((n, lw), dtype=torch.int32, device=dev)
    out_lens = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        code = lib.ie_encode_locals(
            img.data_ptr(), h, w, block_size, tables[0].data_ptr(),
            tables[1].data_ptr(), quant_z.data_ptr(), int(use_rle), lw,
            out_words.data_ptr(), out_lens.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_encode_locals")
    encode_locals.launches += 1
    return out_words, out_lens


encode_locals.launches = 0


@lru_cache(maxsize=None)
def _device_tables(block_size: int, norm: str, device: torch.device):
    wz, scale_z = encode_tables(block_size, norm)
    return (torch.as_tensor(wz, device=device),
            torch.as_tensor(scale_z, device=device))
