"""K1 and K5: the f64 block transform on the card.

K1, the encode front end, is the counterpart of
imageencoder_tpu/ops/pallas_encode.py.  For an [H, W] image it returns, per
B x B block in row-major block order, the block's record as a register
file of ``lw`` MSB-first words (int32 [N, lw], the u32 bits) and its bit
length (int32 [N]).  ops/cuda_pack.pack_locals concatenates them into the
stream.  The input is u8 pixels, or int16 video samples: frames stacked as
[F*H, W], I-frame rows holding pixels and P-frame rows the residual
cur - pred.  ``lw`` follows from the dtype: u8 takes ``frontend_lw``,
int16 the residual range's ``video_lw``.  A record longer than lw words
is refused, not truncated: an overflow flag comes back with the records,
and K2 turns the stream's total into -1, on which the host raises.  K1
divides by a quant entry through its reciprocal (:func:`reciprocals`),
which gives the correctly rounded quotient for the integers 1..255
(:func:`division_sweep` checks it on the card).

K5, :func:`quantize_image`, is the counterpart of
imageencoder_tpu/ops/pallas_kernels.py::dct_quantize: the same transform
with the coefficients left in place, int32 [H, W] (block (r, c),
coefficient (u, v) at [B*r + u, B*c + v]).  :func:`recon_step` is K5 with
a recon P-frame's reconstruction fused in: from the frame and its
prediction it writes the coefficients and returns the reconstruction.

On a CUDA tensor the wrappers launch csrc/encode.cu and csrc/transform.cu;
on a CPU tensor they run the plain versions.  K1's has two stages that
the tests check apart:

  * :func:`transform_quantize_zz`: the f64 DCT in the reference's exact
    order (ops/dct.py::dct2_exact), quantize and round half away from
    zero, in zig-zag order (K5's plain version takes natural order);
  * :func:`locals_from_coeffs`: RLE stats, wire fields and register files.

Unlike the TPU kernels, which compute the transform in f32 and differ from
the host engine at rounding ties, both stages are exact: the streams equal
encode_image / encode_video(backend="numpy") byte for byte.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..kernels import build
from . import device_pack, rle
from .dct import _fwd_weights, _inv_weights, dct_matrix
from .zigzag import zigzag_order

INPUT_DTYPES = {torch.uint8: 0, torch.int16: 1}  # dtype code of the C ABI


# Register-file sizes: the port's copies of imageencoder_tpu/ops/
# pallas_encode.py's bounds.
def _bound_bits(block_size: int, norm: str, peak: float) -> int:
    """data_bits bound for samples - 128 of magnitude at most ``peak``:
    |Y(u, v)| <= peak * (max_u sum_i |D[u, i]|)^2, and data_bits also
    covers ffs(count) <= bit_length(B*B)."""
    d = np.abs(np.asarray(dct_matrix(block_size, norm), np.float64))
    r = d.sum(axis=1).max()
    mag = int(np.ceil(peak * r * r))
    return max(mag.bit_length() + 1, (block_size * block_size).bit_length(),
               1)


def coeff_bound_bits(block_size: int, norm: str) -> int:
    """data_bits bound for u8 pixels (pixel - 128 in [-128, 127]) and an
    integer quant >= 1: 11 bits at 4x4."""
    return _bound_bits(block_size, norm, 128.0)


def coeff_bound_bits_residual(block_size: int, norm: str) -> int:
    """data_bits bound for P-frame residuals cur - pred in [-255, 255],
    biased by -128 as pixels are (Block.cpp:139-153): [-383, 127]."""
    return _bound_bits(block_size, norm, 383.0)


def lw_for_bits(block_size: int, db: int) -> int:
    """Register words per record for a data_bits bound of db."""
    k2 = block_size * block_size
    return -(-(4 + db + k2 * db) // 32)


def frontend_lw(block_size: int, norm: str) -> int:
    """Register words per record under the u8-pixel bound (6 at 4x4)."""
    return lw_for_bits(block_size, coeff_bound_bits(block_size, norm))


def video_lw(block_size: int, norm: str) -> int:
    """Register words per record under the residual bound (7 at 4x4)."""
    return lw_for_bits(block_size,
                       coeff_bound_bits_residual(block_size, norm))


def record_words(dtype: torch.dtype, block_size: int, norm: str) -> int:
    """Register-file words ``lw`` for K1 input of ``dtype``: the data_bits
    bound of u8 pixels, or of int16 residuals in [-255, 255]."""
    if dtype == torch.uint8:
        return frontend_lw(block_size, norm)
    if dtype == torch.int16:
        return video_lw(block_size, norm)
    raise TypeError(f"expected uint8 pixels or int16 residuals, got {dtype}")


@lru_cache(maxsize=None)
def encode_tables(block_size: int, norm: str, zigzag: bool = True):
    """(w f64 [K, K], scale f64 [K]): the forward weights W[c, uv] and
    C(u)C(v) scales of ops/dct.py::_fwd_weights, with the coefficient axis
    in zig-zag order (K1) or natural order (K5); each coefficient's
    arithmetic is unchanged."""
    w, scale = _fwd_weights(block_size, norm)
    if not zigzag:
        return w, scale
    zz = zigzag_order(block_size)
    return np.ascontiguousarray(w[:, zz]), np.ascontiguousarray(scale[zz])


def device_constant(a, device) -> torch.Tensor:
    """A read-only copy of the numpy array ``a`` on ``device``, made once
    per content and device: a fresh host-to-device copy per call would
    wait for the stream."""
    a = np.ascontiguousarray(a)
    return _constant(a.tobytes(), a.dtype.str, a.shape, torch.device(device))


@lru_cache(maxsize=256)
def _constant(data: bytes, dtype: str, shape: tuple, device: torch.device):
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return torch.as_tensor(arr.copy(), device=device)


def _quant_vec(quant, block_size: int, device, zigzag: bool) -> torch.Tensor:
    """Quant matrix [B, B] (array-like) -> f64 [K] on ``device``."""
    q = np.asarray(quant, np.float64).reshape(-1)
    if zigzag:
        q = q[zigzag_order(block_size)]
    return device_constant(q, device)


def reciprocals(quant) -> np.ndarray:
    """K1's division table, f64 in the quant's shape: RN(1 / q) for an
    entry q that is an integer in 1..255, through which K1 divides by q
    exactly (csrc/transform.cuh); 0 for any other entry, which K1 divides
    by __ddiv_rn."""
    q = np.asarray(quant, np.float64)
    exact = (q >= 1.0) & (q <= 255.0) & (q == np.floor(q))
    return np.where(exact, 1.0 / np.where(exact, q, 1.0), 0.0)


def _blocks(img: torch.Tensor, block_size: int) -> torch.Tensor:
    """[H, W] -> [N, B*B] row-major blocks in row-major block order."""
    b = block_size
    h, w = img.shape
    return (img.reshape(h // b, b, w // b, b).permute(0, 2, 1, 3)
            .reshape(-1, b * b))


def unblocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`_blocks`: [N, B*B] -> [H, W]."""
    b = int(round(blocks.shape[1] ** 0.5))
    return (blocks.reshape(h // b, w // b, b, b).permute(0, 2, 1, 3)
            .reshape(h, w))


def _check_input(img: torch.Tensor, block_size: int,
                 frames: bool = False) -> None:
    """An [H, W] image (with ``frames`` also [F, H, W]) of u8 pixels or
    int16 residuals that tiles into blocks."""
    if img.dtype not in INPUT_DTYPES:
        raise TypeError(f"expected uint8 pixels or int16 residuals, got "
                        f"{img.dtype}")
    if img.dim() != 2 and not (frames and img.dim() == 3):
        raise ValueError(f"expected an [H, W] image"
                         f"{' or [F, H, W] frames' if frames else ''}, got "
                         f"{tuple(img.shape)}")
    h, w = img.shape[-2:]
    if h % block_size or w % block_size:
        raise ValueError(f"image {h}x{w} is not a multiple of the "
                         f"{block_size}-pixel block")


def _transform(img: torch.Tensor, quant, block_size: int, norm: str,
               zigzag: bool) -> torch.Tensor:
    """[H, W] u8 or int16 -> int32 [N, K] quantized coefficients.

    Each coefficient is acc = 0; acc = acc + x[c] * w[c] for c = 0..K-1
    (a rounded multiply, then a rounded add: torch runs them as two ops),
    then * scale, / quant and round half away from zero.
    """
    dev = img.device
    wt, scale = _device_tables(block_size, norm, dev, zigzag)
    x = _blocks(img, block_size).to(torch.float64) - 128.0
    acc = torch.zeros_like(x)
    for c in range(x.shape[1]):
        acc = acc + x[:, c:c + 1] * wt[c]
    y = acc * scale
    z = y / _quant_vec(quant, block_size, dev, zigzag)
    t = torch.trunc(z)
    d = z - t
    r = torch.where((d >= 0.5) | (d <= -0.5),
                    torch.where(z >= 0.0, t + 1.0, t - 1.0), t)
    return r.to(torch.int32)


def transform_quantize_zz(img: torch.Tensor, quant, block_size: int = 4,
                          norm: str = "reference") -> torch.Tensor:
    """[H, W] u8 or int16 -> int32 [N, K] quantized coefficients in zig-zag
    order, bit-identical to
    imageencoder_tpu.ops.dct.forward_transform_quantize_zz."""
    return _transform(img, quant, block_size, norm, zigzag=True)


def locals_from_coeffs(coeffs_zz: torch.Tensor, use_rle: bool, lw: int):
    """[N, K] zig-zag coefficients -> (register files int32 [N, lw],
    record lengths int32 [N]).  A record longer than lw words is refused
    as K1 refuses it: it keeps its length and its words are zero."""
    stats = rle.block_stats(coeffs_zz, use_rle)
    vals, nbits = rle.block_fields(coeffs_zz, stats, use_rle)
    local, lens = device_pack.register_files(vals, nbits, lw)
    local = torch.where((lens > 32 * lw)[:, None], 0, local)
    return device_pack.as_int32(local), lens.to(torch.int32)


def encode_locals_plain(img: torch.Tensor, quant, block_size: int = 4,
                        use_rle: bool = True, norm: str = "reference"):
    """The plain version of K1, on any device."""
    lw = record_words(img.dtype, block_size, norm)
    cz = transform_quantize_zz(img, quant, block_size, norm)
    local, lens = locals_from_coeffs(cz, use_rle, lw)
    overflow = (lens > 32 * lw).any().to(torch.int32).reshape(1)
    return local, lens, overflow


def encode_locals(img: torch.Tensor, quant, block_size: int = 4,
                  use_rle: bool = True, norm: str = "reference"):
    """[H, W] u8 image or int16 residual stack -> (register files int32
    [N, lw], lengths int32 [N], overflow int32 [1]).

    overflow is 1 where a record is longer than lw words (an input outside
    its dtype's bound); that record is refused, not truncated.  The flag
    stays on the device; K2 (cuda_pack.pack_locals) refuses the same
    record and reports the stream's total as -1, which the host reads
    anyway.

    A CPU tensor runs the plain version; a CUDA tensor launches K1.
    """
    _check_input(img, block_size)
    if img.device.type == "cpu":
        return encode_locals_plain(img, quant, block_size, use_rle, norm)
    _check_kernel_block(block_size, "K1")
    dev = img.device
    build.require(img, "img", img.dtype, 2, dev)  # device and layout
    build.require_aligned(img, "img")  # K1 loads a row as one vector
    h, w = img.shape
    lw = record_words(img.dtype, block_size, norm)
    wz, scale_z = _device_tables(block_size, norm, dev, True)
    quant_z = _quant_vec(quant, block_size, dev, True)
    recip_z = _quant_vec(reciprocals(quant), block_size, dev, True)
    n = (h // block_size) * (w // block_size)
    out_words = torch.empty((n, lw), dtype=torch.int32, device=dev)
    out_lens = torch.empty((n,), dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = build.library().ie_encode_locals(
            img.data_ptr(), INPUT_DTYPES[img.dtype], h, w, block_size,
            wz.data_ptr(), scale_z.data_ptr(), quant_z.data_ptr(),
            recip_z.data_ptr(), int(use_rle), lw, out_words.data_ptr(),
            out_lens.data_ptr(), overflow.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_encode_locals")
    encode_locals.launches += 1
    return out_words, out_lens, overflow


encode_locals.launches = 0


def division_sweep(device, k_max: int, n_random: int,
                   seed: int = 0) -> dict:
    """Run K1's reciprocal division beside __ddiv_rn on the card
    (csrc/division.cu) for every quant q in 1..255: around k*q, (k + 1/2)*q
    and (k + 1/4)*q for |k| <= k_max, 8 ulps each way, and n_random seeded
    random y.  Returns {"mismatches", "checks", "y", "q"} (y, q: one
    mismatching pair, if any).  Needs a CUDA device: the division's CPU
    counterpart is tests/test_torch_division.py."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the division sweep runs on a CUDA device")
    recip = torch.from_numpy(reciprocals(np.arange(256))).to(dev)
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    max_exp = int(np.ceil(np.log2((k_max + 1) * 255.0))) + 2
    with torch.cuda.device(dev):
        code = build.library().ie_div_sweep(
            recip.data_ptr(), k_max, n_random, max_exp, seed, out.data_ptr(),
            build.stream_ptr(dev))
    build.check(code, "ie_div_sweep")
    bad, checks, y_bits, q = out.tolist()
    y = float(np.array([y_bits], np.int64).view(np.float64)[0])
    return {"mismatches": bad, "checks": checks, "y": y, "q": q}


def _as_frames(x: torch.Tensor) -> torch.Tensor:
    """[H, W] as one frame [1, H, W]; [F, H, W] as it is."""
    return x[None] if x.dim() == 2 else x


def record_lengths(coeffs: torch.Tensor, block_size: int,
                   use_rle: bool) -> torch.Tensor:
    """Each block's record length in bits, int32 [F, N] (N blocks a frame
    in row-major order) of int32 [F, H, W] coefficients in place: the
    port's rle.block_stats of the zig-zag coefficients, what K5 and the
    recon step write and K4 pack_coeffs sums."""
    f, h, w = coeffs.shape
    nat = _blocks(coeffs.reshape(f * h, w), block_size)
    zz = nat[:, device_constant(zigzag_order(block_size), coeffs.device)]
    bits = rle.block_stats(zz, use_rle)["total_bits"]
    return bits.to(torch.int32).view(f, -1)


def _written(x: torch.Tensor, into: torch.Tensor | None, one: bool):
    """x [F, ...] as a single frame where the call took one, copied into
    ``into`` where given."""
    if one:
        x = x[0]
    return x if into is None else into.copy_(x)


def quantize_image_plain(img: torch.Tensor, quant, block_size: int = 4,
                         norm: str = "reference",
                         out: torch.Tensor | None = None,
                         lens: torch.Tensor | None = None,
                         use_rle: bool = True):
    """The plain version of K5, on any device: int32 [F, H, W] (or
    [H, W]), and with ``lens`` the record lengths int32 [F, N] (or [N])
    too (:func:`record_lengths`)."""
    x = _as_frames(img)
    f, h, w = x.shape
    q = unblocks(_transform(x.reshape(f * h, w), quant, block_size, norm,
                            zigzag=False), f * h, w).view(f, h, w)
    one = img.dim() == 2
    got = _written(q, out, one)
    if lens is None:
        return got
    return got, _written(record_lengths(q, block_size, use_rle), lens, one)


def _check_shape(x: torch.Tensor, name: str, dtype, shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {list(shape)}, got "
                         f"{x.dtype} {list(x.shape)}")


def _lens_on_card(lens, f: int, n: int, dev):
    """(pointer, row stride) of a lengths output int32 [F, N] (or [N] for
    one frame) whose rows may lie apart, or (None, 0)."""
    if lens is None:
        return None, 0
    lens = lens.view(f, n)
    build.require_frames(lens, "lens", torch.int32, 2, dev)
    return lens.data_ptr(), lens.stride(0)


def quantize_image(img: torch.Tensor, quant, block_size: int = 4,
                   norm: str = "reference",
                   out: torch.Tensor | None = None,
                   lens: torch.Tensor | None = None,
                   use_rle: bool = True):
    """F frames u8 or int16 [F, H, W] (or one, [H, W]) -> int32 [F, H, W]
    (or [H, W]) quantized coefficients in place, written into ``out``
    where given.  With ``lens`` (int32 [F, N], N blocks a frame) each
    block's record length under ``use_rle`` is written there too, and
    (coefficients, lens) returned.  A frame of any of them may lie any
    whole number of frames from the next: ``frames[k::gop]`` and
    ``coeffs[k::gop]`` go in as they are.

    A CPU tensor runs the plain version; a CUDA tensor launches K5, once
    for all the frames.
    """
    _check_input(img, block_size, frames=True)
    x = _as_frames(img)
    f, h, w = x.shape
    n = (h // block_size) * (w // block_size)
    if out is not None:
        _check_shape(out, "out", torch.int32, img.shape)
    if lens is not None:
        _check_shape(lens, "lens", torch.int32,
                      (n,) if img.dim() == 2 else (f, n))
    if img.device.type == "cpu":
        return quantize_image_plain(img, quant, block_size, norm, out, lens,
                                    use_rle)
    _check_kernel_block(block_size, "K5")
    dev = img.device
    wt, scale = _device_tables(block_size, norm, dev, False)
    qv = _quant_vec(quant, block_size, dev, False)
    rv = _quant_vec(reciprocals(quant), block_size, dev, False)
    if out is None:
        out = torch.empty(img.shape, dtype=torch.int32, device=dev)
    o = _as_frames(out)
    in_stride = build.frame_stride(x, "img", x.dtype, 3, dev)
    out_stride = build.frame_stride(o, "out", torch.int32, 3, dev)
    lens_ptr, lens_stride = _lens_on_card(lens, f, n, dev)
    if f * n:
        with torch.cuda.device(dev):
            code = build.library().ie_quantize_image(
                x.data_ptr(), INPUT_DTYPES[x.dtype], f, in_stride, h, w,
                block_size, wt.data_ptr(), scale.data_ptr(), qv.data_ptr(),
                rv.data_ptr(), o.data_ptr(), out_stride, lens_ptr,
                lens_stride,
                int(use_rle), build.stream_ptr(dev))
        build.check(code, "ie_quantize_image")
        quantize_image.launches += 1
    return out if lens is None else (out, lens)


quantize_image.launches = 0


def reconstruct(coeffs: torch.Tensor, pred: torch.Tensor, quant,
                block_size: int, norm: str) -> torch.Tensor:
    """A P-frame's reconstruction: int32 [H, W] in-place coefficients and
    its u8 [H, W] prediction -> u8 [H, W] (frames stacked as [F*H, W]
    too).

    Dequantize, the inverse DCT in the exact order of ops/dct.py::
    idct2_exact (acc = acc + y[c] * wi[c] for c = 0..K-1, each a rounded
    multiply then a rounded add), +128, + prediction, clamp to [0, 255]
    and truncate: bit-identical to runtime/native.py::
    idct_recon_exact_native.  The K products are taken in one op; the
    sum starts from the first product instead of 0.0 + it, which can
    change only the sign of a zero, and + 128 removes that.
    """
    dev = coeffs.device
    h, w = coeffs.shape
    wi = device_constant(_inv_weights(block_size, norm), dev)
    qv = device_constant(np.asarray(quant, np.float64).reshape(-1), dev)
    y = _blocks(coeffs, block_size).to(torch.float64) * qv
    prod = y[:, :, None] * wi                                  # [N, K, K]
    acc = prod[:, 0]
    for c in range(1, y.shape[1]):
        acc = acc + prod[:, c]
    pv = _blocks(pred, block_size).to(torch.float64) + (acc + 128.0)
    return unblocks(pv.clamp(0.0, 255.0).to(torch.uint8), h, w)


def recon_step_plain(cur: torch.Tensor, pred: torch.Tensor, quant,
                     block_size: int = 4, norm: str = "reference",
                     out: torch.Tensor | None = None,
                     recon: torch.Tensor | None = None,
                     lens: torch.Tensor | None = None,
                     use_rle: bool = True):
    """The plain version of the recon step, on any device: K5 on the
    residual cur - pred, then :func:`reconstruct`; with ``lens`` the
    record lengths too."""
    c, p = _as_frames(cur), _as_frames(pred)
    f, h, w = c.shape
    q = quantize_image_plain((c.to(torch.int16) - p).reshape(f * h, w),
                             quant, block_size, norm)
    r = reconstruct(q, p.reshape(f * h, w), quant, block_size, norm)
    one = cur.dim() == 2
    q = q.view(f, h, w)
    got = (_written(q, out, one), _written(r.view(f, h, w), recon, one))
    if lens is None:
        return got
    return got + (_written(record_lengths(q, block_size, use_rle), lens,
                           one),)


def recon_step(cur: torch.Tensor, pred: torch.Tensor, quant,
               block_size: int = 4, norm: str = "reference",
               out: torch.Tensor | None = None,
               recon: torch.Tensor | None = None,
               lens: torch.Tensor | None = None, use_rle: bool = True):
    """Recon P-frames' step: F frames cur and their predictions pred, u8
    [F, H, W] (or one, [H, W]) -> (int32 coefficients of cur - pred in
    place, written into ``out`` where given; the u8 reconstruction,
    written into ``recon`` where given), and with ``lens`` (int32 [F, N])
    each block's record length under ``use_rle`` written there and
    returned third.  As for :func:`quantize_image`, each tensor's frames
    may lie apart.

    A CPU tensor runs the plain version; a CUDA tensor launches the fused
    kernel of csrc/transform.cu, one launch for the whole step of all the
    frames.
    """
    for name, x in (("cur", cur), ("pred", pred)):
        if x.dtype != torch.uint8 or x.dim() not in (2, 3):
            raise TypeError(f"{name}: expected u8 [F, H, W] or [H, W], got "
                            f"{x.dtype} {tuple(x.shape)}")
    if pred.shape != cur.shape:
        raise ValueError(f"pred {tuple(pred.shape)} != cur "
                         f"{tuple(cur.shape)}")
    _check_input(cur, block_size, frames=True)
    f, h, w = _as_frames(cur).shape
    n = (h // block_size) * (w // block_size)
    if out is not None:
        _check_shape(out, "out", torch.int32, cur.shape)
    if recon is not None:
        _check_shape(recon, "recon", torch.uint8, cur.shape)
    if lens is not None:
        _check_shape(lens, "lens", torch.int32,
                      (n,) if cur.dim() == 2 else (f, n))
    if cur.device.type == "cpu":
        return recon_step_plain(cur, pred, quant, block_size, norm, out,
                                recon, lens, use_rle)
    _check_kernel_block(block_size, "recon step")
    dev = cur.device
    wt, scale = _device_tables(block_size, norm, dev, False)
    qv = _quant_vec(quant, block_size, dev, False)
    rv = _quant_vec(reciprocals(quant), block_size, dev, False)
    wi = device_constant(_inv_weights(block_size, norm), dev)
    if out is None:
        out = torch.empty(cur.shape, dtype=torch.int32, device=dev)
    if recon is None:
        recon = torch.empty(cur.shape, dtype=torch.uint8, device=dev)
    strides = [build.frame_stride(_as_frames(x), name, x.dtype, 3, dev)
               for name, x in (("cur", cur), ("pred", pred), ("out", out),
                               ("recon", recon))]
    lens_ptr, lens_stride = _lens_on_card(lens, f, n, dev)
    if f * n:
        with torch.cuda.device(dev):
            code = build.library().ie_recon_step(
                cur.data_ptr(), strides[0], pred.data_ptr(), strides[1], f,
                h, w, block_size, wt.data_ptr(), scale.data_ptr(),
                qv.data_ptr(), rv.data_ptr(), wi.data_ptr(), out.data_ptr(),
                strides[2],
                recon.data_ptr(), strides[3], lens_ptr, lens_stride,
                int(use_rle), build.stream_ptr(dev))
        build.check(code, "ie_recon_step")
        recon_step.launches += 1
    return (out, recon) + (() if lens is None else (lens,))


recon_step.launches = 0


def _check_kernel_block(block_size: int, name: str) -> None:
    if block_size not in (4, 8):
        raise ValueError(f"the {name} kernel takes 4x4 or 8x8 blocks, not "
                         f"{block_size}x{block_size}")


def _device_tables(block_size: int, norm: str, device, zigzag: bool):
    wt, scale = encode_tables(block_size, norm, zigzag)
    return device_constant(wt, device), device_constant(scale, device)
