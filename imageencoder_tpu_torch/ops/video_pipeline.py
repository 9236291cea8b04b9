"""The device video encode: frames -> packed stream words (+ histogram).

The counterpart of imageencoder_tpu/ops/video_pipeline.py's
make_encode_video_packed (ref_mode="raw") and
make_encode_video_packed_recon (ref_mode="recon").  Both return a function
f(frames u8 [F, H, W], quant [B, B], start_bit, header_words int32
[HEADER_WORDS]) -> (words, total_bits), or (words, total_bits, hist int32
[256]) with the byte histogram, which the packer counts as it writes the
stream (K3 folded into K2 or K4 pack_coeffs).  The header words are OR'd into the first words, so
the words are the complete inner stream.  Stream order per frame
(Frame.cpp:194-242): a P-frame's motion vectors, 2 x mvec_nbits signed
bits per macroblock in row-major order, then its residual blocks; an
I-frame's pixel blocks alone.

Raw reference (every P-frame predicted from the raw frame before it), no
frame-to-frame carry, so the whole video is one pass of four launches and
no torch op between them:

    K6+K7 search_residual (ops/cuda_motion.py)  the whole video in: the P
       frames' vectors, and the int16 residual stack [F*H, W]: pixels on
       I rows, cur - pred on P rows
    K1 encode_locals  (ops/cuda_encode.py)   one launch, register files
    K2 pack_locals    (ops/cuda_pack.py)     two launches: the stream
       words, each P-frame's vector records read from the vectors, and
       with the histogram the stream's byte counts

Recon reference (every P-frame predicted from the reconstruction of the
frame before it) carries the reconstruction from frame to frame.  Every
GOP opens with an I-frame, which resets the carry to its raw pixels
(Frame.cpp:130-159 never reconstructs it), so GOPs are independent and
frame k of every GOP goes in one launch: a Python loop over the GOP's
steps (:func:`gop_steps`) takes the place of the JAX package's lax.scan
over frames, and gives its output, not its order.

    K5 quantize_image (ops/cuda_encode.py)  every I-frame, frames[0::gop],
       into coeffs[0::gop]; the carry is those raw frames
    then for k = 1 .. min(gop, F) - 1, over the n_k GOPs that have a
    frame k (only the last GOP may be short), two launches:
    K6+K7 search_predict (ops/cuda_motion.py)  frames[k::gop][:n_k]
       against the carry: the vectors into their P-frame rows,
       mvecs[k - 1::gop - 1], and the prediction
    recon step (ops/cuda_encode.py::recon_step)  the residual, K5's
       transform into coeffs[k::gop], and the reconstruction (dequantize,
       the exact-order f64 IDCT, +128, + prediction, clamp, truncate to
       u8) as the next carry

K5 and the recon step also write each block's record length.  The carry
and the prediction are two buffers: the search reads the carry and writes
the prediction, the step reads the prediction and writes the carry.  At
720p25, gop 4 that is 7 launches, not one an I-frame and two a P-frame
(43).  Then K4 pack_coeffs packs every frame's vector and block records
straight from the coefficients and the vectors in K2's two launches, the
first summing the lengths, and with the histogram counts the stream's
bytes as it stores them.
"""

from __future__ import annotations

import torch

from . import cuda_encode, cuda_motion, cuda_pack
from .device_pack import packed_words_bound
from .motion import MACRO


def gop_steps(n_frames: int, gop: int) -> list[tuple[int, int]]:
    """The recon loop's steps: (k, n_k) for k = 0 .. min(gop, F) - 1, n_k
    the GOPs of an F-frame video that have a frame k (frames k, k + gop,
    ... of frames[k::gop]); step 0 is the I-frames."""
    return [(k, len(range(k, n_frames, gop)))
            for k in range(min(gop, n_frames))]


def make_encode_video_packed(gop: int, merange: int, mvec_nbits: int,
                             block_size: int = 4, use_rle: bool = True,
                             norm: str = "reference",
                             with_hist: bool = False):
    """The raw-reference device encoder (see the module docstring)."""
    b = block_size

    def encode_video_packed(frames, quant, start_bit: int, header_words):
        f, h, w = frames.shape
        if cuda_motion.p_frames(f, gop):
            mvecs, x = cuda_motion.search_residual(frames, gop, merange)
        else:  # every frame an I-frame: K1 takes the pixels as they are
            mvecs, x = None, frames.reshape(f * h, w)
        local, lens, _ = cuda_encode.encode_locals(x, quant, b, use_rle,
                                                   norm)
        # Stream order: per frame, its macroblocks' vector records (empty
        # on an I-frame), then its block records.  A record K1 refused
        # makes K2's total -1.
        n_macro = 0 if mvecs is None else mvecs.shape[1]
        n_rows = local.shape[0] + f * n_macro
        pack = cuda_pack.pack_locals_hist if with_hist else \
            cuda_pack.pack_locals
        return pack(local, lens, start_bit,
                    packed_words_bound(n_rows, local.shape[1]),
                    prefix=header_words, mvecs=mvecs, n_frames=f, gop=gop,
                    mvec_nbits=mvec_nbits)

    return encode_video_packed


def make_encode_video_packed_recon(gop: int, merange: int, mvec_nbits: int,
                                   block_size: int = 4, use_rle: bool = True,
                                   norm: str = "reference",
                                   with_hist: bool = False):
    """The recon-reference device encoder (see the module docstring)."""
    b = block_size

    def encode_video_packed(frames, quant, start_bit: int, header_words):
        f, h, w = frames.shape
        dev = frames.device
        n_micro = (h // b) * (w // b)
        n_p = len(cuda_motion.p_frames(f, gop))
        n_macro = (h // MACRO) * (w // MACRO) if n_p else 0
        coeffs = torch.empty((f, h, w), dtype=torch.int32, device=dev)
        lens = torch.empty((f, n_micro), dtype=torch.int32, device=dev)
        mvecs = torch.empty((n_p, n_macro, 2), dtype=torch.int32, device=dev)
        steps = gop_steps(f, gop)
        if steps:
            cuda_encode.quantize_image(frames[0::gop], quant, b, norm,
                                       out=coeffs[0::gop], lens=lens[0::gop],
                                       use_rle=use_rle)
        if len(steps) > 1:
            n_1 = steps[1][1]
            carry = frames[0::gop][:n_1]
            pred = torch.empty((n_1, h, w), dtype=torch.uint8, device=dev)
            recon = torch.empty_like(pred)
            for k, n_k in steps[1:]:
                cur = frames[k::gop]
                cuda_motion.search_predict(cur, carry[:n_k], merange,
                                           mvec=mvecs[k - 1::gop - 1],
                                           out=pred[:n_k])
                cuda_encode.recon_step(cur, pred[:n_k], quant, b, norm,
                                       out=coeffs[k::gop], recon=recon[:n_k],
                                       lens=lens[k::gop], use_rle=use_rle)
                carry = recon

        # Every frame's records, in stream order, straight from the
        # coefficients and the vectors, their lengths summed first: K4's
        # two launches, no fields tensor.
        pack = cuda_pack.pack_coeffs_hist if with_hist else \
            cuda_pack.pack_coeffs
        lw = cuda_encode.video_lw(b, norm)
        return pack(coeffs, mvecs, gop, mvec_nbits, b, use_rle, lw,
                    start_bit, packed_words_bound(f * (n_macro + n_micro), lw),
                    prefix=header_words, lens=lens)

    return encode_video_packed
