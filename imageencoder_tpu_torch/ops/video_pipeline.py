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
frame before it) carries the reconstruction from frame to frame, so a
Python loop over frames takes the place of the JAX package's lax.scan.
Per P-frame two launches: K6 with K7 as its epilogue against the carry
(search_predict), then the recon step (ops/cuda_encode.py::recon_step),
which forms the residual, runs K5's transform into the frame's
coefficients and reconstructs the frame (dequantize, the exact-order f64
IDCT, +128, + prediction, clamp, truncate to u8) as the next carry.  An
I-frame goes through K5 alone and resets the carry to its raw pixels
(Frame.cpp:130-159 never reconstructs it).  After the loop K4's
pack_coeffs front end packs every frame's vector and block records
straight from the coefficients and the vectors, and with the
histogram counts the stream's bytes as it stores them.
"""

from __future__ import annotations

import torch

from . import cuda_encode, cuda_motion, cuda_pack
from .device_pack import packed_words_bound
from .motion import MACRO

def make_encode_video_packed(gop: int, merange: int, mvec_nbits: int,
                             block_size: int = 4, use_rle: bool = True,
                             norm: str = "reference",
                             with_hist: bool = False):
    """The raw-reference device encoder (see the module docstring)."""
    b = block_size
    k = b * b

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
        return pack(local, lens, start_bit, packed_words_bound(n_rows, k + 2),
                    prefix=header_words, mvecs=mvecs, n_frames=f, gop=gop,
                    mvec_nbits=mvec_nbits)

    return encode_video_packed


def make_encode_video_packed_recon(gop: int, merange: int, mvec_nbits: int,
                                   block_size: int = 4, use_rle: bool = True,
                                   norm: str = "reference",
                                   with_hist: bool = False):
    """The recon-reference device encoder (see the module docstring)."""
    b = block_size
    k = b * b

    def encode_video_packed(frames, quant, start_bit: int, header_words):
        f, h, w = frames.shape
        dev = frames.device
        n_micro = (h // b) * (w // b)
        n_macro = ((h // MACRO) * (w // MACRO)
                   if cuda_motion.p_frames(f, gop) else 0)
        coeffs = torch.empty((f, h, w), dtype=torch.int32, device=dev)
        mvecs = []
        carry = None
        for fi in range(f):
            cur = frames[fi]
            if fi % gop == 0:
                cuda_encode.quantize_image(cur, quant, b, norm, out=coeffs[fi])
                carry = cur
                continue
            mvec, pred = cuda_motion.search_predict(cur[None], carry[None],
                                                    merange)
            _, carry = cuda_encode.recon_step(cur, pred[0], quant, b, norm,
                                              out=coeffs[fi])
            mvecs.append(mvec[0])

        # Every frame's records, in stream order, straight from the
        # coefficients and the vectors: one K4 launch, no fields tensor.
        mv = (torch.stack(mvecs) if mvecs else
              torch.zeros((0, n_macro, 2), dtype=torch.int32, device=dev))
        pack = cuda_pack.pack_coeffs_hist if with_hist else \
            cuda_pack.pack_coeffs
        return pack(coeffs, mv, gop, mvec_nbits, b, use_rle,
                    cuda_encode.video_lw(b, norm), start_bit,
                    packed_words_bound(f * (n_macro + n_micro), k + 2),
                    prefix=header_words)

    return encode_video_packed
