"""The device video encode: frames -> packed stream words (+ histogram).

The counterpart of imageencoder_tpu/ops/video_pipeline.py's
make_encode_video_packed (ref_mode="raw") and
make_encode_video_packed_recon (ref_mode="recon").  Both return a function
f(frames u8 [F, H, W], quant [B, B], start_bit, header_words int32
[HEADER_WORDS]) -> (words, total_bits), or (words, meta int32 [257]) with
the byte histogram.  The header words are OR'd into the first words, so
the words are the complete inner stream.  Stream order per frame
(Frame.cpp:194-242): a P-frame's motion vectors, 2 x mvec_nbits signed
bits per macroblock in row-major order, then its residual blocks; an
I-frame's pixel blocks alone.

Raw reference (every P-frame predicted from the raw frame before it), no
frame-to-frame carry, so the whole video is one pass:

    K6 motion_search  (ops/cuda_motion.py)   P-frames against frame f - 1
    K7 predict        (ops/cuda_motion.py)   the prediction windows
       int16 residual stack [F*H, W]: pixels on I rows, cur - pred on P
    K1 encode_locals  (ops/cuda_encode.py)   one launch, register files
       mvec records as one-word register files, interleaved per frame
    K2 pack_locals    (ops/cuda_pack.py)     the stream words
    K3 byte_histogram (ops/cuda_kernels.py)  Huffman statistics

Recon reference (every P-frame predicted from the reconstruction of the
frame before it) carries the reconstruction from frame to frame, so a
Python loop over frames takes the place of the JAX package's lax.scan.
Per P-frame three launches: K6 and K7 against the carry, then the recon
step (ops/cuda_encode.py::recon_step), which forms the residual, runs
K5's transform into the frame's coefficients and reconstructs the frame
(dequantize, the exact-order f64 IDCT, +128, + prediction, clamp,
truncate to u8) as the next carry.  An I-frame goes through K5 alone and
resets the carry to its raw pixels (Frame.cpp:130-159 never reconstructs
it).  After the loop K4's pack_coeffs front end packs every frame's
vector and block records straight from the coefficients and the vectors,
and K3 takes the histogram.
"""

from __future__ import annotations

import torch

from . import cuda_encode, cuda_motion, cuda_pack
from .device_pack import as_int32, packed_words_bound
from .motion import MACRO
from .pipeline import stream_byte_histogram


def _p_frames(n_frames: int, gop: int) -> list[int]:
    """Indices of the P-frames: every frame but each GOP's first."""
    return [f for f in range(n_frames) if f % gop]


def _finish(words, total, with_hist: bool):
    if with_hist:
        return words, stream_byte_histogram(words, total)
    return words, total


def mvec_words(mvec: torch.Tensor, mvec_nbits: int) -> torch.Tensor:
    """Motion vectors int32 [..., 2] -> their record as one MSB-first word
    (int32 bits): x then y, mvec_nbits two's-complement bits each
    (pallas_encode.py::mvec_locals)."""
    nb = mvec_nbits
    m = mvec.to(torch.int64) & ((1 << nb) - 1)
    return as_int32((m[..., 0] << (32 - nb)) | (m[..., 1] << (32 - 2 * nb)))


def make_encode_video_packed(gop: int, merange: int, mvec_nbits: int,
                             block_size: int = 4, use_rle: bool = True,
                             norm: str = "reference",
                             with_hist: bool = False):
    """The raw-reference device encoder (see the module docstring)."""
    b = block_size
    k = b * b

    def encode_video_packed(frames, quant, start_bit: int, header_words):
        f, h, w = frames.shape
        dev = frames.device
        p_idx = _p_frames(f, gop)
        n_micro = (h // b) * (w // b)
        n_macro = (h // MACRO) * (w // MACRO) if p_idx else 0

        x = frames.to(torch.int16)
        if p_idx:
            pi = torch.tensor(p_idx, device=dev)
            cur = frames.index_select(0, pi)
            ref = frames.index_select(0, pi - 1)
            mvec = cuda_motion.motion_search(cur, ref, merange)
            pred = cuda_motion.predict(ref, mvec)
            x.index_copy_(0, pi, cur.to(torch.int16) - pred)
        local, lens, overflow = cuda_encode.encode_locals(
            x.reshape(f * h, w), quant, b, use_rle, norm)
        lw = local.shape[1]

        # Stream order: per frame, its macroblocks' vector records (zero
        # length on I-frames), then its block records.
        mlocal = torch.zeros((f, n_macro, lw), dtype=torch.int32, device=dev)
        mlens = torch.zeros((f, n_macro), dtype=torch.int32, device=dev)
        if p_idx:
            mlocal[pi, :, 0] = mvec_words(mvec, mvec_nbits)
            mlens[pi] = 2 * mvec_nbits
        merged = torch.cat([mlocal, local.view(f, n_micro, lw)], dim=1)
        merged_lens = torch.cat([mlens, lens.view(f, n_micro)], dim=1)
        n_rows = f * (n_macro + n_micro)
        words, total = cuda_pack.pack_locals(
            merged.reshape(n_rows, lw), merged_lens.reshape(n_rows),
            start_bit, packed_words_bound(n_rows, k + 2),
            prefix=header_words)
        return _finish(words, cuda_encode.refuse_overflow(total, overflow),
                       with_hist)

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
        p_idx = _p_frames(f, gop)
        n_micro = (h // b) * (w // b)
        n_macro = (h // MACRO) * (w // MACRO) if p_idx else 0
        coeffs = torch.empty((f, h, w), dtype=torch.int32, device=dev)
        mvecs = []
        carry = None
        for fi in range(f):
            cur = frames[fi]
            if fi % gop == 0:
                cuda_encode.quantize_image(cur, quant, b, norm, out=coeffs[fi])
                carry = cur
                continue
            mvec = cuda_motion.motion_search(cur[None], carry[None], merange)
            pred = cuda_motion.predict(carry[None], mvec)[0]
            _, carry = cuda_encode.recon_step(cur, pred, quant, b, norm,
                                              out=coeffs[fi])
            mvecs.append(mvec[0])

        # Every frame's records, in stream order, straight from the
        # coefficients and the vectors: one K4 launch, no fields tensor.
        mv = (torch.stack(mvecs) if mvecs else
              torch.zeros((0, n_macro, 2), dtype=torch.int32, device=dev))
        words, total = cuda_pack.pack_coeffs(
            coeffs, mv, gop, mvec_nbits, b, use_rle,
            cuda_encode.video_lw(b, norm), start_bit,
            packed_words_bound(f * (n_macro + n_micro), k + 2),
            prefix=header_words)
        return _finish(words, total, with_hist)

    return encode_video_packed
