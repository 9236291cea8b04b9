"""The closed-loop video encode, stated plainly in PyTorch: the reference
of the benchmark's recon cells.

It follows the source's encoder loop (ThenTech/ImageEncoder,
Frame.cpp:130-243 and ImageBase.cpp:266-306): a GOP opens with an
I-frame, coded from its pixels and never reconstructed, so the frame the
next one is predicted from is the raw I-frame.  Every later frame of the
GOP is a P-frame, predicted from that carry: its vectors come from the
2D-log descent against the carry (``codec.search``), its prediction is
the carry's windows under them (``codec.predict``), its residual cur -
pred goes through the transform and quantizer as pixels do
(``codec.quantize``), and its reconstruction

    to_u8(pred + inverse(quantized residual))

(the dequantization, the exact-order f64 inverse, + 128, then + the
prediction, clamped to [0, 255] and truncated) is the carry of the frame
after it.  The stream is ``codec.encode_video``'s: the header, then per
frame a P-frame's vectors and every frame's block records.

As in the source, the carry is not what a decoder sees: a decoder
predicts from the decoded I-frame, not the raw one, and the
reconstruction dequantizes every quantized coefficient (Block.cpp:111-119),
also one that the block's record then drops (RLE's trailing strip,
``codec.records``).  The encoder and decoder drift apart by design.

Departures from the source:

  * frame k of every GOP goes through in one set of tensor operations:
    GOPs share nothing, so the order in which they are worked changes no
    bit;
  * only the Y plane is read, from u8 planes, not from YUV420p bytes;
  * the Huffman stage, the transform's order and the records are
    ``codec``'s, with the departures its docstring notes.

It imports nothing of the program under test.  ``dtype`` is the
precision of the transforms: float64 is the format; float32 is the
benchmark's control, which must fail the comparison.
"""

from __future__ import annotations

import torch

from . import codec


def encode_video_recon(frames: torch.Tensor, quant, use_rle: bool, gop: int,
                       merange: int, use_huffman: bool = True,
                       dtype=torch.float64) -> codec.Video:
    """u8 [F, H, W] Y planes -> :class:`codec.Video`; each P-frame
    predicted from the reconstruction of the frame before it."""
    f, h, w = frames.shape
    dev = frames.device
    gop = max(1, gop)
    mb = codec.mvec_bits(merange)
    coeffs: list = [None] * f
    vectors = {}
    carry = None  # the frames frame k - 1 of each GOP left behind
    for k in range(min(gop, f)):
        idx = list(range(k, f, gop))  # frame k of every GOP that has one
        cur = frames[idx]
        if k == 0:
            q = codec.quantize(codec.blocks(cur).reshape(-1, codec.K),
                               quant, dtype)
            carry = cur
        else:
            ref = carry[:len(idx)]
            mv = codec.search(cur, ref, merange)
            pred = codec.predict(ref, mv)
            res = cur.to(torch.int16) - pred.to(torch.int16)
            q = codec.quantize(codec.blocks(res).reshape(-1, codec.K),
                               quant, dtype)
            px = (codec.blocks(pred).reshape(-1, codec.K).to(dtype)
                  + codec.inverse(q, quant, dtype))
            carry = codec.unblocks(codec.to_u8(px).reshape(len(idx), -1,
                                                           codec.K), h, w)
            for j, i in enumerate(idx):
                vectors[i] = mv[j]
        for j, q_i in enumerate(q.reshape(len(idx), -1, codec.K)):
            coeffs[idx[j]] = q_i

    parts_v, parts_b, carried = [], [], []
    hv, hb = codec._fields(codec.header(quant, use_rle, w, h, use_huffman,
                                        (f, gop, merange)), dev)
    parts_v.append(hv)
    parts_b.append(hb)
    for i in range(f):
        if i in vectors:
            parts_v.append(vectors[i].reshape(-1).to(torch.int64))
            parts_b.append(torch.full((vectors[i].numel(),), mb,
                                      dtype=torch.int64, device=dev))
        vals, nbits, kept = codec.records(coeffs[i], use_rle)
        parts_v.append(vals.reshape(-1))
        parts_b.append(nbits.reshape(-1))
        carried.append(kept.to(torch.int16).cpu())
    data = codec.finish(torch.cat(parts_v), torch.cat(parts_b), use_huffman)
    return codec.Video(data, torch.stack(carried),
                       {i: v.cpu() for i, v in vectors.items()}, (f, h, w),
                       gop, quant)
