"""The sharded video encode and decode over a ("frame", "block") mesh.

The counterpart of imageencoder_tpu/parallel/video_sharding.py.  Frames
[F, H, W] shard F over the "frame" axis (contiguous chunks) and H over the
"block" axis (stripes whose heights are multiples of the 16-pixel
macroblock and at least ``merange`` rows).  Every function runs SPMD, as
parallel/sharding.py's do: every rank calls it with the same global input,
takes its (frame, block) shard, and returns the global result.

The encode of a rank's shard, on a card:

  * the reference (:func:`make_sharded_video_packed`, ``ref_mode``):
      - "raw" (the shipped binaries): frame f is predicted from raw frame
        f - 1.  The chunk's first frame's reference is the previous
        chunk's last frame, one shift along "frame" (mesh.shift, the JAX
        package's ppermute, :441-443), and each reference gets ``merange``
        halo rows from the stripes above and below, two shifts along
        "block" (:350-353);
      - "recon" (the reference source): frame f is predicted from the
        reconstruction of frame f - 1.  Chunks must be GOP-aligned (each
        opens a GOP; the JAX package also refuses a single chunk of a
        length no multiple of the GOP); the carry is the stripe's
        reconstruction.  The JAX package scans the frames and exchanges
        the carry's halo at every P-frame (:344-355, :433-447); the port
        steps by GOP, as ops/video_pipeline.py does, with one halo
        exchange a step for frame k of every GOP;
  * K6+K7 on the haloed stripe, positions clamped in global rows
    (ops/cuda_motion.py: search_residual_stripe, one launch for the
    chunk in raw mode; in recon mode search_predict_stripe and the recon
    step, one launch each a GOP step);
  * K1 once on the stripe's residual stack (pixels on I rows, cur - pred
    on P rows): register files;
  * the segments' bits: a frame's wire order is
    [mv(s0)..mv(sS-1)][blk(s0)..blk(sS-1)] (:517-518).  A vector segment
    is a fixed n_mb * 2 * mvec_nbits bits; the block segments' bits are
    all-gathered over both axes, and the host waits once, for them;
  * both kinds of segment packed at their final bit phase, all of a
    rank's in one launch each: the block segments by K2 over segments
    (cuda_pack.pack_segments), the vector segments by K4 pack_records
    over segments (cuda_pack.pack_records_segments).  The JAX package
    packs at bit 0 and funnel-shifts (:534-543), a TPU workaround left
    out;
  * optionally the windowed K3 over each segment's whole bytes,
    all-reduced over "block" (:546-554).

The stream is then the segments spliced in wire order: as 2F "virtual
frames", vectors of frame f on row 2f and blocks on row 2f + 1, it is
parallel/sharding.py's concat stream, spliced on the device
(sharding._splice) or coded by its distributed Huffman stage
(:func:`encode_sharded_video_huffman`).  The transform is the exact f64
one (K5, K1), so the streams equal encode_video(backend="numpy") byte for
byte; the JAX package's sharded step transforms in f32.

The decode (:func:`decode_video_sharded`) lays the GOPs over the
flattened mesh: every rank runs D1, D2 and the vector read over the whole
stream, decodes its own GOPs (models/video.py::decode_into: D3, and K7
from frame k - 1), and the frames are all-gathered.  It needs no halo.

Offsets are int64 throughout: the JAX package's int32 capacity and the
auto-chunking it forces (:617-627, :661-691) have no counterpart;
:func:`encode_video_sharded` splits a video into GOP-aligned calls of at
most MAX_FRAMES_PER_CALL frames a rank, which bounds its memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.headers import VideoParams
from ..models.image import BLOCK_SIZE, upload
from ..models.video import (MAX_FRAMES_PER_CALL, UV_FILL, mvec_bits,
                            plan_video, video_header)
from ..ops import bitpack, cuda_encode, cuda_kernels, cuda_motion, cuda_pack
from ..ops.device_pack import to_device
from ..ops.huffman import huffman_encode, huffman_launch
from ..ops.motion import MACRO, p_frames
from ..ops.pipeline import make_encode_fields
from ..ops.video_pipeline import gop_steps
from ..utils.device import resolve_device
from ..utils.quant import QuantMatrix
from .mesh import all_gather, all_reduce, axis_size, mesh_device, shift
from .sharding import (_Layout, _bases, _flat_index, _full_matrix,
                       _gather_rows, _quant_array, _round4, _splice,
                       _stream_bytes, encode_sharded_huffman)


class _Stripes:
    """This rank's chunk and stripe of a video [F, H, W], and the checks
    the JAX package's shard_map and asserts make (:113-118, :307-314)."""

    def __init__(self, mesh, frames, merange: int, gop: int,
                 ref_mode: str = "raw", short: str = "; use fewer stripes"):
        if len(frames.shape) != 3:
            raise ValueError(f"expected frames [F, H, W], got "
                             f"{tuple(frames.shape)}")
        if ref_mode not in ("raw", "recon"):
            raise ValueError(f"unknown ref_mode {ref_mode!r}")
        f, h, w = frames.shape
        self.lay = lay = _Layout(mesh, f)
        if f == 0:
            raise ValueError("a sharded video needs at least one frame")
        if h % lay.sa:
            raise ValueError(f"{h} rows do not shard into {lay.sa} stripes")
        self.h_loc, self.h, self.w = h // lay.sa, h, w
        self.m = int(merange)
        if self.h_loc < self.m:
            raise ValueError(f"stripe height {self.h_loc} < merange "
                             f"{self.m}{short}")
        if self.h_loc % MACRO or w % MACRO:
            raise ValueError(f"a {h}x{w} video does not shard into "
                             f"{lay.sa} stripes of whole {MACRO}-pixel "
                             f"macroblocks")
        self.gop = max(1, int(gop))
        # Every chunk must open a GOP, so that no reconstruction crosses
        # ranks.  The JAX package asserts f_loc % gop == 0 (:311-314),
        # which is that where the frame axis has more than one chunk; one
        # chunk of any length opens the video's first GOP, so the port
        # encodes it where the JAX package refuses.
        if ref_mode == "recon" and lay.fa > 1 and lay.f_loc % self.gop:
            raise ValueError(f"recon mode needs GOP-aligned frame chunks: "
                             f"{lay.f_loc} frames/chunk vs gop {self.gop}")
        # A single stripe is the whole frame: no rows past its edges are
        # read, so it takes no halo (and no shift along "block").
        self.halo = min(self.m, self.h_loc) if lay.sa > 1 else 0
        self.row0 = lay.sid * self.h_loc
        self.f0 = lay.fid * lay.f_loc
        self.n_frames = f
        self.n_mb = (self.h_loc // MACRO) * (w // MACRO)
        self.p_local = p_frames(lay.f_loc, self.gop, self.f0)
        # Whether any rank searches: every rank shifts, or none does.
        self.any_p = bool(p_frames(f, self.gop))

    def stripe(self, frames, dev) -> torch.Tensor:
        """This rank's u8 [f_loc, h_loc, W] on dev."""
        part = frames[self.f0:self.f0 + self.lay.f_loc,
                      self.row0:self.row0 + self.h_loc]
        if isinstance(part, torch.Tensor):
            part = part.to(dev).contiguous()
        else:
            part = to_device(np.ascontiguousarray(part), dev)
        if part.dtype != torch.uint8:
            raise TypeError(f"expected u8 frames, got {part.dtype}")
        return part

    def haloed(self, ref: torch.Tensor, mesh) -> torch.Tensor:
        """ref u8 [n, h_loc, W] with ``halo`` rows of the stripe above and
        below it (zeros past the frame's edges, which no clamped position
        reads): [n, h_loc + 2 * halo, W]."""
        if not self.halo:
            return ref.contiguous()
        above = shift(ref[:, -self.halo:], mesh, "block", 1, cyclic=False)
        below = shift(ref[:, :self.halo], mesh, "block", -1, cyclic=False)
        return torch.cat([above, ref, below], dim=1)

    def raw_front(self, cur: torch.Tensor, mesh):
        """Raw reference: (vectors int32 [P_loc, n_mb, 2] of the chunk's
        P-frames, the K1 input [f_loc * h_loc, W]: int16 residuals on P
        rows and pixels on I rows, or the u8 pixels where the video has
        no P-frame)."""
        if not self.any_p:
            return None, cur.reshape(-1, self.w)
        prev = shift(cur[-1], mesh, "frame", 1, cyclic=True)
        ref = self.haloed(torch.cat([prev[None], cur[:-1]]), mesh)
        return cuda_motion.search_residual_stripe(
            cur, ref, self.row0, self.halo, self.h, self.f0, self.gop,
            self.m)

    def recon_front(self, cur: torch.Tensor, mesh, quant, block_size: int,
                    norm: str):
        """Recon reference, stepped by GOP (ops/video_pipeline.py's
        :func:`gop_steps`): the carry opens as the chunk's I-frames, then
        for k = 1 .. min(gop, f_loc) - 1, over the n_k GOPs that have a
        frame k, the carry's halo is exchanged, frame k of every GOP is
        searched in the haloed carry (K6+K7 search_predict_stripe) and
        reconstructed into the carry (the recon step: K5's transform fused
        with the exact inverse), one launch each.  Returns (vectors int32
        [P_loc, n_mb, 2], int16 [f_loc * h_loc, W]: cur - pred on P rows,
        pixels on I rows)."""
        dev, gop, halo = cur.device, self.gop, self.halo
        h, w = self.h_loc, self.w
        mvecs = torch.empty((len(self.p_local), self.n_mb, 2),
                            dtype=torch.int32, device=dev)
        preds = torch.empty_like(cur)
        preds[0::gop] = 0  # the steps write the P rows
        # Whether any rank searches.  The steps depend on f_loc and gop
        # alone, so every rank of a "block" group shifts as often.
        steps = gop_steps(cur.shape[0], gop) if self.any_p else []
        if len(steps) > 1:
            n_1 = steps[1][1]
            # The carry lives in its haloed buffer: frame g's
            # reconstruction in rows halo .. halo + h - 1 of buf[g], the
            # rows of the stripes above and below around it.  One buffer
            # will do: the search reads the carry and writes preds, the
            # recon step reads cur and preds, so on one stream the step
            # may overwrite the carry the search has just read.
            buf = torch.empty((n_1, h + 2 * halo, w), dtype=torch.uint8,
                              device=dev)
            carry = buf[:, halo:halo + h]
            carry.copy_(cur[0::gop][:n_1])
            coeffs = torch.empty((n_1, h, w), dtype=torch.int32, device=dev)
            for k, n_k in steps[1:]:
                if halo:  # every step: no stale halo rows survive
                    buf[:n_k, :halo] = shift(carry[:n_k, h - halo:], mesh,
                                             "block", 1, cyclic=False)
                    buf[:n_k, halo + h:] = shift(carry[:n_k, :halo], mesh,
                                                 "block", -1, cyclic=False)
                cuda_motion.search_predict_stripe(
                    cur[k::gop], buf[:n_k], self.row0, halo, self.h, self.m,
                    mvec=mvecs[k - 1::gop - 1], out=preds[k::gop])
                cuda_encode.recon_step(cur[k::gop], preds[k::gop], quant,
                                       block_size, norm, out=coeffs[:n_k],
                                       recon=carry[:n_k])
        x = cur.to(torch.int16)
        x -= preds
        return mvecs, x.reshape(-1, w)


def make_sharded_video_step(mesh, gop: int, merange: int, mvec_nbits: int,
                            block_size: int = BLOCK_SIZE,
                            use_rle: bool = True, norm: str = "reference"):
    """The sharded fields step, raw reference.

    f(frames u8 [F, H, W] (numpy or a tensor), quant [B, B]) ->
        mvals  int32 [F, Nmb, 2]      motion-vector field values, masked
                                      to mvec_nbits (I-frame rows 0)
        bvals  int32 [F, Nmicro, K+2] block field values (wire order)
        bnbits int32 [F, Nmicro, K+2]
        base   int64 [F, S]           each (frame, stripe)'s block bits
    on every rank.  A shard's search is K6+K7 on its haloed stripe, its
    fields come from ops/pipeline.py::make_encode_fields of the residual
    stack (K5 on a card)."""
    fields = make_encode_fields(block_size, use_rle, norm)
    mask = (1 << int(mvec_nbits)) - 1

    def step(frames, quant):
        st = _Stripes(mesh, frames, merange, gop, short=(
            ": motion offsets would reach past the immediate neighbour's "
            "halo; use fewer stripes"))
        lay, dev = st.lay, mesh_device(mesh)
        mvec, x = st.raw_front(st.stripe(frames, dev), mesh)
        vals, nbits = fields(x, _quant_array(quant))
        vals = vals.reshape(lay.f_loc, -1, vals.shape[1])
        nbits = nbits.reshape(vals.shape)
        mvals = torch.zeros((lay.f_loc, st.n_mb, 2), dtype=torch.int32,
                            device=dev)
        if st.p_local:
            mvals[to_device(np.array(st.p_local), dev)] = mvec & mask
        f = st.n_frames
        return (_gather_rows(mesh, mvals).reshape(f, -1, 2),
                _gather_rows(mesh, vals).reshape(f, -1, vals.shape[2]),
                _gather_rows(mesh, nbits).reshape(f, -1, vals.shape[2]),
                _full_matrix(mesh, nbits.sum(dim=(1, 2), dtype=torch.int64)))

    return step


def _virtual_bits(blk_bits, gop: int, mv_seg_bits: int) -> np.ndarray:
    """The 2F virtual frames' segment bits [2F, S] from the block segments'
    [F, S]: frame f's vector segments (n_mb * 2 * mvec_nbits bits on a
    P-frame, none on an I-frame) on row 2f, its block segments on row
    2f + 1, so that the concat order is the wire order."""
    blk = np.asarray(torch.as_tensor(blk_bits).cpu(), np.int64)
    f, s = blk.shape
    is_p = (np.arange(f) % max(1, gop)) != 0
    mv = np.repeat(np.where(is_p, mv_seg_bits, 0)[:, None], s, axis=1)
    return np.stack([mv, blk], axis=1).reshape(2 * f, s)


def _virtual_words(mvw, blw) -> torch.Tensor:
    """The segment words as 2F virtual frames [2F, S, W*], W* the wider of
    the two kinds (each row's words are defined up to its segment's last,
    zeros after)."""
    mvw, blw = (_as_words(x) for x in (mvw, blw))
    f, s = blw.shape[:2]
    w = max(mvw.shape[2], blw.shape[2])
    pad = torch.nn.functional.pad
    return torch.stack([pad(mvw, (0, w - mvw.shape[2])),
                        pad(blw, (0, w - blw.shape[2]))],
                       dim=1).reshape(2 * f, s, w)


def _as_words(x) -> torch.Tensor:
    """Segment words as int32 (the u32 bits), from numpy or a tensor."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.int32 else x.to(torch.int32)
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def make_sharded_video_packed(mesh, gop: int, merange: int, mvec_nbits: int,
                              block_size: int = BLOCK_SIZE,
                              use_rle: bool = True, norm: str = "reference",
                              ref_mode: str = "raw", histogram: bool = True):
    """The sharded video encode with packed bits off every rank.

    Returns f(frames u8 [F, H, W] (numpy or a tensor), quant [B, B],
    start_bit) ->
        mvw      int32 [F, S, WMV]   each vector segment's words at its
                                     final bit phase (u32 bits), word 0
                                     the stream's word base >> 5, defined
                                     up to the segment's last word (zero
                                     on I-frames)
        blw      int32 [F, S, WBLK]  the block segments' likewise
        blk_bits int64 [F, S]        each block segment's bits, on the
                                     host (read there once); a vector
                                     segment's are n_mb * 2 * mvec_nbits
                                     on a P-frame, 0 on an I-frame
        hist     int32 [F, 257]      each frame's histogram of the bytes
                                     its segments cover whole, summed over
                                     the stripes (slot 256 zero); None
                                     without ``histogram`` (K3 does not
                                     run)
    on every rank.  ``ref_mode`` "raw" or "recon" (the module docstring).
    Raises ValueError where the JAX package's asserts fail: a stripe
    shorter than merange, recon chunks of which one does not open a GOP
    (the JAX package refuses a single chunk of a length no multiple of the
    GOP too); and on frames that do not shard (F by the "frame" extent,
    stripes of whole macroblocks) or no frame at all."""
    b = block_size
    mb = int(mvec_nbits)

    def step(frames, quant, start_bit: int):
        st = _Stripes(mesh, frames, merange, gop, ref_mode)
        lay, dev = st.lay, mesh_device(mesh)
        qf = _quant_array(quant)
        cur = st.stripe(frames, dev)
        if ref_mode == "raw":
            mvec, x = st.raw_front(cur, mesh)
        else:
            mvec, x = st.recon_front(cur, mesh, qf, b, norm)
        local, lens, _ = cuda_encode.encode_locals(x, qf, b, use_rle, norm)
        local = local.view(lay.f_loc, -1, local.shape[1])
        lens = lens.view(lay.f_loc, -1)
        full = _full_matrix(mesh, lens.sum(dim=1, dtype=torch.int64))
        blk_bits = full.cpu().numpy()  # the one wait
        # [F, 2, S]: each frame's vector segments, then its block ones.
        bits = _virtual_bits(blk_bits, st.gop, st.n_mb * 2 * mb).reshape(
            -1, 2, lay.sa)
        base = _bases(bits.reshape(-1, lay.sa), int(start_bit),
                      "concat").reshape(bits.shape)
        # Each kind's words a row: the widest segment at its phase.
        n_mv, n_blk = (_round4(max(1, int((((base[:, k] & 31) + bits[:, k]
                                             + 31) >> 5).max())))
                       for k in (0, 1))
        phase = base[lay.rows, :, lay.sid] & 31  # [f_loc, 2]
        mine = bits[lay.rows, :, lay.sid]
        blw, _ = cuda_pack.pack_segments(local, lens,
                                         to_device(phase[:, 1], dev), n_blk)
        mvw = torch.zeros((lay.f_loc, n_mv), dtype=torch.int32, device=dev)
        if st.p_local:
            p = np.array(st.p_local)
            words, _ = cuda_pack.pack_records_segments(
                mvec, torch.full_like(mvec, mb), to_device(phase[p, 0], dev),
                n_mv)
            mvw[to_device(p, dev)] = words
        hist = None
        if histogram:
            hist = _segment_hist(blw, phase[:, 1], mine[:, 1], dev)
            if st.p_local:
                hist += _segment_hist(mvw, phase[:, 0], mine[:, 0], dev)
            hist = all_reduce(hist, mesh, "block")
            hist = all_gather(hist, mesh, "frame").reshape(-1, 256)
            hist = torch.nn.functional.pad(hist, (0, 1))
        return (_gather_rows(mesh, mvw), _gather_rows(mesh, blw),
                torch.from_numpy(blk_bits), hist)

    return step


def _segment_hist(words, phase: np.ndarray, bits: np.ndarray, dev):
    """The windowed K3 over each row's segment of ``bits`` bits from bit
    ``phase``: the bytes it covers whole (an empty window where none)."""
    lo = (phase + 7) >> 3
    hi = np.maximum((phase + bits) >> 3, lo)
    lo, hi = to_device(np.stack([lo, hi]), dev)
    return cuda_kernels.byte_histogram_rows(words, lo, hi)


def _header(quant, use_rle: bool, width: int, height: int, n_frames: int,
            gop: int, merange: int, use_huffman: bool):
    """(the stream's bytes before the payload, its bit count)."""
    writer = video_header(quant, use_rle, width, height,
                          VideoParams(n_frames, max(1, gop), merange),
                          use_huffman)
    return writer.getvalue(), writer.position


def _mv_seg_bits(width: int, height: int, n_stripes: int,
                 merange: int) -> int:
    return (height // n_stripes // MACRO) * (width // MACRO) * 2 * mvec_bits(
        merange)


def _quant_matrix(quant) -> QuantMatrix:
    return quant if isinstance(quant, QuantMatrix) else QuantMatrix(
        np.asarray(quant))


def assemble_sharded_video(mvals, bnbits, bvals, width: int, height: int,
                           quant, use_rle: bool, gop: int, merange: int,
                           use_huffman: bool = True,
                           device="cuda") -> bytes:
    """The wire stream from :func:`make_sharded_video_step`'s outputs, on
    the host as the JAX package assembles it: the header, then per frame
    its vector fields (P-frames only) and its block fields, packed
    (ops/bitpack.py), then Huffman on ``device`` (a card unless the caller
    asks for the CPU; the fields may lie anywhere).  Byte-identical to
    encode_video(backend="numpy") where the fields are the exact ones."""
    device = resolve_device(device)
    qm = _quant_matrix(quant)
    mvals, bvals, bnbits = (np.asarray(torch.as_tensor(x).cpu())
                            for x in (mvals, bvals, bnbits))
    f = bvals.shape[0]
    gop = max(1, gop)
    mb = mvec_bits(merange)
    writer = video_header(qm, use_rle, width, height,
                          VideoParams(f, gop, merange), use_huffman)
    vals = [np.asarray(writer.values, np.int64)]
    nbits = [np.asarray(writer.nbits, np.int64)]
    for fi in range(f):
        if fi % gop:
            mv = mvals[fi].astype(np.int64).reshape(-1)  # (x, y) interleaved
            vals.append(mv)
            nbits.append(np.full(mv.shape[0], mb, np.int64))
        vals.append(bvals[fi].astype(np.int64).reshape(-1))
        nbits.append(bnbits[fi].astype(np.int64).reshape(-1))
    inner, _ = bitpack.pack_fields(np.concatenate(vals),
                                   np.concatenate(nbits))
    return huffman_encode(inner, device) if use_huffman else inner


def _splice_video_segments(mvw, blw, blk_bits, header: bytes, start_bit: int,
                           gop: int, mv_seg_bits: int):
    """The segments of :func:`make_sharded_video_packed` spliced in wire
    order behind ``header`` on their device (sharding._splice over the 2F
    virtual frames), one copy to the host.  Returns (inner bytes, each
    segment's bits in wire order, total bits)."""
    bits_v = _virtual_bits(blk_bits, gop, mv_seg_bits)
    rows, totals = _splice(_virtual_words(mvw, blw), bits_v, int(start_bit),
                           [header], "concat")
    return (_stream_bytes(rows, totals)[0], bits_v.reshape(-1).tolist(),
            int(totals[0]))


def assemble_sharded_video_packed(mvw, blw, blk_bits, width: int,
                                  height: int, quant, use_rle: bool,
                                  gop: int, merange: int,
                                  use_huffman: bool = True,
                                  hist=None) -> bytes:
    """The stream of :func:`make_sharded_video_packed`'s outputs: the
    segments spliced behind the header on their device, then with Huffman
    the windowed K3 over the whole spliced stream, the dict kernel and K4
    on it (ops/huffman.py::huffman_launch), one wait for the copy.  The
    JAX package adds ``hist`` to a host count of the boundary bytes; here
    the device counts every byte of the stream, so ``hist`` is not read
    (it is taken for the JAX package's signature)."""
    qm = _quant_matrix(quant)
    words_v = _virtual_words(mvw, blw)
    f, s = words_v.shape[0] // 2, words_v.shape[1]
    header, start = _header(qm, use_rle, width, height, f, gop, merange,
                            use_huffman)
    bits_v = _virtual_bits(blk_bits, gop, _mv_seg_bits(width, height, s,
                                                       merange))
    rows, totals = _splice(words_v, bits_v, start, [header], "concat")
    if not use_huffman:
        return _stream_bytes(rows, totals)[0]
    totals = to_device(totals, rows.device)
    counts = cuda_kernels.byte_histogram_rows(
        rows, torch.zeros_like(totals), (totals + 7) // 8)
    return huffman_launch(rows, totals, counts).finish()[0]


def encode_sharded_video_huffman(mvw, blw, blk_bits, hist, width: int,
                                 height: int, quant, use_rle: bool, gop: int,
                                 merange: int, mesh) -> bytes:
    """The distributed Huffman stage over the packed video segments: as
    2F virtual frames (vectors of frame f on row 2f, blocks on row
    2f + 1; the histogram of frame f on row 2f) they are stage 1's concat
    stream, and parallel/sharding.py::encode_sharded_huffman codes it:
    each rank codes the bytes its segments own on its device.  Equal to
    :func:`assemble_sharded_video_packed` with use_huffman=True."""
    qm = _quant_matrix(quant)
    words_v = _virtual_words(mvw, blw).to(mesh_device(mesh))
    f, s = words_v.shape[0] // 2, words_v.shape[1]
    header, start = _header(qm, use_rle, width, height, f, gop, merange,
                            True)
    bits_v = _virtual_bits(blk_bits, gop, _mv_seg_bits(width, height, s,
                                                       merange))
    hist = torch.as_tensor(hist).cpu()
    hist_v = torch.stack([hist, torch.zeros_like(hist)],
                         dim=1).reshape(2 * f, -1)
    return encode_sharded_huffman(words_v, bits_v, hist_v, start, header,
                                  mesh, mode="concat")


def encode_video_sharded(frames, quant, mesh, use_rle: bool = True,
                         gop: int = 4, merange: int = 16,
                         use_huffman: bool = True, ref_mode: str = "raw",
                         block_size: int = BLOCK_SIZE,
                         norm: str = "reference",
                         bit_capacity: int = 2 ** 31) -> bytes:
    """Encode Y planes u8 [F, H, W] (numpy or a tensor) over the mesh:
    byte-identical to encode_video(backend="numpy") of the same frames,
    on every rank.

    :func:`make_sharded_video_packed` (without the histogram), the
    segments spliced on the device behind the header, then with Huffman
    the windowed K3 over the spliced stream, the dict kernel and K4
    (:func:`assemble_sharded_video_packed`).  A video of more than
    MAX_FRAMES_PER_CALL frames a rank goes in GOP-aligned calls (each
    opens with an I-frame, so no reference crosses them) spliced behind
    the header on the host, then Huffman over the whole stream.

    The constraints are make_sharded_video_packed's.  ``bit_capacity`` is
    the JAX package's int32 offset capacity, which chunks its calls; the
    port's offsets are int64, so it is taken and not needed: the stream
    is the same at every capacity."""
    del bit_capacity
    qm = _quant_matrix(quant)
    f, h, w = frames.shape
    gop = max(1, gop)
    mb = mvec_bits(merange)
    fa = axis_size(mesh, "frame")
    header, start = _header(qm, use_rle, w, h, f, gop, merange, use_huffman)
    g = math.lcm(gop, fa) if ref_mode == "raw" else gop * fa
    chunk = max(g, (MAX_FRAMES_PER_CALL * fa // g) * g)
    step = make_sharded_video_packed(mesh, gop, merange, mb, block_size,
                                     use_rle, norm, ref_mode,
                                     histogram=False)
    if f <= chunk:
        mvw, blw, blk_bits, _ = step(frames, qm.as_float(), start)
        return assemble_sharded_video_packed(mvw, blw, blk_bits, w, h, qm,
                                             use_rle, gop, merange,
                                             use_huffman)
    mv_seg = _mv_seg_bits(w, h, axis_size(mesh, "block"), merange)
    segments = [(header, start)]
    for c0 in range(0, f, chunk):
        mvw, blw, blk_bits, _ = step(frames[c0:c0 + chunk], qm.as_float(), 0)
        inner, _, total = _splice_video_segments(mvw, blw, blk_bits, b"", 0,
                                                 gop, mv_seg)
        segments.append((inner, total))
    inner = bitpack.concat_bit_segments(segments)
    return huffman_encode(inner, mesh_device(mesh)) if use_huffman else inner


def make_sharded_video_decode(mesh, h: int, w: int, gop: int,
                              block_size: int = BLOCK_SIZE,
                              norm: str = "reference",
                              motioncomp: bool = True):
    """The GOP-sharded decode from coefficients: f(coeffs int32
    [G, L, Nmicro, B, B], mvec int32 [G, L, Nmacro, 2] (zero rows for
    I-frames), quant [B, B]) -> frames u8 [G, L, h, w] on every rank.

    G lies over the flattened mesh (it must divide by the mesh's size);
    each rank runs the frame chain on its GOPs, frame k of all of them at
    once: the exact f64 inverse (+128, clamp, floor:
    ops/cuda_encode.py::reconstruct, torch operations, as the JAX package
    runs an XLA einsum here), onto K7's prediction from frame k - 1 for
    k >= 1 (with motioncomp=False the prediction is the frame); the
    frames are all-gathered.  L is the (padded) GOP length."""
    b = block_size
    nd = mesh.size()

    def step(coeffs, mvec, quant):
        dev = mesh_device(mesh)
        g, length = coeffs.shape[:2]
        if g % nd:
            raise ValueError(f"{g} GOPs do not shard over {nd} devices")
        per = g // nd
        at = _flat_index(mesh) * per
        cf = torch.as_tensor(coeffs[at:at + per]).to(dev)
        mv = torch.as_tensor(mvec[at:at + per]).to(dev).to(torch.int32)
        qf = _quant_array(quant)
        out = torch.empty((per, length, h, w), dtype=torch.uint8, device=dev)
        for k in range(length):
            img = cuda_encode.unblocks(
                cf[:, k].reshape(-1, b * b).to(torch.int32), per * h, w)
            i_frame = k % max(1, gop) == 0
            if i_frame:
                pred = torch.zeros((per * h, w), dtype=torch.uint8,
                                   device=dev)
            else:
                pred = cuda_motion.predict(out[:, k - 1].contiguous(),
                                           mv[:, k].contiguous())
                if not motioncomp:
                    out[:, k] = pred
                    continue
                pred = pred.reshape(per * h, w)
            out[:, k] = cuda_encode.reconstruct(img, pred, qf, b,
                                                norm).view(per, h, w)
        return all_gather(out, mesh).reshape(g, length, h, w)

    return step


def decode_video_sharded(data: bytes, mesh, motioncomp: bool = True,
                         norm: str = "reference",
                         block_size: int = BLOCK_SIZE):
    """Decode a video stream across the mesh: (YUV420p bytes, VideoParams,
    (width, height)) on every rank, frame for frame as
    imageencoder_tpu.models.video.decode_video(data, motioncomp, norm,
    backend="numpy").

    Every rank parses the stream and uploads it once, then D1 (with
    Huffman), D2 over the whole video and the vector read run there (a
    record's place depends on every record before it).  The GOPs lie over
    the flattened mesh, padded to a multiple of its size; each rank
    decodes its own GOPs (models/video.py::decode_into: D3, and K7 from
    frame k - 1), and the frames are all-gathered into a YUV420 buffer on
    the device, its U and V filled there (the port's assemble_yuv420 on
    the device, as decode_video does), which comes to the host in one
    copy."""
    from ..models.video import decode_into

    dev = mesh_device(mesh)
    plan = plan_video(data, block_size, pinned=dev.type == "cuda")
    params, w, h = plan["params"], plan["w"], plan["h"]
    n = params.frame_count
    if n == 0:
        return b"", params, (w, h)
    gop = max(1, params.gop)
    n_gops = -(-n // gop)
    per = -(-n_gops // mesh.size())
    g0 = _flat_index(mesh) * per
    mine = max(0, min((g0 + per) * gop, n) - g0 * gop)  # frames decoded
    y = torch.zeros((per * gop, h, w), dtype=torch.uint8, device=dev)
    if mine and plan["n_blocks"]:
        decode_into(plan, upload(plan, dev), y[:mine], motioncomp, norm,
                    block_size, gops=(g0, g0 + per))
    y_size = h * w
    buf = torch.empty((n, y_size + y_size // 2), dtype=torch.uint8,
                      device=dev)
    buf[:, y_size:] = UV_FILL
    buf[:, :y_size] = all_gather(y, mesh).reshape(mesh.size() * per * gop,
                                                  y_size)[:n]
    if dev.type == "cuda":
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        buf = host
    return buf.numpy().tobytes(), params, (w, h)
