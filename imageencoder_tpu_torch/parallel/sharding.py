"""The sharded image encode and decode over a ("frame", "block") mesh.

The counterpart of imageencoder_tpu/parallel/sharding.py.  A batch of
frames [F, H, W] shards F over the "frame" axis and H over the "block"
axis: each rank owns a horizontal stripe of block rows of F / frames
frames, a segment each.  The wire format orders blocks row-major, so the
stripes concatenate in wire order, and the sharded streams equal the
one-device streams byte for byte.

Every function runs SPMD: every rank of the mesh calls it with the same
global input, takes its (frame, block) shard, and returns the global
result (the JAX package's shard_map out_specs become all-gathers over the
mesh, parallel/mesh.py).  On a card a rank's shard runs the kernels of
the one-device path:

  * stage 1 (:func:`make_sharded_encode_packed`): K1 on the shard's frames
    stacked, the segments' bit totals all-gathered, then K2 over the
    rank's segments in one launch pair, each segment at its final bit
    phase (K2 takes a start bit a stream), then the windowed K3
    (cuda_kernels.byte_histogram_rows) over the bytes each segment covers
    whole, all-reduced over "block".  The JAX package's TPU branch packs
    at bit 0 and funnel-shifts (:215-222): a TPU workaround, left out;
  * Huffman after stage 1 (:func:`encode_sharded_image_batch`): the
    segments spliced on the device, the windowed K3 over each whole
    stream, then the dict kernel and K4 over the batch;
  * stage 2 (:func:`make_sharded_huffman_pack`), the distributed Huffman
    coding: the dict kernel builds every stream's dict from the
    histogram of stage 1 and the bytes no segment covers whole; each rank
    codes the inner bytes its segments own, the merged junction word
    OR'd in; the windowed K3 counts those bytes, so their code bits are
    known and all-gathered before the pack, and K4 pack_payload codes the
    window at the segment's final output bit (its table names the window
    and the start bit, ops/dict_table.py);
  * the decode (:func:`decode_image_sharded`): every rank runs D1 and D2
    over the whole stream (each block's place depends on every block
    before it), then D3 on its stripe of block rows; the stripes are
    all-gathered.

The host adds the bytes no segment covers whole to stage 2's histogram,
as the JAX package does, and reads the dict tables back once for each
stream's prefix; the segments are spliced on the device (the JAX package
splices them on the host), the wire emit writes the streams' bytes there,
a stream that falls back included, and one copy brings them to the
host.
Offsets are int64 throughout, so :func:`check_int32_bit_capacity` guards
nothing here; it is kept for the JAX package's chunk layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.headers import write_image_header
from ..models.image import BLOCK_SIZE, parse_stream, upload
from ..ops import cuda_decode, cuda_encode, cuda_kernels, cuda_pack
from ..ops import dict_table, huffman
from ..ops.bitpack import BitWriter
from ..ops.device_pack import bytes_to_words, to_device
from ..ops.huffman import MAX_CODE_LEN, Tail, huffman_launch
from ..ops.pipeline import make_encode_fields
from ..utils.quant import QuantMatrix
from .mesh import (all_gather, all_reduce, axis_index, axis_size,
                   mesh_device)


def _round4(n: int) -> int:
    return -(-int(n) // 4) * 4


def _quant_array(quant) -> np.ndarray:
    """A quant matrix (QuantMatrix or array-like [B, B]) as f64."""
    if isinstance(quant, QuantMatrix):
        return quant.as_float()
    return np.asarray(quant, np.float64)


class _Layout:
    """This rank's place in the mesh, its frames of F and its segments."""

    def __init__(self, mesh, n_frames: int):
        self.fa, self.sa = axis_size(mesh, "frame"), axis_size(mesh, "block")
        self.fid, self.sid = axis_index(mesh, "frame"), axis_index(mesh,
                                                                   "block")
        if n_frames % self.fa:
            raise ValueError(f"{n_frames} frames do not shard over a frame "
                             f"axis of {self.fa}")
        self.f_loc = n_frames // self.fa
        self.rows = self.fid * self.f_loc + np.arange(self.f_loc)

    def shard(self, frames, block_size: int, dev) -> torch.Tensor:
        """This rank's stripe of its frames of [F, H, W] u8 (numpy or a
        tensor), stacked: u8 [f_loc * H / S, W] on dev."""
        h = frames.shape[1]
        if h % block_size or (h // block_size) % self.sa:
            raise ValueError(f"{h} rows do not shard into {self.sa} stripes "
                             f"of {block_size}-pixel block rows")
        h_loc = h // self.sa
        f0, r0 = self.fid * self.f_loc, self.sid * h_loc
        part = frames[f0:f0 + self.f_loc, r0:r0 + h_loc]
        if isinstance(part, torch.Tensor):
            part = part.to(dev).contiguous()
        else:
            part = to_device(np.ascontiguousarray(part), dev)
        if part.dtype != torch.uint8:
            raise TypeError(f"expected u8 frames, got {part.dtype}")
        return part.reshape(self.f_loc * h_loc, -1)


def _full_matrix(mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's per-frame values [f_loc] as the global [F, S]."""
    g = all_gather(all_gather(local, mesh, "block"), mesh, "frame")
    return g.permute(0, 2, 1).reshape(-1, g.shape[1])  # [fa * f_loc, S]


def _gather_rows(mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's rows [f_loc, ...] as the global [F, S, ...]."""
    fa, sa = axis_size(mesh, "frame"), axis_size(mesh, "block")
    g = all_gather(local, mesh)
    g = g.reshape(fa, sa, *local.shape)
    return g.transpose(1, 2).reshape(fa * local.shape[0], sa,
                                     *local.shape[1:])


def _bases(full, start, mode: str):
    """Each segment's first bit [F, S] from the segments' bits [F, S]
    (numpy or a tensor): in "concat" mode the frames make one stream from
    ``start`` (an int); in "separate" mode each frame its own, from
    ``start`` (an int, or one per frame)."""
    cumsum = torch.cumsum if isinstance(full, torch.Tensor) else np.cumsum
    if mode == "concat":
        flat = full.reshape(-1)
        return (start + cumsum(flat, 0) - flat).reshape(full.shape)
    if not isinstance(start, int):
        start = start[:, None]
    return start + cumsum(full, 1) - full


def _check_mode(mode: str) -> None:
    if mode not in ("concat", "separate"):
        raise ValueError(f"mode must be 'concat' or 'separate', not {mode!r}")


def make_sharded_encode_step(mesh, block_size: int = BLOCK_SIZE,
                             use_rle: bool = True, norm: str = "reference"):
    """The sharded fields step: f(frames u8 [F, H, W] (numpy or a tensor),
    quant [B, B]) -> (vals int32 [F, N, K+2], nbits int32 [F, N, K+2],
    the blocks in row-major order; base int64 [F, S], each stripe's first
    bit within its frame's payload).  A shard's fields come from
    ops/pipeline.py::make_encode_fields (K5 on a card), its stripes' bit
    totals are all-gathered along "block"."""
    fields = make_encode_fields(block_size, use_rle, norm)

    def step(frames, quant):
        lay = _Layout(mesh, frames.shape[0])
        dev = mesh_device(mesh)
        vals, nbits = fields(lay.shard(frames, block_size, dev),
                             _quant_array(quant))
        vals = vals.reshape(lay.f_loc, -1, vals.shape[1])
        nbits = nbits.reshape(vals.shape)
        total = nbits.sum(dim=(1, 2), dtype=torch.int64)  # [f_loc]
        before = all_gather(total, mesh, "block")[:lay.sid].sum(dim=0)
        f, s = lay.fa * lay.f_loc, lay.sa
        return (_gather_rows(mesh, vals).reshape(f, -1, vals.shape[2]),
                _gather_rows(mesh, nbits).reshape(f, -1, vals.shape[2]),
                _gather_rows(mesh, before).reshape(f, s))

    return step


def make_sharded_encode_packed(mesh, block_size: int = BLOCK_SIZE,
                               use_rle: bool = True, norm: str = "reference",
                               mode: str = "concat", histogram: bool = True):
    """Stage 1 of the sharded encode: packed bits off every rank.

    Returns f(frames u8 [F, H, W], quant [B, B], start_bit) ->
        words  int32 [F, S, W]  each segment's words at its final bit
                                phase (u32 bits), word 0 the stream's word
                                base >> 5; defined up to the segment's last
                                word
        bits   int64 [F, S]     each segment's payload bits
        hist   int32 [F, 257]   each frame's byte histogram of the bytes
                                its segments cover whole (slot 256 zero;
                                sum over F yourself in concat mode)

    mode "concat": the frames make one stream (a video's payload), the
    bases accumulate across frames; "separate": each frame is its own
    stream from ``start_bit`` (a batch of same-shape images).  The host
    reads the bit totals once, after their all-gather: they size the words
    and place the segments.  Without ``histogram``, hist is None and K3
    does not run (a caller that counts the spliced streams instead).
    """
    _check_mode(mode)

    def step(frames, quant, start_bit: int):
        lay = _Layout(mesh, frames.shape[0])
        dev = mesh_device(mesh)
        local, lens, _ = cuda_encode.encode_locals(
            lay.shard(frames, block_size, dev), _quant_array(quant),
            block_size, use_rle, norm)
        local = local.view(lay.f_loc, -1, local.shape[1])
        lens = lens.view(lay.f_loc, -1)
        full = _full_matrix(mesh, lens.sum(dim=1, dtype=torch.int64))
        bits = full.cpu().numpy()  # the one wait
        base_f = _bases(bits, int(start_bit), mode)
        n_words = _round4(max(1, int((((base_f & 31) + bits + 31)
                                       >> 5).max())))
        base = base_f[lay.rows, lay.sid]
        phase = base & 31
        words, _ = cuda_pack.pack_segments(local, lens,
                                           to_device(phase, dev), n_words)
        if not histogram:
            return _gather_rows(mesh, words), full, None
        seg = bits[lay.rows, lay.sid]
        window = np.stack([(phase + 7) >> 3, (phase + seg) >> 3])
        lo, hi = to_device(window, dev)
        hist = all_reduce(cuda_kernels.byte_histogram_rows(words, lo, hi),
                          mesh, "block")
        hist = all_gather(hist, mesh, "frame").reshape(-1, 256)
        hist = torch.nn.functional.pad(hist, (0, 1))
        return _gather_rows(mesh, words), full, hist

    return step


def make_sharded_huffman_pack(mesh, mode: str = "concat"):
    """Stage 2 of the sharded encode, the distributed Huffman coding:
    every rank codes the inner bytes its segments own with the shared
    canonical codes and packs them on its device.

    Segment g owns the inner bytes [ceil(base_g / 8), ceil(end_g / 8)): a
    partition of the stream.  Its last byte may hold the next segment's
    first bits, so the host passes each segment's merged end word
    (:func:`_merged_boundary_words`) and the rank ORs it in.  The windowed
    K3 counts the owned bytes; their code bits, the histogram times the
    code lengths, are all-gathered, so each segment's output bit is known
    (the prefix plus the code bits of the segments before it) before K4
    pack_payload codes the window there, all of a rank's segments in one
    launch.

    Returns f(words int32 [F, S, W] (stage 1), bits [F, S], bnd u32 [F, S],
    code_w [F, 256], code_l [F, 256] (numpy, or tensors such as the dict
    tables' columns; row 0 for every frame in concat mode), inner_start,
    prefix_bits [F] (the dict and the header bytes' codes; row 0 in
    concat mode)) ->
        out_words int32 [F, S, W2]  each segment's codes at their final
                                    bit phase, word 0 the output's word
                                    out_base >> 5
        out_bits  int64 [F, S]
    """
    _check_mode(mode)

    def step(words, bits, bnd, code_w, code_l, inner_start: int,
             prefix_bits):
        f, _, n_w = words.shape
        lay = _Layout(mesh, f)
        dev = words.device
        rows = to_device(lay.rows, dev)
        bits = np.asarray(torch.as_tensor(bits).cpu(), np.int64)
        base = _bases(bits, int(inner_start), mode)[lay.rows, lay.sid]
        end = base + bits[lay.rows, lay.sid]
        phase = base & 31
        # The merged end word, where the segment ends inside a word that
        # its buffer holds.
        w = words[rows, lay.sid].clone()
        at = (end >> 5) - (base >> 5)
        live = np.nonzero(((end & 31) != 0) & (at < n_w))[0]
        bnd_mine = np.asarray(bnd, np.int64)[lay.rows, lay.sid]
        if len(live):
            r, c = to_device(live, dev), to_device(at[live], dev)
            w[r, c] |= to_device(bnd_mine[live].astype(np.uint32)
                                 .view(np.int32), dev)
        window = np.stack([(phase + 7) >> 3, (phase + (end - base) + 7) >> 3])
        lo, hi = to_device(window, dev)
        own = cuda_kernels.byte_histogram_rows(w, lo, hi)
        code_rows = to_device(
            lay.rows if mode == "separate" else np.zeros_like(lay.rows), dev)
        cw, cl = (_codes(x, dev)[code_rows] for x in (code_w, code_l))
        out_full = _full_matrix(mesh, (own.to(torch.int64) * cl).sum(dim=1))
        prefix = np.asarray(prefix_bits, np.int64)
        start = (int(prefix[0]) if mode == "concat"
                 else to_device(prefix, dev))
        out_base = _bases(out_full, start, mode)[rows, lay.sid]
        tables = torch.zeros((lay.f_loc, dict_table.TABLE_WORDS),
                             dtype=torch.int32, device=dev)
        t = dict_table
        tables[:, t.CODE_W:t.CODE_W + 256] = cw.to(torch.int32)
        tables[:, t.CODE_L:t.CODE_L + 256] = cl.to(torch.int32)
        meta = tables[:, t.META:].view(torch.int64)
        meta[:, t.META_FIELDS.index("dict_bits")] = out_base & 31
        meta[:, t.META_FIELDS.index("nbytes")] = hi
        meta[:, t.META_FIELDS.index("first_byte")] = lo
        n_out = _round4((31 + 4 * n_w * MAX_CODE_LEN + 31) // 32)
        out, _ = cuda_pack.pack_payload_window(w, tables, n_out)
        return _gather_rows(mesh, out), out_full

    return step


def _codes(x, dev) -> torch.Tensor:
    """Code words or lengths [n, 256] (numpy or a tensor) as int64 on dev."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int64))
    return x.to(dev).to(torch.int64)


def _merged_boundary_words(words, bits, base_np, header: bytes,
                           streams: np.ndarray):
    """Host side: the merged value of every segment-junction word, from
    each segment's first word and the word its end lies in (two small
    copies from the device).

    ``streams[g]`` names the stream of segment g (0 in concat mode, the
    frame in separate mode: word indices of two streams collide).  Returns
    (bnd u32 [n_seg], the merged word at each segment's end word; a
    {(stream, word): u32} map of the header's words and every junction
    word, from which the bytes no segment covers whole are read).  A
    segment that ends on a word boundary puts no bits in its end word,
    and the kernels leave the words past a segment's last one unwritten:
    its end word adds nothing."""
    f, s, n_w = words.shape
    flat = words.reshape(f * s, n_w)
    base = base_np.reshape(-1)
    end = base + np.asarray(bits, np.int64).reshape(-1)
    at = (end >> 5) - (base >> 5)
    live = ((end & 31) != 0) & (at < n_w)
    idx = to_device(np.where(live, at, 0), flat.device)
    fw = flat[:, 0].cpu().numpy().view(np.uint32)
    tw = np.where(live, torch.gather(flat, 1, idx[:, None])[:, 0].cpu()
                  .numpy().view(np.uint32), 0)

    acc: dict[tuple[int, int], int] = {}
    for st in sorted(set(int(x) for x in streams)):
        for p in range(0, len(header), 4):
            wv = int.from_bytes(header[p:p + 4].ljust(4, b"\x00"), "big")
            acc[st, p // 4] = acc.get((st, p // 4), 0) | wv
    for g in range(len(base)):
        st = int(streams[g])
        kb, ke = (st, int(base[g]) >> 5), (st, int(end[g]) >> 5)
        acc[kb] = acc.get(kb, 0) | int(fw[g])
        acc[ke] = acc.get(ke, 0) | int(tw[g])
    bnd = np.array([acc.get((int(streams[g]), int(end[g]) >> 5), 0)
                    for g in range(len(base))], dtype=np.uint32)
    return bnd, acc


def _acc_byte(acc: dict, st: int, b: int) -> int:
    return (acc.get((st, b >> 2), 0) >> (24 - 8 * (b & 3))) & 0xFF


class _Streams:
    """The streams of stage 1's segments, as the host sees them: each
    segment's first bit, each stream's segments, total bits and exact
    byte histogram (the whole bytes the ranks counted, all-reduced, plus
    the bytes no segment covers whole, read from the junction words), and
    the merged end words stage 2 ORs in."""

    def __init__(self, words, bits, hist, start_bit: int, header: bytes,
                 mode: str):
        _check_mode(mode)
        f, s, _ = words.shape
        self.mode, self.start = mode, int(start_bit)
        self.bits = np.asarray(torch.as_tensor(bits).cpu(), np.int64)
        self.base = _bases(self.bits, self.start, mode)
        self.n = f if mode == "separate" else 1
        stream_of = (np.zeros(f * s, np.int64) if mode == "concat"
                     else np.repeat(np.arange(f), s))
        self.bnd, self.acc = _merged_boundary_words(
            words, self.bits, self.base, header, stream_of)
        hist_np = torch.as_tensor(hist).cpu().numpy()[:, :256].astype(
            np.int64)
        self.frames = [list(range(f))] if mode == "concat" else [
            [fi] for fi in range(f)]
        self.totals = np.array([self.start + int(self.bits[fr].sum())
                                for fr in self.frames], np.int64)
        self.freqs = np.stack([self._freqs(st, hist_np[fr].sum(axis=0))
                               for st, fr in enumerate(self.frames)])

    def _freqs(self, st: int, whole: np.ndarray) -> np.ndarray:
        """Stream st's byte histogram: its whole bytes, then the others,
        the gaps between the segments' whole bytes (which follow one
        another in stream order)."""
        vals, at = [], 0  # the first byte no whole byte before covers
        for fi in self.frames[st]:
            for b, nb in zip(self.base[fi], self.bits[fi]):
                b0, b1 = -(-int(b) // 8), int(b + nb) // 8
                if b1 > b0:
                    vals += [self.byte(st, x) for x in range(at, b0)]
                    at = b1
        vals += [self.byte(st, x)
                 for x in range(at, (int(self.totals[st]) + 7) // 8)]
        return whole + np.bincount(np.array(vals, np.int64), minlength=256)

    def byte(self, st: int, b: int) -> int:
        """Byte b of stream st where no segment covers it whole."""
        return _acc_byte(self.acc, st if self.mode == "separate" else 0, b)


def _splice(words, bits: np.ndarray, start, headers, mode: str):
    """The byte-OR splice of aligned segments on their device.

    words: [F, S, W] int32 (each segment's words at its final bit phase,
    defined up to the segment's last word); bits: [F, S]; ``start``: the
    streams' first segment bit (an int, or one a frame in separate mode);
    headers: each stream's bytes before it.  A segment's defined words are
    OR'd into its stream's row from the word its first bit lies in (a
    segment shares a word only with its neighbours and the header, and
    their bits do not overlap).  Returns (rows int32 [n_streams, R] on
    the words' device, total bits int64 [n_streams])."""
    f, s, _ = words.shape
    n = f if mode == "separate" else 1
    base = _bases(bits, start, mode)
    starts = np.broadcast_to(np.asarray(start, np.int64), (f,))
    totals = (bits.sum(axis=1) + starts if mode == "separate"
              else np.array([bits.sum() + starts[0]]))
    heads = [bytes_to_words(h) for h in headers]
    row = _round4(max(1, int(((totals + 31) >> 5).max()),
                      max(len(h) for h in heads)))
    out = torch.zeros((n, row), dtype=torch.int32, device=words.device)
    for st, head in enumerate(heads):
        if len(head):
            out[st, :len(head)] = to_device(head, words.device)
    for fi in range(f):
        st = fi if mode == "separate" else 0
        for si in range(s):
            nb, b = int(bits[fi, si]), int(base[fi, si])
            if nb:
                k = ((b & 31) + nb + 31) >> 5
                out[st, b >> 5:(b >> 5) + k] |= words[fi, si, :k]
    return out, totals.astype(np.int64)


def _stream_bytes(rows: torch.Tensor, totals: np.ndarray) -> list[bytes]:
    """Each row's first ceil(total / 8) bytes, the totals held on the host:
    the wire emit and one pinned copy (ops/huffman.py::Tail), no wait for
    the lengths."""
    lengths = torch.from_numpy(np.asarray(totals, np.int64))
    return Tail(rows, to_device(lengths.numpy(), rows.device),
                lengths=lengths).finish()


def _prefix(table: np.ndarray, got: _Streams, st: int,
            start_bit: int) -> BitWriter:
    """Stream st's Huffman prefix from its dict table read back (int32
    [TABLE_WORDS]): the dict's bits, then the codes of the header bytes
    [0, ceil(start_bit / 8))."""
    t = dict_table
    n = int(table[t.META:].view(np.int64)[t.META_FIELDS.index("dict_bits")])
    pw = BitWriter()
    for k, word in enumerate(table[t.DICT:t.DICT + (n + 31) // 32]
                             .view(np.uint32).tolist()):
        used = min(32, n - 32 * k)
        pw.put(used, word >> (32 - used))
    cw, cl = table[t.CODE_W:t.CODE_W + 256], table[t.CODE_L:t.CODE_L + 256]
    for p in range(-(-start_bit // 8)):
        v = got.byte(st, p)
        pw.put(int(cl[v]), int(cw[v]))
    return pw


def encode_sharded_huffman(words, bits, hist, start_bit: int, header: bytes,
                           mesh, mode: str = "concat"):
    """Finish a stage-1 sharded encode with the distributed Huffman coding.

    The inner stream is never assembled: its byte histogram is the
    all-reduced histogram of whole bytes plus the bytes no segment covers
    whole, read from the junction words (:class:`_Streams`); the dict
    kernel turns every stream's histogram into its codes, dict and
    fallback flag in one launch (ops/huffman.py::build_dict_batch), and
    the host reads the tables back once for the prefixes (the dict, then
    the header bytes' codes); every rank codes its own bytes on its device
    with the tables' codes (:func:`make_sharded_huffman_pack`); the
    compressed segments are spliced on the device behind the prefix.
    Where the coded stream would not be smaller, the stream falls back to
    [0][raw inner bytes]: only then is its inner stream spliced, on the
    device.  The wire emit writes every stream's bytes and one copy brings
    them to the host (ops/huffman.py::Tail, the tables' totals already
    read).  Equal to ops/huffman.py::huffman_encode of the assembled inner
    stream.

    Returns bytes (concat) or a list of each frame's bytes (separate).
    """
    got = _Streams(words, bits, hist, start_bit, header, mode)
    f, dev, t = words.shape[0], words.device, dict_table
    tables = huffman.build_dict_batch(
        to_device(got.freqs.astype(np.int32), dev), to_device(got.totals, dev))
    host = tables.cpu().numpy()
    metas = np.ascontiguousarray(host[:, t.META:]).view(np.int64)
    prefix_bits = np.zeros(f, np.int64)
    prefixes = [b""] * got.n
    fallback = []
    for st, table in enumerate(host):
        meta = dict(zip(t.META_FIELDS, metas[st].tolist()))
        if meta["error"]:
            raise RuntimeError("the Huffman code-length limit found no valid "
                               "code profile for this histogram")
        fallback.append(bool(meta["fallback"]))
        if fallback[-1]:
            continue
        pw = _prefix(table, got, st, start_bit)
        prefixes[st] = pw.getvalue()
        prefix_bits[got.frames[st]] = pw.position
    # A stream that falls back codes nothing: the emit writes its inner
    # stream, spliced here, behind one 0 bit.
    inner = coded = None
    if any(fallback):
        inner, _ = _splice(words, got.bits, start_bit, [header] * got.n,
                           mode)
    if not all(fallback):
        keep = to_device(np.array([not fb for fb in fallback]), dev)
        out_words, out_bits = make_sharded_huffman_pack(mesh, mode)(
            words, got.bits, got.bnd.reshape(f, -1),
            tables[:, t.CODE_W:t.CODE_W + 256],
            tables[:, t.CODE_L:t.CODE_L + 256] * keep[:, None], start_bit,
            prefix_bits)
        out_start = int(prefix_bits[0]) if mode == "concat" else prefix_bits
        coded, totals = _splice(out_words, out_bits.cpu().numpy(), out_start,
                                prefixes, mode)
        want = metas[:, t.META_FIELDS.index("out_total")]
        if any(not fb and int(totals[st]) != int(want[st])
               for st, fb in enumerate(fallback)):
            raise RuntimeError("the coded segments' bits differ from the "
                               "dict tables' out totals")
    inner = coded if inner is None else inner
    lengths = torch.from_numpy(host.reshape(-1)[
        t.META:(got.n - 1) * t.TABLE_WORDS + t.TABLE_WORDS].copy())
    out = Tail(inner, None, tables, inner if coded is None else coded,
               lengths=lengths).finish()
    return out[0] if mode == "concat" else out


def check_int32_bit_capacity(total_bits: int) -> None:
    """The JAX package's guard of its int32 device offsets: a stream of
    2**31 bits or more is refused there (it encodes in GOP or segment
    chunks).  The port's offsets are int64, so its paths do not call it."""
    if int(total_bits) >= 2**31:
        raise ValueError(
            f"sharded stream payload is {int(total_bits)} bits, beyond the "
            "int32 device offset capacity (2**31); encode in GOP/segment "
            "chunks and splice on host instead")


def assemble_packed_stream(words, bits, start_bit: int, header: bytes,
                           mode: str = "concat"):
    """The inner stream bytes of stage 1's segments.

    words: [F, S, W] (a tensor, or numpy; each segment's words at its
    final bit phase); bits: [F, S]; header: the stream's bytes before
    ``start_bit``.  Returns (inner bytes, total bits) in concat mode, or a
    list of each frame's (inner, total bits) in separate mode.  The
    segments are spliced on their device (:func:`_splice`) and one copy
    brings the streams to the host."""
    _check_mode(mode)
    words = torch.as_tensor(words)
    if words.dtype != torch.int32:  # uint32 bits from numpy
        words = torch.as_tensor(np.asarray(words).view(np.int32))
    bits = np.asarray(torch.as_tensor(bits).cpu(), np.int64)
    n = words.shape[0] if mode == "separate" else 1
    rows, totals = _splice(words, bits, int(start_bit), [header] * n, mode)
    out = list(zip(_stream_bytes(rows, totals), totals.tolist()))
    return out[0] if mode == "concat" else out


def boundary_byte_histogram(inner: bytes, bits, start_bit: int) -> np.ndarray:
    """The histogram of the bytes no segment covers whole: the header
    region, each segment boundary's partial byte and the tail.  Stage 1's
    histogram plus this is np.bincount(inner) exactly."""
    bits = np.asarray(torch.as_tensor(bits).cpu(), np.int64).reshape(-1)
    data = np.frombuffer(inner, dtype=np.uint8)
    covered = np.zeros(len(data) + 1, dtype=bool)
    base = start_bit
    for nb in bits:
        lo = -(-base // 8)
        hi = (base + int(nb)) // 8
        if hi > lo:
            covered[lo:hi] = True
        base += int(nb)
    idx = np.nonzero(~covered[:len(data)])[0]
    return np.bincount(data[idx], minlength=256).astype(np.int64)


def encode_sharded_image_batch(frames, quant, mesh, use_rle: bool = True,
                               use_huffman: bool = True,
                               norm: str = "reference",
                               block_size: int = BLOCK_SIZE,
                               device_entropy: bool = False) -> list[bytes]:
    """A batch of same-shape images u8 [F, H, W], sharded over the mesh,
    each to its own stream, byte-identical to encode_image(img, ...,
    device=...) and to imageencoder_tpu.encode_image(backend="numpy").

    Stage 1 (:func:`make_sharded_encode_packed`, separate mode), then
    without Huffman the splice; with Huffman either the segments spliced
    on the device, the windowed K3 over each whole stream and the dict
    kernel and K4 over the batch (one launch each,
    ops/huffman.py::huffman_launch), or with ``device_entropy`` the
    distributed stage 2 (:func:`encode_sharded_huffman`).
    """
    frames_shape = tuple(frames.shape)
    if len(frames_shape) != 3:
        raise ValueError(f"expected frames [F, H, W], got {frames_shape}")
    f, h, w = frames_shape
    qm = quant if isinstance(quant, QuantMatrix) else QuantMatrix(
        np.asarray(quant))
    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)
    write_image_header(writer, qm, use_rle, w, h)
    header = writer.getvalue()
    start = writer.position

    step = make_sharded_encode_packed(mesh, block_size, use_rle, norm,
                                      mode="separate",
                                      histogram=use_huffman and device_entropy)
    words, bits, hist = step(frames, qm.as_float(), start)
    if not use_huffman:
        return [inner for inner, _ in assemble_packed_stream(
            words, bits, start, header, mode="separate")]
    if device_entropy:
        return encode_sharded_huffman(words, bits, hist, start, header, mesh,
                                      mode="separate")
    rows, totals = _splice(words, np.asarray(bits.cpu(), np.int64), start,
                           [header] * f, "separate")
    totals = to_device(totals, rows.device)
    hist = cuda_kernels.byte_histogram_rows(rows, torch.zeros_like(totals),
                                            (totals + 7) // 8)
    return huffman_launch(rows, totals, hist).finish()


def make_sharded_image_decode(mesh, h: int, w: int,
                              block_size: int = BLOCK_SIZE,
                              norm: str = "reference"):
    """The sharded inverse half of the decode: f(coeffs int32 [N, B, B]
    row-major blocks, quant [B, B]) -> image u8 [h, w].

    Block rows shard over the flattened (frame, block) mesh; each rank
    dequantizes, inverts (the exact f64 inverse in the reference's order,
    + 128, clamp, floor: ops/cuda_encode.py::reconstruct with a zero
    prediction, torch operations; the JAX package runs an f32 einsum in
    XLA here, no Pallas kernel) and all-gathers its stripe.  h / B must
    divide by the mesh size (:func:`decode_image_sharded` pads)."""
    b = block_size
    nd = mesh.size()
    if h % b or w % b or (h // b) % nd:
        raise ValueError(f"a {h}x{w} image does not shard into {nd} stripes "
                         f"of {b}-pixel block rows")
    rows = (h // b) // nd

    def step(coeffs, quant):
        dev = mesh_device(mesh)
        at = _flat_index(mesh) * rows * (w // b)
        part = torch.as_tensor(coeffs[at:at + rows * (w // b)]).to(dev)
        img = cuda_encode.unblocks(part.reshape(-1, b * b).to(torch.int32),
                                   rows * b, w)
        pred = torch.zeros((rows * b, w), dtype=torch.uint8, device=dev)
        stripe = cuda_encode.reconstruct(img, pred, _quant_array(quant), b,
                                         norm)
        return all_gather(stripe, mesh).reshape(h, w)

    return step


def _flat_index(mesh) -> int:
    """This rank's index in the flattened (frame, block) mesh."""
    return (axis_index(mesh, "frame") * axis_size(mesh, "block")
            + axis_index(mesh, "block"))


def decode_image_sharded(data: bytes, mesh, norm: str = "reference",
                         block_size: int = BLOCK_SIZE) -> torch.Tensor:
    """Decode one stream across every rank of the mesh: u8 [H, W] on this
    rank's device, pixel for pixel as
    imageencoder_tpu.decode_image(data, backend="numpy").

    Every rank parses the stream and uploads it once, then D1 (with
    Huffman) and D2 run over the whole stream: a block's place depends on
    every block before it.  D3 decodes the rank's stripe of block rows,
    straight into its part of the stripe buffer, and the stripes are
    all-gathered.  Block rows that do not divide among the ranks pad the
    last stripes with gray rows, cut off after the gather."""
    dev = mesh_device(mesh)
    plan = parse_stream(data, block_size, pinned=dev.type == "cuda")
    views = upload(plan, dev)
    payload, nbytes = views["stream"], views["nbytes"]
    if plan["huffman"]:
        payload, nbytes = cuda_decode.huffman_decode(
            payload, nbytes, plan["dict_end"], views["table"],
            plan["max_len"], plan["cap"])
    offs, dbits, counts, _ = cuda_decode.walk_offsets(
        payload, nbytes, plan["start"], plan["n_blocks"], plan["use_rle"],
        block_size)
    b, h, w = block_size, plan["h"], plan["w"]
    by, bx = h // b, w // b
    nd = mesh.size()
    rows = -(-by // nd)
    r0 = _flat_index(mesh) * rows
    real = min(max(by - r0, 0), rows)
    stripe = torch.full((rows * b, w), 128, dtype=torch.uint8, device=dev)
    if real and bx:
        span = slice(r0 * bx, (r0 + real) * bx)
        cuda_decode.decode_blocks(payload, nbytes, offs[span], dbits[span],
                                  counts[span], views["quant"], b, norm,
                                  real * b, w, out=stripe[:real * b])
    return all_gather(stripe, mesh).reshape(nd * rows * b, w)[:h]
