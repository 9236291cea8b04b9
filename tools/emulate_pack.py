#!/usr/bin/env python3
"""Run the packers' kernels and the wire emit on the host, with no card
and no nvcc.

    python tools/emulate_pack.py

Compiles csrc/pack.cu and csrc/wire.cu with g++ against
tools/emulate_decode.py's
emulation of CUDA (each CUDA thread of a block a fiber on one OS thread,
run in turn; barriers, ballots and shuffles yield until every thread has
arrived; two-dimensional grids; dynamic shared memory filled with
garbage at each block), widened here to the intrinsics and atomics the
packers use.  Then it holds K2 over a batch (ie_pack_locals_batch, with
and without the histograms, from one start bit or one a stream) and K4
pack_payload over a batch (ie_pack_payload_batch: the payloads of a batch
and byte windows at odd start bits; ie_pack_payload, one stream) and
the wire emit (ie_emit_wire: the batch's streams without Huffman, and
with it the payloads or, where a stream falls back, its inner words with
one 0 bit first) against their plain versions (ops/cuda_pack.py) on
ragged batches: streams of very different lengths, a stream that takes
the raw-copy fallback (no byte to code), one stream and 17.  It holds K4
pack_records (ie_pack_records, ie_pack_records_segments) against its plain
versions on one stream from bit 0 and from an odd bit behind a 3-word
prefix, on the recon fields of a small clip encoded on the host, on a
run of empty records longer than a tile, and on ragged segments (1 and
17 of them, of 0 records or of several tiles, at odd start bits), and a
record of width 17, whose total must be -1.  The
output buffers start dirty: only the words up to each stream's end are
compared (the emit's bytes up to the last stream's padded end, all of
which it writes); the emit's input words are dirty past each stream's
last byte.

It finds compile errors and logic faults before a chip call; it says
nothing of speed, of nvcc's own rules, or of races (its threads run in
turn).  Exit status 1 on a mismatch.
"""

from __future__ import annotations

import ctypes
import importlib.util
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from imageencoder_tpu_torch.kernels.build import SIGNATURES  # noqa: E402
from imageencoder_tpu_torch.ops import (cuda_encode, cuda_pack,  # noqa
                                        device_pack, dict_table, huffman)

CSRC = REPO / "imageencoder_tpu_torch" / "csrc"
ENTRY = ("ie_pack_locals_batch", "ie_pack_locals_scratch",
         "ie_pack_payload", "ie_pack_payload_batch", "ie_pack_payload_scratch",
         "ie_pack_records", "ie_pack_records_segments",
         "ie_pack_records_scratch", "ie_emit_wire")
UNITS = ("pack.cu", "wire.cu")
JPEG4 = np.array([[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
                  [14, 17, 22, 29]])

# What pack.cu needs beyond the decode kernels' emulation.
EXTRA = r"""
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline unsigned atomicOr(unsigned* p, unsigned v) {
    const unsigned old = *p;
    *p = old | v;
    return old;
}
inline int atomicAdd(int* p, int v) {
    const int old = *p;
    *p = old + v;
    return old;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
    return (unsigned)(((((unsigned long long)hi) << 32) | lo) >> (s & 31));
}
inline int __reduce_add_sync(unsigned, int v) {
    const int t = threadIdx.x, w = t / 32;
    __syncwarp();
    g_emu->slot[t] = (unsigned long long)(long long)v;
    __syncwarp();
    long long r = 0;
    for (int l = 0; l < 32; l++) r += (long long)g_emu->slot[w * 32 + l];
    __syncwarp();
    return (int)r;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
    return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
"""


def load_decode_emulation():
    spec = importlib.util.spec_from_file_location(
        "emulate_decode", REPO / "tools" / "emulate_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shim(base: str) -> str:
    """The decode emulation's shim with the extras above."""
    return base + EXTRA


def source(text: str, launch: re.Pattern) -> str:
    """pack.cu for the emulation: launches as calls, dynamic shared memory
    from the launch."""
    text = re.sub(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                  r"\1* \2 = (\1*)emu_dyn.data();", text)
    return launch.sub(lambda m: f"emu_launch({m.group(2)}, [&]{{ "
                                f"{m.group(1)}({m.group(3)}); }});", text)


def build(tmp: pathlib.Path) -> ctypes.CDLL:
    """pack.cu and wire.cu, launches rewritten, compiled into a
    library."""
    emu = load_decode_emulation()
    (tmp / "cuda_runtime.h").write_text(shim(emu.SHIM))
    for src in [*CSRC.glob("*.cuh"), *(CSRC / u for u in UNITS)]:
        (tmp / src.name).write_text(source(src.read_text(), emu.LAUNCH))
    lib = tmp / "libemu_pack.so"
    cmd = ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{tmp}"]
    for unit in UNITS:
        cmd += ["-x", "c++", str(tmp / unit)]
    subprocess.run([*cmd, "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ENTRY:
        getattr(dll, name).argtypes = SIGNATURES[name]
        getattr(dll, name).restype = ctypes.c_int
    return dll


def ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def dirty(shape) -> np.ndarray:
    """An output buffer of garbage: the kernels leave words past a stream
    as they were."""
    return np.full(shape, -0x5A5A5A5B, np.int32)


def locals_batch(lib, local, lens, start, n_words: int, prefix=None,
                 hist: bool = False):
    """K2 over a batch, emulated: (words [B, n_words], totals [B], hists
    [B, 256] or None).  ``start``: one start bit, or int64 [B]."""
    b, n, lw = local.shape
    starts = None if np.isscalar(start) else np.ascontiguousarray(
        start, np.int64)
    sums = np.full(b * lib.ie_pack_locals_scratch(n, lw), -7, np.int64)
    out, total = dirty((b, n_words)), np.full(b, -9, np.int64)
    bins = np.full((b, 256), 77, np.int32) if hist else None
    pre = None if prefix is None else np.ascontiguousarray(prefix, np.int32)
    assert lib.ie_pack_locals_batch(
        ptr(local), ptr(lens), n, lw, b, 0 if starts is not None else start,
        None if starts is None else ptr(starts),
        None if pre is None else ptr(pre), 0 if pre is None else len(pre),
        ptr(out), n_words, ptr(sums), ptr(total),
        None if bins is None else ptr(bins), None) == 0
    return out, total, bins


def payload_batch(lib, words, tables, n_words: int):
    """K4 pack_payload over a batch, emulated: (payloads [B, n_words],
    totals [B])."""
    b, w = words.shape
    sums = np.full(b * lib.ie_pack_payload_scratch(w), -7, np.int64)
    out, total = dirty((b, n_words)), np.full(b, -9, np.int64)
    assert lib.ie_pack_payload_batch(ptr(words), w, ptr(tables), b, ptr(out),
                                     n_words, ptr(sums), ptr(total),
                                     None) == 0
    return out, total


def payload_one(lib, words, table, n_words: int):
    """K4 pack_payload of one stream, emulated: (payload, total [1])."""
    sums = np.full(lib.ie_pack_payload_scratch(len(words)), -7, np.int64)
    out, total = dirty(n_words), np.full(1, -9, np.int64)
    assert lib.ie_pack_payload(ptr(words), len(words), ptr(table), ptr(out),
                               n_words, ptr(sums), ptr(total), None) == 0
    return out, total


def records_one(lib, vals, nbits, start: int, n_words: int, prefix=None):
    """K4 pack_records of one stream, emulated: (words [1, n_words],
    total [1])."""
    n, f = vals.shape
    sums = np.full(lib.ie_pack_records_scratch(n), -7, np.int64)
    out, total = dirty(n_words), np.full(1, -9, np.int64)
    assert lib.ie_pack_records(
        ptr(vals), ptr(nbits), n, f, start,
        None if prefix is None else ptr(prefix),
        0 if prefix is None else len(prefix), ptr(out), n_words, ptr(sums),
        ptr(total), None) == 0
    return out[None], total


def records_segments(lib, vals, nbits, starts, n_words: int):
    """K4 pack_records over segments, emulated: (words [B, n_words],
    totals [B])."""
    b, n, f = vals.shape
    sums = np.full(b * lib.ie_pack_records_scratch(n), -7, np.int64)
    out, total = dirty((b, n_words)), np.full(b, -9, np.int64)
    assert lib.ie_pack_records_segments(
        ptr(vals), ptr(nbits), n, f, b, ptr(starts), ptr(out), n_words,
        ptr(sums), ptr(total), None) == 0
    return out, total


def emit_wire(lib, words, totals=None, tables=None, payload=None):
    """The wire emit, emulated, into a dirty buffer: u8
    [wire_capacity(B, W)]."""
    b, w = words.shape
    out = np.full(cuda_pack.wire_capacity(b, w), 0x5B, np.uint8)
    p_words = 0 if payload is None else payload.shape[1]
    assert lib.ie_emit_wire(
        ptr(words), w, w, None if payload is None else ptr(payload), p_words,
        p_words, None if tables is None else ptr(tables),
        None if totals is None else ptr(totals), b, ptr(out), None) == 0
    return out


def dirty_past(words: torch.Tensor, bits) -> np.ndarray:
    """Each row's words with garbage in every byte past its stream's
    ceil(bits / 8), as the packers leave their buffers."""
    rows = words.numpy().copy()
    raw = rows.view(np.uint8).reshape(rows.shape[0], -1)
    for k, t in enumerate(bits):
        nbytes = (max(int(t), 0) + 7) // 8
        # Bytes in memory are little-endian within a word: byte i of the
        # stream lies at 4 (i // 4) + 3 - i % 4.
        idx = np.arange(raw.shape[1])
        stream_pos = 4 * (idx // 4) + 3 - idx % 4
        raw[k, stream_pos >= nbytes] = 0xA7
    return rows


def same_wire(got: np.ndarray, want: torch.Tensor, sources,
              n_words: int) -> bool:
    """The emit's bytes up to the last stream's padded end (every one it
    writes) equal the plain version's."""
    nbytes, offsets, _ = cuda_pack.wire_layout(sources, n_words)
    end = offsets[-1] + -(-nbytes[-1] // 16) * 16 if nbytes else 0
    return np.array_equal(got[:end], want[:end].numpy())


def same_streams(got, want) -> bool:
    """Each row's words up to its stream's end and the totals equal (the
    histograms too where given)."""
    gw, gt, *gh = got
    ww, wt, *wh = want
    ok = np.array_equal(gt, wt.numpy())
    for k in range(len(gt)):
        n = (max(int(wt[k]), 0) + 31) // 32
        ok = ok and np.array_equal(gw[k, :n], ww[k, :n].numpy())
    if gh and gh[0] is not None:
        ok = ok and np.array_equal(gh[0], wh[0].numpy())
    return ok


def images(kinds, h: int, w: int, seed: int) -> np.ndarray:
    """Same-shape u8 images [B, H, W] of very different content: image k
    is smooth where kinds[k] is "smooth", noise where "noise", flat where
    "flat"."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for k, kind in enumerate(kinds):
        if kind == "noise":
            out.append(rng.integers(0, 256, (h, w), dtype=np.uint8))
        elif kind == "flat":
            out.append(np.full((h, w), 100 + k, np.uint8))
        else:
            f = 128 + 60 * np.sin(x / (5 + k)) * np.cos(y / 7) \
                + rng.normal(0, 4, (h, w))
            out.append(np.clip(np.rint(f), 0, 255).astype(np.uint8))
    return np.stack(out)


def batch_inputs(imgs: np.ndarray, quant: np.ndarray):
    """K2's and K4's inputs for a batch, as encode_image_batch makes them
    on the CPU: (local, lens, start bit, n_words, header prefix), the
    plain K2's (words, totals, hists) and the dict tables."""
    from imageencoder_tpu_torch.models import image
    from imageencoder_tpu_torch.utils.quant import QuantMatrix

    b, h, w = imgs.shape
    q = QuantMatrix(quant)
    start, header = image.stream_header(q, True, w, h, True, "cpu")
    local, lens, _ = cuda_encode.encode_locals(
        torch.from_numpy(imgs.reshape(b * h, w)), q.as_float(), 4, True,
        "reference")
    n = local.shape[0] // b
    n_words = device_pack.packed_words_bound(n, local.shape[1])
    local, lens = local.view(b, n, -1), lens.view(b, n)
    plain = cuda_pack.pack_locals_hist_batch_plain(local, lens, start,
                                                   n_words, header)
    tables = huffman.build_dict_batch_plain(plain[2], plain[1])
    return (local, lens, start, n_words, header), plain, tables


def window_tables(tables: torch.Tensor, words_w: int, seed: int):
    """The tables of byte windows as the sharded stage 2 writes them:
    each row's codes, no dict words, a start bit 0..31 (odd ones among
    them) and a window [first, nbytes) with first > 0."""
    rng = np.random.default_rng(seed)
    t = dict_table
    out = torch.zeros_like(tables)
    out[:, t.CODE_W:t.CODE_W + 256] = tables[:, t.CODE_W:t.CODE_W + 256]
    out[:, t.CODE_L:t.CODE_L + 256] = tables[:, t.CODE_L:t.CODE_L + 256]
    meta = out[:, t.META:].view(torch.int64)
    b = tables.shape[0]
    first = rng.integers(1, 5, b)
    last = np.minimum(first + rng.integers(0, 4 * words_w, b), 4 * words_w)
    meta[:, t.META_FIELDS.index("dict_bits")] = torch.from_numpy(
        (2 * rng.integers(0, 16, b) + 1).astype(np.int64))
    meta[:, t.META_FIELDS.index("first_byte")] = torch.from_numpy(first)
    meta[:, t.META_FIELDS.index("nbytes")] = torch.from_numpy(last)
    return out


def run_case(lib, label: str, kinds, shape, quant, report) -> None:
    imgs = images(kinds, *shape, len(kinds))
    (local, lens, start, n_words, header), plain, tables = batch_inputs(
        imgs, quant)
    ln, lo = lens.numpy(), local.numpy()
    report(f"{label}: K2 batch",
           same_streams(locals_batch(lib, lo, ln, start, n_words,
                                     header.numpy())[:2], plain[:2]))
    report(f"{label}: K2+hist batch",
           same_streams(locals_batch(lib, lo, ln, start, n_words,
                                     header.numpy(), hist=True), plain))
    starts = np.arange(len(kinds), dtype=np.int64) * 7 % 32
    report(f"{label}: K2 segments",
           same_streams(locals_batch(lib, lo, ln, starts, n_words)[:2],
                        cuda_pack.pack_segments_plain(
                            local, lens, torch.from_numpy(starts), n_words)))
    words = plain[0]
    p_words = -(-huffman.payload_words(words.shape[1]) // 4) * 4
    got = payload_batch(lib, words.numpy(), tables.numpy(), p_words)
    report(f"{label}: K4 pack_payload batch (bytes coded "
           f"{[int(dict_table.fields(t)['nbytes']) for t in tables]})",
           same_streams(got, cuda_pack.pack_payload_batch_plain(
               words, tables, p_words)))
    # One stream alone, its words not a whole number of records.
    k = int(np.argmax([dict_table.fields(t)["nbytes"] for t in tables]))
    row = words[k].numpy()[:-3].copy()
    want = cuda_pack.pack_payload_plain(torch.from_numpy(row), tables[k],
                                        p_words)
    got = payload_one(lib, row, tables[k].numpy().copy(), p_words)
    report(f"{label}: K4 pack_payload one stream",
           same_streams((got[0][None], got[1]),
                        (want[0][None], want[1].reshape(1))))
    win = window_tables(tables, words.shape[1], len(kinds))
    got = payload_batch(lib, words.numpy(), win.numpy(), p_words)
    report(f"{label}: K4 pack_payload window",
           same_streams(got, cuda_pack.pack_payload_batch_plain(
               words, win, p_words)))
    # The wire emit on the streams with garbage past each one's end: the
    # inner words without Huffman, and with it each stream's payload or,
    # where its table falls back, its inner words behind one 0 bit.
    n_w = words.shape[1]
    inner = dirty_past(words, plain[1])
    report(f"{label}: wire emit without Huffman",
           same_wire(emit_wire(lib, inner, totals=plain[1].numpy()),
                     cuda_pack.emit_wire_plain(torch.from_numpy(inner),
                                               plain[1]),
                     [(int(t), False) for t in plain[1]], n_w))
    payload, p_totals = cuda_pack.pack_payload_batch_plain(words, tables,
                                                           p_words)
    payload = dirty_past(payload, p_totals)
    sources = cuda_pack.wire_sources(None, tables)
    report(f"{label}: wire emit with Huffman (fallback "
           f"{[fb for _, fb in sources]})",
           same_wire(emit_wire(lib, inner, tables=tables.numpy(),
                               payload=payload),
                     cuda_pack.emit_wire_plain(
                         torch.from_numpy(inner), None, tables,
                         torch.from_numpy(payload)), sources, n_w))


CASES = {  # label: image kinds, (H, W), quant
    "ragged 4": (("smooth", "noise", "flat", "smooth"), (96, 256), JPEG4),
    # Streams of many tiles and groups of tiles (a tile codes 8 KB).
    "long 3": (("noise", "smooth", "noise"), (256, 384), JPEG4),
    "fallback 4, quant all ones": (("smooth", "smooth", "smooth", "noise"),
                                   (128, 256), np.ones((4, 4), np.int64)),
    "one stream": (("smooth",), (96, 256), JPEG4),
    "17 streams": (tuple(("smooth", "noise", "flat")[k % 3]
                         for k in range(17)), (64, 128), JPEG4),
}


def fields(shape, seed: int, widths=(0, 17)):
    """Random (vals, nbits) int32 fields of ``shape``, widths drawn from
    [widths[0], widths[1])."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-2 ** 15, 2 ** 15, shape).astype(np.int32)
    return vals, rng.integers(*widths, shape).astype(np.int32)


def row_words(n: int, f: int) -> int:
    """Words enough for n records of f fields of up to 16 bits from any
    start bit below 32, rounded to 16 bytes."""
    return -(-(n * f * 16 // 32 + 2) // 4) * 4


def recon_fields(seed: int):
    """The recon path's records as pack_records fields: a 128x96 clip of 8
    frames encoded on the host (encode_video, ref_mode="recon", gop 4),
    its pack_coeffs call's coefficients and vectors through coeff_fields:
    (vals, nbits, start bit, n_words, header prefix)."""
    import imageencoder_tpu_torch as port

    calls = []
    real = cuda_pack.pack_coeffs_hist

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    w, h = 128, 96
    frames = images(("smooth",) * 8, h, w, seed)
    data = b"".join(f.tobytes() + bytes([128]) * (w * h // 2) for f in frames)
    cuda_pack.pack_coeffs_hist = record
    try:
        port.encode_video(data, w, h, port.quant_from_numpy(JPEG4), True, 4,
                          8, ref_mode="recon", device="cpu")
    finally:
        cuda_pack.pack_coeffs_hist = real
    (coeffs, mvecs, gop, nb, b, rle, _lw, start, n_words), kw = calls[0]
    vals, nbits = cuda_pack.coeff_fields(coeffs, mvecs, gop, nb, b, rle)
    return (vals.numpy(), nbits.numpy(), start, n_words,
            kw["prefix"].numpy())


def held_records(lib, vals, nbits, start: int, n_words: int,
                 prefix=None) -> bool:
    """K4 pack_records, emulated into a dirty buffer, equals its plain
    version up to the stream's end."""
    want = cuda_pack.pack_records_plain(
        torch.from_numpy(vals), torch.from_numpy(nbits), start, n_words,
        None if prefix is None else torch.from_numpy(prefix))
    return same_streams(records_one(lib, vals, nbits, start, n_words, prefix),
                        (want[0][None], want[1].reshape(1)))


def held_segments(lib, vals, nbits, starts, n_words: int) -> bool:
    """K4 pack_records over segments, emulated into dirty buffers, equals
    its plain version segment by segment up to each one's end."""
    want = cuda_pack.pack_records_segments_plain(
        torch.from_numpy(vals), torch.from_numpy(nbits),
        torch.from_numpy(starts), n_words)
    return same_streams(records_segments(lib, vals, nbits, starts, n_words),
                        want)


def empty_run(lib) -> bool:
    """Records 301 .. 1,500 of 2,000 empty: the tiles before the run reach
    past whole empty tiles for the bits of their last words."""
    vals, nbits = fields((2000, 3), 8)
    nbits[301:1501] = 0
    nbits[300] = (5, 7, 9)  # the run starts inside a word
    return held_records(lib, vals, nbits, 11, row_words(2000, 3))


def refused_width(lib) -> bool:
    """A record with a width of 17, in the second tile of three: the total
    is -1."""
    vals, nbits = fields((1500, 5), 4)
    nbits[700, 2] = 17
    return int(records_one(lib, vals, nbits, 3, row_words(1500, 5))[1][0]) \
        == -1


def one_stream(lib, n: int, f: int, start: int, prefix_words: int,
               seed: int) -> bool:
    vals, nbits = fields((n, f), seed)
    prefix = None
    if prefix_words:
        prefix = np.random.default_rng(seed).integers(
            -2 ** 31, 2 ** 31, prefix_words).astype(np.int32)
    return held_records(lib, vals, nbits, start, row_words(n, f) + 4, prefix)


def segments(lib, b: int, n: int, f: int, seed: int, widths=(0, 17)) -> bool:
    vals, nbits = fields((b, n, f), seed, widths)
    starts = np.random.default_rng(seed).integers(0, 16, b) * 2 + 1
    return held_segments(lib, vals, nbits, starts.astype(np.int64),
                         row_words(n, f))


RECORD_CASES = {  # label: check(lib) -> bool
    # 10 tiles of 512 records: two groups of tiles.
    "one stream from bit 0": lambda lib: one_stream(lib, 5000, 7, 0, 0, 1),
    "one stream from bit 101 behind 3 prefix words":
        lambda lib: one_stream(lib, 700, 18, 101, 3, 2),
    "the recon fields of a small clip":
        lambda lib: held_records(lib, *recon_fields(3)),
    "a run of 1,200 empty records": empty_run,
    "a width of 17: total -1": refused_width,
    "1 segment of several tiles, widths 6":
        lambda lib: segments(lib, 1, 1500, 2, 5, (6, 7)),
    "17 segments of 0 records": lambda lib: segments(lib, 17, 0, 2, 6),
    "17 segments of several tiles": lambda lib: segments(lib, 17, 1100, 3, 7),
}


def main() -> int:
    failed = 0

    def report(label: str, ok: bool) -> None:
        nonlocal failed
        failed += not ok
        print(f"{'ok  ' if ok else 'FAIL'} {label}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        lib = build(pathlib.Path(tmp))
        for label, (kinds, shape, quant) in CASES.items():
            run_case(lib, label, kinds, shape, quant, report)
        for label, check in RECORD_CASES.items():
            report(f"K4 pack_records: {label}", check(lib))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
