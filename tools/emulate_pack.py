#!/usr/bin/env python3
"""Run the packers' two-launch kernels on the host, with no card and no
nvcc.

    python tools/emulate_pack.py

Compiles csrc/pack.cu with g++ against tools/emulate_decode.py's
emulation of CUDA (each CUDA thread of a block a fiber on one OS thread,
run in turn; barriers, ballots and shuffles yield until every thread has
arrived), widened here to two-dimensional grids, dynamic shared memory
(filled with garbage at each block) and the intrinsics and atomics the
packers use.  Then it holds K2 over a batch (ie_pack_locals_batch, with
and without the histograms, from one start bit or one a stream) and K4
pack_payload over a batch (ie_pack_payload_batch: the payloads of a batch
and byte windows at odd start bits; ie_pack_payload, one stream)
against their plain versions
(ops/cuda_pack.py) on ragged batches: streams of very different lengths,
a stream that takes the raw-copy fallback (no byte to code), one stream
and 17.  The output buffers start dirty: only the words up to each
stream's end are compared.

The single-pass packer (pack_tiles: one CTA waits for others) is compiled
but not run: blocks run one after another here, so it would wait forever.
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
         "ie_pack_payload", "ie_pack_payload_batch", "ie_pack_payload_scratch")
JPEG4 = np.array([[16, 11, 10, 16], [12, 12, 14, 19], [14, 13, 16, 24],
                  [14, 17, 22, 29]])

# What pack.cu needs beyond the decode kernels' emulation.
EXTRA = r"""
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
    return {a, b, c, d};
}
inline int max(int a, int b) { return a > b ? a : b; }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline unsigned atomicOr(unsigned* p, unsigned v) {
    const unsigned old = *p;
    *p = old | v;
    return old;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
    const unsigned old = *p;
    *p = old + v;
    return old;
}
inline int atomicAdd(int* p, int v) {
    const int old = *p;
    *p = old + v;
    return old;
}
inline unsigned long long atomicExch(unsigned long long* p,
                                     unsigned long long v) {
    const unsigned long long old = *p;
    *p = v;
    return old;
}
inline void __threadfence() {}
inline void __nanosleep(unsigned) {}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
    return (unsigned)(((((unsigned long long)hi) << 32) | lo) >> (s & 31));
}
inline bool __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
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
enum { cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
    return cudaSuccess;
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        int* n, K, int, size_t) {
    *n = 1;
    return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
    *v = 4;
    return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
// Dynamic shared memory: a block's own, garbage at its start.
inline std::vector<unsigned> emu_dyn;
template <class F>
inline void emu_launch(dim3 grid, unsigned block, size_t smem,
                       cudaStream_t s, F f) {
    gridDim.y = grid.y;
    for (unsigned y = 0; y < grid.y; y++) {
        blockIdx.y = y;
        emu_dyn.assign(smem / 4 + 4, 0xA5A5A5A5u);
        emu_launch(grid.x, block, smem, s, f);
    }
    blockIdx.y = 0;
    gridDim.y = 0;
}
"""


def load_decode_emulation():
    spec = importlib.util.spec_from_file_location(
        "emulate_decode", REPO / "tools" / "emulate_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shim(base: str) -> str:
    """The decode emulation's shim with two-dimensional grids and the
    extras above."""
    old = "struct dim3 { unsigned x = 0, y = 0, z = 0; };"
    if base.count(old) != 1:
        raise RuntimeError("emulate_decode.py's dim3 changed")
    base = base.replace(old, "struct dim3 { unsigned x = 0, y = 0, z = 0; "
                             "dim3() = default; dim3(unsigned a, unsigned "
                             "b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };")
    return base + EXTRA


def source(text: str, launch: re.Pattern) -> str:
    """pack.cu for the emulation: launches as calls, dynamic shared memory
    from the launch, the PTX loads and stores as plain ones."""
    text = re.sub(r"extern __shared__ __align__\(16\) (\w+) (\w+)\[\];",
                  r"\1* \2 = (\1*)emu_dyn.data();", text)
    text = re.sub(r'asm volatile\("ld[^"]*"[^;]*;', "v = *p;", text)
    text = re.sub(r'asm volatile\("st[^"]*"[^;]*;', "*p = v;", text)
    return launch.sub(lambda m: f"emu_launch({m.group(2)}, [&]{{ "
                                f"{m.group(1)}({m.group(3)}); }});", text)


def build(tmp: pathlib.Path) -> ctypes.CDLL:
    """pack.cu, launches rewritten, compiled into a library."""
    emu = load_decode_emulation()
    (tmp / "cuda_runtime.h").write_text(shim(emu.SHIM))
    for src in [*CSRC.glob("*.cuh"), CSRC / "pack.cu"]:
        (tmp / src.name).write_text(source(src.read_text(), emu.LAUNCH))
    lib = tmp / "libemu_pack.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    f"-I{tmp}", "-x", "c++", str(tmp / "pack.cu"), "-o",
                    str(lib)], check=True)
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
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
