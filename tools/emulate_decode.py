#!/usr/bin/env python3
"""Run the decode kernels D1-D3 and the vector read on the host, with no
card and no nvcc.

    python tools/emulate_decode.py

Compiles csrc/huffman_decode.cu, walk.cu and decode.cu with g++ against a
small emulation of the CUDA they use: every CUDA thread of a block is a
fiber (ucontext) on one OS thread, run in turn, blocks run one after
another over a grid of one or two dimensions, __syncthreads is a block
barrier and ballots, shuffles and warp reductions exchange through a
per-warp barrier, each a yield until every thread has arrived, dynamic
shared memory (`emu_dyn`) is filled with garbage at each block, and a
launch `k<<<grid, block, smem, stream>>>(args)` becomes a call that runs
the grid.  tools/emulate_pack.py and tools/emulate_dict.py build on this
emulation.  Then it holds each kernel's output against its plain version
(ops/cuda_decode.py) on streams written by the port's encoder on the CPU
and on records built to keep speculative walkers out of phase, with many
small chunks, and prints the chunks each chain walked whole.  For videos
(streams of the port's encode_video: gop 1, 4 and 5, merange 1 and 16,
RLE on and off, whole and cut short) it runs D2 over the whole video with
chunks small enough that nearly every chunk holds a frame boundary, the
vector read at the start bits D2 wrote, and D3 on frame k of every GOP at
once with the prediction from frame k - 1 (the plain K7), as the decode
does, and holds the frames against decode_video(device="cpu").

It finds compile errors and logic faults before a chip call.  It says
nothing of speed, of nvcc's own rules, or of races (its threads run in
turn); the card tests and chip_smoke.py do.  Exit status 1 on a mismatch.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from imageencoder_tpu_torch import (QuantMatrix, decode_video,  # noqa
                                    encode_image, encode_video)
from imageencoder_tpu_torch.kernels.build import SIGNATURES  # noqa: E402
from imageencoder_tpu_torch.models import image, video  # noqa: E402
from imageencoder_tpu_torch.ops import (bitpack, cuda_decode,  # noqa: E402
                                        huffman, motion)
from imageencoder_tpu_torch.ops.dct import _inv_weights  # noqa: E402
from imageencoder_tpu_torch.ops.zigzag import zigzag_order  # noqa: E402

CSRC = REPO / "imageencoder_tpu_torch" / "csrc"
UNITS = ("huffman_decode.cu", "walk.cu", "decode.cu")
ENTRY = ("ie_huffman_decode", "ie_walk_video", "ie_chain_scratch_words",
         "ie_read_vectors", "ie_decode_blocks")

SHIM = r"""
#pragma once
#include <ucontext.h>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct dim3 {
    unsigned x = 0, y = 0, z = 0;
    dim3() = default;
    dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline long long clock64() {
    return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline unsigned atomicAnd(unsigned* p, unsigned v) {
    const unsigned old = *p;
    *p = old & v;
    return old;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
    const unsigned long long old = *p;
    *p = old + v;
    return old;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline double __ddiv_rn(double a, double b) { volatile double r = a / b; return r; }
inline double __int2double_rn(int a) { return a; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
    return {a, b, c, d};
}
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
    return (unsigned)(((((unsigned long long)hi) << 32) | lo)
                      >> (32 - (s & 31)));
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const unsigned long long v = ((unsigned long long)y << 32) | x;
    unsigned r = 0;
    for (int i = 0; i < 4; i++)
        r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFFu) << (8 * i);
    return r;
}
struct double2 { double x, y; };
// A block's threads are fibers on one OS thread, run in turn; a barrier
// yields until every thread of its warp or block has arrived.
struct EmuFiber {
    ucontext_t ctx;
    std::vector<char> stack;
    bool done;
};
struct EmuBarrier {
    unsigned n, arrived = 0, generation = 0;
};
struct EmuBlock {
    ucontext_t main;
    std::vector<EmuFiber> fibers;
    unsigned current = 0;
    EmuBarrier block;
    std::vector<EmuBarrier> warp;
    std::vector<unsigned long long> slot;
    void (*run)(void*) = nullptr;
    void* job = nullptr;
};
inline EmuBlock* g_emu;
inline void emu_yield() {
    EmuBlock* b = g_emu;
    swapcontext(&b->fibers[b->current].ctx, &b->main);
}
inline void emu_wait(EmuBarrier& bar) {
    const unsigned gen = bar.generation;
    if (++bar.arrived == bar.n) {
        bar.arrived = 0;
        bar.generation++;
        return;
    }
    while (bar.generation == gen) emu_yield();
}
inline void __syncthreads() { emu_wait(g_emu->block); }
inline void __syncwarp() { emu_wait(g_emu->warp[threadIdx.x / 32]); }
inline int __syncthreads_or(int p) {
    __syncthreads();
    g_emu->slot[threadIdx.x] = p != 0;
    __syncthreads();
    int r = 0;
    for (unsigned long long v : g_emu->slot) r |= v != 0;
    __syncthreads();
    return r;
}
template <class T> inline T emu_exchange(T v, int src_of_lane(int, int),
                                         int arg) {
    const int t = threadIdx.x, w = t / 32, lane = t % 32;
    __syncwarp();
    unsigned long long u = 0;
    std::memcpy(&u, &v, sizeof(T));
    g_emu->slot[t] = u;
    __syncwarp();
    const int src = src_of_lane(lane, arg);
    T r = v;
    if (src >= 0) {
        const unsigned long long x = g_emu->slot[w * 32 + src];
        std::memcpy(&r, &x, sizeof(T));
    }
    __syncwarp();
    return r;
}
inline int emu_src(int, int src) { return src; }
inline int emu_up(int lane, int d) { return lane >= d ? lane - d : -1; }
inline int emu_xor(int lane, int m) { return lane ^ m; }
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
    return emu_exchange(v, emu_src, src);
}
template <class T> inline T __shfl_up_sync(unsigned, T v, int d) {
    return emu_exchange(v, emu_up, d);
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) {
    return emu_exchange(v, emu_xor, m);
}
inline unsigned __ballot_sync(unsigned, bool p) {
    const int t = threadIdx.x, w = t / 32;
    __syncwarp();
    g_emu->slot[t] = p;
    __syncwarp();
    unsigned r = 0;
    for (int l = 0; l < 32; l++)
        if (g_emu->slot[w * 32 + l]) r |= 1u << l;
    __syncwarp();
    return r;
}
inline bool __all_sync(unsigned m, int p) {
    return __ballot_sync(m, p) == 0xffffffffu;
}
inline bool __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
template <class T> inline T emu_reduce(T v, bool take_max) {
    const int t = threadIdx.x, w = t / 32;
    __syncwarp();
    g_emu->slot[t] = (unsigned long long)(long long)v;
    __syncwarp();
    T r = v;
    for (int l = 0; l < 32; l++) {
        const T x = (T)(long long)g_emu->slot[w * 32 + l];
        r = take_max ? (x > r ? x : r) : (x < r ? x : r);
    }
    __syncwarp();
    return r;
}
inline int __reduce_max_sync(unsigned, int v) { return emu_reduce(v, true); }
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
    return emu_reduce(v, true);
}
inline int __reduce_min_sync(unsigned, int v) { return emu_reduce(v, false); }
inline void emu_fiber_main() {
    EmuBlock* b = g_emu;
    b->run(b->job);
    b->fibers[b->current].done = true;
    emu_yield();
}
// Dynamic shared memory: a block's own, garbage at its start.
inline std::vector<unsigned> emu_dyn;
template <class F>
inline void emu_launch(dim3 grid, unsigned block, size_t smem, cudaStream_t,
                       F f) {
    blockDim.x = block;
    gridDim.x = grid.x;
    gridDim.y = grid.y;
    EmuBlock eb;
    eb.block.n = block;
    eb.warp.assign((block + 31) / 32, EmuBarrier{32});
    eb.slot.assign(block, 0);
    eb.fibers.resize(block);
    eb.run = [](void* j) { (*static_cast<F*>(j))(); };
    eb.job = &f;
    g_emu = &eb;
    for (unsigned y = 0; y < grid.y; y++)
    for (unsigned b = 0; b < grid.x; b++) {
        blockIdx.x = b;
        blockIdx.y = y;
        emu_dyn.assign(smem / 4 + 4, 0xA5A5A5A5u);
        for (auto& fb : eb.fibers) {
            fb.stack.resize(1 << 16);
            fb.done = false;
            getcontext(&fb.ctx);
            fb.ctx.uc_stack.ss_sp = fb.stack.data();
            fb.ctx.uc_stack.ss_size = fb.stack.size();
            fb.ctx.uc_link = nullptr;
            makecontext(&fb.ctx, emu_fiber_main, 0);
        }
        for (unsigned left = block; left > 0;) {
            left = 0;
            for (unsigned t = 0; t < block; t++) {
                if (eb.fibers[t].done) continue;
                eb.current = t;
                threadIdx.x = t;
                swapcontext(&eb.main, &eb.fibers[t].ctx);
                left += !eb.fibers[t].done;
            }
        }
    }
    blockIdx.y = 0;
    gridDim.y = 0;
}
"""

LAUNCH = re.compile(r"([\w:]+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def build(tmp: pathlib.Path) -> ctypes.CDLL:
    """The three units, launches rewritten, compiled into one library."""
    (tmp / "cuda_runtime.h").write_text(SHIM)
    for src in [*CSRC.glob("*.cuh"), *(CSRC / u for u in UNITS)]:
        text = LAUNCH.sub(lambda m: f"emu_launch({m.group(2)}, [&]{{ "
                                    f"{m.group(1)}({m.group(3)}); }});",
                          src.read_text())
        (tmp / src.name).write_text(text)
    lib = tmp / "libemu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off",
           "-fPIC", "-shared", f"-I{tmp}"]
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


def buffer(data: bytes, tail: int) -> np.ndarray:
    """The bytes and ``tail`` bytes of 0xFF past them: reads past the
    count must not see them."""
    return np.frombuffer(data + b"\xff" * tail, np.uint8).copy()


def stats_buffer() -> np.ndarray:
    return np.zeros(len(cuda_decode.CHAIN_STATS), np.int64)


def named(stats) -> dict:
    """The stats by their names (cuda_decode.CHAIN_STATS)."""
    return dict(zip(cuda_decode.CHAIN_STATS, stats))


def d1(lib, data: bytes, chunk_bits: int,
       rounds: int = cuda_decode.CHAIN_ROUNDS):
    """D1 on a Huffman stream with ``rounds`` rounds: (equal to the plain
    decode, stats (cuda_decode.CHAIN_STATS), the decoded bytes)."""
    entries, end = huffman.parse_dict_bytes(data)
    table, max_len, min_len = huffman.decode_table(entries)
    cap = cuda_decode.payload_capacity(8 * len(data) - end, min_len)
    buf, nb = buffer(data, 64), np.array([len(data)], np.int64)
    n_chunks = cuda_decode._n_chunks(8 * len(buf) - end, chunk_bits)
    scratch = np.full(lib.ie_chain_scratch_words(n_chunks, chunk_bits, 1),
                      -7, np.int64)
    out, count = np.full(cap, 0xEE, np.uint8), np.zeros(1, np.int64)
    stats = stats_buffer()
    assert lib.ie_huffman_decode(
        ptr(buf), ptr(nb), end, n_chunks, chunk_bits, ptr(table), max_len,
        ptr(out), cap, ptr(count), ptr(scratch), rounds, ptr(stats),
        len(stats), None) == 0
    want = huffman.huffman_decode(data)
    ok = int(count[0]) == len(want) and out[:len(want)].tobytes() == want
    return ok, stats.tolist(), want


def d2(lib, payload: bytes, start: int, n_blocks: int, use_rle: bool,
       block_size: int, chunk_bits: int):
    """D2 on a payload: (equal to the plain walk, stats, records)."""
    buf, nb = buffer(payload, 256), np.array([len(payload)], np.int64)
    n_chunks = cuda_decode._n_chunks(8 * len(buf) - start, chunk_bits)
    scratch = np.full(lib.ie_chain_scratch_words(n_chunks, chunk_bits, 0),
                      -7, np.int64)
    offs = np.full(n_blocks, -1, np.int64)
    dbits, counts = (np.full(n_blocks, -1, np.int32) for _ in range(2))
    end, stats = np.full(1, -1, np.int64), stats_buffer()
    assert lib.ie_walk_video(
        ptr(buf), ptr(nb), start, n_chunks, chunk_bits, n_blocks, 1, 1, 0,
        int(use_rle), block_size, ptr(offs), ptr(dbits), ptr(counts),
        ptr(end), None, None, ptr(scratch), ptr(stats), len(stats),
        None) == 0
    want = image.walk_block_offsets(None, start, n_blocks, use_rle,
                                    block_size, packed=payload)
    ok = (all(np.array_equal(a, b) for a, b in zip((offs, dbits, counts),
                                                   want[:3]))
          and int(end[0]) == want[3])
    return ok, stats.tolist(), want[:3]


def d3(lib, payload: bytes, records, quant: np.ndarray, block_size: int,
       norm: str, h: int, w: int, pred: np.ndarray | None = None,
       step: int = 1, misalign: int = 0) -> np.ndarray | None:
    """D3 on a payload's records (one frame's, or [G * step, N] of which
    every ``step``-th row), with a prediction u8 [G, h, w] or none, into
    every ``step``-th frame of a buffer: its frames if equal to the plain
    block decode, else None.  The payload starts ``misalign`` bytes past
    a 16-byte boundary."""
    room = np.zeros(len(payload) + 64 + 32, np.uint8)
    at = -room.ctypes.data % 16 + misalign
    buf = room[at:at + len(payload) + 64]
    buf[:] = buffer(payload, 64)
    nb = np.array([len(payload)], np.int64)
    offs, dbits, counts = (np.ascontiguousarray(r) for r in records)
    rows = offs.reshape(offs.shape[0] if offs.ndim == 2 else 1,
                        offs.shape[-1])
    n_frames = -(-rows.shape[0] // step)
    wi = np.ascontiguousarray(_inv_weights(block_size, norm))
    zz = zigzag_order(block_size)
    izz = np.empty_like(zz)
    izz[zz] = np.arange(len(zz), dtype=np.int32)
    q = np.ascontiguousarray(quant, np.float64).reshape(-1)
    img = np.full((n_frames * step, h, w), 0x77, np.uint8)
    p = None if pred is None else np.ascontiguousarray(pred)
    assert lib.ie_decode_blocks(
        ptr(buf), ptr(nb), ptr(offs), ptr(dbits), ptr(counts),
        rows.shape[1], n_frames, step * rows.shape[1], ptr(q), ptr(wi),
        ptr(izz), block_size, w, None if p is None else ptr(p), h * w,
        ptr(img), step * h * w, None) == 0
    tr = [torch.from_numpy(r.reshape(rows.shape)[::step])
          for r in (offs, dbits, counts)]
    want = cuda_decode.decode_blocks_plain(
        torch.from_numpy(buf), torch.tensor([len(payload)]), *tr,
        torch.from_numpy(q), block_size, norm, h, w,
        None if p is None else torch.from_numpy(p))
    got = img[::step]
    return got if np.array_equal(got, want.numpy()) else None


def video_case(lib, data: bytes, chunk_bits: int):
    """A video stream decoded by the emulated D1, D2 over the whole video,
    the vector read and D3, K7's plain version between: (equal to
    decode_video(device="cpu"), D2 equal to its plain version, the vector
    read equal to its plain version, D2's stats)."""
    plan = video.plan_video(data, 4)
    params, w, h = plan["params"], plan["w"], plan["h"]
    n, gop, n_micro = params.frame_count, max(1, params.gop), plan["n_blocks"]
    payload = data if not plan["huffman"] else d1(lib, data, 512)[2]
    start, vbits = plan["start"], plan["vbits"]
    buf, nb = buffer(payload, 256), np.array([len(payload)], np.int64)
    n_chunks = cuda_decode._n_chunks(8 * len(buf) - start, chunk_bits)
    scratch = np.full(lib.ie_chain_scratch_words(n_chunks, chunk_bits, 0),
                      -7, np.int64)
    offs = np.full(n * n_micro, -1, np.int64)
    dbits, counts = (np.full(n * n_micro, -1, np.int32) for _ in range(2))
    end, stats = np.full(1, -1, np.int64), stats_buffer()
    vstart, rstart = (np.full(n, -1, np.int64) for _ in range(2))
    assert lib.ie_walk_video(
        ptr(buf), ptr(nb), start, n_chunks, chunk_bits, n_micro, n, gop,
        vbits, int(plan["use_rle"]), 4, ptr(offs), ptr(dbits), ptr(counts),
        ptr(end), ptr(vstart), ptr(rstart), ptr(scratch), ptr(stats),
        len(stats), None) == 0
    t_buf, t_nb = torch.from_numpy(buf), torch.tensor([len(payload)])
    want = cuda_decode.walk_video_plain(t_buf, t_nb, start, n, n_micro, gop,
                                        vbits, plan["use_rle"], 4)
    walk_ok = all(np.array_equal(a, b.numpy()) for a, b in zip(
        (offs, dbits, counts, end, vstart, rstart), want))
    mvec = np.zeros((n, plan["n_macro"], 2), np.int32)
    if vbits:
        assert lib.ie_read_vectors(ptr(buf), ptr(nb), ptr(vstart), n, gop,
                                   2 * plan["n_macro"], plan["mb"],
                                   ptr(mvec), None) == 0
    vec_ok = np.array_equal(mvec, cuda_decode.read_vectors_plain(
        t_buf, t_nb, torch.from_numpy(vstart), gop, plan["n_macro"],
        plan["mb"]).numpy())
    recs = [r.reshape(n, n_micro) for r in (offs, dbits, counts)]
    q = plan["quant"].as_float()
    frames = np.zeros((n, h, w), np.uint8)
    got = d3(lib, payload, recs, q, 4, "reference", h, w, step=gop)
    ok = got is not None
    if ok:
        frames[0::gop] = got
    for k in range(1, min(gop, n) if vbits else 1):
        g_k = len(range(k, n, gop))
        pred = motion.predict_plain(torch.from_numpy(frames[k - 1::gop][:g_k]),
                                    torch.from_numpy(mvec[k::gop])).numpy()
        got = d3(lib, payload, [r[k:] for r in recs], q, 4, "reference", h,
                 w, pred, step=gop)
        ok = ok and got is not None
        if ok:
            frames[k::gop] = got
    yuv = video.assemble_yuv420(frames, w, h)
    return (ok and yuv == decode_video(data, device="cpu")[0], walk_ok,
            vec_ok, stats.tolist())


def records(kind: str, n: int, seed: int, use_rle: bool, k: int):
    """Payload bytes of n block records: "long" (b = 15, count = k: the
    walkers stay out of phase), "random" (b, count any), "corrupt"
    (random, some counts past k)."""
    rng = np.random.default_rng(seed)
    vals, nb = [0], [3]  # 3 lead bits
    for i in range(n):
        b, cnt = (15, k) if kind == "long" else (
            int(rng.integers(0, 16)), int(rng.integers(0, k + 1)))
        if kind == "corrupt" and (1 << b) > k + 1 and i % 7 == 3:
            cnt = int(rng.integers(k + 1, 1 << b))
        cnt = cnt if use_rle else k
        vals += [b] + ([cnt] if use_rle else []) + \
            rng.integers(0, 1 << 15, cnt).tolist()
        nb += [4] + ([b] if use_rle else []) + [b] * cnt
    return bitpack.pack_fields(vals, nb)[0]


def main() -> int:
    failed = 0

    def report(label: str, ok: bool, stats=None) -> None:
        nonlocal failed
        failed += not ok
        extra = ""
        if stats is not None:
            st = named(stats)
            extra = (f" ({st['chunks']} chunks, {st['walked_whole']} walked "
                     f"whole, {st['rounds_changed']} rounds changed a "
                     f"chunk, breaks left {st['breaks_left']}, the sweep "
                     f"fixed {st['sweep_breaks']} breaks, took "
                     f"{st['jumps']} jumps)")
        print(f"{'ok  ' if ok else 'FAIL'} {label}{extra}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        lib = build(pathlib.Path(tmp))
        y, x = np.mgrid[0:96, 0:128].astype(np.float64)
        rng = np.random.default_rng(0)
        img = np.clip(128 + 60 * np.sin(x / 9) * np.cos(y / 7)
                      + rng.normal(0, 6, x.shape), 0, 255).astype(np.uint8)
        jpeg = np.array([[16, 11, 10, 16], [12, 12, 14, 19],
                         [14, 13, 16, 24], [14, 17, 22, 29]])
        for b, norm in ((4, "reference"), (8, "ortho")):
            q = jpeg if b == 4 else 1 + 2 * np.add.outer(range(8), range(8))
            for use_rle in (True, False):
                data = encode_image(img, QuantMatrix(q), use_rle, True, norm,
                                    b, device="cpu")
                plan = image.parse_stream(data, b)
                for chunk in (32, 1024):
                    ok, stats, payload = d1(lib, data, chunk)
                    report(f"D1 {b}x{b} rle={use_rle} chunks of {chunk}",
                           ok, stats)
                for chunk in (32, 2048):
                    ok, stats, recs = d2(lib, payload, plan["start"],
                                         plan["n_blocks"], use_rle, b, chunk)
                    report(f"D2 {b}x{b} rle={use_rle} chunks of {chunk}",
                           ok, stats)
                report(f"D3 {b}x{b} {norm} rle={use_rle}",
                       d3(lib, payload, recs, q, b, norm, 96, 128)
                       is not None)
        # D1: breaks that more than one round settles (an 8x8 stream at
        # chunks of 32 bits: no table); the same with no round (the table),
        # and 3-bit codes at chunks of 32 bits, where no walker meets the
        # codeword grid and every chunk is walked whole from its true
        # entry: the rounds leave breaks, and the table settles them.
        data = encode_image(img, QuantMatrix(1 + 2 * np.add.outer(
            range(8), range(8))), True, True, "ortho", 8, device="cpu")
        for rounds in (cuda_decode.CHAIN_ROUNDS, 0):
            ok, stats, _ = d1(lib, data, 32, rounds)
            st = named(stats)
            report(f"D1 8x8, chunks of 32, {rounds} rounds", ok and
                   st["breaks_left"] == (rounds == 0) and
                   (st["rounds_changed"] > 1 or not rounds), stats)
        inner = bytes(np.repeat(np.arange(8, dtype=np.uint8) * 17, 50)[
            rng.permutation(400)])  # every code 3 bits long
        ok, stats, _ = d1(lib, huffman.huffman_encode(inner, "cpu"), 32)
        st = named(stats)
        report("D1 3-bit codes, chunks of 32", ok and st["walked_whole"] > 0
               and st["breaks_left"] == 1, stats)
        # D2's sweep: the breaks the check leaves (8x8 records without RLE
        # at chunks of 2048 bits; "long" records at chunks of 32 bits,
        # which keep walkers out of phase for many chunks).
        data = encode_image(img, QuantMatrix(1 + 2 * np.add.outer(
            range(8), range(8))), False, True, "ortho", 8, device="cpu")
        plan = image.parse_stream(data, 8)
        payload = huffman.huffman_decode(data)
        ok, stats, _ = d2(lib, payload, plan["start"], plan["n_blocks"],
                          False, 8, 2048)
        report("D2 8x8 rle=False, chunks of 2048", ok and named(stats)[
            "sweep_breaks"] > 0, stats)
        for kind, use_rle in (("long", True), ("long", False),
                              ("random", True), ("corrupt", True)):
            payload = records(kind, 200, 1, use_rle, 16)
            ok, stats, recs = d2(lib, payload, 3, 232, use_rle, 4, 32)
            if kind == "long":  # breaks over many chunks in a row
                ok = ok and named(stats)["sweep_breaks"] > 0
            report(f"D2 {kind} records rle={use_rle}, chunks of 32", ok,
                   stats)
            report(f"D3 {kind} records, a third cut off", d3(
                lib, payload[:2 * len(payload) // 3], recs, jpeg, 4,
                "reference", 32, 116) is not None)
        # Videos: 64x48 frames of 192 records (about 1,000-3,000 bits a
        # frame), so chunks of 32 and 256 bits put a boundary in nearly
        # every chunk, and 96-bit P-frame vector blocks at merange 1.
        rng = np.random.default_rng(2)
        base = np.kron(rng.integers(0, 256, (6, 8)), np.ones((8, 8)))
        yuv = b"".join(np.clip(np.roll(base, (2 * f, 3 * f), (0, 1))
                               + rng.normal(0, 3, base.shape), 0, 255)
                       .astype(np.uint8).tobytes() + bytes(1536)
                       for f in range(9))
        for gop, merange, use_rle, huff, mode, cut in (
                (4, 16, True, True, "raw", False),
                (5, 1, True, False, "recon", False),
                (1, 8, False, True, "raw", False),
                (4, 1, False, False, "raw", False),
                (3, 16, True, False, "raw", True)):
            data = encode_video(yuv, 64, 48, QuantMatrix(jpeg), use_rle, gop,
                                merange, use_huffman=huff, ref_mode=mode,
                                device="cpu")
            if cut:  # the last frames' records read zeros
                data = data[:2 * len(data) // 3]
            for chunk in (32, 256, 2048):
                ok, walk_ok, vec_ok, stats = video_case(lib, data, chunk)
                label = (f"video gop {gop} merange {merange} rle={use_rle} "
                         f"huffman={huff}{' cut' if cut else ''}, chunks of "
                         f"{chunk}")
                report(f"D2 {label}", walk_ok, stats)
                report(f"vectors {label}", vec_ok)
                report(f"D3 frames {label}", ok)
    print("all equal" if not failed else f"{failed} mismatches")
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main())
