#!/usr/bin/env python3
"""Run the Huffman dict kernel on the host, with no card and no nvcc.

    python tools/emulate_dict.py

Compiles csrc/huffman.cu with g++ against tools/emulate_decode.py's
emulation of CUDA (each CUDA thread of a block a fiber on one OS thread,
run in turn; barriers, ballots, shuffles and warp reductions yield until
every thread has arrived), widened here to the intrinsics the dict kernel
uses (__match_any_sync, __clz, the shared-memory atomics).  Then it holds
ie_huffman_dict_batch, a CTA a stream, against the plain version
(ops/huffman.py::build_dict_batch_plain) word for word on one ragged
batch: every histogram kind of tests/test_torch_huffman.py (the
geometric kind's counts clipped to what an int32 histogram holds), its
random histograms, histograms of few distinct counts (the round rule's
pairs, no length limit to hide them), a refused stream (total -1), one
byte value, two, all 256 equal, power-of-two and Fibonacci chains (the serial merge and the
15-bit limit), and the byte histogram of a seeded 256x128 image's inner
stream written by the port on the CPU; and ie_huffman_dict, one stream,
on the image's histogram.  The output buffers start dirty.

It finds compile errors and logic faults before a chip call; it says
nothing of speed, of nvcc's own rules, or of races (its threads run in
turn).  Exit status 1 on a mismatch.
"""

from __future__ import annotations

import ctypes
import importlib.util
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from imageencoder_tpu_torch import QuantMatrix, encode_image  # noqa: E402
from imageencoder_tpu_torch.kernels.build import SIGNATURES  # noqa: E402
from imageencoder_tpu_torch.ops import dict_table, huffman  # noqa: E402

CSRC = REPO / "imageencoder_tpu_torch" / "csrc"
ENTRY = ("ie_huffman_dict", "ie_huffman_dict_batch", "ie_dict_table_words")
INT32_MAX = 2 ** 31 - 1

# What huffman.cu needs beyond the decode kernels' emulation.
EXTRA = r"""
inline unsigned long long min(unsigned long long a, unsigned long long b) {
    return a < b ? a : b;
}
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
inline unsigned __match_any_sync(unsigned, int v) {
    const int t = threadIdx.x, w = t / 32;
    __syncwarp();
    g_emu->slot[t] = (unsigned long long)(long long)v;
    __syncwarp();
    unsigned r = 0;
    for (int l = 0; l < 32; l++)
        if (g_emu->slot[w * 32 + l] == (unsigned long long)(long long)v)
            r |= 1u << l;
    __syncwarp();
    return r;
}
"""


def load_decode_emulation():
    spec = importlib.util.spec_from_file_location(
        "emulate_decode", REPO / "tools" / "emulate_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(tmp: pathlib.Path) -> ctypes.CDLL:
    """huffman.cu, launches rewritten, compiled into a library."""
    emu = load_decode_emulation()
    (tmp / "cuda_runtime.h").write_text(emu.SHIM + EXTRA)
    for src in [*CSRC.glob("*.cuh"), CSRC / "huffman.cu"]:
        text = emu.LAUNCH.sub(lambda m: f"emu_launch({m.group(2)}, [&]{{ "
                                        f"{m.group(1)}({m.group(3)}); }});",
                              src.read_text())
        (tmp / src.name).write_text(text)
    lib = tmp / "libemu_dict.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    f"-I{tmp}", "-x", "c++", str(tmp / "huffman.cu"), "-o",
                    str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ENTRY:
        getattr(dll, name).argtypes = SIGNATURES[name]
        getattr(dll, name).restype = ctypes.c_int
    return dll


def ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def load_histograms():
    """tests/test_torch_huffman.py's histogram kinds and random ones."""
    spec = importlib.util.spec_from_file_location(
        "torch_huffman_kinds", REPO / "tests" / "test_torch_huffman.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chain(kind: str, n: int) -> np.ndarray:
    """n bytes whose counts make a tree as deep as they are: powers of
    two or Fibonacci numbers, at spread-out byte values."""
    f = np.zeros(256, np.int64)
    a, b = 1, 1
    for i, s in enumerate(range(3, 3 + 7 * n, 7)):
        f[s % 256] = 1 << i if kind == "pow2" else a
        a, b = b, a + b
    return f


def image_histogram() -> tuple[np.ndarray, int]:
    """The byte histogram and bit length of a seeded 256x128 image's
    inner stream (Huffman off), written by the port on the CPU."""
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:128, 0:256].astype(np.float64)
    img = np.clip(128 + 50 * np.sin(x / 11) * np.cos(y / 5)
                  + rng.normal(0, 5, x.shape), 0, 255).astype(np.uint8)
    q = QuantMatrix(np.array([[16, 11, 10, 16], [12, 12, 14, 19],
                              [14, 13, 16, 24], [14, 17, 22, 29]]))
    inner = encode_image(img, q, True, False, device="cpu")
    return (np.bincount(np.frombuffer(inner, np.uint8), minlength=256)
            .astype(np.int64), 8 * len(inner))


def batch_cases() -> dict:
    """{label: (histogram int64 [256], total bits)}: the ragged batch."""
    kinds = load_histograms()
    cases = {}
    for kind, seed in kinds.KINDS:
        f = np.minimum(kinds.histogram(kind, seed), INT32_MAX)
        cases[f"{kind} {seed}"] = (f, 8 * int(f.sum()))
    for seed in range(12):
        f = kinds.random_histogram(seed)
        cases[f"random {seed}"] = (f, 8 * int(f.sum()))
    for seed in range(16):  # few distinct counts, no length limit
        rng = np.random.default_rng(100 + seed)
        m = int(rng.integers(40, 200))
        f = np.zeros(256, np.int64)
        f[rng.permutation(256)[:m]] = rng.integers(1, int(rng.integers(2, 9)),
                                                   m)
        cases[f"small counts {seed}"] = (f, 8 * int(f.sum()))
    f = np.repeat(np.array([1, 2, 0], np.int64), [40, 40, 176])
    cases["40 ones, 40 twos"] = (f, 8 * int(f.sum()))
    f = kinds.histogram("ties", 0)
    cases["refused"] = (f, -1)
    cases["one byte value"] = (np.eye(256, dtype=np.int64)[200] * 9, 72)
    cases["two byte values"] = (kinds.histogram("two", 7), 8 * (10 ** 9 + 1))
    cases["all 256 equal"] = (np.full(256, 3, np.int64), 8 * 768)
    for kind in ("pow2", "fibonacci"):
        for n in (31, 33):  # the serial merge, then the rounds
            f = chain(kind, n)
            if f.max() <= INT32_MAX:
                cases[f"{kind} chain of {n}"] = (f, 8 * int(f.sum()))
    cases["256x128 image"] = image_histogram()
    return cases


def dict_batch(lib, hists: np.ndarray, totals: np.ndarray) -> np.ndarray:
    """ie_huffman_dict_batch, emulated: tables [B, TABLE_WORDS]."""
    h = np.ascontiguousarray(hists, np.int32)
    t = np.ascontiguousarray(totals, np.int64)
    out = np.full((len(h), dict_table.TABLE_WORDS), -0x5A5A5A5B, np.int32)
    assert lib.ie_huffman_dict_batch(ptr(h), ptr(t), ptr(out), len(h),
                                     None) == 0
    return out


def dict_one(lib, hist: np.ndarray, total: int) -> np.ndarray:
    """ie_huffman_dict, emulated: one table."""
    h = np.ascontiguousarray(hist, np.int32)
    t = np.array([total], np.int64)
    out = np.full(dict_table.TABLE_WORDS, -0x5A5A5A5B, np.int32)
    assert lib.ie_huffman_dict(ptr(h), ptr(t), ptr(out), None) == 0
    return out


def check(lib, report) -> None:
    """Run the batch and the single stream; report(label, ok) for each
    stream and each entry point."""
    cases = batch_cases()
    hists = np.stack([f for f, _ in cases.values()])
    totals = np.array([t for _, t in cases.values()], np.int64)
    got = dict_batch(lib, hists, totals)
    want = huffman.build_dict_batch_plain(
        torch.from_numpy(hists), torch.from_numpy(totals)).numpy()
    for (label, _), g, w in zip(cases.items(), got, want):
        fields = dict_table.fields(torch.from_numpy(g))
        report(f"batch: {label} (fallback {fields['fallback']}, error "
               f"{fields['error']}, max length "
               f"{int(g[dict_table.CODE_L:dict_table.CODE_L + 256].max())})",
               np.array_equal(g, w))
    f, total = cases["256x128 image"]
    report("one stream: 256x128 image", np.array_equal(
        dict_one(lib, f, total), huffman.build_dict_plain(
            torch.from_numpy(f), torch.tensor(total)).numpy()))


def main() -> int:
    failed = 0

    def report(label: str, ok: bool) -> None:
        nonlocal failed
        failed += not ok
        print(f"{'ok  ' if ok else 'FAIL'} {label}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        check(build(pathlib.Path(tmp)), report)
    print("all equal" if not failed else f"{failed} mismatches")
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main())
