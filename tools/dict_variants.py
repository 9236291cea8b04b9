#!/usr/bin/env python3
"""The Huffman dict kernel's time on a GPU, by CUDA events, against
variants of its design, the floor of a one-CTA launch, and a parent's.

    python3 tools/dict_variants.py [--reps N] [--parent DIR]

Builds csrc/huffman.cu and, by text substitution into a temporary
directory, variants of its design:

  serial     every merge serial in lane 0 (the rounds' gain alone);
  rounds     the merge in rounds for 32 leaves or fewer too, where the
             kernel merges serially (the serial switch's gain on chains);
  jumps9     nine pointer-jumping rounds, whatever the rounds the merge
             took (the bound on the tree's depth);
  limit_scan the 15-bit limit scanning for the depth to split at every
             step, as _limit_lengths is written (the kept one scans only
             where that depth can have moved);
  no_merge   no merge: every node a child of the root (its table is
             wrong): the rest of the kernel;

the floor, a kernel of one 256-thread CTA a stream that reads its
histogram and total and writes its table's words and nothing else (what
a launch of the dict kernel's shape and I/O costs at the least); and with
``--parent DIR`` the huffman.cu of the tree at DIR (a ``git archive`` of
another commit).  Each runs through the C entry points the wrappers call
(ie_huffman_dict, ie_huffman_dict_batch), one nvcc each, in parallel.

The histograms: captured from real calls on the card (the dict's inputs
in encode_image of chip_smoke.py's 4096x912 image, encode_video of its
720p25 video with the raw and the recon reference, encode_image of its
128x256 noise image under quant all ones, which takes the fallback, and
the serving batch's 16 streams, one ie_huffman_dict_batch launch), and
built: 30 Fibonacci counts and 31 powers of two (chains: trees as deep
as their bytes, merged serially, through the 15-bit limit), and 256
geometric counts up to 2^30 (34 rounds, then the limit).  Each design's
table is held against the kept one's (serial, rounds, jumps9,
limit_scan and the parent must equal it), then
each is timed in turns (parent, kept, variants, variants reversed, kept,
parent): CUDA-event milliseconds per launch of N launches queued behind
a spin kernel (chip_smoke.py::queued_ms), so the card's time, not the
host's launch rate.  Beside each histogram, the rounds the merge takes
(a model of the kernel's round rule; the serial steps for 32 leaves or
fewer), at a window of 64 and of 32.  Prints one line per histogram
and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys
import tempfile

sys.modules["jax"] = None
sys.modules["imageencoder_tpu"] = None
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ENTRIES = ("ie_huffman_dict", "ie_huffman_dict_batch", "ie_dict_table_words")
SERIAL_MAX = "constexpr int kSerialMax = 32;"
LIMIT_STEP = """            if (j < ln - 2) {
                j++;
            } else if (lim[j] == 0) {
                while (j > 0 && lim[j] == 0) j--;
            }
"""
JUMPS = "    const int jumps = 32 - __clz(s_rounds);"
MERGE = """        if (n <= kSerialMax) {
            if (lane == 0) merge_serial(leaf, inode, up, n);
        } else {
            rounds = merge_rounds(leaf, inode, up, n, lane);
        }"""
STAR = """        for (int i = lane; i < root; i += 32) up[i] = root;
        rounds = 1;"""
VARIANTS = {  # name: [(old, new), ...]
    "serial": [(SERIAL_MAX, SERIAL_MAX.replace("32", "256"))],
    "rounds": [(SERIAL_MAX, SERIAL_MAX.replace("32", "1"))],
    "jumps9": [(JUMPS, "    const int jumps = 9 + 0 * s_rounds;")],
    "limit_scan": [(LIMIT_STEP, """            j = ln - 2;
            while (j > 0 && lim[j] == 0) j--;
""")],
    "no_merge": [(MERGE, STAR)],
}
EXACT = ("parent", "serial", "rounds", "jumps9", "limit_scan")
FLOOR = r"""
#include <cstdint>

#include <cuda_runtime.h>

#include "dict_table.cuh"

namespace {

__global__ void __launch_bounds__(256) dict_floor_kernel(
        const int32_t* __restrict__ hist,
        const long long* __restrict__ total_bits, int32_t* __restrict__ table) {
    hist += (long long)blockIdx.x * 256;
    table += (long long)blockIdx.x * ie::kTableWords;
    const int s = threadIdx.x;
    const int f = hist[s];
    const long long t = total_bits[blockIdx.x];
    table[ie::kTableCodeW + s] = f;
    table[ie::kTableCodeL + s] = f >> 8;
    table[ie::kTableDict + s] = f ^ (int)t;
    if (s < 2 * ie::kMetaFields) table[ie::kTableMeta + s] = (int)(t >> s);
}

}  // namespace

extern "C" int ie_dict_table_words() { return ie::kTableWords; }

extern "C" int ie_huffman_dict_batch(const void* hist, const void* total_bits,
                                     void* table, long long n_streams,
                                     void* stream) {
    dict_floor_kernel<<<(unsigned)n_streams, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)hist, (const long long*)total_bits, (int32_t*)table);
    return (int)cudaGetLastError();
}

extern "C" int ie_huffman_dict(const void* hist, const void* total_bits,
                               void* table, void* stream) {
    return ie_huffman_dict_batch(hist, total_bits, table, 1, stream);
}
"""


def rounds_of(freqs, window: int = 64) -> int:
    """The rounds of the kernel's merge on a histogram (its round rule,
    csrc/huffman.cu: the ``window`` smallest live keys, k = c // 2 nodes a
    round), or its serial steps where it merges serially."""
    syms = [s for s in range(256) if freqs[s] > 0]
    n = len(syms)
    if n <= 32:
        return max(n - 1, 0)
    leaf = sorted((int(freqs[s]) << 17) | (s << 9) | i
                  for i, s in enumerate(syms))

    def key(a, b, node):
        tie = min((a >> 9) & 0xFF, (b >> 9) & 0xFF)
        return (((a >> 17) + (b >> 17)) << 17) | (tie << 9) | node

    made, li, ih, rounds = [], 0, 0, 0
    while len(made) < n - 1:
        x = sorted(leaf[li:li + window] + made[ih:ih + window])[:window]
        node = n + len(made)
        n1 = key(x[0], x[1], node)
        k = max(1, sum(v < n1 for v in x) // 2)
        made += [key(x[2 * j], x[2 * j + 1], node + j) for j in range(k)]
        leaves = sum((v & 0x1FF) < n for v in x[:2 * k])
        li, ih, rounds = li + leaves, ih + 2 * k - leaves, rounds + 1
    return rounds


def built_histograms() -> dict:
    """The chains and the geometric counts, int64 [256] each."""
    import numpy as np

    out = {}
    for name, n in (("fibonacci", 30), ("pow2", 31)):
        f = np.zeros(256, np.int64)
        a, b = 1, 1
        for i in range(n):
            f[(3 + 7 * i) % 256] = 1 << i if name == "pow2" else a
            a, b = b, a + b
        out[f"{name} ({n} bytes)"] = f
    rng = np.random.default_rng(5)
    out["geometric30 (256 bytes)"] = np.floor(
        2.0 ** rng.uniform(0, 30, 256)).astype(np.int64)
    return out


def build_all(tmp: pathlib.Path, parent: pathlib.Path | None) -> dict:
    """{name: shared library path}: "kept", each variant, "floor" and,
    with a parent tree, "parent"."""
    from imageencoder_tpu_torch.kernels import build

    csrc = build.CSRC
    jobs = {"kept": (csrc, [])}
    jobs.update({name: (csrc, subs) for name, subs in VARIANTS.items()})
    if parent is not None:
        jobs["parent"] = (parent / "imageencoder_tpu_torch" / "csrc", [])
    cmds, libs = [], {}
    for name, (src_dir, subs) in [*jobs.items(), ("floor", (csrc, None))]:
        d = tmp / name
        d.mkdir()
        for header in src_dir.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        text = FLOOR if subs is None else (src_dir / "huffman.cu").read_text()
        for old, new in subs or ():
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        (d / "huffman.cu").write_text(text)
        libs[name] = d / "lib.so"
        cmds.append([build.nvcc_path(), *build.COMPILE_FLAGS, "-shared",
                     "-o", str(libs[name]), str(d / "huffman.cu")])
    logs = build._run_all(cmds)
    for name, log in zip(libs, logs):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return libs


def load(path: pathlib.Path) -> ctypes.CDLL:
    from imageencoder_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        getattr(lib, name).argtypes = build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def dict_call(lib, hists, totals, table) -> None:
    """One launch through ``lib``: one stream where ``hists`` is [256],
    else a CTA a stream."""
    from imageencoder_tpu_torch.kernels import build

    dev = hists.device
    if hists.dim() == 1:
        code = lib.ie_huffman_dict(hists.data_ptr(), totals.data_ptr(),
                                   table.data_ptr(), build.stream_ptr(dev))
    else:
        code = lib.ie_huffman_dict_batch(
            hists.data_ptr(), totals.data_ptr(), table.data_ptr(),
            hists.shape[0], build.stream_ptr(dev))
    build.check(code, "ie_huffman_dict")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    opts = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.ops import dict_table
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("dict_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    h, w = cs.SHAPES[0]
    vw, vh, vn = cs.VIDEO
    frames = cs.yuv420(cs.video_frames(vw, vh, vn, 0))
    noise = np.random.default_rng(9).integers(0, 256, (128, 256),
                                              dtype=np.uint8)
    ones = port.QuantMatrix(np.ones((4, 4), dtype=np.uint32))
    inputs = {}  # label: (hist, totals), one stream's or a batch's
    for label, drive in (
            ("image 4096x912", lambda: port.encode_image(
                cs.synthetic(h, w, 2), quant, use_huffman=True,
                device="cuda")),
            ("video raw", lambda: port.encode_video(
                frames, vw, vh, quant, True, cs.GOP, cs.MERANGE,
                use_huffman=True, ref_mode="raw", device="cuda")),
            ("video recon", lambda: port.encode_video(
                frames, vw, vh, quant, True, cs.GOP, cs.MERANGE,
                use_huffman=True, ref_mode="recon", device="cuda")),
            ("noise 128x256 (fallback)", lambda: port.encode_image(
                noise, ones, use_huffman=True, device="cuda"))):
        with cs.captured_calls() as calls:
            drive()
        hist, total = calls["Huffman dict"][0][0]
        inputs[label] = (hist.clone(), total.reshape(1).to(torch.int64))
    batch = torch.from_numpy(cs.serving_batch()).to(dev)
    with cs.captured_calls() as calls:
        port.encode_image_batch(batch, quant, device="cuda")
    hists, totals = calls["Huffman dict batch"][0][0]
    inputs["serving batch (16 streams)"] = (hists.clone(),
                                            totals.to(torch.int64))
    del batch, calls
    for label, f in built_histograms().items():
        inputs[label] = (torch.from_numpy(f.astype(np.int32)).to(dev),
                         torch.tensor([8 * int(f.sum())], device=dev))

    out = {"gpu": gpu_identity(), "reps": opts.reps, "inputs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load(p) for name, p in build_all(
            pathlib.Path(tmp), opts.parent).items()}
        names = [n for n in ("parent", "kept") if n in libs] + [
            n for n in libs if n not in ("parent", "kept")]
        for label, (hist, total) in inputs.items():
            b = hist.shape[0] if hist.dim() == 2 else 1
            tables = {name: torch.empty((b, dict_table.TABLE_WORDS),
                                        dtype=torch.int32, device=dev)
                      for name in names}
            for name in names:
                dict_call(libs[name], hist, total, tables[name])
            torch.cuda.synchronize()
            for name in EXACT:
                if name in libs and not torch.equal(tables[name],
                                                    tables["kept"]):
                    raise AssertionError(f"{label}: {name}'s table differs "
                                         f"from the kept design's")
            times = {name: [] for name in names}
            for order in (names, names[::-1]):
                for name in order:
                    times[name].append(cs.queued_ms(
                        lambda: dict_call(libs[name], hist, total,
                                          tables[name]), opts.reps) * 1e3)
            host = hist.cpu().numpy().reshape(b, 256)
            rounds = [rounds_of(f) for f in host]
            rounds32 = [rounds_of(f, 32) for f in host]
            res = {name: {"us": sum(t) / len(t), "turns": t}
                   for name, t in times.items()}
            out["inputs"][label] = {"rounds": rounds, "rounds32": rounds32,
                                    "us": res}
            base = res["kept"]["us"]
            print(f"{label}: rounds {min(rounds)}-{max(rounds)} (at a "
                  f"window of 32: {min(rounds32)}-{max(rounds32)}); kept "
                  f"{base:.2f} us; " + "; ".join(
                      f"{name} {r['us']:.2f} ({r['us'] - base:+.2f})"
                      for name, r in res.items() if name != "kept"),
                  flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
