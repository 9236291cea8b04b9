#!/usr/bin/env python3
"""K2's two designs and where its time goes, on a GPU.

    python3 tools/k2_variants.py [--reps N] [--batch | --parent DIR]

K2 (imageencoder_tpu_torch/csrc/pack.cu, pack_locals) is reduce, then
pack: tile_sums_kernel sums each tile's record lengths, and in
pack_known_kernel every CTA adds up the sums before its own, composes its
tile's words in shared memory and stores them, reading on past its last
record for the bits its last word lacks.  K4 pack_coeffs runs on the same
two kernels with its own front end (CoeffsFront: the lengths K5 and the
recon step wrote, then each block's coefficients).  This script derives
from pack.cu, at run time into a temporary directory, the other design
and variants of the kept one:

  lookback     design (a): the same front end (LocalsFront) under K4's
               single-pass packer pack_tiles (decoupled look-back over a
               persistent grid, the tiles' shared words merged at the end),
               4 records a thread, the records emitted by the same code.
               Its entry point and kernel are added to pack.cu as text; it
               needs K4's zeroed scratch;
  items4,      the pack takes 4 or 1 records a thread instead of 2 (tiles
  items1       of 1024 or 256 records instead of 512);
  no_emit      records are not emitted (the words stay zero);
  no_reach     no tile reads past its last record (the words tiles share
               lack the later tile's bits);
  ctas6,       the pack is compiled for 6 or 8 resident CTAs an SM (fewer
  ctas8        registers a thread) instead of what its registers allow;
  all_atomic   K2 writes every word of a record into the tile's words by
               a shared-memory atomicOr, its interior words too, as
               pack_coeffs does;
  two_words    a record's words past its first two, the ones read as it is
               emitted, are taken as zero;
  coeffs_items1,
  coeffs_items4  pack_coeffs takes 1 or 4 4x4 blocks a thread instead of 2;
  lengths_last   pack_coeffs's launch 2 takes each length from the block's
               stats, its scan waiting for the block, and its reach past
               the tile loads every record it looks at;

builds K2 and each with nvcc (one process each, in parallel), and times
each on the inputs K2 gets on the main paths, captured from real calls
(the 4096x912 image's register files; the 720p25 raw video's, with its
vectors), and pack_coeffs on the 720p25 recon video's coefficients,
vectors and lengths (all but the lookback design, which is K2's alone),
in turns: the kernels' device time a call and the whole device
time a call (the scratch's memset included) from torch.profiler.  The
lookback design's stream is held equal to K2's; no_emit's, no_reach's and
two_words' outputs are wrong by design, and only their times are read.
Prints one line per input and one JSON line last.

``--batch`` reads K2 over a batch instead, on the kept sources alone: the
register files of chip_smoke.py's serving batch (16 4096x912 images,
captured from a real encode_image_batch call) packed through
pack_locals_batch and pack_locals_hist_batch at the batch's row stride
(the worst-case packed_words_bound) and at the segments' (each row the
words of the longest stream, rounded to 16 bytes, as the sharded encode
sizes its rows from the totals), with and without the header prefix, and
through pack_segments (a start bit a stream, all the batch's own) at
both strides; each reading's two launches apart and together, in turns
(forward, then backward), and every reading's totals held equal.

``--parent DIR`` reads K2 on the image's and the raw video's register
files, alone and with the histogram (pack_locals, pack_locals_hist), in
four builds: the kept pack.cu, the one of the tree at DIR (another
commit, unpacked by ``git archive``; its own headers), and two variants
of the kept one that undo, each, one change to the code K2 shares with
K4 pack_payload:

  tiles_from_grid  a CTA takes its stream's tiles from the grid (n_tiles)
                   again and none leaves early, in both launches;
  byte_checks      the histogram's count checks each byte's place against
                   the stream's end (64-bit compares) before its atomic,
                   as the parent's count did, not the word's once;

in turns (kept, parent, variants, variants, parent, kept): the kernels'
device time a call from torch.profiler, each stream and histogram held
equal to the kept build's.
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

ITEMS = "int locals_items(int lw) { return lw <= 8 ? 2 : 1; }"
REACH = "    if (tid < 32 && nspan > 0 && need > 0) {"
KERNEL_AT = "// Records a thread of K2's pack takes:"
LOOKBACK_KERNEL = """\
// K2's front end in K4's protocol: the same emission, through the
// emitter's sink (the emitter itself stays empty, so its finish() adds
// nothing).
struct LocalsFrontEm : LocalsFront<true> {
    template <class E>
    __device__ __forceinline__ void emit(const State& st, E& em) const {
        emit_words(st, em.nacc, em.sink);
    }
};

__global__ void __launch_bounds__(kTile) pack_locals_lookback_kernel(
        LocalsFrontEm fe, PackOut a) {
    pack_tiles<4>(fe, a);
}

"""
LOOKBACK_ENTRY = """
extern "C" int ie_pack_locals_lookback(
        const void* local, const void* lens, long long n_blocks, int lw,
        const void* mvecs, long long n_frames, long long n_macro, int gop,
        int mvec_nbits, long long start_bit, const void* prefix,
        long long prefix_words, void* out, long long n_words, void* scratch,
        void* edges, void* total, void* stream) {
    LocalsFrontEm fe;
    long long n = 0;
    if (!locals_front(local, lens, n_blocks, lw, mvecs, n_frames, n_macro,
                      gop, mvec_nbits, &fe, &n))
        return (int)cudaErrorInvalidValue;
    const PackOut a = pack_out(n, start_bit, prefix, prefix_words, out,
                               n_words, scratch, edges, total);
    return launch_pack(pack_locals_lookback_kernel, 4, a, 32ll * lw,
                       (cudaStream_t)stream, fe);
}
"""
VARIANTS = {  # name: [(old, new), ...] in pack.cu; None appends the entry
    "lookback": [(KERNEL_AT, LOOKBACK_KERNEL + KERNEL_AT),
                 (None, LOOKBACK_ENTRY)],
    "items4": [(ITEMS, ITEMS.replace("? 2 :", "? 4 :")),
               ("return items == 2 ? launch_known<2>(fe, a, s)",
                "return items == 4 ? launch_known<4>(fe, a, s)"),
               ("return items == 2 ? launch_known<2>(blocks, a, s)",
                "return items == 4 ? launch_known<4>(blocks, a, s)")],
    "items1": [(ITEMS, ITEMS.replace("? 2 :", "? 1 :"))],
    "no_emit": [("            emit_owned(fe, rec[r], lens[r], rs, w0, span, nspan);",
                 "            ;")],
    "no_reach": [(REACH, REACH.replace("tid < 32", "tid < 0"))],
    "all_atomic": [("    static constexpr bool kAllAtomic = false;  // see "
                    "OwnedSink",
                    "    static constexpr bool kAllAtomic = true;")],
    **{f"ctas{n}": [("__launch_bounds__(kTile) pack_known_kernel(",
                     f"__launch_bounds__(kTile, {n}) pack_known_kernel(")]
       for n in (6, 8)},
    "two_words": [(": k == 1 ? st.w1 : __ldg(st.row + k);",
                   ": k == 1 ? st.w1 : 0u;")],
    "lengths_last": [("    static constexpr bool kLengthsFirst = true;",
                      "    static constexpr bool kLengthsFirst = false;")],
    **{f"coeffs_items{n}": [("constexpr int kCoeffsItems4 = 2;",
                             f"constexpr int kCoeffsItems4 = {n};")]
       for n in (1, 4)},
}
SYMBOLS = ("tile_sums_kernel", "pack_known_kernel",
           "pack_locals_lookback_kernel")
# --parent's variants of the kept pack.cu.
SHARED = {
    "tiles_from_grid": [
        ("    const long long tiles = a.tiles(ITEMS);\n"
         "    if (t >= tiles) return;\n",
         "    const long long tiles = a.n_tiles;\n"),
        ("        if ((long long)blockIdx.x * kWarps >= a.tiles(ITEMS)) "
         "return;\n", "")],
    "byte_checks": [("        if (j < live) atomicAdd(",
                     "        if (b0 + j < end) atomicAdd(")],
}


def build_all(tmp: pathlib.Path, variants: dict = VARIANTS,
              parent: pathlib.Path | None = None) -> dict:
    """{name: shared library path} for K2 ("k2"), each of ``variants`` and,
    where given, the pack.cu of the tree at ``parent`` ("parent")."""
    from imageencoder_tpu_torch.kernels import build

    cmds, libs = [], {}
    names = ("k2", *variants) + (("parent",) if parent else ())
    for name in names:
        csrc = (parent / "imageencoder_tpu_torch" / "csrc"
                if name == "parent" else build.CSRC)
        d = tmp / name
        d.mkdir()
        for src in csrc.glob("*.cuh"):
            (d / src.name).write_text(src.read_text())
        text = (csrc / "pack.cu").read_text()
        for old, new in variants.get(name, []):
            if old is None:
                text += new
                continue
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        (d / "pack.cu").write_text(text)
        libs[name] = d / "lib.so"
        cmds.append([build.nvcc_path(), *build.COMPILE_FLAGS, "-shared",
                     "-o", str(libs[name]), str(d / "pack.cu")])
    build._run_all(cmds)
    return libs


def load(path: pathlib.Path, lookback: bool) -> ctypes.CDLL:
    from imageencoder_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    sigs = {name: build.SIGNATURES[name]
            for name in ("ie_pack_tile", "ie_pack_locals",
                         "ie_pack_locals_scratch", "ie_pack_coeffs",
                         "ie_pack_coeffs_scratch")}
    if lookback:  # K2's arguments up to the total, then K4's tail
        sigs["ie_pack_locals_lookback"] = (
            build.SIGNATURES["ie_pack_locals"][:9] + build._K4_TAIL)
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.ie_error_string.argtypes = [ctypes.c_int]
    lib.ie_error_string.restype = ctypes.c_char_p
    return lib


def pack_locals_lookback(local, lens, start_bit, n_words, prefix=None,
                         mvecs=None, n_frames=1, gop=1, mvec_nbits=0):
    """pack_locals through the lookback design's entry point, with the
    library that has it loaded (build._LIB): K4's allocation and call."""
    from imageencoder_tpu_torch.ops import cuda_pack

    n, lw = local.shape
    n_macro = 0 if mvecs is None else mvecs.shape[1]
    return cuda_pack._k4(
        "ie_pack_locals_lookback", n + n_frames * n_macro, n_words,
        local.device, (local.data_ptr(), lens.data_ptr(), n, lw,
                       mvecs.data_ptr() if n_macro else None, n_frames,
                       n_macro, gop, mvec_nbits, start_bit,
                       *cuda_pack._prefix(prefix, local.device)))


def batch_main(reps: int) -> None:
    """``--batch``: K2 over the serving batch, by stride, prefix, start
    bits and histogram (see the module's docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.ops import cuda_pack
    from imageencoder_tpu_torch.utils.device import gpu_identity

    dev = torch.device("cuda", 0)
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    batch = torch.from_numpy(cs.serving_batch()).to(dev)
    with cs.captured_calls() as calls:
        port.encode_image_batch(batch, quant, device="cuda")
    (local, lens, start_bit, n_words, prefix), _ = \
        calls["K2 pack_locals+hist batch"][0]
    b = local.shape[0]
    _, totals = cuda_pack.pack_locals_batch(local, lens, start_bit, n_words,
                                            prefix)
    tight = -(-int(((totals + 31) // 32).max()) // 4) * 4
    starts = torch.full((b,), start_bit, dtype=torch.int64, device=dev)
    readings = {
        "batch": lambda: cuda_pack.pack_locals_batch(
            local, lens, start_bit, n_words, prefix),
        "batch+hist": lambda: cuda_pack.pack_locals_hist_batch(
            local, lens, start_bit, n_words, prefix),
        "batch, segments' stride": lambda: cuda_pack.pack_locals_batch(
            local, lens, start_bit, tight, prefix),
        "batch+hist, segments' stride": lambda:
            cuda_pack.pack_locals_hist_batch(local, lens, start_bit, tight,
                                             prefix),
        "batch, segments' stride, no prefix": lambda:
            cuda_pack.pack_locals_batch(local, lens, start_bit, tight),
        "segments": lambda: cuda_pack.pack_segments(local, lens, starts,
                                                    tight),
        "segments, batch's stride": lambda: cuda_pack.pack_segments(
            local, lens, starts, n_words),
    }
    for label, fn in readings.items():
        if not torch.equal(fn()[1], totals):
            raise AssertionError(f"{label}: totals differ from the batch's")
    parts = {"both": SYMBOLS[:2], "launch 1": SYMBOLS[0],
             "launch 2": SYMBOLS[1]}
    times = {label: {part: [] for part in parts} for label in readings}
    for turn in range(2):
        for label in (list(readings) if turn == 0 else list(readings)[::-1]):
            for part, sym in parts.items():
                times[label][part].append(
                    cs.profiled_ms(readings[label], sym, reps) * 1e3)
    res = {label: {part: sum(t) / len(t) for part, t in by.items()}
           for label, by in times.items()}
    for label, r in res.items():
        print(f"{label}: {r['both']:.2f} us (launch 1 {r['launch 1']:.2f}, "
              f"launch 2 {r['launch 2']:.2f})", flush=True)
    print(json.dumps({"gpu": gpu_identity(), "reps": reps, "streams": b,
                      "records": lens.shape[1], "lw": local.shape[2],
                      "start_bit": start_bit, "n_words": n_words,
                      "tight_words": tight, "totals": totals.tolist(),
                      "readings": res, "turns": times}))


def parent_main(reps: int, parent: pathlib.Path) -> None:
    """``--parent DIR``: K2 alone and with the histogram, kept against the
    parent's pack.cu and the variants that undo one shared change each
    (see the module's docstring)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.ops import cuda_pack
    from imageencoder_tpu_torch.utils.device import gpu_identity

    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    h, w = cs.SHAPES[0]
    vw, vh, vn = cs.VIDEO
    frames = cs.yuv420(cs.video_frames(vw, vh, vn, 0))
    inputs = {}
    for label, drive in (
            ("image", lambda: port.encode_image(
                cs.synthetic(h, w, 2), quant, use_huffman=True,
                device="cuda")),
            ("video raw", lambda: port.encode_video(
                frames, vw, vh, quant, True, cs.GOP, cs.MERANGE,
                use_huffman=True, ref_mode="raw", device="cuda"))):
        with cs.captured_calls() as calls:
            drive()
        captured = calls["K2 pack_locals+hist"][0]
        inputs[label] = (cuda_pack.pack_locals, captured)
        inputs[label + "+hist"] = (cuda_pack.pack_locals_hist, captured)

    out = {"gpu": gpu_identity(), "reps": reps, "parent": str(parent),
           "inputs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load(p, False) for name, p in build_all(
            pathlib.Path(tmp), SHARED, parent).items()}
        saved = build.library()
        names = ["k2", "parent", *SHARED]
        try:
            for label, (packer, (args, kwargs)) in inputs.items():
                call = lambda: packer(*args, **kwargs)  # noqa: E731
                build._LIB = libs["k2"]
                want = call()
                for name in names[1:]:
                    build._LIB = libs[name]
                    got = call()
                    if not all(torch.equal(g, x) for g, x in zip(
                            (cuda_pack.stream_words(*got[:2]), *got[1:]),
                            (cuda_pack.stream_words(*want[:2]),
                             *want[1:]))):
                        raise AssertionError(f"{label}: {name}'s stream "
                                             f"differs from the kept one's")
                times = {name: [] for name in names}
                for turn in range(2):  # kept, parent, variants, and back
                    for name in (names if turn == 0 else names[::-1]):
                        build._LIB = libs[name]
                        times[name].append(
                            cs.profiled_ms(call, SYMBOLS[:2], reps) * 1e3)
                res = {name: {"us": sum(t) / len(t), "turns": t}
                       for name, t in times.items()}
                base = res["k2"]["us"]
                print(f"{label}: K2 {base:.2f} us; " + "; ".join(
                    f"{name} {r['us']:.2f} us ({r['us'] - base:+.2f})"
                    for name, r in res.items() if name != "k2"),
                      flush=True)
                out["inputs"][label] = res
        finally:
            build._LIB = saved
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--batch", action="store_true")
    mode.add_argument("--parent", type=pathlib.Path, default=None)
    opts = ap.parse_args()
    reps = opts.reps
    if opts.batch or opts.parent:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("k2_variants: no CUDA device")
        if opts.batch:
            batch_main(reps)
        else:
            parent_main(reps, opts.parent.resolve())
        return

    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.ops import cuda_pack
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: no CUDA device")
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    h, w = cs.SHAPES[0]
    vw, vh, vn = cs.VIDEO
    frames = cs.yuv420(cs.video_frames(vw, vh, vn, 0))
    inputs = {}
    for label, drive in (
            ("image", lambda: port.encode_image(
                cs.synthetic(h, w, 2), quant, use_huffman=True,
                device="cuda")),
            ("video raw", lambda: port.encode_video(
                frames, vw, vh, quant, True, cs.GOP, cs.MERANGE,
                use_huffman=True, ref_mode="raw", device="cuda"))):
        with cs.captured_calls() as calls:
            drive()
        # The main paths count the histogram too; K2 alone on its inputs.
        inputs[label] = (cuda_pack.pack_locals,
                         calls["K2 pack_locals+hist"][0])
    with cs.captured_calls() as calls:
        port.encode_video(frames, vw, vh, quant, True, cs.GOP, cs.MERANGE,
                          use_huffman=True, ref_mode="recon", device="cuda")
    inputs["video recon"] = (cuda_pack.pack_coeffs,
                             calls["K4 pack_coeffs+hist"][0])

    out = {"gpu": gpu_identity(), "reps": reps, "inputs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load(p, name == "lookback")
                for name, p in build_all(pathlib.Path(tmp)).items()}
        saved = build.library()
        try:
            for label, (packer, (args, kwargs)) in inputs.items():
                names = list(libs)
                if packer is cuda_pack.pack_locals:
                    want = cuda_pack.stream_words(*packer(*args, **kwargs))
                    build._LIB = libs["lookback"]
                    got = cuda_pack.stream_words(
                        *pack_locals_lookback(*args, **kwargs))
                    if not torch.equal(got, want):
                        raise AssertionError(f"{label}: the lookback "
                                             f"design's stream differs from "
                                             f"K2's")
                else:
                    names.remove("lookback")
                times = {name: [] for name in names}
                for turn in range(2):  # K2, variants, variants, K2
                    for name in (names if turn == 0 else names[::-1]):
                        build._LIB = libs[name]
                        fn = (pack_locals_lookback if name == "lookback"
                              else packer)
                        call = lambda fn=fn: fn(*args, **kwargs)  # noqa: E731
                        times[name].append(
                            (cs.profiled_ms(call, SYMBOLS, reps) * 1e3,
                             cs.profiled_ms(call, None, reps) * 1e3))
                res = {name: {"us": sum(k for k, _ in t) / len(t),
                              "stage_us": sum(s for _, s in t) / len(t),
                              "turns": t} for name, t in times.items()}
                base = res["k2"]["us"]
                print(f"{label}: K2 {base:.2f} us (kernels, profiler; all "
                      f"its device work {res['k2']['stage_us']:.2f} us); "
                      + "; ".join(f"{name} {r['us']:.2f} us "
                                  f"({r['us'] - base:+.2f}; all "
                                  f"{r['stage_us']:.2f})"
                                  for name, r in res.items()
                                  if name != "k2"), flush=True)
                out["inputs"][label] = res
        finally:
            build._LIB = saved
    print(json.dumps(out))


if __name__ == "__main__":
    main()
