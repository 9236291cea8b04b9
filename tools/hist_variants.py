#!/usr/bin/env python3
"""Where the byte histogram folded into K2 and K4 pack_coeffs spends its
time, on a GPU.

    python3 tools/hist_variants.py [--reps N]

K2 (pack_locals_hist) and K4 pack_coeffs (pack_coeffs_hist), both on
pack_known_kernel, count the bytes of every word they store into per-warp
bins in shared memory, and
each CTA adds its nonzero bins to the global histogram by atomicAdd.  This
script derives from pack.cu, at run time into a temporary directory,
variants of the kept design:

  no_count   the packers count no byte: no shared-memory atomics, and so
             no bin to add to the global histogram;
  no_flush   they count into shared memory and add nothing to the global
             histogram;
  copies16   each CTA adds its bins to one of 16 copies of the global bins
             (CTA number mod 16), so a sixteenth of the CTAs meet on each
             address;
  bins_x2,   each warp counts into 2 or 4 sets of bins (by lane mod 2 or 4),
  bins_x4    so fewer lanes of one atomic instruction meet on one bin;
  byte_checks  each byte's place against the stream's end is checked
             before its atomic (64-bit compares), not the word's once;

builds the kept libraries and each variant with nvcc (one process each, in
parallel), and times each on the inputs the main paths give the kernels,
captured from real calls (the 4096x912 image's and the 720p25 raw video's
register files for K2; the 720p25 recon video's coefficients for K4; the
serving batch's 16 4096x912 register files for K2 over a batch,
ie_pack_locals_batch with a histogram a stream), in turns (kept,
variants, variants, kept): the kernels' device time a call from
torch.profiler.  The variants' outputs are wrong by design, but for
byte_checks, which must equal the kept design's; only their times are
read.  The dict kernel's variants are tools/dict_variants.py's.
Prints one line per input and one JSON line last.
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

COPIES = 16
COUNT = "        if (j < live) atomicAdd(bins + ((w >> (24 - 8 * j)) & 0xFFu), 1);"
FLUSH = "        if (c) atomicAdd(hist + k, c);"
MY_BINS = "    int* my_bins = bins + (kHist ? warp * 256 : 0);"
def more_bins(k: int) -> list:
    """Substitutions giving each warp k sets of bins, by lane mod k."""
    return [("__shared__ int bins[kHist ? kWarps * 256 : 1];",
             f"__shared__ int bins[kHist ? {k} * kWarps * 256 : 1];"),
            (MY_BINS, MY_BINS.replace(
                "warp * 256", f"(warp * {k} + (tid % {k})) * 256")),
            ("zero_bins<kWarps>(bins)", f"zero_bins<{k} * kWarps>(bins)"),
            ("flush_bins<kWarps>(bins, a.hist)",
             f"flush_bins<{k} * kWarps>(bins, a.hist)")]


VARIANTS = {  # name: (source, [(old, new[, times]), ...])
    "no_count": ("pack.cu", [(COUNT, "        ;")]),
    "no_flush": ("pack.cu", [(FLUSH, "        if (c == -1) hist[k] = c;")]),
    "copies16": ("pack.cu", [(FLUSH, f"        if (c) atomicAdd(hist + 256 * "
                              f"(blockIdx.x % {COPIES}) + k, c);")]),
    "bins_x2": ("pack.cu", more_bins(2)),
    "bins_x4": ("pack.cu", more_bins(4)),
    "byte_checks": ("pack.cu", [(COUNT, COUNT.replace("j < live",
                                                      "b0 + j < end"))]),
}
# Their outputs must equal the kept design's.
EXACT = ("byte_checks",)
ENTRIES = {"pack.cu": ("ie_pack_locals", "ie_pack_locals_batch",
                       "ie_pack_locals_scratch", "ie_pack_coeffs",
                       "ie_pack_coeffs_scratch")}


def build_all(tmp: pathlib.Path) -> dict:
    """{name: shared library path}: "pack.cu" for the kept source,
    then each variant of it."""
    from imageencoder_tpu_torch.kernels import build

    csrc = build.CSRC
    cmds, libs = [], {}
    jobs = [(src, src, []) for src in ENTRIES] + [
        (name, src, subs) for name, (src, subs) in VARIANTS.items()]
    for name, src, subs in jobs:
        d = tmp / name
        d.mkdir()
        for header in csrc.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        text = (csrc / src).read_text()
        for old, new, *times in subs:
            want = times[0] if times else 1
            if text.count(old) != want:
                raise RuntimeError(f"variant {name}: {old!r} not found "
                                   f"{want} times")
            text = text.replace(old, new)
        (d / src).write_text(text)
        libs[name] = d / "lib.so"
        cmds.append([build.nvcc_path(), *build.COMPILE_FLAGS, "-shared",
                     "-o", str(libs[name]), str(d / src)])
    build._run_all(cmds)
    return libs


def load(path: pathlib.Path, src: str) -> ctypes.CDLL:
    from imageencoder_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    for name in ENTRIES[src]:
        getattr(lib, name).argtypes = build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    if src == "pack.cu":  # the error strings live in pack.cu
        lib.ie_error_string.argtypes = [ctypes.c_int]
        lib.ie_error_string.restype = ctypes.c_char_p
    return lib


def pack_locals_hist(lib, bins, local, lens, start_bit, n_words, prefix=None,
                     mvecs=None, n_frames=1, gop=1, mvec_nbits=0):
    """K2 with its histogram through ``lib``, the bins in ``bins`` (room
    for the copies); the wrapper's allocations and call."""
    import torch

    from imageencoder_tpu_torch.kernels import build

    dev = local.device
    n, lw = local.shape
    n_macro = 0 if mvecs is None else mvecs.shape[1]
    sums = torch.empty(lib.ie_pack_locals_scratch(n + n_frames * n_macro, lw),
                       dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    code = lib.ie_pack_locals(
        local.data_ptr(), lens.data_ptr(), n, lw,
        mvecs.data_ptr() if n_macro else None, n_frames, n_macro, gop,
        mvec_nbits, start_bit, None if prefix is None else prefix.data_ptr(),
        0 if prefix is None else prefix.shape[0], out.data_ptr(), n_words,
        sums.data_ptr(), total.data_ptr(), bins.data_ptr(),
        build.stream_ptr(dev))
    build.check(code, "ie_pack_locals")
    return out, total


def pack_locals_hist_batch(lib, bins, local, lens, start_bit, n_words,
                           prefix=None):
    """K2 with its histograms over a batch through ``lib``, stream k's
    bins at ``bins[256 * k:]`` (room for the copies past the last); the
    wrapper's allocations and call."""
    import torch

    from imageencoder_tpu_torch.kernels import build

    dev = local.device
    b, n, lw = local.shape
    sums = torch.empty(b * lib.ie_pack_locals_scratch(n, lw),
                       dtype=torch.int64, device=dev)
    total = torch.empty(b, dtype=torch.int64, device=dev)
    out = torch.empty((b, n_words), dtype=torch.int32, device=dev)
    code = lib.ie_pack_locals_batch(
        local.data_ptr(), lens.data_ptr(), n, lw, b, start_bit, None,
        None if prefix is None else prefix.data_ptr(),
        0 if prefix is None else prefix.shape[0], out.data_ptr(), n_words,
        sums.data_ptr(), total.data_ptr(), bins.data_ptr(),
        build.stream_ptr(dev))
    build.check(code, "ie_pack_locals_batch")
    return out, total


def pack_coeffs_hist(lib, bins, coeffs, mvecs, gop, mvec_nbits, b, use_rle,
                     lw, start_bit, n_words, prefix=None, lens=None):
    """K4 pack_coeffs with its histogram through ``lib``, the bins in
    ``bins`` (room for the copies); the wrapper's allocations and call."""
    import torch

    from imageencoder_tpu_torch.kernels import build

    dev = coeffs.device
    f, h, w = coeffs.shape
    n_macro = mvecs.shape[1]
    records = f * (n_macro + (h // b) * (w // b))
    sums = torch.empty(lib.ie_pack_coeffs_scratch(records, b),
                       dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    code = lib.ie_pack_coeffs(
        coeffs.data_ptr(), f, h, w, b,
        None if lens is None else lens.data_ptr(), mvecs.data_ptr(), n_macro,
        gop, mvec_nbits, int(use_rle), lw, start_bit,
        None if prefix is None else prefix.data_ptr(),
        0 if prefix is None else prefix.shape[0], out.data_ptr(), n_words,
        sums.data_ptr(), total.data_ptr(), bins.data_ptr(),
        build.stream_ptr(dev))
    build.check(code, "ie_pack_coeffs")
    return out, total


def exact_view(result) -> list:
    """What a variant that must not change the result is held to: a
    pack's totals and bins (the words past a stream are left as
    allocated, and differ from call to call)."""
    return [x.clone() for x in result[1:]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    reps = ap.parse_args().reps

    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("hist_variants: no CUDA device")
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    h, w = cs.SHAPES[0]
    vw, vh, vn = cs.VIDEO
    frames = cs.yuv420(cs.video_frames(vw, vh, vn, 0))
    captured = {}
    for label, drive in (
            ("image", lambda: port.encode_image(
                cs.synthetic(h, w, 2), quant, use_huffman=True,
                device="cuda")),
            ("video raw", lambda: port.encode_video(
                frames, vw, vh, quant, True, cs.GOP, cs.MERANGE,
                use_huffman=True, ref_mode="raw", device="cuda")),
            ("video recon", lambda: port.encode_video(
                frames, vw, vh, quant, True, cs.GOP, cs.MERANGE,
                use_huffman=True, ref_mode="recon", device="cuda"))):
        with cs.captured_calls() as calls:
            drive()
        captured[label] = calls
    dev = torch.device("cuda", 0)
    bins = torch.zeros(COPIES * 256, dtype=torch.int32, device=dev)
    inputs = {  # label: (libraries timed, kernel symbols, call(lib))
        f"K2+hist {label}": (
            ("pack.cu", "no_count", "no_flush", "copies16", "bins_x2",
             "bins_x4", "byte_checks"),
            ("tile_sums_kernel", "pack_known_kernel"),
            lambda lib, a=captured[label]["K2 pack_locals+hist"][0]:
            (*pack_locals_hist(lib, bins, *a[0], **a[1]), bins[:256]))
        for label in ("image", "video raw")}
    coeffs_args = captured["video recon"]["K4 pack_coeffs+hist"][0]
    inputs["K4 pack_coeffs+hist video recon"] = (
        ("pack.cu", "no_count", "no_flush", "copies16", "bins_x2", "bins_x4",
         "byte_checks"),
        ("tile_sums_kernel", "pack_known_kernel"),
        lambda lib: (*pack_coeffs_hist(lib, bins, *coeffs_args[0],
                                       **coeffs_args[1]), bins[:256]))
    batch = torch.from_numpy(cs.serving_batch()).cuda()
    with cs.captured_calls() as calls:
        port.encode_image_batch(batch, quant, device="cuda")
    batch_args = calls["K2 pack_locals+hist batch"][0]
    batch_bins = torch.zeros((batch.shape[0] + COPIES) * 256,
                             dtype=torch.int32, device=batch.device)
    inputs["K2+hist batch"] = (
        ("pack.cu", "no_count", "no_flush", "copies16", "bins_x2",
         "byte_checks"),
        ("tile_sums_kernel", "pack_known_kernel"),
        lambda lib: (*pack_locals_hist_batch(lib, batch_bins, *batch_args[0],
                                             **batch_args[1]),
                     batch_bins[:batch.shape[0] * 256]))
    out = {"gpu": gpu_identity(), "reps": reps, "inputs": {}}
    saved_lib = build.library()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths = build_all(pathlib.Path(tmp))
            libs = {name: load(p, VARIANTS[name][0] if name in VARIANTS
                               else name) for name, p in paths.items()}
            for label, (names, symbols, call) in inputs.items():
                for name in EXACT:
                    if name in names:
                        build._LIB = libs[names[0]]
                        want = exact_view(call(libs[names[0]]))
                        build._LIB = libs[name]
                        got = exact_view(call(libs[name]))
                        if not all(map(torch.equal, got, want)):
                            raise AssertionError(f"{label}: {name} differs "
                                                 f"from the kept design")
                times = {name: [] for name in names}
                for turn in range(2):  # kept, variants, variants, kept
                    for name in (names if turn == 0 else names[::-1]):
                        build._LIB = libs[name]
                        times[name].append(cs.profiled_ms(
                            lambda: call(libs[name]), symbols, reps) * 1e3)
                res = {name: {"us": sum(t) / len(t), "turns": t}
                       for name, t in times.items()}
                base = res[names[0]]["us"]
                print(f"{label}: kept {base:.2f} us (kernels, profiler); "
                      + "; ".join(f"{name} {r['us']:.2f} us "
                                  f"({r['us'] - base:+.2f})"
                                  for name, r in res.items()
                                  if name != names[0]), flush=True)
                out["inputs"][label] = res
    finally:
        build._LIB = saved_lib
    print(json.dumps(out))


if __name__ == "__main__":
    main()
