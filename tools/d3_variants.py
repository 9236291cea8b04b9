#!/usr/bin/env python3
"""D3, the block decode (csrc/decode.cu), on a GPU by CUDA events, against
variants of its design and a parent's.

    python3 tools/d3_variants.py [--reps N] [--parent DIR]

Builds csrc/decode.cu and, by text substitution into a temporary
directory, variants of its design, each of which must decode the same
pixels:

  global_reads  no staging: every field read from device memory, four
                bounded byte loads, as before the span was staged (the
                frame still the grid's y);
  threads64     CTAs of 64 threads at 4x4 and 8x8;
  threads128    CTAs of 128 threads at 4x4 and 8x8;
  threads256    CTAs of 256 threads at 4x4 and 8x8 (the kept design: 128
                at 4x4, 256 at 8x8);

and with ``--parent DIR`` the decode.cu of the tree at DIR (a ``git
archive`` of another commit), one nvcc each, in parallel, printing each
build's ptxas registers and spills.  The inputs are D3's calls captured
from real decodes on the card: decode_image of chip_smoke.py's 4096x912
Huffman stream, decode_frames of its 720p25 raw stream (the I-frames'
launch and the first P-frame launch, frame 1 of every GOP onto its
prediction), and decode_image of its 4096x912 noise image in 8x8 blocks
under quant all ones without RLE.  Each design runs through the wrapper
(ops/cuda_decode.py::decode_blocks) with the library swapped, its pixels
held against the kept design's, then each is timed in turns (parent,
kept, variants, variants reversed, kept, parent): CUDA-event
milliseconds per launch of N launches queued behind a spin kernel
(chip_smoke.py::queued_ms).  Prints one line per input and one JSON
line last.
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

THREADS = "constexpr int kDecodeThreads = B == 4 ? 128 : 256;"
VARIANTS = {  # name: [(old, new), ...]
    "global_reads": [("    if (__all_sync(kAll, fits)) {",
                      "    if (false && __all_sync(kAll, fits)) {")],
    **{f"threads{t}": [(THREADS, THREADS.replace("128 : 256",
                                                  f"{t} : {t}"))]
       for t in (64, 128, 256)},
}


def build_all(tmp: pathlib.Path, parent: pathlib.Path | None) -> dict:
    """{name: shared library path}: "kept", each variant and, with a
    parent tree, "parent"; prints each build's ptxas lines for D3."""
    from imageencoder_tpu_torch.kernels import build

    csrc = build.CSRC
    jobs = {"kept": (csrc, [])}
    jobs.update({name: (csrc, subs) for name, subs in VARIANTS.items()})
    if parent is not None:
        jobs["parent"] = (parent / "imageencoder_tpu_torch" / "csrc", [])
    cmds, libs = [], {}
    for name, (src_dir, subs) in jobs.items():
        d = tmp / name
        d.mkdir()
        for header in src_dir.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        text = (src_dir / "decode.cu").read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        (d / "decode.cu").write_text(text)
        libs[name] = d / "lib.so"
        cmds.append([build.nvcc_path(), *build.COMPILE_FLAGS, "-shared",
                     "-o", str(libs[name]), str(d / "decode.cu")])
    for name, log in zip(libs, build._run_all(cmds)):
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                kernel = line.split("decode_blocks_kernel")[-1][:10]
            elif "Used" in line or "spill" in line:
                print(f"  {name} {kernel}: {line.strip()}")
    return libs


def load(path: pathlib.Path) -> ctypes.CDLL:
    from imageencoder_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    lib.ie_decode_blocks.argtypes = build.SIGNATURES["ie_decode_blocks"]
    lib.ie_decode_blocks.restype = ctypes.c_int
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    opts = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.ops import cuda_decode
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("d3_variants: no CUDA device")
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    h, w = cs.SHAPES[0]
    vw, vh, vn = cs.VIDEO
    image = port.encode_image(cs.synthetic(h, w, 2), quant,
                              use_huffman=True, device="cuda")
    video = port.encode_video(cs.yuv420(cs.video_frames(vw, vh, vn, 0)),
                              vw, vh, quant, True, cs.GOP, cs.MERANGE,
                              use_huffman=True, ref_mode="raw",
                              device="cuda")
    noise = np.random.default_rng(12).integers(0, 256, (h, w),
                                               dtype=np.uint8)
    noise8 = port.encode_image(noise, port.QuantMatrix(np.ones(
        (8, 8), dtype=np.uint32)), use_rle=False, use_huffman=False,
        block_size=8, device="cuda")
    inputs = {}  # label: (args, kwargs) of a decode_blocks call
    with cs.captured_calls() as calls:
        port.decode_image(image, device="cuda")
    inputs["image 4096x912"] = calls["D3 decode_blocks"][0]
    with cs.captured_calls() as calls:
        port.decode_frames(video, device="cuda")
    inputs["720p25 I-frames"] = calls["D3 decode_blocks"][0]
    inputs["720p25 P-frames, one launch"] = calls["D3 decode_blocks"][1]
    with cs.captured_calls() as calls:
        port.decode_image(noise8, block_size=8, device="cuda")
    inputs["noise 4096x912, 8x8, quant ones"] = calls["D3 decode_blocks"][0]
    del calls

    out = {"gpu": gpu_identity(), "reps": opts.reps, "inputs": {}}
    saved = build.library()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            libs = {name: load(p) for name, p in build_all(
                pathlib.Path(tmp), opts.parent).items()}
            names = [n for n in ("parent", "kept") if n in libs] + [
                n for n in libs if n not in ("parent", "kept")]
            for label, (args, kwargs) in inputs.items():
                kw = {k: v for k, v in kwargs.items() if k != "out"}
                outs = {}
                for name in names:
                    build._LIB = libs[name]
                    outs[name] = cuda_decode.decode_blocks(*args, **kw)
                torch.cuda.synchronize()
                for name in names:
                    if not torch.equal(outs[name], outs["kept"]):
                        raise AssertionError(f"{label}: {name}'s pixels "
                                             f"differ from the kept "
                                             f"design's")
                times = {name: [] for name in names}
                for order in (names, names[::-1]):
                    for name in order:
                        build._LIB = libs[name]
                        times[name].append(cs.queued_ms(
                            lambda: cuda_decode.decode_blocks(*args, **kw),
                            opts.reps) * 1e3)
                res = {name: {"us": sum(t) / len(t), "turns": t}
                       for name, t in times.items()}
                out["inputs"][label] = res
                base = res["kept"]["us"]
                print(f"{label}: kept {base:.2f} us; " + "; ".join(
                    f"{name} {r['us']:.2f} ({r['us'] - base:+.2f})"
                    for name, r in res.items() if name != "kept"),
                    flush=True)
    finally:
        build._LIB = saved
    print(json.dumps(out))


if __name__ == "__main__":
    main()
