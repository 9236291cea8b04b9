#!/usr/bin/env python3
"""What each of K1's four design points is worth, on a GPU.

    python3 tools/k1_variants.py [--reps N]

K1 (imageencoder_tpu_torch/csrc/encode.cu) divides through a reciprocal,
converts each sample once, loads a row as one vector and stores its
register files through shared memory.  This script derives from that
source, at run time into a temporary directory, one variant per point
that goes back to the older form of that point alone:

  division     __ddiv_rn for every coefficient (no reciprocal table);
  conversion   each sample converted, then 128 subtracted in f64;
  loads        the samples read one at a time (and converted as in
               "conversion": the scalar loader of K5);
  stores       each thread stores its register file straight to global
               memory, lw words apart;

builds K1 and each variant with nvcc (one process each, in parallel),
checks that every variant's output equals K1's, and times all of them on
chip_smoke.py's inputs (the 4096x912 u8 image, and the 720p25 raw video's
int16 residual stack under its quant), in turns, with CUDA events.  Prints
one line per input and one JSON line last.
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

VARIANTS = {  # name: (text in encode.cu or transform.cuh, replacement)
    "division": ("encode.cu",
                 "q,\n                            tab.vec[2]);", "q);"),
    "conversion": ("transform.cuh", "x[r * B + c] = __int2double_rn(s - 128);",
                   "x[r * B + c] = __dsub_rn((double)s, 128.0);"),
    "loads": ("encode.cu", "ie::load_block_vec<B>(", "ie::load_block<B>("),
    "stores": ("encode.cu", "uint32_t* row = stage + threadIdx.x * lw;",
               "uint32_t* row = out_words + n * lw;"),
}
STORES_OFF = ("const int words = (int)(rows * lw);", "const int words = 0;")


def build_all(tmp: pathlib.Path) -> dict:
    """{name: shared library path} for K1 ("k1") and each variant."""
    from imageencoder_tpu_torch.kernels import build

    csrc = build.CSRC
    cmds, libs = [], {}
    for name in ("k1", *VARIANTS):
        d = tmp / name
        d.mkdir()
        for src in csrc.glob("*.cuh"):
            (d / src.name).write_text(src.read_text())
        (d / "encode.cu").write_text((csrc / "encode.cu").read_text())
        if name != "k1":
            fname, old, new = VARIANTS[name]
            text = (d / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
            if name == "stores":
                text = text.replace(*STORES_OFF)
            (d / fname).write_text(text)
        libs[name] = d / "lib.so"
        cmds.append([build.nvcc_path(), *build.COMPILE_FLAGS, "-shared",
                     "-o", str(libs[name]), str(d / "encode.cu")])
    build._run_all(cmds)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    reps = ap.parse_args().reps

    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.ops import cuda_encode
    from imageencoder_tpu_torch.ops.video_pipeline import (
        make_encode_video_packed)
    from imageencoder_tpu_torch.models.video import mvec_bits
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32)).as_float()

    # The inputs K1 gets on the main paths, captured from real calls.
    h, w = cs.SHAPES[0]
    inputs = {"u8 4096x912": torch.from_numpy(cs.synthetic(h, w, 2)).to(dev)}
    seen = []
    real = cuda_encode.encode_locals

    def stand_in(x, *a, **k):
        seen.append(x)
        return real(x, *a, **k)

    stand_in.launches = 0  # the wrapper counts on the name it is bound to
    cuda_encode.encode_locals = stand_in
    vw, vh, vn = cs.VIDEO
    frames = torch.from_numpy(cs.video_frames(vw, vh, vn, 0)).to(dev)
    make_encode_video_packed(cs.GOP, cs.MERANGE, mvec_bits(cs.MERANGE))(
        frames, quant, 0, None)
    cuda_encode.encode_locals = real
    inputs["int16 18000x1280"] = seen[0]

    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, path in build_all(pathlib.Path(tmp)).items():
            lib = ctypes.CDLL(str(path))
            lib.ie_encode_locals.argtypes = build.SIGNATURES[
                "ie_encode_locals"]
            lib.ie_encode_locals.restype = ctypes.c_int
            libs[name] = lib

        out = {"gpu": gpu_identity(), "reps": reps, "inputs": {}}
        for label, img in inputs.items():
            hh, ww = img.shape
            lw = cuda_encode.record_words(img.dtype, 4, "reference")
            wz, scale_z = cuda_encode._device_tables(4, "reference", dev,
                                                     True)
            qz = cuda_encode._quant_vec(quant, 4, dev, True)
            rz = cuda_encode._quant_vec(cuda_encode.reciprocals(quant), 4,
                                        dev, True)
            n = (hh // 4) * (ww // 4)
            results = {}

            def run(lib):
                words = torch.empty((n, lw), dtype=torch.int32, device=dev)
                lens = torch.empty(n, dtype=torch.int32, device=dev)
                err = torch.zeros(1, dtype=torch.int32, device=dev)
                launch(lib, words, lens, err)
                return words, lens, err

            def launch(lib, words, lens, err):
                code = lib.ie_encode_locals(
                    img.data_ptr(), cuda_encode.INPUT_DTYPES[img.dtype], hh,
                    ww, 4, wz.data_ptr(), scale_z.data_ptr(), qz.data_ptr(),
                    rz.data_ptr(), 1, lw, words.data_ptr(), lens.data_ptr(),
                    err.data_ptr(), build.stream_ptr(dev))
                build.check(code, "ie_encode_locals")

            want = run(libs["k1"])
            for name, lib in libs.items():
                got = run(lib)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{label}: variant {name} differs "
                                         f"from K1")
            bufs = run(libs["k1"])  # outputs reused by the timed launches
            times = {name: [] for name in libs}
            for turn in range(2):  # K1, variants, variants, K1
                order = list(libs) if turn == 0 else list(libs)[::-1]
                for name in order:
                    times[name].append(cs.cuda_ms(
                        lambda: launch(libs[name], *bufs), reps) * 1e3)
            for name, t in times.items():
                results[name] = {"us": sum(t) / len(t), "turns": t}
            base = results["k1"]["us"]
            print(f"{label}: K1 {base:.2f} us; " + "; ".join(
                f"without {name} {r['us']:.2f} us (+{r['us'] - base:.2f})"
                for name, r in results.items() if name != "k1"), flush=True)
            out["inputs"][label] = results
    print(json.dumps(out))


if __name__ == "__main__":
    main()
