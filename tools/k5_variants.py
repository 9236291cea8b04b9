#!/usr/bin/env python3
"""K5 and the recon step in other grid shapes, on a GPU.

    python3 tools/k5_variants.py [--reps N]

K5 (imageencoder_tpu_torch/csrc/transform.cu: quantize_image_kernel) and
the recon step (recon_step_kernel) fill their tables into shared memory
once a CTA and loop over blocks, on a grid of at most 4 CTAs a CTA slot
of the card (kSlots).  This script derives from transform.cu, at run time
into a temporary directory, variants that change that shape:

  slots1, slots2   1 or 2 CTAs a resident slot: fewer, longer CTAs;
  fence            a __threadfence_block() at the top of each loop turn in
                   place of keep_loads_in_loop() (an instruction, not only
                   a compiler barrier);
  block_a_thread   a grid that covers every block, one block a thread and
                   no loop (the kernels' shape before they took frames);
  threads64,
  threads256       64 or 256 threads a CTA, the grid as the card holds;

builds the kernels and each variant with nvcc (one process each, in
parallel; each variant's registers and spills are printed), and times
each on the inputs the recon path gives the two kernels, captured from a
real 720p25 recon encode_video (gop 4: K5 over the 7 I-frames, the recon
step over frame k of every GOP), in turns (kernels, variants, variants,
kernels): the kernel's device time a call from torch.profiler.  Every
variant computes the same output, which is checked against the kernel's.
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

SLOTS = "constexpr int kSlots = 4;"
THREADS = "constexpr int kThreads = 128;"
KEEP = "ie::keep_loads_in_loop();"
VARIANTS = {  # name: [(old, new), ...] in transform.cu
    "fence": [(KEEP, "__threadfence_block();")],
    "slots1": [(SLOTS, "constexpr int kSlots = 1;")],
    "slots2": [(SLOTS, "constexpr int kSlots = 2;")],
    "block_a_thread": [(SLOTS, "constexpr int kSlots = 1 << 20;")],
    "threads64": [(THREADS, "constexpr int kThreads = 64;")],
    "threads256": [(THREADS, "constexpr int kThreads = 256;")],
}
ENTRIES = ("ie_quantize_image", "ie_recon_step")


def build_all(tmp: pathlib.Path) -> dict:
    """{name: shared library path} for the kernels ("k5") and each
    variant; prints each one's registers and spills."""
    from imageencoder_tpu_torch.kernels import build

    csrc = build.CSRC
    cmds, libs = [], {}
    for name in ("k5", *VARIANTS):
        d = tmp / name
        d.mkdir()
        for src in csrc.glob("*.cuh"):
            (d / src.name).write_text(src.read_text())
        text = (csrc / "transform.cu").read_text()
        for old, new in VARIANTS.get(name, []):
            if text.count(old) != (2 if old == KEEP else 1):
                raise RuntimeError(f"variant {name}: {old!r} not found as "
                                   f"often as expected")
            text = text.replace(old, new)
        (d / "transform.cu").write_text(text)
        libs[name] = d / "lib.so"
        cmds.append([build.nvcc_path(), *build.COMPILE_FLAGS, "-shared",
                     "-o", str(libs[name]), str(d / "transform.cu")])
    for name, log in zip(libs, build._run_all(cmds)):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
    return libs


def load(path: pathlib.Path) -> ctypes.CDLL:
    from imageencoder_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        getattr(lib, name).argtypes = build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    reps = ap.parse_args().reps

    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.ops import cuda_encode
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("k5_variants: no CUDA device")
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    vw, vh, vn = cs.VIDEO
    frames = cs.yuv420(cs.video_frames(vw, vh, vn, 0))
    with cs.captured_calls() as calls:
        port.encode_video(frames, vw, vh, quant, True, cs.GOP, cs.MERANGE,
                          use_huffman=True, ref_mode="recon", device="cuda")
    inputs = {"K5 I-frames": ("K5 quantize_image",
                              calls["K5 quantize_image"][0])}
    for k, call in enumerate(calls["K5 recon_step"], 1):
        inputs[f"recon step k={k}"] = ("K5 recon_step", call)

    out = {"gpu": gpu_identity(), "reps": reps, "inputs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load(p) for name, p in build_all(
            pathlib.Path(tmp)).items()}
        saved = build.library()
        try:
            for label, (kernel, (args, kwargs)) in inputs.items():
                _, attr, _, symbol, *_ = cs.KERNELS[kernel]
                fn = getattr(cuda_encode, attr)
                kernel_call, _ = cs.calls_of(kernel, args, kwargs)
                outs, times = {}, {name: [] for name in libs}
                for turn in range(2):
                    for name in (list(libs) if turn == 0
                                 else list(libs)[::-1]):
                        build._LIB = libs[name]
                        if turn == 0:
                            outs[name] = [x.clone() for x in kernel_call()]
                        times[name].append(cs.profiled_ms(
                            lambda: fn(*args, **kwargs), symbol,
                            reps) * 1e3)
                for name, got in outs.items():
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, outs["k5"])):
                        raise AssertionError(f"{label}: variant {name} "
                                             f"differs from the kernel")
                res = {name: {"us": sum(t) / len(t), "turns": t}
                       for name, t in times.items()}
                base = res["k5"]["us"]
                print(f"{label} ({tuple(args[0].shape)}): kernel "
                      f"{base:.2f} us (profiler); "
                      + "; ".join(f"{name} {r['us']:.2f} us "
                                  f"({r['us'] - base:+.2f})"
                                  for name, r in res.items()
                                  if name != "k5"), flush=True)
                out["inputs"][label] = res
        finally:
            build._LIB = saved
    print(json.dumps(out))


if __name__ == "__main__":
    main()
