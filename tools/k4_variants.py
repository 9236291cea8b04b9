#!/usr/bin/env python3
"""Where K4's time goes, on a GPU.

    python3 tools/k4_variants.py [--reps N]

K4 (imageencoder_tpu_torch/csrc/pack.cu, pack_tiles) works per tile in
steps: the front end's lengths, a block scan, the look-back, the record
emission into the shared span, the span's stores; and once at the end the
merge of the tiles' shared words.  This script derives from pack.cu, at run
time into a temporary directory, variants that leave steps out or
change a parameter:

  no_emit            records are not emitted (the span stays zero);
  no_merge           the CTAs stop after their last tile: no wait for the
                     others, no merge, no total;
  no_merge_lookback  as no_merge, and each tile takes a made-up prefix
                     instead of looking back;
  items1, items4     the payload front end takes 1 or 4 records a thread
                     instead of 2;

builds K4 and each variant with nvcc (one process each, in parallel), and
times each on the input pack_payload gets on the main path, captured
from a real call (the 4096x912 image's stream), in turns: the kernel's
device time a call from torch.profiler.  The variants' outputs are wrong
by design; only their times are read.  Prints one line per input and one
JSON line last.
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

MERGE = ("    // Every tile has been taken by a running CTA: wait for all of "
         "them.\n")
LOOKBACK = "const long long excl = look_back(status, t, agg, a.start_bit);"
ITEMS = "    static constexpr int kItems = 2;"
VARIANTS = {  # name: [(old, new), ...] in pack.cu
    "no_emit": [("fe.emit(st[r], em);", "")],
    "no_merge": [(MERGE, MERGE + "    return;\n")],
    "no_merge_lookback": [(MERGE, MERGE + "    return;\n"),
                          (LOOKBACK, "const long long excl = t * agg;")],
    **{f"items{n}": [(f"struct PayloadFront {{\n{ITEMS}", f"struct "
                      f"PayloadFront {{\n{ITEMS.replace('2;', f'{n};')}")]
       for n in (1, 4)},
}
ENTRIES = ("ie_pack_tile", "ie_pack_records", "ie_pack_payload")


def build_all(tmp: pathlib.Path) -> dict:
    """{name: shared library path} for K4 ("k4") and each variant."""
    from imageencoder_tpu_torch.kernels import build

    csrc = build.CSRC
    cmds, libs = [], {}
    for name in ("k4", *VARIANTS):
        d = tmp / name
        d.mkdir()
        for src in csrc.glob("*.cuh"):
            (d / src.name).write_text(src.read_text())
        text = (csrc / "pack.cu").read_text()
        for old, new in VARIANTS.get(name, []):
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        (d / "pack.cu").write_text(text)
        libs[name] = d / "lib.so"
        cmds.append([build.nvcc_path(), *build.COMPILE_FLAGS, "-shared",
                     "-o", str(libs[name]), str(d / "pack.cu")])
    build._run_all(cmds)
    return libs


def load(path: pathlib.Path) -> ctypes.CDLL:
    from imageencoder_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        getattr(lib, name).argtypes = build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.ie_error_string.argtypes = [ctypes.c_int]
    lib.ie_error_string.restype = ctypes.c_char_p
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
    from imageencoder_tpu_torch.ops import cuda_pack
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: no CUDA device")
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    h, w = cs.SHAPES[0]
    with cs.captured_calls() as calls:
        port.encode_image(cs.synthetic(h, w, 2), quant, use_huffman=True,
                          device="cuda")
    inputs = {"pack_payload image": ("K4 pack_payload",
                                     calls["K4 pack_payload"][0])}

    out = {"gpu": gpu_identity(), "reps": reps, "inputs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load(p) for name, p in build_all(
            pathlib.Path(tmp)).items()}
        saved = build.library()
        try:
            for label, (kernel, (args, kwargs)) in inputs.items():
                _, attr, _, symbol, *_ = cs.KERNELS[kernel]
                fn = getattr(cuda_pack, attr)
                times = {name: [] for name in libs}
                for turn in range(2):  # K4, variants, variants, K4
                    for name in (list(libs) if turn == 0
                                 else list(libs)[::-1]):
                        build._LIB = libs[name]
                        times[name].append(cs.profiled_ms(
                            lambda: fn(*args, **kwargs), symbol,
                            reps) * 1e3)
                res = {name: {"us": sum(t) / len(t), "turns": t}
                       for name, t in times.items()}
                base = res["k4"]["us"]
                print(f"{label}: K4 {base:.2f} us (kernel, profiler); "
                      + "; ".join(f"{name} {r['us']:.2f} us "
                                  f"({r['us'] - base:+.2f})"
                                  for name, r in res.items()
                                  if name != "k4"), flush=True)
                out["inputs"][label] = res
        finally:
            build._LIB = saved
    print(json.dumps(out))


if __name__ == "__main__":
    main()
