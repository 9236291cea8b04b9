#!/usr/bin/env python3
"""Where K4 pack_payload's time goes, on a GPU.

    python3 tools/k4_variants.py [--reps N] [--parent DIR]

K4 pack_payload (imageencoder_tpu_torch/csrc/pack.cu, PayloadFront) packs
one stream, a batch of streams or a batch of byte windows on K2's two
launches: tile_sums_kernel sums each tile's code lengths (a CTA a tile),
pack_known_kernel emits with every tile's start known.  This script
derives from pack.cu, at run time into a temporary directory, variants
that leave steps out or change a parameter:

  no_emit         launch 2 emits no record;
  no_reach        no tile of launch 2 reads past its last record;
  sums_no_lookup  launch 1 takes a record's first byte for its length: no
                  code looked up;
  sums_no_load    launch 1 loads no record (its words made up);
  stores          launch 2 stores a record's interior words instead of
                  OR'ing them in by shared-memory atomics, as K2 does;
  items2, items4  the payload front end takes 2 records a thread over a
                  batch too (not 4), or 4 for one stream too (not 2);

builds K4 and each variant with nvcc (one process each, in parallel), and
times each on the inputs pack_payload gets on the main paths, captured
from real calls (the 4096x912 image's stream, and the same in the words
9 a record would give; over a batch, the 16
streams of chip_smoke.py's serving batch through encode_image_batch; over
windows, the 16 owned byte windows of the sharded encode's stage 2 of
that batch, encode_sharded_image_batch in a world of one over NCCL; and
the batch's words cut to the longest stream's, so that its grid holds no
CTA past every stream's bytes), in turns: the kernels' device time a call
from torch.profiler, and each launch's.  For the batch it also prints each
stream's bytes to code (its table's nbytes) and times pack_payload alone
on the longest stream.  The variants' outputs are wrong by design; only
their times are read.  With ``--parent DIR`` (another tree of the port,
such as a parent commit unpacked by ``git archive``) it also builds that
tree's pack.cu and times its single-pass pack_payload (the design before
the two launches: a zeroed scratch, a tile counter and look-back) on the
one-stream input, its stream held equal to the kept one's.  Prints one
line per input and one JSON line last.
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

ITEMS = ("    static constexpr int kItemsOne = 2;\n"
         "    static constexpr int kItemsBatch = 4;")
VARIANTS = {  # name: [(old, new), ...] in pack.cu
    "no_emit": [(
        "            emit_owned(fe, rec[r], lens[r], rs, w0, span, nspan);",
        "            ;")],
    "no_reach": [("    if (tid < 32 && nspan > 0 && need > 0) {",
                  "    if (tid < 0 && nspan > 0 && need > 0) {")],
    "sums_no_lookup": [(
        "            len[j] = r < n ? length_of(w[j], r) : 0;",
        "            len[j] = r < n ? (int)(w[j][0] & 0xFFu) : 0;")],
    "sums_no_load": [(
        "            if (first + step * j < n) load(first + step * j, w[j]);",
        "            w[j][0] = w[j][1] = w[j][2] = w[j][3] = (uint32_t)j;")],
    "stores": [(
        "    static constexpr bool kAllAtomic = true;  // emitted a code at a "
        "time",
        "    static constexpr bool kAllAtomic = false;")],
    # Records a thread: 2 over a batch too, or 4 for one stream too.
    "items2": [(ITEMS, ITEMS.replace("Batch = 4", "Batch = 2"))],
    "items4": [(ITEMS, ITEMS.replace("One = 2", "One = 4"))],
}
ENTRIES = ("ie_pack_tile", "ie_pack_records", "ie_pack_payload",
           "ie_pack_payload_batch", "ie_pack_payload_scratch")
# The single-pass pack_payload's entry (before the two launches): words,
# n_in, table, out, n_words, scratch, edges, total, stream.
_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
PARENT_ENTRY = [_P, _I64, _P, _P, _I64, _P, _P, _P, _P]
TWO_LAUNCHES = ("tile_sums_kernel", "pack_known_kernel")


def build_all(tmp: pathlib.Path, parent: pathlib.Path | None) -> dict:
    """{name: shared library path} for K4 ("k4"), each variant and, with
    ``parent``, that tree's pack.cu ("parent")."""
    from imageencoder_tpu_torch.kernels import build

    cmds, libs = [], {}
    names = ("k4", *VARIANTS) + (("parent",) if parent else ())
    for name in names:
        csrc = (parent / "imageencoder_tpu_torch" / "csrc" if name == "parent"
                else build.CSRC)
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


def load(path: pathlib.Path, parent: bool) -> ctypes.CDLL:
    from imageencoder_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        fn = getattr(lib, name, None)  # a parent's tree may lack one
        if fn is not None:
            fn.argtypes = (PARENT_ENTRY if parent and name == "ie_pack_payload"
                           else build.SIGNATURES[name])
            fn.restype = ctypes.c_int
    lib.ie_error_string.argtypes = [ctypes.c_int]
    lib.ie_error_string.restype = ctypes.c_char_p
    return lib


def parent_pack_payload(lib, words, table, n_words: int):
    """The parent tree's single-pass pack_payload on one stream, as its
    wrapper called it: (words, total)."""
    import torch

    from imageencoder_tpu_torch.kernels import build

    dev = words.device
    n_tiles = -(-(-(-words.shape[0] // 4)) // lib.ie_pack_tile())
    scratch = torch.zeros(3 + n_tiles, dtype=torch.int64, device=dev)
    edges = torch.empty(max(2 * n_tiles, 1), dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    code = lib.ie_pack_payload(words.data_ptr(), words.shape[0],
                               table.data_ptr(), out.data_ptr(), n_words,
                               scratch.data_ptr(), edges.data_ptr(),
                               total.data_ptr(), build.stream_ptr(dev))
    build.check(code, "ie_pack_payload")
    return out, total.reshape(())


def window_call(batch, quant):
    """The (args, kwargs) of the pack_payload_window call of one sharded
    encode of ``batch`` with the distributed stage 2, in a world of one
    over NCCL."""
    import chip_smoke as cs
    import torch.distributed as dist
    from imageencoder_tpu_torch import parallel
    from imageencoder_tpu_torch.parallel import distributed

    distributed.initialize(device="cuda")
    try:
        mesh = parallel.make_mesh(1, device="cuda")
        with cs.captured_calls() as calls:
            parallel.encode_sharded_image_batch(batch, quant, mesh,
                                                device_entropy=True)
    finally:
        dist.destroy_process_group()
    return calls["K4 pack_payload window"][0]


def batch_streams(cs, call, reps: int) -> dict:
    """Each stream's bytes to code in the batch's call, and pack_payload's
    device time alone on the longest one beside the batch's."""
    from imageencoder_tpu_torch.ops import cuda_pack
    from imageencoder_tpu_torch.ops.dict_table import fields

    (words, tables, n_words), _ = call
    nbytes = [fields(t)["nbytes"] for t in tables]
    k = max(range(len(nbytes)), key=nbytes.__getitem__)
    one = cs.profiled_ms(lambda: cuda_pack.pack_payload(
        words[k], tables[k], n_words), TWO_LAUNCHES, reps) * 1e3
    whole = cs.profiled_ms(lambda: cuda_pack.pack_payload_batch(
        words, tables, n_words), TWO_LAUNCHES, reps) * 1e3
    print(f"pack_payload batch: bytes to code a stream {nbytes}; the "
          f"longest (stream {k}) alone {one:.2f} us, the batch {whole:.2f} "
          f"us (kernels, profiler)", flush=True)
    return {"nbytes": nbytes, "longest": k, "longest_alone_us": one,
            "batch_us": whole}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    opts = ap.parse_args()
    reps = opts.reps

    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.ops import cuda_pack, huffman
    from imageencoder_tpu_torch.ops.dict_table import fields
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
    # The same stream in words sized 9 a record, as the rows were before
    # one rule (packed_words_bound(n, lw)) sized every stream: the grid
    # those words give, the bytes to code unchanged.
    (words, table, _), kwargs = calls["K4 pack_payload"][0]
    wide = torch.zeros((h // 4) * (w // 4) * 9 + 64, dtype=words.dtype,
                       device=words.device)
    wide[:words.shape[0]] = words
    inputs["pack_payload image, 9 words a record"] = (
        "K4 pack_payload",
        ((wide, table, huffman.payload_words(wide.shape[0])), kwargs))
    batch = torch.from_numpy(cs.serving_batch()).cuda()
    with cs.captured_calls() as calls:
        port.encode_image_batch(batch, quant, device="cuda")
    inputs["pack_payload batch"] = ("K4 pack_payload batch",
                                    calls["K4 pack_payload batch"][0])
    inputs["pack_payload window"] = ("K4 pack_payload window",
                                     window_call(batch, quant))
    (words, tables, n_words), _ = inputs["pack_payload batch"][1]
    cut = -(-max((fields(t)["nbytes"] + 3) // 4 for t in tables) // 4) * 4
    inputs["pack_payload batch, rows cut"] = (
        "K4 pack_payload batch",
        ((words[:, :cut].contiguous(), tables, n_words), {}))
    out_streams = batch_streams(cs, inputs["pack_payload batch"][1], reps)

    out = {"gpu": gpu_identity(), "reps": reps, "inputs": {},
           "batch_streams": out_streams}
    parts = {"us": TWO_LAUNCHES, "launch1_us": TWO_LAUNCHES[0],
             "launch2_us": TWO_LAUNCHES[1]}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: load(p, name == "parent") for name, p in build_all(
            pathlib.Path(tmp), opts.parent).items()}
        saved = build.library()
        try:
            for label, (kernel, (args, kwargs)) in inputs.items():
                fn = getattr(cuda_pack, cs.KERNELS[kernel][1])
                calls = {name: (lambda fn=fn: fn(*args, **kwargs))
                         for name in ["k4", *VARIANTS]}
                if kernel == "K4 pack_payload" and "parent" in libs:
                    calls["parent"] = lambda: parent_pack_payload(
                        libs["parent"], *args, **kwargs)
                    build._LIB = libs["k4"]
                    want = cuda_pack.stream_words(*calls["k4"]())
                    got = cuda_pack.stream_words(*calls["parent"]())
                    if not torch.equal(got, want):
                        raise AssertionError(f"{label}: the parent's stream "
                                             f"differs from the kept one's")
                names = list(calls)
                times = {name: {p: [] for p in parts} for name in names}
                for turn in range(2):  # K4, variants, variants, K4
                    for name in (names if turn == 0 else names[::-1]):
                        build._LIB = libs[name]
                        for part, sym in parts.items():
                            if name == "parent" and part != "us":
                                continue
                            times[name][part].append(cs.profiled_ms(
                                calls[name], "pack_payload_kernel"
                                if name == "parent" else sym, reps) * 1e3)
                res = {name: {p: sum(t) / len(t) for p, t in by.items() if t}
                       for name, by in times.items()}
                for name in res:
                    res[name]["turns"] = times[name]["us"]
                base = res["k4"]
                print(f"{label}: K4 {base['us']:.2f} us (launch 1 "
                      f"{base['launch1_us']:.2f}, launch 2 "
                      f"{base['launch2_us']:.2f}; kernels, profiler); "
                      + "; ".join(f"{name} {r['us']:.2f} us "
                                  f"({r['us'] - base['us']:+.2f})"
                                  for name, r in res.items()
                                  if name != "k4"), flush=True)
                out["inputs"][label] = res
        finally:
            build._LIB = saved
    print(json.dumps(out))


if __name__ == "__main__":
    main()
