#!/usr/bin/env python3
"""The encode's tail on a GPU: how each encode path's stream gets from the
card to the caller, on any tree.

    python3 tools/tail_bench.py [--root DIR] [--samples N] [--paths A,B]

Imports the port (imageencoder_tpu_torch) from ``DIR`` (this checkout by
default; a tree unpacked by ``git archive`` for another commit), with JAX
and the JAX package blocked, builds its kernels, and drives each encode
path on chip_smoke.py's inputs, already on the card:

  image          encode_image of the seeded 4096x912 image, Huffman on;
  image_off      the same, Huffman off;
  fallback       the 256x128 noise image under quant all ones (the
                 raw-copy fallback);
  noise_full     the 4096x912 noise image under quant all ones (it is
                 coded: the records' headers skew its byte histogram);
  fallback_full  a full-size fallback: huffman.huffman_encode (the
                 Huffman entry of a long video's spliced chunks) of a
                 seeded random inner stream of FULL_FALLBACK_BYTES, the
                 4096x912 image's Huffman stream size, its upload
                 included;
  batch          encode_image_batch of the 16 serving images;
  raw, recon     models/video.py::encode_frames of the 720p25 video, gop 4,
                 merange 16, Huffman on;
  sharded, sharded_stage2
                 parallel's encode_sharded_image_batch of the 16 images in
                 a world of one over NCCL, Huffman after stage 1 and by
                 the distributed stage 2;
  cut            Tail.result's cut alone, on a pinned buffer of each of
                 CUT_BYTES (the raw and the recon clip's streams): one
                 tobytes() against ops/huffman.py::cut_threaded on 1, 2,
                 4 and 8 threads (a pool of the bench's own, past the
                 program's cap) where the tree has it, in turns, with
                 the cores this process may use and the host's
                 transparent huge page mode (read only).

For each encode path it reads, over N calls: the whole call (host clock, median and
p90); the host's milliseconds a call inside ops/huffman.py::Tail.copy and
Tail.result, and inside device_pack.words_to_bytes and huffman._fallback
wherever the port calls them (0 where it does not); the device-to-host
copies a call (torch.profiler's DtoH rows); the host's waits for the
device a call (chip_smoke.py's host_waits of the same tree); the wire
emit's device microseconds a call where the tree has it; and the streams'
bytes.  Prints one JSON line.  To compare two commits, run it on each in
one chip call, in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import sys
import time

sys.modules["jax"] = None
sys.modules["imageencoder_tpu"] = None

PATHS = ("image", "image_off", "fallback", "noise_full", "fallback_full",
         "batch", "raw", "recon", "sharded", "sharded_stage2", "cut")
FULL_FALLBACK_BYTES = 2_637_546
CUT_BYTES = (46_729_792, 60_915_314)
CUT_THREADS = (1, 2, 4, 8)
THP = pathlib.Path("/sys/kernel/mm/transparent_hugepage/enabled")
PROFILED_CALLS = 5
WAIT_CALLS = 5


def timed_functions(timers: dict):
    """Wrap Tail.copy and Tail.result, and words_to_bytes and _fallback
    in every port module that binds them, to add their host seconds to
    ``timers``; returns a function that puts them back."""
    import importlib

    from imageencoder_tpu_torch.ops import device_pack, huffman

    saved = []

    def wrap(owner, attr, key):
        real = getattr(owner, attr)

        def timed(*args, _real=real, **kwargs):
            t0 = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                timers[key] += time.perf_counter() - t0

        saved.append((owner, attr, real))
        setattr(owner, attr, timed)

    wrap(huffman.Tail, "copy", "tail_copy")
    wrap(huffman.Tail, "result", "tail_result")
    for attr, real, key in (
            ("words_to_bytes", device_pack.words_to_bytes, "words_to_bytes"),
            ("_fallback", huffman._fallback, "fallback")):
        for name in list(sys.modules):
            if not name.startswith("imageencoder_tpu_torch"):
                continue
            mod = importlib.import_module(name)
            if getattr(mod, attr, None) is real:
                wrap(mod, attr, key)

    def restore():
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)

    return restore


def cut_times(samples: int) -> dict:
    """The cut alone: milliseconds (median, p90) of tobytes() and of the
    tree's cut_threaded at each of CUT_THREADS, taken in turns, on a
    pinned buffer of each of CUT_BYTES; each cut checked against
    tobytes()."""
    import torch

    from imageencoder_tpu_torch.ops import huffman

    import concurrent.futures

    threaded = getattr(huffman, "cut_threaded", None)
    if threaded is not None:
        pool = concurrent.futures.ThreadPoolExecutor(max(CUT_THREADS) - 1)
        huffman._pool = lambda: pool
    thp = THP.read_text().strip() if THP.exists() else None
    out = {"cores": len(os.sched_getaffinity(0)), "thp": thp,
           "threaded": threaded is not None}
    for n in CUT_BYTES:
        buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        buf.random_(0, 256, generator=torch.Generator().manual_seed(n))
        data, parts = buf.numpy(), [(0, n)]
        ways = {"tobytes": lambda: [data[:n].tobytes()]}
        if threaded is not None:
            ways.update({f"threads_{k}": (lambda k=k: threaded(data, parts, k))
                         for k in CUT_THREADS})
        want = data[:n].tobytes()
        for name, fn in ways.items():
            if fn() != [want]:
                raise SystemExit(f"tail_bench: cut {name} of {n} bytes "
                                 f"differs from tobytes()")
        del want
        t = {name: [] for name in ways}
        for _ in range(samples):
            for name, fn in ways.items():
                t0 = time.perf_counter()
                fn()
                t[name].append((time.perf_counter() - t0) * 1e3)
        out[str(n)] = {name: [sorted(v)[len(v) // 2],
                              sorted(v)[int(len(v) * 0.9)]]
                       for name, v in t.items()}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--paths", default=",".join(PATHS))
    opts = ap.parse_args()
    root = pathlib.Path(opts.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.kernels import build
    from imageencoder_tpu_torch.models.video import encode_frames
    from imageencoder_tpu_torch.ops import huffman
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("tail_bench: no CUDA device")
    if pathlib.Path(port.__file__).resolve().parent.parent != root:
        raise SystemExit(f"tail_bench: imported the port from "
                         f"{port.__file__}, not from {root}")
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    ones = port.QuantMatrix(np.ones((4, 4), dtype=np.uint32))
    h, w = cs.SHAPES[0]
    img = torch.from_numpy(cs.synthetic(h, w, 2)).to(dev)
    noise = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (128, 256), dtype=np.uint8)).to(dev)
    noise_full = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (h, w), dtype=np.uint8)).to(dev)
    inner = np.random.default_rng(11).integers(
        0, 256, FULL_FALLBACK_BYTES, dtype=np.uint8).tobytes()
    imgs = torch.from_numpy(cs.serving_batch()).to(dev)
    vw, vh, vn = cs.VIDEO
    frames = torch.from_numpy(cs.video_frames(vw, vh, vn, 0)).to(dev)
    wanted = opts.paths.split(",")
    mesh = None
    if any(p.startswith("sharded") for p in wanted):
        from imageencoder_tpu_torch import parallel
        from imageencoder_tpu_torch.parallel import distributed

        distributed.initialize(device="cuda")
        mesh = parallel.make_mesh(1, device="cuda")

    def video(mode):
        return lambda: encode_frames(frames, vw, vh, quant, True, cs.GOP,
                                     cs.MERANGE, use_huffman=True,
                                     ref_mode=mode, device=dev)

    def sharded(entropy):
        from imageencoder_tpu_torch import parallel

        return lambda: parallel.encode_sharded_image_batch(
            imgs, quant, mesh, device_entropy=entropy)

    calls = {
        "image": lambda: port.encode_image(img, quant, use_huffman=True,
                                           device=dev),
        "image_off": lambda: port.encode_image(img, quant, use_huffman=False,
                                               device=dev),
        "fallback": lambda: port.encode_image(noise, ones, use_huffman=True,
                                              device=dev),
        "noise_full": lambda: port.encode_image(
            noise_full, ones, use_huffman=True, device=dev),
        "fallback_full": lambda: huffman.huffman_encode(inner, dev),
        "batch": lambda: port.encode_image_batch(imgs, quant, device=dev),
        "raw": video("raw"),
        "recon": video("recon"),
        "sharded": sharded(False),
        "sharded_stage2": sharded(True),
    }
    results = {}
    for name in wanted:
        if name == "cut":
            results[name] = cut_times(opts.samples)
            print(f"{name}: {json.dumps(results[name])}", file=sys.stderr,
                  flush=True)
            continue
        fn = calls[name]
        got = fn()
        streams = got if isinstance(got, list) else [got]
        torch.cuda.synchronize()
        t = []
        for _ in range(opts.samples):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        timers = collections.Counter()
        restore = timed_functions(timers)
        try:
            for _ in range(opts.samples):
                fn()
            torch.cuda.synchronize()
        finally:
            restore()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_CALLS):
                fn()
            torch.cuda.synchronize()
        d2h = emit_us = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if "DtoH" in e.key:
                d2h += e.count / PROFILED_CALLS
            if "emit_wire_kernel" in e.key:
                us = getattr(e, "self_device_time_total", None)
                emit_us += (e.self_cuda_time_total if us is None
                            else us) / PROFILED_CALLS
        waits, where = cs.host_waits(fn, WAIT_CALLS)
        t.sort()
        results[name] = {
            "call_ms": [t[len(t) // 2], t[int(len(t) * 0.9)]],
            **{f"{k}_ms": timers[k] * 1e3 / opts.samples
               for k in ("tail_copy", "tail_result", "words_to_bytes",
                         "fallback")},
            "d2h_per_call": d2h, "waits": waits, "waits_by_line": where,
            "emit_us": emit_us, "streams": len(streams),
            "bytes": sum(map(len, streams)),
            "first_bit_0": sum(1 for s in streams if not s[0] & 0x80),
        }
        print(f"{name}: {json.dumps(results[name])}", file=sys.stderr,
              flush=True)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    print(json.dumps({"root": str(root), "gpu": gpu_identity(),
                      "build_s": build_s, "samples": opts.samples,
                      "paths": results}))


if __name__ == "__main__":
    main()
