#!/usr/bin/env python3
"""An encode path's device window, kernels and launches, on a GPU.

    python3 tools/path_bench.py [--path recon|raw|image] [--root DIR]
                                [--samples N]

Imports the port (imageencoder_tpu_torch) from ``DIR`` (this checkout by
default; a tree unpacked by ``git archive`` for another commit), with JAX
and the JAX package blocked, builds its kernels, and drives one encode
path through the public functions every version of the port has, with
Huffman on and the input on the card: the recon (default) or raw
reference video encode on chip_smoke.py's 720p25 video (1280x720, 25
frames, gop 4, merange 16, RLE on; ops/video_pipeline.py's
make_encode_video_packed_recon or make_encode_video_packed with the
histogram, then models/video.py::encode_frames), or encode_image on its
seeded 4096x912 image (ops/pipeline.py::make_encode_packed_hist, then
encode_image).  It reads:

  * the device window of the device encoder (CUDA events, median and p90
    over N calls), until the histogram is counted;
  * the device time a call of each kernel group and its launches a call
    (torch.profiler over 10 calls): K1 (encode_locals_kernel), K2
    (pack_locals: tile_sums_kernel and pack_known_kernel on register
    files), K5 (quantize_image_kernel), the recon step
    (recon_step_kernel), the search (motion_search_kernel), K4
    pack_coeffs (pack_coeffs_kernel, or tile_sums_kernel and
    pack_known_kernel on coefficients), and the rest (torch's own rows);
    and each device operation's own row;
  * the whole call (encode_frames or encode_image), host clock, median
    and p90 over N calls.

Prints one JSON line.  To compare two commits, run it on each in one chip
call, in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.modules["jax"] = None
sys.modules["imageencoder_tpu"] = None

# A kernel's group: the first whose every part is in its name (pack_coeffs
# and K2 share tile_sums_kernel and pack_known_kernel, their front ends
# tell them apart).
GROUPS = (("K1", ("encode_locals_kernel",)),
          ("K5", ("quantize_image_kernel",)),
          ("recon step", ("recon_step_kernel",)),
          ("search", ("motion_search_kernel",)),
          ("pack_coeffs", ("pack_coeffs_kernel",)),
          ("pack_coeffs", ("CoeffsFront",)),
          ("K2", ("LocalsFront",)))
PROFILED_CALLS = 10


def quantiles(samples) -> list:
    s = sorted(samples)
    return [s[len(s) // 2], s[int(len(s) * 0.9)]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--path", choices=("recon", "raw", "image"),
                    default="recon")
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
    from imageencoder_tpu_torch.models.image import stream_header
    from imageencoder_tpu_torch.models.video import (VideoParams,
                                                     encode_frames,
                                                     mvec_bits, video_header)
    from imageencoder_tpu_torch.ops.device_pack import header_to_words
    from imageencoder_tpu_torch.ops.pipeline import make_encode_packed_hist
    from imageencoder_tpu_torch.ops.video_pipeline import (
        make_encode_video_packed, make_encode_video_packed_recon)
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("path_bench: no CUDA device")
    if pathlib.Path(port.__file__).resolve().parent.parent != root:
        raise SystemExit(f"path_bench: imported the port from "
                         f"{port.__file__}, not from {root}")
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    qf = quant.as_float()
    if opts.path == "image":
        h, w = cs.SHAPES[0]
        size = [w, h]
        img = torch.from_numpy(cs.synthetic(h, w, 2)).to(dev)
        start_bit, hdr = stream_header(quant, True, w, h, True, dev)
        enc = make_encode_packed_hist(4, True, "reference")

        def call():
            return enc(img, qf, start_bit, hdr)

        def whole():
            port.encode_image(img, quant, use_huffman=True, device=dev)
    else:
        w, h, n = cs.VIDEO
        size = [w, h, n]
        frames = torch.from_numpy(cs.video_frames(w, h, n, 0)).to(dev)
        writer = video_header(quant, True, w, h,
                              VideoParams(n, cs.GOP, cs.MERANGE), True)
        hdr = torch.from_numpy(header_to_words(writer.getvalue())
                               .view(np.int32)).to(dev)
        make = (make_encode_video_packed_recon if opts.path == "recon"
                else make_encode_video_packed)
        enc = make(cs.GOP, cs.MERANGE, mvec_bits(cs.MERANGE), 4, True,
                   "reference", with_hist=True)

        def call():
            return enc(frames, qf, writer.position, hdr)

        def whole():
            encode_frames(frames, w, h, quant, True, cs.GOP, cs.MERANGE,
                          use_huffman=True, ref_mode=opts.path, device=dev)

    call()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(opts.samples)]
    for start, end in ev:
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    window = quantiles([s.elapsed_time(e) for s, e in ev])

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            call()
        torch.cuda.synchronize()
    kernels = {name: {"us": 0.0, "launches": 0.0} for name, _ in GROUPS}
    kernels["other"] = {"us": 0.0, "launches": 0.0}
    rows = {}  # each device operation's own, by the start of its name
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        us = (e.self_cuda_time_total if t is None else t) / PROFILED_CALLS
        group = next((name for name, parts in GROUPS
                      if all(part in e.key for part in parts)), "other")
        kernels[group]["us"] += us
        kernels[group]["launches"] += e.count / PROFILED_CALLS
        rows[e.key[:90]] = {"us": us, "launches": e.count / PROFILED_CALLS}

    t = []
    for _ in range(opts.samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole()
        t.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "root": str(root), "gpu": gpu_identity(), "build_s": build_s,
        "path": opts.path, "size": size, "gop": cs.GOP,
        "samples": opts.samples, "window_ms": window,
        "call_ms": quantiles(t),
        "device_us": sum(k["us"] for k in kernels.values()),
        "device_ops": sum(k["launches"] for k in kernels.values()),
        "kernels": kernels, "rows": rows}))


if __name__ == "__main__":
    main()
