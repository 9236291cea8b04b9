#!/usr/bin/env python3
"""An encode path's device window, kernels and launches, on a GPU.

    python3 tools/path_bench.py [--path recon|raw|image|sharded_recon|
                                        pair_recon] [--root DIR]
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

``--path sharded_recon`` reads the sharded recon encode
(parallel/video_sharding.py) of the 720p25 video in a world of one over
NCCL: the front (``_Stripes.recon_front``: the stripe search, the recon
step and the halo exchange, up to K1's input) as the device encoder
above, then the whole encode_video_sharded call.  ``--path pair_recon``
runs it in two gloo processes on the card, a (1, 2) mesh over the
1280x704x24 video whose halo exchange crosses the processes: process
0's front and whole call, host clock with a barrier before each, and one
whole call's device operations.

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


def recon_front(mesh, frames, quant):
    """(the sharded recon front of this rank's stripe, the whole
    encode_video_sharded call), both on the frames on the card."""
    import chip_smoke as cs
    from imageencoder_tpu_torch import parallel
    from imageencoder_tpu_torch.parallel import sharding, video_sharding

    st = video_sharding._Stripes(mesh, frames, cs.MERANGE, cs.GOP, "recon")
    cur = st.stripe(frames, frames.device)
    qf = sharding._quant_array(quant.as_float())

    def front():
        return st.recon_front(cur, mesh, qf, 4, "reference")

    def encode():
        return parallel.encode_video_sharded(frames, quant, mesh, True,
                                             cs.GOP, cs.MERANGE,
                                             ref_mode="recon")

    return front, encode


def pair_job(samples: int) -> dict:
    """One process's share of ``--path pair_recon`` (a job of
    parallel/dryrun.py's spawn_world): the front's and the whole call's
    host ms, a barrier and a synchronize before each and after the call,
    and one whole call's device operations and device time."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch import parallel

    mesh = parallel.make_mesh(2, frame_axis=1, device="cuda")
    w, h, n = cs.VIDEO_PAIR
    frames = torch.from_numpy(cs.video_frames(w, h, n, 2)).cuda()
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    front, encode = recon_front(mesh, frames, quant)
    out = {}
    for name, fn in (("front_ms", front), ("call_ms", encode)):
        fn()
        t = []
        for _ in range(samples):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3)
        out[name] = quantiles(t)
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        encode()
        torch.cuda.synchronize()
    out["device_us"] = out["device_ops"] = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            out["device_us"] += e.self_cuda_time_total if t is None else t
            out["device_ops"] += e.count
    return out


def pair_recon(samples: int) -> dict:
    """``--path pair_recon``: pair_job in two gloo processes on the
    card; process 0's numbers, process 1's medians beside them."""
    import os
    import tempfile

    import chip_smoke as cs
    from imageencoder_tpu_torch.parallel import dryrun

    # The processes import this script as a module.
    here = str(pathlib.Path(__file__).resolve().parent)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    with tempfile.TemporaryDirectory() as work:
        ranks = dryrun.spawn_world(2, [("path_bench:pair_job",
                                        {"samples": samples})],
                                   workdir=work, timeout_s=600)
    got = dict(ranks[0][0])
    got["process_1"] = {k: ranks[1][0][k] for k in ("front_ms", "call_ms",
                                                    "device_ops")}
    return dict(got, path="pair_recon", size=list(cs.VIDEO_PAIR), gop=cs.GOP,
                samples=samples)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--path", choices=("recon", "raw", "image",
                                       "sharded_recon", "pair_recon"),
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
    if opts.path == "pair_recon":
        print(json.dumps(dict(pair_recon(opts.samples), root=str(root),
                              gpu=gpu_identity(), build_s=build_s)))
        return
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
    elif opts.path == "sharded_recon":
        from imageencoder_tpu_torch import parallel
        from imageencoder_tpu_torch.parallel import distributed

        distributed.initialize(device="cuda")
        mesh = parallel.make_mesh(1, device="cuda")
        w, h, n = cs.VIDEO
        size = [w, h, n]
        frames = torch.from_numpy(cs.video_frames(w, h, n, 0)).to(dev)
        call, encode = recon_front(mesh, frames, quant)

        def whole():
            encode()
            torch.cuda.synchronize()
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
        row = rows.setdefault(e.key[:90], {"us": 0.0, "launches": 0.0})
        row["us"] += us
        row["launches"] += e.count / PROFILED_CALLS

    t = []
    for _ in range(opts.samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole()
        t.append((time.perf_counter() - t0) * 1e3)
    extra = {}
    if opts.path == "sharded_recon":  # the whole call's device work too
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_CALLS):
                whole()
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        extra = {"call_device_ops": sum(e.count for e in ops)
                 / PROFILED_CALLS,
                 "call_device_us": sum(
                     getattr(e, "self_device_time_total", None)
                     or e.self_cuda_time_total for e in ops)
                 / PROFILED_CALLS}
        import torch.distributed as dist

        dist.destroy_process_group()
    print(json.dumps({**extra, 
        "root": str(root), "gpu": gpu_identity(), "build_s": build_s,
        "path": opts.path, "size": size, "gop": cs.GOP,
        "samples": opts.samples, "window_ms": window,
        "call_ms": quantiles(t),
        "device_us": sum(k["us"] for k in kernels.values()),
        "device_ops": sum(k["launches"] for k in kernels.values()),
        "kernels": kernels, "rows": rows}))


if __name__ == "__main__":
    main()
