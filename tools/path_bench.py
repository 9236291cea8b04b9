#!/usr/bin/env python3
"""An encode or decode path's device window, kernels and launches, on a
GPU.

    python3 tools/path_bench.py [--path recon|raw|image|sharded_recon|
                                        pair_recon|decode_image|
                                        decode_video|decode_image_batch|
                                        image_batch|sharded_image]
                                [--root DIR] [--samples N]

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

``--path decode_image`` reads the decode of the 4096x912 Huffman stream
(written on the card from the seeded image): the device window of
models/image.py::decode_uploaded (D1, D2, D3 on the uploaded stream), D1's
and D2's device time and launches a call by kind (walk, check, round,
table, stitch, emit; each kind's row), and the whole decode_image until
its pixels are ready.
``--path decode_video`` reads the same of the 720p25 raw stream:
models/video.py::decode_into (D1, D2 over the video, the vector read, D3,
K7) and the whole decode_frames.  Both also print the ``stats`` that D1
and D2 write (cuda_decode.CHAIN_STATS of the tree; a tree without it
writes two: the chunks and those walked whole).
``--path decode_image_batch`` reads models/batch.py::decode_image_batch
of chip_smoke.py's 16 serving images (4096x912, Huffman on, written on
the card): the whole call (each stream's parse, upload and D1-D3) is
both the window and the call, and its device time by kernel group.

``--path image_batch`` reads models/batch.py::encode_image_batch of the
same 16 serving images on the card, Huffman on: the window is
launch_batch (K1 on the stacked images, K2 with the histograms over the
16 streams, the dict kernel and K4 pack_payload over them, and the
lengths' copy), the whole call encode_image_batch, its device time by
kernel group (K2 and K4 pack_payload by their front ends, each of the
two-launch packers' launches in its own row).  ``--path sharded_image``
reads parallel/sharding.py's encode_sharded_image_batch of the same
images with the distributed stage 2, in a world of one over NCCL (K2
over segments, the windowed K3, the dict, K4 pack_payload over the
owned byte windows): the whole call is the window.

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

CHAIN_LAUNCHES = ("walk", "check", "round", "table", "table_top",
                  "table_apply", "stitch", "emit")
# A kernel's group: the first whose every part is in its name (pack_coeffs
# and K2 share tile_sums_kernel and pack_known_kernel, their front ends
# tell them apart).
GROUPS = (("K1", ("encode_locals_kernel",)),
          ("K5", ("quantize_image_kernel",)),
          ("recon step", ("recon_step_kernel",)),
          ("search", ("motion_search_kernel",)),
          ("pack_coeffs", ("pack_coeffs_kernel",)),
          ("pack_coeffs", ("CoeffsFront",)),
          ("K2", ("LocalsFront",)),
          ("K4 pack_payload", ("PayloadFront",)),
          ("K4 pack_payload", ("pack_payload_kernel",)),
          ("dict", ("huffman_dict_kernel",)),
          *(("D1", (f"huffman_{k}_kernel",)) for k in CHAIN_LAUNCHES),
          *(("D2", (f"offset_{k}_kernel",)) for k in CHAIN_LAUNCHES),
          ("D3", ("decode_blocks_kernel",)),
          ("vector read", ("read_vectors_kernel",)),
          ("K7", ("predict_kernel",)))
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


def decode_path(path: str, quant, dev):
    """(the device window's call, the whole call ending in a synchronize,
    the size, {"stats": D1's and D2's stats}) for ``--path
    decode_image|decode_video``."""
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.models import video
    from imageencoder_tpu_torch.models.image import (decode_uploaded,
                                                     parse_stream, upload)
    from imageencoder_tpu_torch.ops import cuda_decode

    if path == "decode_image":
        h, w = cs.SHAPES[0]
        size = [w, h]
        data = port.encode_image(cs.synthetic(h, w, 2), quant,
                                 use_huffman=True, device="cuda")
        plan = parse_stream(data)
        views = upload(plan, dev)

        def call():
            return decode_uploaded(plan, views)

        def whole():
            port.decode_image(data, device=dev)
            torch.cuda.synchronize()
    else:
        w, h, n = cs.VIDEO
        size = [w, h, n]
        data = port.encode_video(cs.yuv420(cs.video_frames(w, h, n, 0)), w,
                                 h, quant, True, cs.GOP, cs.MERANGE,
                                 use_huffman=True, ref_mode="raw",
                                 device="cuda")
        plan = video.plan_video(data)
        views = upload(plan, dev)
        y = torch.empty((n, h, w), dtype=torch.uint8, device=dev)

        def call():
            return video.decode_into(plan, views, y)

        def whole():
            video.decode_frames(data, device=dev)
            torch.cuda.synchronize()
    names = getattr(cuda_decode, "CHAIN_STATS", ("chunks", "walked_whole"))
    stats = [torch.zeros(len(names), dtype=torch.int64, device=dev)
             for _ in range(2)]
    d1_chunks = cuda_decode.CHUNK_BITS_HUFFMAN
    if path == "decode_video":  # as models/video.py passes it
        d1_chunks = getattr(cuda_decode, "CHUNK_BITS_HUFFMAN_VIDEO",
                            d1_chunks)
    payload, count = cuda_decode.huffman_decode(
        views["stream"], views["nbytes"], plan["dict_end"], views["table"],
        plan["max_len"], plan["cap"], chunk_bits=d1_chunks, stats=stats[0])
    if path == "decode_image":
        cuda_decode.walk_offsets(payload, count, plan["start"],
                                 plan["n_blocks"], plan["use_rle"], 4,
                                 stats=stats[1])
    else:
        p = plan["params"]
        cuda_decode.walk_video(payload, count, plan["start"], p.frame_count,
                               plan["n_blocks"], p.gop, plan["vbits"],
                               plan["use_rle"], 4, stats=stats[1])
    extra = {"stats": {k: dict(zip(names, s.tolist()))
                       for k, s in zip(("D1", "D2"), stats)},
             "chain_rounds": getattr(cuda_decode, "CHAIN_ROUNDS", 0),
             "chunk_bits": [d1_chunks, cuda_decode.CHUNK_BITS_WALK]}
    return call, whole, size, extra


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--path", choices=("recon", "raw", "image",
                                       "sharded_recon", "pair_recon",
                                       "decode_image", "decode_video",
                                       "decode_image_batch", "image_batch",
                                       "sharded_image"),
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
    elif opts.path in ("decode_image", "decode_video"):
        call, whole, size, extra = decode_path(opts.path, quant, dev)
    elif opts.path == "decode_image_batch":
        streams = [port.encode_image(torch.from_numpy(img).to(dev), quant,
                                     use_huffman=True, device=dev)
                   for img in cs.serving_batch()]
        bq, bh, bw = cs.BATCHES[0]
        size = [bq, bw, bh]

        def call():
            return port.decode_image_batch(streams, device=dev)

        def whole():
            call()
            torch.cuda.synchronize()
    elif opts.path == "image_batch":
        from imageencoder_tpu_torch.models.batch import launch_batch

        imgs = torch.from_numpy(cs.serving_batch()).to(dev)
        bq, bh, bw = cs.BATCHES[0]
        size = [bq, bw, bh]

        def call():
            return launch_batch(imgs, quant, True, True, "reference", 4)

        def whole():
            port.encode_image_batch(imgs, quant, device=dev)
    elif opts.path == "sharded_image":
        from imageencoder_tpu_torch import parallel
        from imageencoder_tpu_torch.parallel import distributed

        distributed.initialize(device="cuda")
        mesh = parallel.make_mesh(1, device="cuda")
        imgs = torch.from_numpy(cs.serving_batch()).to(dev)
        bq, bh, bw = cs.BATCHES[0]
        size = [bq, bw, bh]

        def call():
            return parallel.encode_sharded_image_batch(imgs, quant, mesh,
                                                       device_entropy=True)

        def whole():
            call()
            torch.cuda.synchronize()
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
    if opts.path not in ("decode_image", "decode_video"):
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
    if opts.path in ("sharded_recon", "sharded_image"):
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
