#!/usr/bin/env python3
"""Time D1 (Huffman decode) at several chunk sizes and round counts, and
D2 (offset walk) at several chunk sizes.

    python3 tools/decode_chunks.py [--out FILE.jsonl] [--rounds 0,4,8]
                                   [--d1-chunks 256,512] [--d2-chunks ...]

Needs one CUDA card.  Encodes chip_smoke.py's seeded 4096x912 and
3840x2160 images on the card (Huffman on) and its 1280x720x25 video
(gop 4, merange 16, Huffman on) with the raw and with the recon
reference.  For each stream it runs D1 on the stream at each chunk size
and round count (cuda_decode.CHAIN_ROUNDS, set for the run), and D2 on
its payload at each chunk size (walk_offsets on an image, walk_video over
a whole video; D2 takes no round), checks the output equal to the
defaults', and prints the device time of each launch kind (walk, check,
round, table, table_top, table_apply, stitch, emit) a call from
torch.profiler over 10 calls, and every entry of ``stats``
(cuda_decode.CHAIN_STATS: what the rounds, the table and D2's sweep
did).  The card's name and power
limit come first; with --out each row also goes to FILE as a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import sys

sys.modules["jax"] = None
sys.modules["imageencoder_tpu"] = None
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
import imageencoder_tpu_torch as port  # noqa: E402
from imageencoder_tpu_torch.models.image import parse_stream, upload  # noqa
from imageencoder_tpu_torch.models.video import plan_video  # noqa: E402
from imageencoder_tpu_torch.ops import cuda_decode  # noqa: E402
from imageencoder_tpu_torch.utils.device import gpu_identity  # noqa: E402

REPS = 10


def device_us(fn) -> dict:
    """Device microseconds a call of fn() by kernel name (walk, check,
    round, stitch, emit), and the round launches a call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    rows, launches = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            found = re.search(r"_(\w+?)_kernel", e.key)
            name = found.group(1) if found else e.key[:24]
            rows[name] = rows.get(name, 0.0) + e.self_device_time_total / REPS
            launches[name] = launches.get(name, 0) + e.count / REPS
    return rows, launches


def sweep(out, label: str, fn, chunks, rounds_list, reference) -> None:
    for chunk in chunks:
        for rounds in rounds_list:
            cuda_decode.CHAIN_ROUNDS = rounds
            stats = torch.zeros(len(cuda_decode.CHAIN_STATS),
                                dtype=torch.int64, device="cuda")
            got = fn(chunk, stats)
            for a, b in zip(got, reference):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label} at {chunk} bits, {rounds} "
                                         f"rounds differs")
            rows, launches = device_us(lambda: fn(chunk, None))
            st = dict(zip(cuda_decode.CHAIN_STATS, stats.tolist()))
            total = sum(rows.values())
            parts = ", ".join(f"{k} {v:.2f}" for k, v in sorted(rows.items()))
            print(f"{label} chunks of {chunk} bits, {rounds} rounds: "
                  f"{total:.2f} us ({parts}); "
                  + ", ".join(f"{k} {v}" for k, v in st.items()), flush=True)
            out.write(json.dumps({"stream": label, "chunk_bits": chunk,
                                  "rounds": rounds, "us": total,
                                  "kernels_us": rows,
                                  "launches": launches, "stats": st}) + "\n")
            out.flush()


def ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--rounds", default=f"0,{cuda_decode.CHAIN_ROUNDS}")
    ap.add_argument("--d1-chunks", default="128,256,512,1024")
    ap.add_argument("--d2-chunks", default="512,1024,2048,4096")
    ap.add_argument("--streams", default="image,image4k,raw,recon")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_chunks: needs a CUDA card")
    print(f"gpu: {gpu_identity()}", flush=True)
    rounds_list = ints(opts.rounds)
    default_rounds = cuda_decode.CHAIN_ROUNDS
    quant = port.QuantMatrix(np.array(cs.QUANT, np.uint32))
    dev = torch.device("cuda", 0)
    streams = {}
    for i, (h, w) in enumerate(cs.SHAPES):
        streams[("image", "image4k")[i]] = (f"{w}x{h}", port.encode_image(
            cs.synthetic(h, w, 2 + i), quant, use_huffman=True,
            device="cuda"))
    vw, vh, vn = cs.VIDEO
    vdata = cs.yuv420(cs.video_frames(vw, vh, vn, 0))
    for mode in ("raw", "recon"):
        streams[mode] = (f"{vw}x{vh}x{vn} {mode}", port.encode_video(
            vdata, vw, vh, quant, True, cs.GOP, cs.MERANGE, use_huffman=True,
            ref_mode=mode, device="cuda"))
    if opts.out:
        pathlib.Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    with open(opts.out or os.devnull, "w") as out:
        for key in opts.streams.split(","):
            name, data = streams[key]
            video = key in ("raw", "recon")
            plan = (plan_video(data, pinned=True) if video
                    else parse_stream(data, pinned=True))
            views = upload(plan, dev)
            d1_args = (views["stream"], views["nbytes"], plan["dict_end"],
                       views["table"], plan["max_len"], plan["cap"])
            cuda_decode.CHAIN_ROUNDS = default_rounds
            payload, count = cuda_decode.huffman_decode(*d1_args)
            n_payload = int(count)

            def d1(chunk, stats):
                got, cnt = cuda_decode.huffman_decode(
                    *d1_args, chunk_bits=chunk, stats=stats)
                return got[:n_payload], cnt

            if video:
                params = plan["params"]
                d2_args = (payload, count, plan["start"], params.frame_count,
                           plan["n_blocks"], params.gop, plan["vbits"],
                           plan["use_rle"], 4)
                walk = cuda_decode.walk_video
                n_records = params.frame_count * plan["n_blocks"]
            else:
                d2_args = (payload, count, plan["start"], plan["n_blocks"],
                           plan["use_rle"], 4)
                walk = cuda_decode.walk_offsets
                n_records = plan["n_blocks"]

            def d2(chunk, stats):
                return walk(*d2_args, chunk_bits=chunk, stats=stats)

            print(f"{name}: {len(data)} stream bytes, {n_payload} payload "
                  f"bytes, {n_records} records", flush=True)
            d1_ref, d2_ref = d1(cuda_decode.CHUNK_BITS_HUFFMAN, None), d2(
                cuda_decode.CHUNK_BITS_WALK, None)
            sweep(out, f"D1 {name}", d1, ints(opts.d1_chunks), rounds_list,
                  d1_ref)
            sweep(out, f"D2 {name}", d2, ints(opts.d2_chunks), [0], d2_ref)
            del views, payload, count
    cuda_decode.CHAIN_ROUNDS = default_rounds


if __name__ == "__main__":
    main()
