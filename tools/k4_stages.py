#!/usr/bin/env python3
"""Device time of the port's K4 stages, glue and kernel together, on a GPU.

    python3 tools/k4_stages.py [--tree DIR]

Imports ``imageencoder_tpu_torch`` and ``chip_smoke`` (for its inputs and
its profiler helpers) from DIR, the root of a checkout of the port
(default: this one), so one call can time two versions of the port on the
same inputs and the same card.  It blocks JAX and the JAX package, as the
smoke does.  The stages, at chip_smoke.py's sizes:

  * payload: ``ops/huffman.py::pack_payload``, the Huffman payload pack,
    on the inner stream of the 4096x912 image and of the 720p25 raw and
    recon videos, under the dict built from each stream's histogram;
  * recon fields: everything the recon-reference device encode (no
    histogram) runs on the device except the frame loop's kernels (K5,
    K6, K7 and the recon step): the build of every frame's records and
    their pack.

Each is the profiler's device time per call, summed over every device
operation, with the operations per call.  Prints one line per stage and
one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.modules["jax"] = None
sys.modules["imageencoder_tpu"] = None

LOOP_KERNELS = ("quantize_image_kernel", "motion_search_kernel",
                "predict_kernel", "recon_step_kernel")
REPS = 10


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__)
                                          .resolve().parent.parent))
    tree = pathlib.Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch

    import chip_smoke as cs
    import imageencoder_tpu_torch as port
    from imageencoder_tpu_torch.models.image import stream_header
    from imageencoder_tpu_torch.models.video import (VideoParams, mvec_bits,
                                                     video_header)
    from imageencoder_tpu_torch.ops import huffman
    from imageencoder_tpu_torch.ops.device_pack import header_to_words
    from imageencoder_tpu_torch.ops.pipeline import make_encode_packed_hist
    from imageencoder_tpu_torch.ops.video_pipeline import (
        make_encode_video_packed, make_encode_video_packed_recon)
    from imageencoder_tpu_torch.utils.device import gpu_identity

    if not torch.cuda.is_available():
        raise SystemExit("k4_stages: no CUDA device")
    assert pathlib.Path(port.__file__).resolve().is_relative_to(tree)
    dev = torch.device("cuda", 0)
    quant = port.QuantMatrix(np.array(cs.QUANT, dtype=np.uint32))
    qf = quant.as_float()
    out = {"tree": tree.name, "gpu": gpu_identity(), "stages": {}}

    def record(label: str, fn) -> None:
        counts = {}
        cs.device_rows(fn, REPS, counts)
        ms = cs.profiled_ms(fn, reps=REPS)
        out["stages"][label] = {"device_ms": ms,
                                "device_ops": sum(counts.values())}
        print(f"{tree.name}: {label}: device {ms:.4f} ms a call, "
              f"{sum(counts.values()):.0f} device operations", flush=True)

    def payload(label: str, words, meta) -> None:
        meta = np.asarray(meta.cpu().numpy())
        inner = (int(meta[0]) + 7) // 8
        built = huffman._dict_and_codes(meta[1:])
        code_w, code_l, dict_words, dict_bits = huffman.dict_tensors(built,
                                                                     dev)
        wb = huffman.bucket_words(words, inner)
        record(f"payload {label}", lambda: huffman.pack_payload(
            wb, inner, code_w, code_l, dict_bits, dict_words))

    (h, w) = cs.SHAPES[0]
    img = torch.from_numpy(cs.synthetic(h, w, 2)).to(dev)
    sb, hdr = stream_header(quant, True, w, h, True, dev)
    payload("image", *make_encode_packed_hist(4, True, "reference")(
        img, qf, sb, hdr))

    vw, vh, vn = cs.VIDEO
    frames = torch.from_numpy(cs.video_frames(vw, vh, vn, 0)).to(dev)
    writer = video_header(quant, True, vw, vh,
                          VideoParams(vn, cs.GOP, cs.MERANGE), True)
    vhdr = torch.from_numpy(header_to_words(writer.getvalue())
                            .view(np.int32)).to(dev)
    args = (frames, qf, writer.position, vhdr)
    mb = mvec_bits(cs.MERANGE)
    for mode, factory in (("raw", make_encode_video_packed),
                          ("recon", make_encode_video_packed_recon)):
        enc = factory(cs.GOP, cs.MERANGE, mb, 4, True, "reference",
                      with_hist=True)
        payload(f"video {mode}", *enc(*args))

    enc = make_encode_video_packed_recon(cs.GOP, cs.MERANGE, mb, 4, True,
                                         "reference")
    counts = {}
    rows, _ = cs.device_rows(lambda: enc(*args), REPS, counts)
    fields = [k for k in rows if not any(s in k for s in LOOP_KERNELS)]
    us = sum(rows[k] for k in fields)
    ops = sum(counts[k] for k in fields)
    out["stages"]["recon fields"] = {"device_ms": us / 1e3,
                                     "device_ops": ops}
    print(f"{tree.name}: recon fields (the recon encode but its frame loop's "
          f"kernels): device {us / 1e3:.4f} ms a call, {ops:.0f} device "
          f"operations; of the whole call's {sum(rows.values()) / 1e3:.4f} "
          f"ms and {sum(counts.values()):.0f} operations", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
