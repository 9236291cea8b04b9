"""``decode_frames``: one of ``clips`` video streams, made at set-up by
the reference's encoder from distinct clips and held on the host as
bytes, drawn uniformly; the request ends when its Y planes are ready on
the device.

Traffic keys: ``clips``, ``motioncomp``.
"""

from __future__ import annotations

import time

import torch

from benchmark import content, roofline
from benchmark.reference import codec
from benchmark.workload import Workload


class Entry(Workload):
    direction = "decode"
    check_name = "mismatched_pixels"

    def __init__(self, *args):
        super().__init__(*args)
        c = self.config
        self.f, self.h, self.w = c["frame_count"], c["height"], c["width"]
        self.n_clips = self.traffic["clips"]
        self.pixels = self.f * self.h * self.w
        if c.get("ref_mode", "raw") != "raw":
            raise ValueError("the reference encodes raw-reference video")
        if not self.traffic["motioncomp"]:
            raise ValueError("the reference decodes with motion "
                             "compensation")

    def make_inputs(self):
        c = self.config
        clips = content.video_clips(self.n_clips, self.f, self.h, self.w,
                                    self.seed, self.device)
        t0 = time.perf_counter()
        self.videos = [codec.encode_video(clips[k], self.quant, c["use_rle"],
                                          c["gop"], c["merange"],
                                          c["use_huffman"])
                       for k in range(self.n_clips)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.reference_s = time.perf_counter() - t0
        self.by_data = {id(v.data): v for v in self.videos}

    def draw(self):
        k = self.order.randrange(self.n_clips)
        return k, self.videos[k].data

    def port_program(self):
        from imageencoder_tpu_torch import decode_frames

        c, dev = self.config, self.device
        mc = self.traffic["motioncomp"]
        return lambda data: decode_frames(data, mc, c["norm"],
                                          c["block_size"], device=dev)

    def control_program(self):
        return lambda data: codec.decode_video(self.by_data[id(data)],
                                               self.device, torch.float32)

    def reference(self, k):
        return codec.decode_video(self.videos[k], self.device)

    def mismatches(self, out, ref) -> int:
        if not isinstance(out, torch.Tensor) or out.shape != ref.shape:
            return ref.numel()
        return int((out != ref).sum())

    def least(self, key, out):
        return roofline.video_decode(self.f, self.h, self.w,
                                     self.config["gop"],
                                     len(self.videos[key].data))
