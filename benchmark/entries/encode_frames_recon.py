"""``encode_frames_recon``: the closed-loop clip encode.  One of ``clips``
distinct clips resident on the device, drawn uniformly, goes through the
port's ``encode_frames`` with ``ref_mode`` "recon"; the request ends when
the stream's bytes are returned.  The check holds each kept stream byte
for byte against reference/recon.py at float64.

Traffic keys: ``clips``.
"""

from __future__ import annotations

import torch

from benchmark import content, roofline_recon
from benchmark.reference import recon
from benchmark.workload import Workload, quant_matrix


class Entry(Workload):
    check_name = "mismatched_streams"

    def __init__(self, *args):
        super().__init__(*args)
        c = self.config
        self.f, self.h, self.w = c["frame_count"], c["height"], c["width"]
        self.n_clips = self.traffic["clips"]
        self.pixels = self.f * self.h * self.w
        if c["ref_mode"] != "recon":
            raise ValueError("the reference encodes recon-reference video")

    def make_inputs(self):
        self.clips = content.video_clips(self.n_clips, self.f, self.h,
                                         self.w, self.seed, self.device)

    def draw(self):
        k = self.order.randrange(self.n_clips)
        return k, self.clips[k]

    def encode(self, frames, dtype=torch.float64) -> bytes:
        c = self.config
        return recon.encode_video_recon(frames, self.quant, c["use_rle"],
                                        c["gop"], c["merange"],
                                        c["use_huffman"], dtype).data

    def port_program(self):
        from imageencoder_tpu_torch.models.video import encode_frames

        c, q = self.config, quant_matrix(self.quant)
        dev = self.device

        def run(frames):
            return encode_frames(frames, self.w, self.h, q, c["use_rle"],
                                 c["gop"], c["merange"], c["use_huffman"],
                                 c["norm"], "recon", c["block_size"],
                                 device=dev)
        return run

    def control_program(self):
        return lambda frames: self.encode(frames, torch.float32)

    def reference(self, k):
        return self.encode(self.clips[k])

    def mismatches(self, out, ref) -> int:
        return int(out != ref)

    def least(self, key, out):
        c = self.config
        return roofline_recon.video_encode_recon(
            self.f, self.h, self.w, c["gop"], c["merange"], len(out))
