"""``encode_image_batch``: ``batch`` consecutive images of a pool resident
on the device, a view at an offset drawn uniformly; the request ends when
the streams' bytes are returned.

Traffic keys: ``pool``, ``batch``, ``noise_every`` (content.image_pool).
"""

from __future__ import annotations

import torch

from benchmark import content, roofline
from benchmark.reference import codec
from benchmark.workload import Workload, quant_matrix


class Entry(Workload):
    check_name = "mismatched_streams"

    def __init__(self, *args):
        super().__init__(*args)
        c, t = self.config, self.traffic
        self.h, self.w = c["height"], c["width"]
        self.batch, self.n_pool = t["batch"], t["pool"]
        self.pixels = self.batch * self.h * self.w
        self.streams: dict[int, bytes] = {}

    def make_inputs(self):
        self.pool = content.image_pool(self.n_pool, self.h, self.w,
                                       self.seed, self.device,
                                       self.traffic["noise_every"])

    def draw(self):
        at = self.order.randrange(self.n_pool - self.batch + 1)
        return at, self.pool[at:at + self.batch]

    def port_program(self):
        from imageencoder_tpu_torch import encode_image_batch

        c, q = self.config, quant_matrix(self.quant)
        dev = self.device

        def run(imgs):
            return encode_image_batch(imgs, q, c["use_rle"],
                                      c["use_huffman"], c["norm"],
                                      c["block_size"], device=dev)
        return run

    def control_program(self):
        c = self.config
        return lambda imgs: [codec.encode_image(im, self.quant, c["use_rle"],
                                                c["use_huffman"],
                                                torch.float32)
                             for im in imgs]

    def reference(self, at):
        c = self.config
        for j in range(at, at + self.batch):
            if j not in self.streams:
                self.streams[j] = codec.encode_image(
                    self.pool[j], self.quant, c["use_rle"], c["use_huffman"])
        return [self.streams[j] for j in range(at, at + self.batch)]

    def mismatches(self, out, ref) -> int:
        out = list(out)
        return sum(a != b for a, b in zip(out, ref)) + abs(len(out) -
                                                            len(ref))

    def least(self, key, out):
        return roofline.image_encode(self.batch, self.h, self.w,
                                     sum(len(s) for s in out))
