"""What every traffic mix shares: a cell's configuration and traffic mix,
read from their data files, made into the requests of a loop and the
check of what the program returned.

A traffic file names the program's entry point (``entry``) and the loop
that drives it (``loop``).  Each entry point is a file of its own,
``entries/<entry>.py``, whose ``Entry`` class (a :class:`Workload`) makes
the inputs, draws the requests, calls the program and works out what each
request should have returned; each loop is ``loops/<loop>.py``.  A later
cell adds the files it needs beside them and edits none.

Every request is drawn from the seed: the same seed gives the same
inputs in the same order.  While the window runs, a reservoir drawn from
the seed keeps the outputs of ``checked_requests`` requests; once it has
closed, the reference (reference/) works out what each of those should
have been from the same inputs, and :meth:`Workload.check` counts the
differences.
"""

from __future__ import annotations

import importlib.util
import pathlib
import random

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, found by name."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind} file for {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(config: dict, traffic: dict, seed: int, device) -> "Workload":
    cls = load("entries", traffic["entry"]).Entry
    return cls(config, traffic, seed, torch.device(device))


def quant_matrix(quant):
    """The configuration's quant table as the port takes it."""
    from imageencoder_tpu_torch import QuantMatrix

    return QuantMatrix(np.array(quant, dtype=np.uint32))


class Workload:
    """The requests of one entry point, and their check."""

    direction = "encode"  # which end-to-end metrics the cell reports
    pixels = 0  # luma pixels a request
    check_name = ""
    # Seconds of set-up spent in the reference (a decode cell's streams):
    # the reference's work, not the program's, so not in setup_s.
    reference_s = 0.0

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from .reference import codec

        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.entry = traffic["entry"]
        self.order = random.Random(f"order:{seed}")
        self.sample = random.Random(f"sample:{seed}")
        self.keep_n = int(traffic["checked_requests"])
        self.kept: list = []
        self.quant = config["quant"]
        if config["norm"] != "reference" or config["block_size"] != codec.B:
            raise ValueError("the reference takes norm 'reference' and "
                             "4x4 blocks")
        self.program = None

    # -- what each entry defines --
    def make_inputs(self) -> None:
        raise NotImplementedError

    def draw(self):
        """The next request: (key, input)."""
        raise NotImplementedError

    def port_program(self):
        """The program's entry point as f(input) -> output."""
        raise NotImplementedError

    def control_program(self):
        """The reference in the program's place, its transform in
        float32: the control that the check must fail."""
        raise NotImplementedError

    def reference(self, key):
        """What the request of ``key`` should return."""
        raise NotImplementedError

    def mismatches(self, out, ref) -> int:
        raise NotImplementedError

    def least(self, key, out) -> dict:
        """roofline.bound() of the request's least device time."""
        raise NotImplementedError

    # -- the loop --
    def call(self, inp):
        out = self.program(inp)
        if self.device.type == "cuda" and isinstance(out, torch.Tensor):
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def keep(self, i: int, key, out) -> None:
        """Reservoir sampling of the window's requests."""
        if i < self.keep_n:
            self.kept.append((i, key, out))
            return
        j = self.sample.randrange(i + 1)
        if j < self.keep_n:
            self.kept[j] = (i, key, out)

    def check(self) -> tuple[int, int]:
        """(the differences summed over the kept requests, the kept
        requests that differ), each against the reference."""
        refs, bad, total = {}, 0, 0
        for _, key, out in sorted(self.kept, key=lambda k: k[0]):
            if key not in refs:
                refs[key] = self.reference(key)
            n = self.mismatches(out, refs[key])
            total += n
            bad += n > 0
        return total, bad
