"""The benchmark of imageencoder_tpu_torch on one NVIDIA H100.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json (harness.py says how) and prints one JSON
line last on standard output.  JAX and the JAX package are blocked
before anything else is imported: the port runs without them.
"""

import os
import sys
import time

T_START = time.perf_counter()
for _name in ("jax", "jaxlib", "flax", "imageencoder_tpu"):
    sys.modules[_name] = None
# Load from one process with few threads: the host's own torch and numpy
# work runs on one thread, so no thread pool spins beside the caller.
for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_name] = "1"

import argparse  # noqa: E402
import pathlib  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    from benchmark import harness

    sys.exit(harness.main(parse(), T_START))
