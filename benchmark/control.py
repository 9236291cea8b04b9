"""The readings a cell's check is set from, on the card:

    python3 benchmark/control.py --workload <config>.<traffic> \
        --seeds 1 2 3 [--side control|program]

For each seed it makes the cell's inputs at the cell's own size, runs as
many requests as a run checks (``checked_requests``) through the control
(the reference, its transforms in float32, in the program's place) or
through the program, and checks them as a run does.  One JSON line a
seed.  The benchmark's own runs never run the control.
"""

import sys
import time

from run import T_START  # noqa: F401  (blocks JAX before anything else)

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark import harness, workload  # noqa: E402


def readings(name: str, seed: int, side: str, device: str = "cuda:0"):
    """One seed's reading of the cell ``<config>.<traffic>``."""
    config_name, traffic_name = name.split(".", 1)
    config = harness.load_json("configs", config_name)
    traffic = harness.load_json("traffic", traffic_name)
    wl = workload.make(config, traffic, seed, device)
    wl.program = (wl.control_program() if side == "control"
                  else wl.port_program())
    wl.make_inputs()
    t0 = time.perf_counter()
    for i in range(wl.keep_n):
        key, inp = wl.draw()
        wl.keep(i, key, wl.call(inp))
    mismatched, bad = wl.check()
    return {"workload": name, "seed": seed, "side": side,
            wl.check_name: mismatched, "requests_differing": bad,
            "requests": len(wl.kept),
            "seconds": time.perf_counter() - t0}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--side", choices=("control", "program"),
                   default="control")
    args = p.parse_args()
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.side)),
              flush=True)


if __name__ == "__main__":
    main()
