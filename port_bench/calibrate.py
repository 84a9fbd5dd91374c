"""Readings for the limits of a cell's comparison: the program's runs on
many seeds, and the control's (the reference in the next lower precision
put in the program's place) on a few, in one process.

    python3 port_bench/calibrate.py --workload roach_rl6.grid64 --seconds 5 \\
        --seeds 11,12,13 --control-seeds 21,22,23

Prints one JSON line a run: the seed, whether it was the control, and each
number compared. The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from port_bench import harness, registry

    if not torch.cuda.is_available():
        print("calibrate.py reads the limits on the card", file=sys.stderr)
        return 2
    bench = registry.load_benchmark()
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        out = harness.run_cell(bench, args.workload, seed, args.seconds, False, "cuda",
                               time.perf_counter(), control=control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                          "correct": out["correct"],
                          "checks": {k: c["value"] for k, c in out["checks"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
