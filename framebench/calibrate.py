"""Readings for the limits of a cell's comparison, in one process: the
program's on each seed, and the control's, the plain reference computed in
the precision below the configuration's and put in the program's place,
on the same compared frames. Not part of the benchmark's runs.

    python3 framebench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <n> ...]

Prints one JSON line a seed: {"seed", "correct", "checks", "control"}.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    from framebench.lib import bench

    for seed in args.seeds:
        r = bench.run(args.workload, seed, args.seconds, False, "cuda",
                      time.perf_counter(),
                      control=seed in args.control_seeds)
        print(json.dumps(dict(
            seed=seed, correct=r["correct"], frames=r["attempted"],
            frame_ms=r["metrics"].get("frame_ms", {}).get("value"),
            checks={k: v["value"] for k, v in r["checks"].items()},
            control=r.get("control"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
