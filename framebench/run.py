"""Run one cell of the benchmark once and print its result line.

    python3 framebench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell, its configuration, traffic, comparison limits and per-layer
metrics are found by name (framebench/lib/loader.py). With --trace 0 the
line carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics read from a torch.profiler trace of a few steady frames inside the
window, with the device's busy time and a breakdown. Either way the
program's frames are compared with the plain reference after the window,
and each number compared is printed beside its limit, last on standard
error and last in the line ("checks"). Without a CUDA card the run fails
and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache inside the checkout, at fixed paths; no
# library the port uses may load JAX behind its back.
BUILD = os.path.join(ROOT, "build")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from framebench.lib import bench, loader

    spec = loader.cell(loader.benchmark(), args.workload)
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"framebench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = bench.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", T_START)
    found = bench.banned_modules()
    if found:
        print(f"framebench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
