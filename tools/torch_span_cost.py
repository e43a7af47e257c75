"""What the port's spans cost and hold, on one benchmark cell.

    python3 tools/torch_span_cost.py --workload <cell> [--root DIR] \
        [--seed N] [--frames N] [--traced-frames N] [--repeats N]

Builds the cell as `framebench/run.py` does, from the checkout at
`--root` (default: this one; an unpacked earlier commit for a
comparison), warms it, then `--repeats` times runs `--frames` frames
untraced, `--frames` frames with the program's recorder on (each frame
in the span `framebench/frame`, no profiler) and `--traced-frames`
frames under torch.profiler (CPU and CUDA), all paced as the benchmark
paces them (at most two frames in flight), and prints one JSON line:

  untraced_ms, recorded_ms, traced_ms
                          wall time a frame of each stretch, in order
                          (recorded_ms null where the program has no
                          recorder)
  ratio, recorded_ratio   each traced and recorded stretch over the
                          untraced one before it: the profiler's and the
                          recorder's cost, the host's speed divided out
  metrics                 this checkout's per-layer metric readers on
                          the last traced stretch, the recorded ones on
                          the last recorded stretch
  twins                   each profiled host metric beside the recorded
                          host time a frame of the same span
  k5_by_name_ms           the splat's kernels a frame, read by name
  device_ms               the traced device operations a frame
  span_cover              the share of that time held by the outermost
                          `illuminant/` spans (their device time)
  outside                 the device operations launched outside every
                          `illuminant/` span, by name, ms a frame
  untied_ms               the device operations the profiler tied to no
                          host operation at all, ms a frame

The last recorded stretch's table of spans by host self time goes to
standard error. Needs a CUDA card. The metric readers and the
benchmark's description are this checkout's, the cell's scene and the
program `--root`'s.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K5 = r"\b(bin|scan|scatter|accumulate)_kernel(<\d+>)?\(.*Splat"
# The profiler's own event for a buffer of device records: it takes the id
# of the operator open when the buffer was asked for, and so holds that
# operator's kernels a second time.
OVERHEAD = "Activity Buffer Request"
# Each profiled host metric's span, as the recorder records it (the
# particle cell's `particles_host_ms` reads the benchmark's own range
# around `update`, which holds the program's `illuminant/particles/
# update` and nothing else).
TWINS = dict(lighting_host_ms="illuminant/frame/lighting",
             particles_host_ms=("illuminant/frame/particles",
                                "illuminant/particles/update"),
             tick_host_ms="illuminant/particles/tick",
             update_fields_host_ms="illuminant/renderer/update_fields")


def _paced(cell, frames, wrap=None):
    """`frames` frames, at most two in flight -> wall seconds."""
    import torch

    events = [torch.cuda.Event() for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(frames):
        if i >= 2:
            events[i % 2].synchronize()
        if wrap is None:
            cell.step()
        else:
            with wrap():
                cell.step()
        events[i % 2].record()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _power_limit():
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _spans(prof):
    """The CPU events named `illuminant/...` inside no other such event,
    with their device time (us) less what the profiler's own overhead
    events under them hold a second time (`OVERHEAD`); the device
    operations that CPU events outside every such span launched, by name
    (us); and the device time of all operations tied to a CPU event
    (us)."""
    from torch.autograd import DeviceType

    top, outside, tied = [], {}, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU or e.name == OVERHEAD:
            continue
        chain = [e]
        while chain[-1].cpu_parent is not None:
            chain.append(chain[-1].cpu_parent)
        named = [a for a in chain if a.name.startswith("illuminant/")]
        if named == [e]:
            twice = sum(c.device_time_total for c in _descendants(e)
                        if c.name == OVERHEAD)
            top.append(e.device_time_total - twice)
        for k in e.kernels:
            tied += k.duration
            if not named:
                outside[k.name[:120]] = outside.get(k.name[:120], 0.0) \
                    + k.duration
    return top, outside, tied


def _descendants(e):
    stack = list(e.cpu_children)
    while stack:
        c = stack.pop()
        yield c
        stack.extend(c.cpu_children)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--seed", type=int, default=2_718_281_828)
    ap.add_argument("--frames", type=int, default=0,
                    help="untraced frames (default: 20 or 300 by cell)")
    ap.add_argument("--traced-frames", type=int, default=0,
                    help="traced frames (default: 6 or 60 by cell)")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    from framebench.lib import loader, peaks as peaks_mod, trace as tr

    base = os.path.join(root, "framebench")
    bench = json.load(open(os.path.join(HERE, "BENCHMARK.json")))
    spec = loader.cell(bench, args.workload, base)
    flagship = spec["entry"]["config"].startswith("flagship")
    frames = args.frames or (20 if flagship else 300)
    traced = args.traced_frames or (6 if flagship else 60)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cell = loader.module("scenes", spec["entry"]["config"], base).build(
        spec["config"], spec["params"], args.seed, dev)
    _paced(cell, spec["params"]["warm_frames"] + 2)
    from illuminant_tpu_torch.core import trace as program_trace

    # This checkout's reader of a recording, where the readers look for
    # it (an earlier `--root` may have none).
    recorded_mod = loader.module("metrics", "_recorded",
                                 os.path.join(HERE, "framebench"))
    sys.modules.setdefault(recorded_mod.__name__, recorded_mod)
    recorder = getattr(program_trace, "recording", None)
    untraced_ms, recorded_ms, traced_ms = [], [], []
    recorded = None
    for _ in range(args.repeats):
        untraced_ms.append(1e3 * _paced(cell, frames) / frames)
        if recorder is not None:
            with recorder() as rec:
                recorded_ms.append(1e3 * _paced(
                    cell, frames,
                    wrap=lambda: program_trace.span(recorded_mod.FRAME))
                    / frames)
            recorded = recorded_mod.Recorded(rec)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_ms.append(1e3 * _paced(
                cell, traced, wrap=lambda: record_function(tr.FRAME_RANGE))
                / traced)
    name = torch.cuda.get_device_name(dev)
    trace = tr.reduce(prof, traced, cell=cell,
                      peaks=peaks_mod.peaks_for(name))
    trace.recorded = recorded
    if recorded is not None:
        print(recorded.table(), file=sys.stderr)
    metrics = {}
    for m in spec["per_layer"]:
        value = loader.module("metrics", m["name"],
                              os.path.join(HERE, "framebench")).read(trace)
        if value is not None:
            metrics[m["name"]] = value
    device_us = sum(b - a for _, a, b in trace.device_ops)
    top, outside, tied_us = _spans(prof)
    held_us = sum(top)

    def by_name(pattern):
        return sum(b - a for n, a, b in trace.device_ops
                   if re.search(pattern, n)) * 1e-3 / traced

    twins = {}
    for metric, spans in TWINS.items():
        if metric in metrics and recorded is not None:
            spans = (spans,) if isinstance(spans, str) else spans
            twins[metric] = [metrics[metric], next(
                (v for v in map(recorded.host_ms, spans) if v is not None),
                None)]

    print(json.dumps(dict(
        workload=args.workload, root=root, device=name,
        power_limit=_power_limit(),
        untraced_ms=untraced_ms, recorded_ms=recorded_ms or None,
        traced_ms=traced_ms,
        ratio=[t / u for u, t in zip(untraced_ms, traced_ms)],
        recorded_ratio=[r / u for u, r in zip(untraced_ms, recorded_ms)],
        frames=frames, traced_frames=traced, metrics=metrics, twins=twins,
        k5_by_name_ms=by_name(K5),
        device_ms=device_us * 1e-3 / traced,
        span_cover=held_us / device_us if device_us else None,
        untied_ms=(device_us - tied_us) * 1e-3 / traced,
        outside={k: v * 1e-3 / traced for k, v in sorted(
            outside.items(), key=lambda kv: -kv[1])[:8]})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
