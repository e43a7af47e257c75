"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Frame pacing is a swap chain of two buffers: before the host starts frame
i it waits for the CUDA event recorded after frame i - 2's image, so at
most two frames are in flight. A frame's interval is the time between two
completions the host observes so; the window closes at the first frame
boundary past `seconds`, after which the frames in flight are waited for
and counted. `frame_ms` is the window over the frames completed in it,
`frame_ms_p90` the 90th percentile of all their intervals.
"""

from __future__ import annotations

import gc
import random
import statistics
import sys
import time

import torch

from framebench.lib import compare, loader, peaks as peaks_mod, trace as tr
from framebench.lib.capture import like

BANNED = ("jax", "jaxlib", "flax", "illuminant_tpu")


def banned_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark must not load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _sample_points(seed: int, count: int):
    """Where in the window (as shares of it) the compared frames start,
    drawn from the seed."""
    rng = random.Random(seed)
    return sorted(rng.uniform(0.1, 0.9) for _ in range(count))


class _HostEvent:
    """A CUDA event's stand-in on the CPU, where every call has finished
    when it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(cell, device, seconds, in_flight, sample_at, buffers,
            trace_frames, trace_at=0.3):
    """The measured window: frames paced by `in_flight` events, the
    frames starting first past each share of `sample_at` captured into
    `buffers`, and with `trace_frames` the frames starting first past
    `trace_at` of it traced (past the window if it is too short).
    -> (t0, completion times, the captured frames, the finished profiler
    or None)."""
    events = [torch.cuda.Event() if device.type == "cuda" else _HostEvent()
              for _ in range(in_flight)]
    completions, captured = [], []
    prof = None
    traced_left = trace_frames
    pending = list(sample_at)
    t0 = time.perf_counter()
    i = 0
    while True:
        if i >= in_flight:
            events[i % in_flight].synchronize()
            completions.append(time.perf_counter())
        now = time.perf_counter() - t0
        # A traced run goes on past the window until its traced frames
        # have run.
        if now >= seconds and not traced_left:
            break
        if traced_left and prof is None and now >= trace_at * seconds:
            from torch.profiler import ProfilerActivity, profile

            _sync(device)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        if prof is not None and traced_left:
            with torch.profiler.record_function(tr.FRAME_RANGE):
                cell.step()
            traced_left -= 1
            if not traced_left:
                _sync(device)
                prof.stop()
        elif pending and now >= pending[0] * seconds:
            pending.pop(0)
            captured.append(cell.captured_step(buffers.pop(0)))
        else:
            cell.step()
        events[i % in_flight].record()
        i += 1
    # Frames 0 .. len(completions) - 1 were seen to complete; wait for the
    # rest of those started.
    for k in range(len(completions), i):
        events[k % in_flight].synchronize()
        completions.append(time.perf_counter())
    return t0, completions, captured, prof


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, bench=None, base: str = loader.HERE,
        control: bool = False) -> dict:
    """One run of the cell `workload` of `bench` (by default the
    checkout's BENCHMARK.json), its files found under `base`. -> the
    result object (the line's keys, with "checks" last). `control` (for
    the calibration, never in the benchmark's runs) adds "control": the
    readings of the reference computed in the precision below the
    configuration's (`Reference.frame(lowp=True)`) in the program's place,
    on the same compared frames."""
    bench = bench or loader.benchmark()
    spec = loader.cell(bench, workload, base)
    params = spec["params"]
    scene = loader.module("scenes", spec["entry"]["config"], base)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t_build = time.perf_counter()
    cell = scene.build(spec["config"], params, seed, device)
    _sync(device)
    t_first = time.perf_counter()
    captured = [cell.captured_step()]  # the first frame, from the seed
    _sync(device)
    t_warm = time.perf_counter()
    for _ in range(params["warm_frames"] - 1):
        cell.step()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup: imports {t_build - t_start:.3f} s, build "
          f"{t_first - t_build:.3f} s, first frame {t_warm - t_first:.3f} s,"
          f" warm frames {t_start + setup_s - t_warm:.3f} s",
          file=sys.stderr)

    pin = device.type == "cuda"
    buffers = [(like(captured[0][0], pin), like(captured[0][1], pin))
               for _ in range(params["compared_frames"])]
    t0, done, in_window, prof = _window(
        cell, device, seconds, params["in_flight"],
        _sample_points(seed, params["compared_frames"]), buffers,
        params["trace_frames"] if trace else 0)
    captured += in_window
    window_s = done[-1] - t0
    # The window's first completion is seen only after the host has
    # launched two frames (the swap chain filling): the intervals start
    # at it.
    intervals = [b - a for a, b in zip(done[:-1], done[1:])] or [window_s]
    ms = sorted(1e3 * v for v in intervals)
    slow = sorted(range(len(intervals)), key=lambda k: -intervals[k])[:5]
    print(f"window: {len(done)} frames in {window_s:.3f} s; intervals ms "
          f"min {ms[0]:.3f} median {statistics.median(ms):.3f} "
          f"max {ms[-1]:.3f}; slowest five (frame, ms) "
          f"{[(k, round(1e3 * intervals[k], 1)) for k in slow]}",
          file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peaks = peaks_mod.peaks_for(name)

    metrics = {}
    breakdown, dev_extra = None, {}
    if trace:
        traced = tr.reduce(prof, params["trace_frames"], cell=cell,
                           peaks=peaks)
        for m in spec["per_layer"]:
            value = loader.module("metrics", m["name"], base).read(traced)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        breakdown = traced.breakdown()
        dev_extra = dict(busy_s=traced.busy_s, window_s=traced.window_s)
        del prof, traced
    else:
        p90 = (statistics.quantiles(intervals, n=10, method="inclusive")[-1]
               if len(intervals) > 1 else intervals[0])
        e2e = dict(frame_ms=1e3 * window_s / len(done),
                   frame_ms_p90=1e3 * p90,
                   peak_mem_gb=peak / 1e9, setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])

    # The program's state goes before the reference runs, so that the
    # reference neither meets it in memory nor sets the peak.
    cell.release()
    del cell
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = loader.module("reference", spec["entry"]["config"],
                        base).Reference(spec["config"], device)
    t_ref = time.perf_counter()
    pairs = []
    with torch.no_grad():
        for inputs, outputs in captured:
            pairs.append((outputs, ref.frame(inputs)))
    checks = params["checks"]
    ok, failed, shown = compare.verdict(checks, pairs)
    print(f"reference: {len(pairs)} frames in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    control_values = None
    if control:
        with torch.no_grad():
            control_values = {n: c["value"] for n, c in compare.verdict(
                checks, [(ref.frame(inputs, lowp=True), r)
                         for (inputs, _), (_, r) in zip(captured, pairs)]
            )[2].items()}
    result = dict(
        correct=ok, attempted=len(done), failed=failed,
        metrics=metrics,
        device=dict(platform="gpu" if device.type == "cuda" else "cpu",
                    kind=name, count=1, memory_peak_bytes=int(peak),
                    **dev_extra))
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control_values is not None:
        result["control"] = control_values
    result["checks"] = shown
    return result
