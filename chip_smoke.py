"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--warmup N] [--profile DIR]

Builds the hand-written CUDA kernel of the port from this checkout's
sources, holds it against its plain PyTorch version at the flagship's
shapes, then drives the voxel flagship frame (1080x1920, 8 sphere lights,
a 1M-particle system) through `build_flagship` and `frame`, the entry
points a user calls, and checks what comes out. Every phase prints one
line; the line before the last holds the kernels' record as JSON, and the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line is printed. With no CUDA card the script exits 2.

`--warmup N` runs N untimed frames before the timed ones (default 4).
The particle ring fills after capacity / spawn_max = 256 frames, so
`--warmup 260` times the frame at its steady population of about 1M live
particles; the default times it at 16k-82k.

`--profile DIR` additionally traces two frames with torch.profiler, writes
the per-kernel and per-stage tables under DIR, and prints the device's
busy time per frame and its idle share of the unprofiled frame.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The slice's full width (bench.py's voxel row).
SLICE = dict(height=1080, width=1920, n_lights=8, capacity=1 << 20,
             spawn_max=4096, sdf_resolution_scale=0.25, field="voxel")
# The small input of tests/test_torch_flagship.py, for the reference check.
SMALL = dict(height=96, width=160, n_lights=4, capacity=1 << 10,
             spawn_max=128, sdf_resolution_scale=0.5, field="voxel")
TIMED_FRAMES = 16


def say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from illuminant_tpu_torch.sdf import columns_kernel

    t0 = time.perf_counter()
    columns_kernel.build()
    secs = time.perf_counter() - t0
    log = (columns_kernel.BUILD_LOG or "").strip().replace("\n", " | ")
    say("build", kernel="column_maps", seconds=f"{secs:.2f}",
        ptxas=json.dumps(log[-400:]))


def _slice_maps(device):
    """The slice's scene and a column-map pack of its shape: the maps of
    the loaded static field, (5, 135, 240) at the flagship's width."""
    from illuminant_tpu_torch.scenes import build_flagship
    from illuminant_tpu_torch.sdf.columns import build_column_maps

    scene = build_flagship(device=device, **SLICE)
    return scene, build_column_maps(scene.volume).maps_c


def phase_kernel(maps):
    """The kernel against its plain version at the slice's shapes: the
    real maps and 1M texel coordinates spanning past both edges, plus the
    exact edge values."""
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    _, hc, wc = maps.shape
    gen = torch.Generator(device=maps.device).manual_seed(1)
    n = 1 << 20
    ty = torch.rand(n, generator=gen, device=maps.device) * (hc + 3) - 2
    tx = torch.rand(n, generator=gen, device=maps.device) * (wc + 3) - 2
    ty[:6] = torch.tensor([-0.5, -3.0, 0.0, hc - 1.0, hc - 0.5, hc + 2.0])
    tx[:6] = torch.tensor([-0.5, wc - 1.0, wc + 3.0, -7.0, 0.25, wc - 1.5])
    # Float32 on both sides in the same tap order; nvcc may fuse a
    # multiply-add that PyTorch rounds twice, a few ulps of the largest
    # map value.
    tol = 1e-5 * max(1.0, float(maps.abs().max()))
    record = {}
    for grad in (False, True):
        out = ck.sample_maps(maps, ty, tx, want_grad=grad)
        torch.cuda.synchronize()
        ref = ck.sample_maps_reference(maps, ty, tx, want_grad=grad)
        if out.shape != ref.shape or out.dtype != torch.float32:
            raise AssertionError(f"kernel output {tuple(out.shape)} "
                                 f"{out.dtype} vs {tuple(ref.shape)}")
        err = float((out - ref).abs().max())
        if not err <= tol:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"(want_grad={grad}): {err} > {tol}")
        ms = cuda_time_ms(lambda: ck.sample_maps(maps, ty, tx, grad), 50)
        plain_ms = cuda_time_ms(
            lambda: ck.sample_maps_reference(maps, ty, tx, grad), 50)
        say("kernel", name="column_maps_sample", want_grad=grad,
            shape=f"{tuple(maps.shape)}x{n}", max_abs_err=err, tol=tol,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
        record[grad] = dict(err=err, ms=ms, plain_ms=plain_ms)
    return record


def _run_frames(scene, n, i0, generator, state, avg, spawn_uniforms=None):
    env_u = scene.environment.uniforms(device=scene.device)
    img = None
    for j in range(n):
        img, state, avg, _ = scene.frame(
            state, avg, generator, scene.volume, scene.gbuffer,
            scene.sphere_lights, env_u, scene.spawner.spawn_max,
            frame_index=i0 + j,
            spawn_uniforms=None if spawn_uniforms is None
            else spawn_uniforms[j])
    return img, state, avg


def phase_slice(scene, warmup: int, frames: int):
    """The flagship frame at full width: warm-up, then the timed frames
    that the launch counter watches."""
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(0)
    state = scene.system.state
    avg = torch.tensor(0.5, device=dev)
    img, state, avg = _run_frames(scene, warmup, 0, gen, state, avg)
    torch.cuda.synchronize()
    ck.LAUNCHES = 0
    t0 = time.perf_counter()
    img, state, avg = _run_frames(scene, frames, warmup, gen, state, avg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ck.LAUNCHES
    live = int(state.live_count())
    img_np = img.cpu().numpy()
    avg_f = float(avg)
    ms_per_frame = 1000.0 * secs / frames
    say("slice", warmup=warmup, frames=frames,
        ms_per_frame=f"{ms_per_frame:.3f}", live_particles=live, avg_lum=f"{avg_f:.5f}",
        image=f"{img_np.shape}/{img_np.dtype}", column_map_launches=launches)
    if img_np.shape != (SLICE["height"], SLICE["width"], 3):
        raise AssertionError(f"image shape {img_np.shape}")
    if not img_np.astype(np.float64).var() > 0.0:
        raise AssertionError("the frame is one flat colour")
    if not live > 0:
        raise AssertionError("no live particles")
    if not math.isfinite(avg_f):
        raise AssertionError(f"avg_lum {avg_f}")
    # Two samples per frame: the initial distance and the fused step
    # sample with its gradient (particles/integrate.py).
    if launches != 2 * frames:
        raise AssertionError(f"column-map kernel launched {launches} times "
                             f"in {frames} frames, expected {2 * frames}")
    return launches, state, avg, gen, ms_per_frame


def phase_reference():
    """The port on the card against the port's plain CPU path on the small
    input of the CPU tests (which hold the CPU path to the JAX package):
    three frames from the same state with the same spawn draws."""
    from illuminant_tpu_torch.scenes import build_flagship

    rng = np.random.default_rng(0)
    draws = [tuple(rng.random((SMALL["spawn_max"], 4), dtype=np.float32)
                   for _ in range(3)) for _ in range(3)]
    out = {}
    for device in ("cpu", "cuda"):
        scene = build_flagship(device=device, **SMALL)
        img, state, avg = _run_frames(
            scene, 3, 0, None, scene.system.state,
            torch.tensor(0.5, device=device), spawn_uniforms=draws)
        out[device] = (img.cpu().numpy().astype(np.int32),
                       state.position.cpu().numpy(), float(avg))
    d = np.abs(out["cuda"][0] - out["cpu"][0])
    live = out["cpu"][1][:, 3] > 0
    pos_err = np.abs(out["cuda"][1][live, :3] - out["cpu"][1][live, :3])
    pos_ok = float((pos_err.max(axis=1) <= 0.05).mean())
    say("reference", size=f"{SMALL['height']}x{SMALL['width']}",
        mean_abs_lsb=f"{d.mean():.4f}", share_over_8=f"{(d > 8).mean():.5f}",
        avg_lum_cpu=out["cpu"][2], avg_lum_cuda=out["cuda"][2],
        particles_within_0p05=pos_ok)
    # The bounds the CPU tests hold the port to against the JAX frame.
    if not (d.mean() <= 1.0 and (d > 8).mean() <= 0.01 and pos_ok >= 0.99
            and abs(out["cuda"][2] - out["cpu"][2])
            <= 0.01 * abs(out["cpu"][2])):
        raise AssertionError("the card's frame disagrees with the CPU path")


def _busy_us(events) -> tuple:
    """(union of the device events' intervals, sum of their durations),
    in microseconds. The union counts overlapping work once; the stage
    ranges' device-side twins span the timeline and are left out."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("illuminant/"))
    union, total, end = 0.0, 0.0, -math.inf
    for a, b in spans:
        total += b - a
        if b > end:
            union += b - max(a, end)
            end = b
    return union, total


def phase_profile(scene, state, avg, gen, i0, frame_ms, out_dir):
    """Two traced frames: per-kernel and per-stage tables, the device's
    busy time per frame, and its idle share of the unprofiled frame time
    `frame_ms` measured in the same run."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _run_frames(scene, 2, i0, gen, state, avg)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    with open(os.path.join(out_dir, "profile_kernels.txt"), "w") as f:
        f.write(ka.table(sort_by="cuda_time_total", row_limit=40))
    # The host-side stage ranges: their host time, and the device time of
    # the kernels they launched. (Their device-side twins, with no host
    # time, span the GPU timeline and are not busy time.)
    stages = [e for e in ka
              if e.key.startswith("illuminant/") and e.cpu_time_total > 0]
    with open(os.path.join(out_dir, "profile_stages.txt"), "w") as f:
        for e in sorted(stages, key=lambda e: -e.cpu_time_total):
            f.write(f"{e.key} calls={e.count} "
                    f"host_ms_per_frame={e.cpu_time_total / 2e3:.3f} "
                    f"device_ms_per_frame={e.device_time_total / 2e3:.3f}"
                    "\n")
    union, total = _busy_us(prof.events())
    busy_ms = union / 2e3
    say("profile", frames=2, out=out_dir,
        device_busy_ms_per_frame=f"{busy_ms:.3f}",
        device_kernel_sum_ms_per_frame=f"{total / 2e3:.3f}",
        unprofiled_ms_per_frame=f"{frame_ms:.3f}",
        device_idle_share=f"{1.0 - busy_ms / frame_ms:.4f}",
        stages=len(stages))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warmup", type=int, default=4,
                    help="untimed frames before the timed ones")
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import illuminant_tpu_torch  # noqa: F401  (sets the float32 policy)

    card = card_line()
    say("card", nvidia_smi=json.dumps(card), torch=torch.__version__,
        cuda=torch.version.cuda, device=json.dumps(
            torch.cuda.get_device_name(0)))
    phase_build()
    scene, maps = _slice_maps(torch.device("cuda"))
    kernel = phase_kernel(maps)
    launches, state, avg, gen, frame_ms = phase_slice(
        scene, args.warmup, TIMED_FRAMES)
    phase_reference()
    if args.profile:
        phase_profile(scene, state, avg, gen, args.warmup + TIMED_FRAMES,
                      frame_ms, args.profile)
    kernels = [{
        "name": "column_maps_sample",
        "route": "cuda",
        "source": "illuminant_tpu_torch/csrc/column_maps.cu",
        "replaces": "illuminant_tpu/sdf/columns_pallas.py:78",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in kernel.values()),
        # The frame's heavier launch (want_grad=True); the other is in the
        # [kernel] line above.
        "ms": kernel[True]["ms"],
        "plain_ms": kernel[True]["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
