"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--warmup N] [--profile DIR]

Builds the hand-written CUDA kernel of the port from this checkout's
sources, holds it against its plain PyTorch version at the flagship's
shapes, then drives three full-width flagship frames (1080x1920, 8 sphere
lights, a 1M-particle system) through `build_flagship` and `frame`, the
entry points a user calls, and checks what comes out:
  * `slice`: the voxel field, fast preset — the path of the column-map
    kernel, which must launch exactly twice a frame;
  * `slice_analytic`: the analytic field, fast preset (the headline frame);
  * `slice_parity`: the analytic field, parity preset.
The analytic slices must launch the column-map kernel 0 times: they never
build a ColumnField. Each slice line gives ms/frame, live particles,
avg_lum and the peak device memory. `reference` and `reference_analytic`
hold the card's frame to the port's plain CPU path on a small input (the
voxel frame; the analytic frame at both presets). Every phase prints one
line; the line before the last holds the kernels' record as JSON, and the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before that line is printed. With no CUDA card the script exits 2.

`--warmup N` runs N untimed frames before the timed ones of every slice
(default 4). The particle ring fills after capacity / spawn_max = 256
frames, so `--warmup 260` times each frame at its steady population of
about 1M live particles; the default times it at 16k-82k.

`--profile DIR` additionally traces two frames of each slice with
torch.profiler, writes the per-kernel and per-stage tables under
DIR/<slice>/, and prints the device's busy time per frame and its idle
share of the unprofiled frame.
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

# The slices' full width (bench.py's flagship rows).
FULL = dict(height=1080, width=1920, n_lights=8, capacity=1 << 20,
            spawn_max=4096, sdf_resolution_scale=0.25)
# slice phase name -> build_flagship field and preset.
SLICES = {
    "slice": dict(field="voxel", preset="fast"),
    "slice_analytic": dict(field="analytic", preset="fast"),
    "slice_parity": dict(field="analytic", preset="parity"),
}
# The small input of tests/test_torch_flagship.py and
# tests/test_torch_analytic_flagship.py, for the reference checks.
SMALL = dict(height=96, width=160, n_lights=4, capacity=1 << 10,
             spawn_max=128, sdf_resolution_scale=0.5)
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
    """The voxel slice's scene and a column-map pack of its shape: the
    maps of the loaded static field, (5, 135, 240) at the flagship's
    width."""
    from illuminant_tpu_torch.scenes import build_flagship
    from illuminant_tpu_torch.sdf.columns import build_column_maps

    scene = build_flagship(device=device, **FULL, **SLICES["slice"])
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


def phase_slice(name, scene, warmup: int, frames: int):
    """One flagship frame at full width: warm-up, then the timed frames
    that the launch counter watches. The voxel slice launches the
    column-map kernel twice a frame (the initial distance and the fused
    step sample with its gradient, particles/integrate.py); the analytic
    slices never."""
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(0)
    state = scene.system.state
    avg = torch.tensor(0.5, device=dev)
    torch.cuda.reset_peak_memory_stats()
    img, state, avg = _run_frames(scene, warmup, 0, gen, state, avg)
    torch.cuda.synchronize()
    ck.LAUNCHES = 0
    t0 = time.perf_counter()
    img, state, avg = _run_frames(scene, frames, warmup, gen, state, avg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ck.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    live = int(state.live_count())
    img_np = img.cpu().numpy()
    avg_f = float(avg)
    ms_per_frame = 1000.0 * secs / frames
    say(name, **SLICES[name], warmup=warmup, frames=frames,
        ms_per_frame=f"{ms_per_frame:.3f}", live_particles=live,
        avg_lum=f"{avg_f:.5f}", peak_mem_gb=f"{peak_gb:.3f}",
        image=f"{img_np.shape}/{img_np.dtype}",
        column_map_launches=launches)
    if img_np.shape != (FULL["height"], FULL["width"], 3):
        raise AssertionError(f"{name}: image shape {img_np.shape}")
    if not img_np.astype(np.float64).var() > 0.0:
        raise AssertionError(f"{name}: the frame is one flat colour")
    if not live > 0:
        raise AssertionError(f"{name}: no live particles")
    if not math.isfinite(avg_f):
        raise AssertionError(f"{name}: avg_lum {avg_f}")
    expected = 2 * frames if SLICES[name]["field"] == "voxel" else 0
    if launches != expected:
        raise AssertionError(f"{name}: column-map kernel launched {launches} "
                             f"times in {frames} frames, expected {expected}")
    return launches, state, avg, gen, ms_per_frame


def _small_frames(device, draws, **kw):
    """Three frames of the small flagship on `device` from the same state
    with the given spawn draws -> (images int32, positions, avg_lum)."""
    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(device=device, **SMALL, **kw)
    img, state, avg = _run_frames(
        scene, 3, 0, None, scene.system.state,
        torch.tensor(0.5, device=device), spawn_uniforms=draws)
    return (img.cpu().numpy().astype(np.int32), state.position.cpu().numpy(),
            float(avg))


def _compare_small(phase, cpu, cuda, **fields):
    """Print and check the card's small frame against the CPU one: image
    mean |d| <= 1 LSB and <= 1% of values off by more than 8, avg_lum
    within 1%, equal live masks, particles within 0.05. Returns the share
    of live particles within 1e-3."""
    d = np.abs(cuda[0] - cpu[0])
    live = cpu[1][:, 3] > 0
    same_live = bool(np.array_equal(live, cuda[1][:, 3] > 0))
    pos_err = np.abs(cuda[1][live, :3] - cpu[1][live, :3]).max(axis=1)
    within_1e3 = float((pos_err <= 1e-3).mean())
    say(phase, **fields, size=f"{SMALL['height']}x{SMALL['width']}",
        mean_abs_lsb=f"{d.mean():.4f}", share_over_8=f"{(d > 8).mean():.5f}",
        avg_lum_cpu=cpu[2], avg_lum_cuda=cuda[2], same_live=same_live,
        particles_within_0p05=float((pos_err <= 0.05).mean()),
        particles_within_1e3=within_1e3)
    if not (d.mean() <= 1.0 and (d > 8).mean() <= 0.01 and same_live
            and abs(cuda[2] - cpu[2]) <= 0.01 * abs(cpu[2])):
        raise AssertionError(f"{phase}: the card's frame disagrees with the "
                             "CPU path")
    return float((pos_err <= 0.05).mean()), within_1e3


def _draws():
    rng = np.random.default_rng(0)
    return [tuple(rng.random((SMALL["spawn_max"], 4), dtype=np.float32)
                  for _ in range(3)) for _ in range(3)]


def phase_reference():
    """The voxel frame on the card against the port's plain CPU path on
    the small input of the CPU tests (which hold the CPU path to the JAX
    package): three frames from the same state with the same spawn
    draws."""
    draws = _draws()
    kw = SLICES["slice"]
    out = {dev: _small_frames(dev, draws, **kw) for dev in ("cpu", "cuda")}
    within, _ = _compare_small("reference", out["cpu"], out["cuda"], **kw)
    # A particle within the float rounding of a collision threshold may
    # resolve the other way on the card (nvcc fuses multiply-adds).
    if not within >= 0.99:
        raise AssertionError("reference: particles moved apart")


def phase_reference_analytic():
    """The analytic frame at both presets on the card against the CPU
    path, to the bounds of tests/test_torch_analytic_flagship.py."""
    draws = _draws()
    for name in ("slice_analytic", "slice_parity"):
        kw = SLICES[name]
        out = {dev: _small_frames(dev, draws, **kw)
               for dev in ("cpu", "cuda")}
        within, within_1e3 = _compare_small("reference_analytic",
                                            out["cpu"], out["cuda"], **kw)
        if not (within == 1.0 and within_1e3 >= 0.999):
            raise AssertionError(f"reference_analytic ({kw}): particles "
                                 "moved apart")


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


def phase_profile(name, scene, state, avg, gen, i0, frame_ms, out_dir):
    """Two traced frames of slice `name`: per-kernel and per-stage tables
    under out_dir/name, the device's busy time per frame, and its idle
    share of the unprofiled frame time `frame_ms` measured in the same
    run."""
    from torch.profiler import ProfilerActivity, profile

    out_dir = os.path.join(out_dir, name)
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
    say(name.replace("slice", "profile"), frames=2, out=out_dir,
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
    from illuminant_tpu_torch.scenes import build_flagship

    card = card_line()
    say("card", nvidia_smi=json.dumps(card), torch=torch.__version__,
        cuda=torch.version.cuda, device=json.dumps(
            torch.cuda.get_device_name(0)))
    phase_build()
    cuda = torch.device("cuda")
    built = {}
    built["slice"], maps = _slice_maps(cuda)
    kernel = phase_kernel(maps)
    del maps
    launches = {}
    for name, kw in SLICES.items():
        # One slice's scene and state on the card at a time.
        scene = built.pop(name, None) or build_flagship(device=cuda, **FULL,
                                                        **kw)
        launches[name], state, avg, gen, frame_ms = phase_slice(
            name, scene, args.warmup, TIMED_FRAMES)
        if args.profile:
            phase_profile(name, scene, state, avg, gen,
                          args.warmup + TIMED_FRAMES, frame_ms, args.profile)
        del scene, state
        torch.cuda.empty_cache()
    phase_reference()
    phase_reference_analytic()
    kernels = [{
        "name": "column_maps_sample",
        "route": "cuda",
        "source": "illuminant_tpu_torch/csrc/column_maps.cu",
        "replaces": "illuminant_tpu/sdf/columns_pallas.py:78",
        "launches": launches["slice"],
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
