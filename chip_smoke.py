"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--warmup N] [--profile DIR]

Builds the hand-written CUDA kernels of the port from this checkout's
sources (`illuminant_tpu_torch/csrc/column_maps.cu`: the map pack, the
column-map sampler and the fused ColumnField query), holds each against
its plain PyTorch version at the flagship's shapes, (5, 135, 240) maps and
1M points, and times it on the device beside its plain version, the
two-stage query it replaces, a PyTorch library call and its bound
(`[kernel]`). Then it drives five full-width flagship
frames (1080x1920, 8 sphere lights, a 1M-particle system) through
`build_flagship` and `frame`, the entry points a user calls, and checks
what comes out:
  * `slice`: the voxel field, fast preset — the path of the column
    kernels: the fused query and the pack launch exactly twice a frame,
    the sampler (`sample_maps`, which the query replaced) never; after
    its timed frames the fused query is checked and timed once more on
    the slice's own particle positions (`[kernel] inputs=frame`);
  * `slice_analytic`: the analytic field, fast preset (the headline frame);
  * `slice_parity`: the analytic field, parity preset;
  * `slice_family`, `slice_family_parity`: the analytic field at both
    presets with `full_family=True`: a directional sun, a line light, a
    shadowed volumetric light, a projector and particle lights on top of
    the sphere lights. Before them `families` checks on a small frame
    that each of the five families changes the image.
The analytic slices launch no column kernel: they never build a
ColumnField. Each slice line gives ms/frame, live particles, avg_lum, the
peak device memory and the launch counts. `reference` holds the card's
voxel frame at both presets (the fused query 2 and 5 launches a frame),
`reference_analytic` the analytic frame at both presets and
`reference_family` the full-family frame on the analytic field at both
presets and on the voxel field (the fused query 4 launches a frame: the
two of the collision, the volumetric window's exact refine and the
projector's AO sample) to the port's plain CPU path on a small input.

Two more full-width frames go through the library's public renderer,
`LightingRenderer` (`update_fields`, `render_lighting`, `resolve`), 2
warm-up and 8 timed frames each, every frame moving a light or an
obstruction on the host first:
  * `slice_renderer` (renderer-25d): a 2.5D G-buffer of three height
    volumes and a billboard, 8 shadow-casting ring lights (specular, AO,
    a ramp texture) and 8 replicated shadowless ones under scan shadows, a
    subtractive sphere light and a max directional light (three light
    passes), the tonemapped, sRGB, dithered resolve. Gates: a volume's top
    is lit differently from the ground, the pixel behind a volume is
    darker than its mirror pixel, the subtractive light lowers its region,
    no pixel lies under the max light's floor;
  * `slice_renderer_march` (renderer-voxel-march): a (16, 270, 480) voxel
    field of 6 static and 2 moving dynamic obstructions under
    `update_fields(budget=2)`, 8 lights through the exact cone march.
    Gates: the budgeted field lags the full one while the boxes move and
    equals `generate_volume` of the whole set bit for bit once they stop.
Neither launches a column kernel (the renderer holds no ColumnField).
`reference_renderer` holds both at 96x160 on the card to the CPU path.

The particle engine's public API runs as a user drives it:
  * `slice_particles` (particles-voxel-1080p): BASELINE config 4
    (demo.py:344-410) at 1080 x 1920 on the voxel slice's ColumnField: a
    `ParticleSystem` of 1M slots (a spawner of 4096 a tick, the swirl
    VectorField, an attractor, Noise, a Sensor, collision at 3 substeps)
    takes `update(1/60)`, `render` (untextured quads), `resolve` and
    `to_uint8` each of 8 timed frames. Gates: the fused query and its pack
    launch 5 times a tick and the sampler never, a tick reads nothing back
    from the device, the Sensor equals a direct count, the ring holds
    1,048,576 live particles once it has filled (`--warmup 260`);
  * `reference_particles`: config 2 (plain integrate), config 4 on its
    analytic field, config 4 with every other modifier on a ColumnField,
    and the pattern -> feedback pair, each 10 ticks at 96 x 160 on the
    card against the CPU path from the same host spawn draws.

The particle render's sprite and alpha routes (`csrc/tile_raster.cu`: the
tile compositor K11a and the additive sprite splat K11b):
  * `[kernel]` rows for both at the sprite cell's shapes (1080 x 1920,
    apron 9, the leaf table, 131,072 particles as the cell holds them
    once full), each against its plain version (the composite bit for
    bit), timed beside its bound, with the mean, p99 and largest entries
    a tile and the launch's block (threads, shared memory, blocks an SM,
    registers); the composite also untextured (quad) and on the fullest
    tile's list alone (`inputs=hottest_tile`), the splat with the
    particles a block stages before and after its neighbour filter (by
    the filter's plain mirror, which the kernel's kept lists, read back,
    must equal entry for entry);
  * `slice_alpha_sprites` (particles-alpha-sprites-1080p): config 4 on
    the voxel slice's ColumnField cut to 1<<17 slots and 512 spawns a
    tick, sizes 18 -> 8 px over life; each of 8 timed frames (after 2
    warm-up frames, or --warmup N) runs `update(1/60)`, `render` with
    demo.py's leaf texture, `additive_blend=False`, back-to-front
    `z_formula` and a lit floor, `resolve` and `to_uint8`. Gates: the
    composite launches once a render, a tick and a render read the device
    0 times, accumulated alpha <= 1, the image finite and not flat, the
    last frame's composite equal to its plain version;
    `slice_additive_sprites` draws the same system additively (K11b once
    a render);
  * `reference_sprites`: every route (alpha quad / gauss / round, dither,
    opacity and background, textured additive and alpha, power disc,
    relative size, a velocity-driven sprite sheet, both warps) at 90 x
    150 (partial tiles at the edges) on the card against the CPU path:
    the composite routes bit for bit, the splat routes within K11b's
    bound.
The lighting library's remaining entry points (`csrc/tiled_lights.cu`:
K10, the tiled particle lights as one fused launch a frame):
  * `slice_particle_lights` (particle-lights-tiled-1080p): demo.py's
    `scene_tiled_torches` (:1357-1412) at 1080 x 1920: 2048 torch flames
    as a ParticleState, a shadowless template with an AO radius of 16,
    `ParticleLightSource(method="auto", tile=64, tile_capacity=48)` over a
    flat ground at the voxel slice's ground and ceiling, its AO sampled
    in K10 from that slice's ColumnField. Each of 8 timed frames (after 4
    warm-up frames, or --warmup N) uploads new colour alphas from the host
    without blocking, then runs `accumulate_particle_lights`, adds the
    ambient, `resolve` and `to_uint8`. Gates: K10 and the map pack once a
    frame, the column query never, 0 device reads a frame, no light
    dropped and no relief beyond the candidate window, the last frame's
    K10 call repeated with its debug lists, which must equal
    `bin_lights_to_tiles`' (and `dropped`, the deficit), its image within
    1e-5 x (1 + max) of its plain version, the frame finite and not flat.
    Its `[kernel] tiled_lights_fused` row holds that call against its
    plain version, timed beside the bound (bytes once; operations of the
    cull's box tests, each pixel's AO query and the (light, pixel) pairs
    whose plain opacity is nonzero), with the binned and the contributing
    pairs and the launch's block; with `--parent`, the earlier checkout's
    K10 (which shades alone, from bins made in PyTorch) on the frame's
    own bins in turns with it, and both routes' device work timed
    eagerly;
  * `reference_particle_lights`: the tiled and auto routes at 96 x 160
    (partial 32-px tiles) with stipple, relief, a squashed falloff, an
    overflowing tile (the same `dropped`), a ramp-texture template (auto
    takes the subset), card against CPU; the tiled route against the
    dense subset within 0.02 relative;
  * `reference_probes`: `evaluate_probes` of every family of the
    full-family flagship at a 36 x 20 grid across the frame, card against
    CPU (and each family must change the values), an SH bake and the
    jump flood of demo.py's 256 x 256 mask (exactly equal).
Every phase prints one line; the last
three lines are the kernels' record as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}. Any failure exits non-zero
before those lines are printed. With no CUDA card the script exits 2.

`--warmup N` runs N untimed frames before the timed ones of every
flagship, particle, sprite and particle-light cell (default 4; 2 for the
sprite cells).
The particle rings fill after capacity / spawn_max = 256 frames, so
`--warmup 260` times each frame at its steady population (about 1M live
particles; 131,072 in the sprite cells); the default times it at 20k-33k
(1,024-5,120 in the sprite cells).

`--parent DIR` builds the tile kernels and K10 of another checkout at DIR
(an earlier commit unpacked with `git archive`) and times them beside
these in the `[kernel]` rows of the sprite kernels and of K10, on the same
inputs, in turns (parent_ms).

`--profile DIR` additionally traces two frames of each slice and of each
renderer frame with
torch.profiler once every slice is timed (on a scene built anew and run
through the same warm-up and timed frames, so no other slice's memory is
held), writes the per-kernel and per-stage tables under DIR/<slice>/, and
prints the device's busy time per frame, its device operations
(kernels, copies, fills) per frame and its idle share of the unprofiled
frame.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    "slice_family": dict(field="analytic", preset="fast", full_family=True),
    "slice_family_parity": dict(field="analytic", preset="parity",
                                full_family=True),
}
# The small input of tests/test_torch_flagship.py and
# tests/test_torch_analytic_flagship.py, for the reference checks.
SMALL = dict(height=96, width=160, n_lights=4, capacity=1 << 10,
             spawn_max=128, sdf_resolution_scale=0.5)
# Timed frames of each flagship slice (the renderer frames keep 8): four
# keep the whole run, which has grown by two renderer frames, near 90 s.
TIMED_FRAMES = 4
# The H100 SXM's published peaks: device memory and
# float32 outside the tensor cores. A kernel's bound is the larger of its
# bytes (each input read once, each output written once) and its
# operations over these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KERNEL_REPS = 100


def say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Device time of one fn() call: `reps` calls captured in one CUDA
    graph, then CUDA events around a replay, over `reps`. The replay runs
    the calls back to back, so the host's time to enqueue them (which
    paces small kernels called one by one) is not in it."""
    fn()  # warm-up: builds and loads what the call needs
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    """Build every kernel library from the checkout's sources, one nvcc
    for each source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from illuminant_tpu_torch.core.cuda_build import BUILD_LOGS
    from illuminant_tpu_torch.lighting import tiled_lights_kernel
    from illuminant_tpu_torch.raster import tile_kernel
    from illuminant_tpu_torch.sdf import columns_kernel

    def timed(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    mods = {"column_maps": columns_kernel, "tile_raster": tile_kernel,
            "tiled_lights": tiled_lights_kernel}
    with ThreadPoolExecutor(len(mods)) as pool:
        secs = dict(zip(mods, pool.map(timed, mods.values())))
    for name, mod in mods.items():
        log = BUILD_LOGS.get(mod._LIBRARY, "").strip().replace("\n", " | ")
        say("build", kernel=name, seconds=f"{secs[name]:.2f}",
            ptxas=json.dumps(log[-400:]))


def _slice_field(device):
    """The voxel slice's scene and the ColumnField of its loaded static
    field: (5, 135, 240) coarse maps at the flagship's width."""
    from illuminant_tpu_torch.scenes import build_flagship
    from illuminant_tpu_torch.sdf.columns import build_column_maps

    scene = build_flagship(device=device, **FULL, **SLICES["slice"])
    return scene, build_column_maps(scene.volume)


def pointwise_ops(fn) -> int:
    """The operations of one fn() call, counted as it runs: the elements
    written by its pointwise aten operations (an add, a compare, a where,
    a sqrt each count one per element; a gather, copy or reshape none).
    Run on a plain version, this counts the work of the function a kernel
    computes from its source, at this run's inputs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                self.n += sum(t.numel() for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
            return out

    with Count() as count:
        fn()
    return count.n


def _bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by) of a function that moves n_bytes and does
    n_ops float32 operations."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _max_err(out, ref) -> float:
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if any(a.shape != b.shape or a.dtype != torch.float32
           for a, b in zip(out, ref)) or len(out) != len(ref):
        raise AssertionError("kernel output of another shape or type than "
                             "its plain version")
    return max(float((a - b).abs().max()) for a, b in zip(out, ref))


def _require(name: str, err: float, tol: float, **what):
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({what}): {err} > {tol}")


def _report(rec, key, name, err, bound, calls, **fields):
    """Time each of `calls` by `device_ms`, print one [kernel] line with
    the error and the bound, and keep the times under rec[key]."""
    ms = {m: device_ms(fn, KERNEL_REPS) for m, fn in calls.items()}
    bound_ms, bound_by = bound
    say("kernel", name=name, **fields, max_abs_err=err,
        **{m: f"{v:.4f}" for m, v in ms.items()},
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / ms['ms']:.3f}")
    rec[key] = dict(ms, err=err, bound=bound)


def _grid_sample(maps, ty, tx):
    """The library yardstick of the sampler: grid_sample of the C-channel
    map (bilinear, border padding, align_corners) at texel coords (ty, tx).
    It matches the interior bilinear only and gives no derivative rows."""
    import torch.nn.functional as F

    _, hc, wc = maps.shape
    grid = torch.stack([2.0 * tx / (wc - 1) - 1.0, 2.0 * ty / (hc - 1) - 1.0],
                       dim=-1)[None, None]
    return lambda: F.grid_sample(maps[None], grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)


def _query_job(rec, key, field, x, y, z, tol, **fields):
    """The fused query as the frame calls it (`columns.query`: the pack,
    then one query launch) at world x, y, z, without and with the unit
    gradient, against its plain version; timed beside the query kernel
    alone, the two-stage query (the sampler kernel between the PyTorch
    head and tail), the plain version and grid_sample at the same texel
    coords. Keys rec[key, want_grad]."""
    from illuminant_tpu_torch.sdf import columns
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    maps = field.maps_c
    n = x.shape[0]
    tx, ty = columns._map_coords(field, x, y, z)[:2]
    pack = ck.pack_maps(maps)
    geometry = columns.query_geometry(field)
    for grad in (False, True):
        out = columns.query(field, x, y, z, grad, grad)
        ref = columns.query_reference(field, x, y, z, grad, grad)
        torch.cuda.synchronize()
        out, ref = (out, ref) if grad else ((out,), (ref,))
        err_d = _max_err(out[0], ref[0])
        err_g = _max_err(out[1:], ref[1:]) if grad else 0.0
        _require("column_query", err_d, tol, want_grad=grad, output="d")
        _require("column_query", err_g, 1e-5, want_grad=grad,
                 output="unit gradient")
        ops = pointwise_ops(
            lambda g=grad: columns.query_reference(field, x, y, z, g, g))
        bound = _bound(4.0 * maps.numel() + 4.0 * n * (3 + (4 if grad
                                                             else 1)), ops)
        _report(rec, (key, grad), "column_query", max(err_d, err_g), bound, {
            "ms": lambda g=grad: columns.query(field, x, y, z, g, g),
            "kernel_only_ms": lambda g=grad: ck.query_columns(
                pack, geometry, x, y, z, g, g),
            "two_stage_ms": lambda g=grad: columns.query_reference(
                field, x, y, z, g, g, sampler=ck.sample_maps),
            "plain_ms": lambda g=grad: columns.query_reference(
                field, x, y, z, g, g),
            "library_ms": _grid_sample(maps, ty, tx)},
            **fields, want_grad=grad, normalize=grad, points=n,
            max_abs_err_d=err_d, max_abs_err_g=err_g, tol_d=tol)


def _tolerance(maps) -> float:
    """1e-5 of the largest map value, on a distance or a map sample: the
    source is built with -fmad=false, so products and sums round as in
    PyTorch; sqrt and division are IEEE on both sides. (1e-5 on a unit
    gradient.)"""
    return 1e-5 * max(1.0, float(maps.abs().max()))


def phase_kernel(field):
    """Each column kernel against its plain version at the voxel slice's
    shapes: the real (5, 135, 240) maps, 1M texel coordinates spanning
    past both edges for the sampler, and 1M world positions around and
    outside the volume for the query, with exact edges among them. Each
    [kernel] line gives the error, then the device time per call
    (`device_ms`) of the wrapper as the frame calls it (`ms`), of the
    plain version and of the library yardstick, beside the bound. Returns
    {key: the times, the error and the bound}."""
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    maps = field.maps_c
    dev = maps.device
    n_maps, hc, wc = maps.shape
    c = field.config
    n = 1 << 20
    gen = torch.Generator(device=dev).manual_seed(1)

    def uniform(lo, hi):
        return torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo

    ty, tx = uniform(-2.0, hc + 1.0), uniform(-2.0, wc + 1.0)
    ty[:6] = torch.tensor([-0.5, -3.0, 0.0, hc - 1.0, hc - 0.5, hc + 2.0])
    tx[:6] = torch.tensor([-0.5, wc - 1.0, wc + 3.0, -7.0, 0.25, wc - 1.5])
    ex, ey, ez = (float(c.virtual_width), float(c.virtual_height),
                  float(c.virtual_depth))
    x, y = uniform(-20.0, ex + 20.0), uniform(-20.0, ey + 20.0)
    z = uniform(-8.0, ez + 8.0) + c.z_offset
    # Box faces, a coarse texel edge, the end slices.
    sx = c.scale_x * wc / c.slice_width
    x[:6] = torch.tensor([0.0, ex, 40.5 / sx, 700.0, 960.0, -1.0])
    z[:6] = torch.tensor([20.0, 30.0, 10.0, 0.0, ez, ez - 4.0]) + c.z_offset
    maps_bytes = 4.0 * maps.numel()
    tol = _tolerance(maps)
    rec = {}

    # The pack: exact against its plain version. No one library call
    # computes it.
    out = ck.pack_maps(maps)
    torch.cuda.synchronize()
    err = _max_err(out, ck.pack_maps_reference(maps))
    _require("column_maps_pack", err, 0.0)
    _report(rec, "pack", "column_maps_pack", err,
            _bound(maps_bytes + 4.0 * out.numel(),
                   pointwise_ops(lambda: ck.pack_maps_reference(maps))),
            {"ms": lambda: ck.pack_maps(maps),
             "plain_ms": lambda: ck.pack_maps_reference(maps)},
            shape=tuple(maps.shape), record=tuple(out.shape))

    for grad in (False, True):
        ref = ck.sample_maps_reference(maps, ty, tx, want_grad=grad)
        out = ck.sample_maps(maps, ty, tx, grad)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        _require("column_maps_sample", err, tol, want_grad=grad)
        rows = n_maps + (2 if grad else 0)
        bound = _bound(maps_bytes + 4.0 * n * (2 + rows), pointwise_ops(
            lambda g=grad: ck.sample_maps_reference(maps, ty, tx, g)))
        _report(rec, ("sample", grad), "column_maps_sample", err, bound, {
            "ms": lambda g=grad: ck.sample_maps(maps, ty, tx, g),
            "plain_ms": lambda g=grad: ck.sample_maps_reference(
                maps, ty, tx, g),
            "library_ms": _grid_sample(maps, ty, tx)},
            want_grad=grad, tol=tol, shape=f"{tuple(maps.shape)}x{n}")

    _query_job(rec, "query", field, x, y, z, tol, inputs="uniform")
    return rec


def phase_frame_points(field, state):
    """The fused query on the voxel slice's own traffic: the particles'
    positions after its timed frames, in slot order, passed as the frame
    passes them (strided columns of the (N, 4) state), against its plain
    version and timed as in `phase_kernel`. The maps are the loaded
    field's, the frame's before its animation."""
    pos = state.position
    rec = {}
    _query_job(rec, "query_frame", field, pos[:, 0], pos[:, 1], pos[:, 2],
               _tolerance(field.maps_c), inputs="frame",
               live=int(state.live_count()))
    return rec


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
    that the launch counters watch. The voxel slice launches the fused
    query and its pack twice a frame (the initial distance, and the step
    sample with its unit gradient, particles/integrate.py) and the
    sampler never; the analytic slices launch none of them."""
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(0)
    state = scene.system.state
    avg = torch.tensor(0.5, device=dev)
    torch.cuda.reset_peak_memory_stats()
    img, state, avg = _run_frames(scene, warmup, 0, gen, state, avg)
    torch.cuda.synchronize()
    ck.LAUNCHES = ck.QUERY_LAUNCHES = ck.PACK_LAUNCHES = 0
    t0 = time.perf_counter()
    img, state, avg = _run_frames(scene, frames, warmup, gen, state, avg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(column_query=ck.QUERY_LAUNCHES,
                    column_maps_pack=ck.PACK_LAUNCHES,
                    column_maps_sample=ck.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    live = int(state.live_count())
    img_np = img.cpu().numpy()
    avg_f = float(avg)
    ms_per_frame = 1000.0 * secs / frames
    say(name, **SLICES[name], warmup=warmup, frames=frames,
        ms_per_frame=f"{ms_per_frame:.3f}", live_particles=live,
        avg_lum=f"{avg_f:.5f}", peak_mem_gb=f"{peak_gb:.3f}",
        image=f"{img_np.shape}/{img_np.dtype}",
        **{f"{k}_launches": v for k, v in launches.items()})
    if img_np.shape != (FULL["height"], FULL["width"], 3):
        raise AssertionError(f"{name}: image shape {img_np.shape}")
    if not img_np.astype(np.float64).var() > 0.0:
        raise AssertionError(f"{name}: the frame is one flat colour")
    if not live > 0:
        raise AssertionError(f"{name}: no live particles")
    if not math.isfinite(avg_f):
        raise AssertionError(f"{name}: avg_lum {avg_f}")
    per_frame = 2 if SLICES[name]["field"] == "voxel" else 0
    expected = dict(column_query=per_frame * frames,
                    column_maps_pack=per_frame * frames,
                    column_maps_sample=0)
    if launches != expected:
        raise AssertionError(f"{name}: column kernels launched {launches} "
                             f"times in {frames} frames, expected {expected}")
    return launches, state, ms_per_frame


def _small_frames(device, draws, **kw):
    """Three frames of the small flagship on `device` from the same state
    with the given spawn draws -> (images int32, positions, avg_lum,
    fused-query launches, pack launches)."""
    from illuminant_tpu_torch.scenes import build_flagship
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    scene = build_flagship(device=device, **SMALL, **kw)
    ck.QUERY_LAUNCHES = ck.PACK_LAUNCHES = 0
    img, state, avg = _run_frames(
        scene, 3, 0, None, scene.system.state,
        torch.tensor(0.5, device=device), spawn_uniforms=draws)
    return (img.cpu().numpy().astype(np.int32), state.position.cpu().numpy(),
            float(avg), ck.QUERY_LAUNCHES, ck.PACK_LAUNCHES)


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
    """The voxel frame at both presets on the card against the port's
    plain CPU path on the small input of the CPU tests (which hold the CPU
    path to the JAX package): three frames from the same state with the
    same spawn draws. The card's frames run the fused query 2 (fast) and
    5 (parity: the initial distance, three substeps, the normal) times a
    frame. Fast keeps the voxel slice's bound, 99% of particles within
    0.05; parity is held to those of tests/test_torch_analytic_flagship.py.
    """
    draws = _draws()
    for preset, per_frame in (("fast", 2), ("parity", 5)):
        kw = dict(field="voxel", preset=preset)
        out = {dev: _small_frames(dev, draws, **kw)
               for dev in ("cpu", "cuda")}
        launches = out["cuda"][3]
        within, within_1e3 = _compare_small(
            "reference", out["cpu"], out["cuda"], **kw,
            column_query_launches=launches)
        if launches != 3 * per_frame:
            raise AssertionError(f"reference ({kw}): the fused query "
                                 f"launched {launches} times in 3 frames")
        # A particle within the float rounding of a collision threshold
        # may resolve the other way on the card.
        ok = (within >= 0.99 if preset == "fast"
              else within == 1.0 and within_1e3 >= 0.999)
        if not ok:
            raise AssertionError(f"reference ({kw}): particles moved apart")


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


# Fused-query launches of one voxel full-family frame at the fast preset:
# the collision's initial distance and its step sample with the unit
# gradient (particles/integrate.py), the exact per-candidate refine of the
# volumetric light's windowed scan (one refine sample; a windowed view
# never takes the carried refine, lighting/scan_shadows.py), and the
# projector's AO sample (lighting/projector.py; its cone march runs no
# step: the flagship's projector has no origin). The sun's and the line
# light's AO are gated off on the host, the particle lights' template has
# no AO radius, and every grid query samples the volume itself.
FAMILY_VOXEL_QUERIES_PER_FRAME = 4


def phase_reference_family():
    """The full-family frame on the card against the port's plain CPU
    path on the small input: the analytic field at both presets to the
    bounds of `reference_analytic`, and the voxel field at the fast
    preset to those of `reference`, its fused-query and pack launches
    counted against FAMILY_VOXEL_QUERIES_PER_FRAME."""
    draws = _draws()
    for kw in (SLICES["slice_family"], SLICES["slice_family_parity"],
               dict(field="voxel", preset="fast", full_family=True)):
        out = {dev: _small_frames(dev, draws, **kw)
               for dev in ("cpu", "cuda")}
        queries, packs = out["cuda"][3:5]
        within, within_1e3 = _compare_small(
            "reference_family", out["cpu"], out["cuda"], **kw,
            column_query_launches=queries, column_maps_pack_launches=packs)
        if kw["field"] == "voxel":
            expected = 3 * FAMILY_VOXEL_QUERIES_PER_FRAME
            ok = within >= 0.99
        else:
            expected = 0
            ok = within == 1.0 and within_1e3 >= 0.999
        if (queries, packs) != (expected, expected):
            raise AssertionError(
                f"reference_family ({kw}): the fused query launched "
                f"{queries} times and its pack {packs} times in 3 frames, "
                f"expected {expected}")
        if not ok:
            raise AssertionError(f"reference_family ({kw}): particles "
                                 "moved apart")


def phase_families():
    """Each extra family is in the frame: on the card, at the small size,
    the second frame (the particle lights read the first frame's
    particles) with every family differs from the frame with any one
    family left out."""
    from illuminant_tpu_torch.scenes import FAMILIES, build_flagship

    def image(full_family):
        scene = build_flagship(device="cuda", **SMALL, field="analytic",
                               preset="fast", full_family=full_family)
        img, _, _ = _run_frames(
            scene, 2, 0, torch.Generator(device="cuda").manual_seed(0),
            scene.system.state, torch.tensor(0.5, device="cuda"))
        return img.cpu().numpy().astype(np.int32)

    full = image(True)
    moved = {name: float(np.abs(
        full - image(tuple(f for f in FAMILIES if f != name))).mean())
        for name in FAMILIES}
    say("families", size=f"{SMALL['height']}x{SMALL['width']}",
        **{f"mean_abs_lsb_without_{k}": f"{v:.4f}" for k, v in moved.items()})
    missing = [k for k, v in moved.items() if not v > 0.0]
    if missing:
        raise AssertionError(f"families: leaving out {missing} does not "
                             "change the frame")


# --- the LightingRenderer frames ------------------------------------------

RENDERER_TIMED_FRAMES = 8
RENDERER_WARMUP_FRAMES = 2
RENDERER_SMALL = dict(height=96, width=160)
_RING_COLOURS = [
    (1.0, 0.5, 0.3, 1.0), (0.3, 1.0, 0.5, 1.0), (0.4, 0.5, 1.0, 1.0),
    (1.0, 0.9, 0.4, 1.0), (0.9, 0.3, 0.9, 1.0), (0.3, 0.9, 0.9, 1.0),
    (1.0, 0.7, 0.7, 1.0), (0.7, 1.0, 0.7, 1.0)]


def port_api():
    """The port's classes that the renderer scenes are built from, by the
    names both packages give them. A test passes the JAX package's
    classes instead and gets the same scene there."""
    from types import SimpleNamespace

    from illuminant_tpu_torch.core.config import HDRConfig, RendererConfig
    from illuminant_tpu_torch.lighting import environment as env
    from illuminant_tpu_torch.lighting.billboard import Billboard
    from illuminant_tpu_torch.lighting.directional import (
        DirectionalLightSource)
    from illuminant_tpu_torch.lighting.renderer import LightingRenderer
    from illuminant_tpu_torch.ops import sdf_primitives
    from illuminant_tpu_torch.sdf.height_volume import HeightVolume
    from illuminant_tpu_torch.sdf.volume import SdfVolumeConfig

    return SimpleNamespace(
        HDRConfig=HDRConfig, RendererConfig=RendererConfig,
        LightingEnvironment=env.LightingEnvironment,
        LightObstruction=env.LightObstruction,
        SphereLightSource=env.SphereLightSource,
        ReplicatedLight=env.ReplicatedLight,
        LightSourceReplicator=env.LightSourceReplicator,
        DirectionalLightSource=DirectionalLightSource, Billboard=Billboard,
        HeightVolume=HeightVolume, SdfVolumeConfig=SdfVolumeConfig,
        LightingRenderer=LightingRenderer, TYPE_BOX=sdf_primitives.TYPE_BOX)


def _ring(api, width, height, n_lights, z, radius, **kw):
    cx, cy, ring = width * 0.5, height * 0.5, height * 0.37
    return [api.SphereLightSource(
        position=(cx + ring * math.cos(2 * math.pi * i / n_lights),
                  cy + ring * math.sin(2 * math.pi * i / n_lights), z),
        radius=radius, ramp_length=0.5 * height,
        color=_RING_COLOURS[i % len(_RING_COLOURS)], **kw)
        for i in range(n_lights)]


def ramp_texture():
    """A (4, 16, 3) ramp: brighter with the opacity along u, a hue that
    turns with the angle along v."""
    u = np.linspace(0.0, 1.0, 16, dtype=np.float32)[None, :, None]
    v = np.linspace(0.0, 1.0, 4, dtype=np.float32)[:, None, None]
    hue = np.asarray([1.0, 0.6, 0.3], np.float32) * (1.0 - v) \
        + np.asarray([0.4, 0.7, 1.0], np.float32) * v
    return (u ** 1.5 * hue).astype(np.float32)


def renderer_25d_scene(api, width, height, n_lights=8, n_replicas=8,
                       z_unit=None, **renderer_kw):
    """The `renderer-25d` frame (demo.py's config3_multilight_25d, BASELINE
    config 3, with every option of the light pass on): positions in
    fractions of the frame, heights in `z_unit` (1 at 1080 rows, smaller
    on a small frame so that the volumes stay inside it). -> (renderer,
    hdr, move) where move(i) puts the moving light and obstruction where
    frame i has them. See PERF.md section 4 for the layout."""
    w, h = float(width), float(height)
    zu = min(1.0, h / 270.0) if z_unit is None else z_unit
    env = api.LightingEnvironment(
        ground_z=0.0, maximum_z=96.0, z_to_y_multiplier=1.0,
        ambient=(0.02, 0.02, 0.03, 1.0))
    ring = _ring(api, w, h, n_lights, 40.0 * zu, 9.0 * zu)
    ring[0].specular_color, ring[0].specular_power = (0.6, 0.6, 0.5), 12.0
    ring[3 % n_lights].specular_color = (0.3, 0.4, 0.6)
    ring[3 % n_lights].specular_power = 4.0
    ring[1].ambient_occlusion_radius = 12.0 * zu
    ring[2].ramp_texture = ramp_texture()
    ring[2].ramp_offset, ring[2].ramp_rate = 0.25, 0.5
    env.lights += ring
    rep = api.LightSourceReplicator(template=api.SphereLightSource(
        radius=3.0 * zu, ramp_length=0.08 * h, color=(1.0, 0.8, 0.5, 0.6),
        cast_shadows=False))
    for i in range(n_replicas):
        rep.add(api.ReplicatedLight(
            position=(w * (0.08 + 0.84 * (i + 0.5) / n_replicas), 0.93 * h,
                      10.0 * zu),
            radius=4.0 * zu if i % 3 == 0 else None,
            color=(0.5, 0.8, 1.0, 0.7) if i % 4 == 1 else None,
            opacity=0.5 if i % 2 else None))
    env.lights.append(rep)
    env.lights.append(api.SphereLightSource(
        position=(0.55 * w, 0.8 * h, 30.0 * zu), radius=6.0 * zu,
        ramp_length=0.15 * h, color=(0.8, 0.9, 1.0, 0.6), cast_shadows=False,
        blend_mode="subtractive"))
    env.lights.append(api.DirectionalLightSource(
        direction=(-0.5, -0.4, -0.75), color=(0.10, 0.13, 0.2, 0.6),
        cast_shadows=False, blend_mode="max"))

    def quad(cx, cy, hx, hy):
        return [(cx - hx, cy - hy), (cx + hx, cy - hy), (cx + hx, cy + hy),
                (cx - hx, cy + hy)]

    hx, hy = 0.8 * w, 0.3 * h  # the hexagon's centre; concave on its right
    env.height_volumes += [
        api.HeightVolume(polygon=quad(0.5 * w, 0.5 * h, 0.1 * h, 0.1 * h),
                         z_base=0.0, height=40.0 * zu),
        api.HeightVolume(polygon=quad(0.2 * w, 0.72 * h, 0.05 * h, 0.07 * h),
                         z_base=0.0, height=22.0 * zu),
        api.HeightVolume(polygon=[
            (hx - 0.07 * h, hy - 0.04 * h), (hx + 0.02 * h, hy - 0.08 * h),
            (hx + 0.09 * h, hy - 0.02 * h), (hx + 0.03 * h, hy + 0.01 * h),
            (hx + 0.07 * h, hy + 0.08 * h), (hx - 0.06 * h, hy + 0.06 * h)],
            z_base=0.0, height=30.0 * zu)]
    a = math.radians(15.0)
    moving = api.LightObstruction.box((0.4 * w, 0.85 * h, 10.0 * zu),
                                      (0.03 * h, 0.02 * h, 10.0 * zu))
    env.obstructions += [
        api.LightObstruction.cylinder((0.35 * w, 0.2 * h, 24.0 * zu),
                                      (0.03 * h, 0.03 * h, 24.0 * zu)),
        api.LightObstruction.ellipsoid((0.12 * w, 0.3 * h, 18.0 * zu),
                                       (0.05 * h, 0.03 * h, 18.0 * zu)),
        api.LightObstruction(api.TYPE_BOX, (0.6 * w, 0.15 * h, 20.0 * zu),
                             (0.04 * h, 0.025 * h, 20.0 * zu),
                             rotation=(0.0, 0.0, math.sin(a), math.cos(a))),
        moving]
    # A round silhouette standing at the right edge, bent like a cylinder.
    yy, xx = np.mgrid[0:16, 0:16]
    disc = np.zeros((16, 16, 4), np.float32)
    disc[..., 3] = ((xx - 7.5) ** 2 + (yy - 7.5) ** 2 <= 56.0)
    env.billboards.append(api.Billboard(
        screen_bounds=(0.9 * w - 0.04 * h, 0.12 * h, 0.9 * w + 0.04 * h,
                       0.28 * h), texture=disc, cylinder_factor=0.5))

    renderer = api.LightingRenderer(
        api.RendererConfig(width=width, height=height,
                           two_point_five_d=True), env, None, **renderer_kw)
    hdr = api.HDRConfig(mode=2, exposure=1.3, white_point=4.0,
                        srgb_output=True, dithering=True)
    base = ring[5 % n_lights].position

    def move(i):
        ph = 0.7 * i
        ring[5 % n_lights].position = (
            base[0] + 0.03 * h * math.sin(ph),
            base[1] + 0.03 * h * math.cos(ph), base[2])
        moving.center = ((0.4 + 0.05 * math.sin(0.5 * i)) * w, 0.85 * h,
                         10.0 * zu)

    return renderer, hdr, move


def renderer_march_scene(api, width, height, n_lights=8,
                         resolution_scale=0.25, **renderer_kw):
    """The `renderer-voxel-march` frame (demo.py's single_light_box and
    dynamic_obstructions, BASELINE config 1, at the flagship's voxel field):
    6 static obstructions, 2 dynamic boxes, `n_lights` shadow-casting
    sphere lights, a budgeted voxel field. -> (renderer, hdr, move)."""
    w, h = float(width), float(height)
    env = api.LightingEnvironment(ground_z=0.0, maximum_z=64.0,
                                  ambient=(0.04, 0.04, 0.05, 1.0))
    env.lights += _ring(api, w, h, n_lights, 40.0, 10.0)
    O = api.LightObstruction
    u = h / 270.0  # obstruction footprints in units of 1/270 of the height
    env.obstructions += [
        O.box((0.5 * w, 0.5 * h, 20.0), (14.0 * u, 14.0 * u, 20.0)),
        O.box((0.18 * w, 0.25 * h, 12.0), (20.0 * u, 8.0 * u, 12.0)),
        O.cylinder((0.8 * w, 0.7 * h, 24.0), (10.0 * u, 10.0 * u, 24.0)),
        O.cylinder((0.3 * w, 0.8 * h, 10.0), (7.0 * u, 7.0 * u, 10.0)),
        O.ellipsoid((0.7 * w, 0.2 * h, 16.0), (18.0 * u, 10.0 * u, 16.0)),
        O.ellipsoid((0.1 * w, 0.6 * h, 14.0), (8.0 * u, 12.0 * u, 14.0))]
    dyn = [O.box((0.4 * w, 0.3 * h, 16.0), (12.0 * u, 12.0 * u, 16.0),
                 is_dynamic=True),
           O.box((0.62 * w, 0.75 * h, 8.0), (9.0 * u, 16.0 * u, 8.0),
                 is_dynamic=True)]
    env.obstructions += dyn
    renderer = api.LightingRenderer(
        api.RendererConfig(width=width, height=height), env,
        api.SdfVolumeConfig(
            virtual_width=width, virtual_height=height, virtual_depth=64,
            slice_count=16, resolution_scale=resolution_scale),
        **renderer_kw)
    hdr = api.HDRConfig(mode=2, exposure=1.2, white_point=3.0)

    def move(i):
        dyn[0].center = ((0.4 + 0.04 * math.sin(0.6 * i)) * w,
                         (0.3 + 0.05 * math.cos(0.6 * i)) * h, 16.0)
        dyn[1].center = ((0.62 + 0.05 * math.cos(0.4 * i)) * w, 0.75 * h,
                         8.0)

    return renderer, hdr, move


# phase name -> (scene function, shadow mode, update_fields budget)
RENDERER_FRAMES = {
    "slice_renderer": (renderer_25d_scene, "scan", None),
    "slice_renderer_march": (renderer_march_scene, "march", 2),
}


def renderer_frame(renderer, hdr, move, i, shadow_mode, budget):
    """Frame i of a renderer scene as a user drives it: move the moving
    parts on the host, update the fields, light, resolve, quantize ->
    (uint8 image, lightmap)."""
    from illuminant_tpu_torch.raster.resolve import to_uint8

    move(i)
    renderer.update_fields(budget=budget)
    lightmap = renderer.render_lighting(shadow_mode=shadow_mode)
    return to_uint8(renderer.resolve(lightmap, hdr)), lightmap


class HostReads:
    """Counts the device-to-host scalar reads (`aten::_local_scalar_dense`:
    a march's "any ray live?", an `int()` of a tensor) made inside it."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self
        outer.n = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten._local_scalar_dense.default:
                    outer.n += 1
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _build_renderer(name, device, height, width, **kw):
    """The renderer scene of phase `name` on `device` with its initial
    fields built (every slice of the voxel field valid)."""
    build, shadow_mode, budget = RENDERER_FRAMES[name]
    renderer, hdr, move = build(port_api(), width, height, device=device,
                                **kw)
    renderer.update_fields(budget=10 ** 6)
    return renderer, hdr, move, shadow_mode, budget


def _px(renderer, fx, fy):
    h, w = renderer.config.lightmap_shape
    return int(fy * h), int(fx * w)


def gates_25d(renderer, lightmap):
    """What the 2.5D frame must show, read from the last frame's lightmap
    (numpy) and two more renders of the same fields."""
    env = renderer.environment
    lum = lightmap[..., :3].sum(axis=-1)
    gb = renderer.gbuffer
    top, ground = _px(renderer, 0.5, 0.47), _px(renderer, 0.5, 0.68)
    z = gb.z.cpu().numpy()
    if not (z[top] > z[ground] == 0.0 and abs(lum[top] - lum[ground]) > 0.02):
        raise AssertionError(
            f"renderer-25d: the top of the centre volume (z {z[top]}, light "
            f"{lum[top]}) is lit like the ground beside it ({lum[ground]})")
    # Left of the left volume every ring light is hidden; its mirror pixel
    # on the right has none of the scene's geometry near it.
    behind, mirror = _px(renderer, 0.14, 0.72), _px(renderer, 0.86, 0.72)
    if not lum[behind] < 0.8 * lum[mirror]:
        raise AssertionError(
            f"renderer-25d: the pixel behind the left volume ({lum[behind]}) "
            f"is not darker than its mirror pixel ({lum[mirror]})")
    lights = list(env.lights)
    sub = [l for l in lights if getattr(l, "blend_mode", "") == "subtractive"]
    mx = [l for l in lights if getattr(l, "blend_mode", "") == "max"]
    try:
        env.lights[:] = [l for l in lights if l not in sub]
        without = renderer.render_lighting(
            shadow_mode="scan")[..., :3].sum(dim=-1).cpu().numpy()
        env.lights[:] = mx
        ambient, env.ambient = env.ambient, (0.0, 0.0, 0.0, 0.0)
        floor = renderer.render_lighting(shadow_mode="scan").cpu().numpy()
        env.ambient = ambient
    finally:
        env.lights[:] = lights
    at = _px(renderer, 0.55, 0.8)
    if not lum[at] < without[at] - 0.05:
        raise AssertionError(
            f"renderer-25d: the subtractive light does not lower its region "
            f"({lum[at]} with it, {without[at]} without)")
    if not (floor[..., :3].max() > 0.0
            and (lightmap >= floor - 1e-6).all()):
        raise AssertionError("renderer-25d: a pixel lies under the max "
                             "light's floor")
    return dict(top_vs_ground=f"{lum[top]:.4f}/{lum[ground]:.4f}",
                behind_vs_mirror=f"{lum[behind]:.4f}/{lum[mirror]:.4f}",
                subtractive=f"{lum[at]:.4f}/{without[at]:.4f}",
                max_floor=f"{floor[..., :3].max():.4f}")


def gates_march(renderer, budget):
    """The budgeted field: while the dynamic boxes moved it lags the full
    field of the whole obstruction set; once they stand still, enough
    budgeted updates make it that field bit for bit."""
    from illuminant_tpu_torch.sdf import volume as vol

    full = vol.generate_volume(
        renderer.sdf_config, renderer.environment.pack_obstructions(
            capacity=renderer.obstruction_capacity, device=renderer.device))
    stale = int((renderer.volume.data != full.data).sum())
    if not (stale > 0 and renderer._invalid_dynamic):
        raise AssertionError("renderer-voxel-march: the budgeted field does "
                             "not lag the moving boxes")
    calls = 0
    while renderer._invalid_slices:
        renderer.update_fields(budget=budget)
        calls += 1
        if calls > 16:
            raise AssertionError("renderer-voxel-march: the budgeted field "
                                 "does not converge")
    if not (torch.equal(renderer.volume.data, full.data)
            and float(renderer.volume.max_valid_z) == float(full.max_valid_z)):
        raise AssertionError("renderer-voxel-march: the converged field is "
                             "not generate_volume of the obstruction set")
    return dict(stale_voxels_while_moving=stale, calls_to_converge=calls)


def phase_slice_renderer(name):
    """One full-width LightingRenderer frame: warm-up, the timed frames
    (each fenced by a synchronize), the device-to-host reads of one more
    frame, then the frame's gates."""
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    renderer, hdr, move, shadow_mode, budget = _build_renderer(
        name, "cuda", FULL["height"], FULL["width"])
    torch.cuda.reset_peak_memory_stats()
    n = 0
    for _ in range(RENDERER_WARMUP_FRAMES):
        renderer_frame(renderer, hdr, move, n, shadow_mode, budget)
        n += 1
    torch.cuda.synchronize()
    ck.LAUNCHES = ck.QUERY_LAUNCHES = ck.PACK_LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(RENDERER_TIMED_FRAMES):
        image, lightmap = renderer_frame(renderer, hdr, move, n, shadow_mode,
                                         budget)
        torch.cuda.synchronize()
        n += 1
    ms_per_frame = 1e3 * (time.perf_counter() - t0) / RENDERER_TIMED_FRAMES
    launches = ck.LAUNCHES + ck.QUERY_LAUNCHES + ck.PACK_LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with HostReads() as reads:
        image, lightmap = renderer_frame(renderer, hdr, move, n, shadow_mode,
                                         budget)
    img = image.cpu().numpy()
    lm = lightmap.cpu().numpy()
    if img.shape != (FULL["height"], FULL["width"], 4) or \
            img.dtype != np.uint8:
        raise AssertionError(f"{name}: image {img.shape}/{img.dtype}")
    if not (np.isfinite(lm).all() and img[..., :3].astype(np.float64).var()
            > 0.0):
        raise AssertionError(f"{name}: the frame is flat or not finite")
    if launches:
        raise AssertionError(f"{name}: a column kernel was launched "
                             f"{launches} times; the renderer holds no "
                             "ColumnField")
    gates = (gates_25d(renderer, lm) if name == "slice_renderer"
             else gates_march(renderer, budget))
    say(name, shadow_mode=shadow_mode, budget=budget,
        warmup=RENDERER_WARMUP_FRAMES, frames=RENDERER_TIMED_FRAMES,
        ms_per_frame=f"{ms_per_frame:.3f}", peak_mem_gb=f"{peak_gb:.3f}",
        image_mean=f"{img[..., :3].mean():.3f}",
        image=f"{img.shape}/{img.dtype}", host_reads_per_frame=reads.n,
        column_kernel_launches=launches, **gates)
    return ms_per_frame


def _small_renderer_frames(name, device):
    """Three frames of the small renderer scene on `device` -> the last
    (uint8 image, lightmap, field data or None) as numpy."""
    voxel = RENDERER_FRAMES[name][2] is not None
    renderer, hdr, move, shadow_mode, budget = _build_renderer(
        name, device, **RENDERER_SMALL,
        **({"resolution_scale": 0.5} if voxel else {}))
    for i in range(3):
        image, lightmap = renderer_frame(renderer, hdr, move, i, shadow_mode,
                                         budget)
    data = None if renderer.volume is None else \
        renderer.volume.data.cpu().numpy()
    return image.cpu().numpy().astype(np.int32), lightmap.cpu().numpy(), data


def phase_reference_renderer():
    """Both renderer frames at 96 x 160 on the card against the port's
    plain CPU path (which the CPU tests hold to the JAX package): uint8
    image mean |d| <= 1 LSB and <= 1% of values off by more than 8, the
    lightmap's mean |d| <= 1e-3, the budgeted field within 1e-4."""
    for name in RENDERER_FRAMES:
        cpu = _small_renderer_frames(name, "cpu")
        cuda = _small_renderer_frames(name, "cuda")
        d = np.abs(cuda[0] - cpu[0])
        dl = np.abs(cuda[1] - cpu[1])
        field = None if cpu[2] is None else float(
            np.abs(cuda[2] - cpu[2]).max())
        say("reference_renderer", frame=name,
            size=f"{RENDERER_SMALL['height']}x{RENDERER_SMALL['width']}",
            mean_abs_lsb=f"{d.mean():.4f}",
            share_over_8=f"{(d > 8).mean():.5f}",
            lightmap_mean_abs=f"{dl.mean():.6f}",
            lightmap_max_abs=f"{dl.max():.5f}", field_max_abs=field)
        if not (d.mean() <= 1.0 and (d > 8).mean() <= 0.01
                and dl.mean() <= 1e-3 and (field is None or field <= 1e-4)):
            raise AssertionError(f"reference_renderer ({name}): the card's "
                                 "frame disagrees with the CPU path")


# --- the particle engine's public API -------------------------------------

# BASELINE config 4 (demo.py:344-410) at the flagship's width: the cell
# particles-voxel-1080p. Ticks come from `update(1/60)` at 60 updates a
# second, one a frame; the ring fills after capacity / spawn_max = 256.
PARTICLE_FULL = dict(height=1080, width=1920, capacity=1 << 20,
                     spawn_max=4096)
PARTICLE_TIMED_FRAMES = 8
# The small systems of `reference_particles` and of
# tests/test_torch_particle_system.py.
PARTICLE_SMALL = dict(height=96, width=160, capacity=1 << 10, spawn_max=64)
PARTICLE_TICKS = 10
DT = 1.0 / 60.0


def particle_api(device):
    """The port's classes that the particle systems are built from, by the
    names both packages give them, and `kw`, the device keywords of the
    port's allocating calls. A test passes the JAX package's classes (and
    no keywords) and gets the same systems there."""
    from types import SimpleNamespace

    from illuminant_tpu_torch.lighting.environment import LightObstruction
    from illuminant_tpu_torch.ops import sdf_primitives
    from illuminant_tpu_torch.ops.bezier import pack_bezier
    from illuminant_tpu_torch.particles import formula, spawner, transforms
    from illuminant_tpu_torch.particles import system
    from illuminant_tpu_torch.particles.render_data import RenderDataUniforms
    from illuminant_tpu_torch.sdf.analytic import pack_scene

    return SimpleNamespace(
        ParticleSystem=system.ParticleSystem,
        ParticleSystemConfig=system.ParticleSystemConfig,
        Spawner=spawner.Spawner, FeedbackSpawner=spawner.FeedbackSpawner,
        PatternSpawner=spawner.PatternSpawner, formula=formula,
        tx=transforms, RenderDataUniforms=RenderDataUniforms,
        pack_bezier=pack_bezier, LightObstruction=LightObstruction,
        pack_scene=pack_scene, TYPE_BOX=sdf_primitives.TYPE_BOX,
        kw=dict(device=device))


def _frame_scale(height, width):
    """(s, cx, cy): demo.py's 512 x 512 layouts scaled by s = height / 512
    about the frame centre."""
    return height / 512.0, width * 0.5, height * 0.5


def swirl_field(n=64):
    """Config 4's procedural swirl (demo.py:364-371): unit tangents about
    the field's centre in channels x, y."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    c = n * 0.5
    fx, fy = -(yy - c), xx - c
    norm = np.sqrt(fx * fx + fy * fy) + 1e-3
    field = np.zeros((n, n, 4), np.float32)
    field[..., 0], field[..., 1] = fx / norm, fy / norm
    return field


def config4_obstructions(api, height, width):
    """Config 4's box and ellipsoid (demo.py:373-376), xy scaled."""
    s, cx, cy = _frame_scale(height, width)
    return [api.LightObstruction.box((cx, cy, 24.0), (26.0 * s, 26.0 * s,
                                                      24.0)),
            api.LightObstruction.ellipsoid(
                (cx - 106.0 * s, cy + 74.0 * s, 20.0),
                (30.0 * s, 18.0 * s, 20.0))]


def config2_system(api, height, width, capacity, spawn_max):
    """BASELINE config 2 (demo.py:114-174): two attractors over a ring
    spawner, the plain integrate (no field); rates fill the ring in
    capacity / spawn_max ticks."""
    f = api.formula
    s, cx, cy = _frame_scale(height, width)
    cfg = api.ParticleSystemConfig(
        capacity=capacity, updates_per_second=0.0,
        life_decay_per_second=0.25, friction=0.15,
        maximum_velocity=400.0 * s)
    spawner = api.Spawner(
        min_rate=spawn_max / DT, max_rate=spawn_max / DT,
        life=f.Formula1(constant=4.0, random_scale=1.0, offset=-0.5),
        position=f.Formula3(constant=(cx, cy, 0.0),
                            offset=(60.0 * s, 60.0 * s, 0.0),
                            random_scale=(20.0 * s, 20.0 * s, 0.0),
                            type=f.FORMULA_SPHERICAL),
        velocity=f.Formula3(random_scale=(60.0 * s, 60.0 * s, 0.0),
                            type=f.FORMULA_SPHERICAL),
        color=f.Formula4(constant=(0.1, 0.25, 0.9, 0.6),
                         random_scale=(0.5, 0.3, 0.1, 0.2)),
        spawn_max=spawn_max, axis_mask=(1.0, 1.0, 0.0))
    grav = api.tx.Gravity(attractors=[
        api.tx.Attractor(position=(cx - 106.0 * s, cy - 106.0 * s, 0.0),
                         radius=400.0 * s, strength=220.0 * s,
                         falloff_type=api.tx.FALLOFF_LINEAR),
        api.tx.Attractor(position=(cx + 124.0 * s, cy + 74.0 * s, 0.0),
                         radius=300.0 * s, strength=260.0 * s,
                         falloff_type=api.tx.FALLOFF_EXPONENTIAL),
    ], maximum_acceleration=2000.0 * s)
    rd = api.RenderDataUniforms.defaults(**api.kw).replace(
        color_from_life=api.pack_bezier(
            [[0.0, 0.0, 0.0, 0.0], [1.0, 0.8, 0.5, 1.0]], 0.0, 2.0,
            **api.kw))
    return api.ParticleSystem(cfg, [spawner, grav], render_data=rd,
                              **api.kw)


def config4_system(api, field, height, width, capacity, spawn_max,
                   extra=()):
    """BASELINE config 4 (demo.py:344-410) on `field`: a stochastic-free
    ring spawner filling the ring in capacity / spawn_max ticks, the swirl
    VectorField, a central attractor, the composite scene's Noise
    (demo.py:272), a Sensor over the centre quarter of the frame, then
    `extra` transforms; SDF collision at 3 substeps. -> (system, sensor)."""
    f = api.formula
    s, cx, cy = _frame_scale(height, width)
    cfg = api.ParticleSystemConfig(
        capacity=capacity, updates_per_second=60.0,
        life_decay_per_second=0.4, friction=0.1,
        maximum_velocity=220.0 * s, collision_distance=1.0,
        bounce_velocity_multiplier=0.65, collision_substeps=3)
    spawner = api.Spawner(
        min_rate=spawn_max / DT, max_rate=spawn_max / DT,
        life=f.Formula1(constant=2.5, random_scale=1.0, offset=-0.5),
        position=f.Formula3(constant=(cx, cy, 10.0),
                            offset=(170.0 * s, 170.0 * s, 4.0),
                            random_scale=(30.0 * s, 30.0 * s, 2.0),
                            type=f.FORMULA_SPHERICAL),
        velocity=f.Formula3(random_scale=(30.0 * s, 30.0 * s, 0.0),
                            type=f.FORMULA_SPHERICAL),
        color=f.Formula4(constant=(0.3, 0.8, 1.0, 0.5),
                         random_scale=(0.4, 0.2, 0.0, 0.3)),
        spawn_max=spawn_max)
    vf = api.tx.VectorField(
        field=swirl_field(), field_scale=(64.0 / height,) * 2,
        velocity_scale=(160.0 * s, 160.0 * s, 0.0, 0.0),
        cycles_per_second=3.0)
    grav = api.tx.Gravity(attractors=[api.tx.Attractor(
        position=(cx, cy, 10.0), radius=600.0 * s, strength=60.0 * s,
        falloff_type=api.tx.FALLOFF_LINEAR)])
    noise = api.tx.Noise(velocity_scale=(18.0 * s, 18.0 * s, 3.0, 0.0),
                         cycles_per_second=4.0,
                         _rng=np.random.default_rng(1))
    sensor = api.tx.Sensor(area=api.tx.TransformArea(
        type=api.TYPE_BOX, center=(cx, cy, 0.0),
        size=(width * 0.25, height * 0.25, 1e4)))
    system = api.ParticleSystem(cfg, [spawner, vf, grav, noise, sensor,
                                      *extra], volume=field, **api.kw)
    return system, sensor


def column_transforms(api, height, width):
    """Every other modifier, for the ColumnField system: spatial noise,
    an FMA drag inside a box, a MatrixMultiply and a GeometricTransform
    turning velocities."""
    s, cx, cy = _frame_scale(height, width)
    c, n = math.cos(0.02), math.sin(0.02)
    turn = np.asarray([[c, n, 0, 0], [-n, c, 0, 0], [0, 0, 1, 0],
                       [0, 0, 0, 1]], np.float32)
    return [
        api.tx.spatial_noise(velocity_scale=(12.0 * s, 12.0 * s, 0.0, 0.0),
                             space_scale=(24.0 * s, 24.0 * s),
                             cycles_per_second=2.0, interval_seconds=0.1,
                             _rng=np.random.default_rng(2)),
        api.tx.FMA(velocity_multiply=(0.5, 0.5, 1.0), cycles_per_second=2.0,
                   area=api.tx.TransformArea(
                       type=api.TYPE_BOX, center=(cx + 60.0 * s, cy, 0.0),
                       size=(50.0 * s, 50.0 * s, 100.0), falloff=8.0)),
        api.tx.MatrixMultiply(velocity_matrix=turn, cycles_per_second=None),
        api.tx.GeometricTransform(velocity_rotation=(0.0, 0.0, -0.03),
                                  velocity_scale=1.01,
                                  cycles_per_second=None),
    ]


def pattern_feedback_systems(api, height, width, capacity):
    """demo.py:507-568 at the frame: a PatternSpawner stamps a ring
    texture; a FeedbackSpawner re-emits sparks from its live particles.
    Both spawners keep the default spawn_max of 8192, over the capacity
    of a small system. -> (source, feedback)."""
    f = api.formula
    s, cx, cy = _frame_scale(height, width)
    n = max(int(height * 0.25), 8)
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    rr = np.sqrt(ys ** 2 + xs ** 2)
    pat = np.zeros((n, n, 4), np.float32)
    pat[(rr > 0.55) & (rr < 0.9)] = [0.9, 0.6, 1.4, 1.0]
    src = api.ParticleSystem(
        api.ParticleSystemConfig(capacity=capacity, updates_per_second=0.0,
                                 life_decay_per_second=0.4),
        [api.PatternSpawner(image=pat, pixel_scale=2.0,
                            position=f.Formula3(constant=(cx - n, cy - n,
                                                          0.0)),
                            min_rate=5000.0, max_rate=5000.0,
                            life=f.Formula1(constant=3.0))], **api.kw)
    feedback = api.FeedbackSpawner(
        source=src, min_rate=3000.0, max_rate=3000.0,
        velocity=f.Formula3(random_scale=(30.0 * s, 30.0 * s, 0.0),
                            type=f.FORMULA_SPHERICAL))
    grav = api.tx.Gravity(attractors=[api.tx.Attractor(
        position=(cx, cy + 100.0 * s, 0.0), radius=300.0 * s,
        strength=60.0 * s, falloff_type=api.tx.FALLOFF_LINEAR)])
    fb = api.ParticleSystem(
        api.ParticleSystemConfig(capacity=capacity, updates_per_second=0.0,
                                 life_decay_per_second=1.2),
        [feedback, grav], **api.kw)
    return src, fb


def small_column_field(api, height, width, device):
    """The port's ColumnField of config 4's obstructions on a
    (height, width) frame: 16 slices at half resolution."""
    from illuminant_tpu_torch.lighting.environment import LightingEnvironment
    from illuminant_tpu_torch.sdf.columns import build_column_maps
    from illuminant_tpu_torch.sdf.volume import (SdfVolumeConfig,
                                                 generate_volume)

    env = LightingEnvironment()
    env.obstructions += config4_obstructions(api, height, width)
    cfg = SdfVolumeConfig(virtual_width=width, virtual_height=height,
                          virtual_depth=64, slice_count=16,
                          resolution_scale=0.5)
    return build_column_maps(generate_volume(
        cfg, env.pack_obstructions(device=device)))


def spawn_draws(systems, ticks, seed=0):
    """Per tick, per system, one triple of (spawn_max, 4) uniforms per
    spawner, made on the host from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [[[tuple(rng.random((s.spawn_max, 4), dtype=np.float32)
                    for _ in range(3)) for s in system.spawners]
             for system in systems] for _ in range(ticks)]


def small_particle_systems(name, device):
    """The systems of `reference_particles` case `name` on `device`, in
    tick order."""
    api = particle_api(device)
    h, w, cap, smax = (PARTICLE_SMALL[k] for k in
                       ("height", "width", "capacity", "spawn_max"))
    if name == "config2":
        return [config2_system(api, h, w, cap, smax)]
    if name == "config4_analytic":
        field = api.pack_scene(config4_obstructions(api, h, w), **api.kw)
        return [config4_system(api, field, h, w, cap, smax)[0]]
    if name == "column_field":
        field = small_column_field(api, h, w, device)
        return [config4_system(api, field, h, w, cap, smax,
                               extra=column_transforms(api, h, w))[0]]
    return list(pattern_feedback_systems(api, h, w, cap))


def run_small_particles(name, device, draws, random_fields=None):
    """PARTICLE_TICKS ticks of case `name` on `device` with the given
    draws -> (systems, the sum of their rendered images as numpy, the
    fused-query launches). `random_fields`: the Noise fields to use, one a
    system (a device's generator draws its own)."""
    from illuminant_tpu_torch.ops.noise import RandomField
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    systems = small_particle_systems(name, device)
    for system, field in zip(systems, random_fields or ()):
        system.random_field = RandomField(data=field.to(device))
    ck.QUERY_LAUNCHES = 0
    for tick in draws:
        for system, d in zip(systems, tick):
            system.tick(DT, spawn_uniforms=d)
    launches = ck.QUERY_LAUNCHES
    cfg = TiledRasterConfig(height=PARTICLE_SMALL["height"],
                            width=PARTICLE_SMALL["width"])
    img = sum(s.render(cfg)[0] for s in systems)
    return systems, img.cpu().numpy(), launches


PARTICLE_CASES = ("config2", "config4_analytic", "column_field",
                  "pattern_feedback")


def phase_reference_particles():
    """The small systems on the card against the port's CPU path (which
    the CPU tests hold to the JAX package), 10 ticks from the same host
    draws and the CPU systems' Noise fields: equal live masks, 99% of
    live particles within 1e-3 and all within 0.05 (a particle within the
    float rounding of a collision threshold may resolve the other way on
    the card), images within 1% of
    their mean. The ColumnField case launches the fused query 5 times a
    tick."""
    for name in PARTICLE_CASES:
        probe = small_particle_systems(name, "cpu")
        draws = spawn_draws(probe, PARTICLE_TICKS)
        cpu, img_c, _ = run_small_particles(name, "cpu", draws)
        cuda, img_g, launches = run_small_particles(
            name, "cuda", draws, [s.random_field.data for s in cpu])
        same_live, within, within_1e3 = True, 1.0, 1.0
        for a, b in zip(cpu, cuda):
            pa, pb = a.state.position.numpy(), b.state.position.cpu().numpy()
            live = pa[:, 3] > 0
            same_live &= bool(np.array_equal(live, pb[:, 3] > 0))
            err = np.abs(pa[live] - pb[live]).max(axis=1)
            within = min(within, float((err <= 0.05).mean()))
            within_1e3 = min(within_1e3, float((err <= 1e-3).mean()))
        img_err = float(np.abs(img_g - img_c).mean()
                        / max(np.abs(img_c).mean(), 1e-12))
        live = sum(s.live_count for s in cpu)
        say("reference_particles", case=name,
            size=f"{PARTICLE_SMALL['height']}x{PARTICLE_SMALL['width']}",
            ticks=PARTICLE_TICKS, live=live, same_live=same_live,
            particles_within_0p05=within, particles_within_1e3=within_1e3,
            image_mean_rel_err=f"{img_err:.2e}",
            column_query_launches=launches)
        expected = 5 * PARTICLE_TICKS if name == "column_field" else 0
        if not (live > 0 and same_live and within == 1.0
                and within_1e3 >= 0.99 and img_err <= 0.01):
            raise AssertionError(f"reference_particles ({name}): the card's "
                                 "systems disagree with the CPU path")
        if launches != expected:
            raise AssertionError(f"reference_particles ({name}): the fused "
                                 f"query launched {launches} times in "
                                 f"{PARTICLE_TICKS} ticks, expected "
                                 f"{expected}")


def _sensor_direct_count(sensor, state):
    """The live particles (life > 1) whose box distance to the sensor's
    area is below 0.99 (weight > 0.01 at falloff 1), counted on the host
    in float64, and how many lie within 1e-3 of that edge."""
    a = sensor.area
    p = state.position.cpu().numpy().astype(np.float64)
    q = np.abs(p[:, :3] - np.asarray(a.center)) - np.asarray(a.size)
    d = (np.linalg.norm(np.maximum(q, 0.0), axis=1)
         + np.minimum(q.max(axis=1), 0.0))
    live = p[:, 3] > 1.0
    return (int((live & (d < 0.99)).sum()),
            int((live & (np.abs(d - 0.99) < 1e-3)).sum()))


def particle_frame(system, raster, hdr):
    """One frame of the particle cell: a tick through `update`, the
    additive render, the resolve, the uint8 image."""
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8

    system.update(DT)
    img, _ = system.render(raster)
    return to_uint8(resolve(img, hdr))


def _particle_cell(field, warmup):
    """The particles-voxel-1080p system after `warmup` frames, its raster
    config and its resolve."""
    from illuminant_tpu_torch.core.config import HDRConfig
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    api = particle_api(torch.device("cuda"))
    system, sensor = config4_system(api, field, **PARTICLE_FULL)
    raster = TiledRasterConfig(height=PARTICLE_FULL["height"],
                               width=PARTICLE_FULL["width"])
    hdr = HDRConfig(mode=2, exposure=2.2, white_point=3.0, srgb_output=True)
    for _ in range(warmup):
        particle_frame(system, raster, hdr)
    torch.cuda.synchronize()
    return system, sensor, raster, hdr


def phase_slice_particles(field, warmup: int):
    """The particle cell at full width: `warmup` frames, then the timed
    frames, each fenced by a synchronize, with CUDA events splitting the
    tick from the render; then one more tick under the host-read counter,
    and the gates. Returns (launches, ms_per_frame)."""
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8
    from illuminant_tpu_torch.sdf import columns_kernel as ck
    from illuminant_tpu_torch.sdf.analytic import scene_sample_p

    torch.cuda.reset_peak_memory_stats()
    system, sensor, raster, hdr = _particle_cell(field, warmup)
    ck.LAUNCHES = ck.QUERY_LAUNCHES = ck.PACK_LAUNCHES = 0
    tick_ms, render_ms = [], []
    t0 = time.perf_counter()
    for _ in range(PARTICLE_TIMED_FRAMES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        system.update(DT)
        ev[1].record()
        img, _ = system.render(raster)
        image = to_uint8(resolve(img, hdr))
        ev[2].record()
        torch.cuda.synchronize()
        tick_ms.append(ev[0].elapsed_time(ev[1]))
        render_ms.append(ev[1].elapsed_time(ev[2]))
    ms_per_frame = 1e3 * (time.perf_counter() - t0) / PARTICLE_TIMED_FRAMES
    launches = dict(column_query=ck.QUERY_LAUNCHES,
                    column_maps_pack=ck.PACK_LAUNCHES,
                    column_maps_sample=ck.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with HostReads() as reads:
        system.update(DT)
    torch.cuda.synchronize()
    state = system.state
    live = system.live_count
    inside = sensor.measure(state)
    direct, edge = _sensor_direct_count(sensor, state)
    pos = state.position
    alive = pos[:, 3] > 0
    d = scene_sample_p(field, pos[:, 0], pos[:, 1], pos[:, 2])
    deep = float(((d < -system.config.collision_distance) & alive).sum()
                 / max(live, 1))
    img_np = image.cpu().numpy()
    say("slice_particles", cell="particles-voxel-1080p", warmup=warmup,
        frames=PARTICLE_TIMED_FRAMES, ms_per_frame=f"{ms_per_frame:.3f}",
        tick_ms=f"{sum(tick_ms) / len(tick_ms):.3f}",
        render_ms=f"{sum(render_ms) / len(render_ms):.3f}",
        live_particles=live, peak_mem_gb=f"{peak_gb:.3f}",
        image=f"{img_np.shape}/{img_np.dtype}",
        image_mean=f"{img_np[..., :3].mean():.3f}",
        column_query_per_tick=launches["column_query"]
        / PARTICLE_TIMED_FRAMES,
        column_maps_pack_per_tick=launches["column_maps_pack"]
        / PARTICLE_TIMED_FRAMES,
        column_maps_sample_launches=launches["column_maps_sample"],
        host_reads_per_tick=reads.n, sensor=inside, sensor_direct=direct,
        sensor_edge=edge, deeper_than_collision_distance=f"{deep:.5f}")
    if img_np.shape != (PARTICLE_FULL["height"], PARTICLE_FULL["width"], 4) \
            or img_np.dtype != np.uint8:
        raise AssertionError(f"slice_particles: image {img_np.shape}")
    if not (bool(torch.isfinite(img).all())
            and img_np[..., :3].astype(np.float64).var() > 0.0):
        raise AssertionError("slice_particles: the frame is flat or not "
                             "finite")
    if not live > 0:
        raise AssertionError("slice_particles: no live particles")
    full = PARTICLE_FULL["capacity"]
    if warmup >= full // PARTICLE_FULL["spawn_max"] and live != full:
        raise AssertionError(f"slice_particles: {live} live particles after "
                             f"the ring filled, expected {full}")
    expected = dict(column_query=5 * PARTICLE_TIMED_FRAMES,
                    column_maps_pack=5 * PARTICLE_TIMED_FRAMES,
                    column_maps_sample=0)
    if launches != expected:
        raise AssertionError(f"slice_particles: column kernels launched "
                             f"{launches} times in {PARTICLE_TIMED_FRAMES} "
                             f"ticks, expected {expected}")
    if abs(inside - direct) > edge:
        raise AssertionError(f"slice_particles: the sensor counted {inside}, "
                             f"a direct count {direct} (+-{edge})")
    if reads.n:
        raise AssertionError(f"slice_particles: a tick read the device "
                             f"{reads.n} times")
    return launches, ms_per_frame


def phase_profile_particles(field, warmup, frame_ms, out_dir):
    """Two traced frames of the particle cell, on a system built anew and
    run through the same warm-up and timed frames: the tables, the busy
    time, the idle share and the host reads per frame (each frame one
    tick) as in `phase_profile`."""
    system, _, raster, hdr = _particle_cell(
        field, warmup + PARTICLE_TIMED_FRAMES + 1)

    def two_frames():
        for _ in range(2):
            particle_frame(system, raster, hdr)
            torch.cuda.synchronize()

    _traced("slice_particles", out_dir, frame_ms, two_frames)


# --- the particle render's sprite and alpha routes --------------------------

# The cell particles-alpha-sprites-1080p: BASELINE config 4 (demo.py:
# 344-410) at 1080 x 1920 on the voxel slice's ColumnField, cut to 1<<17
# slots and 512 spawns a tick (the ring fills after 256 ticks), drawn as
# demo.py:650-702 draws its leaves: textured, depth-ordered alpha over a lit
# floor. `slice_additive_sprites` draws the same system additively (the
# textured additive route of demo.py:614-647).
SPRITE_FULL = dict(height=1080, width=1920, capacity=1 << 17, spawn_max=512)
SPRITE_TIMED_FRAMES = 8
SPRITE_WARMUP_FRAMES = 2
# Not a whole number of 32-px tiles: the last row and column of tiles are
# partial, so the kernels' edge guard runs.
SPRITE_SMALL = dict(height=90, width=150)


def leaf_texture(n=24):
    """demo.py:661-664's leaf: a soft rounded diamond."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    return (np.clip(1.0 - (np.abs(xs) ** 1.5 + np.abs(ys * 1.6) ** 1.5),
                    0, 1) ** 0.8).astype(np.float32)


# One object: an appearance keys its sprite table on the texture's id.
LEAF = leaf_texture()


def lit_floor(height, width, device):
    """demo.py:694-697's lit floor (H, W, 4), its 256 x 256 layout scaled
    by s = height / 256 about the frame's centre."""
    s = height / 256.0
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    lum = 0.2 + 0.5 * np.exp(-((xx - width * 0.5) ** 2
                               + (yy - 110.0 * s) ** 2) / (7000.0 * s * s))
    bg = np.stack([lum] * 3 + [np.ones_like(lum)], -1).astype(np.float32)
    return torch.as_tensor(bg, device=device)


def sprite_appearance(**kw):
    """demo.py:665-666's appearance of the leaves (the port's class)."""
    from illuminant_tpu_torch.raster.render import ParticleAppearance

    return ParticleAppearance(**{**dict(texture=LEAF, angle_bins=8, rank=4,
                                        size_bins=4, size_min=8.0,
                                        size_max=18.0), **kw})


class KernelInputs:
    """Inside it, the arguments and result of the last call of the kernel
    wrapper `name` (the tile kernels' `composite_over_tiles`,
    `sprite_accumulate`, or a wrapper of `module`) are kept as .args and
    .out; the wrapper still runs and counts as before."""

    def __init__(self, name, module=None):
        self.name, self.args, self.out = name, None, None
        self._mod = module

    def __enter__(self):
        if self._mod is None:
            from illuminant_tpu_torch.raster import tile_kernel

            self._mod = tile_kernel
        self._orig = getattr(self._mod, self.name)

        def spy(*args, **kwargs):
            self.args, self.out = args, self._orig(*args, **kwargs)
            self.kwargs = kwargs
            return self.out

        setattr(self._mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.name, self._orig)


def eager_ms(fn, reps: int) -> float:
    """Device time of one fn() call run eagerly: CUDA events around `reps`
    calls after one warm-up call. For plain versions, whose host reads
    keep them out of a CUDA graph; the host's pacing is in it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _plain(name):
    from illuminant_tpu_torch.raster import tile_kernel as tk

    return {"composite_over_tiles": tk.composite_over_tiles_reference,
            "sprite_accumulate": tk.sprite_accumulate_reference}[name]


def kernel_work(name, args):
    """(bytes, operations) the call `args` of kernel `name` needs: each
    input read once and the image written once; the operations of the
    (particle, pixel) pairs that its data makes nonzero (the rows x
    columns of each listed particle's footprint: its profile's reach or
    its sprite variant's nonzero taps, clipped to the tile for the
    composite, to the particle's own tile's window and to the image for
    the additive splat) and of the factors on those rows and columns."""
    cfg, (ids, starts), records = args[:3]
    gy, gx = cfg.grid
    t, a = cfg.tile, cfg.apron
    n = int(starts[-1])
    accumulate = name == "sprite_accumulate"
    sprite = accumulate or not isinstance(args[3], str)
    table = args[3] if sprite else None
    ranks = table[0].shape[1] if sprite else 1
    support = table[0].shape[2] if sprite else 0
    ch = cfg.channels if accumulate else 4
    background = None if accumulate else args[4]
    nbytes = 4.0 * (records.numel() + n + starts.numel()
                    + (2 * table[0].numel() if sprite else 0)
                    + cfg.height * cfg.width * ch
                    * (2 if background is not None else 1))
    ids = ids[:n].long()
    tile = torch.searchsorted(starts[1:].long(),
                              torch.arange(n, device=ids.device), right=True)
    org = torch.stack([tile % gx, tile // gx], dim=1).float() * t
    c = records[ids, :2] - org  # tile-local centres (x, y)
    if sprite:
        # Each variant's first and last nonzero tap, columns then rows: a
        # window position is reached by its two lerp taps s - 1 and s.
        nz = [(f != 0).any(dim=1).float() for f in (table[1], table[0])]
        first = torch.stack([z.argmax(dim=1) for z in nz], dim=1)
        last = support - 1 - torch.stack([z.flip(1).argmax(dim=1)
                                          for z in nz], dim=1)
        b = records[ids, 7].long().clamp(0, table[0].shape[0] - 1)
        fl = torch.floor((c + a) - 0.5)
        lo = fl + first[b] - support // 2 - a
        hi = fl + last[b] + 1 - support // 2 - a
    else:
        r = records[ids, 6:7]
        reach = (torch.clamp(r * 0.5, min=0.3) * 4.0 if args[3] == "gauss"
                 else r + 0.5)
        lo, hi = torch.ceil(c - reach - 0.5), torch.floor(c + reach - 0.5)
    if accumulate:
        extent = torch.tensor([cfg.width, cfg.height], device=org.device)
        lo = torch.maximum(torch.clamp(lo, min=-a), -org)
        hi = torch.minimum(torch.clamp(hi, max=t - 1 + a), extent - 1 - org)
        per_pair = 2 * ranks - 1 + 2 * ch
    else:
        lo, hi = torch.clamp(lo, min=0), torch.clamp(hi, max=t - 1)
        per_pair = 2 * ranks - 1 + (2 if sprite else 0) + 1 + 12
    span = torch.clamp(hi - lo + 1, min=0)  # (n, 2): footprint columns, rows
    ops = (float(span.prod(dim=1).sum()) * per_pair
           + float(span.sum()) * (6 * ranks + 8))
    return nbytes, ops


def entry_stats(starts) -> dict:
    """Mean, p99 and maximum entries of the tiles' lists."""
    counts = (starts[1:] - starts[:-1]).float()
    return dict(entries_mean=f"{float(counts.mean()):.1f}",
                entries_p99=f"{float(torch.quantile(counts, 0.99)):.0f}",
                entries_max=int(counts.max()))


def block_plan(name, args) -> dict:
    """The launch the call makes on this card: its block and how many of
    them an SM holds."""
    from illuminant_tpu_torch.raster import tile_kernel as tk

    coverage = args[3]
    sprite = not isinstance(coverage, str)
    plan = tk.launch_plan(name == "sprite_accumulate", args[0].tile,
                          coverage[0].shape[1] if sprite else 1,
                          2 * coverage[0].numel() if sprite else 0)
    return dict(threads=plan["threads"], chunk=plan["chunk"],
                smem_bytes=plan["smem_bytes"],
                table_in_smem=plan["table_floats"] > 0,
                blocks_per_sm=plan["blocks_per_sm"],
                registers=plan["registers"], spill_bytes=plan["spill_bytes"])


def parent_module(root, name):
    """Module `name` (e.g. "raster.tile_kernel") of the port in another
    checkout at `root` (an earlier commit unpacked with `git archive`),
    imported as a package of its own beside this one; its kernel library
    is built from its own source into root/build/."""
    import importlib
    import importlib.util

    pkg_name = "parent_illuminant_tpu_torch"
    if pkg_name not in sys.modules:
        pkg = os.path.join(os.path.abspath(root), "illuminant_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            pkg_name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[pkg_name] = mod
        spec.loader.exec_module(mod)
    mod = importlib.import_module(f"{pkg_name}.{name}")
    t0 = time.perf_counter()
    mod.build()
    say("build", kernel=f"parent {name}", root=json.dumps(root),
        seconds=f"{time.perf_counter() - t0:.2f}")
    return mod


def _sprite_kernel_row(rec, key, name, args, tol, parent=None, **fields):
    """Check one recorded call of kernel `name` against its plain version
    on the same inputs, time both and print the [kernel] line with the
    launch's block. With `parent` (`parent_module`), the earlier
    commit's kernel is checked and timed on the same inputs too, in turns
    with this one (parent, this, this, parent)."""
    from illuminant_tpu_torch.raster import tile_kernel as tk

    kernel, plain = getattr(tk, name), _plain(name)
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    _require(name, err, tol, **fields)
    nbytes, ops = kernel_work(name, args)
    bound_ms, bound_by = _bound(nbytes, ops)
    call = lambda: kernel(*args)  # noqa: E731
    before = {}
    if parent is not None:
        old = getattr(parent, name)
        _require("parent " + name, _max_err(old(*args), ref), tol, **fields)
        old_call = lambda: old(*args)  # noqa: E731
        times = [device_ms(f, KERNEL_REPS)
                 for f in (old_call, call, call, old_call)]
        ms, old_ms = min(times[1:3]), min(times[0], times[3])
        before = dict(parent_ms=f"{old_ms:.4f}",
                      parent_share_of_bound=f"{bound_ms / old_ms:.3f}",
                      turns=json.dumps([round(v, 4) for v in times]))
    else:
        ms = device_ms(call, KERNEL_REPS)
    plain_ms = eager_ms(lambda: plain(*args), 1)
    say("kernel", name=name, **fields, max_abs_err=err, tol=tol,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / ms:.3f}", bytes=int(nbytes),
        operations=int(ops), **before, **block_plan(name, args))
    rec[key] = dict(ms=ms, plain_ms=plain_ms, err=err,
                    bound=(bound_ms, bound_by), library_ms=None)


def hottest_tile(args):
    """The composite's call `args` with every list emptied but the
    fullest."""
    cfg, (ids, starts) = args[:2]
    counts = starts[1:] - starts[:-1]
    hot = int(torch.argmax(counts))
    first, end = int(starts[hot]), int(starts[hot + 1])
    kept = torch.arange(starts.shape[0], device=starts.device) > hot
    hot_starts = (kept.to(torch.int32) * (end - first)).to(torch.int32)
    return (cfg, (ids[first:end].contiguous(), hot_starts), *args[2:])


def _add_tolerance(ref) -> float:
    """The additive splat's bound against its plain scatter: float32
    reordering of each pixel's sum, 1e-5 of (1 + the image's largest
    value)."""
    return 1e-5 * (1.0 + float(ref.abs().max()))


def steady_sprites(device, seed=0, height=SPRITE_FULL["height"],
                   width=SPRITE_FULL["width"], n=SPRITE_FULL["capacity"]):
    """131,072 particles as the cell holds them once its ring has filled
    (--warmup 260): a ring of radius 170 s about the centre (s = height /
    512) spread by 45 s and the swirl, sizes 8-18 px, leaf colours of
    opacity 0.5-0.8, every rotation, made from a seed on the card. Other
    frame sizes scale the ring; `n` particles."""
    h, w = height, width
    s = h / 512.0
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, device=device, generator=g)

    ang = u(n) * (2.0 * math.pi)
    rad = 170.0 * s + torch.randn(n, device=device, generator=g) * 45.0 * s
    x = w * 0.5 + rad * torch.cos(ang)
    y = h * 0.5 + rad * torch.sin(ang)
    a = 0.5 + 0.3 * u(n)
    color = torch.stack([0.3 * a, 0.8 * a, 1.0 * a, a], dim=1)
    return (x, y, color, 8.0 + 10.0 * u(n), torch.ones(n, dtype=torch.bool,
                                                       device=device),
            u(n) * (2.0 * math.pi))


def phase_sprite_kernels(device="cuda", parent=None):
    """K11a and K11b at the cell's shapes (1080 x 1920, apron 9, the
    leaf table, 131,072 steady particles) through the routes that call
    them: each against its plain version on the same inputs, both timed,
    beside the bound, with the lists' entries per tile and the block the
    launch takes. The composite also with the untextured quad and on the
    fullest tile's list alone (the floor of compositing in order); the
    splat with the particles its blocks stage before and after the
    neighbour filter. `parent`: an earlier commit's tile-kernel module,
    timed on the same inputs (`parent_module`)."""
    from illuminant_tpu_torch.raster import sprites, tiled
    from illuminant_tpu_torch.raster import tile_kernel as tk

    x, y, color, size, live, rot = steady_sprites(device)
    table = sprite_appearance().sprite_table(device)
    cfg = tiled.TiledRasterConfig(height=SPRITE_FULL["height"],
                                  width=SPRITE_FULL["width"], apron=9)
    bg = lit_floor(cfg.height, cfg.width, device)
    rec = {}
    with KernelInputs("composite_over_tiles") as spy:
        sprites.rasterize_sprites_alpha(cfg, table, x, y, color, size, live,
                                        rotation=rot, background=bg)
    sprite_args = spy.args
    _sprite_kernel_row(rec, "composite", "composite_over_tiles", sprite_args,
                       0.0, parent, coverage="sprite", inputs="steady",
                       particles=x.shape[0],
                       entries=int(sprite_args[1][1][-1]),
                       **entry_stats(sprite_args[1][1]))
    hot = hottest_tile(sprite_args)
    _sprite_kernel_row(rec, "composite_hot", "composite_over_tiles", hot,
                       0.0, parent, coverage="sprite",
                       inputs="hottest_tile", entries=int(hot[1][1][-1]))
    route_ms = eager_ms(lambda: sprites.rasterize_sprites_alpha(
        cfg, table, x, y, color, size, live, rotation=rot, background=bg),
        20)
    say("kernel", name="rasterize_sprites_alpha", inputs="steady",
        route_ms=f"{route_ms:.4f}", note="the route: bins, records, K11a")
    with KernelInputs("composite_over_tiles") as spy:
        tiled.rasterize_tiled_alpha(dataclasses.replace(cfg, kernel="quad"),
                                    x, y, color, size, live, background=bg)
    quad_args = spy.args
    _sprite_kernel_row(rec, "composite_quad", "composite_over_tiles",
                       quad_args, 0.0, parent, coverage="quad",
                       inputs="steady", particles=x.shape[0],
                       entries=int(quad_args[1][1][-1]),
                       **entry_stats(quad_args[1][1]))
    with KernelInputs("sprite_accumulate") as spy:
        sprites.rasterize_sprites(cfg, table, x, y, color, size, live,
                                  rotation=rot)
    # The particles a block stages, by the filter's plain mirror; the
    # kernel's own kept lists, read back from its scratch, must equal it.
    want, kept_starts, listed = tk.accumulate_filter_reference(
        cfg, spy.args[1], spy.args[2], table.support)
    got, got_starts, _ = tk.accumulate_kept(*spy.args[:4])
    if not (torch.equal(got, want.cpu())
            and torch.equal(got_starts, kept_starts.cpu())):
        raise AssertionError("sprite_accumulate: the kernel's filter kept "
                             "other entries than its mirror")
    kept = (kept_starts[1:] - kept_starts[:-1]).float()
    staged = dict(
        mirror_staged_mean_unfiltered=f"{float(listed.float().mean()):.1f}",
        mirror_staged_mean=f"{float(kept.mean()):.1f}",
        mirror_staged_max=int(kept.max()), kernel_kept_equals_mirror=True)
    _sprite_kernel_row(rec, "accumulate", "sprite_accumulate", spy.args,
                       _add_tolerance(spy.out), parent, inputs="steady",
                       particles=x.shape[0],
                       entries=int(spy.args[1][1][-1]),
                       **entry_stats(spy.args[1][1]), **staged)
    return rec


def sprite_cell(field, warmup, additive, device="cuda"):
    """The particles-alpha-sprites-1080p system after `warmup` frames:
    (system, raster config, resolve, render keywords). Sizes run 18 -> 8
    px through a size_from_life ramp over life 3 -> 0.8; rotation turns
    with life and slot index."""
    from illuminant_tpu_torch.core.config import HDRConfig
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    api = particle_api(torch.device(device))
    system, _ = config4_system(api, field, **SPRITE_FULL)
    system.patch(render_data=api.RenderDataUniforms.defaults(**api.kw).replace(
        size_from_life=api.pack_bezier([[8.0], [18.0]], 0.8, 3.0, **api.kw),
        rotation_from_life_and_index=torch.tensor([1.5, 0.37],
                                                  device=device)))
    raster = TiledRasterConfig(height=SPRITE_FULL["height"],
                               width=SPRITE_FULL["width"], apron=9)
    hdr = HDRConfig(mode=2, exposure=2.2, white_point=3.0, srgb_output=True)
    kw = dict(appearance=sprite_appearance(), additive_blend=additive,
              z_formula=(0.0, 0.0, 1.0, 0.0),
              background=lit_floor(raster.height, raster.width, device))
    for _ in range(warmup):
        sprite_frame(system, raster, hdr, kw)
    torch.cuda.synchronize()
    return system, raster, hdr, kw


def sprite_frame(system, raster, hdr, kw):
    """One frame of a sprite cell: a tick through `update`, the render,
    the resolve, the uint8 image -> (image, the render's HDR image)."""
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8

    system.update(DT)
    img, _ = system.render(raster, **kw)
    return to_uint8(resolve(img, hdr)), img


def phase_slice_sprites(field, warmup: int, additive: bool, kernel_rec,
                        device="cuda"):
    """A sprite cell at full width: `warmup` frames, the timed frames
    (each fenced by a synchronize; CUDA events split tick and render),
    then one frame under the host-read counter whose kernel call is
    checked against its plain version, and the gates. Returns (launches,
    ms_per_frame)."""
    from illuminant_tpu_torch.raster import tile_kernel as tk
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    name = "slice_additive_sprites" if additive else "slice_alpha_sprites"
    kernel = "sprite_accumulate" if additive else "composite_over_tiles"
    torch.cuda.reset_peak_memory_stats()
    system, raster, hdr, kw = sprite_cell(field, warmup, additive, device)
    tk.COMPOSITE_LAUNCHES = tk.ACCUMULATE_LAUNCHES = 0
    ck.LAUNCHES = ck.QUERY_LAUNCHES = ck.PACK_LAUNCHES = 0
    tick_ms, render_ms = [], []
    t0 = time.perf_counter()
    for _ in range(SPRITE_TIMED_FRAMES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        system.update(DT)
        ev[1].record()
        img, _ = system.render(raster, **kw)
        image = to_uint8(resolve(img, hdr))
        ev[2].record()
        torch.cuda.synchronize()
        tick_ms.append(ev[0].elapsed_time(ev[1]))
        render_ms.append(ev[1].elapsed_time(ev[2]))
    ms_per_frame = 1e3 * (time.perf_counter() - t0) / SPRITE_TIMED_FRAMES
    launches = dict(composite_over_tiles=tk.COMPOSITE_LAUNCHES,
                    sprite_accumulate=tk.ACCUMULATE_LAUNCHES,
                    column_query=ck.QUERY_LAUNCHES,
                    column_maps_pack=ck.PACK_LAUNCHES,
                    column_maps_sample=ck.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with HostReads() as tick_reads:
        system.update(DT)
    with HostReads() as render_reads, KernelInputs(kernel) as spy:
        img, _ = system.render(raster, **kw)
        image = to_uint8(resolve(img, hdr))
    torch.cuda.synchronize()
    live = system.live_count
    tol = _add_tolerance(spy.out) if additive else 0.0
    err = _max_err(spy.out, _plain(kernel)(*spy.args))
    alpha_max = None
    if not additive:
        bare, _ = system.render(raster, **{**kw, "background": None})
        alpha_max = float(bare[..., 3].max())
        _sprite_kernel_row(kernel_rec, "composite_frame", kernel, spy.args,
                           tol, coverage="sprite", inputs="frame",
                           live=live, entries=int(spy.args[1][1][-1]),
                           **entry_stats(spy.args[1][1]))
    img_np = image.cpu().numpy()
    say(name, cell="particles-alpha-sprites-1080p" if not additive
        else "particles-additive-sprites-1080p", warmup=warmup,
        frames=SPRITE_TIMED_FRAMES, ms_per_frame=f"{ms_per_frame:.3f}",
        tick_ms=f"{sum(tick_ms) / len(tick_ms):.3f}",
        render_ms=f"{sum(render_ms) / len(render_ms):.3f}",
        live_particles=live, peak_mem_gb=f"{peak_gb:.3f}",
        image=f"{img_np.shape}/{img_np.dtype}",
        image_mean=f"{img_np[..., :3].mean():.3f}",
        **{f"{k}_launches": v for k, v in launches.items()},
        host_reads_per_tick=tick_reads.n,
        host_reads_per_render=render_reads.n, max_alpha=alpha_max,
        kernel_vs_plain_max_abs_err=err, tol=tol)
    expected = dict(composite_over_tiles=0 if additive
                    else SPRITE_TIMED_FRAMES,
                    sprite_accumulate=SPRITE_TIMED_FRAMES if additive else 0)
    got = {k: launches[k] for k in expected}
    if got != expected:
        raise AssertionError(f"{name}: tile kernels launched {got} times in "
                             f"{SPRITE_TIMED_FRAMES} renders, expected "
                             f"{expected}")
    if tick_reads.n or render_reads.n:
        raise AssertionError(f"{name}: {tick_reads.n} host reads in a tick, "
                             f"{render_reads.n} in a render; expected 0")
    if alpha_max is not None and not alpha_max <= 1.0 + 1e-5:
        raise AssertionError(f"{name}: accumulated alpha {alpha_max} > 1")
    if not (bool(torch.isfinite(img).all())
            and img_np[..., :3].astype(np.float64).var() > 0.0
            and img_np.shape == (SPRITE_FULL["height"],
                                 SPRITE_FULL["width"], 4)):
        raise AssertionError(f"{name}: the frame is flat or not finite")
    if not live > 0:
        raise AssertionError(f"{name}: no live particles")
    _require(kernel, err, tol, phase=name)
    full = SPRITE_FULL["capacity"]
    if warmup >= full // SPRITE_FULL["spawn_max"] and live != full:
        raise AssertionError(f"{name}: {live} live particles after the ring "
                             f"filled, expected {full}")
    return launches, ms_per_frame


def phase_profile_sprites(field, warmup, frame_ms, out_dir):
    """Two traced frames of the alpha sprite cell, on a system built anew
    and run through the same warm-up and timed frames: the tables, the
    busy time, the idle share and the host reads a frame as in
    `phase_profile`."""
    system, raster, hdr, kw = sprite_cell(
        field, warmup + SPRITE_TIMED_FRAMES + 2, False)

    def two_frames():
        for _ in range(2):
            sprite_frame(system, raster, hdr, kw)
            torch.cuda.synchronize()

    _traced("slice_alpha_sprites", out_dir, frame_ms, two_frames)


def small_sprite_state(device, n=600, seed=4):
    """The particles of `reference_sprites` at 90 x 150: positions over
    the frame and past its edges, life 0.3-3, velocities, sizes 2-12,
    rotations, premultiplied colours of opacity 0.3-1."""
    from illuminant_tpu_torch.particles.state import ParticleState

    h, w = SPRITE_SMALL["height"], SPRITE_SMALL["width"]
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-4, w + 4, n), rng.uniform(-4, h + 4, n),
                    rng.uniform(0, 60, n), rng.uniform(0.3, 3.0, n)], -1)
    pos[rng.uniform(size=n) < 0.1, 3] = 0.0
    a = rng.uniform(0.3, 1.0, n)
    rc = np.concatenate([rng.uniform(0.1, 1.0, (n, 3)) * a[:, None],
                         a[:, None]], -1)
    rd = np.zeros((n, 4))
    rd[:, 0] = rng.uniform(2.0, 12.0, n)
    rd[:, 1] = rng.uniform(-7.0, 7.0, n)
    vel = np.zeros((n, 4))
    vel[:, :3] = rng.normal(0, 20, (n, 3))

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return ParticleState(position=t(pos), velocity=t(vel),
                         color=t(np.zeros((n, 4))), render_color=t(rc),
                         render_data=t(rd),
                         write_cursor=torch.tensor(0, device=device),
                         total_spawned=torch.tensor(0, device=device))


SHEET = np.concatenate([np.concatenate([LEAF, LEAF[::-1]], 1),
                        np.concatenate([LEAF.T, LEAF * 0.5], 1)], 0)
# Route name -> (what it drives, its keywords, the kernel it launches).
SPRITE_ROUTES = {
    "alpha_quad": ("alpha", dict(kernel="quad"), "composite"),
    "alpha_gauss": ("alpha", dict(kernel="gauss"), "composite"),
    "alpha_round": ("alpha", dict(kernel="round"), "composite"),
    "alpha_dither": ("alpha", dict(kernel="quad", dither=True), "composite"),
    "alpha_opacity_background": ("alpha", dict(kernel="quad", opacity=0.6,
                                               background=True), "composite"),
    "textured_additive": ("render", dict(appearance=dict()), "accumulate"),
    "textured_alpha_z_formula": ("render", dict(
        appearance=dict(), additive_blend=False,
        z_formula=(0.0, 0.2, 1.0, 0.0), background=True), "composite"),
    "power_disc": ("render", dict(appearance=dict(
        texture=None, rounded=True, rounding_power_from_life=0.4)),
        "accumulate"),
    "relative_size": ("render", dict(appearance=dict(relative_size=True),
                                     additive_blend=False), "composite"),
    "velocity_sheet": ("render", dict(appearance=dict(
        texture=SHEET, columns=2, rows=2, column_from_velocity=True,
        animation_rate=(0.0, 1.5)), additive_blend=False), "composite"),
    "vector_warp": ("warp", dict(), None),
    "normal_refraction_warp": ("warp", dict(), None),
}


def _small_sprite_route(name, device):
    """Route `name` of SPRITE_ROUTES at 90 x 150 on `device` -> the image
    as numpy. The appearances keep supports of at most 2 x 9 + 1 px for
    the apron of 9."""
    from illuminant_tpu_torch.raster import render, tiled, warp

    what, kw, _ = SPRITE_ROUTES[name]
    kw = dict(kw)
    h, w = SPRITE_SMALL["height"], SPRITE_SMALL["width"]
    st = small_sprite_state(device)
    bg = lit_floor(h, w, device)
    if kw.pop("background", False):
        kw["background"] = bg
    if what == "warp":
        rng = np.random.default_rng(5)
        field = torch.as_tensor(rng.uniform(0, 1, (h, w, 4)).astype(
            np.float32), device=device)
        out = (warp.vector_warp(bg, field, intensity=(12.0, 12.0, 0.0))
               if name == "vector_warp"
               else warp.normal_refraction_warp(bg, field))
        return out.cpu().numpy()
    cfg = tiled.TiledRasterConfig(height=h, width=w, apron=9,
                                  kernel=kw.pop("kernel", "quad"))
    if what == "alpha":
        x, y = st.position[:, 0], st.position[:, 1]
        out, _ = tiled.rasterize_tiled_alpha(
            cfg, x, y, st.render_color, st.render_data[:, 0],
            st.live_mask(), **kw)
        return out.cpu().numpy()
    kw["appearance"] = sprite_appearance(**kw["appearance"])
    out, _ = render.render_particles(st, cfg, **kw)
    return out.cpu().numpy()


def phase_reference_sprites():
    """Every route of the sprite slice at 90 x 150 on the card against the
    port's CPU path (which the CPU tests hold to the JAX package), from the
    same particles. The composite routes bit for bit (K11a equals its plain
    version; the bins, records and tables are the same on both devices),
    except the dithered one: at most 0.5% of its pixels may differ (a
    pixel whose alpha lies within a rounding of a Bayer threshold may
    flip). The splat routes within K11b's bound, 1e-5 of (1 + the image's
    largest value); the warps within 1e-5. Each route launches its kernel
    exactly once on the card."""
    from illuminant_tpu_torch.raster import tile_kernel as tk

    for name, (_, _, kernel) in SPRITE_ROUTES.items():
        cpu = _small_sprite_route(name, "cpu")
        tk.COMPOSITE_LAUNCHES = tk.ACCUMULATE_LAUNCHES = 0
        cuda = _small_sprite_route(name, "cuda")
        launches = dict(composite=tk.COMPOSITE_LAUNCHES,
                        accumulate=tk.ACCUMULATE_LAUNCHES)
        d = np.abs(cuda - cpu)
        flipped = (d > 0.0).any(-1).mean()
        tol = (_add_tolerance(torch.as_tensor(cpu))
               if kernel == "accumulate" else 0.0)
        say("reference_sprites", route=name,
            size=f"{SPRITE_SMALL['height']}x{SPRITE_SMALL['width']}",
            max_abs_err=f"{d.max():.3e}", tol=tol,
            pixels_differing=f"{flipped:.5f}",
            image_mean=f"{np.abs(cpu).mean():.4f}",
            **{f"{k}_launches": v for k, v in launches.items()})
        expected = {k: int(k == kernel) for k in launches}
        if launches != expected:
            raise AssertionError(f"reference_sprites ({name}): launches "
                                 f"{launches}, expected {expected}")
        if kernel is None:
            ok = bool(np.allclose(cuda, cpu, rtol=1e-5, atol=1e-5))
        elif name == "alpha_dither":
            ok = flipped <= 0.005
        else:
            ok = float(d.max()) <= tol
        if not (ok and np.isfinite(cuda).all() and np.abs(cpu).mean() > 0.0):
            raise AssertionError(f"reference_sprites ({name}): the card's "
                                 "image disagrees with the CPU path")


# --- the lighting library's remaining entry points --------------------------

# The cell particle-lights-tiled-1080p: demo.py scene_tiled_torches
# (:1357-1412) at 1080 x 1920: 2048 torch flames, each an exact shadowless
# sphere light, binned to the 64-px tiles its support reaches (17 x 30 =
# 510 tiles, the last row partial) and shaded over the voxel slice's
# ground by K10, one launch a frame that also samples the AO from that
# slice's ColumnField (the column query's device function). The
# density estimate 2048 x (2 x 38 + 64)^2 / 2,073,600 = 19.4 binned a tile,
# x 1.5 <= 48, takes the auto route to the tiled culling.
LIGHTS_FULL = dict(height=1080, width=1920, n=2048, tile=64, capacity=48)
LIGHTS_TIMED_FRAMES = 8
LIGHTS_SMALL = dict(height=96, width=160)


def torch_template(**kw):
    """The cell's template: demo.py:1402-1406's torch light with an AO
    radius of 16 at opacity 0.5 (K10 samples the AO from the ColumnField
    at every pixel)."""
    from illuminant_tpu_torch.lighting.environment import SphereLightSource

    base = dict(radius=4.0, ramp_length=34.0, color=(1.0, 1.0, 1.0, 0.85),
                cast_shadows=False, ambient_occlusion_radius=16.0,
                ambient_occlusion_opacity=0.5)
    base.update(kw)
    return SphereLightSource(**base)


def torch_flames(n, height, width, seed=12):
    """demo.py:1387-1400's torch flames, all live: numpy default_rng(seed);
    x, y uniform 24 px inside the frame, z 8-14; colour (1, 0.45-0.75,
    0.1-0.3, 0.6-1.0) -> (position, color), (n, 4) float32 each."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(24, width - 24, n)
    pos[:, 1] = rng.uniform(24, height - 24, n)
    pos[:, 2] = rng.uniform(8, 14, n)
    pos[:, 3] = 1.0
    col = np.zeros((n, 4), np.float32)
    col[:, 0] = 1.0
    col[:, 1] = rng.uniform(0.45, 0.75, n)
    col[:, 2] = rng.uniform(0.1, 0.3, n)
    col[:, 3] = rng.uniform(0.6, 1.0, n)
    return pos, col


def lights_cell(field, env_host, device="cuda"):
    """The particle-lights-tiled-1080p scene on `device`: a flat-ground
    G-buffer at the voxel slice's ground and ceiling (`env_host`), ambient
    (0.01, 0.01, 0.015, 1), the flames as a ParticleState, the auto
    source, the resolve, and the host generator of the flicker."""
    from types import SimpleNamespace

    from illuminant_tpu_torch.core.config import HDRConfig
    from illuminant_tpu_torch.lighting.environment import EnvironmentUniforms
    from illuminant_tpu_torch.lighting.gbuffer import flat_ground
    from illuminant_tpu_torch.lighting.particle_light import (
        ParticleLightSource)
    from illuminant_tpu_torch.particles.state import ParticleState

    h, w, n = LIGHTS_FULL["height"], LIGHTS_FULL["width"], LIGHTS_FULL["n"]
    env = EnvironmentUniforms.make(ambient=(0.01, 0.01, 0.015, 1.0),
                                   device=device, **env_host)
    pos, col = torch_flames(n, h, w)
    state = ParticleState.empty(n, device=device).replace(
        position=torch.as_tensor(pos, device=device),
        color=torch.as_tensor(col, device=device))
    source = ParticleLightSource(template=torch_template(), method="auto",
                                 tile=LIGHTS_FULL["tile"],
                                 tile_capacity=LIGHTS_FULL["capacity"])
    return SimpleNamespace(
        field=field, gbuffer=flat_ground(h, w, env), env=env, state=state,
        source=source, hdr=HDRConfig(mode=2, exposure=1.2, white_point=2.5),
        rng=np.random.default_rng(13))


def lights_frame(cell, events=None):
    """One frame of the cell: the host draws new colour alphas (0.6-1.0)
    and uploads them without blocking, then the particle lights, ambient,
    the resolve and the uint8 image -> (image, lightmap, dropped).
    `events`: two CUDA events recorded around the particle lights."""
    from illuminant_tpu_torch.core.config import QualitySettings
    from illuminant_tpu_torch.core.upload import upload
    from illuminant_tpu_torch.lighting.particle_light import (
        accumulate_particle_lights)
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8

    state = cell.state
    alpha = upload(cell.rng.uniform(0.6, 1.0, state.capacity),
                   state.color.device)
    cell.state = state.replace(color=torch.cat(
        [state.color[:, :3], alpha[:, None]], dim=1))
    if events:
        events[0].record()
    lm, dropped = accumulate_particle_lights(
        cell.field, cell.gbuffer, cell.state, cell.source, cell.env,
        QualitySettings(), return_diagnostics=True)
    if events:
        events[1].record()
    return to_uint8(resolve(lm + cell.env.ambient, cell.hdr)), lm, dropped


def _reset_launches():
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10
    from illuminant_tpu_torch.raster import tile_kernel as tk
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    k10.LAUNCHES = 0
    tk.COMPOSITE_LAUNCHES = tk.ACCUMULATE_LAUNCHES = 0
    ck.LAUNCHES = ck.QUERY_LAUNCHES = ck.PACK_LAUNCHES = 0


def _launches():
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10
    from illuminant_tpu_torch.raster import tile_kernel as tk
    from illuminant_tpu_torch.sdf import columns_kernel as ck

    return dict(tiled_lights_fused=k10.LAUNCHES,
                column_query=ck.QUERY_LAUNCHES,
                column_maps_pack=ck.PACK_LAUNCHES,
                column_maps_sample=ck.LAUNCHES,
                composite_over_tiles=tk.COMPOSITE_LAUNCHES,
                sprite_accumulate=tk.ACCUMULATE_LAUNCHES)


def check_fused_lights(args, kwargs, phase):
    """K10's call (`args`, `kwargs`) once more with its debug lists, and
    its plain version on the same inputs: the kept lists, their counts,
    `dropped` and `window_deficit_px` must be equal, the image within
    1e-5 x (1 + max) -> (image error, tolerance, the kept lists' entries,
    the plain version's result)."""
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10

    got = k10.tiled_lights_fused(*args, **dict(kwargs, debug=True))
    ref = k10.tiled_lights_fused_reference(*args, **dict(kwargs, debug=True))
    torch.cuda.synchronize()
    err = _max_err(got[0], ref[0])
    tol = _add_tolerance(ref[0])
    for name, a, b in zip(("dropped", "window_deficit_px", "kept lists",
                           "kept counts"), got[1:], ref[1:]):
        if not torch.equal(a, b):
            raise AssertionError(f"{phase}: K10's {name} differ from the "
                                 "plain binning's")
    _require("tiled_lights_fused", err, tol, phase=phase)
    return err, tol, int(ref[4].sum()), ref


def phase_slice_lights(field, env_host, warmup: int, device="cuda"):
    """The cell at full width: `warmup` frames, the timed frames (each
    fenced by a synchronize; CUDA events around the particle lights), then
    one frame under the host-read counter whose K10 call is checked
    against its plain version (`check_fused_lights`: the debug lists equal
    to `bin_lights_to_tiles`'), and the gates: K10 and the map pack once a
    frame, the column query never, 0 host reads a frame, no light dropped
    and no relief beyond the window, the image finite and not flat.
    Returns (launches, ms_per_frame, K10's recorded call)."""
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10

    torch.cuda.reset_peak_memory_stats()
    cell = lights_cell(field, env_host, device)
    for _ in range(warmup):
        lights_frame(cell)
    torch.cuda.synchronize()
    _reset_launches()
    light_ms, dropped = [], []
    t0 = time.perf_counter()
    for _ in range(LIGHTS_TIMED_FRAMES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        image, _, d = lights_frame(cell, ev)
        dropped.append(d)
        torch.cuda.synchronize()
        light_ms.append(ev[0].elapsed_time(ev[1]))
    ms_per_frame = 1e3 * (time.perf_counter() - t0) / LIGHTS_TIMED_FRAMES
    launches = _launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with HostReads() as reads, KernelInputs("tiled_lights_fused",
                                            k10) as spy:
        image, lm, d = lights_frame(cell)
    torch.cuda.synchronize()
    dropped.append(d)
    n_dropped = int(torch.stack(dropped).sum())
    deficit = float(spy.out[2])
    err, tol, kept, _ = check_fused_lights(spy.args, spy.kwargs,
                                           "slice_particle_lights")
    img_np = image.cpu().numpy()
    say("slice_particle_lights", cell="particle-lights-tiled-1080p",
        warmup=warmup, frames=LIGHTS_TIMED_FRAMES, lights=cell.state.capacity,
        tile=cell.source.tile, capacity=cell.source.tile_capacity,
        ms_per_frame=f"{ms_per_frame:.3f}",
        light_ms=f"{sum(light_ms) / len(light_ms):.3f}",
        peak_mem_gb=f"{peak_gb:.3f}",
        image=f"{img_np.shape}/{img_np.dtype}",
        image_mean=f"{img_np[..., :3].mean():.3f}",
        **{f"{k}_launches": v for k, v in launches.items()},
        host_reads_per_frame=reads.n, dropped=n_dropped,
        window_deficit_px=deficit, kept_entries=kept,
        debug_lists="equal", kernel_vs_plain_max_abs_err=err, tol=tol)
    expected = dict(tiled_lights_fused=LIGHTS_TIMED_FRAMES,
                    column_query=0, column_maps_pack=LIGHTS_TIMED_FRAMES,
                    column_maps_sample=0, composite_over_tiles=0,
                    sprite_accumulate=0)
    if launches != expected:
        raise AssertionError(f"slice_particle_lights: launches {launches} "
                             f"in {LIGHTS_TIMED_FRAMES} frames, expected "
                             f"{expected}")
    if reads.n:
        raise AssertionError(f"slice_particle_lights: {reads.n} host reads "
                             "in a frame; expected 0")
    if n_dropped or deficit:
        raise AssertionError(f"slice_particle_lights: {n_dropped} lights "
                             f"dropped, window deficit {deficit} px")
    if not (bool(torch.isfinite(lm).all())
            and img_np[..., :3].astype(np.float64).var() > 0.0
            and img_np.shape == (LIGHTS_FULL["height"],
                                 LIGHTS_FULL["width"], 4)):
        raise AssertionError("slice_particle_lights: the frame is flat or "
                             "not finite")
    return launches, ms_per_frame, (spy.args, spy.kwargs)


# Operations of the cull's test of one (light, tile) candidate inside the
# window: x, y scaled (2); floor(x / tile), floor(y / tile) (4); the two
# offsets and their window checks (6); the tile's x box (2), the clamps of
# x and y to the box and the distances (6); the two compares and their
# and with live (5).
CULL_OPS_PER_CANDIDATE = 25


def light_kernel_work(args):
    """(bytes, operations, counts) of K10's fused call `args`: bytes of
    the G-buffer planes (z, relative_y, normal), the factor plane
    (fullbright or pix_f), the ColumnField's 5 maps (the call packs them
    itself: the quad pack is its own intermediate), the lights
    (position x, y, z, colour, active) and the light occlusion read once
    and the image written once; operations of the cull's box tests (each
    live light against the in-frame tiles of its candidate window), of
    each pixel's own work and factor (the AO query included), counted on
    the plain version (`pointwise_ops`), and of the shading over the
    (light, pixel) pairs whose plain opacity is nonzero only (a pair's
    operations counted on the plain shading at 1 and 2 slots a tile: the
    difference is one slot's work over every pixel). The plain shading
    always computes the light-occlusion term and selects it away when the
    environment's light_occlusion is 0; K10 skips it, so then its
    operations (`occluded`) are not counted."""
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10

    z, rel, normal, factor, position, color, active, lo, sh, mode = args[:10]
    column = args[10] if len(args) > 10 else None
    h, w = z.shape
    n = position.shape[0]
    channels = 4 if sh.with_alpha else 3
    maps = 0 if column is None else column.maps_c.numel()
    nbytes = (4.0 * (z.numel() + rel.numel() + normal.numel()
                     + factor.numel() + maps + 7 * n + lo.numel()
                     + h * w * channels) + active.numel())
    pix_f, idx, mask, records, _, _ = k10.fused_inputs(*args[:7], sh, mode,
                                                      column)
    # The cull: live lights x in-frame tiles of their candidate window.
    th, tw = -(-h // sh.tile), -(-w // sh.tile)
    spans = []
    for c, reps, n_t in ((0, sh.reps_x, tw), (1, sh.reps_y, th)):
        base = torch.floor(position[:, c] * sh.render_scale / sh.tile)
        lo_t = torch.clamp(base - reps, min=0)
        hi_t = torch.clamp(base + reps, max=n_t - 1)
        spans.append(torch.clamp(hi_t - lo_t + 1, min=0))
    candidates = float((spans[0] * spans[1] * active).sum())
    if mode == "pix_f":
        factor_ops = 0
    else:
        factor_ops = pointwise_ops(lambda: k10.pixel_factor(
            column, z, rel, normal, factor, sh.render_scale,
            sh.ao_radius if mode == "column_ao" else 0.0, sh.ao_opacity))

    def plain(k):
        return lambda: k10.tiled_light_accumulate_reference(
            z, rel, normal, pix_f, idx[:, :k].contiguous(),
            mask[:, :k].contiguous(), records, lo, sh.tile, sh.radius,
            sh.ramp_length, sh.y_factor, sh.ramp_mode, sh.render_scale,
            sh.with_alpha)

    one, two = pointwise_ops(plain(1)), pointwise_ops(plain(2))
    per_slot = two - one
    own = one - per_slot
    if float(lo) <= 0.0:
        occl_on = lo > 0.0
        per_slot -= pointwise_ops(lambda: k10.occluded(z, z, lo, occl_on))
    per_pair = per_slot / (h * w)
    rows = torch.clamp(h - torch.arange(th) * sh.tile, max=sh.tile)
    cols = torch.clamp(w - torch.arange(tw) * sh.tile, max=sh.tile)
    pixels = (rows[:, None] * cols[None, :]).reshape(-1).to(mask.device)
    binned = float((mask.sum(dim=1) * pixels).sum())
    _, contributing = k10.tiled_light_accumulate_reference(
        z, rel, normal, pix_f, idx, mask, records, lo, sh.tile, sh.radius,
        sh.ramp_length, sh.y_factor, sh.ramp_mode, sh.render_scale,
        sh.with_alpha, count_pairs=True)
    ops = (own + factor_ops + candidates * CULL_OPS_PER_CANDIDATE
           + per_pair * contributing)
    counts = dict(binned_pairs=int(binned), contributing_pairs=contributing,
                  ops_per_pair=per_pair, cull_candidates=int(candidates),
                  factor_ops=factor_ops,
                  binned_mean=float(mask.sum(dim=1).float().mean()),
                  binned_max=int(mask.sum(dim=1).max()))
    return nbytes, ops, counts


def parent_k10_call(parent, args):
    """The earlier checkout's K10 on this frame -> (that call, the
    route's whole device work). That K10 shades alone
    (`tiled_light_accumulate` of the checkout module `parent`): it takes
    the frame's own bins, records and factor as its route computed them
    in PyTorch (`tiled_lights_kernel.fused_inputs`), and the route is those
    PyTorch pieces and that K10."""
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10

    sh, mode = args[8], args[9]
    column = args[10] if len(args) > 10 else None

    def shading_args():
        pix_f, idx, mask, records, _, _ = k10.fused_inputs(
            *args[:7], sh, mode, column)
        return (*args[:3], pix_f.contiguous(), idx, mask,
                records.contiguous(), args[7], sh.tile, sh.radius,
                sh.ramp_length, sh.y_factor, sh.ramp_mode, sh.render_scale,
                sh.with_alpha)

    frame = shading_args()
    return (lambda: parent.tiled_light_accumulate(*frame),
            lambda: parent.tiled_light_accumulate(*shading_args()))


def phase_light_kernel(call, parent=None):
    """K10 at the cell's shapes, on the last frame's call: against its
    plain version (the debug lists, `dropped` and the deficit equal, the
    image within 1e-5 x (1 + max)), both timed (`device_ms` on the wrapper:
    the map pack, the zeroing of the diagnostics and K10; `eager_ms` on
    the plain version), beside the bound, with the binned and the
    contributing (light, pixel) pairs and the launch's block. With
    `parent` (`parent_module(root, "lighting.tiled_lights_kernel")`), the
    earlier checkout's K10 on the same frame's bins (`parent_k10_call`),
    in turns with this one, and the eager time of each route's device
    work."""
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10

    args, kwargs = call
    err, tol, kept, ref = check_fused_lights(args, kwargs,
                                             "phase_light_kernel")
    nbytes, ops, counts = light_kernel_work(args)
    bound_ms, bound_by = _bound(nbytes, ops)
    fused = lambda: k10.tiled_lights_fused(*args, **kwargs)  # noqa: E731
    before = {}
    if parent is not None:
        old, old_route = parent_k10_call(parent, args)
        _require("parent tiled_light_accumulate", _max_err(old(), ref[0]),
                 tol, inputs="frame")
        times = [device_ms(f, KERNEL_REPS) for f in (old, fused, fused, old)]
        ms, old_ms = min(times[1:3]), min(times[0], times[3])
        eager = [eager_ms(f, 20) for f in (old_route, fused, fused,
                                           old_route)]
        before = dict(parent_ms=f"{old_ms:.4f}",
                      parent_share_of_bound=f"{bound_ms / old_ms:.3f}",
                      turns=json.dumps([round(v, 4) for v in times]),
                      route_eager_ms=f"{min(eager[1:3]):.4f}",
                      parent_route_eager_ms=f"{min(eager[0], eager[3]):.4f}")
    else:
        ms = device_ms(fused, KERNEL_REPS)
    plain_ms = eager_ms(lambda: k10.tiled_lights_fused_reference(
        *args, **kwargs), 2)
    sh = args[8]
    plan = k10.launch_plan(sh)
    say("kernel", name="tiled_lights_fused", inputs="frame",
        shape=f"{tuple(args[0].shape)}", tile=sh.tile,
        tiles=ref[3].shape[0], capacity=sh.capacity, offsets=sh.offsets,
        mode=args[9], binned_mean=f"{counts['binned_mean']:.1f}",
        binned_max=counts["binned_max"], kept_entries=kept,
        binned_pairs=counts["binned_pairs"],
        contributing_pairs=counts["contributing_pairs"],
        ops_per_pair=f"{counts['ops_per_pair']:.1f}",
        cull_candidates=counts["cull_candidates"],
        factor_ops=counts["factor_ops"], max_abs_err=err, tol=tol,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / ms:.3f}", bytes=int(nbytes),
        operations=int(ops), **before, **plan)
    return {"lights": dict(ms=ms, plain_ms=plain_ms, err=err,
                           bound=(bound_ms, bound_by), library_ms=None)}


def phase_profile_lights(field, env_host, warmup, frame_ms, out_dir):
    """Two traced frames of the particle-lights cell, built anew and run
    through the same warm-up and timed frames: the tables, the busy time,
    the idle share and the host reads a frame as in `phase_profile`."""
    cell = lights_cell(field, env_host)
    for _ in range(warmup + LIGHTS_TIMED_FRAMES + 1):
        lights_frame(cell)
    torch.cuda.synchronize()

    def two_frames():
        for _ in range(2):
            lights_frame(cell)
            torch.cuda.synchronize()

    _traced("slice_particle_lights", out_dir, frame_ms, two_frames)


def _small_lights(case, device):
    """Case `case` of `reference_particle_lights` at 96 x 160 on `device`
    -> (image, dropped, K10 launches): 120 lights from a seed, 20% dead,
    over and past the frame, on a box field."""
    from illuminant_tpu_torch.core.config import QualitySettings
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10
    from illuminant_tpu_torch.lighting.environment import (
        LightingEnvironment, LightObstruction)
    from illuminant_tpu_torch.lighting.gbuffer import flat_ground
    from illuminant_tpu_torch.lighting.particle_light import (
        ParticleLightSource, accumulate_particle_lights)
    from illuminant_tpu_torch.particles.state import ParticleState
    from illuminant_tpu_torch.sdf.analytic import pack_scene

    h, w = LIGHTS_SMALL["height"], LIGHTS_SMALL["width"]
    rng = np.random.default_rng(21)
    n = 120
    pos = np.stack([rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n),
                    rng.uniform(4, 18, n),
                    (rng.uniform(size=n) > 0.2).astype(float)],
                   1).astype(np.float32)
    col = rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32)
    if case == "overflow":
        pos[:60, :2] = (70.0, 40.0)
    env = LightingEnvironment(ground_z=0.0, maximum_z=64.0).uniforms(
        device=device)
    gb = flat_ground(h, w, env)
    if case in ("tiled_25d", "auto"):
        rel = torch.zeros((h, w), device=device)
        rel[60:, 20:120] = -20.0
        gb = gb.replace(relative_y=rel)
    field = pack_scene([LightObstruction.box((60.0, 40.0, 8.0),
                                             (10.0, 10.0, 8.0))],
                       device=device)
    state = ParticleState.empty(n, device=device).replace(
        position=torch.as_tensor(pos, device=device),
        color=torch.as_tensor(col, device=device))
    tpl = dict(radius=2.0, ramp_length=14.0, color=(1.0, 0.9, 0.8, 0.3),
               ambient_occlusion_radius=4.0, ambient_occlusion_opacity=0.7)
    src = dict(method="tiled", tile=32, tile_capacity=64)
    if case == "tiled_25d":
        tpl.update(falloff_y_factor=0.5)
        src.update(stipple_factor=0.5)
    elif case == "auto":
        src = dict(method="auto", tile=32, tile_capacity=64)
    elif case == "overflow":
        src.update(tile_capacity=16)
    elif case == "ramp_texture_auto":
        tpl.update(ramp_texture=np.linspace(0.2, 1.0, 24, dtype=np.float32)
                   .reshape(1, 8, 3))
        src = dict(method="auto", tile=32, tile_capacity=64)
    elif case == "dense_subset":
        src = dict(method="subset", max_lights=n)
    before = k10.LAUNCHES
    img, dropped = accumulate_particle_lights(
        field, gb, state,
        ParticleLightSource(template=torch_template(**tpl), **src), env,
        QualitySettings(), return_diagnostics=True)
    return img.cpu().numpy(), int(dropped), k10.LAUNCHES - before


LIGHT_CASES = {  # case -> K10 launches on the card
    "tiled_25d": 1, "auto": 1, "overflow": 1, "tiled": 1,
    "ramp_texture_auto": 0, "dense_subset": 0}


def phase_reference_particle_lights():
    """The particle lights at 96 x 160 (partial 32-px tiles) on the card
    against the CPU path from the same inputs: the tiled route on a 2.5D
    G-buffer with a squashed y falloff at stipple 0.5, auto (taking the
    tiled route), a tile that overflows its capacity (the same `dropped`),
    the plain tiled route, a ramp-texture template (auto takes the subset)
    and the dense subset; within K10's bound, 1e-5 x (1 + the image's
    largest value). On the card the tiled route is then held to the dense
    subset within tests/test_tiled_lights.py:42's 0.02 relative."""
    images = {}
    for case, k10_launches in LIGHT_CASES.items():
        cpu, d_cpu, _ = _small_lights(case, "cpu")
        cuda, d_cuda, launched = _small_lights(case, "cuda")
        images[case] = cuda
        err = float(np.abs(cuda - cpu).max())
        tol = 1e-5 * (1.0 + float(np.abs(cpu).max()))
        say("reference_particle_lights", case=case,
            size=f"{LIGHTS_SMALL['height']}x{LIGHTS_SMALL['width']}",
            max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}", dropped=d_cuda,
            dropped_cpu=d_cpu, image_max=f"{np.abs(cpu).max():.4f}",
            k10_launches=launched)
        if launched != k10_launches:
            raise AssertionError(f"reference_particle_lights ({case}): K10 "
                                 f"launched {launched} times, expected "
                                 f"{k10_launches}")
        if not (err <= tol and d_cuda == d_cpu
                and (d_cuda > 0) == (case == "overflow")
                and np.isfinite(cuda).all() and np.abs(cpu).max() > 0.0):
            raise AssertionError(f"reference_particle_lights ({case}): the "
                                 "card disagrees with the CPU path")
    dense = images["dense_subset"]
    rel = float(np.abs(images["tiled"] - dense).max()) / max(
        float(dense.max()), 1e-6)
    say("reference_particle_lights", case="tiled_vs_dense_subset",
        max_rel_err=f"{rel:.4f}", tol=0.02)
    if not rel < 0.02:
        raise AssertionError("reference_particle_lights: the tiled route "
                             "strays from the dense subset")


# Probes on a 36 x 20 grid across the 1080p frame; every third without a
# normal.
PROBE_GRID = (36, 20)
PROBE_FAMILIES = ("sphere", "directional", "line", "volumetric", "projector")


def _probe_values(device, leave_out=None):
    """evaluate_probes of the full-family flagship's analytic scene and
    packed lights (1080 x 1920) at the probe grid on `device`, with family
    `leave_out` left out -> (P, 4) numpy."""
    from illuminant_tpu_torch.core.config import QualitySettings
    from illuminant_tpu_torch.lighting.probes import (LightProbe,
                                                      evaluate_probes,
                                                      pack_probes)
    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(device=device, height=FULL["height"],
                           width=FULL["width"], n_lights=8, capacity=1 << 10,
                           spawn_max=128, field="analytic", full_family=True)
    gx, gy = PROBE_GRID
    probes = [LightProbe(position=((i + 0.5) * FULL["width"] / gx,
                                   (j + 0.5) * FULL["height"] / gy, 1.0),
                         normal=None if (i + j) % 3 == 0 else (0, 0, 1))
              for j in range(gy) for i in range(gx)]
    extra = scene.extra_lights
    lights = dict(sphere_lights=scene.sphere_lights,
                  directional_lights=extra["directional"],
                  line_lights=extra["line"],
                  volumetric_lights=extra["volumetric"],
                  projector_lights=extra["projector"])
    if leave_out is not None:
        lights.pop(f"{leave_out}_lights")
    return evaluate_probes(
        scene.volume, pack_probes(probes, device=device),
        scene.environment.uniforms(device=device), QualitySettings(),
        **lights).cpu().numpy()


def _gi_radiance(dirs):
    """demo.py:829-833's GI-probe radiance (scene_gi_probes)."""
    w = torch.clamp(dirs[:, 0] * 0.8 + dirs[:, 2] * 0.6, min=0.0)[:, None]
    f = torch.tensor([1.8, 1.2, 0.5], device=dirs.device)
    return w ** 2 * f + torch.tensor([0.05, 0.08, 0.2], device=dirs.device)


def _jfa_mask():
    """demo.py:1063-1066's jump-flood mask, 256 x 256."""
    ys, xs = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    return (((ys - 128) ** 2 + (xs - 96) ** 2) < 60 ** 2) | (
        (np.abs(ys - 120) < 18) & (np.abs(xs - 180) < 50))


def phase_reference_probes():
    """The probes, the SH bake and the jump flood on the card against the
    CPU path. Probes of every family at once: the cone marches take the
    same float32 steps, so mean |d| <= 1e-3 and 99% of the probes within
    1e-3 x (1 + the largest value), the family tests' march bound; leaving
    any family out must change the card's values. The SH bake of
    demo.py's radiance within 1e-5 of the largest coefficient (float32
    sums over 256 samples in another order); the jump flood of
    demo.py's 256 x 256 mask exactly equal."""
    from illuminant_tpu_torch.lighting.spherical_harmonics import (
        bake_probe_from_lights)
    from illuminant_tpu_torch.utils.jumpflood import jump_flood_sdf

    cpu, cuda = _probe_values("cpu"), _probe_values("cuda")
    d = np.abs(cuda - cpu)
    scale = 1e-3 * (1.0 + float(np.abs(cpu).max()))
    changed = {f: float(np.abs(cuda - _probe_values("cuda", f)).max())
               for f in PROBE_FAMILIES}
    say("reference_probes", probes=cpu.shape[0],
        grid=f"{PROBE_GRID[0]}x{PROBE_GRID[1]}", mean_abs_err=f"{d.mean():.3e}",
        within=f"{float((d.max(axis=1) <= scale).mean()):.4f}",
        max_abs_err=f"{d.max():.3e}", value_max=f"{np.abs(cpu).max():.4f}",
        **{f"without_{f}": f"{v:.4f}" for f, v in changed.items()})
    if not (d.mean() <= 1e-3 and (d.max(axis=1) <= scale).mean() >= 0.99
            and np.isfinite(cuda).all()):
        raise AssertionError("reference_probes: the card's probes disagree "
                             "with the CPU path")
    if not all(v > 1e-3 for v in changed.values()):
        raise AssertionError(f"reference_probes: a family leaves the probes "
                             f"unchanged: {changed}")
    sh = {dev: bake_probe_from_lights((0.0, 0.0, 0.0), _gi_radiance,
                                      n_samples=256, device=dev).cpu()
          for dev in ("cpu", "cuda")}
    sh_err = float((sh["cuda"] - sh["cpu"]).abs().max())
    sh_tol = 1e-5 * float(sh["cpu"].abs().max())
    mask = _jfa_mask()
    jfa = {dev: jump_flood_sdf(mask, device=dev).cpu()
           for dev in ("cpu", "cuda")}
    say("reference_probes", sh_max_abs_err=f"{sh_err:.3e}",
        sh_tol=f"{sh_tol:.3e}", jfa="256x256",
        jfa_equal=bool(torch.equal(jfa["cuda"], jfa["cpu"])),
        jfa_range=f"{float(jfa['cpu'].min()):.2f}..{float(jfa['cpu'].max()):.2f}")
    if not sh_err <= sh_tol:
        raise AssertionError("reference_probes: the card's SH bake "
                             "disagrees with the CPU path")
    if not torch.equal(jfa["cuda"], jfa["cpu"]):
        raise AssertionError("reference_probes: the card's jump flood "
                             "differs from the CPU path")


def _busy_us(events) -> tuple:
    """(union of the device events' intervals, sum of their durations),
    in microseconds, and their count. The union counts overlapping work
    once; the stage ranges' device-side twins span the timeline and are
    left out."""
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
    return union, total, len(spans)


def phase_profile(name, warmup: int, frame_ms, out_dir):
    """Two traced frames of slice `name`, after its warm-up and timed
    frames replayed untraced on a scene built anew (the same seeds, so the
    same state; nothing of the other slices is held on the card):
    per-kernel and per-stage tables under out_dir/name, the device's busy
    time per frame, and its idle share of the unprofiled frame time
    `frame_ms` measured in the same run."""
    from illuminant_tpu_torch.scenes import build_flagship

    dev = torch.device("cuda")
    scene = build_flagship(device=dev, **FULL, **SLICES[name])
    gen = torch.Generator(device=dev).manual_seed(0)
    i0 = warmup + TIMED_FRAMES
    _, state, avg = _run_frames(scene, i0, 0, gen, scene.system.state,
                                torch.tensor(0.5, device=dev))
    torch.cuda.synchronize()
    _traced(name, out_dir, frame_ms,
            lambda: _run_frames(scene, 2, i0, gen, state, avg))


def phase_profile_renderer(name, frame_ms, out_dir):
    """Two traced frames of renderer frame `name` on a scene built anew
    and run through the same warm-up and timed frames: the tables, the
    busy time and the idle share as in `phase_profile`; the stage ranges
    are illuminant/renderer/update_fields, /gbuffer, /field_regen,
    /light_pass/<mode> and /resolve."""
    renderer, hdr, move, shadow_mode, budget = _build_renderer(
        name, "cuda", FULL["height"], FULL["width"])
    i0 = RENDERER_WARMUP_FRAMES + RENDERER_TIMED_FRAMES + 1
    for i in range(i0):
        renderer_frame(renderer, hdr, move, i, shadow_mode, budget)
    torch.cuda.synchronize()

    def two_frames():
        for i in (i0, i0 + 1):
            renderer_frame(renderer, hdr, move, i, shadow_mode, budget)
            torch.cuda.synchronize()

    _traced(name, out_dir, frame_ms, two_frames)


def _traced(name, out_dir, frame_ms, two_frames):
    """Run `two_frames` under torch.profiler; write the per-kernel and
    per-stage tables under out_dir/name and print the [profile*] line."""
    from torch.profiler import ProfilerActivity, profile

    out_dir = os.path.join(out_dir, name)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        two_frames()
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
    union, total, events = _busy_us(prof.events())
    busy_ms = union / 2e3
    # Device-to-host reads of a scalar (a march's "any ray live?" check,
    # a percentile): each waits for the device to drain its queue.
    reads = [e for e in ka if e.key == "aten::_local_scalar_dense"]
    say(name.replace("slice", "profile"), frames=2, out=out_dir,
        device_busy_ms_per_frame=f"{busy_ms:.3f}",
        device_kernel_sum_ms_per_frame=f"{total / 2e3:.3f}",
        device_events_per_frame=events / 2,
        unprofiled_ms_per_frame=f"{frame_ms:.3f}",
        device_idle_share=f"{1.0 - busy_ms / frame_ms:.4f}",
        host_reads_per_frame=sum(e.count for e in reads) / 2,
        host_read_ms_per_frame="%.3f" % (
            sum(e.cpu_time_total for e in reads) / 2e3),
        stages=len(stages))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--warmup", type=int, default=None,
                    help="untimed frames before the timed ones (default 4 "
                    "for the flagship and particle cells, 2 for the sprite "
                    "cells)")
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables")
    ap.add_argument("--parent", default=None,
                    help="root of an earlier commit's checkout (`git "
                    "archive`): its tile kernels are timed beside these on "
                    "the same inputs")
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
    warmup = 4 if args.warmup is None else args.warmup
    sprite_warmup = SPRITE_WARMUP_FRAMES if args.warmup is None \
        else args.warmup
    phase_build()
    cuda = torch.device("cuda")
    scene, field = _slice_field(cuda)
    env_host = dict(ground_z=scene.environment.ground_z,
                    maximum_z=scene.environment.maximum_z)
    kernel = phase_kernel(field)
    kernel.update(phase_sprite_kernels(parent=parent_module(
        args.parent, "raster.tile_kernel") if args.parent else None))
    parent_lights = None
    if args.parent:
        parent_lights = parent_module(args.parent,
                                      "lighting.tiled_lights_kernel")
    launches, frame_ms = {}, {}
    for name, kw in SLICES.items():
        if name == "slice_family":
            phase_families()
        if scene is None:
            scene = build_flagship(device=cuda, **FULL, **kw)
        launches[name], state, frame_ms[name] = phase_slice(
            name, scene, warmup, TIMED_FRAMES)
        if name == "slice":
            kernel.update(phase_frame_points(field, state))
        scene = state = None
        torch.cuda.empty_cache()
    for name in RENDERER_FRAMES:
        frame_ms[name] = phase_slice_renderer(name)
        torch.cuda.empty_cache()
    particle_launches, frame_ms["slice_particles"] = phase_slice_particles(
        field, warmup)
    torch.cuda.empty_cache()
    sprite_launches = {}
    for additive in (False, True):
        sprite_launches[additive], frame_ms[
            "slice_additive_sprites" if additive
            else "slice_alpha_sprites"] = phase_slice_sprites(
                field, sprite_warmup, additive, kernel)
        torch.cuda.empty_cache()
    light_launches, frame_ms["slice_particle_lights"], light_call = \
        phase_slice_lights(field, env_host, warmup)
    kernel.update(phase_light_kernel(light_call, parent_lights))
    del light_call
    torch.cuda.empty_cache()
    # Profiled after every slice is timed: a profiler session slows the
    # launches that follow it in the process.
    for name in SLICES if args.profile else ():
        phase_profile(name, warmup, frame_ms[name], args.profile)
        torch.cuda.empty_cache()
    for name in RENDERER_FRAMES if args.profile else ():
        phase_profile_renderer(name, frame_ms[name], args.profile)
        torch.cuda.empty_cache()
    if args.profile:
        phase_profile_particles(field, warmup,
                                frame_ms["slice_particles"], args.profile)
        phase_profile_sprites(field, sprite_warmup,
                              frame_ms["slice_alpha_sprites"], args.profile)
        phase_profile_lights(field, env_host, warmup,
                             frame_ms["slice_particle_lights"], args.profile)
    del field
    phase_reference()
    phase_reference_analytic()
    phase_reference_family()
    phase_reference_renderer()
    phase_reference_particles()
    phase_reference_sprites()
    phase_reference_particle_lights()
    phase_reference_probes()
    # Each kernel at the heavier of the frame's calls: the query with the
    # unit gradient, the sampler with the derivative rows; the other calls
    # are in the [kernel] lines above. "ms" is one call of the wrapper the
    # frame calls (the query and the sampler include their pack).
    # "launches" counts the voxel flagship's timed frames,
    # "launches_particles" the particle cell's timed ticks,
    # "launches_sprites" the alpha sprite cell's,
    # "launches_particle_lights" the particle-light cell's timed frames;
    # the tile kernels' "launches" count their sprite cell's timed
    # renders, their times are at that cell's steady 131,072 particles;
    # K10's count that cell's frames, its time is on its last frame.
    rows = [("column_query", "illuminant_tpu/sdf/columns_pallas.py:78",
             kernel["query", True]),
            ("column_maps_sample", "illuminant_tpu/sdf/columns_pallas.py:78",
             kernel["sample", True]),
            ("column_maps_pack", "illuminant_tpu/sdf/columns_pallas.py:108",
             kernel["pack"])]
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "illuminant_tpu_torch/csrc/column_maps.cu",
        "replaces": replaces,
        "launches": launches["slice"][name],
        "launches_particles": particle_launches[name],
        "launches_sprites": sprite_launches[False][name],
        "launches_particle_lights": light_launches[name],
        "max_abs_err": r["err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1],
        "library_ms": r.get("library_ms"),
    } for name, replaces, r in rows]
    for name, replaces, key, additive in (
            ("composite_over_tiles", "illuminant_tpu/raster/tiled.py:749",
             "composite", False),
            ("sprite_accumulate", "illuminant_tpu/raster/sprites.py:344",
             "accumulate", True)):
        r = kernel[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "illuminant_tpu_torch/csrc/tile_raster.cu",
            "replaces": replaces,
            "launches": sprite_launches[additive][name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None})
    r = kernel["lights"]
    kernels.append({
        "name": "tiled_lights_fused", "route": "cuda",
        "source": "illuminant_tpu_torch/csrc/tiled_lights.cu",
        "replaces": "illuminant_tpu/lighting/tiled_lights.py:123",
        "launches": light_launches["tiled_lights_fused"],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
