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
    kernels: the pack launches once a frame (for K4, the collision
    integrate, on the frame's new maps), the fused query and the sampler
    (`sample_maps`, which the query replaced) never; after its timed
    frames the fused query is checked and timed once more on the slice's
    own particle positions (`[kernel] inputs=frame`);
  * `slice_analytic`: the analytic field, fast preset (the headline frame);
  * `slice_parity`: the analytic field, parity preset;
  * `slice_family`, `slice_family_parity`: the analytic field at both
    presets with `full_family=True`: a directional sun, a line light, a
    shadowed volumetric light, a projector and particle lights on top of
    the sphere lights. Before them `families` checks on a small frame
    that each of the five families changes the image.
The analytic slices launch no column kernel: they never build a
ColumnField. Every slice gates K4 (`csrc/collide_integrate.cu`, the
particles' collision integrate and render data) at one launch a frame,
and `[kernel] name=collide_integrate` holds K4 on the integrate calls of
the benchmark's flagship and particle cells to its plain version bit for
bit, timed beside its byte bound and the plain version. Every slice gates
K1 (`csrc/scan_walk.cu`, the scan shadows'
column walk) at one launch a `scan_visibility` call (SCAN_WALK_PER_FRAME),
and `[kernel] name=scan_walk` holds K1 on the analytic and the voxel
flagship's own walks (270 x 480, 8 lights) to the eager loop bit for bit,
timed beside its byte bound, the eager loop as the frame runs it
(`plain_ms`) and that loop captured in a CUDA graph (`graph_ms`); K2
(`csrc/scan_readout.cu`, the readout after the walk) launches as often,
and `[kernel] name=scan_readout` holds it on the flagship scan and the
2.5D renderer cells' readouts to its plain version bit for bit, timed
the same way beside its bound (`scan_readout_work`). Each
slice line gives ms/frame, live particles, avg_lum, the peak device
memory and the launch counts. `reference` holds the card's
voxel frame at both presets (K4 once a frame, the fused query never),
`reference_analytic` the analytic frame at both presets and
`reference_family` the full-family frame on the analytic field at both
presets and on the voxel field (the fused query 2 launches a frame: the
volumetric window's exact refine and the projector's AO sample) to the
port's plain CPU path on a small input.

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
    `to_uint8` each of 8 timed frames. Gates: K4 launches once a tick,
    the fused query, its pack and the sampler never, a tick reads nothing back
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
  * `reference_sprites`: every route (alpha quad / gauss / round /
    point, the additive point splat, dither, opacity and background,
    textured additive and alpha, power disc, relative size, a
    velocity-driven sprite sheet, both warps) at 90 x 150 (partial tiles
    at the edges) on the card against the CPU path: the composite routes
    bit for bit, the splat routes within K11b's bound.
The modeling layer (`illuminant_tpu_torch/models/`), the way an editor or
a compiled model drives the engine (demo.py:1324-1354):
  * `slice_model` (model-engine-1080p): `EngineModel.loads` of
    `model_json` (three systems: sparks from a Spawner whose rate is the
    named variable `rate`, with an attractor and Noise, untextured
    additive quads; embers from a FeedbackSpawner fed by the sparks,
    an inline texture drawn additively, K11b; smoke with demo.py's leaf,
    opacity from life, composited over the additive image, K11a), an
    `EngineView` of 1<<17 slots a system on the voxel slice's
    ColumnField (each tick of each system collides: one K4 launch), then
    each of 8 timed frames (after 2 warm-up frames, or --warmup N)
    `update(1/60)`, every system's `render` in draw order, `resolve`,
    `to_uint8`. Gates: K4 3 times a frame, the query, its pack and the
    sampler never, K11a and K11b once a render, 0 host reads in
    an update, in the renders 0 but the untextured splat's one
    (ROADMAP Queue 3, K5), alpha <= 1, the frame finite and not flat,
    the checked frame's K11a equal to its plain version and its K11b
    within its bound (each timed, `[kernel] inputs=model_frame`),
    `refresh_variables` with half the rate keeping the live state and
    halving the sparks' spawns a tick, 131,072 live in each ring under
    `--warmup 260`;
  * `reference_models`: the model at 96 x 160 for 10 updates on the
    card against the CPU from the same host draws (every live particle
    within 1e-4 + 1e-5 |b|, equal live masks and cursors); the
    SaveAsCode module's systems against the JSON view's on the card
    after 20 updates, bit for bit; tests/test_editor.py's edit script on
    the card against the CPU (digest within the same bound, `dumps()`
    equal).
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
The march and the splat (`csrc/cone_trace.cu`: K12, every cone march;
`csrc/splat.cu`: K5, the untextured additive splat):
  * `slice_family_march` (analytic-family-march-1080p): the full-family
    flagship with `shadow_mode="march"`, the sphere lights and the sun
    marched, K12 three times a frame (the sphere pass, the sun, the
    projector); its device busy time (`profile_family_march`) in every
    run. Every flagship slice gates K5 once a frame, K12 as
    `K12_PER_FRAME` counts, FLAGSHIP_READS_PER_FRAME host reads and its
    splat under the sync debug mode; the renderer frames gate 0 host
    reads a frame and K12 once a light pass under the march; the
    particle and model cells 0 reads a render;
  * `[kernel] name=cone_trace` on renderer-voxel-march's rays
    (SdfVolume, read from its packed taps: `[kernel] name=volume_pack`,
    bit for bit, once a new volume), the march cell's sphere, sun and
    projector rays (AnalyticScene) and the voxel flagship's ColumnField;
    `[kernel] name=splat` (four launches a splat) on the voxel
    flagship's, the particle cell's and the model's sparks' particles
    and on a clustered cloud (`clustered_cloud`: 16,384 of 131,072 in
    one tile); each against its plain version, timed beside its bound;
    the `[build]` line of K12 gives the SASS instructions of each
    instance's march loop body (`march_loop_sass`, from `cuobjdump
    -sass`) and each kernel's registers and spills;
  * `reference_march`: the march flagship at 96 x 160 on both fields,
    with and without the families, a `carried_all` frame and one at
    `shadow_scale=0.25`, card against CPU.
The multi-device frame (`illuminant_tpu_torch/parallel/`: `make_mesh`,
`build_flagship(mesh=...)`, the row-banded raster
`rasterize_tiled_sharded`):
  * `slice_mesh` (flagship-mesh1-1080p): the analytic fast flagship built
    on the card's mesh, an NCCL group of one rank, run as `slice_analytic`
    was (same state, generator, warm-up and timed frames). Gates: the last
    timed image within 1 of that slice's, avg_lum within 1e-4, K5
    LAUNCHES_PER_SPLAT times a frame, FLAGSHIP_READS_PER_FRAME host reads
    a frame (the histogram's all-reduce reads nothing) and none in its
    raster, which runs once more under the sync debug mode; ms/frame
    beside the unsharded slice's;
  * `mesh_bands`: the route and the band rasters of meshes of 2, 4 and 8
    ranks in this process (the exchange a transpose of the stacked send
    buffers), on that slice's particles and on the clustered cloud. Gates:
    each band's K5 (its grid one ghost tile row above and below inside the
    frame, y shifted by whole tiles, D x B received slots) within its bound
    of its plain version, the stitched bands within the unsharded K5's
    bound, the routes' counts and send drops equal to the CPU route's; D =
    1 through the real `all_to_all_single`. Device ms of the routes and
    the band rasters beside one unsharded K5;
  * `reference_mesh`: the mesh frame at 96 x 160 with the global ring and
    with 4 spawn sub-rings, card against the CPU frame without a mesh.
Every phase prints one line; the last
three lines are the kernels' record as JSON, the card's name and power
limit, and {"ok": true, "device": {...}}. Any failure exits non-zero
before those lines are printed. With no CUDA card the script exits 2.

`--warmup N` runs N untimed frames before the timed ones of every
flagship, particle, sprite, model and particle-light cell (default 4; 2
for the sprite and model cells).
The particle rings fill after capacity / spawn_max = 256 frames, so
`--warmup 260` times each frame at its steady population (about 1M live
particles; 131,072 in the sprite cells and in each model system); the
default times it at 20k-33k (1,024-5,120 in the sprite cells, 5,632 a
model system).

`--parent DIR` builds the tile kernels, K10, K5 and K12 of another
checkout at DIR (an earlier commit unpacked with `git archive`), holds
K5's and K12's outputs to the same plain versions and gates, and times
them beside these in the `[kernel]` rows of the sprite kernels, K10, K5
and K12, on the same inputs, in turns (parent, this, this, parent:
parent_ms, parent_share_of_bound); the parent K12's march loop SASS is
printed on its `[build]` line.

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
import functools
import json
import math
import os
import re
import shutil
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
    # analytic-family-march-1080p: the exact march for the sphere lights
    # and the sun (K12), the line light's and the volumetric light's own
    # scans.
    "slice_family_march": dict(field="analytic", preset="fast",
                               full_family=True, shadow_mode="march"),
}
# K12 launches a frame of each slice: the sphere pass under the march; the
# sun's standalone march when no fused scan carries it (under the march);
# the projector's march with full_family (its rays disabled in the
# flagship, whose projector has no origin, but launched). The line light
# takes its own scan under the march, as in the JAX frame.
K12_PER_FRAME = {"slice": 0, "slice_analytic": 0, "slice_parity": 0,
                 "slice_family": 1, "slice_family_parity": 1,
                 "slice_family_march": 3}
# K1 (and K2) launches a frame of each slice: one a `scan_visibility`
# call. The sphere lights' scan (fused with the sun's and the line
# light's where the families are on); the volumetric light's windowed
# scan; under the march the line light's own scan.
SCAN_WALK_PER_FRAME = {"slice": 1, "slice_analytic": 1, "slice_parity": 1,
                       "slice_family": 2, "slice_family_parity": 2,
                       "slice_family_march": 2}
# Device-to-host reads a flagship frame: the exposure's percentile
# (utils/histogram.py:percentile) indexes four tensors with 0-d tensor
# indices; the splat's `amax` (and its `nonzero`) are gone with K5.
FLAGSHIP_READS_PER_FRAME = 4
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
# The earlier checkout's kernel modules under `--parent` ("splat",
# "cone_trace"), which the [kernel] rows of K5 and K12 time beside these.
PARENT = {}
# Each flagship slice's last timed image and the avg_lum after it, which
# `slice_mesh` holds its mesh frame to.
SLICE_LAST = {}


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


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")


def sass_functions(library) -> dict:
    """{mangled kernel name: [(address, instruction text)]} from
    `cuobjdump -sass` of a built library."""
    proc = subprocess.run([cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120)
    return parse_sass(proc.stdout)


def parse_sass(text: str) -> dict:
    funcs, ins = {}, None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            ins = funcs.setdefault(s.split(":", 1)[1].strip(), [])
        elif ins is not None and s.startswith("/*") and "*/" in s:
            head, _, rest = s[2:].partition("*/")
            body = rest.split("/*")[0].strip().rstrip(";").strip()
            if body and re.fullmatch(r"[0-9a-fA-F]+", head):
                ins.append((int(head, 16), body))
    return funcs


def sass_loops(library, text=None) -> dict:
    """For each kernel of a built library (or of `cuobjdump -sass` output
    `text`): its SASS instruction count, and its loops as the address
    spans of its backward branches (a `BRA` to an address at or before
    its own), outermost first, each with the instructions it spans. A
    march kernel's outermost loop is the march loop; its body's count is
    the static number of instructions a step issues (a primitive or edge
    loop nested in it counts once)."""
    funcs = parse_sass(text) if text is not None else sass_functions(library)
    out = {}
    for name, ins in funcs.items():
        spans = []
        for addr, body in ins:
            words = body.replace(",", " ").split()
            op = words[1] if words[0].startswith("@") and len(words) > 1 \
                else words[0]
            if op.split(".")[0] != "BRA" or not words[-1].startswith("0x"):
                continue
            first = int(words[-1], 16)
            if first <= addr:
                spans.append(dict(first=first, last=addr, instructions=sum(
                    1 for a, _ in ins if first <= a <= addr)))
        spans.sort(key=lambda s: s["first"] - s["last"])
        out[name] = dict(instructions=len(ins), loops=spans)
    return out


def march_loop_sass(library, text=None) -> dict:
    """{field instance: instructions of K12's march loop body} of a built
    cone_trace library (`sass_loops`: each instance's outermost loop),
    with the loops nested in it."""
    kinds = {"ILi0E": "volume", "ILi1E": "analytic", "ILi2E": "column",
             "ILi3E": "analytic_global"}
    out = {}
    for name, info in sass_loops(library, text).items():
        if "cone_trace_kernel" not in name or not info["loops"]:
            continue
        kind = next((v for k, v in kinds.items() if k in name), name)
        outer = info["loops"][0]
        inner = [s["instructions"] for s in info["loops"][1:]
                 if outer["first"] <= s["first"] and
                 s["last"] <= outer["last"]]
        out[kind] = dict(loop=outer["instructions"], nested=inner,
                         kernel=info["instructions"])
    return out


def ptxas_summary(log: str) -> dict:
    """{kernel: "registers / spill stores / spill loads"} from a `-Xptxas
    -v` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    short = {}
    for name, v in out.items():
        m = re.search(r"([a-z_]+_kernel)(?:ILi(\d)E)?", name)
        short[m.group(1) + (f"<{m.group(2)}>" if m and m.group(2) else "")
              if m else name] = v
    return short


@functools.lru_cache(maxsize=None)
def _libraries():
    """Every kernel library of the port by source name (`Library`), found
    by importing each of the port's modules."""
    import importlib
    import pkgutil

    import illuminant_tpu_torch as pkg
    from illuminant_tpu_torch.core.cuda_build import Library

    libs = {}
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        for v in vars(importlib.import_module(m.name)).values():
            if isinstance(v, Library):
                libs[v.source.stem] = v
    return dict(sorted(libs.items()))


def phase_build():
    """Build every kernel library from the checkout's sources, one nvcc
    for each source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from illuminant_tpu_torch.core.cuda_build import BUILD_LOGS

    def timed(lib):
        t0 = time.perf_counter()
        lib.build()
        return time.perf_counter() - t0

    libs = _libraries()
    with ThreadPoolExecutor(len(libs)) as pool:
        secs = dict(zip(libs, pool.map(timed, libs.values())))
    for name, lib in libs.items():
        log = BUILD_LOGS.get(lib.path, "").strip().replace("\n", " | ")
        extra = {}
        if name == "cone_trace":
            # K12's yardstick: the SASS instructions of each instance's
            # march loop body, and every instance's registers and spills.
            extra = dict(march_loop_sass=json.dumps(
                march_loop_sass(lib.path)), ptxas_all=json.dumps(
                    ptxas_summary(BUILD_LOGS.get(lib.path, ""))))
        say("build", kernel=name, seconds=f"{secs[name]:.2f}",
            ptxas=json.dumps(log[-400:]), **extra)


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


def phase_frame_points(field, state, raster_config):
    """The fused query on the voxel slice's own traffic: the particles'
    positions after its timed frames, in slot order, passed as the frame
    passes them (strided columns of the (N, 4) state), against its plain
    version and timed as in `phase_kernel`. The maps are the loaded
    field's, the frame's before its animation. Then K5 on the same
    particles as the frame's splat takes them (`[kernel] splat
    inputs=flagship`)."""
    pos = state.position
    rec = {}
    _query_job(rec, "query_frame", field, pos[:, 0], pos[:, 1], pos[:, 2],
               _tolerance(field.maps_c), inputs="frame",
               live=int(state.live_count()))
    _splat_row(rec, "splat_flagship", (
        raster_config, pos[:, 0], pos[:, 1], state.render_color,
        state.render_data[:, 0], state.live_mask()), inputs="flagship",
        live=int(state.live_count()))
    return rec


def splat_work(cfg, x, y, color, size, live, terms):
    """(bytes, operations) of one K5 call: x, y, size (float32), live (a
    byte) and the C colour floats of every particle read once and the
    image written once; the operations the splat needs for this data:
    one profile for each nonzero row and each nonzero column of each live
    on-screen particle's footprint inside its tile's window, and for each
    nonzero (particle, pixel) term (`terms`, `tiled.splat_terms`) the
    weight product and C products and sums. A profile's operations are
    its plain version's (`pointwise_ops`). The taps of weight 0 that the
    kernel walks, and the column profiles it recomputes in every row, are
    not needed and not counted."""
    from illuminant_tpu_torch.raster import tiled

    n, ch = x.shape[0], cfg.channels
    nbytes = n * (4.0 * 3 + 1.0 + 4.0 * ch) + 4.0 * cfg.height * cfg.width * ch
    sel, xs, ys, radius = tiled._splat_selection(cfg, x, y, size, live)
    if sel.numel() == 0:
        return nbytes, 0.0
    (_, wx), (_, wy) = tiled._footprints(cfg, xs, ys, radius)
    profiles = float((wx != 0.0).sum() + (wy != 0.0).sum())
    one = torch.ones(1, device=x.device)
    prof = pointwise_ops(lambda: tiled._profile(cfg.kernel, one * 0.3, one))
    return nbytes, float(terms.sum()) * (1 + 2 * ch) + profiles * prof


def _in_turns(call, parent_call, bound_ms) -> tuple:
    """(ms, the parent's fields): `call` timed alone, or with a parent
    call in turns (parent, this, this, parent), each the least of its
    two."""
    if parent_call is None:
        return device_ms(call, KERNEL_REPS), {}
    times = [device_ms(f, KERNEL_REPS)
             for f in (parent_call, call, call, parent_call)]
    ms, old_ms = min(times[1:3]), min(times[0], times[3])
    return ms, dict(parent_ms=f"{old_ms:.4f}",
                    parent_share_of_bound=f"{bound_ms / old_ms:.3f}",
                    turns=json.dumps([round(v, 4) for v in times]))


def _splat_row(rec, key, args, **fields):
    """K5 on a recorded call (cfg, x, y, color, size, live) against its
    plain version on the same inputs (max |d| within n_max x 2^-23 x the
    image's largest value: each pixel's sum of n terms reordered by the
    atomics, n_max from `tiled.splat_terms`), both timed, beside the
    bound; with `--parent` the earlier commit's K5 too (held to the same
    bound, timed in turns); one [kernel] line with the accumulation's
    block and the largest tile's count, the record under rec[key]."""
    from illuminant_tpu_torch.raster import splat_kernel, tiled

    cfg, x, y, color, size, live = args
    out = splat_kernel.splat_cuda(*args)
    (ref, _), plain_ms = timed_once(
        lambda: tiled.rasterize_tiled_reference(*args))
    err = _max_err(out, ref)
    terms = tiled.splat_terms(cfg, x, y, size, live)
    n_max = int(terms.max())
    tol = n_max * 2.0 ** -23 * float(ref.abs().max())
    _require("splat", err, tol, **fields)
    nbytes, ops = splat_work(*args, terms)
    bound_ms, bound_by = _bound(nbytes, ops)
    parent = PARENT.get("splat")
    parent_call = None
    if parent is not None:
        _require("parent splat", _max_err(parent.splat_cuda(*args), ref),
                 tol, **fields)
        parent_call = lambda: parent.splat_cuda(*args)  # noqa: E731
    ms, before = _in_turns(lambda: splat_kernel.splat_cuda(*args),
                           parent_call, bound_ms)
    counts = splat_kernel.bin_plan(cfg, x, y, live)["counts"]
    say("kernel", name="splat", **fields, kernel=cfg.kernel,
        particles=x.shape[0], binned=int(counts.sum()),
        tile_max=int(counts.max()), max_abs_err=err, tol=tol,
        terms_per_pixel_max=n_max, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        share_of_bound=f"{bound_ms / ms:.3f}", bytes=int(nbytes),
        operations=int(ops), library_ms=None, **before,
        launches_per_splat=splat_kernel.LAUNCHES_PER_SPLAT,
        **splat_kernel.block_plan(cfg))
    rec[key] = dict(ms=ms, plain_ms=plain_ms, err=err,
                    bound=(bound_ms, bound_by), library_ms=None)


def clustered_cloud(device, n=131072, hot=16384, seed=13):
    """A 1080p cloud that piles `hot` of its `n` live particles into one
    32-px tile (a Gaussian blob of sigma 5 px around (1003, 517), as a
    model's emitter or an explosion does) and spreads the rest over the
    frame; sizes 1-8 px, colours in [0, 1]: K5's (cfg, x, y, color, size,
    live) for the gauss kernel at 3 channels."""
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    rng = np.random.default_rng(seed)
    h, w = FULL["height"], FULL["width"]
    xy = np.empty((n, 2), np.float32)
    xy[:hot] = rng.normal((1003.0, 517.0), 5.0, (hot, 2))
    xy[hot:, 0] = rng.uniform(0, w, n - hot)
    xy[hot:, 1] = rng.uniform(0, h, n - hot)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    cfg = TiledRasterConfig(height=h, width=w, kernel="gauss", channels=3)
    return (cfg, t(xy[:, 0].copy()), t(xy[:, 1].copy()),
            t(rng.uniform(0, 1, (n, 4)).astype(np.float32)),
            t(rng.uniform(1, 8, n).astype(np.float32)),
            t(np.ones(n, bool)))


def _unique_bytes(view) -> float:
    """Bytes of the distinct elements a strided view reads (a dimension of
    stride 0 counts once)."""
    n = 1
    for size, stride in zip(view.shape, view.stride()):
        n *= size if stride else 1
    return float(n * view.element_size())


# K12's agreement with its plain version beyond the march bound: the
# share of the rays whose step count may differ (0-3 of 16,588,800 on an
# H100 80GB HBM3) and the largest |d| of a ray whose steps agree, as a
# share of 1 + the largest value (1.1e-4 - 1.7e-4 there, on outputs in
# [0, 1]).
MARCH_STEPS_DIFFER_MAX = 1e-5
MARCH_AGREE_TOL = 2.5e-4
# The plain loop's masking, per ray and step, that the kernel does not
# need (a dead ray leaves its loop): the three torch.where (steps, vis,
# offset) and the `live &` of the liveness update.
MARCH_MASK_OPS = 4


def exact_sqrt(fn):
    """fn() with every float32 aten sqrt correctly rounded, as the
    kernel's sqrtf is: taken in float64 and rounded once (53 bits are
    enough for the double rounding of a square root to be exact)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Exact(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.sqrt.default and \
                    args[0].dtype == torch.float32:
                return torch.sqrt(args[0].double()).float()
            return func(*args, **(kwargs or {}))

    with Exact():
        return fn()


def _march_gates(out, steps, ref, ref_steps, what, fields) -> dict:
    """The march bound (mean |d| <= 1e-3, 99% of the rays within 1e-3 x
    (1 + max)), at most MARCH_STEPS_DIFFER_MAX of the rays with another
    step count, every ray whose steps agree within MARCH_AGREE_TOL x (1 +
    max); raises unless all hold. -> the statistics."""
    d = (out - ref).abs()
    scale = 1.0 + float(ref.abs().max())
    tol = 1e-3 * scale
    err, err_mean = float(d.max()), float(d.mean())
    within = float((d <= tol).float().mean())
    agree = steps == ref_steps
    differ = int((~agree).sum())
    err_agree = float(torch.where(agree, d, 0.0).max())
    if not (err_mean <= 1e-3 and within >= 0.99):
        raise AssertionError(f"{what} disagrees with its plain version "
                             f"({fields}): mean {err_mean}, {within} of the "
                             f"rays within {tol}")
    if not (differ <= MARCH_STEPS_DIFFER_MAX * d.numel()
            and err_agree <= MARCH_AGREE_TOL * scale):
        raise AssertionError(f"{what} disagrees with its plain version "
                             f"({fields}): {differ} rays' steps differ, "
                             f"{err_agree} where they agree")
    return dict(err=err, err_mean=err_mean, within=within, tol=tol,
                differ=differ, err_agree=err_agree)


def parent_field(volume):
    """`volume` (an SdfVolume, AnalyticScene or ColumnField) as an instance
    of the parent package's class of the same name, sharing its tensors,
    so that the parent's K12 wrapper dispatches on it."""
    import importlib

    mod = importlib.import_module(type(volume).__module__.replace(
        "illuminant_tpu_torch", "parent_illuminant_tpu_torch", 1))
    obj = object.__new__(getattr(mod, type(volume).__name__))
    obj.__dict__.update(volume.__dict__)
    return obj


def _cone_trace_row(rec, key, call, **fields):
    """K12 on a recorded call (`cone_trace_cuda`'s (args, kwargs)) against
    its plain version `cone_trace_reference` on the same CUDA tensors,
    under `_march_gates`. The rays whose steps differ are counted again
    against the plain version with correctly rounded roots
    (`exact_sqrt`), printed, not gated. Both timed; with `--parent` the
    earlier commit's K12 too (held to the same gates, timed in turns);
    the bound: the rays' distinct input bytes, the field and the output
    once, or the operations this data needs (the plain version's
    `pointwise_ops` without a step and with one, the difference less its
    masking (MARCH_MASK_OPS) a ray's step, times the steps the rays took;
    on a ColumnField the column query's per point,
    `columns.query_reference`); the warps' efficiency (the steps a warp's
    rays take over 32 x its slowest ray's, rays in launch order: each warp
    runs as long as its slowest ray); the launch's block. On an SdfVolume
    the pack of its taps is timed too (`pack_ms`: once a new volume)."""
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
    from illuminant_tpu_torch.lighting.cone_trace import cone_trace_reference
    from illuminant_tpu_torch.sdf import columns
    from illuminant_tpu_torch.sdf.columns import ColumnField
    from illuminant_tpu_torch.sdf.volume import SdfVolume

    args, kwargs = call
    volume, quality = args[0], args[6]
    raw = kwargs.get("raw", args[7] if len(args) > 7 else False)
    a6 = tuple(args[:6])
    out, steps = ctk.cone_trace_cuda(*a6, quality, raw, with_steps=True)
    (ref, ref_steps), plain_ms = timed_once(lambda: cone_trace_reference(
        *a6, quality, raw, with_steps=True))
    g = _march_gates(out, steps, ref, ref_steps, "cone_trace", fields)
    _, exact_steps = exact_sqrt(lambda: cone_trace_reference(
        *a6, quality, raw, with_steps=True))
    differ_exact = int((steps != exact_steps).sum())
    plan = ctk.launch_plan(*a6, quality, raw)
    n = plan["lights"] * plan["points"]
    enable = plan["views"]["enable"].reshape(-1)
    taken = torch.where(enable, quality.max_step_count
                        - steps.reshape(-1), 0.0).double()
    q0 = dataclasses.replace(quality, max_step_count=0)
    q1 = dataclasses.replace(quality, max_step_count=1)
    ops0 = pointwise_ops(lambda: cone_trace_reference(*a6, q0, raw))
    per_step = (pointwise_ops(lambda: cone_trace_reference(*a6, q1, raw))
                - ops0) / n - MARCH_MASK_OPS
    if isinstance(volume, ColumnField):
        probe = plan["views"]["origin"].reshape(-1, 3)[:1 << 20]
        per_step += pointwise_ops(lambda: columns.query_reference(
            volume, probe[:, 0], probe[:, 1], probe[:, 2])) / probe.shape[0]
    ops = ops0 + per_step * float(taken.sum())
    nbytes = sum(_unique_bytes(v) for v in plan["views"].values()) \
        + sum(4.0 * t.numel() for t in plan["field_tensors"]
              if t is not None) + 4.0 * n
    bound_ms, bound_by = _bound(nbytes, ops)
    parent = PARENT.get("cone_trace")
    parent_call, parent_gates = None, {}
    if parent is not None:
        pa = (parent_field(volume),) + a6[1:]
        p_out, p_steps = parent.cone_trace_cuda(*pa, quality, raw,
                                                with_steps=True)
        pg = _march_gates(p_out, p_steps, ref, ref_steps,
                          "parent cone_trace", fields)
        parent_gates = dict(parent_max_abs_err=pg["err"],
                            parent_rays_whose_steps_differ=pg["differ"])
        parent_call = lambda: parent.cone_trace_cuda(  # noqa: E731
            *pa, quality, raw)
    ms, before = _in_turns(lambda: ctk.cone_trace_cuda(*a6, quality, raw),
                           parent_call, bound_ms)
    pack = {}
    if isinstance(volume, SdfVolume):
        data = volume.data
        pack_ms = device_ms(lambda: ctk.pack_volume(data), KERNEL_REPS)
        pack = dict(pack_ms=f"{pack_ms:.4f}")
    pad = (-n) % 32
    warps = torch.cat([taken, taken.new_zeros(pad)]).reshape(-1, 32)
    busy = float(warps.amax(dim=1).sum()) * 32.0
    efficiency = float(taken.sum()) / busy if busy else 1.0
    blocks = ctk.ray_blocks(plan)
    per_ray = torch.cat([taken, taken.new_zeros(1)])
    bw = per_ray[torch.where(blocks >= 0, blocks, n)].reshape(-1, 32)
    busy_b = float(bw.amax(dim=1).sum()) * 32.0
    efficiency_b = float(taken.sum()) / busy_b if busy_b else 1.0
    live = taken[enable]
    say("kernel", name="cone_trace", **fields,
        field=type(volume).__name__, rays=n, lights=plan["lights"],
        shape=json.dumps(list(plan["shape"])),
        raw=raw, max_abs_err=g["err"], mean_abs_err=g["err_mean"],
        share_within_1e3=f"{g['within']:.6f}", tol=g["tol"],
        rays_whose_steps_differ=g["differ"],
        max_abs_err_steps_agree=g["err_agree"],
        rays_whose_steps_differ_exact_sqrt=differ_exact,
        mean_steps=f"{float(live.mean()) if live.numel() else 0.0:.2f}",
        warp_efficiency=f"{efficiency:.3f}",
        warp_efficiency_launched=f"{efficiency_b:.3f}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, share_of_bound=f"{bound_ms / ms:.3f}",
        bytes=int(nbytes), operations=int(ops), library_ms=None, **before,
        **parent_gates, **pack, **ctk.block_plan(volume))
    rec[key] = dict(ms=ms, plain_ms=plain_ms, err=g["err"],
                    bound=(bound_ms, bound_by), library_ms=None)


def _pack_row(rec, key, volume, **fields):
    """The volume pack (the SdfVolume's taps as 16-byte records, rebuilt
    once a new volume, before its first march) against its plain version
    bit for bit, both timed, beside its byte bound (the volume read once,
    the pack written once)."""
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk

    data = volume.data
    out = ctk.pack_volume(data)
    ref, plain_ms = timed_once(lambda: ctk.pack_volume_reference(data))
    err = _max_err(out, ref)
    _require("volume_pack", err, 0.0, **fields)
    bound_ms, bound_by = _bound(4.0 * data.numel() * 5, 0)
    ms = device_ms(lambda: ctk.pack_volume(data), KERNEL_REPS)
    say("kernel", name="volume_pack", **fields,
        shape=json.dumps(list(data.shape)), max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, share_of_bound=f"{bound_ms / ms:.3f}",
        library_ms=None)
    rec[key] = dict(ms=ms, plain_ms=plain_ms, err=err,
                    bound=(bound_ms, bound_by), library_ms=None)


# Float32 operations (compares and selects included) of one K1 row-step:
# the fan (x + 0.5 - along, in front, valid, the clamp, the division, the
# clamp to [-1, 1], |f|, 1 - |f|, f >= 0: 11), each of the three carries'
# select, product, fused multiply-add and mask (12), the merge (the
# column's select, min, compare, the arg-min select, the exit band's add,
# clamp, compare and select: 8). The footprint adds its carry and merge
# (6), the extras the phase's add, round, clamp, the copy's compares and
# selects, the phase update and the masks and merges (16).
SCAN_WALK_OPS = 31
SCAN_WALK_FOOTPRINT_OPS = 6
SCAN_WALK_EXTRA_OPS = 16


def scan_walk_work(occ, lights, footprint, extra):
    """(bytes, operations) of one K1 call on an (H, W) grid: the carries
    of every sector written once, the images and the lights' three
    scalars read once; every (sector, light, row, column) step."""
    h, w = occ.shape
    carries = 4 if footprint else 3
    channels = carries + (2 if extra else 0)
    images = 1 + int(footprint) + (2 if extra else 0)
    n_bytes = 4 * (4 * channels * lights * h * w + images * h * w
                   + 3 * lights)
    n_ops = 4 * lights * h * w * (
        SCAN_WALK_OPS + (SCAN_WALK_FOOTPRINT_OPS if footprint else 0)
        + (SCAN_WALK_EXTRA_OPS if extra else 0))
    return n_bytes, n_ops


def flagship_walk(field="analytic"):
    """The walk arguments of one full-width flagship frame (8 lights, the
    270 x 480 nomination grid; the voxel field's carries take the extras
    and the footprint), from a scene of few particles."""
    from illuminant_tpu_torch.lighting import scan_shadows
    from illuminant_tpu_torch.scenes import build_flagship

    cuda = torch.device("cuda")
    scene = build_flagship(device=cuda, **dict(FULL, capacity=1 << 12,
                                               spawn_max=64), field=field)
    with KernelInputs("scan_walk", scan_shadows) as spy:
        _run_frames(scene, 1, 0, torch.Generator(device=cuda).manual_seed(0),
                    scene.system.state, torch.tensor(0.5, device=cuda))
    if len(spy.calls) != 1:
        raise AssertionError(f"the flagship frame walked {len(spy.calls)} "
                             "times; expected 1")
    return spy.calls[0]


def phase_scan_walk_kernel(rec):
    """`[kernel] name=scan_walk` (K1) on the analytic and the voxel
    flagship's walks: the kernel against the eager loop on the same CUDA
    tensors (every channel bit for bit, counted), its time by CUDA-graph
    replay beside its bound and its block; the eager loop's time run as
    the frame runs it (`plain_ms`, the host's launches in it) and
    captured in a CUDA graph (`graph_ms`: its device work without the
    launch overhead)."""
    from illuminant_tpu_torch.lighting import scan_shadows
    from illuminant_tpu_torch.lighting import scan_walk_kernel as k1

    for field in ("analytic", "voxel"):
        args, kw = flagship_walk(field)
        occ, lx = args[0], args[1]
        extra, fp = args[5], args[6]
        _reset_launches()
        got = k1.scan_walk_cuda(*args, **kw)
        launches = _launches()["k1_scan_walk"]
        ref, first_ms = timed_once(
            lambda: scan_shadows.scan_walk_reference(*args, **kw))
        torch.cuda.synchronize()
        differ = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        if launches != 1 or differ:
            raise AssertionError(f"scan_walk ({field}): {launches} "
                                 f"launches, {differ} elements differ from "
                                 "the eager loop")
        n_bytes, n_ops = scan_walk_work(occ, lx.shape[0], fp is not None,
                                        bool(extra))
        bound = _bound(n_bytes, n_ops)
        plan = k1.block_plan(*occ.shape, lx.shape[0], fp is not None,
                             bool(extra))
        ms = device_ms(lambda: k1.scan_walk_cuda(*args, **kw), KERNEL_REPS)
        plain_ms = eager_ms(
            lambda: scan_shadows.scan_walk_reference(*args, **kw), 3)
        graph_ms = device_ms(
            lambda: scan_shadows.scan_walk_reference(*args, **kw), 2)
        say("kernel", name="scan_walk", inputs=f"flagship_{field}",
            grid=f"{occ.shape[0]}x{occ.shape[1]}", lights=lx.shape[0],
            channels=plan["channels"], elements_differ=differ,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            plain_first_ms=f"{first_ms:.4f}", graph_ms=f"{graph_ms:.4f}",
            bound_ms=f"{bound[0]:.4f}", bound_by=bound[1],
            share_of_bound=f"{bound[0] / ms:.3f}", bytes=n_bytes,
            operations=n_ops, **{k: plan[k] for k in (
                "blocks", "threads", "rows_per_thread", "tile_cols",
                "smem_bytes", "registers", "spill_bytes")})
        rec["scan_walk_" + field] = dict(ms=ms, plain_ms=plain_ms,
                                         graph_ms=graph_ms, err=0.0,
                                         bound=bound)
        args = kw = got = ref = None
        torch.cuda.empty_cache()
    return rec


# Float32 operations of one readout point outside the field (K2): the
# sector select (the texel's offset, the fraction, the mask: 12), the
# ray geometry (dx, dy, |.|, max, clamp, the root's six, sec: 14), the
# cone (clamp, max_radius, growth: 4), the trace budget (4), a
# candidate's t, its endpoints and height (10), its cone radius and ratio
# (8), the guard (12), the thresholds and the power (6); each staged
# channel of a halving (the row and column passes: 6 products, 3 sums; 4
# channels, 7 carried) and the normalisation (6). The field: a primitive's
# operations by type (sdf_fields.cuh: the box 19, the ellipsoid 35, the
# cylinder 22, the spheroid 29, the octagon 46; a rotation 30 more), an
# extruded polygon's 12 and 22 an edge; the carried reconstruction 11.
SCAN_READOUT_OPS = 62
SCAN_READOUT_CANDIDATE_OPS = 18
SCAN_READOUT_UPSAMPLE_OPS = 9
SCAN_READOUT_NORMALISE_OPS = 6
PRIMITIVE_OPS = {1: 35, 2: 19, 3: 22, 4: 29, 5: 46}
ROTATION_OPS = 30
POLYGON_OPS = 12
POLYGON_EDGE_OPS = 22
CARRIED_OPS = 11


def scan_readout_work(args, kw):
    """(bytes, operations) of one K2 call: the selected sector's channels
    of each nomination texel read once, the per-pixel heights and offsets
    read once (per lane where they are per lane), the visibility written
    once; every point's readout, its candidates' field evaluations (the
    scene counted as sdf_fields.cuh evaluates it) and its halvings'
    upsample."""
    from illuminant_tpu_torch.lighting import scan_readout_kernel as k2
    from illuminant_tpu_torch.sdf.analytic import AnalyticScene

    scene, walk, quality = args[0], args[1], args[7]
    height, width, halvings, use_cols = args[9], args[10], args[12], args[13]
    lights, nh, nw = walk.shape[2], walk.shape[3], walk.shape[4]
    channels = 6 if use_cols else 3
    n_bytes = 4 * (channels * lights * nh * nw + lights * height * width)
    for key in ("pixel_z", "pixel_offset_xy"):
        if kw.get(key) is not None:
            n_bytes += 4 * kw[key].numel()
    points = lights * height * width
    candidates = min(max(quality.scan_refine_samples, 0), 3)
    field = 0
    if use_cols:
        field = CARRIED_OPS
    elif isinstance(scene, AnalyticScene) and candidates:
        records, _ = k2.k12.analytic_records(scene)
        for r in records.tolist():
            field += PRIMITIVE_OPS[int(r[0])] + (ROTATION_OPS if r[1] > 0.5
                                                 else 0)
        if scene.polygons is not None:
            p = scene.polygons
            field += p.capacity * (POLYGON_OPS + POLYGON_EDGE_OPS
                                   * int(p.vertices.shape[1]))
    staged = k2.CHANNELS[use_cols]
    per_point = (SCAN_READOUT_OPS + candidates * (SCAN_READOUT_CANDIDATE_OPS
                                                  + field)
                 + (halvings * staged * SCAN_READOUT_UPSAMPLE_OPS
                    + SCAN_READOUT_NORMALISE_OPS if halvings else 0))
    return n_bytes, points * per_point


def scan_readout_call(cell: str):
    """The readout's call in one frame of a benchmark cell (`framebench/`)
    from a fixed seed: "flagship" (flagship-scan-1080p: 8 lanes, its
    4-primitive analytic scene) or "renderer_25d" (renderer-25d-1080p: 16
    lanes, the turned box and three extruded prisms) -> the call's (args,
    kwargs) as `scan_readout_kernel.scan_readout_cuda` takes them."""
    from framebench.lib.loader import json_file, module
    from illuminant_tpu_torch.lighting import scan_readout_kernel as k2

    config, workload = {
        "flagship": ("flagship-analytic-1080p", "flagship-scan-1080p"),
        "renderer_25d": ("renderer-25d-scan-1080p",
                         "renderer-25d-1080p")}[cell]
    built = module("scenes", config).build(
        json_file("configs", config), json_file("workloads", workload),
        2_718_281_828, torch.device("cuda"))
    with KernelInputs("scan_readout_cuda", k2) as spy:
        built.step()
    torch.cuda.synchronize()
    built.release()
    if len(spy.calls) != 1:
        raise AssertionError(f"the {cell} frame read the scan out "
                             f"{len(spy.calls)} times; expected 1")
    return spy.calls[0]


def phase_scan_readout_kernel(rec):
    """`[kernel] name=scan_readout` (K2) on the readouts of the flagship
    scan cell's frame (8 lanes) and the 2.5D renderer cell's (16 lanes),
    540 x 960 from a 270 x 480 walk: the kernel against its plain version
    on the same CUDA tensors (every pixel bit for bit; one launch), its
    time by CUDA-graph replay beside its bound (bytes or operations, the
    larger: `scan_readout_work`) and its block, and the plain version run
    as the frame ran it (`plain_ms`) and captured in a CUDA graph
    (`graph_ms`)."""
    from illuminant_tpu_torch.lighting import scan_readout_kernel as k2
    from illuminant_tpu_torch.lighting import scan_shadows

    for cell in ("flagship", "renderer_25d"):
        args, kw = scan_readout_call(cell)
        _reset_launches()
        got = k2.scan_readout_cuda(*args, **kw)
        launches = _launches()["k2_scan_readout"]
        ref = scan_shadows.scan_readout_reference(*args, **kw)
        torch.cuda.synchronize()
        differ = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        if launches != 1 or differ:
            raise AssertionError(f"scan_readout ({cell}): {launches} "
                                 f"launches, {differ} pixels differ from "
                                 "the plain version")
        n_bytes, n_ops = scan_readout_work(args, kw)
        bound = _bound(n_bytes, n_ops)
        name, _, f_ints, _, _ = k2._field(args[0], args[7], args[13])
        plan = k2.block_plan(args[9], args[10], args[1].shape[2], args[12],
                             name, k2.k12.analytic_smem_bytes(f_ints) // 4
                             if name == "analytic" else 0)
        ms = device_ms(lambda: k2.scan_readout_cuda(*args, **kw),
                       KERNEL_REPS)
        plain_ms = eager_ms(
            lambda: scan_shadows.scan_readout_reference(*args, **kw), 3)
        graph_ms = device_ms(
            lambda: scan_shadows.scan_readout_reference(*args, **kw), 2)
        say("kernel", name="scan_readout", inputs=cell,
            grid=f"{args[9]}x{args[10]}", lanes=args[1].shape[2],
            halvings=args[12], instance=name, elements_differ=differ,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            graph_ms=f"{graph_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
            bound_by=bound[1], share_of_bound=f"{bound[0] / ms:.3f}",
            bytes=n_bytes, operations=n_ops, **{k: plan[k] for k in (
                "smem_bytes", "registers", "spill_bytes", "blocks_per_sm")})
        rec["scan_readout_" + cell] = dict(ms=ms, plain_ms=plain_ms,
                                           graph_ms=graph_ms, err=0.0,
                                           bound=bound)
        args = kw = got = ref = None
        torch.cuda.empty_cache()
    return rec


def integrate_call(cell: str):
    """The collision integrate's call in one frame of a benchmark cell
    (`framebench/`), on its own steady population from a fixed seed:
    "flagship" (flagship-scan-1080p: the analytic field, one substep) or
    "particles" (particles-collide-1080p: the ColumnField, three) -> the
    call's (args, kwargs) as `integrate_kernel.integrate_cuda` takes
    them."""
    from framebench.lib.loader import json_file, module
    from illuminant_tpu_torch.particles import integrate_kernel as k4

    config, workload = {
        "flagship": ("flagship-analytic-1080p", "flagship-scan-1080p"),
        "particles": ("particles-config4-1080p",
                      "particles-collide-1080p")}[cell]
    built = module("scenes", config).build(
        json_file("configs", config), json_file("workloads", workload),
        2_718_281_828, torch.device("cuda"))
    with KernelInputs("integrate_cuda", k4) as spy:
        built.step()
    torch.cuda.synchronize()
    built.release()
    return spy.calls[-1]


def phase_integrate_kernel(rec):
    """`[kernel] name=collide_integrate` (K4) on the integrate calls of
    the flagship's (1,048,576 slots, the analytic field, one substep) and
    the particle cell's frames (1,048,576 slots, the ColumnField, three):
    the kernel against its plain version on the same CUDA tensors (every
    element of the four output rows, bit for bit; one launch a call), its
    time by CUDA-graph replay beside its byte bound (112 B a slot at 3.35
    TB/s) and its block, and the plain version run as the frame ran it
    (`plain_ms`, the host's launches in it) and captured in a CUDA graph
    (`graph_ms`)."""
    from illuminant_tpu_torch.particles import integrate as integ
    from illuminant_tpu_torch.particles import integrate_kernel as k4

    for cell in ("flagship", "particles"):
        args, kw = integrate_call(cell)
        state, volume, substeps = args[0], args[3], args[5]
        _reset_launches()
        got = k4.integrate_cuda(*args, **kw)
        launches = _launches()["k4_integrate"]
        ref = integ.integrate_with_distance_field_reference(*args, **kw)
        torch.cuda.synchronize()
        differ = sum(int((getattr(got, p).view(torch.int32)
                          != getattr(ref, p).view(torch.int32)).sum())
                     for p in ("position", "velocity", "render_color",
                               "render_data"))
        if launches != 1 or differ:
            raise AssertionError(
                f"collide_integrate ({cell}): {launches} launches, "
                f"{differ} elements differ from the plain version")
        collided = int((got.velocity[:, 3] == integ.BOUNCE_DELAY).sum())
        n = state.capacity
        n_bytes = k4.BYTES_PER_SLOT * n
        bound = _bound(n_bytes, 0.0)
        plan = k4.block_plan(volume, substeps)
        ms = device_ms(lambda: k4.integrate_cuda(*args, **kw), KERNEL_REPS)
        plain_ms = eager_ms(
            lambda: integ.integrate_with_distance_field_reference(
                *args, **kw), 3)
        graph_ms = device_ms(
            lambda: integ.integrate_with_distance_field_reference(
                *args, **kw), 2)
        say("kernel", name="collide_integrate", inputs=cell, slots=n,
            substeps=substeps, live=int(state.live_count()),
            bounce_delay_set=collided, elements_differ=differ,
            launches=launches, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            graph_ms=f"{graph_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
            bound_by=bound[1], share_of_bound=f"{bound[0] / ms:.3f}",
            bytes=n_bytes, **plan)
        rec["collide_integrate_" + cell] = dict(
            ms=ms, plain_ms=plain_ms, graph_ms=graph_ms, err=0.0,
            bound=bound)
        args = kw = got = ref = state = volume = None
        torch.cuda.empty_cache()
    return rec


def spawn_call(cell: str):
    """The spawn's call in one frame of a benchmark cell (`framebench/`),
    on its own steady population from a fixed seed: "flagship"
    (flagship-scan-1080p: 4,096 rows, the emission path and the velocity
    matrix animated at the frame's time) or "particles"
    (particles-collide-1080p: 4,096 rows, static uniforms) -> the call's
    (args, kwargs) as `spawn_kernel.spawn_cuda` takes them."""
    from framebench.lib.loader import json_file, module
    from illuminant_tpu_torch.particles import spawn_kernel as k4b

    config, workload = {
        "flagship": ("flagship-analytic-1080p", "flagship-scan-1080p"),
        "particles": ("particles-config4-1080p",
                      "particles-collide-1080p")}[cell]
    built = module("scenes", config).build(
        json_file("configs", config), json_file("workloads", workload),
        2_718_281_828, torch.device("cuda"))
    with KernelInputs("spawn_cuda", k4b) as spy:
        built.step()
    torch.cuda.synchronize()
    built.release()
    return spy.calls[-1]


def phase_spawn_kernel(rec):
    """`[kernel] name=spawn` (K4b) on the spawn calls of the flagship's
    and the particle cell's frames (4,096 rows into 1,048,576 slots): the
    kernel against its plain version on copies of the same CUDA state,
    its rows NaN (the recorded state already holds the frame's own spawn,
    which a kernel that wrote nothing would match): every row of the
    ring, the cursor and the total bit for bit, rows written, one launch
    a call. Its time by CUDA-graph replay beside its byte bound
    (`spawn_kernel.bytes_moved`: 48 B a computed row, 48 B a written one,
    the uniforms once, at 3.35 TB/s: it is bound by latency) and its
    block, and the plain version run as the frame ran it (`plain_ms`, the
    host's launches in it)."""
    from illuminant_tpu_torch.particles import spawn_kernel as k4b
    from illuminant_tpu_torch.particles import spawner

    def fresh(state):
        return state.replace(**{p: torch.full_like(getattr(state, p),
                                                   float("nan"))
                                for p in ("position", "velocity", "color")})

    for cell in ("flagship", "particles"):
        args, kw = spawn_call(cell)
        state, u, count, spawn_max, draws, sub_rings, shard, t = args
        _reset_launches()
        got = k4b.spawn_cuda(fresh(state), *args[1:], **kw)
        launches = _launches()["k4b_spawn"]
        ref = spawner.spawn_reference(fresh(state), u, count, spawn_max,
                                      None, draws, sub_rings, shard, t)
        torch.cuda.synchronize()
        differ = sum(int((getattr(got, p).view(torch.int32)
                          != getattr(ref, p).view(torch.int32)).sum())
                     for p in ("position", "velocity", "color",
                               "write_cursor", "total_spawned"))
        written = int((~torch.isnan(got.position)).any(dim=1).sum())
        if launches != 1 or differ or not written:
            raise AssertionError(
                f"spawn ({cell}): {launches} launches, {differ} elements "
                f"differ from the plain version, {written} rows written")
        n_bytes = k4b.bytes_moved(u, int(count), written)
        bound = _bound(n_bytes, 0.0)
        scratch = fresh(state)
        ms = device_ms(lambda: k4b.spawn_cuda(scratch, *args[1:], **kw),
                       KERNEL_REPS)
        plain_ms = eager_ms(lambda: spawner.spawn_reference(
            scratch, u, count, spawn_max, None, draws, sub_rings, shard, t),
            3)
        say("kernel", name="spawn", inputs=cell, rows=spawn_max,
            slots=state.capacity, animated=u.position_path is not None,
            elements_differ=differ, launches=launches, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
            bound_by=bound[1], share_of_bound=f"{bound[0] / ms:.3f}",
            written=written, bytes=n_bytes, **k4b.block_plan())
        rec["spawn_" + cell] = dict(ms=ms, plain_ms=plain_ms, err=0.0,
                                    bound=bound)
        args = kw = got = ref = state = scratch = None
        torch.cuda.empty_cache()
    return rec


def modifier_call():
    """The modifier chain's call in one frame of the particle cell
    (particles-collide-1080p: VectorField, Gravity and Noise over
    1,048,576 slots), on its own steady population from a fixed seed ->
    the call's (args, kwargs) as `modifier_kernel.modifiers_cuda` takes
    them."""
    from framebench.lib.loader import json_file, module
    from illuminant_tpu_torch.particles import modifier_kernel as k4c

    built = module("scenes", "particles-config4-1080p").build(
        json_file("configs", "particles-config4-1080p"),
        json_file("workloads", "particles-collide-1080p"), 2_718_281_828,
        torch.device("cuda"))
    with KernelInputs("modifiers_cuda", k4c) as spy:
        built.step()
    torch.cuda.synchronize()
    built.release()
    return spy.calls[-1]


def phase_modifier_kernel(rec):
    """`[kernel] name=modifiers` (K4c) on the modifier chain of the
    particle cell's frame (VectorField, Gravity, Noise over 1,048,576
    slots): the kernel, writing into NaN-filled rows (a kernel that wrote
    nothing fails), against its plain version on the same CUDA tensors:
    every element of both rows bit for bit, one launch a call. Its time by
    CUDA-graph replay beside its byte bound (`modifier_kernel.bytes_moved`:
    64 B a slot and the uniforms once, at 3.35 TB/s) and its block, and the
    plain version run as the tick ran it (`plain_ms`, the host's launches
    in it) and captured in a CUDA graph (`graph_ms`)."""
    from illuminant_tpu_torch.particles import modifier_kernel as k4c
    from illuminant_tpu_torch.particles.transforms import \
        apply_modifiers_reference

    args, kw = modifier_call()
    position, velocity, steps = args[:3]

    def nans():
        return (torch.full_like(position, float("nan")),
                torch.full_like(velocity, float("nan")))

    _reset_launches()
    got = k4c.modifiers_cuda(*args, **kw, out=nans())
    launches = _launches()["k4c_modifiers"]
    ref = apply_modifiers_reference(*args)
    torch.cuda.synchronize()
    differ = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                 for a, b in zip(got, ref))
    if launches != 1 or differ:
        raise AssertionError(f"modifiers: {launches} launches, {differ} "
                             "elements differ from the plain version")
    prog = k4c.program(steps)
    n = position.shape[0]
    n_bytes = k4c.bytes_moved(prog, n)
    bound = _bound(n_bytes, 0.0)
    scratch = nans()
    ms = device_ms(lambda: k4c.modifiers_cuda(*args, **kw, out=scratch),
                   KERNEL_REPS)
    plain_ms = eager_ms(lambda: apply_modifiers_reference(*args), 3)
    graph_ms = device_ms(lambda: apply_modifiers_reference(*args), 2)
    say("kernel", name="modifiers", inputs="particles", slots=n,
        steps="+".join(f"{kind}{a or ''}" for kind, a in prog),
        live=int((position[:, 3] > 0).sum()), elements_differ=differ,
        launches=launches, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        graph_ms=f"{graph_ms:.4f}", bound_ms=f"{bound[0]:.4f}",
        bound_by=bound[1], share_of_bound=f"{bound[0] / ms:.3f}",
        bytes=n_bytes, **k4c.block_plan())
    rec["modifiers_particles"] = dict(ms=ms, plain_ms=plain_ms,
                                      graph_ms=graph_ms, err=0.0,
                                      bound=bound)
    return rec


def phase_voxel_march_kernel(field, scene):
    """K12 on the voxel flagship's ColumnField at 1080p (the voxel slice's
    loaded static field and its maps): the sphere lights' rays as the
    march pass makes them (`accumulate_sphere_lights(shadow_mode="march")`
    on the slice's G-buffer and lights, its K12 call kept)."""
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
    from illuminant_tpu_torch.lighting.sphere import accumulate_sphere_lights

    env_u = scene.environment.uniforms(device=scene.device)
    with KernelInputs("cone_trace_cuda", ctk) as spy:
        accumulate_sphere_lights(field, scene.gbuffer, scene.sphere_lights,
                                 env_u, scene.config.quality,
                                 with_specular=False, shadow_mode="march",
                                 with_ao=False, with_alpha=False)
    rec = {}
    _cone_trace_row(rec, "cone_trace_voxel", spy.calls[0],
                    inputs="voxel_flagship")
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


def flagship_render_reads_nothing(scene, state):
    """The frame's splat (`_FlagshipFrame.raster`'s call) on `state` under
    torch.cuda.set_sync_debug_mode("error"): a synchronizing operation in
    it (a `nonzero`, an `item`) raises. -> the image."""
    from illuminant_tpu_torch.raster.tiled import rasterize_tiled

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, _ = rasterize_tiled(
            scene.raster_config, state.position[:, 0], state.position[:, 1],
            state.render_color, state.render_data[:, 0], state.live_mask())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return img


def phase_slice(name, scene, warmup: int, frames: int):
    """One flagship frame at full width: warm-up, then the timed frames
    that the launch counters watch, then one frame under the host-read
    counter (its K12 calls kept) and its splat once more under the sync
    debug mode. Every slice collides in K4 once a frame; the voxel slice
    packs its frame's new maps for it once a frame and launches the fused
    query and the sampler never; the analytic slices launch none of the
    column kernels. Every slice spawns through K4b once a frame. K5 launches once a frame, K12
    K12_PER_FRAME[name] times; a frame reads the device
    FLAGSHIP_READS_PER_FRAME times. Returns (launches, state,
    ms_per_frame, the extra frame's K12 calls). K1 and K2 launch
    SCAN_WALK_PER_FRAME[name] times a frame."""
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
    from illuminant_tpu_torch.raster import splat_kernel as k5

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(0)
    state = scene.system.state
    avg = torch.tensor(0.5, device=dev)
    torch.cuda.reset_peak_memory_stats()
    img, state, avg = _run_frames(scene, warmup, 0, gen, state, avg)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    img, state, avg = _run_frames(scene, frames, warmup, gen, state, avg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    SLICE_LAST[name] = (img.clone(), float(avg))
    launches = _launches("k7_column_query", "k7_column_pack",
                         "k7_column_sample", "k12_cone_trace", "k5_splat",
                         "k1_scan_walk", "k2_scan_readout", "k4_integrate",
                         "k4b_spawn", "k4c_modifiers")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with HostReads() as reads, KernelInputs("cone_trace_cuda", ctk) as k12:
        _, state, avg = _run_frames(scene, 1, warmup + frames, gen, state,
                                    avg)
    torch.cuda.synchronize()
    flagship_render_reads_nothing(scene, state)
    live = int(state.live_count())
    img_np = img.cpu().numpy()
    avg_f = float(avg)
    ms_per_frame = 1000.0 * secs / frames
    say(name, **SLICES[name], warmup=warmup, frames=frames,
        ms_per_frame=f"{ms_per_frame:.3f}", live_particles=live,
        avg_lum=f"{avg_f:.5f}", peak_mem_gb=f"{peak_gb:.3f}",
        image=f"{img_np.shape}/{img_np.dtype}",
        **{f"{k}_launches": v for k, v in launches.items()},
        host_reads_per_frame=reads.n, render_sync_debug="error: none")
    if img_np.shape != (FULL["height"], FULL["width"], 3):
        raise AssertionError(f"{name}: image shape {img_np.shape}")
    if not img_np.astype(np.float64).var() > 0.0:
        raise AssertionError(f"{name}: the frame is one flat colour")
    if not live > 0:
        raise AssertionError(f"{name}: no live particles")
    if not math.isfinite(avg_f):
        raise AssertionError(f"{name}: avg_lum {avg_f}")
    packs = 1 if SLICES[name]["field"] == "voxel" else 0
    expected = dict(k7_column_query=0, k7_column_pack=packs * frames,
                    k7_column_sample=0,
                    k12_cone_trace=K12_PER_FRAME[name] * frames,
                    k5_splat=k5.LAUNCHES_PER_SPLAT * frames,
                    k1_scan_walk=SCAN_WALK_PER_FRAME[name] * frames,
                    k2_scan_readout=SCAN_WALK_PER_FRAME[name] * frames,
                    k4_integrate=frames, k4b_spawn=frames,
                    k4c_modifiers=frames)
    if launches != expected:
        raise AssertionError(f"{name}: kernels launched {launches} times in "
                             f"{frames} frames, expected {expected}")
    if reads.n != FLAGSHIP_READS_PER_FRAME or \
            len(k12.calls) != K12_PER_FRAME[name]:
        raise AssertionError(f"{name}: a frame read the device {reads.n} "
                             f"times and launched K12 {len(k12.calls)} "
                             f"times, expected {FLAGSHIP_READS_PER_FRAME} "
                             f"and {K12_PER_FRAME[name]}")
    return launches, state, ms_per_frame, k12.calls


def _small_frames(device, draws, **kw):
    """Three frames of the small flagship on `device` from the same state
    with the given spawn draws -> (images int32, positions, avg_lum,
    fused-query launches, pack launches, K12 launches, K4 launches)."""
    from illuminant_tpu_torch.scenes import build_flagship

    scene = build_flagship(device=device, **SMALL, **kw)
    _reset_launches()
    img, state, avg = _run_frames(
        scene, 3, 0, None, scene.system.state,
        torch.tensor(0.5, device=device), spawn_uniforms=draws)
    return (img.cpu().numpy().astype(np.int32), state.position.cpu().numpy(),
            float(avg), *_launches("k7_column_query", "k7_column_pack",
                                   "k12_cone_trace", "k4_integrate").values())


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
    same spawn draws. The card's frames collide in K4, once a frame at
    both presets, and run the fused query never (the integrate's plain
    version ran it 2 and 5 times a frame). Fast keeps the voxel slice's
    bound, 99% of particles within 0.05; parity is held to those of
    tests/test_torch_analytic_flagship.py.
    """
    draws = _draws()
    for preset in ("fast", "parity"):
        kw = dict(field="voxel", preset=preset)
        out = {dev: _small_frames(dev, draws, **kw)
               for dev in ("cpu", "cuda")}
        launches, k4_launches = out["cuda"][3], out["cuda"][6]
        within, within_1e3 = _compare_small(
            "reference", out["cpu"], out["cuda"], **kw,
            column_query_launches=launches, collide_integrate=k4_launches)
        if (launches, k4_launches) != (0, 3):
            raise AssertionError(f"reference ({kw}): the fused query "
                                 f"launched {launches} times and K4 "
                                 f"{k4_launches} in 3 frames")
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
# the projector's AO sample (lighting/projector.py; its cone march runs no
# step: the flagship's projector has no origin). The exact per-candidate
# refine of the volumetric light's windowed scan (a windowed view never
# takes the carried refine, lighting/scan_shadows.py) samples the field
# inside K2, the collision inside K4. The sun's and the line light's AO
# are gated off on the host, the particle lights' template has no AO
# radius, and every grid query samples the volume itself. The projector's
# march is one K12 launch; K12, K4 and K2 share the frame's one pack of
# its new maps (`columns_kernel.packed`).
FAMILY_VOXEL_QUERIES_PER_FRAME = 1


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
        queries, packs, k12, k4_launches = out["cuda"][3:7]
        within, within_1e3 = _compare_small(
            "reference_family", out["cpu"], out["cuda"], **kw,
            column_query_launches=queries, column_maps_pack_launches=packs,
            cone_trace_launches=k12, collide_integrate=k4_launches)
        voxel = kw["field"] == "voxel"
        if voxel:
            expected = 3 * FAMILY_VOXEL_QUERIES_PER_FRAME
            ok = within >= 0.99
        else:
            expected = 0
            ok = within == 1.0 and within_1e3 >= 0.999
        # K12's, K4's and K2's pack: once a frame's new maps.
        want_packs = expected + (3 if voxel else 0)
        if (queries, packs, k12, k4_launches) != (expected, want_packs, 3,
                                                  3):
            raise AssertionError(
                f"reference_family ({kw}): the fused query launched "
                f"{queries} times, its pack {packs} times, K12 {k12} and "
                f"K4 {k4_launches} times in 3 frames, expected {expected}, "
                f"{want_packs}, 3 and 3")
        if not ok:
            raise AssertionError(f"reference_family ({kw}): particles "
                                 "moved apart")


def _to_device(obj, device):
    """A copy of a field (a tensor dataclass, nested ones and tuples of
    tensors included) or tensor on `device`."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(_to_device(o, device) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def _march_against_cpu(call, **fields):
    """A recorded K12 call on the card against the plain march on CPU
    copies of its arguments, under the march bound: mean |d| <= 1e-3 and
    99% of the rays within 1e-3 x (1 + max)."""
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
    from illuminant_tpu_torch.lighting.cone_trace import cone_trace_reference

    args, kwargs = call
    out = ctk.cone_trace_cuda(*args, **kwargs).cpu()
    ref = cone_trace_reference(*_to_device(tuple(args), "cpu"), **kwargs)
    d = (out - ref).abs()
    tol = 1e-3 * (1.0 + float(ref.abs().max()))
    mean, within = float(d.mean()), float((d <= tol).float().mean())
    if not (mean <= 1e-3 and within >= 0.99):
        raise AssertionError(f"reference_march ({fields}): the card's march "
                             f"against the CPU's: mean {mean}, {within} "
                             f"within {tol}")
    return dict(march_mean_abs=f"{mean:.2e}", march_max_abs=float(d.max()),
                march_within_1e3=f"{within:.5f}")


# K12 launches a small march frame: the sphere pass, and with the families
# the sun's march and the projector's.
MARCH_K12_PER_FRAME = {False: 1, True: 3}


def phase_reference_march():
    """The flagship with shadow_mode="march" at 96 x 160 on the card
    against the port's plain CPU path (held to the JAX package by
    tests/test_torch_march_flagship.py): three frames from the same draws
    on the analytic and the voxel field, without and with the families,
    to the bounds of `reference_analytic` and `reference` (voxel); K12
    launched MARCH_K12_PER_FRAME times a frame (on the voxel field K12 and
    K4 share one pack of the frame's new maps); the first frame's sphere
    march on
    the card against the plain march on the CPU under the march bound.
    Then the analytic scan frame under `scan_refine_mode="carried_all"`
    and at `shadow_scale=0.25`, to `reference_analytic`'s bounds."""
    from illuminant_tpu_torch.core.config import QualitySettings
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk

    draws = _draws()
    for field in ("analytic", "voxel"):
        for family in (False, True):
            kw = dict(field=field, preset="fast", shadow_mode="march",
                      full_family=family)
            cpu = _small_frames("cpu", draws, **kw)
            with KernelInputs("cone_trace_cuda", ctk) as spy:
                cuda = _small_frames("cuda", draws, **kw)
            queries, packs, k12 = cuda[3:6]
            march = _march_against_cpu(spy.calls[0], **kw)
            within, within_1e3 = _compare_small(
                "reference_march", cpu, cuda, **kw, cone_trace_launches=k12,
                column_query_launches=queries,
                column_maps_pack_launches=packs, **march)
            # On the voxel field K12 and K4 share each frame's one pack.
            voxel_packs = 3 if field == "voxel" else 0
            ok = (within >= 0.99 if field == "voxel"
                  else within == 1.0 and within_1e3 >= 0.999)
            if k12 != 3 * MARCH_K12_PER_FRAME[family] or \
                    packs != queries + voxel_packs:
                raise AssertionError(
                    f"reference_march ({kw}): K12 launched {k12} times, the "
                    f"pack {packs} times for {queries} queries")
            if not ok:
                raise AssertionError(f"reference_march ({kw}): particles "
                                     "moved apart")
    for q_kw in (dict(scan_refine_mode="carried_all"),
                 dict(shadow_scale=0.25)):
        kw = dict(field="analytic", preset="fast",
                  quality=QualitySettings(**q_kw))
        out = {dev: _small_frames(dev, draws, **kw)
               for dev in ("cpu", "cuda")}
        within, within_1e3 = _compare_small(
            "reference_march", out["cpu"], out["cuda"], field="analytic",
            shadow_mode="scan", **q_kw)
        if not (within == 1.0 and within_1e3 >= 0.999):
            raise AssertionError(f"reference_march ({q_kw}): particles "
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
# K12 launches a renderer frame: one a light pass under the march (the
# march frame's 8 ring lights are one additive pass); the scan frame none.
RENDERER_K12_PER_FRAME = {"slice_renderer": 0, "slice_renderer_march": 1}


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
    frame (gated 0; its K12 call kept), then the frame's gates: K12 once a
    light pass under the march, the volume pack once a frame there.
    Returns (ms/frame, the extra frame's last K12 call or None, the pack's
    launches in the timed frames)."""
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk

    renderer, hdr, move, shadow_mode, budget = _build_renderer(
        name, "cuda", FULL["height"], FULL["width"])
    torch.cuda.reset_peak_memory_stats()
    n = 0
    for _ in range(RENDERER_WARMUP_FRAMES):
        renderer_frame(renderer, hdr, move, n, shadow_mode, budget)
        n += 1
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(RENDERER_TIMED_FRAMES):
        image, lightmap = renderer_frame(renderer, hdr, move, n, shadow_mode,
                                         budget)
        torch.cuda.synchronize()
        n += 1
    ms_per_frame = 1e3 * (time.perf_counter() - t0) / RENDERER_TIMED_FRAMES
    counts = _launches()
    launches = sum(counts[k] for k in ("k7_column_sample", "k7_column_query",
                                       "k7_column_pack"))
    k12, packs = counts["k12_cone_trace"], counts["k12_volume_pack"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with HostReads() as reads, KernelInputs("cone_trace_cuda", ctk) as spy:
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
        column_kernel_launches=launches, cone_trace_launches=k12,
        volume_pack_launches=packs, **gates)
    if reads.n or k12 != RENDERER_K12_PER_FRAME[name] * RENDERER_TIMED_FRAMES:
        raise AssertionError(
            f"{name}: {reads.n} host reads a frame, K12 launched {k12} "
            f"times in {RENDERER_TIMED_FRAMES} frames; expected 0 and "
            f"{RENDERER_K12_PER_FRAME[name]} a frame")
    # A frame's field is a new volume: its taps are packed once, before
    # its first march.
    if packs != (RENDERER_TIMED_FRAMES if RENDERER_K12_PER_FRAME[name]
                 else 0):
        raise AssertionError(f"{name}: the volume pack launched {packs} "
                             f"times in {RENDERER_TIMED_FRAMES} frames")
    return ms_per_frame, (spy.calls[-1] if spy.calls else None), packs


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
    ticks' launches {"k7_column_query": the fused query's,
    "k4_integrate": K4's, "k4c_modifiers": K4c's}). `random_fields`: the Noise fields to use, one a system (a
    device's generator draws its own)."""
    from illuminant_tpu_torch.ops.noise import RandomField
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    systems = small_particle_systems(name, device)
    for system, field in zip(systems, random_fields or ()):
        system.random_field = RandomField(data=field.to(device))
    _reset_launches()
    for tick in draws:
        for system, d in zip(systems, tick):
            system.tick(DT, spawn_uniforms=d)
    launches = _launches("k7_column_query", "k4_integrate", "k4c_modifiers")
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
    their mean. Every system with a field collides in K4 once a tick,
    every system with modifiers runs them in K4c once a tick; nothing
    launches the fused query."""
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
            **{f"{k}_launches": v for k, v in launches.items()})
        with_field = sum(s.volume is not None for s in cuda)
        with_modifiers = sum(bool(s._step) for s in cuda)
        expected = dict(k7_column_query=0,
                        k4_integrate=PARTICLE_TICKS * with_field,
                        k4c_modifiers=PARTICLE_TICKS * with_modifiers)
        if not (live > 0 and same_live and within == 1.0
                and within_1e3 >= 0.99 and img_err <= 0.01):
            raise AssertionError(f"reference_particles ({name}): the card's "
                                 "systems disagree with the CPU path")
        if launches != expected:
            raise AssertionError(f"reference_particles ({name}): kernels "
                                 f"launched {launches} times in "
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
    tick from the render; then one more tick and one more render under
    the host-read counter (the render also under the sync debug mode), and
    the gates: K4, K4b and K4c once a tick (the maps packed before, once),
    K5 once a render, 0 reads. Returns (launches, ms_per_frame, the checked render's
    K5 call)."""
    from illuminant_tpu_torch.raster import splat_kernel as k5
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8
    from illuminant_tpu_torch.sdf.analytic import scene_sample_p

    torch.cuda.reset_peak_memory_stats()
    system, sensor, raster, hdr = _particle_cell(field, warmup)
    _reset_launches()
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
    launches = _launches("k7_column_query", "k7_column_pack",
                         "k7_column_sample", "k5_splat", "k4_integrate",
                         "k4b_spawn", "k4c_modifiers")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with HostReads() as reads:
        system.update(DT)
    torch.cuda.synchronize()
    # A render under the host-read counter and the sync debug mode: a
    # synchronizing operation in it raises.
    torch.cuda.set_sync_debug_mode("error")
    try:
        with HostReads() as render_reads, \
                KernelInputs("splat_cuda", k5) as splat_call:
            system.render(raster)
    finally:
        torch.cuda.set_sync_debug_mode(0)
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
        k7_column_query_per_tick=launches["k7_column_query"]
        / PARTICLE_TIMED_FRAMES,
        k7_column_pack_per_tick=launches["k7_column_pack"]
        / PARTICLE_TIMED_FRAMES,
        k7_column_sample_launches=launches["k7_column_sample"],
        k5_splat_launches=launches["k5_splat"],
        k4_integrate_per_tick=launches["k4_integrate"]
        / PARTICLE_TIMED_FRAMES,
        k4b_spawn_per_tick=launches["k4b_spawn"] / PARTICLE_TIMED_FRAMES,
        k4c_modifiers_per_tick=launches["k4c_modifiers"]
        / PARTICLE_TIMED_FRAMES,
        host_reads_per_tick=reads.n,
        host_reads_per_render=render_reads.n, sensor=inside,
        sensor_direct=direct,
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
    expected = dict(k7_column_query=0, k7_column_pack=0,
                    k7_column_sample=0,
                    k5_splat=k5.LAUNCHES_PER_SPLAT * PARTICLE_TIMED_FRAMES,
                    k4_integrate=PARTICLE_TIMED_FRAMES,
                    k4b_spawn=PARTICLE_TIMED_FRAMES,
                    k4c_modifiers=PARTICLE_TIMED_FRAMES)
    if launches != expected:
        raise AssertionError(f"slice_particles: kernels launched "
                             f"{launches} times in {PARTICLE_TIMED_FRAMES} "
                             f"ticks, expected {expected}")
    if abs(inside - direct) > edge:
        raise AssertionError(f"slice_particles: the sensor counted {inside}, "
                             f"a direct count {direct} (+-{edge})")
    if reads.n or render_reads.n:
        raise AssertionError(f"slice_particles: a tick read the device "
                             f"{reads.n} times, a render {render_reads.n}")
    return launches, ms_per_frame, splat_call.calls[-1][0]


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
    .out, and every call's arguments in .calls; the wrapper still runs
    and counts as before."""

    def __init__(self, name, module=None):
        self.name, self.args, self.out = name, None, None
        self._mod = module
        # Every call's (args, kwargs), in order.
        self.calls = []

    def __enter__(self):
        if self._mod is None:
            from illuminant_tpu_torch.raster import tile_kernel

            self._mod = tile_kernel
        self._orig = getattr(self._mod, self.name)

        def spy(*args, **kwargs):
            self.args, self.out = args, self._orig(*args, **kwargs)
            self.kwargs = kwargs
            self.calls.append((args, kwargs))
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


def timed_once(fn):
    """(fn()'s result, its device time in ms): CUDA events around one
    eager call, with no warm-up call. For plain versions that take
    hundreds of milliseconds, beside which a first call's set-up is small;
    their result is then the reference the kernel is checked against."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
                 else torch.ones_like(r) if args[3] == "point"
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
    mod.LIBRARY.build()
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
    ref, plain_ms = timed_once(lambda: plain(*args))
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
    # The "point" kind (the bilinear 2-tap), untextured, alone.
    with KernelInputs("composite_over_tiles") as spy:
        tiled.rasterize_tiled_alpha(dataclasses.replace(cfg, kernel="point"),
                                    x, y, color, size, live, background=bg)
    point_args = spy.args
    _sprite_kernel_row(rec, "composite_point", "composite_over_tiles",
                       point_args, 0.0, parent, coverage="point",
                       inputs="steady", particles=x.shape[0],
                       entries=int(point_args[1][1][-1]),
                       **entry_stats(point_args[1][1]))
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
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8

    name = "slice_additive_sprites" if additive else "slice_alpha_sprites"
    kernel = "sprite_accumulate" if additive else "composite_over_tiles"
    torch.cuda.reset_peak_memory_stats()
    system, raster, hdr, kw = sprite_cell(field, warmup, additive, device)
    _reset_launches()
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
    launches = _launches("k11a_composite", "k11b_sprite_accumulate",
                         "k7_column_query", "k7_column_pack",
                         "k7_column_sample")
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
    expected = dict(k11a_composite=0 if additive else SPRITE_TIMED_FRAMES,
                    k11b_sprite_accumulate=SPRITE_TIMED_FRAMES if additive
                    else 0)
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
    "alpha_point": ("alpha", dict(kernel="point"), "composite"),
    "additive_point": ("render", dict(appearance=dict(
        texture=None, kernel="point")), None),
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

    for name, (_, _, kernel) in SPRITE_ROUTES.items():
        cpu = _small_sprite_route(name, "cpu")
        _reset_launches()
        cuda = _small_sprite_route(name, "cuda")
        counts = _launches()
        launches = dict(composite=counts["k11a_composite"],
                        accumulate=counts["k11b_sprite_accumulate"])
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


# --- the modeling layer -----------------------------------------------------

# The cell model-engine-1080p: an artist's saved particle model, as a game
# or the Lumined editor loads it (demo.py:1324-1354's path, at full
# width): `EngineModel.loads` of the JSON below, an `EngineView` of
# 1<<17 slots a system on the voxel slice's ColumnField, `update(1/60)`,
# each system's `render` in draw order, `resolve`, `to_uint8`. Three
# systems: "sparks" (a Spawner whose rate is the named variable `rate`,
# an attractor, Noise, untextured additive quads), "embers" (a
# FeedbackSpawner re-emitting the sparks' live particles, an inline
# texture drawn additively: K11b) and "smoke" (demo.py's leaf, rounded,
# opacity from life, composited "over" the additive image: K11a). All
# three collide with the field at 3 substeps (K7). Each spawns 512 a tick
# and lives 5-6 s, so every ring holds its 131,072 slots from the 256th
# frame on (`--warmup 260`).
MODEL_FULL = dict(height=1080, width=1920, capacity=1 << 17, per_tick=512)
MODEL_TIMED_FRAMES = 8
MODEL_WARMUP_FRAMES = 2
MODEL_SMALL = dict(height=96, width=160, capacity=1 << 10, per_tick=64)
MODEL_TICKS = 10
CODEGEN_UPDATES = 20
def ember_texture(n=12):
    """A soft disc, the embers' inline texture."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    return np.clip(1.0 - (xs * xs + ys * ys), 0.0, 1.0).astype(np.float32)


def _vec(*v):
    return dict(zip("XYZW", (float(x) for x in v)))


def model_json(height, width, per_tick, **_):
    """The model-engine cell's EngineModel as Lumined JSON (the serialized
    forms of tests/test_models.py:SAMPLE and tests/test_codegen.py:
    MODEL_JSON), laid out on a (height, width) frame; each system spawns
    `per_tick` particles a tick at 60 updates a second."""
    s, cx, cy = _frame_scale(height, width)
    rate = float(per_tick * 60)
    prefix = "Squared.Illuminant.Particles.Transforms."

    def prop(v):
        return {"Type": "System.Object", "Value": v}

    def transform(kind, order, **props):
        return {"Name": kind.lower(), "Type": prefix + kind,
                "UpdateOrder": order,
                "Properties": {k: prop(v) for k, v in props.items()}}

    def config(**kw):
        return {"LifeDecayPerSecond": 1.0, "UpdatesPerSecond": 60.0,
                "Collision": {"Distance": 1.0, "LifePenalty": 0.0,
                              "BounceVelocityMultiplier": 0.6,
                              "EscapeVelocity": 128.0}, **kw}

    life = {"Constant": 5.5, "RandomScale": 1.0, "Offset": -0.5}
    sparks = {
        "Name": "sparks", "UpdateOrder": 0, "DrawOrder": 0,
        "AdditiveBlend": True,
        "Configuration": config(
            MaximumVelocity=260.0 * s, Friction=0.15, Size=3.0,
            Color={"FromLife": {"Mode": 0, "Count": 2, "MinValue": 0.0,
                                "MaxValue": 2.0, "A": _vec(0.2, 0.05, 0.0,
                                                           0.2),
                                "B": _vec(1.0, 1.0, 1.0, 1.0)}}),
        "Transforms": [
            transform(
                "Spawner", 0,
                MinRate={"ValueType": "System.Single", "Name": "rate"},
                MaxRate={"ValueType": "System.Single", "Name": "rate"},
                Life=life,
                Position={"Constant": [cx, cy - 150.0 * s, 10.0],
                          "RandomScale": [40.0 * s, 40.0 * s, 4.0],
                          "Type": "Spherical"},
                Velocity={"RandomScale": [120.0 * s, 120.0 * s, 0.0],
                          "Type": "Spherical"},
                Color={"Constant": {
                    "ValueType": "Microsoft.Xna.Framework.Vector4",
                    "Name": "tint"}}),
            transform("Gravity", 1, Attractors=[{
                "Position": {"ValueType": "Microsoft.Xna.Framework.Vector3",
                             "Constant": _vec(cx, cy, 10.0)},
                "Radius": {"ValueType": "System.Single",
                           "Constant": 500.0 * s},
                "Strength": {"ValueType": "System.Single",
                             "Constant": 80.0 * s},
                "Type": 1}], MaximumAcceleration=400.0 * s),
            transform("Noise", 2, Interval=250.0,
                      Velocity={"Scale": [30.0 * s, 30.0 * s, 0.0, 0.0]}),
        ]}
    embers = {
        "Name": "embers", "UpdateOrder": 1, "DrawOrder": 1,
        "AdditiveBlend": True,
        "Configuration": config(
            MaximumVelocity=200.0 * s, Friction=0.3, Size=6.0,
            Appearance={"Texture": ember_texture().tolist()}),
        "Transforms": [
            transform("FeedbackSpawner", 0, MinRate=rate, MaxRate=rate,
                      SourceSystem="sparks", InstanceMultiplier=1,
                      SourceVelocityFactor=0.5, Life=life,
                      Velocity={"RandomScale": [20.0 * s, 20.0 * s, 0.0],
                                "Type": "Spherical"},
                      Color={"Constant": [1.0, 0.45, 0.15, 0.8]}),
            transform("Gravity", 1, Attractors=[{
                "Position": [cx, cy + 150.0 * s, 10.0],
                "Radius": 400.0 * s, "Strength": 40.0 * s,
                "Type": 1}]),
        ]}
    smoke = {
        "Name": "smoke", "UpdateOrder": 2, "DrawOrder": 2,
        "AdditiveBlend": False,
        "Configuration": config(
            MaximumVelocity=120.0 * s, Friction=0.2, Size=10.0,
            ZFormula=[0.0, 0.0, 1.0, 0.0],
            Color={"OpacityFromLife": 1.5},
            Appearance={"Texture": leaf_texture().tolist(),
                        "Rounded": True}),
        "Transforms": [
            transform("Spawner", 0, MinRate=rate, MaxRate=rate, Life=life,
                      Position={"Constant": [cx + 250.0 * s, cy + 80.0 * s,
                                             20.0],
                                "RandomScale": [60.0 * s, 60.0 * s, 10.0],
                                "Type": "Spherical"},
                      Velocity={"RandomScale": [25.0 * s, 25.0 * s, 0.0],
                                "Type": "Spherical"},
                      Color={"Constant": [0.55, 0.55, 0.6, 0.7],
                             "RandomScale": [0.2, 0.2, 0.2, 0.2]}),
            transform("FMA", 1, Velocity={"Add": [0.0, -10.0 * s, 0.0]},
                      CyclesPerSecond=1.0),
        ]}
    return json.dumps({
        "NamedVariables": {
            "rate": {"DefaultValue": {"ValueType": "System.Single",
                                      "Constant": rate},
                     "IsExternal": True},
            "tint": {"DefaultValue": {
                "ValueType": "Microsoft.Xna.Framework.Vector4",
                "Constant": _vec(1.0, 0.55, 0.2, 1.0)},
                "IsExternal": False}},
        "Systems": [sparks, embers, smoke],
        "UserData": {"Cell": "model-engine-1080p"}})


def model_view(device, size, volume, overrides=None):
    """The model of `size` (MODEL_FULL or MODEL_SMALL) bound by an
    EngineView on `device` with the given collision field."""
    from illuminant_tpu_torch.models.model import EngineModel
    from illuminant_tpu_torch.models.view import EngineView

    return EngineView(EngineModel.loads(model_json(**size)), volume=volume,
                      overrides=overrides, capacity=size["capacity"],
                      device=device)


def model_render(view, raster):
    """Every system in draw order: the additive ones add onto the image so
    far, the alpha ones composite over it -> the (H, W, 4) HDR image."""
    img = None
    for sv in sorted(view.systems, key=lambda v: v.model.draw_order):
        img, _ = sv.system.render(raster, appearance=sv.appearance,
                                  additive_blend=sv.model.additive_blend,
                                  background=img)
    return img


def model_cell(field, warmup, device="cuda"):
    """The model-engine-1080p view after `warmup` frames, its raster
    config and its resolve."""
    from illuminant_tpu_torch.core.config import HDRConfig
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    view = model_view(device, MODEL_FULL, field)
    raster = TiledRasterConfig(height=MODEL_FULL["height"],
                               width=MODEL_FULL["width"], apron=9)
    hdr = HDRConfig(mode=2, exposure=2.2, white_point=3.0, srgb_output=True)
    for _ in range(warmup):
        view.update(DT)
        to_uint8(resolve(model_render(view, raster), hdr))
    torch.cuda.synchronize()
    return view, raster, hdr


def _system_ticks(view) -> int:
    return sum(sv.system._tick_index for sv in view.systems)


def phase_slice_model(field, warmup: int, kernel_rec, device="cuda"):
    """The cell model-engine-1080p: `warmup` frames, the timed frames
    (CUDA events split the update and the render), one checked frame
    (host reads of the update and of each system's render; its K11a call
    against its plain version bit for bit and its K11b call within its
    bound, each timed as a `[kernel] inputs=model_frame` row), the alpha
    system's accumulated alpha, then `refresh_variables` with half the
    rate: the live state carries over and the sparks spawn half as many a
    tick; the checked frame's untextured splat (the sparks) is K5's
    `[kernel] inputs=model_sparks` row. Returns (launches in the timed
    frames, ms/frame)."""
    from illuminant_tpu_torch.raster import splat_kernel as k5
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8

    torch.cuda.reset_peak_memory_stats()
    view, raster, hdr = model_cell(field, warmup, device)
    _reset_launches()
    ticks0 = _system_ticks(view)
    update_ms, render_ms = [], []
    t0 = time.perf_counter()
    for _ in range(MODEL_TIMED_FRAMES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        view.update(DT)
        ev[1].record()
        image = to_uint8(resolve(model_render(view, raster), hdr))
        ev[2].record()
        torch.cuda.synchronize()
        update_ms.append(ev[0].elapsed_time(ev[1]))
        render_ms.append(ev[1].elapsed_time(ev[2]))
    ms_per_frame = 1e3 * (time.perf_counter() - t0) / MODEL_TIMED_FRAMES
    launches = _launches()
    system_ticks = _system_ticks(view) - ticks0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with HostReads() as tick_reads:
        view.update(DT)
    render_reads = {}
    img = None
    with KernelInputs("composite_over_tiles") as alpha_spy, \
            KernelInputs("sprite_accumulate") as add_spy, \
            KernelInputs("splat_cuda", k5) as splat_spy:
        for sv in sorted(view.systems, key=lambda v: v.model.draw_order):
            # The untextured splat (K5) under the sync debug mode too.
            splat = ((sv.appearance is None
                      or sv.appearance.texture is None)
                     and sv.model.additive_blend)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if splat else 0)
            try:
                with HostReads() as reads:
                    img, _ = sv.system.render(
                        raster, appearance=sv.appearance,
                        additive_blend=sv.model.additive_blend,
                        background=img)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            render_reads[sv.model.name] = reads.n
        image = to_uint8(resolve(img, hdr))
    torch.cuda.synchronize()
    live = {sv.model.name: sv.system.live_count for sv in view.systems}
    for key, name, spy, tol in (
            ("composite_model", "composite_over_tiles", alpha_spy, 0.0),
            ("accumulate_model", "sprite_accumulate", add_spy,
             _add_tolerance(add_spy.out))):
        _sprite_kernel_row(kernel_rec, key, name, spy.args, tol,
                           coverage="sprite", inputs="model_frame",
                           live=json.dumps(live),
                           entries=int(spy.args[1][1][-1]),
                           **entry_stats(spy.args[1][1]))
    _splat_row(kernel_rec, "splat_model", splat_spy.args,
               inputs="model_sparks", live=live["sparks"])
    splat_spy = None
    smoke = next(sv for sv in view.systems if not sv.model.additive_blend)
    bare, _ = smoke.system.render(raster, appearance=smoke.appearance,
                                  additive_blend=False)
    alpha_max = float(bare[..., 3].max())
    systems = [sv.system for sv in view.systems]
    sparks = systems[0]
    spawned0 = int(sparks.state.total_spawned)
    states = [s.state.position.clone() for s in systems]
    view.refresh_variables({"rate": MODEL_FULL["per_tick"] * 30.0})
    carried = (all(sv.system is s and torch.equal(s.state.position, p)
                   for sv, s, p in zip(view.systems, systems, states))
               and systems[1].transforms[0].source is sparks)
    view.update(DT)
    spawned = int(sparks.state.total_spawned) - spawned0
    img_np = image.cpu().numpy()
    per_frame = {k: v / MODEL_TIMED_FRAMES for k, v in launches.items()}
    say("slice_model", cell="model-engine-1080p", warmup=warmup,
        frames=MODEL_TIMED_FRAMES, ms_per_frame=f"{ms_per_frame:.3f}",
        update_ms=f"{sum(update_ms) / len(update_ms):.3f}",
        render_ms=f"{sum(render_ms) / len(render_ms):.3f}",
        **{f"live_{k}": v for k, v in live.items()},
        peak_mem_gb=f"{peak_gb:.3f}", system_ticks=system_ticks,
        **{f"{k}_per_frame": v for k, v in per_frame.items()},
        host_reads_per_update=tick_reads.n,
        host_reads_per_render=json.dumps(render_reads),
        max_alpha=alpha_max,
        composite_vs_plain=kernel_rec["composite_model"]["err"],
        accumulate_vs_plain=kernel_rec["accumulate_model"]["err"],
        image_mean=f"{img_np[..., :3].mean():.3f}",
        refresh_carried_state=carried,
        sparks_spawned_after_refresh=spawned)
    # A tick spawns through K4b once a plain spawner (each spawns every
    # tick at the model's fixed rate); the feedback spawner stays eager.
    plain_spawners = sum(not getattr(s, "is_feedback", False)
                         for sv in view.systems for s in sv.system.spawners)
    # A tick of a system with modifiers runs them as one K4c launch.
    modifier_systems = sum(bool(sv.system._step) for sv in view.systems)
    expected = dict(
        # Each system's collision is one K4 launch a tick; the field's
        # maps were packed at its first tick.
        k7_column_query=0, k7_column_pack=0, k4_integrate=system_ticks,
        k4b_spawn=plain_spawners * MODEL_TIMED_FRAMES,
        k4c_modifiers=modifier_systems * MODEL_TIMED_FRAMES,
        k7_column_sample=0, k11a_composite=MODEL_TIMED_FRAMES,
        k11b_sprite_accumulate=MODEL_TIMED_FRAMES, k10_tiled_lights=0,
        k12_cone_trace=0, k12_volume_pack=0, k1_scan_walk=0,
        k2_scan_readout=0,
        k5_splat=k5.LAUNCHES_PER_SPLAT * MODEL_TIMED_FRAMES)
    if launches != expected or system_ticks != 3 * MODEL_TIMED_FRAMES:
        raise AssertionError(f"slice_model: launches {launches} in "
                             f"{system_ticks} system ticks, expected "
                             f"{expected} in {3 * MODEL_TIMED_FRAMES}")
    # The untextured additive splat is K5: no read.
    if tick_reads.n or render_reads != dict(sparks=0, embers=0, smoke=0):
        raise AssertionError(f"slice_model: {tick_reads.n} host reads in an "
                             f"update, {render_reads} in the renders; "
                             "expected 0")
    if not alpha_max <= 1.0 + 1e-5:
        raise AssertionError(f"slice_model: accumulated alpha {alpha_max}")
    if not (bool(torch.isfinite(img).all())
            and img_np[..., :3].astype(np.float64).var() > 0.0
            and img_np.shape == (MODEL_FULL["height"], MODEL_FULL["width"],
                                 4)):
        raise AssertionError("slice_model: the frame is flat or not finite")
    full = MODEL_FULL["capacity"]
    if warmup >= full // MODEL_FULL["per_tick"]:
        if set(live.values()) != {full}:
            raise AssertionError(f"slice_model: live {live} after the rings "
                                 f"filled, expected {full} each")
    elif not min(live.values()) > 0:
        raise AssertionError(f"slice_model: a system is empty: {live}")
    if not (carried and spawned == MODEL_FULL["per_tick"] // 2):
        raise AssertionError(
            f"slice_model: refresh_variables kept the state: {carried}; the "
            f"sparks spawned {spawned} in a tick after it, expected "
            f"{MODEL_FULL['per_tick'] // 2}")
    return launches, ms_per_frame


def model_draws(view, updates, seed=0):
    """Host draws for `updates` updates of one tick each: per update, by
    system name, one tick of one (spawn_max, 4) triple per spawner."""
    rng = np.random.default_rng(seed)
    return [{sv.model.name: [[tuple(rng.random((s.spawn_max, 4),
                                               dtype=np.float32)
                                    for _ in range(3))
                              for s in sv.system.spawners]]
             for sv in view.systems} for _ in range(updates)]


def small_model(device, draws=None, random_fields=None):
    """The model at 96 x 160 on `device` over its small ColumnField,
    MODEL_TICKS updates from `draws` (None: make them) with the given
    Noise fields (one a system; None: the device's own) -> (view, draws,
    fused-query launches, K4 launches)."""
    from illuminant_tpu_torch.ops.noise import RandomField

    h, w = MODEL_SMALL["height"], MODEL_SMALL["width"]
    view = model_view(device, MODEL_SMALL, small_column_field(
        particle_api(device), h, w, device))
    for sv, field in zip(view.systems, random_fields or ()):
        sv.system.random_field = RandomField(data=field.to(device))
    draws = draws or model_draws(view, MODEL_TICKS)
    _reset_launches()
    for d in draws:
        view.update(DT, spawn_uniforms=d)
    return view, draws, *_launches("k7_column_query",
                                   "k4_integrate").values()


STATE_FIELDS = ("position", "velocity", "color", "render_color",
                "render_data")


def state_agreement(a, b) -> tuple:
    """tests/test_torch_particle_system.py's rule between two states:
    (same live masks, cursors and totals; the share of live particles
    whose every field agrees to 1e-4 + 1e-5 |b|)."""
    la = a.position[:, 3].cpu().numpy() > 0
    lb = b.position[:, 3].cpu().numpy() > 0
    same = (bool(np.array_equal(la, lb))
            and int(a.write_cursor) == int(b.write_cursor)
            and int(a.total_spawned) == int(b.total_spawned))
    ok = np.ones(la.shape, bool)
    for name in STATE_FIELDS:
        x = getattr(a, name).cpu().numpy()
        y = getattr(b, name).cpu().numpy()
        ok &= np.all(np.abs(x - y) <= 1e-4 + 1e-5 * np.abs(y), axis=1)
    return same, float(ok[lb].mean()) if lb.any() else 1.0


def editor_session(device, draws=None):
    """tests/test_editor.py:49-108's edit script on `device`: a system,
    a Spawner and a Gravity added, 10 updates, the attractor's strength
    edited live, 10 more updates, from host draws (None: make them) ->
    (controller, draws)."""
    from illuminant_tpu_torch.models.editor import EditorController

    ed = EditorController(capacity=MODEL_SMALL["capacity"], device=device)
    ed.add_system("sparks")
    ed.add_transform(0, "Spawner", {
        "MinRate": 600.0, "MaxRate": 600.0,
        "Life": {"Constant": 2.0, "RandomScale": 0.5},
        "Position": {"Constant": [64.0, 64.0, 0.0],
                     "RandomScale": [8.0, 8.0, 0.0], "Type": "Spherical"},
        "Velocity": {"RandomScale": [30.0, 30.0, 0.0], "Type": "Spherical"},
        "Color": {"Constant": [1.0, 0.8, 0.2, 1.0]}})
    ed.add_transform(0, "Gravity", {
        "Attractors": [{"Position": [64.0, 120.0, 0.0], "Radius": 200.0,
                        "Strength": 50.0, "FalloffType": "Linear"}],
        "MaximumAcceleration": 500.0})
    draws = draws or model_draws(ed.view, 20, seed=1)
    for i, d in enumerate(draws):
        if i == 10:
            ed.set_transform_property(0, 1, "Attractors", [
                {"Position": [64.0, 120.0, 0.0], "Radius": 200.0,
                 "Strength": 150.0, "FalloffType": "Linear"}])
        ed.update(DT, spawn_uniforms=d)
    return ed, draws


def phase_reference_models(device="cuda"):
    """The modeling layer at 96 x 160 on the card against the port's CPU
    path (which the CPU tests hold to the JAX package): the model's three
    systems after 10 updates from the same host draws and the CPU's Noise
    fields (same live masks, cursors and totals; every live particle
    within 1e-4 + 1e-5 |b|; one K4 launch a system tick, no fused
    query); the SaveAsCode module's systems against the JSON view's on
    the card, each drawing from its own generator, after 20 updates: bit
    for bit (drift 0.0); the
    scripted editor session: its digest within the same bound and its
    `dumps()` equal byte for byte. `device="cpu"` rehearses it here."""
    from illuminant_tpu_torch.models.codegen import save_as_code

    cpu, draws, _, _ = small_model("cpu")
    cuda, _, launches, k4_launches = small_model(
        device, draws, [sv.system.random_field.data for sv in cpu.systems])
    agree = {sv.model.name: state_agreement(sv.system.state,
                                            sg.system.state)
             for sv, sg in zip(cpu.systems, cuda.systems)}
    h, w = MODEL_SMALL["height"], MODEL_SMALL["width"]
    field = small_column_field(particle_api(device), h, w, device)
    view = model_view(device, MODEL_SMALL, field)
    ns = {}
    exec(compile(save_as_code(view.model), "<generated>", "exec"), ns)
    compiled = ns["build_systems"](volume=field,
                                   capacity=MODEL_SMALL["capacity"],
                                   device=device)
    for _ in range(CODEGEN_UPDATES):
        for s in compiled:
            s.update(DT)
        view.update(DT)
    drift = max(float((getattr(s.state, f) - getattr(sv.system.state, f))
                      .abs().max())
                for s, sv in zip(compiled, view.systems)
                for f in ("position", "velocity", "color"))
    compiled_live = [s.live_count for s in compiled]
    ed_cpu, ed_draws = editor_session("cpu")
    ed_cuda, _ = editor_session(device, ed_draws)
    dc, dg = ed_cpu.state_digest(), ed_cuda.state_digest()
    live = dc["0:position"][:, 3] > 0
    digest_err = max(float(np.abs(dg[k][live] - dc[k][live]).max())
                     for k in dc)
    digest_ok = bool(np.array_equal(live, dg["0:position"][:, 3] > 0)) and \
        all(np.all(np.abs(dg[k][live] - dc[k][live])
                   <= 1e-4 + 1e-5 * np.abs(dc[k][live])) for k in dc)
    dumps_equal = ed_cpu.model.dumps() == ed_cuda.model.dumps()
    say("reference_models", size=f"{h}x{w}", ticks=MODEL_TICKS,
        live=json.dumps({sv.model.name: sv.system.live_count
                         for sv in cpu.systems}),
        same_live_cursors=json.dumps({k: v[0] for k, v in agree.items()}),
        share_within_rule=json.dumps({k: v[1] for k, v in agree.items()}),
        column_query_launches=launches, codegen_drift=drift,
        codegen_live=json.dumps(compiled_live),
        editor_live=ed_cuda.live_count, editor_digest_max_err=digest_err,
        editor_digest_ok=digest_ok, editor_dumps_equal=dumps_equal)
    if not all(same and share == 1.0 for same, share in agree.values()):
        raise AssertionError(f"reference_models: the card's systems disagree "
                             f"with the CPU path: {agree}")
    if (launches, k4_launches) != (0, 3 * MODEL_TICKS):
        raise AssertionError(f"reference_models: {launches} fused queries "
                             f"and {k4_launches} K4 launches in "
                             f"{MODEL_TICKS} updates of 3 systems")
    if not (drift == 0.0 and min(compiled_live) > 0):
        raise AssertionError(f"reference_models: the SaveAsCode systems "
                             f"drift {drift} from the JSON view's")
    if not (digest_ok and dumps_equal and ed_cuda.live_count > 0):
        raise AssertionError("reference_models: the editor session on the "
                             "card disagrees with the CPU's")


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
    from illuminant_tpu_torch.core import cuda_build

    cuda_build.reset_launches()


def _launches(*kernels):
    """The kernel launches since `_reset_launches`, by launch-span name:
    of `kernels`, or of every hand-written kernel (each library's kernels
    count from its import)."""
    from illuminant_tpu_torch.core import cuda_build

    _libraries()
    counts = cuda_build.launches()
    return {k: counts[k] for k in kernels} if kernels else counts


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
    expected = dict(k10_tiled_lights=LIGHTS_TIMED_FRAMES,
                    k7_column_query=0, k7_column_pack=LIGHTS_TIMED_FRAMES,
                    k7_column_sample=0, k11a_composite=0,
                    k11b_sprite_accumulate=0, k12_cone_trace=0,
                    k12_volume_pack=0, k1_scan_walk=0,
                    k2_scan_readout=0, k5_splat=0,
                    k4_integrate=0, k4b_spawn=0, k4c_modifiers=0)
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


def parent_k10_call(parent, args, kwargs):
    """The earlier checkout's K10 on this frame -> (that call, the
    route's whole device work). A checkout of PR 10 or later fuses the
    route into `tiled_lights_fused`, which takes this frame's arguments as
    they are (both are that call, its image). An earlier K10 shades alone
    (`tiled_light_accumulate` of the checkout module `parent`): it takes
    the frame's own bins, records and factor as its route computed them
    in PyTorch (`tiled_lights_kernel.fused_inputs`), and the route is those
    PyTorch pieces and that K10."""
    from illuminant_tpu_torch.lighting import tiled_lights_kernel as k10

    if hasattr(parent, "tiled_lights_fused"):
        call = lambda: parent.tiled_lights_fused(  # noqa: E731
            *args, **kwargs)[0]
        return call, call
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
        old, old_route = parent_k10_call(parent, args, kwargs)
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
    before = _launches()["k10_tiled_lights"]
    img, dropped = accumulate_particle_lights(
        field, gb, state,
        ParticleLightSource(template=torch_template(**tpl), **src), env,
        QualitySettings(), return_diagnostics=True)
    return (img.cpu().numpy(), int(dropped),
            _launches()["k10_tiled_lights"] - before)


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


# The multi-device frame (illuminant_tpu_torch/parallel/). One card holds
# a mesh of one rank, an NCCL group of one; the route and the band rasters
# of meshes of MESH_DEVICES ranks run in this process, rank by rank, with
# the exchange between them a transpose of the stacked send buffers (what
# all_to_all_single does across ranks).
MESH_DEVICES = (2, 4, 8)
MESH_SLICE = dict(field="analytic", preset="fast")
MESH = {}


def card_mesh(device="cuda"):
    """The mesh of this process's card: make_mesh(1) on an NCCL group of
    one (gloo for a rehearsal on "cpu"), made once and reused."""
    from illuminant_tpu_torch.parallel.mesh import make_mesh

    if "mesh" not in MESH:
        MESH["mesh"] = make_mesh(1, device)
    return MESH["mesh"]


def _mesh_run(scene, state, warmup, frames):
    """`phase_slice`'s schedule: warm-up, timed frames (K5's launches
    counted), one frame under the host-read counter; -> (last timed
    image, state, avg_lum after it, ms/frame, K5 launches, host reads of
    the extra frame)."""

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(0)
    avg = torch.tensor(0.5, device=dev)
    _, state, avg = _run_frames(scene, warmup, 0, gen, state, avg)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    img, state, avg = _run_frames(scene, frames, warmup, gen, state, avg)
    torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t0) / frames
    launches = _launches()["k5_splat"]
    img, avg_f = img.clone(), float(avg)
    with HostReads() as reads:
        _, state, _ = _run_frames(scene, 1, warmup + frames, gen, state, avg)
    torch.cuda.synchronize()
    return img, state, avg_f, ms, launches, reads.n


def mesh_render_reads(mesh, cfg, state) -> int:
    """The mesh frame's raster (`rasterize_tiled_sharded`) on `state` under
    torch.cuda.set_sync_debug_mode("error") and the host-read counter ->
    the reads (a synchronizing operation raises)."""
    from illuminant_tpu_torch.parallel.raster import rasterize_tiled_sharded

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with HostReads() as reads:
            rasterize_tiled_sharded(
                mesh, cfg, state.position[:, 0], state.position[:, 1],
                state.render_color, state.render_data[:, 0],
                state.live_mask())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return reads.n


def phase_slice_mesh(warmup: int, frames: int, plain_ms: float,
                     device="cuda"):
    """flagship-mesh1-1080p: the analytic fast flagship at full width built
    on the card's mesh (`build_flagship(mesh=card_mesh())`, its capacity
    shard from `shard_particles`), run as `phase_slice` ran
    `slice_analytic` (the same state, generator and frames; its ms/frame
    `plain_ms`). Gates: the last timed image within 1 of that slice's,
    avg_lum within 1e-4, K5 launched LAUNCHES_PER_SPLAT times a frame,
    FLAGSHIP_READS_PER_FRAME reads a frame (the exposure's percentile; the
    histogram's all-reduce reads nothing) and none in its raster, which
    runs once more under the sync debug mode. -> (K5 launches, mesh
    state, raster config, ms/frame)."""
    import torch.distributed as dist

    from illuminant_tpu_torch.parallel import mesh as pmesh
    from illuminant_tpu_torch.raster import splat_kernel as k5
    from illuminant_tpu_torch.scenes import build_flagship

    t0 = time.perf_counter()
    mesh = card_mesh(device)
    torch.cuda.reset_peak_memory_stats()
    scene = build_flagship(device=device, mesh=mesh, **FULL, **MESH_SLICE)
    img, state, avg, ms, launches, reads = _mesh_run(
        scene, pmesh.shard_particles(scene.system.state, mesh), warmup,
        frames)
    render_reads = mesh_render_reads(mesh, scene.raster_config, state)
    plain_img, plain_avg = SLICE_LAST["slice_analytic"]
    lsb = int((img.to(torch.int32) - plain_img.to(torch.int32)).abs().max())
    live = int(state.live_count())
    say("slice_mesh", cell="flagship-mesh1-1080p", **MESH_SLICE,
        mesh_size=mesh.size(), backend=dist.get_backend(), warmup=warmup,
        frames=frames, ms_per_frame=f"{ms:.3f}",
        unsharded_ms_per_frame=f"{plain_ms:.3f}", max_abs_lsb=lsb,
        avg_lum=f"{avg:.6f}", avg_lum_unsharded=f"{plain_avg:.6f}",
        live_particles=live, splat_launches=launches,
        host_reads_per_frame=reads, render_host_reads=render_reads,
        render_sync_debug="error: none",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    if tuple(img.shape) != (FULL["height"], FULL["width"], 3) or lsb > 1:
        raise AssertionError(f"slice_mesh: image {tuple(img.shape)} off the "
                             f"unsharded frame by {lsb}")
    if abs(avg - plain_avg) > 1e-4 or not live > 0:
        raise AssertionError(f"slice_mesh: avg_lum {avg} against "
                             f"{plain_avg}, {live} live")
    if launches != k5.LAUNCHES_PER_SPLAT * frames:
        raise AssertionError(f"slice_mesh: K5 launched {launches} times in "
                             f"{frames} frames")
    if reads != FLAGSHIP_READS_PER_FRAME or render_reads != 0:
        raise AssertionError(f"slice_mesh: {reads} host reads a frame, "
                             f"{render_reads} in its raster")
    return launches, state, scene.raster_config, ms


def _band_inputs(cfg, d, rank, recv):
    """The local K5 call of `raster_band` (parallel/raster.py): (local
    config, x, y, color, size, live) on rank's ghost-extended grid, and
    the crop of its band's rows."""
    from illuminant_tpu_torch.parallel import mesh as pmesh
    from illuminant_tpu_torch.parallel import raster as praster

    row_lo, local = praster.band_grid(cfg, d, rank)
    row0, row1 = pmesh.band_rows(cfg, d, rank)
    return ((local, recv[:, 0], recv[:, 1] - float(row_lo), recv[:, 4:8],
             recv[:, 2], recv[:, 3] > 0.5), slice(row0 - row_lo, row1 - row_lo))


def _route_all(cfg, d, args, factor):
    """Every rank's route of `args` (a whole capacity) -> (per-rank sends,
    counts (D, D), send drops, budget)."""
    from illuminant_tpu_torch.parallel import raster as praster

    _, x, y, color, size, live = args
    n_loc = x.shape[0] // d
    budget = praster.send_budget(cfg, d, n_loc, factor)
    outs = [praster.route(cfg, d, *(a[r * n_loc:(r + 1) * n_loc]
                                    for a in (x, y, color, size, live)),
                          budget) for r in range(d)]
    sends = torch.stack([o[0] for o in outs])
    counts = torch.stack([o[1] for o in outs])
    return sends, counts, int(sum(int(o[2]) for o in outs)), budget


def phase_mesh_bands(inputs, device="cuda"):
    """K5 on band grids: for each input (cfg, x, y, color, size, live) and
    D of MESH_DEVICES, every rank's route, the exchange, every band's
    raster (`raster_band`: one K5 splat, LAUNCHES_PER_SPLAT launches, for
    every band with rows). Gates: each band's K5 within its bound of its
    plain version on the same band inputs, the stitched bands within the
    unsharded K5 image's bound, the routes' counts and send drops at the
    frame's factor (3.0) equal to the same route on the CPU. Times the
    routes and the band rasters (device ms, CUDA graphs) beside one
    unsharded K5. The lossless factor D routes every particle; the frame's
    3.0 is used where it drops none. D = 1 goes through the real
    collective: route, all_to_all_single on the card's NCCL group,
    raster_band. -> {(input, D): record}."""
    import torch.distributed as dist

    from illuminant_tpu_torch.parallel import mesh as pmesh
    from illuminant_tpu_torch.parallel import raster as praster
    from illuminant_tpu_torch.raster import splat_kernel as k5
    from illuminant_tpu_torch.raster import tiled

    rec = {}
    for name, args in inputs.items():
        cfg, x, y, color, size, live = args
        whole = k5.splat_cuda(*args)
        terms = tiled.splat_terms(cfg, x, y, size, live)
        tol = int(terms.max()) * 2.0 ** -23 * float(whole.abs().max())
        whole_ms = device_ms(lambda: k5.splat_cuda(*args), KERNEL_REPS)
        mesh = card_mesh(device)
        lanes, _, _ = praster.route(cfg, 1, x, y, color, size, live,
                                         praster.send_budget(
                                             cfg, 1, x.shape[0]))
        recv = torch.empty_like(lanes).reshape(-1, 8)
        dist.all_to_all_single(recv, lanes.reshape(-1, 8),
                               group=pmesh.mesh_group(mesh))
        one = praster.raster_band(cfg, 1, 0, recv)
        err1 = float((one - whole).abs().max())
        _require("mesh_bands D=1", err1, tol, inputs=name)
        for d in MESH_DEVICES:
            t0 = time.perf_counter()
            host = [a.cpu() for a in args[1:]]
            _, counts_cpu, drops_cpu, _ = _route_all(cfg, d, (cfg, *host),
                                                     3.0)
            sends, counts, drops, _ = _route_all(cfg, d, args, 3.0)
            if drops != drops_cpu or not torch.equal(counts.cpu(),
                                                     counts_cpu):
                raise AssertionError(
                    f"mesh_bands {name} D={d}: the card's route sends "
                    f"{counts.tolist()} and drops {drops}, the CPU's "
                    f"{counts_cpu.tolist()} and {drops_cpu}")
            factor = 3.0 if drops == 0 else float(d)
            if drops:
                sends, counts, _, _ = _route_all(cfg, d, args, factor)
            budget = sends.shape[2]
            recvs = sends.transpose(0, 1).reshape(d, d * budget, 8)
            _reset_launches()
            bands = [praster.raster_band(cfg, d, r, recvs[r])
                     for r in range(d)]
            launches = _launches()["k5_splat"]
            with_rows = sum(1 for b in bands if b.shape[0])
            band_err = band_tol = 0.0
            nbytes = ops = plain_ms = 0.0
            for r in range(d):
                if not bands[r].shape[0]:
                    continue
                local, crop = _band_inputs(cfg, d, r, recvs[r])
                ref, p_ms = timed_once(
                    lambda: tiled.rasterize_tiled_reference(*local)[0])
                b_terms = tiled.splat_terms(local[0], local[1], local[2],
                                            local[4], local[5])
                b_tol = int(b_terms.max()) * 2.0 ** -23 * float(
                    ref.abs().max())
                err = float((bands[r] - ref[crop]).abs().max())
                _require("mesh_bands band", err, b_tol, inputs=name, d=d,
                         rank=r)
                band_err, band_tol = max(band_err, err), max(band_tol,
                                                             b_tol)
                b_bytes, b_ops = splat_work(*local, b_terms)
                nbytes, ops, plain_ms = (nbytes + b_bytes, ops + b_ops,
                                         plain_ms + p_ms)
            stitched = torch.cat(bands)
            err = float((stitched - whole).abs().max())
            _require("mesh_bands stitched", err, tol, inputs=name, d=d)
            if launches != k5.LAUNCHES_PER_SPLAT * with_rows:
                raise AssertionError(f"mesh_bands {name} D={d}: K5 "
                                     f"launched {launches} times for "
                                     f"{with_rows} bands")
            n_loc = x.shape[0] // d
            route_calls = [
                (lambda r=r: praster.route(
                    cfg, d, *(a[r * n_loc:(r + 1) * n_loc]
                              for a in (x, y, color, size, live)), budget))
                for r in range(d)]
            band_calls = [(lambda r=r: praster.raster_band(cfg, d, r,
                                                           recvs[r]))
                          for r in range(d)]
            route_ms = sum(device_ms(f, KERNEL_REPS) for f in route_calls)
            bands_ms = sum(device_ms(f, KERNEL_REPS) for f in band_calls)
            bound_ms, bound_by = _bound(nbytes, ops)
            say("mesh_bands", inputs=name, d=d, particles=x.shape[0],
                send_budget=budget, factor=factor, send_dropped_at_3=drops,
                peak=int(counts.max()),
                owners_used=praster.owners_used(cfg, d),
                band_rows=json.dumps([list(pmesh.band_rows(cfg, d, r))
                                      for r in range(d)]),
                route_ms=f"{route_ms:.4f}", bands_ms=f"{bands_ms:.4f}",
                unsharded_ms=f"{whole_ms:.4f}", band_plain_ms=f"{plain_ms:.4f}",
                band_bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                band_max_abs_err=band_err, band_tol=band_tol,
                stitched_max_abs_err=err, tol=tol, d1_collective_err=err1,
                splat_launches=launches,
                seconds=f"{time.perf_counter() - t0:.1f}")
            rec[name, d] = dict(route_ms=route_ms, bands_ms=bands_ms,
                                whole_ms=whole_ms, err=max(err, band_err))
    return rec


def phase_reference_mesh():
    """The mesh frame at 96 x 160 on the card's mesh of one, with the
    global spawn ring and with 4 sub-rings, against the CPU frame without
    a mesh (which tests/test_torch_mesh_frame.py holds to the gloo mesh
    frames and the JAX sub-ring frame) from the same draws, with the
    bounds of `_compare_small`."""
    draws = _draws()
    for kw in (dict(MESH_SLICE), dict(MESH_SLICE, spawn_sub_rings=4)):
        t0 = time.perf_counter()
        cpu = _small_frames("cpu", draws, **kw)
        card = _small_frames("cuda", draws, mesh=card_mesh(), **kw)
        within, _ = _compare_small("reference_mesh", cpu, card, mesh_size=1,
                                   seconds=f"{time.perf_counter() - t0:.1f}",
                                   **kw)
        if within < 0.99:
            raise AssertionError(f"reference_mesh ({kw}): particles moved "
                                 "apart")


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
    per-stage tables under out_dir/name (none with out_dir None) and print
    the [profile*] line."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        two_frames()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # The host-side stage ranges: their host time, and the device time of
    # the kernels they launched. (Their device-side twins, with no host
    # time, span the GPU timeline and are not busy time.)
    stages = [e for e in ka
              if e.key.startswith("illuminant/") and e.cpu_time_total > 0]
    if out_dir is not None:
        out_dir = os.path.join(out_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "profile_kernels.txt"), "w") as f:
            f.write(ka.table(sort_by="cuda_time_total", row_limit=40))
        with open(os.path.join(out_dir, "profile_stages.txt"), "w") as f:
            for e in sorted(stages, key=lambda e: -e.cpu_time_total):
                f.write(f"{e.key} calls={e.count} "
                        f"host_ms_per_frame={e.cpu_time_total / 2e3:.3f} "
                        f"device_ms_per_frame="
                        f"{e.device_time_total / 2e3:.3f}\n")
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
                    "archive`): its tile kernels, K10, K5 and K12 are "
                    "timed beside these on the same inputs")
    args = ap.parse_args(argv)
    started = time.perf_counter()
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
    model_warmup = MODEL_WARMUP_FRAMES if args.warmup is None \
        else args.warmup
    phase_build()
    cuda = torch.device("cuda")
    scene, field = _slice_field(cuda)
    env_host = dict(ground_z=scene.environment.ground_z,
                    maximum_z=scene.environment.maximum_z)
    kernel = phase_kernel(field)
    phase_scan_walk_kernel(kernel)
    phase_scan_readout_kernel(kernel)
    phase_integrate_kernel(kernel)
    phase_spawn_kernel(kernel)
    phase_modifier_kernel(kernel)
    kernel.update(phase_sprite_kernels(parent=parent_module(
        args.parent, "raster.tile_kernel") if args.parent else None))
    parent_lights = None
    if args.parent:
        parent_lights = parent_module(args.parent,
                                      "lighting.tiled_lights_kernel")
        PARENT["splat"] = parent_module(args.parent, "raster.splat_kernel")
        PARENT["cone_trace"] = parent_module(args.parent,
                                             "lighting.cone_trace_kernel")
        say("build", kernel="parent cone_trace", march_loop_sass=json.dumps(
            march_loop_sass(PARENT["cone_trace"].LIBRARY.path)))
    launches, frame_ms = {}, {}
    for name, kw in SLICES.items():
        if name == "slice_family":
            phase_families()
        if scene is None:
            scene = build_flagship(device=cuda, **FULL, **kw)
        launches[name], state, frame_ms[name], k12_calls = phase_slice(
            name, scene, warmup, TIMED_FRAMES)
        if name == "slice":
            kernel.update(phase_frame_points(field, state,
                                             scene.raster_config))
            kernel.update(phase_voxel_march_kernel(field, scene))
        if name == "slice_family_march":
            # The frame's K12 calls: the sphere pass's rays, the sun's,
            # the projector's.
            for key, call in zip(("family", "family_sun",
                                  "family_projector"), k12_calls):
                _cone_trace_row(kernel, "cone_trace_" + key, call,
                                inputs="march_cell_" + key.split("_")[-1]
                                if key != "family"
                                else "family_march_sphere")
        scene = state = k12_calls = None
        torch.cuda.empty_cache()
    mesh_launches, state, cfg, frame_ms["slice_mesh"] = phase_slice_mesh(
        warmup, TIMED_FRAMES, frame_ms["slice_analytic"])
    SLICE_LAST.clear()
    phase_mesh_bands({
        "flagship": (cfg, state.position[:, 0], state.position[:, 1],
                     state.render_color, state.render_data[:, 0],
                     state.live_mask()),
        "clustered": clustered_cloud(cuda)})
    state = None
    torch.cuda.empty_cache()
    pack_launches = 0
    for name in RENDERER_FRAMES:
        frame_ms[name], k12_call, packs = phase_slice_renderer(name)
        pack_launches += packs
        if k12_call is not None:
            _cone_trace_row(kernel, "cone_trace_renderer", k12_call,
                            inputs="renderer_march")
            _pack_row(kernel, "volume_pack", k12_call[0][0],
                      inputs="renderer_march")
        k12_call = None
        torch.cuda.empty_cache()
    particle_launches, frame_ms["slice_particles"], splat_args = \
        phase_slice_particles(field, warmup)
    _splat_row(kernel, "splat_particles", splat_args, inputs="particles")
    splat_args = None
    _splat_row(kernel, "splat_clustered", clustered_cloud(cuda),
               inputs="clustered")
    torch.cuda.empty_cache()
    sprite_launches = {}
    for additive in (False, True):
        sprite_launches[additive], frame_ms[
            "slice_additive_sprites" if additive
            else "slice_alpha_sprites"] = phase_slice_sprites(
                field, sprite_warmup, additive, kernel)
        torch.cuda.empty_cache()
    model_launches, frame_ms["slice_model"] = phase_slice_model(
        field, model_warmup, kernel)
    torch.cuda.empty_cache()
    light_launches, frame_ms["slice_particle_lights"], light_call = \
        phase_slice_lights(field, env_host, warmup)
    kernel.update(phase_light_kernel(light_call, parent_lights))
    del light_call
    torch.cuda.empty_cache()
    # Profiled after every slice is timed: a profiler session slows the
    # launches that follow it in the process. The march cell's device busy
    # time is measured in every run (its tables only with --profile).
    for name in SLICES if args.profile else ("slice_family_march",):
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
    phase_reference_models()
    phase_reference_particle_lights()
    phase_reference_probes()
    phase_reference_march()
    phase_reference_mesh()
    # Each kernel at the heavier of the frame's calls: the query with the
    # unit gradient, the sampler with the derivative rows; the other calls
    # are in the [kernel] lines above. "ms" is one call of the wrapper the
    # frame calls (the query and the sampler include their pack).
    # "launches" counts the voxel flagship's timed frames,
    # "launches_particles" the particle cell's timed ticks,
    # "launches_sprites" the alpha sprite cell's,
    # "launches_particle_lights" the particle-light cell's timed frames,
    # "launches_model" the model cell's;
    # the tile kernels' "launches" count their sprite cell's timed
    # renders, their times are at that cell's steady 131,072 particles;
    # K10's count that cell's frames, its time is on its last frame.
    rows = [("column_query", "k7_column_query",
             "illuminant_tpu/sdf/columns_pallas.py:78", kernel["query", True]),
            ("column_maps_sample", "k7_column_sample",
             "illuminant_tpu/sdf/columns_pallas.py:78",
             kernel["sample", True]),
            ("column_maps_pack", "k7_column_pack",
             "illuminant_tpu/sdf/columns_pallas.py:108", kernel["pack"])]
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": "illuminant_tpu_torch/csrc/column_maps.cu",
        "replaces": replaces,
        "launches": launches["slice"][span],
        "launches_particles": particle_launches[span],
        "launches_sprites": sprite_launches[False][span],
        "launches_particle_lights": light_launches[span],
        "launches_model": model_launches[span],
        "max_abs_err": r["err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1],
        "library_ms": r.get("library_ms"),
    } for name, span, replaces, r in rows]
    for name, span, replaces, key, additive in (
            ("composite_over_tiles", "k11a_composite",
             "illuminant_tpu/raster/tiled.py:749", "composite", False),
            ("sprite_accumulate", "k11b_sprite_accumulate",
             "illuminant_tpu/raster/sprites.py:344", "accumulate", True)):
        r = kernel[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "illuminant_tpu_torch/csrc/tile_raster.cu",
            "replaces": replaces,
            "launches": sprite_launches[additive][span],
            "launches_model": model_launches[span],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None})
    r = kernel["lights"]
    kernels.append({
        "name": "tiled_lights_fused", "route": "cuda",
        "source": "illuminant_tpu_torch/csrc/tiled_lights.cu",
        "replaces": "illuminant_tpu/lighting/tiled_lights.py:123",
        "launches": light_launches["k10_tiled_lights"],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
        "library_ms": None})
    # K12 at the new cell's sphere rays (its launches: the cell's timed
    # frames; the renderer march's and the scan flagships' beside them);
    # K5 at the voxel flagship's steady particles (launches: its timed
    # frames; the particle and model cells' beside them).
    # The volume pack: renderer-voxel-march's frames (once a new volume).
    for name, source, replaces, r, counts in (
            ("scan_walk", "illuminant_tpu_torch/csrc/scan_walk.cu",
             "illuminant_tpu/lighting/scan_shadows.py:150",
             kernel["scan_walk_analytic"],
             dict(launches=launches["slice_analytic"]["k1_scan_walk"],
                  launches_voxel=launches["slice"]["k1_scan_walk"],
                  launches_family=launches["slice_family"]["k1_scan_walk"])),
            # K2 at the flagship scan cell's readout; the 2.5D renderer
            # cell's (16 lanes, prisms and a turned box) beside it.
            ("scan_readout", "illuminant_tpu_torch/csrc/scan_readout.cu",
             "illuminant_tpu/lighting/scan_shadows.py:581",
             kernel["scan_readout_flagship"],
             dict(launches=launches["slice_analytic"]["k2_scan_readout"],
                  launches_voxel=launches["slice"]["k2_scan_readout"],
                  launches_family=launches["slice_family"]["k2_scan_readout"],
                  ms_renderer_25d=kernel["scan_readout_renderer_25d"]["ms"],
                  plain_ms_renderer_25d=kernel[
                      "scan_readout_renderer_25d"]["plain_ms"],
                  bound_ms_renderer_25d=kernel[
                      "scan_readout_renderer_25d"]["bound"][0])),
            ("cone_trace", "illuminant_tpu_torch/csrc/cone_trace.cu",
             "illuminant_tpu/lighting/cone_trace.py:42",
             kernel["cone_trace_family"],
             dict(launches=launches["slice_family_march"]["k12_cone_trace"],
                  launches_family=launches["slice_family"]["k12_cone_trace"])),
            ("volume_pack", "illuminant_tpu_torch/csrc/cone_trace.cu",
             "illuminant_tpu/lighting/cone_trace.py:42",
             kernel["volume_pack"], dict(launches=pack_launches)),
            ("splat", "illuminant_tpu_torch/csrc/splat.cu",
             "illuminant_tpu/raster/tiled.py:589", kernel["splat_flagship"],
             dict(launches=launches["slice"]["k5_splat"],
                  launches_particles=particle_launches["k5_splat"],
                  launches_model=model_launches["k5_splat"],
                  launches_mesh=mesh_launches)),
            # K4 at the flagship cell's integrate call (the analytic
            # field, one substep); the particle cell's (the ColumnField,
            # three) beside it.
            ("collide_integrate", "illuminant_tpu_torch/csrc/"
             "collide_integrate.cu",
             "illuminant_tpu/particles/integrate.py:95",
             kernel["collide_integrate_flagship"],
             dict(launches=launches["slice_analytic"]["k4_integrate"],
                  launches_voxel=launches["slice"]["k4_integrate"],
                  launches_particles=particle_launches["k4_integrate"],
                  launches_model=model_launches["k4_integrate"],
                  ms_particles=kernel["collide_integrate_particles"]["ms"],
                  plain_ms_particles=kernel[
                      "collide_integrate_particles"]["plain_ms"],
                  bound_ms_particles=kernel[
                      "collide_integrate_particles"]["bound"][0])),
            # K4b at the flagship cell's spawn call (animated uniforms);
            # the particle cell's (static ones) beside it.
            ("spawn", "illuminant_tpu_torch/csrc/spawn.cu",
             "illuminant_tpu/particles/spawner.py:65",
             kernel["spawn_flagship"],
             dict(launches=launches["slice_analytic"]["k4b_spawn"],
                  launches_particles=particle_launches["k4b_spawn"],
                  ms_particles=kernel["spawn_particles"]["ms"],
                  plain_ms_particles=kernel["spawn_particles"]["plain_ms"],
                  bound_ms_particles=kernel["spawn_particles"][
                      "bound"][0])),
            # K4c at the particle cell's modifier chain (VectorField,
            # Gravity, Noise); its launches the particle cell's ticks, the
            # flagship's (its Gravity) beside them.
            ("modifiers", "illuminant_tpu_torch/csrc/modifiers.cu",
             "illuminant_tpu/particles/transforms.py",
             kernel["modifiers_particles"],
             dict(launches=particle_launches["k4c_modifiers"],
                  launches_flagship=launches["slice_analytic"][
                      "k4c_modifiers"],
                  graph_ms=kernel["modifiers_particles"]["graph_ms"]))):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, **counts, "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None})
    import torch.distributed as dist

    dist.destroy_process_group()
    say("done", seconds=f"{time.perf_counter() - started:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
