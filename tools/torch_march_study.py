"""What K12's (the cone-trace march) and K5's (the additive splat) design
choices buy on the card.

Builds copies of illuminant_tpu_torch/csrc/cone_trace.cu and splat.cu with
one constant changed (into build/march_study/, one nvcc each, all started
together) and times each copy, and each runtime choice of the wrappers, on
the same inputs in turns (each once forward, once backward; the least of
the two), with the build's output required bit for bit from every copy:
the choices change which thread reads what from where, not any
arithmetic.

  * K12 (`cone_trace_kernel`), on renderer-voxel-march's rays (the
    SdfVolume), the analytic march cell's sphere rays and the voxel
    flagship's ColumnField rays at 1080p: `__launch_bounds__` minimum
    blocks an SM (each instance's own, the build; 1, 5, 6, 8), 16 x 16 ray
    tiles against the same rays in order (flattened to (L, H x W));
  * K5 (`splat_kernel`), on the particle cell's quads after its default
    warm-up and its 1,048,576 steady ones, the model cell's sparks after
    its default warm-up, a uniform cloud of 1,048,576 gauss particles of
    2-4 px, the clustered cloud of `chip_smoke.clustered_cloud` and the
    voxel flagship's particles after its default warm-up: the most particles a chunk
    holds (`CHUNK` 128, 256 (the build's), 1024; a chunk holds at most two
    batches too, `chunk_size`), the most particles of a tile whose terms the
    accumulation adds to the image without a window (`DIRECT` 0, 32 (the
    build's), 128), the lanes that share a particle (1, 2, 4 for every
    profile; the build's `LANES`: 4 for gauss, else 2); and each of its
    kernels' device time
    (bin, scan, scatter, accumulate; torch.profiler; "other" is the
    image's zero fill and the counts' memset).

Run from the repository root on a CUDA card:

    python3 tools/torch_march_study.py [--parent DIR] [--only KERNEL]

`--parent DIR`: an earlier commit's K5, unpacked with `git archive` at
DIR, timed beside these; `--only cone_trace` or `--only splat`: one of
the two. One JSON line a kernel's input (ms of each choice, the fastest
of its turns), the variants' registers and spills, and the card's name
and power limit. Exits 2 without a card.
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# min_blocks<F>()'s body in cone_trace.cu: each instance's minimum blocks
# an SM for __launch_bounds__.
MIN_BLOCKS = "return F == kColumn ? 5 : F == kVolume ? 6 : 1;"
# (kernel, variant) -> (the source's text, its replacement); None: the
# build.
VARIANTS = {
    ("cone_trace", "build"): None,
    **{("cone_trace", f"min_blocks_{m}"): (MIN_BLOCKS, f"return {m};")
       for m in (1, 5, 6, 8)},
    ("splat", "build"): None,
}
# K5's runtime choice: the most particles a chunk (one accumulation block)
# holds; the build's is splat_kernel.CHUNK.
CHUNKS = (128, 256, 1024)
# And the most particles of a tile whose terms the accumulation adds to
# the image without a window (the build's: splat_kernel.DIRECT).
DIRECTS = (0, 32, 128)
REPS = 20
# Each variant's registers and spills (`chip_smoke.ptxas_summary`).
PTXAS = {}


def build_all(modules):
    """Each variant's library, built -> (kernel, variant):
    `cuda_build.Library` with its wrapper's entry points."""
    from illuminant_tpu_torch.core import cuda_build

    out_dir = ROOT / "build" / "march_study"
    out_dir.mkdir(parents=True, exist_ok=True)

    def make(key):
        kernel, name = key
        lib = base = modules[kernel].LIBRARY
        if VARIANTS[key] is not None:
            old, new = VARIANTS[key]
            text = base.source.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{key}: {old!r} is not in the source")
            source = out_dir / f"{kernel}_{name}.cu"
            source.write_text(text.replace(old, new))
            lib = cuda_build.Library(source, base.entry_points, base.kernels,
                                     path=out_dir / f"lib{kernel}_{name}.so")
        lib.build()
        PTXAS[name] = cs.ptxas_summary(cuda_build.BUILD_LOGS.get(lib.path,
                                                                 ""))
        return key, lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(make, VARIANTS))


def march_inputs(cs):
    """The three K12 calls of chip_smoke's [kernel] rows: name -> (args,
    kwargs)."""
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
    from illuminant_tpu_torch.lighting.sphere import accumulate_sphere_lights
    from illuminant_tpu_torch.scenes import build_flagship

    cuda = torch.device("cuda")
    calls = {}
    r, hdr, move, mode, budget = cs._build_renderer(
        "slice_renderer_march", "cuda", cs.FULL["height"], cs.FULL["width"])
    with cs.KernelInputs("cone_trace_cuda", ctk) as spy:
        for i in range(3):
            cs.renderer_frame(r, hdr, move, i, mode, budget)
    calls["renderer_march"] = spy.calls[-1]
    scene = build_flagship(device=cuda, **cs.FULL,
                           **cs.SLICES["slice_family_march"])
    gen = torch.Generator(device=cuda).manual_seed(0)
    with cs.KernelInputs("cone_trace_cuda", ctk) as spy:
        cs._run_frames(scene, 2, 0, gen, scene.system.state,
                       torch.tensor(0.5, device=cuda))
    calls["family_march_sphere"] = spy.calls[-3]
    del scene
    scene, field = cs._slice_field(cuda)
    env_u = scene.environment.uniforms(device=cuda)
    with cs.KernelInputs("cone_trace_cuda", ctk) as spy:
        accumulate_sphere_lights(field, scene.gbuffer, scene.sphere_lights,
                                 env_u, scene.config.quality,
                                 with_specular=False, shadow_mode="march",
                                 with_ao=False, with_alpha=False)
    calls["voxel_flagship"] = spy.calls[0]
    return calls, scene, field


def splat_inputs(cs, scene, field):
    """The K5 calls: name -> (cfg, x, y, color, size, live)."""
    from illuminant_tpu_torch.raster import splat_kernel as k5
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    cuda = torch.device("cuda")
    calls = {}
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, state, _ = cs._run_frames(scene, 4, 0, gen, scene.system.state,
                                 torch.tensor(0.5, device=cuda))
    pos = state.position
    calls["flagship_default"] = (scene.raster_config, pos[:, 0], pos[:, 1],
                                 state.render_color, state.render_data[:, 0],
                                 state.live_mask())
    for name, warmup in (("particles_default", 4),
                         ("particles_1m_quad", 260)):
        system, _, raster, _ = cs._particle_cell(field, warmup)
        system.update(cs.DT)
        with cs.KernelInputs("splat_cuda", k5) as spy:
            system.render(raster)
        calls[name] = spy.args
        del system
    view, raster, _ = cs.model_cell(field, cs.MODEL_WARMUP_FRAMES)
    view.update(cs.DT)
    with cs.KernelInputs("splat_cuda", k5) as spy:
        cs.model_render(view, raster)
    calls["model_sparks"] = spy.args
    del view
    rng = np.random.default_rng(3)
    n = 1 << 20
    h, w = cs.FULL["height"], cs.FULL["width"]
    t = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    calls["uniform_1m_gauss"] = (
        TiledRasterConfig(height=h, width=w, kernel="gauss", channels=3),
        t(rng.uniform(0, w, n).astype(np.float32)),
        t(rng.uniform(0, h, n).astype(np.float32)),
        t(rng.uniform(0, 1, (n, 4)).astype(np.float32)),
        t(rng.uniform(2, 4, n).astype(np.float32)), t(np.ones(n, bool)))
    calls["clustered"] = cs.clustered_cloud(cuda)
    return calls


def flat(a):
    """A sphere pass's K12 arguments (field, centres (L, 1, 1, 3), radius
    and ramp (L, 1, 1), points (1, H, W, 3), enable (L, H, W), quality)
    with the (H, W) axes flattened: the same rays, (L, H x W), launched in
    order rather than in 16 x 16 tiles."""
    return (a[0],) + tuple(t.flatten(1, 2) if t.dim() == 4 else
                           t.flatten(1) for t in a[1:6]) + tuple(a[6:])


def stage_ms(fn, calls: int = 20) -> dict:
    """Device time of each kernel (and fill) of one fn() call, by name:
    torch.profiler over `calls` calls after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((k for k in ("bin_kernel", "scan_kernel",
                                 "scatter_kernel", "accumulate_kernel")
                     if k in e.name), "other")
        out[name] = out.get(name, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e3
    return {k: v / calls for k, v in out.items()}


def turns(choices, run, base, what):
    """{choice: the least ms of its two turns}; every output equal to
    `base`."""
    times = {name: [] for name in choices}
    for name in list(choices) + list(choices)[::-1]:
        out = run(name)
        if not all(torch.equal(a, b) for a, b in zip(out, base)):
            raise AssertionError(f"{what}: {name} changed the output")
        times[name].append(cs.device_ms(lambda: run(name), REPS))
    return {name: round(min(v), 4) for name, v in times.items()}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an earlier checkout (`git archive`) whose K5 is "
                    "timed beside these")
    ap.add_argument("--only", choices=("cone_trace", "splat"), default=None,
                    help="study one kernel")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_march_study: no CUDA device", file=sys.stderr)
        return 2
    from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
    from illuminant_tpu_torch.raster import splat_kernel as k5

    global CHUNK, DIRECT, LANES
    CHUNK, DIRECT, LANES = k5.CHUNK, k5.DIRECT, dict(k5.LANES)
    modules = {"cone_trace": ctk, "splat": k5}
    libs = build_all(modules)
    card = cs.card_line()
    local = {name.split("_GLOBAL__N_")[-1][-40:]: sum(
        1 for _, ins in body if ins.split()[0].startswith(("LDL", "STL")))
        for name, body in cs.sass_functions(libs["splat", "build"]
                                            .path).items()}
    print(json.dumps(dict(ptxas=PTXAS, splat_local_memory_ops=local)),
          flush=True)
    if opts.only == "splat":
        march = {}
        scene, field = cs._slice_field(torch.device("cuda"))
    else:
        march, scene, field = march_inputs(cs)
    for name, (call_args, kwargs) in march.items():
        a = tuple(call_args[:7])
        raw = kwargs.get("raw", call_args[7] if len(call_args) > 7
                         else False)

        def run(choice, a=a, raw=raw):
            variant, order = choice.split("/")
            ctk.LIBRARY = libs["cone_trace", variant]
            args = a if order == "tiles" else flat(a)
            out = ctk.cone_trace_cuda(*args, raw, with_steps=True)
            return tuple(t.reshape(ctk.launch_plan(*a, raw)["shape"])
                         for t in out)

        choices = ["build/tiles", "build/in_order"] + [
            f"{v}/tiles" for (k, v) in VARIANTS
            if k == "cone_trace" and v != "build"]
        base = run("build/tiles")
        row = dict(kernel="cone_trace", inputs=name,
                   rays=int(base[0].numel()),
                   **turns(choices, run, base, name), card=card)
        ctk.LIBRARY = libs["cone_trace", "build"]
        print(json.dumps(row), flush=True)
    del march
    if opts.only == "cone_trace":
        print(card)
        return 0
    parent = cs.parent_module(opts.parent, "raster.splat_kernel") \
        if opts.parent else None
    for name, args in splat_inputs(cs, scene, field).items():
        def run(choice, args=args):
            k5.LIBRARY = libs["splat", choice if ("splat", choice) in libs
                           else "build"]
            key, value = (choice.split("_") + [""])[:2]
            k5.DIRECT = int(value) if key == "direct" else DIRECT
            k5.LANES = {kind: int(value) for kind in LANES} \
                if key == "lanes" else dict(LANES)
            k5.CHUNK = int(value) if key == "chunk" else CHUNK
            return (k5.splat_cuda(*args),)


        # Reordered float atomics: compared within the plain bound, not
        # bit for bit.
        from illuminant_tpu_torch.raster import tiled

        ref, _ = tiled.rasterize_tiled_reference(*args)
        cfg, x, y, _, size, live = args
        tol = int(tiled.splat_terms(cfg, x, y, size, live).max()) \
            * 2.0 ** -23 * float(ref.abs().max())
        choices = [f"chunk_{c}" for c in CHUNKS] + [
            f"direct_{d}" for d in DIRECTS if d != DIRECT] + [
            f"lanes_{g}" for g in (1, 2, 4)] + [
            v for (k, v) in VARIANTS if k == "splat" and v != "build"]
        if parent is not None:
            choices.append("parent")
        times = {c: [] for c in choices}
        for c in choices + choices[::-1]:
            if c == "parent":
                call = lambda: (parent.splat_cuda(*args),)  # noqa: E731
            else:
                call = lambda c=c: run(c)  # noqa: E731
            err = float((call()[0] - ref).abs().max())
            if not err <= tol:
                raise AssertionError(f"{name} {c}: {err} > {tol}")
            times[c].append(cs.device_ms(call, REPS))
        k5.LIBRARY, k5.CHUNK, k5.DIRECT, k5.LANES = libs["splat", "build"], \
            CHUNK, DIRECT, dict(LANES)
        times.update({f"{k}_device_ms": [v]
                      for k, v in stage_ms(lambda: k5.splat_cuda(*args))
                      .items()})
        counts = k5.bin_plan(cfg, x, y, live)["counts"]
        print(json.dumps(dict(kernel="splat", inputs=name,
                              particles=int(x.shape[0]),
                              binned=int(counts.sum()),
                              tiles_used=int((counts > 0).sum()),
                              tile_max=int(counts.max()),
                              **{c: round(min(v), 4)
                                 for c, v in times.items()}, card=card)),
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
