"""The benchmark's 2.5D renderer cell (`renderer-25d-1080p`: `LightingRenderer`
at 1080p with `two_point_five_d=True` under scan shadows, height volumes
and a billboard in the G-buffer, 8 ring lights with AO, ramp and specular
settings, 8 replicated lights, a subtractive and a max pass) on the CPU at
96 x 160 with all 18 lights: the cell agrees with its plain reference and
the control does not, its frozen scene is `chip_smoke.renderer_25d_scene`,
the reference's hand cases, the new spans' nesting and the cell's three
readers.

On the CPU the port walks the scan with its plain loop
(`lighting/scan_shadows.py:scan_walk_reference`), which takes the
reference's operations in the reference's order, as does every other
stage of the frame, so every compared number reads 0 here.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from framebench.lib import bench, loader  # noqa: E402
from framebench.lib.trace import Trace  # noqa: E402
from framebench.reference import gbuffer25d, sdf, sdf25d  # noqa: E402

CELL = "renderer-25d-1080p"
CONFIG = "renderer-25d-scan-1080p"
# 96 rows: the z unit chip_smoke's small frame takes (h / 270), so that
# the volumes' faces stay inside the frame.
SMALL = dict(height=96, width=160, z_unit=96 / 270)
SEED = 2 ** 31 + 303
NEW_METRICS = {"gbuffer_25d_device_ms", "scan_readout_device_ms",
               "sphere_ao_device_ms"}
# The host times of frames run with the program's recorder on.
RECORDED_METRICS = {"frame_host_ms", "host_syncs_per_frame",
                    "launch_host_us", "sphere_lights_host_ms"}

ref_mod = loader.module("reference", CONFIG)


@pytest.fixture(scope="module")
def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_base(tmp_path_factory):
    """A copy of framebench/ with the 2.5D configuration cut to SMALL;
    -> the copy's path."""
    base = tmp_path_factory.mktemp("renderer25d") / "framebench"
    shutil.copytree(os.path.join(ROOT, "framebench"), base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = base / "configs" / f"{CONFIG}.json"
    config = json.loads(path.read_text())
    config.update(SMALL)
    path.write_text(json.dumps(config))
    return str(base)


def _small_config(small_base):
    with open(os.path.join(small_base, "configs", f"{CONFIG}.json")) as f:
        return json.load(f)


def _cell(small_base):
    config = _small_config(small_base)
    params = loader.json_file("workloads", CELL)
    return loader.module("scenes", CONFIG, small_base).build(
        config, params, SEED, torch.device("cpu"))


@pytest.fixture(scope="module")
def controlled(bench_json, small_base):
    return bench.run(CELL, SEED, 1.0, False, "cpu", time.perf_counter(),
                     bench=bench_json, base=small_base, control=True)


def test_the_cell_is_in_the_benchmark(bench_json):
    spec = loader.cell(bench_json, CELL)
    assert spec["entry"]["chips"] == 1
    assert spec["entry"]["traffic"] == "renderer_25d_moving"
    assert spec["config_entry"]["reduced"] == []
    assert spec["config_entry"]["source"] == spec["config"]["source"]
    assert (spec["config"]["width"], spec["config"]["height"]) == (1920, 1080)
    assert spec["config"]["z_unit"] == 1.0
    assert {m["name"] for m in spec["per_layer"]} == \
        NEW_METRICS | RECORDED_METRICS
    for m in spec["per_layer"]:
        assert m["moves"] == "frame_ms"
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == [CELL]
    assert set(spec["params"]["checks"]) == {"gbuffer", "lightmap",
                                             "image_max", "image_mean"}
    assert hasattr(loader.module("scenes", CONFIG), "build")
    for name in NEW_METRICS | RECORDED_METRICS:
        assert callable(loader.module("metrics", name).read)


def test_the_reference_loads_neither_package():
    code = ("import json, sys\n"
            "from framebench.lib import loader\n"
            f"loader.module('reference', '{CONFIG}')\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & set(bench.BANNED + ("illuminant_tpu_torch",))


def test_the_cell_equals_its_reference_on_the_cpu(controlled):
    """Every number reads 0: on the CPU the port's G-buffer, scan, shading,
    blend passes and resolve follow the reference's operations in order."""
    assert controlled["correct"] and controlled["failed"] == 0
    assert controlled["attempted"] > 0
    assert all(c["value"] == 0.0 for c in controlled["checks"].values()), \
        controlled["checks"]


def test_the_control_fails_every_number(controlled):
    failing = {name for name, value in controlled["control"].items()
               if value > controlled["checks"][name]["limit"]}
    assert failing == set(controlled["checks"]), controlled["control"]


def test_a_frame_that_skips_the_g_buffer_rasters_is_not_correct(
        bench_json, small_base, monkeypatch):
    """A G-buffer left at the ground plane (no volumes, no billboard)
    fails the `gbuffer` number."""
    from illuminant_tpu_torch.lighting import renderer as trend

    monkeypatch.setattr(trend, "rasterize_height_volumes",
                        lambda gbuffer, volumes, env: gbuffer)
    r = bench.run(CELL, SEED, 0.3, False, "cpu", time.perf_counter(),
                  bench=bench_json, base=small_base)
    assert not r["correct"]
    assert r["checks"]["gbuffer"]["value"] > r["checks"]["gbuffer"]["limit"]


def _light(l):
    return (tuple(l.position), l.radius, l.ramp_length, tuple(l.color),
            l.opacity, l.cast_shadows, l.ambient_occlusion_radius,
            l.ambient_occlusion_opacity, tuple(l.specular_color),
            l.specular_power, l.ramp_offset, l.ramp_rate,
            None if l.ramp_texture is None
            else l.ramp_texture.tobytes(), l.blend_mode)


def test_the_scene_is_chip_smokes_renderer_25d_scene(small_base):
    """The cell's frozen scene, built on the CPU, holds the lights,
    replicas, volumes, obstructions, billboard, resolve and motion of
    `chip_smoke.renderer_25d_scene` at the same size, value for value."""
    import chip_smoke
    from illuminant_tpu_torch.lighting.environment import (
        LightSourceReplicator, SphereLightSource)

    cell = _cell(small_base)
    smoke, hdr, move = chip_smoke.renderer_25d_scene(
        chip_smoke.port_api(), SMALL["width"], SMALL["height"],
        device="cpu")
    ours = cell.renderer
    assert ours.config == smoke.config and hdr == cell.hdr
    a, b = ours.environment, smoke.environment
    assert (a.ground_z, a.maximum_z, a.z_to_y_multiplier, a.ambient) == (
        b.ground_z, b.maximum_z, b.z_to_y_multiplier, b.ambient)
    assert [type(l) for l in a.lights] == [type(l) for l in b.lights]
    for x, y in zip(a.lights, b.lights):
        if isinstance(x, SphereLightSource):
            assert _light(x) == _light(y)
        elif isinstance(x, LightSourceReplicator):
            assert _light(x.template) == _light(y.template)
            assert [_light(l) for l in x.expand()] == [
                _light(l) for l in y.expand()]
        else:
            assert x == y
    assert [(tuple(map(tuple, v.polygon)), v.z_base, v.height,
             v.is_obstruction) for v in a.height_volumes] == [
        (tuple(map(tuple, v.polygon)), v.z_base, v.height, v.is_obstruction)
        for v in b.height_volumes]

    def obstructions(env):
        return [(o.type, tuple(o.center), tuple(o.size), tuple(o.rotation))
                for o in env.obstructions]

    assert obstructions(a) == obstructions(b)
    (x,), (y,) = a.billboards, b.billboards
    assert (x.screen_bounds, x.cylinder_factor, x.texture.tobytes()) == (
        y.screen_bounds, y.cylinder_factor, y.texture.tobytes())
    i = cell.k0 + 7
    move(i)
    cell.moving_light.position = ref_mod.moving_light(
        cell.config, cell.ring_base, i)
    cell.moving_box.center = ref_mod.moving_box(cell.config, i)
    assert [_light(l) for l in a.lights[:8]] == [
        _light(l) for l in b.lights[:8]]
    assert obstructions(a) == obstructions(b)


def test_the_new_spans_nest_on_the_cpu(small_base):
    """A profiled frame opens each new span once, inside its stage: the
    rasters inside the G-buffer's span (inside `update_fields`), the
    readout inside the scan's span, the AO inside the sphere lights' span
    (both inside `render_lighting`)."""
    from torch.profiler import ProfilerActivity, profile

    cell = _cell(small_base)
    cell.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cell.step()
    want = {
        "illuminant/renderer/gbuffer/height_volumes":
            "illuminant/renderer/gbuffer",
        "illuminant/renderer/gbuffer/billboards":
            "illuminant/renderer/gbuffer",
        "illuminant/scan_shadows/readout": "illuminant/scan_shadows",
        "illuminant/sphere_lights/ao": "illuminant/sphere_lights"}
    stages = {"illuminant/renderer/gbuffer":
              "illuminant/renderer/update_fields",
              "illuminant/scan_shadows": "illuminant/renderer/render_lighting",
              "illuminant/sphere_lights":
                  "illuminant/renderer/render_lighting"}
    events = prof.events()
    for name, parent in want.items():
        found = [e for e in events if e.name == name]
        assert len(found) == 1, (name, len(found))
        chain = []
        e = found[0].cpu_parent
        while e is not None:
            if e.name.startswith("illuminant/"):
                chain.append(e.name)
            e = e.cpu_parent
        assert chain[0] == parent, (name, chain)
        assert stages[parent] in chain, (name, chain)


# -- the reference's hand cases ---------------------------------------------

def _f(v):
    return torch.tensor(v, dtype=torch.float32)


# The configuration's concave hexagon at h = 100, about the origin: the
# vertex (3, 1) is the notch's.
HEXAGON = [(-7.0, -4.0), (2.0, -8.0), (9.0, -2.0), (3.0, 1.0), (7.0, 8.0),
           (-6.0, 6.0)]


def test_the_concave_hexagon_by_hand():
    """(0, 0) is inside, nearest the notch vertex (3, 1): -sqrt(10). (6, 1)
    lies in the notch, outside, nearest the edge (9, -2) -> (3, 1) at
    t = 27 / 45 with q = (0.6, 1.2): +sqrt(1.8). As the prism of z range
    [0, 30], biased out by 1.5: at z = 15 inside, sqrt(10) - 1.5 + 15
    below the surface; at z = 34 above the inside point, the 4 units
    above its top; in the notch at z = 15, sqrt(1.8) + 1.5."""
    v = _f(HEXAGON)
    d = sdf25d.polygon_sd(_f([0.0, 6.0]), _f([0.0, 1.0]), v)
    assert d.tolist() == pytest.approx([-math.sqrt(10.0), math.sqrt(1.8)],
                                       abs=1e-5)
    prism = sdf25d.Prism(v, _f(0.0), _f(30.0))
    got = prism.distance(_f([0.0, 0.0, 6.0]), _f([0.0, 0.0, 1.0]),
                         _f([15.0, 34.0, 15.0]))
    assert got.tolist() == pytest.approx(
        [-math.sqrt(10.0) + 1.5 - 15.0, 4.0, math.sqrt(1.8) + 1.5],
        abs=1e-5)


def test_the_hexagon_equals_the_ports_extruded_distance():
    from illuminant_tpu_torch.sdf.height_volume import (
        HeightVolume, extruded_polygon_distance_p, pack_height_volumes)

    packed = pack_height_volumes([HeightVolume(polygon=HEXAGON, z_base=0.0,
                                               height=30.0)], device="cpu")
    g = torch.linspace(-12.0, 12.0, 49)
    x, y = g[None, :], g[:, None]
    z = _f(12.5)
    ours = sdf25d.Prism(_f(HEXAGON), _f(0.0), _f(30.0)).distance(x, y, z)
    assert torch.equal(ours, extruded_polygon_distance_p(x, y, z, packed))


def test_the_rotated_box_by_hand():
    """The configuration's quaternion (0, 0, sin 15 deg, cos 15 deg) turns a
    box 30 degrees: the point 10 units out along its turned x axis,
    R(-30 deg) (10, 0, 0), lies 10 - 4 = 6 from a box of half size
    (4, 2.5, 20); unturned, the same point lies sqrt(4.66^2 + 2.5^2)
    from it."""
    a = math.radians(15.0)
    box = sdf.Primitive(sdf.TYPE_BOX, _f([0.0, 0.0, 0.0]),
                        _f([4.0, 2.5, 20.0]))
    px = _f([10.0 * math.cos(math.radians(30.0))])
    py = _f([-10.0 * math.sin(math.radians(30.0))])
    pz = _f([0.0])
    turned = sdf25d.Turned(box, _f([0.0, 0.0, math.sin(a), math.cos(a)]))
    assert float(turned.distance(px, py, pz)) == pytest.approx(6.0, abs=1e-5)
    plain = sdf25d.Turned(box).distance(px, py, pz)
    assert float(plain) == pytest.approx(
        math.hypot(10.0 * math.cos(math.radians(30.0)) - 4.0, 2.5),
        abs=1e-5)


def _square_volume():
    """A 64 x 64 frame, zToY 1, one volume on the square (20, 20)-(40, 40)
    from z 0 to 10: its bottom edge (40, 40) -> (20, 40) faces south."""
    g = gbuffer25d.ground(64, 64, 0.0, "cpu")
    square = _f([[20.0, 20.0], [40.0, 20.0], [40.0, 40.0], [20.0, 40.0]])
    return gbuffer25d.height_volumes(
        g, [(square, _f(0.0), _f(10.0))], _f(1.0))


def test_a_top_face_and_a_front_face_pixel_by_hand():
    """Pixel (x 30.5, y 15.5) sees the top face: world y 15.5 + 10 lies in
    the square, z 10 + 0.5, relativeY the same, normal +z. Pixel (30.5,
    35.5) sees the front face of the south edge: z = (40 - 35.5) / 1 = 4.5,
    then + 0.5, normal +y. Pixel (30.5, 50.5) is the ground."""
    g = _square_volume()
    top, front, ground = (15, 30), (35, 30), (50, 30)
    assert float(g["z"][top]) == 10.5 and float(g["relative_y"][top]) == 10.5
    assert g["normal"][top].tolist() == [0.0, 0.0, 1.0]
    assert float(g["z"][front]) == 5.0
    assert float(g["relative_y"][front]) == 5.0
    assert g["normal"][front].tolist() == [0.0, 1.0, 0.0]
    assert float(g["z"][ground]) == 0.0
    assert float(g["relative_y"][ground]) == 0.0
    assert g["normal"][ground].tolist() == [0.0, 0.0, 1.0]


def test_the_square_volume_equals_the_ports_raster():
    from illuminant_tpu_torch.lighting import gbuffer as pgb
    from illuminant_tpu_torch.lighting.environment import EnvironmentUniforms
    from illuminant_tpu_torch.lighting.height_volume import (
        rasterize_height_volumes)
    from illuminant_tpu_torch.sdf.height_volume import (HeightVolume,
                                                        pack_height_volumes)

    env = EnvironmentUniforms.make(z_to_y=1.0, device="cpu")
    port = rasterize_height_volumes(
        pgb.flat_ground(64, 64, env), pack_height_volumes([HeightVolume(
            polygon=[(20.0, 20.0), (40.0, 20.0), (40.0, 40.0), (20.0, 40.0)],
            z_base=0.0, height=10.0)], device="cpu"), env)
    g = _square_volume()
    for key in ("z", "relative_y", "normal", "enable_shadows"):
        assert torch.equal(g[key], getattr(port, key)), key


def test_the_billboards_cylinder_normal_by_hand():
    """A 16 x 16 billboard filling a 16 x 16 frame, every texel opaque,
    cylinder factor 0.5: at pixel column j, u = (j + 0.5) / 16 and the
    normal is (side, sqrt(1 - side^2), 0) with side = (2u - 1) / 2; z rises
    from the bottom edge, (1 - v) 16 at v = (i + 0.5) / 16, relativeY
    16 - (i + 0.5)."""
    g = gbuffer25d.ground(16, 16, 0.0, "cpu")
    tex = torch.ones((4, 4, 4))
    g = gbuffer25d.mask_billboard(g, (0.0, 0.0, 16.0, 16.0), tex, _f(1.0),
                                  0.5)
    for j in (0, 7, 15):
        side = ((j + 0.5) / 16 * 2.0 - 1.0) * 0.5
        assert g["normal"][4, j].tolist() == pytest.approx(
            [side, math.sqrt(1.0 - side * side), 0.0], abs=1e-6)
    for i in (0, 9):
        assert float(g["z"][i, 3]) == pytest.approx(
            (1.0 - (i + 0.5) / 16) * 16.0, abs=1e-5)
        assert float(g["relative_y"][i, 3]) == 16.0 - (i + 0.5)


def test_the_replicators_eight_lanes_by_hand():
    """At 1080p the replicas stand in a row at y 0.93 h, z 10, x = w (0.08 +
    0.84 (i + 0.5) / 8); replicas 0, 3, 6 take radius 4 (the template's
    3 elsewhere), replicas 1 and 5 the blue colour, the odd ones opacity
    0.5; all keep the template's ramp 0.08 h and cast no shadow. The
    port's expansion of the cell's replicator is the same."""
    config = loader.cell(loader.benchmark(), CELL)["config"]
    lanes = ref_mod.expand_replicas(config)
    assert len(lanes) == 8
    w, h = 1920.0, 1080.0
    for i, l in enumerate(lanes):
        assert l["position"] == pytest.approx(
            (w * (0.08 + 0.84 * (i + 0.5) / 8), 0.93 * h, 10.0))
        assert l["radius"] == (4.0 if i % 3 == 0 else 3.0)
        assert l["colour"] == ((0.5, 0.8, 1.0, 0.7) if i in (1, 5)
                               else (1.0, 0.8, 0.5, 0.6))
        assert l["opacity"] == (0.5 if i % 2 else 1.0)
        assert l["ramp_length"] == pytest.approx(0.08 * h)
        assert l["cast_shadows"] is False
    import chip_smoke
    from illuminant_tpu_torch.lighting.environment import (
        LightSourceReplicator)

    smoke, _, _ = chip_smoke.renderer_25d_scene(
        chip_smoke.port_api(), 1920, 1080, device="cpu")
    (rep,) = [l for l in smoke.environment.lights
              if isinstance(l, LightSourceReplicator)]
    assert [(l.position, l.radius, l.ramp_length, tuple(l.color), l.opacity,
             l.cast_shadows) for l in rep.expand()] == [
        (l["position"], l["radius"], l["ramp_length"], l["colour"],
         l["opacity"], l["cast_shadows"]) for l in lanes]


def test_the_subtractive_and_max_composition_by_hand():
    """At one pixel: the additive pass over the ambient (0.52, 0.22, 0.13,
    2), less the subtractive sum (0.3, 0.3, 0, 0.6) = (0.22, -0.08, 0.13,
    1.4); the max light (0.1, 0.05, 0.2, 0.5) lifts green and blue: (0.22,
    0.05, 0.2, 1.4). A float lightmap keeps the negative where no max light
    lifts it."""
    base = _f([[[0.52, 0.22, 0.13, 2.0]]])
    sub = _f([[[0.3, 0.3, 0.0, 0.6]]])
    mx = _f([[[0.1, 0.05, 0.2, 0.5]]])
    got = ref_mod.compose(base, sub, [mx])
    assert got[0, 0].tolist() == pytest.approx([0.22, 0.05, 0.2, 1.4],
                                               abs=1e-6)
    assert float(ref_mod.compose(base, sub, [])[0, 0, 1]) == pytest.approx(
        -0.08, abs=1e-6)


def test_the_frames_blend_passes_at_their_pixels(small_base):
    """In the reference's small frame the subtractive light's centre is
    darker than the additive pass there, and no pixel lies under the max
    light's pass."""
    config = _small_config(small_base)
    ref = ref_mod.Reference(config, "cpu")
    out = ref.frame(dict(frame=11))
    lay = ref.lay
    gbuf = ref.gbuffer()
    floor = ref_mod.directional_light(gbuf, *lay["directional"])
    assert bool((out["lightmap"] >= floor).all())
    sx, sy, _ = lay["subtractive"]["position"]
    at = (int(sy), int(sx))
    sub = ref_mod.sphere_lights(ref.scene(11), gbuf, ref_mod.pack(
        [lay["subtractive"]], "cpu"), shadowed=False, with_ao=False)
    assert float(sub[at][:3].sum()) > 0.05
    assert float(out["lightmap"][at][:3].sum()) < float(
        (out["lightmap"][at] + sub[at])[:3].sum())


# -- the readers -------------------------------------------------------------

def _trace(ranges, ops=True):
    return Trace(frames=2, device_ops=[("k", 0.0, 1.0)] if ops else [],
                 ranges=ranges, host_counts={}, start_us=0.0, end_us=10.0)


@pytest.mark.parametrize("name,span", [
    ("gbuffer_25d_device_ms", "illuminant/renderer/gbuffer"),
    ("scan_readout_device_ms", "illuminant/scan_shadows/readout"),
    ("sphere_ao_device_ms", "illuminant/sphere_lights/ao")])
def test_a_span_reader_reads_its_span(name, span):
    """Two frames: the span's device time summed and halved; nothing off
    the card or without the span; a span nested in it or around it is not
    read."""
    m = loader.module("metrics", name)
    ranges = [(span, 0.0, 3000.0, 1000.0), (span, 5000.0, 6000.0, 3000.0),
              (span + "/inner", 1.0, 2.0, 500.0),
              ("illuminant/renderer/render_lighting", 0.0, 9000.0, 9000.0)]
    assert m.read(_trace(ranges)) == pytest.approx(2.0)
    assert m.read(_trace(ranges, ops=False)) is None
    assert m.read(_trace(ranges[2:])) is None
