"""The benchmark's march cell (`flagship-march-1080p`: the flagship frame
under the sphere lights' exact cone march) on the CPU at a small size:
the cell agrees with its plain reference and the control does not, a
timed path made wrong is not correct, the reference march's hand cases,
and K12's work count and its readers.

On the CPU the port marches with its plain loop (`lighting/cone_trace.py:
cone_trace_reference`), which takes the reference's operations in the
reference's order, so every compared number reads 0 here; on the card
K12 takes another root (PERF.md, section 6).
"""

from __future__ import annotations

import json
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
from framebench.metrics import _k12_work  # noqa: E402
from framebench.reference import march, sdf  # noqa: E402
from illuminant_tpu_torch.lighting import sphere  # noqa: E402

CELL = "flagship-march-1080p"
CONFIG = "flagship-analytic-march-1080p"
SMALL = dict(height=96, width=160, n_lights=4, capacity=1 << 12,
             spawn_max=128, sdf_resolution_scale=0.5)
SEED = 2 ** 31 + 101
QUALITY = dict(max_cone_radius=24.0, cone_growth_factor=1.0,
               occlusion_to_opacity_power=1.0, **march.STEPS)


@pytest.fixture(scope="module")
def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small_base(tmp_path_factory):
    """A copy of framebench/ with the march configuration cut to SMALL;
    -> the copy's path."""
    base = tmp_path_factory.mktemp("march") / "framebench"
    shutil.copytree(os.path.join(ROOT, "framebench"), base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = base / "configs" / f"{CONFIG}.json"
    config = json.loads(path.read_text())
    config.update(SMALL)
    path.write_text(json.dumps(config))
    return str(base)


def _run(bench_json, base, **kw):
    return bench.run(CELL, SEED, 1.0, False, "cpu", time.perf_counter(),
                     bench=bench_json, base=base, **kw)


@pytest.fixture(scope="module")
def controlled(bench_json, small_base):
    return _run(bench_json, small_base, control=True)


def test_the_cell_is_in_the_benchmark(bench_json):
    spec = loader.cell(bench_json, CELL)
    assert spec["entry"]["chips"] == 1
    assert spec["config"]["shadow_mode"] == "march"
    assert spec["config_entry"]["reduced"] == []
    assert {m["name"] for m in spec["per_layer"]} == {
        "k12_roofline", "sphere_lights_device_ms", "frame_host_ms",
        "host_syncs_per_frame", "launch_host_us", "sphere_lights_host_ms"}
    scan = loader.json_file("configs", "flagship-analytic-1080p")
    assert {k: v for k, v in spec["config"].items()
            if k not in ("source", "deployment", "assumed")} == dict(
        {k: v for k, v in scan.items()
         if k not in ("source", "deployment", "assumed")},
        shadow_mode="march")


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
    """Every number reads 0: on the CPU the port's plain march follows
    the reference's operations in order, and the rest of the frame is the
    scan cell's, which agrees bit for bit."""
    assert controlled["correct"] and controlled["failed"] == 0
    assert controlled["attempted"] > 0
    assert all(c["value"] == 0.0 for c in controlled["checks"].values()), \
        controlled["checks"]


def test_the_control_fails_every_number(controlled):
    failing = {name for name, value in controlled["control"].items()
               if value > controlled["checks"][name]["limit"]}
    assert failing == set(controlled["checks"]), controlled["control"]


def _visibility_one(volume, gbuffer, lights, trace_enable, quality):
    return torch.ones(trace_enable.expand(lights.capacity, *gbuffer.shape)
                      .shape)


def _scan_in_its_place(volume, gbuffer, lights, trace_enable, quality):
    from illuminant_tpu_torch.lighting.scan_shadows import \
        scan_cone_visibility

    vis = scan_cone_visibility(
        volume, gbuffer, lights.position, lights.properties[:, 0],
        lights.properties[:, 1], quality, light_active=lights.active)
    return torch.where(trace_enable, vis, 1.0)


@pytest.mark.parametrize("fault", [_visibility_one, _scan_in_its_place])
def test_a_wrong_visibility_is_not_correct(bench_json, small_base,
                                           monkeypatch, fault):
    monkeypatch.setattr(sphere, "_march_visibility", fault)
    r = _run(bench_json, small_base)
    assert not r["correct"], r["checks"]
    assert r["checks"]["lightmap"]["value"] > \
        r["checks"]["lightmap"]["limit"]


def test_the_reference_rays_are_the_ones_the_port_marches(small_base):
    """The rays `_k12_work` counts (the reference's, from the frame's
    index) equal those the port's frame passes to its march."""
    config = json.loads(open(os.path.join(
        small_base, "configs", f"{CONFIG}.json")).read())
    params = loader.json_file("workloads", CELL)
    cpu = torch.device("cpu")
    cell = loader.module("scenes", CONFIG, small_base).build(
        config, params, SEED, cpu)
    seen = []
    orig = sphere.cone_trace

    def spy(volume, center, radius, ramp, origin, enable, quality, *a):
        seen.append((volume, center, radius, ramp, origin, enable,
                     quality))
        return orig(volume, center, radius, ramp, origin, enable, quality,
                    *a)

    sphere.cone_trace = spy
    try:
        cell.step()
        from torch.profiler import profile

        with profile():
            cell.step()
    finally:
        sphere.cone_trace = orig
    assert cell.traced_frame == 1 and len(seen) == 2
    volume, center, radius, ramp, origin, enable, quality = seen[-1]
    scene, rays = cell.traced_march()
    assert torch.equal(center.reshape(-1, 3), rays["center"])
    assert torch.equal(radius.reshape(-1), rays["radius"])
    assert torch.equal(ramp.reshape(-1), rays["ramp"])
    assert torch.equal(origin[0], rays["origin"])
    assert torch.equal(enable, rays["enable"])
    assert rays["quality"] == {k: getattr(quality, k) for k in QUALITY}
    x, y, z = (rays["origin"][..., k] + 7.0 * k for k in range(3))
    assert torch.equal(scene.distance(x, y, z), volume.distance_p(x, y, z))


# -- the reference march's hand cases ---------------------------------------

def _f(v):
    return torch.tensor(v, dtype=torch.float32)


BOX = sdf.Primitive(sdf.TYPE_BOX, _f([50.0, 50.0, 10.0]),
                    _f([10.0, 10.0, 10.0]))


def _march(scene, origin, center, enable, radius=1.0, ramp=100.0):
    n = len(center)
    return march.march(scene, _f(center), _f([radius] * n),
                       _f([ramp] * n), _f(origin), torch.tensor(enable),
                       QUALITY)


def test_an_empty_field_is_clear():
    vis, steps = _march(sdf.Scene([]), [[10.0, 10.0, 1.6], [90.0, 5.0, 1.6]],
                        [[400.0, 300.0, 40.0]], [[True, True]])
    assert torch.equal(vis, torch.ones(1, 2))
    assert bool((steps < 64.0).all())


def test_a_ray_through_a_box_is_shadowed_early():
    vis, steps = _march(sdf.Scene([BOX]), [[20.0, 50.0, 1.6]],
                        [[80.0, 50.0, 1.6]], [[True]])
    assert float(vis) == 0.0
    assert 0.0 < float(steps) < 63.0


def test_disabled_rays_read_one():
    vis, steps = _march(sdf.Scene([BOX]), [[20.0, 50.0, 1.6],
                                           [50.0, 50.0, 5.0]],
                        [[80.0, 50.0, 1.6]], [[False, False]])
    assert torch.equal(vis, torch.ones(1, 2))
    assert torch.equal(steps, torch.full((1, 2), 64.0))


# -- K12's work and its readers ----------------------------------------------

def test_k12_work_equals_a_hand_count():
    """One light, one box, four points: two inside the box (shadowed on
    their first step), one a unit from the light (past its end on its
    first step), one disabled: 3 steps in all.
    Bytes: the light's centre, radius and ramp (5 floats), 4 origins (12
    floats), 4 enable bytes, the box (7 floats), 4 visibilities.
    Operations a ray, with no step: the trace (3 subtractions, 3 squares,
    2 sums, the floor, the root, 3 divisions, the end's subtraction and
    floor: 15) and the epilogue (the ramp's division and minimum, the
    threshold's subtraction, clamp, division and clamp, the power, the
    select: 8), and 4 on the light (the cone's clamp, the ramp's clamp,
    the division and the growth factor). A step: the steps' decrement
    and select (2), the sample point (3 products, 3 sums), the box (3
    offsets; |p| - s 6, the inner max 2 and clamp 1, the outer clamps 3,
    the length 7, the sum 1) and the running minimum (1), the cone (3),
    the visibility (3), the step (4), the two selects (2), the liveness
    (6) and its update (3): 53, less the 4 of the masking."""
    origin = [[50.0, 50.0, 5.0], [52.0, 49.0, 6.0], [200.0, 200.0, 1.6],
              [10.0, 10.0, 1.6]]
    rays = dict(center=_f([[201.0, 201.0, 2.0]]), radius=_f([0.5]),
                ramp=_f([100.0]), origin=_f(origin),
                enable=torch.tensor([[True, True, True, False]]))
    _, steps = march.march(sdf.Scene([BOX]), quality=QUALITY, **rays)
    assert steps.tolist() == [[63.0, 63.0, 63.0, 64.0]]
    n_bytes, n_ops = _k12_work.march_work(sdf.Scene([BOX]), quality=QUALITY,
                                          **rays)
    assert n_bytes == 4.0 * 5 + 4.0 * 12 + 4 + 4.0 * 7 + 4.0 * 4
    assert n_ops == 4 * (15 + 8) + 4 + 3 * (53 - 4)


class _Cell:
    def __init__(self, traced):
        self._traced = traced

    def traced_march(self):
        return self._traced


def _trace(ranges, cell=None, peaks=None, ops=True):
    return Trace(frames=2, device_ops=[("k", 0.0, 1.0)] if ops else [],
                 ranges=ranges, host_counts={}, start_us=0.0, end_us=10.0,
                 cell=cell, peaks=peaks)


def test_k12_roofline_reads_the_last_traced_span():
    from framebench.lib.peaks import bound_ms

    k12 = loader.module("metrics", "k12_roofline")
    scene = sdf.Scene([BOX])
    rays = dict(center=_f([[80.0, 50.0, 20.0]]), radius=_f([4.0]),
                ramp=_f([300.0]), origin=_f([[x, 20.0, 1.6]
                                             for x in range(0, 100, 10)]),
                enable=torch.ones(1, 10, dtype=torch.bool), quality=QUALITY)
    peaks = dict(bytes_per_s=3.35e12, f32_ops_per_s=67e12)
    cell = _Cell((scene, rays))
    ranges = [(k12.SPAN, 5.0, 6.0, 40.0), (k12.SPAN, 1.0, 2.0, 10.0),
              ("illuminant/sphere_lights", 0.0, 7.0, 60.0)]
    got = k12.read(_trace(ranges, cell, peaks))
    want = 100.0 * bound_ms(peaks, *_k12_work.march_work(scene, **rays)) \
        / 40e-3
    assert got == pytest.approx(want, rel=1e-12)
    # Off the card, without the span or a traced frame: nothing.
    assert k12.read(_trace(ranges, cell, None)) is None
    assert k12.read(_trace(ranges, cell, peaks, ops=False)) is None
    assert k12.read(_trace(ranges[2:], cell, peaks)) is None
    assert k12.read(_trace(ranges, _Cell(None), peaks)) is None
    assert k12.read(_trace(ranges, object(), peaks)) is None


def test_sphere_lights_device_ms_reads_its_span():
    m = loader.module("metrics", "sphere_lights_device_ms")
    ranges = [("illuminant/sphere_lights", 0.0, 7.0, 3000.0),
              ("illuminant/sphere_lights", 8.0, 9.0, 5000.0),
              ("illuminant/kernel/k12_cone_trace", 1.0, 2.0, 900.0)]
    assert m.read(_trace(ranges)) == pytest.approx(4.0)
    assert m.read(_trace(ranges, ops=False)) is None
    assert m.read(_trace(ranges[2:])) is None
