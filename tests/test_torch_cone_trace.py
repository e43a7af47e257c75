"""The cone-trace march of the port against the JAX package, on every
field it samples, and K12's argument packing.

The port's `cone_trace` on CPU tensors runs its plain version, the loop
`cone_trace_reference`, which the card's K12 is held to
(tests/test_torch_cone_trace_cuda.py, chip_smoke.py). Here it is held to
JAX `cone_trace` at small sizes: an AnalyticScene of each of the five
primitive types, unrotated, rotated, with extruded polygons and above the
unroll limit; an SdfVolume; a ColumnField, also of a scene of stacked
obstructions with a z-gap (merged intervals); `raw` on and off, disabled
rays, per-light and per-point centers. `launch_plan` (pure) is held to
the broadcast semantics the plain version uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import cone_trace as jct
from illuminant_tpu.lighting.environment import (LightingEnvironment as
                                                 JEnv, LightObstruction)
from illuminant_tpu.sdf import analytic as janalytic
from illuminant_tpu.sdf import columns as jcols
from illuminant_tpu.sdf import height_volume as jhv
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import cone_trace_kernel as ctk
from illuminant_tpu_torch.lighting.cone_trace import (cone_trace,
                                                      cone_trace_reference)
from illuminant_tpu_torch.ops import sdf_primitives as sp
from illuminant_tpu_torch.sdf import analytic, columns
from illuminant_tpu_torch.sdf import height_volume as hv
from illuminant_tpu_torch.sdf import sampling as vol_sampling
from illuminant_tpu_torch.sdf.volume import SdfVolume
from test_torch_columns import sampler_rounding_like_jax

torch.set_num_threads(1)

W, H = 128.0, 96.0
GRID = (24, 32)
TYPES = sorted(sp.PLANAR_EVALUATORS)
POLYGONS = [[(20.0, 70.0), (44.0, 66.0), (40.0, 90.0), (18.0, 86.0)],
            [(90.0, 10.0), (112.0, 14.0), (100.0, 30.0)]]


def _quaternion(rng):
    q = rng.normal(size=4).astype(np.float32)
    return tuple(q / np.linalg.norm(q))


def obstructions(kind: str, seed: int = 0):
    """Host obstructions of a test scene. "types": one of each of the five
    types; "rotated": the same, each rotated; "stacked": two boxes at one
    footprint with a z-gap between them, beside a cylinder; "many": 70
    of all types (above the unroll limit), a third rotated."""
    rng = np.random.default_rng(seed)
    if kind in ("types", "rotated"):
        out = []
        for i, t in enumerate(TYPES):
            center = (16.0 + 24.0 * i, 30.0 + 9.0 * (i % 3), 12.0 + 2.0 * i)
            size = (7.0 + i, 5.0 + 0.5 * i, 10.0 + i)
            rot = _quaternion(rng) if kind == "rotated" else (0.0, 0.0, 0.0,
                                                              1.0)
            out.append(LightObstruction(type=t, center=center, size=size,
                                        rotation=rot))
        return out
    if kind == "stacked":
        return [LightObstruction.box((64.0, 48.0, 8.0), (14.0, 10.0, 6.0)),
                LightObstruction.box((64.0, 48.0, 40.0), (14.0, 10.0, 6.0)),
                LightObstruction.cylinder((30.0, 30.0, 20.0),
                                          (6.0, 6.0, 20.0))]
    out = []
    for i in range(70):
        rot = _quaternion(rng) if i % 3 == 0 else (0.0, 0.0, 0.0, 1.0)
        out.append(LightObstruction(
            type=TYPES[i % len(TYPES)],
            center=tuple(rng.uniform((0, 0, 4), (W, H, 30))),
            size=tuple(rng.uniform((2, 2, 3), (8, 8, 14))), rotation=rot))
    return out


def analytic_pair(kind: str):
    """(JAX scene, port scene) of `obstructions(kind)`; "polygons" is
    "types" with two extruded polygons."""
    obs = obstructions("types" if kind == "polygons" else kind)
    vols = (kind == "polygons")
    j = janalytic.pack_scene(obs, height_volumes=[
        jhv.HeightVolume(polygon=p, z_base=0.0, height=18.0 + 6 * i)
        for i, p in enumerate(POLYGONS)] if vols else None)
    t = analytic.pack_scene(obs, device="cpu", height_volumes=[
        hv.HeightVolume(polygon=p, z_base=0.0, height=18.0 + 6 * i)
        for i, p in enumerate(POLYGONS)] if vols else None)
    return j, t


def volume_pair(kind: str = "types"):
    """(JAX SdfVolume, port SdfVolume) baked from `obstructions(kind)` at
    (16, 48, 64)."""
    env = JEnv()
    env.obstructions += obstructions(kind)
    cfg = jvol.SdfVolumeConfig(virtual_width=int(W), virtual_height=int(H),
                               virtual_depth=64, slice_count=16,
                               resolution_scale=0.5)
    vj = jvol.generate_volume(cfg, env.pack_obstructions())
    return vj, interop.to_torch(SdfVolume, interop.as_numpy_fields(vj))


def field_pair(name: str):
    if name.startswith("analytic_"):
        return analytic_pair(name[len("analytic_"):])
    if name == "volume":
        return volume_pair()
    vj, vt = volume_pair("stacked" if name == "column_stacked" else "types")
    return jax.jit(jcols.build_column_maps)(vj), columns.build_column_maps(vt)


def rays(seed: int, per_point: bool, lights: int = 3):
    """The rays of a test: centers (L, 1, 1, 3) or per point (L, h, w, 3),
    radii and ramps (L, 1, 1), shaded points (1, h, w, 3) on the ground
    lifted 1.6, enable (L, h, w) with about 10% of the rays disabled."""
    rng = np.random.default_rng(seed)
    h, w = GRID
    ys, xs = np.meshgrid((np.arange(h) + 0.5) * H / h,
                         (np.arange(w) + 0.5) * W / w, indexing="ij")
    shaded = np.stack([xs, ys, np.full_like(xs, 1.6)], -1)[None]
    base = rng.uniform((0, 0, 30), (W, H, 50), (lights, 1, 1, 3))
    if per_point:
        center = base + rng.uniform(-20, 20, (lights, h, w, 3))
    else:
        center = base
    radius = rng.uniform(3, 12, (lights, 1, 1))
    ramp = rng.uniform(40, 200, (lights, 1, 1))
    enable = rng.random((lights, h, w)) > 0.1
    f32 = np.float32
    return (center.astype(f32), radius.astype(f32), ramp.astype(f32),
            shaded.astype(f32), enable)


FIELDS = ["analytic_types", "analytic_rotated", "analytic_polygons",
          "analytic_many", "volume", "column", "column_stacked"]


@pytest.fixture(scope="module")
def fields():
    return {}


def _field(fields, name):
    if name not in fields:
        fields[name] = field_pair(name)
    return fields[name]


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("per_point", [False, True])
@pytest.mark.parametrize("name", FIELDS)
def test_march_matches_jax(fields, name, per_point, raw):
    """The port's plain march against JAX `cone_trace` on the same rays.
    A ray whose distance rounds differently in XLA may take another step
    near a threshold: mean |d| <= 1e-4 and 99.9% of the rays within 1e-3
    (tests/test_torch_scan_analytic.py's bound). On a ColumnField the JAX
    sampler's bf16 map rounding is reproduced on the port's side."""
    fj, ft = _field(fields, name)
    c, r, ramp, s, e = rays(2 * FIELDS.index(name) + per_point, per_point)
    ref = np.asarray(jct.cone_trace_jit(
        fj, jnp.asarray(c), jnp.asarray(r), jnp.asarray(ramp),
        jnp.asarray(s), jnp.asarray(e), JQuality(), raw=raw))
    rounding = sampler_rounding_like_jax() if name.startswith("column") \
        else _Null()
    with rounding:
        out = cone_trace(ft, *map(torch.as_tensor, (c, r, ramp, s, e)),
                         QualitySettings(), raw=raw).numpy()
    assert out.shape == ref.shape == (3,) + GRID
    d = np.abs(out - ref)
    assert d.mean() <= 1e-4, d.mean()
    assert (d <= 1e-3).mean() >= 0.999, np.sort(d.ravel())[-5:]
    # Disabled rays are clear; the scene shadows some of the others.
    np.testing.assert_array_equal(out[~e], 1.0)
    assert (out[e] < 0.5).any() and (out[e] > 0.9).any()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _broadcast_args(case: str):
    """Argument sets of the callers' broadcast patterns -> (center,
    radius, ramp, origin, enable) tensors."""
    c, r, ramp, s, e = (torch.as_tensor(a) for a in rays(7, case == "line"))
    if case == "sphere":      # (L, 1, 1, 3) centers, (1, h, w, 3) points
        return c, r[..., 0, 0][:, None, None], ramp, s, e
    if case == "line":        # per-point centers, a scalar radius
        return c, torch.tensor(4.0), ramp, s, e
    if case == "projector":   # one light: (3,) center, (h, w) rays
        return c[0, 0, 0], r[0, 0, 0], ramp[0, 0, 0], s[0], e[0]
    if case == "probes":      # (L, 1, 3) centers, (1, N, 3) points
        return (c[:, 0], r[:, 0], ramp[:, 0], s[:, 0], e[:, 0, :])
    # Strided views and an (h, 1) enable: no (L, P) view, one copy.
    return (c.expand(3, *GRID, 3)[:, ::1], r, ramp.transpose(1, 2),
            torch.cat([s, s], 2)[:, :, ::2], e[:1, :, :1])


CASES = ["sphere", "line", "projector", "probes", "copy"]


@pytest.mark.parametrize("case", CASES)
def test_launch_plan_is_the_broadcast(case):
    """Every (L, P) view of the plan equals its argument broadcast to the
    rays' shape and flattened to lights x points; the plain march on the
    views equals the march on the arguments."""
    args = _broadcast_args(case)
    fj, ft = analytic_pair("types")
    q = QualitySettings()
    plan = ctk.launch_plan(ft, *args, q)
    shape = plan["shape"]
    assert plan["lights"] * plan["points"] == int(np.prod(shape))
    assert plan["lights"] == (shape[0] if len(shape) >= 2 else 1)
    names = dict(zip(ctk.RAY_ARGS, (args[0], args[1], args[2], args[3],
                                    args[4])))
    for name, t in names.items():
        v = plan["views"][name]
        vec = name in ("center", "origin")
        full = t.to(v.dtype).expand(shape + ((3,) if vec else ()))
        ref = full.reshape((plan["lights"], plan["points"])
                           + ((3,) if vec else ()))
        assert torch.equal(v, ref), name
        sl, sp_, sc = plan["strides"][name]
        assert (sl, sp_) == (v.stride(0), v.stride(1))
        assert sc == (v.stride(2) if vec else 0)
    out = cone_trace_reference(
        ft, plan["views"]["center"], plan["views"]["radius"],
        plan["views"]["ramp"], plan["views"]["origin"],
        plan["views"]["enable"], q)
    ref = cone_trace_reference(ft, *args, q)
    assert torch.equal(out.reshape(shape), ref)


def test_launch_plan_shares_broadcast_arguments():
    """The sphere lights' pattern is read in place: broadcast axes have
    stride 0 and nothing is copied."""
    c, r, ramp, s, e = _broadcast_args("sphere")
    plan = ctk.launch_plan(analytic_pair("types")[1], c, r, ramp, s, e,
                           QualitySettings())
    assert plan["strides"]["center"] == (3, 0, 1)
    assert plan["strides"]["origin"] == (0, 3, 1)
    assert plan["strides"]["radius"] == (1, 0, 0)
    assert plan["views"]["center"].data_ptr() == c.data_ptr()
    assert plan["views"]["origin"].data_ptr() == s.data_ptr()


@pytest.mark.parametrize("name", FIELDS)
def test_launch_plan_field_scalars(fields, name):
    """The field's kind and constants as the source reads them."""
    _, ft = _field(fields, name)
    q = QualitySettings(max_step_count=40, min_step_size=0.5,
                        occlusion_to_opacity_power=2.0)
    c, r, ramp, s, e = (torch.as_tensor(a) for a in rays(1, False))
    plan = ctk.launch_plan(ft, c, r, ramp, s, e, q, raw=True)
    assert plan["ints"][:5] == [3, GRID[0] * GRID[1], plan["kind"], 40, 1]
    # The (L, H, W) rays: a block takes a square of a light's points.
    assert plan["ints"][5:7] == list(GRID) and plan["image"] == GRID
    # min_step is max(1, min_step_size), as in the plain version.
    assert plan["floats"][:5] == [1.0, q.long_step_factor, q.max_cone_radius,
                                  q.cone_growth_factor, 2.0]
    kind = plan["kind"]
    assert kind == ctk.FIELD_KINDS[type(ft)]
    if isinstance(ft, analytic.AnalyticScene):
        records = plan["field_tensors"][0]
        batched = sum(ft._counts()) > ft._UNROLL_LIMIT
        n = (sum(int(c_.shape[0]) for c_ in ft.centers) if batched
             else sum(ft._counts()))
        assert plan["ints"][7:9] == [n, int(batched)]
        assert records.shape == (n, ctk.PRIMITIVE_RECORD)
        assert plan["ints"][9] == (0 if ft.polygons is None
                                   else ft.polygons.capacity)
        assert plan["floats"][5] == ft.maximum_distance
        # The records hold each primitive in `distance_p`'s walk order
        # (every slot of a group on the batched path).
        rows = iter(records)
        for gi, t in enumerate(ft.group_types):
            n_g = (ft.centers[gi].shape[0] if batched
                   else ft._counts()[gi])
            for i in range(n_g):
                row = next(rows)
                assert row[0] == t and row[1] == float(ft.group_rotated[gi])
                assert torch.equal(row[2:5], ft.centers[gi][i])
                assert torch.equal(row[5:8], ft.sizes[gi][i])
                assert torch.equal(row[8:12], ft.rotations[gi][i])
    elif kind == 0:
        cfg = ft.config
        assert plan["ints"][7:10] == [cfg.slice_count, cfg.slice_height,
                                      cfg.slice_width]
    else:
        assert plan["floats"][5:] == [float(v) for v in
                                      columns.query_geometry(ft)]


def test_cuda_wrapper_refuses_cpu_tensors():
    """On CPU tensors the wrapper raises (only `cone_trace` dispatches to
    the plain version); an unsupported field raises as the plain
    sampler does."""
    _, ft = analytic_pair("types")
    c, r, ramp, s, e = (torch.as_tensor(a) for a in rays(2, False))
    with pytest.raises(ValueError, match="no kernel"):
        ctk.cone_trace_cuda(ft, c, r, ramp, s, e, QualitySettings())
    with pytest.raises(TypeError, match="unsupported field"):
        ctk.launch_plan(object(), c, r, ramp, s, e, QualitySettings())


def test_plain_march_reports_steps():
    """`with_steps` gives each ray's steps left: the budget less the steps
    taken; disabled rays keep the whole budget."""
    _, ft = analytic_pair("types")
    c, r, ramp, s, e = (torch.as_tensor(a) for a in rays(3, False))
    q = QualitySettings()
    vis, steps = cone_trace_reference(ft, c, r, ramp, s, e, q,
                                      with_steps=True)
    assert torch.equal(vis, cone_trace_reference(ft, c, r, ramp, s, e, q))
    assert steps.shape == vis.shape
    assert (steps[~e] == q.max_step_count).all()
    assert (steps[e] < q.max_step_count).all() and (steps >= 0).all()


@pytest.mark.parametrize("case", CASES + ["odd", "flat"])
def test_ray_blocks_take_every_ray_once(case):
    """The kernel's thread-to-ray map (`ray_blocks`) on every broadcast
    pattern, on an odd image whose 16 x 16 ray tiles are partial and on
    the same rays flattened to (L, H x W): every ray is taken by exactly
    one thread, a tiled block holds one light's points, and only (L, H, W)
    rays tile."""
    if case == "flat":
        c, r, ramp, s, e = (torch.as_tensor(a) for a in rays(4, True, 2))
        args = (c.flatten(1, 2), r.flatten(1), ramp.flatten(1),
                s.flatten(1, 2), e.flatten(1))
    elif case == "odd":
        c, r, ramp, s, e = (torch.as_tensor(a) for a in rays(4, False, 2))
        args = (c, r, ramp, s[:, :23, :37], e[:, :23, :37])
    else:
        args = _broadcast_args(case)
    plan = ctk.launch_plan(analytic_pair("types")[1], *args,
                           QualitySettings())
    shape = plan["shape"]
    tiled_ = len(shape) == 3
    assert plan["image"] == (tuple(shape[1:]) if tiled_ else (0, 0))
    blocks = ctk.ray_blocks(plan)
    assert blocks.shape[1] == ctk.THREADS
    taken = blocks[blocks >= 0]
    n = plan["lights"] * plan["points"]
    assert torch.equal(torch.sort(taken).values, torch.arange(n))
    if tiled_:
        light = torch.where(blocks >= 0, blocks // plan["points"], -1)
        assert bool(((light == light.amax(1, keepdim=True))
                     | (light < 0)).all())


def test_volume_pack_holds_the_taps_sample_reads():
    """The volume pack's plain version (`pack_volume_reference`) holds, at
    each sample's clipped floor texel, exactly the four taps
    `sdf/sampling.py:sample` reads from each of its two slices: points
    inside, on and past every face and edge of the box."""
    _, vol = volume_pair("types")
    c = vol.config
    data = vol.data
    pack = ctk.pack_volume_reference(data)
    assert pack.shape == data.shape + (4,)
    rng = np.random.default_rng(12)
    ex, ey, ez = float(c.virtual_width), float(c.virtual_height), \
        float(c.virtual_depth)
    pts = rng.uniform((-8, -8, -8), (ex + 8, ey + 8, ez + 8), (4000, 3))
    edges = np.array([[0, 0, 0], [ex, ey, ez], [ex, 0, 0], [0, ey, ez],
                      [ex - 1e-4, ey - 1e-4, 0.5], [ex + 3, -3, ez + 3]])
    p = torch.as_tensor(np.concatenate([pts, edges]).astype(np.float32))
    cx = torch.clamp(p[:, 0], 0.0, ex)
    cy = torch.clamp(p[:, 1], 0.0, ey)
    cz = torch.clamp(p[:, 2] - c.z_offset, 0.0, ez)
    s0 = torch.clamp(torch.floor(torch.minimum(cz, vol.max_valid_z)
                                 * (c.slice_count / ez)).long(), 0,
                     c.slice_count - 1)
    x0 = torch.clamp(torch.floor(cx * c.scale_x - 0.5).long(), 0,
                     c.slice_width - 1)
    y0 = torch.clamp(torch.floor(cy * c.scale_y - 0.5).long(), 0,
                     c.slice_height - 1)
    x1 = torch.clamp(x0 + 1, 0, c.slice_width - 1)
    y1 = torch.clamp(y0 + 1, 0, c.slice_height - 1)
    assert bool((x1 == x0).any() and (y1 == y0).any())  # edges reached
    slabs = []
    for s in (s0, torch.clamp(s0 + 1, 0, c.slice_count - 1)):
        want = torch.stack([data[s, y0, x0], data[s, y0, x1],
                            data[s, y1, x0], data[s, y1, x1]], dim=-1)
        q = pack[s, y0, x0]
        assert torch.equal(q, want)
        slabs.append(q)
    # The sample rebuilt from the packed taps is `sample`'s, bit for bit.
    tx, ty = cx * c.scale_x - 0.5, cy * c.scale_y - 0.5
    wx, wy = tx - torch.floor(tx), ty - torch.floor(ty)
    sp = torch.minimum(cz, vol.max_valid_z) * (c.slice_count / ez)
    sw = sp - torch.floor(sp)
    a, b = ((q[:, 0] + (q[:, 1] - q[:, 0]) * wx,
             q[:, 2] + (q[:, 3] - q[:, 2]) * wx) for q in slabs)
    a, b = (t + (u - t) * wy for t, u in (a, b))
    d = torch.stack([-torch.clamp(p[:, 0], max=0.0)
                     + torch.clamp(p[:, 0] - ex, min=0.0),
                     -torch.clamp(p[:, 1], max=0.0)
                     + torch.clamp(p[:, 1] - ey, min=0.0),
                     -torch.clamp(p[:, 2] - c.z_offset, max=0.0)
                     + torch.clamp(p[:, 2] - c.z_offset - ez, min=0.0)])
    out = a + (b - a) * sw + torch.sqrt(d[0] * d[0] + d[1] * d[1]
                                        + d[2] * d[2])
    assert torch.equal(out, vol_sampling.sample(vol, p))
