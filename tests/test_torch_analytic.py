"""The analytic field of the port against the JAX package: the planar
primitives and their closed-form normals, the scene distance (unrolled and
batched), the fast and autograd normals, and the interop carry of a JAX
AnalyticScene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.lighting.environment import LightObstruction
from illuminant_tpu.ops import sdf_primitives as jsp
from illuminant_tpu.sdf import analytic as janalytic
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.ops import sdf_primitives as sp
from illuminant_tpu_torch.sdf import analytic
from illuminant_tpu_torch.sdf.analytic import AnalyticScene

torch.set_num_threads(1)

TYPES = sorted(sp.PLANAR_EVALUATORS)


def _unit_quaternion(rng):
    q = rng.normal(size=4).astype(np.float32)
    return q / np.linalg.norm(q)


def _flagship_obstructions(width=160.0, height=96.0):
    """The four occluders of the flagship (scenes.py:200-208): three
    groups of differing lengths (one ellipsoid, two boxes, one
    cylinder)."""
    cx, cy = width * 0.5, height * 0.5
    ring = min(width, height) * 0.38
    return [
        LightObstruction.box((cx, cy, 24.0), (22.0, 22.0, 24.0)),
        LightObstruction.ellipsoid((cx - ring * 0.5, cy, 20.0),
                                   (28.0, 16.0, 20.0), is_dynamic=True),
        LightObstruction.cylinder((cx, cy - ring * 0.5, 26.0),
                                  (12.0, 12.0, 26.0), is_dynamic=True),
        LightObstruction.box((cx + ring * 0.45, cy + ring * 0.3, 16.0),
                             (30.0, 10.0, 16.0)),
    ]


def _many_obstructions(n=70, seed=3):
    """n obstructions of all five types, a third of them rotated: above
    the unroll limit of 64, so the batched path evaluates them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rot = (tuple(_unit_quaternion(rng)) if i % 3 == 0
               else (0.0, 0.0, 0.0, 1.0))
        out.append(LightObstruction(
            type=TYPES[i % len(TYPES)],
            center=tuple(rng.uniform((0, 0, 0), (400, 300, 40))),
            size=tuple(rng.uniform((3, 3, 3), (25, 25, 30))),
            rotation=rot))
    return out


def _carry(scene_j):
    return interop.to_torch(AnalyticScene, interop.as_numpy_fields(scene_j))


def _points(rng, n, lo, hi):
    return [rng.uniform(l, h, n).astype(np.float32) for l, h in zip(lo, hi)]


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _near_discontinuity(fn, x, y, z, h=1e-3):
    """Points where the unit vector fn(x, y, z) turns by more than 0.05
    under a step of h along any axis: a branch or nearest-primitive
    switch lies within h, where float32 rounding may pick either side."""
    n0 = np.stack([v.numpy() for v in fn(x, y, z)], -1)
    bad = np.zeros(n0.shape[:-1], bool)
    for axis in range(3):
        for sgn in (-h, h):
            p = [x, y, z]
            p[axis] = p[axis] + sgn
            n1 = np.stack([v.numpy() for v in fn(*p)], -1)
            bad |= np.abs(n1 - n0).max(-1) > 0.05
    return bad


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("type_id", TYPES)
def test_planar_primitive_and_normal_match_jax(type_id, rotated):
    rng = np.random.default_rng(type_id * 2 + rotated)
    size = rng.uniform(4.0, 20.0, 3).astype(np.float32)
    x, y, z = _points(rng, 4096, -2.5 * size, 2.5 * size)
    q = (_unit_quaternion(rng) if rotated
         else np.asarray([0, 0, 0, 1], np.float32))

    def run(mod, arr):
        px, py, pz = arr(x), arr(y), arr(z)
        qs = [arr(v) for v in q]
        s = [arr(v) for v in size]
        px, py, pz = mod.rotate_by_quaternion_p(px, py, pz, *qs)
        d = mod.PLANAR_EVALUATORS[type_id](px, py, pz, *s)
        n = mod.PLANAR_NORMALS[type_id](px, py, pz, *s)
        return (d, *mod.rotate_by_quaternion_inverse_p(*n, *qs))

    jax_out = [np.asarray(v)
               for v in jax.jit(lambda: run(jsp, jnp.asarray))()]
    port_out = [v.numpy() for v in run(sp, torch.as_tensor)]
    # The same float32 formulas elementwise.
    np.testing.assert_allclose(port_out[0], jax_out[0], rtol=1e-5,
                               atol=1e-4)
    assert (port_out[0] < 0).any() and (port_out[0] > 0).any()

    def port_normal(px, py, pz):
        qs = [torch.as_tensor(v) for v in q]
        s = [torch.as_tensor(v) for v in size]
        lx, ly, lz = sp.rotate_by_quaternion_p(px, py, pz, *qs)
        return sp.rotate_by_quaternion_inverse_p(
            *sp.PLANAR_NORMALS[type_id](lx, ly, lz, *s), *qs)

    away = ~_near_discontinuity(port_normal, *_t(x, y, z))
    assert away.mean() > 0.95
    n_t = np.stack(port_out[1:], -1)[away]
    n_j = np.stack(jax_out[1:], -1)[away]
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-4)


SCENES = {
    # The flagship's pack: the unrolled path (4 primitives).
    "flagship": (lambda: _flagship_obstructions(), (0, 0, -5), (160, 96, 60)),
    # 70 primitives, a third rotated: the batched path.
    "many": (lambda: _many_obstructions(), (-20, -20, -5), (420, 320, 60)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """(name, JAX scene, port scene carried by interop, x, y, z)."""
    make, lo, hi = SCENES[request.param]
    scene_j = janalytic.pack_scene(make(), group_capacity_round=1)
    rng = np.random.default_rng(11)
    return (request.param, scene_j, _carry(scene_j),
            *_points(rng, 8192, lo, hi))


def test_distance_matches_jax(scene):
    name, scene_j, scene_t, x, y, z = scene
    d_j = np.asarray(jax.jit(scene_j.distance_p)(x, y, z))
    d_t = scene_t.distance_p(*_t(x, y, z)).numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-4)
    # The (..., 3) form is the same function.
    pos = np.stack([x, y, z], -1)
    np.testing.assert_allclose(
        analytic.scene_sample(scene_t, torch.as_tensor(pos)).numpy(), d_j,
        rtol=1e-5, atol=1e-4)
    assert (d_t < 0).any()
    if name == "many":
        assert sum(scene_t.group_counts) > AnalyticScene._UNROLL_LIMIT


def _nearest_two_gap(scene_t, x, y, z):
    """Gap between the two smallest per-primitive distances."""
    per_prim = []
    for g, type_id in enumerate(scene_t.group_types):
        for i in range(scene_t.group_counts[g]):
            one = AnalyticScene(
                centers=(scene_t.centers[g][i:i + 1],),
                sizes=(scene_t.sizes[g][i:i + 1],),
                rotations=(scene_t.rotations[g][i:i + 1],),
                group_types=(type_id,),
                group_rotated=(scene_t.group_rotated[g],),
                maximum_distance=1e9, group_counts=(1,))
            per_prim.append(one.distance_p(x, y, z).numpy())
    d = np.sort(np.stack(per_prim), axis=0)
    return d[1] - d[0]


def _normal_atol(name, kind):
    """1e-4 for closed-form and autograd normals. The batched path's fast
    normal is a central difference of step 0.05: the two packages'
    float32 distances differ by an ulp or two (up to 2.3e-5 measured on
    these points: XLA rounds some products and square roots differently),
    and the difference divides that by 2 * 0.05 * |grad d| >= ~0.1, so
    3e-4 there (measured 1.7e-4)."""
    return 3e-4 if (name, kind) == ("many", "fast") else 1e-4


@pytest.mark.parametrize("kind", ["fast", "autograd"])
def test_normal_matches_jax(scene, kind):
    name, scene_j, scene_t, x, y, z = scene
    fn_j = scene_j.normal_fast_p if kind == "fast" else scene_j.normal_p
    fn_t = scene_t.normal_fast_p if kind == "fast" else scene_t.normal_p
    n_j = np.stack([np.asarray(v) for v in jax.jit(fn_j)(x, y, z)], -1)
    with torch.no_grad():  # normal_p runs autograd under no_grad too
        n_t_parts = fn_t(*_t(x, y, z))
    assert not any(v.requires_grad for v in n_t_parts)
    n_t = np.stack([v.numpy() for v in n_t_parts], -1)
    assert np.isfinite(n_t).all()
    # Away from ties: two primitives within 1e-3 of each other (0.2 for
    # the batched path's central differences, step 0.05), and from the
    # primitives' own branch switches.
    gap = 0.2 if name == "many" else 1e-3
    away = (_nearest_two_gap(scene_t, *_t(x, y, z)) > gap) & \
        ~_near_discontinuity(fn_t, *_t(x, y, z))
    assert away.mean() > 0.9, away.mean()
    np.testing.assert_allclose(n_t[away], n_j[away], rtol=0,
                               atol=_normal_atol(name, kind))
    if kind == "fast" and name == "flagship":
        # Farther than maximum_distance (128) from every primitive: no
        # primitive is strictly nearer than the initial best, so (0, 0, 0).
        far = scene_t.normal_fast_p(*_t(np.float32([1e4]), np.float32([0]),
                                        np.float32([0])))
        assert [float(v) for v in far] == [0.0, 0.0, 0.0]


def test_scene_normal_dispatch_matches_jax(scene):
    """scene_normal (the autograd normal at (..., 3) points) and
    scene_normal_p(fast=True) (the closed-form one) on the same points."""
    name, scene_j, scene_t, x, y, z = scene
    pos = np.stack([x, y, z], -1)[:512]
    ref = np.asarray(jax.jit(janalytic.scene_normal)(scene_j, pos))
    out = analytic.scene_normal(scene_t, torch.as_tensor(pos)).numpy()
    gap = _nearest_two_gap(scene_t, *_t(*pos.T))
    away = (gap > 1e-3) & ~_near_discontinuity(
        scene_t.normal_p, *_t(*pos.T))
    np.testing.assert_allclose(out[away], ref[away], rtol=0, atol=1e-4)
    fast = np.stack([v.numpy() for v in analytic.scene_normal_p(
        scene_t, *_t(*pos.T), fast=True)], -1)
    ref_fast = np.stack([np.asarray(v) for v in jax.jit(
        lambda a, b, c: janalytic.scene_normal_p(scene_j, a, b, c,
                                                 fast=True))(*pos.T)], -1)
    away &= gap > (0.2 if name == "many" else 1e-3)
    np.testing.assert_allclose(fast[away], ref_fast[away], rtol=0,
                               atol=_normal_atol(name, "fast"))
    assert analytic.scene_sample_grad_p(scene_t, *_t(*pos.T)) is None


@pytest.mark.parametrize("groups", ["unequal", "equal"])
def test_interop_carries_analytic_scene(groups):
    """A JAX AnalyticScene carried into the port: per-group arrays stay
    per group and the static type ids and counts stay Python ints. Before
    the fix, groups of differing lengths raised in np.asarray and groups
    of one length were stacked into one array."""
    obs = _flagship_obstructions()
    if groups == "equal":  # one primitive per group
        obs = [obs[0], obs[1], obs[2]]
    scene_j = janalytic.pack_scene(obs, group_capacity_round=1)
    fields = interop.as_numpy_fields(scene_j)
    assert isinstance(fields["centers"], tuple)
    assert fields["group_types"] == scene_j.group_types
    scene_t = interop.to_torch(AnalyticScene, fields)
    assert scene_t.group_types == scene_j.group_types
    assert all(type(v) is int for v in scene_t.group_types)
    assert scene_t.group_counts == scene_j.group_counts
    assert scene_t.group_rotated == scene_j.group_rotated
    assert scene_t.maximum_distance == scene_j.maximum_distance
    for name in ("centers", "sizes", "rotations"):
        got, want = getattr(scene_t, name), getattr(scene_j, name)
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The port's own pack of the same obstructions is the same scene.
    from illuminant_tpu_torch.lighting.environment import (
        LightObstruction as PortObstruction)
    own = analytic.pack_scene(
        [PortObstruction(type=o.type, center=o.center, size=o.size,
                         rotation=o.rotation, is_dynamic=o.is_dynamic)
         for o in obs], group_capacity_round=1, device="cpu")
    assert own.group_types == scene_t.group_types
    for a, b in zip(own.centers, scene_t.centers):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_interop_carries_sprite_table():
    """A JAX SpriteTable carried into the port: the factors as float32
    tensors, the static bin counts as Python ints and the size range and
    residual as Python floats; the port draws with the carried table
    what it draws with its own build of the same texture."""
    from illuminant_tpu.raster import sprites as jsprites
    from illuminant_tpu_torch.raster import sprites, tiled

    ys, xs = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 12),
                         indexing="ij")
    tex = np.clip(1.0 - np.sqrt(xs ** 2 + ys ** 2), 0, 1).astype(np.float32)
    kw = dict(frames_x=2, angle_bins=3, size_bins=2, rank=2, size_min=3.0,
              size_max=7.0)
    table_j = jsprites.build_sprite_table(tex, **kw)
    table_t = interop.to_torch(sprites.SpriteTable,
                               interop.as_numpy_fields(table_j))
    for name in ("frames", "angle_bins", "size_bins"):
        assert type(getattr(table_t, name)) is int
        assert getattr(table_t, name) == getattr(table_j, name)
    for name in ("size_min", "size_max", "residual"):
        assert type(getattr(table_t, name)) is float
        assert getattr(table_t, name) == getattr(table_j, name)
    assert table_t.row_factors.dtype == torch.float32
    own = sprites.build_sprite_table(tex, device="cpu", **kw)
    np.testing.assert_array_equal(table_t.col_factors.numpy(),
                                  own.col_factors.numpy())
    cfg = tiled.TiledRasterConfig(height=32, width=48)
    args = (torch.tensor([10.0, 30.0]), torch.tensor([12.0, 20.0]),
            torch.ones(2, 4), torch.tensor([4.0, 6.0]),
            torch.ones(2, dtype=torch.bool))
    frame = torch.tensor([0.0, 1.0])
    np.testing.assert_array_equal(
        sprites.rasterize_sprites(cfg, table_t, *args, frame=frame)[0],
        sprites.rasterize_sprites(cfg, own, *args, frame=frame)[0])
