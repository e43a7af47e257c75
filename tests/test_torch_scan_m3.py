"""The scan modes the port added last, against the JAX package: the
analytic carried refine (`scan_refine_mode="carried_all"` on an
AnalyticScene, through `analytic.scene_column_images`), shadow scales
other than 0.5 and 1 and visibility resizes other than 1x and 2x
(`utils.image.resize_linear`, the port's copy of jax.image.resize's
linear method). The carried refine is also held to the port's own exact
march on tests/test_refine_quality.py's scenes (ROADMAP F-watch 3: the
JAX path it copies has no test of its own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import scan_shadows as jscan
from illuminant_tpu.lighting.environment import LightObstruction
from illuminant_tpu.sdf import analytic as janalytic
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import scan_shadows as scan
from illuminant_tpu_torch.lighting.cone_trace import cone_trace
from illuminant_tpu_torch.sdf import analytic
from illuminant_tpu_torch.utils.image import resize_linear
from test_refine_quality import SCENES
from test_torch_cone_trace import analytic_pair

torch.set_num_threads(1)

H, W = 96, 144
LIGHTS = np.asarray([[30.0, 48.0, 24.0], [120.0, 20.0, 60.0]], np.float32)
RADII = np.asarray([6.0, 5.0], np.float32)
RAMPS = np.asarray([200.0, 200.0], np.float32)


def _pair(obs):
    return (janalytic.pack_scene(obs, group_capacity_round=1),
            analytic.pack_scene(obs, group_capacity_round=1, device="cpu"))


@pytest.mark.parametrize("nscale", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("kind", ["types", "overlap"])
def test_scene_column_images_match_jax(kind, nscale):
    """Every primitive type's closed-form interval (boxes, cylinders and
    octagons extruded, ellipsoid and spheroid caps), overlapping columns
    merged, empty columns filled from the footprint-nearest primitive;
    the footprint image. Same float32 elementwise formulas: 1e-4 of the
    heights (and of the footprint) absolute."""
    if kind == "types":
        sj, st = analytic_pair("types")
    else:
        obs = [LightObstruction.box((60.0, 40.0, 10.0), (14.0, 10.0, 10.0)),
               LightObstruction.ellipsoid((70.0, 44.0, 30.0),
                                          (16.0, 12.0, 9.0)),
               LightObstruction(type=4, center=(30.0, 60.0, 12.0),
                                size=(12.0, 8.0, 12.0))]
        sj, st = _pair(obs)
    nh, nw = int(H * nscale), int(W * nscale)
    ref = janalytic.scene_column_images(sj, nh, nw, nscale)
    out = analytic.scene_column_images(st, nh, nw, nscale)
    for a, b, name in zip(out, ref, ("h_top", "h_bot", "footprint")):
        assert a.shape == (nh, nw)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=name)
    top, bot, foot = (o.numpy() for o in out)
    assert (foot < 0).any() and (foot > 0).any()
    assert (top >= bot).all()


@pytest.mark.parametrize("kind", ["rotated", "polygons", "many"])
def test_scene_column_images_decline(kind):
    """Rotated groups, polygons and scenes past the unroll limit have no
    column form: None, as in the JAX package (the exact refine runs)."""
    sj, st = analytic_pair(kind)
    assert janalytic.scene_column_images(sj, 24, 32, 0.25) is None
    assert analytic.scene_column_images(st, 24, 32, 0.25) is None


def _scan(scene_t, scene_j, q_kw):
    ref = np.asarray(jscan.scan_visibility_jit(
        scene_j, H, W, jnp.asarray(LIGHTS), jnp.asarray(RADII),
        jnp.asarray(RAMPS), JQuality(**q_kw), pixel_z=jnp.zeros((H, W))))
    out = scan.scan_visibility(
        scene_t, H, W, torch.as_tensor(LIGHTS), torch.as_tensor(RADII),
        torch.as_tensor(RAMPS), QualitySettings(**q_kw),
        pixel_z=torch.zeros((H, W))).numpy()
    return out, ref


@pytest.mark.parametrize("nomination", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_carried_all_matches_jax(name, nomination):
    """The analytic carried refine against the JAX package's: its float16
    walk against the port's float32, mean |d| <= 0.01 for each light (the
    scan's bound in tests/test_torch_scan_analytic.py)."""
    sj, st = _pair(SCENES[name])
    out, ref = _scan(st, sj, dict(scan_refine_mode="carried_all",
                                  scan_nomination_scale=nomination))
    assert out.shape == ref.shape == (2, H, W) and np.isfinite(out).all()
    d = np.abs(out - ref).mean(axis=(1, 2))
    assert (d <= 0.01).all(), d
    assert (ref < 0.5).mean() > 0.005


def _march(scene_t):
    ys, xs = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    shaded = torch.as_tensor(np.stack([xs, ys, np.zeros_like(xs)],
                                      -1).astype(np.float32))
    return np.stack([cone_trace(
        scene_t, torch.as_tensor(LIGHTS[i]), torch.tensor(RADII[i]),
        torch.tensor(RAMPS[i]), shaded, torch.ones((H, W), dtype=torch.bool),
        QualitySettings()).numpy() for i in range(2)])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_carried_all_is_march_bound(name):
    """The carried refine's own bound against the exact march (the bound
    tests/test_refine_quality.py pins for the exact refine): mean |vis -
    march| < 0.12 on each scene, at full and at quarter nomination; and
    within 0.05 of the exact refine's own error."""
    _, st = _pair(SCENES[name])
    march = _march(st)
    for nomination in (1.0, 0.25):
        kw = dict(scan_nomination_scale=nomination, scan_refine_samples=1)
        carried = _scan(st, _pair(SCENES[name])[0],
                        dict(kw, scan_refine_mode="carried_all"))[0]
        exact = scan.scan_visibility(
            st, H, W, torch.as_tensor(LIGHTS), torch.as_tensor(RADII),
            torch.as_tensor(RAMPS), QualitySettings(**kw),
            pixel_z=torch.zeros((H, W))).numpy()
        err = np.abs(carried - march).mean()
        assert err < 0.12, (name, nomination, err)
        assert err <= np.abs(exact - march).mean() + 0.05, (name, err)


@pytest.mark.parametrize("shape,target", [
    ((2, 96, 160), (2, 24, 40)),     # 0.25
    ((2, 96, 144), (2, 32, 48)),     # 1/3
    ((2, 32, 48), (2, 96, 144)),     # 3
    ((3, 31, 45), (3, 93, 135)),     # 3, odd
    ((1, 47, 33), (1, 11, 8)),       # odd, uneven ratios
    ((24, 40, 3), (96, 160, 3)),     # a channel axis kept
])
def test_resize_linear_matches_jax(shape, target):
    """jax.image.resize(x, shape, "linear") and the port's copy: the same
    float32 weights, contracted in another order. Each output sums up to
    a few dozen products of two rounded weights and a value in [-1, 1],
    each side within a few 2^-24 of the exact sum: 4e-6 absolute
    (measured at most 1.9e-6, at the 3x upsamplings)."""
    x = np.random.default_rng(len(shape) + shape[1]).uniform(
        -1, 1, shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), target, "linear"))
    out = resize_linear(torch.as_tensor(x), target).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=4e-6)


def test_resize_visibility_at_three_x_matches_jax():
    """A 3x visibility resize: both packages take the linear resize (the
    JAX package in float32 too outside the 2x case)."""
    vis = np.random.default_rng(9).random((3, 20, 36)).astype(np.float32)
    ref = np.asarray(jscan.resize_visibility(jnp.asarray(vis), (60, 108)))
    out = scan.resize_visibility(torch.as_tensor(vis), (60, 108)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=4e-6)
    # The identity and the 2x path are unchanged.
    assert scan.resize_visibility(torch.as_tensor(vis), (20, 36)).shape \
        == (3, 20, 36)
    np.testing.assert_array_equal(
        scan.resize_visibility(torch.as_tensor(vis), (40, 72)).numpy(),
        scan.upsample2x_bilinear(torch.as_tensor(vis)).numpy())
