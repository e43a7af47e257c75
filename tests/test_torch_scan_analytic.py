"""Scan shadows, the cone-trace march and the collision integrate of the
port on an analytic scene, against the JAX package and against each
other. The scene is tests/test_scan_shadows.py's: one 20x80x32 box and one
light 68 units west of its center; the exact refine is also held to JAX on
that box baked into a voxel volume and its column maps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import cone_trace as jct
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import gbuffer as jgbuf
from illuminant_tpu.lighting import scan_shadows as jscan
from illuminant_tpu.lighting.environment import LightObstruction
from illuminant_tpu.lighting.scan_shadows import scan_visibility_jit
from illuminant_tpu.particles.integrate import (
    integrate_with_distance_field as jax_integrate)
from illuminant_tpu.particles.render_data import RenderDataUniforms as JRD
from illuminant_tpu.particles.state import SystemUniforms as JSU
from illuminant_tpu.ops.bezier import (constant_bezier as jconst,
                                       pack_bezier as jpack)
from illuminant_tpu.sdf import columns as jcols
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu.sdf.analytic import pack_scene
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import scan_shadows as scan
from illuminant_tpu_torch.lighting.gbuffer import GBuffer
from illuminant_tpu_torch.lighting.cone_trace import cone_trace
from illuminant_tpu_torch.ops.bezier import constant_bezier, pack_bezier
from illuminant_tpu_torch.particles.integrate import (
    integrate_with_distance_field)
from illuminant_tpu_torch.particles.render_data import RenderDataUniforms
from illuminant_tpu_torch.particles.state import ParticleState, SystemUniforms
from illuminant_tpu_torch.sdf.analytic import AnalyticScene
from illuminant_tpu_torch.sdf import columns_kernel
from illuminant_tpu_torch.sdf.columns import ColumnField
from illuminant_tpu_torch.sdf.volume import SdfVolume
from test_torch_particles import _jstate, _render_data, _state_np

torch.set_num_threads(1)

H = W = 256
LIGHT = np.asarray([[60.0, 128.0, 32.0]], np.float32)
RADIUS, RAMP, TRACE_Z = 8.0, 200.0, 16.0


@pytest.fixture(scope="module")
def scenes():
    scene_j = pack_scene(
        [LightObstruction.box((128.0, 128.0, 16.0), (10.0, 40.0, 16.0))])
    scene_t = interop.to_torch(AnalyticScene,
                               interop.as_numpy_fields(scene_j))
    return scene_j, scene_t


def _port_scan(scene_t, quality):
    return scan.scan_visibility(
        scene_t, H, W, torch.as_tensor(LIGHT), torch.tensor([RADIUS]),
        torch.tensor([RAMP]), quality, trace_z=TRACE_Z)[0].numpy()


def _shaded(z):
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32) + 0.5,
                         np.arange(W, dtype=np.float32) + 0.5,
                         indexing="ij")
    return np.stack([xs, ys, np.full_like(xs, z)], -1)


@pytest.fixture(scope="module")
def marches(scenes):
    """The exact march at the scan's shaded points, both packages."""
    scene_j, scene_t = scenes
    shaded = _shaded(TRACE_Z)
    vis_j = np.asarray(jct.cone_trace_jit(
        scene_j, jnp.asarray(LIGHT[0]), jnp.float32(RADIUS),
        jnp.float32(RAMP), jnp.asarray(shaded), jnp.ones((H, W), bool),
        JQuality()))
    vis_t = cone_trace(scene_t, torch.as_tensor(LIGHT[0]),
                       torch.tensor(RADIUS), torch.tensor(RAMP),
                       torch.as_tensor(shaded),
                       torch.ones((H, W), dtype=torch.bool),
                       QualitySettings()).numpy()
    return vis_j, vis_t


@pytest.mark.parametrize("nomination", [0.5, 0.25])
@pytest.mark.parametrize("samples", [0, 1, 2, 3])
def test_scan_visibility_matches_jax(scenes, samples, nomination):
    """The exact refine (1 to 3 candidates) and the flatland mode (0),
    with one and two halvings of the nomination grid."""
    scene_j, scene_t = scenes
    kw = dict(scan_refine_samples=samples, scan_nomination_scale=nomination)
    ref = _jax_scan(scene_j, JQuality(**kw))
    out = _port_scan(scene_t, QualitySettings(**kw))
    assert out.shape == ref.shape == (H, W) and np.isfinite(out).all()
    # The JAX walk stores its carries and nominated fields in float16
    # (scan_shadows.py:343-347, 876-890); the port keeps float32. Bound:
    # mean |d| <= 0.01 (measured mean at most 1.9e-4 over these eight
    # cases, max 0.10 at a single pixel).
    d = np.abs(out - ref)
    assert d.mean() <= 0.01, d.mean()
    # Not two all-ones images: the box shadows part of the plane.
    assert (ref < 0.05).mean() > 0.01


def _box_fields(center, half_size):
    """One box as an analytic scene, baked into a (16, 128, 128) voxel
    volume, and that volume's column maps: ({kind: JAX object},
    {kind: port copy})."""
    box = LightObstruction.box(center, half_size)
    env = jenv.LightingEnvironment()
    env.obstructions.append(box)
    cfg = jvol.SdfVolumeConfig(virtual_width=W, virtual_height=H,
                               virtual_depth=64, slice_count=16,
                               resolution_scale=0.5)
    vol_j = jax.jit(jvol.generate_volume)(cfg, env.pack_obstructions())
    fields_j = {"analytic": pack_scene([box]), "volume": vol_j,
                "columns": jax.jit(jcols.build_column_maps)(vol_j)}
    classes = {"analytic": AnalyticScene, "volume": SdfVolume,
               "columns": ColumnField}
    return fields_j, {k: interop.to_torch(classes[k],
                                          interop.as_numpy_fields(v))
                      for k, v in fields_j.items()}


@pytest.fixture(scope="module")
def voxel_fields():
    """The box of `scenes`."""
    return _box_fields((128.0, 128.0, 16.0), (10.0, 40.0, 16.0))


@pytest.fixture(scope="module")
def low_box_fields():
    """The same footprint 12 units tall, under the trace plane: rays pass
    over it and come closest at its far edge, the exit candidate."""
    return _box_fields((128.0, 128.0, 6.0), (10.0, 40.0, 6.0))


def _jax_scan(scene_j, quality):
    return np.asarray(scan_visibility_jit(
        scene_j, H, W, jnp.asarray(LIGHT), jnp.asarray([RADIUS]),
        jnp.asarray([RAMP]), quality, trace_z=jnp.float32(TRACE_Z)),
        np.float32)[0]


@pytest.mark.parametrize("samples", [1, 3])
@pytest.mark.parametrize("field", ["columns", "volume"])
def test_exact_refine_on_voxel_fields_matches_jax(voxel_fields, field,
                                                  samples, monkeypatch):
    """The exact refine on a voxel volume, and `scan_refine_mode="exact"`
    on a ColumnField, whose candidates sample its volume and never its
    column maps."""
    fields_j, fields_t = voxel_fields
    kw = dict(scan_refine_samples=samples, scan_refine_mode="exact",
              scan_nomination_scale=0.5)
    ref = _jax_scan(fields_j[field], JQuality(**kw))
    map_samples = []
    real = columns_kernel.sample_maps_reference
    monkeypatch.setattr(columns_kernel, "sample_maps_reference",
                        lambda *a, **k: map_samples.append(1) or real(*a, **k))
    out = _port_scan(fields_t[field], QualitySettings(**kw))
    assert map_samples == []
    assert out.shape == ref.shape == (H, W) and np.isfinite(out).all()
    # Exact trilinear samples of the same float32 volume on both sides;
    # the float16 walk of the JAX package as above. Bound: mean |d| <=
    # 0.01 (measured mean at most 9.9e-5, max 0.10 at a single pixel).
    d = np.abs(out - ref)
    assert d.mean() <= 0.01, d.mean()
    assert (ref < 0.05).mean() > 0.01


@pytest.mark.parametrize("field", ["analytic", "columns", "volume"])
def test_two_sample_refine_matches_jax(low_box_fields, field):
    """Two refine samples, the blocker midpoint and its exit, where the
    exit sample decides the shadow of a low box on every field."""
    fields_j, fields_t = low_box_fields
    kw = dict(scan_refine_samples=2, scan_refine_mode="exact",
              scan_nomination_scale=0.5)
    ref = _jax_scan(fields_j[field], JQuality(**kw))
    out = _port_scan(fields_t[field], QualitySettings(**kw))
    one = _port_scan(fields_t[field],
                     QualitySettings(**dict(kw, scan_refine_samples=1)))
    assert out.shape == ref.shape == (H, W) and np.isfinite(out).all()
    # The exit sample darkens the box's far edge: it moves 2.7e-3 (voxel)
    # to 5.1e-3 (analytic) of pixels by more than 0.05 against one sample.
    assert (np.abs(out - one) > 0.05).mean() >= 1e-3
    # The float16 walk as above: measured mean |d| at most 7.3e-5, no
    # pixel off by more than 0.05, so a wrong or missing exit sample
    # fails the second bound.
    d = np.abs(out - ref)
    assert d.mean() <= 0.01, d.mean()
    assert (d > 0.05).mean() <= 1e-3, (d > 0.05).mean()


def _tilted_gbuffer():
    """A 256x256 G-buffer whose normals tilt in x and y, with a raised,
    rippled surface and a non-zero screen-to-world y offset, so the
    normal lift moves every ray endpoint in x, y and z."""
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32) + 0.5,
                         np.arange(W, dtype=np.float32) + 0.5,
                         indexing="ij")
    n = np.stack([0.8 * np.sin(xs / 17.0), 0.6 * np.cos(ys / 23.0),
                  np.ones_like(xs)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(normal=n.astype(np.float32),
                relative_y=(0.05 * (ys - 128.0)).astype(np.float32),
                z=(2.0 + 1.5 * np.sin(xs / 29.0 + ys / 31.0))
                .astype(np.float32),
                enable_shadows=np.ones((H, W), np.float32),
                fullbright=np.zeros((H, W), np.float32))


# A second light north-east of the box, so that rays cross the surface's
# x and y offsets at an angle.
TILT_LIGHTS = np.asarray([LIGHT[0], (200.0, 40.0, 32.0)], np.float32)


@pytest.mark.parametrize("shadow_scale", [1.0, 0.5])
def test_scan_cone_visibility_tilted_gbuffer_matches_jax(scenes,
                                                         shadow_scale):
    """scan_cone_visibility over a G-buffer with tilted normals and a
    non-zero relative_y: the lift's world xy offset (lift * normal.xy, plus
    relative_y in y), downsampled with the heights at half resolution, is
    the exact refine's ray endpoint."""
    scene_j, scene_t = scenes
    gb = _tilted_gbuffer()
    kw = dict(shadow_scale=shadow_scale, scan_refine_samples=3,
              scan_nomination_scale=0.5)
    radius, ramp = np.full(2, RADIUS, np.float32), np.full(2, RAMP,
                                                           np.float32)
    ref = np.asarray(jax.jit(
        jscan.scan_cone_visibility, static_argnames=("quality",))(
            scene_j, jgbuf.GBuffer(**{k: jnp.asarray(v)
                                      for k, v in gb.items()}),
            jnp.asarray(TILT_LIGHTS), jnp.asarray(radius),
            jnp.asarray(ramp), quality=JQuality(**kw)), np.float32)
    out = scan.scan_cone_visibility(
        scene_t, GBuffer(**{k: torch.as_tensor(v) for k, v in gb.items()}),
        torch.as_tensor(TILT_LIGHTS), torch.as_tensor(radius),
        torch.as_tensor(ramp), QualitySettings(**kw)).numpy()
    assert out.shape == ref.shape == (2, H, W) and np.isfinite(out).all()
    # The float16 walk as above, and at half resolution the JAX bf16
    # upsample (2^-7 of |vis| <= 1). Measured mean |d| 1.5e-4 (full) and
    # 3.4e-4 (half), 3e-5 and 2.3e-5 of pixels off by more than 0.05. A
    # flipped sign of either offset, swapped axes or a dropped relative_y
    # puts 5e-3 to 5e-2 of pixels past 0.05.
    d = np.abs(out - ref)
    assert d.mean() <= 0.01, d.mean()
    assert (d > 0.05).mean() <= 1e-3, (d > 0.05).mean()
    assert ((ref < 0.05).mean(axis=(1, 2)) > 0.1).all()


def test_scan_matches_march(scenes, marches):
    """The port's own scan against its own march, at the bound the JAX
    package pins for its pair (tests/test_scan_shadows.py)."""
    _, scene_t = scenes
    _, march = marches
    vis = _port_scan(scene_t, QualitySettings())
    assert vis[120:136, 160:220].max() < 0.05
    assert march[120:136, 160:220].max() < 0.05
    assert vis[30:60, 30:60].min() > 0.95
    assert march[30:60, 30:60].min() > 0.95
    diff = np.abs(vis - march)
    assert diff.mean() < 0.03, diff.mean()  # measured 0.0041


def test_march_matches_jax(marches):
    """The same float32 march: a ray whose distance rounds differently
    may take a different step near a threshold. Bound: mean |d| <= 1e-4
    and 99.9% of rays within 1e-3 (measured mean 2.4e-8, max 8.9e-6)."""
    vis_j, vis_t = marches
    d = np.abs(vis_t - vis_j)
    assert d.mean() <= 1e-4, d.mean()
    assert (d <= 1e-3).mean() >= 0.999
    assert (vis_j < 0.05).mean() > 0.01


@pytest.mark.parametrize("substeps", [1, 3])
def test_integrate_on_analytic_scene_matches_jax(substeps):
    """Collision against the flagship's obstructions at 160x96: the
    unfused path (a field sample per substep, the closed-form fast normal
    at the collision point)."""
    from test_torch_analytic import _flagship_obstructions

    rng = np.random.default_rng(5)
    d = _state_np(rng, 4096)
    scene_j = pack_scene(_flagship_obstructions(), group_capacity_round=1)
    su_j = JSU.make(dt=1 / 60, friction=0.05, maximum_velocity=600.0,
                    life_decay=0.2, collision_distance=1.0,
                    bounce_velocity_multiplier=0.7)
    rd_j = _render_data(jpack, jconst, JRD, jnp.zeros,
                        velocity_rotation=jnp.zeros(()))
    out_j = jax.jit(jax_integrate, static_argnames=("substeps",))(
        _jstate(d), su_j, rd_j, scene_j, substeps=substeps)

    scene_t = interop.to_torch(AnalyticScene,
                               interop.as_numpy_fields(scene_j))
    su_t = interop.to_torch(SystemUniforms, interop.as_numpy_fields(su_j))
    rd_t = _render_data(pack_bezier, constant_bezier, RenderDataUniforms,
                        torch.zeros)
    out_t = integrate_with_distance_field(
        interop.to_torch(ParticleState, d), su_t, rd_t, scene_t,
        substeps=substeps)

    pos_t, pos_j = out_t.position.numpy(), np.asarray(out_j.position)
    live = pos_j[:, 3] > 0
    np.testing.assert_array_equal(pos_t[:, 3] > 0, live)
    # Many particles start within a collision distance of the shapes, so
    # every outcome is exercised; the exact field and closed-form normals
    # are float32 on both sides: every live particle within 1e-3 world
    # units (measured max 1.5e-5 at 1 and at 3 substeps).
    err = np.abs(pos_t[live, :3] - pos_j[live, :3]).max(axis=1)
    assert err.max() <= 1e-3, err.max()
    np.testing.assert_allclose(out_t.velocity.numpy(),
                               np.asarray(out_j.velocity), rtol=1e-4,
                               atol=1e-3)
    # Collisions happened: some particles bounced or were redirected.
    assert (np.asarray(out_j.velocity)[live, 3] == 3.0).sum() > 10


@pytest.mark.parametrize("kwargs", [
    dict(quality=QualitySettings(scan_refine_mode="carried_all")),
])
def test_unported_scan_options_raise(scenes, kwargs):
    """The analytic carried refine (scene_column_images) is not ported; it
    raises."""
    _, scene_t = scenes
    kw = {"quality": QualitySettings(), "trace_z": TRACE_Z, **kwargs}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scan.scan_visibility(scene_t, 32, 32, torch.as_tensor(LIGHT),
                             torch.tensor([RADIUS]), torch.tensor([RAMP]),
                             **kw)
