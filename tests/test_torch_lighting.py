"""Lighting path of the port against the JAX package: the carried scan
visibility and the sphere-light accumulation on a ColumnField, and the
resampling helpers they use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import gbuffer as jgbuf
from illuminant_tpu.lighting import scan_shadows as jscan
from illuminant_tpu.lighting.sphere import (
    accumulate_sphere_lights as jax_accumulate)
from illuminant_tpu.sdf import columns as jcols
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import scan_shadows as scan
from illuminant_tpu_torch.lighting.environment import (EnvironmentUniforms,
                                                       SphereLights)
from illuminant_tpu_torch.lighting.gbuffer import GBuffer
from illuminant_tpu_torch.lighting.sphere import accumulate_sphere_lights
from illuminant_tpu_torch.sdf.columns import ColumnField

torch.set_num_threads(1)

H, W = 64, 96


def _scene():
    """A 96x64 voxel scene with the flagship's three shape types and four
    sphere lights in a ring around it, as JAX objects."""
    env = jenv.LightingEnvironment(ambient=(0.03, 0.03, 0.04, 1.0))
    cx, cy, ring = W * 0.5, H * 0.5, min(W, H) * 0.38
    for i, col in enumerate([(1.0, 0.5, 0.3, 1.0), (0.3, 1.0, 0.5, 1.0),
                             (0.4, 0.5, 1.0, 1.0), (1.0, 0.9, 0.4, 1.0)]):
        a = 2 * np.pi * i / 4 + 0.3
        env.lights.append(jenv.SphereLightSource(
            position=(cx + ring * np.cos(a), cy + ring * np.sin(a), 40.0),
            radius=6.0, ramp_length=W * 0.45, color=col))
    env.obstructions += [
        jenv.LightObstruction.box((cx, cy, 24.0), (8.0, 8.0, 24.0)),
        jenv.LightObstruction.ellipsoid((cx - 20, cy + 4, 20.0),
                                        (10.0, 6.0, 20.0)),
        jenv.LightObstruction.cylinder((cx + 18, cy - 12, 10.0),
                                       (5.0, 5.0, 10.0)),
    ]
    cfg = jvol.SdfVolumeConfig(virtual_width=W, virtual_height=H,
                               virtual_depth=64, slice_count=16,
                               resolution_scale=0.5)
    cf = jcols.build_column_maps(
        jvol.generate_volume(cfg, env.pack_obstructions()))
    lights = jenv.pack_sphere_lights(env.lights, capacity=5)
    env_u = env.uniforms()
    return cf, lights, env_u, jgbuf.flat_ground(H, W, env_u)


QUALITIES = {
    # The library defaults: carried refine, 1 sample, half-resolution
    # shadows, nomination walk at half the shadow grid.
    "default": {},
    # Nomination at the shadow grid (no nominated-field upsample) and all
    # three refine candidates.
    "fine_walk_3_samples": dict(scan_nomination_scale=1.0,
                                scan_refine_samples=3),
}


@pytest.fixture(scope="module")
def scene():
    """(JAX objects, port objects, {quality name: JAX visibility})."""
    cf, lights, env_u, gb = _scene()

    def carry(cls, obj):
        return interop.to_torch(cls, interop.as_numpy_fields(obj))

    # One jit of the whole JAX path (op-by-op dispatch compiles each of
    # its hundreds of ops separately).
    scan_j = jax.jit(jscan.scan_cone_visibility, static_argnames=("quality",))
    vis = {name: scan_j(cf, gb, lights.position, lights.properties[:, 0],
                        lights.properties[:, 1], quality=JQuality(**kw),
                        light_active=lights.active)
           for name, kw in QUALITIES.items()}
    return (cf, lights, env_u, gb), (
        carry(ColumnField, cf), carry(SphereLights, lights),
        carry(EnvironmentUniforms, env_u), carry(GBuffer, gb)), vis


@pytest.mark.parametrize("quality", sorted(QUALITIES))
def test_scan_visibility_matches_jax(scene, quality):
    """scan_cone_visibility: the G-buffer heights lifted and downsampled to
    the half-resolution shadow grid, the carried scan_visibility, and the
    2x upsample back."""
    (_, _, _, _), (cf_t, lights_t, _, gb_t), vis_j = scene
    ref = np.asarray(vis_j[quality], np.float32)
    out = scan.scan_cone_visibility(
        cf_t, gb_t, lights_t.position, lights_t.properties[:, 0],
        lights_t.properties[:, 1], QualitySettings(**QUALITIES[quality]),
        light_active=lights_t.active).numpy()
    assert out.shape == ref.shape == (5, H, W)
    assert np.isfinite(out).all()
    # The JAX walk stores its carries and nominated fields in float16
    # (scan_shadows.py:343-347, 876-890) and upsamples in bf16 (:933);
    # the port keeps float32. A visibility value moves with the rounding
    # of min_d (~2^-11 relative) through a 1/(0.875 * radius) ramp, and
    # the bf16 upsample adds 2^-8: most pixels agree to 1e-2, a rare pixel
    # on a nomination boundary could flip (measured: mean |d| 1.7e-4,
    # max 7.4e-3 at the defaults).
    d = np.abs(out - ref)
    assert d.mean() <= 3e-3, d.mean()
    assert (d <= 1e-2).mean() >= 0.99, (d <= 1e-2).mean()
    # Shadows exist in this scene: the comparison is not of two all-ones.
    assert (ref < 0.5).mean() > 0.02


@pytest.mark.parametrize("with_alpha", [False, True])
def test_accumulate_sphere_lights_matches_jax(scene, with_alpha):
    (cf_j, lights_j, env_j, gb_j), (cf_t, lights_t, env_t, gb_t), vis_j = \
        scene
    kw = dict(with_specular=False, with_ao=False, with_alpha=with_alpha)
    # The JAX scan path computes exactly this visibility and masks it with
    # the same trace_enable (sphere.py:304-316); passing it precomputed
    # spares a second compile of the scan.
    ref = np.asarray(jax.jit(jax_accumulate, static_argnames=(
        "quality", "with_specular", "with_ao", "with_alpha"))(
            cf_j, gb_j, lights_j, env_j, quality=JQuality(),
            scan_visibility_precomputed=vis_j["default"], **kw))
    out = accumulate_sphere_lights(cf_t, gb_t, lights_t, env_t,
                                   QualitySettings(), shadow_mode="scan",
                                   **kw).numpy()
    assert out.shape == ref.shape == (H, W, 3 + with_alpha)
    # bf16 opacity and colour operands in the JAX light sum
    # (sphere.py:367-368): 2^-8 relative per light, four lights of
    # colour <= 1 -> 2e-2 absolute, plus the scan differences above; the
    # accumulated opacity is a bf16 sum too (sphere.py:395). Measured:
    # mean |d| 1.3e-4, max 9.3e-4 on rgb.
    d = np.abs(out - ref)
    assert d.mean() <= 5e-3, d.mean()
    assert (d <= 2e-2).mean() >= 0.99, (d <= 2e-2).mean()
    assert out.max() > 0.1


def test_resampling_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 12, 20)).astype(np.float32)
    np.testing.assert_allclose(
        scan.upsample2x_bilinear(torch.as_tensor(x)).numpy(),
        np.asarray(jax.jit(jscan.upsample2x_bilinear)(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    for axis in (1, 2):
        np.testing.assert_allclose(
            scan.downsample2x_linear(torch.as_tensor(x), axis).numpy(),
            np.asarray(jax.jit(jscan.downsample2x_linear, static_argnums=1)(
                jnp.asarray(x), axis)),
            rtol=1e-6, atol=1e-6)
    # resize_visibility: identity, and the exact 2x upsample. The JAX
    # package upsamples in bf16 (scan_shadows.py:933): operands and each
    # lerp round to 2^-8 relative, 2^-7 of |x| <= 1 in all.
    np.testing.assert_array_equal(
        scan.resize_visibility(torch.as_tensor(x), (12, 20)).numpy(), x)
    np.testing.assert_allclose(
        scan.resize_visibility(torch.as_tensor(x), (24, 40)).numpy(),
        np.asarray(jax.jit(jscan.resize_visibility, static_argnums=1)(
            jnp.asarray(x), (24, 40)), np.float32), rtol=0, atol=2.0 ** -7)
