"""Light probes (lighting/probes.py) in the port against the JAX package.

Mirrors tests/test_probes_and_particle_lights.py (falloff and shadow,
back-facing normals) and tests/test_probe_variants.py (a probe on the
ground equals the lightmap's pixel there) on the same numpy inputs, and
adds the directional family. Tolerances: probes whose value goes through
a cone march (sphere and directional lights with shadows, the line
light's 3-ray march, a projector's march) are held to 1e-3, the bound the
port's family tests give the same float32 march (a ray whose distance
rounds differently near a threshold may take one step more); the
unshadowed volumetric and projector probes to 1e-4, their family tests'
elementwise bound. A probe against the port's own lightmap pixel: 2e-3,
as in the JAX test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import directional as jdir
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import gbuffer as jgbuf
from illuminant_tpu.lighting import line as jline
from illuminant_tpu.lighting import probes as jprobes
from illuminant_tpu.lighting import projector as jproj
from illuminant_tpu.lighting import volumetric as jvolum
from illuminant_tpu.sdf.analytic import pack_scene as jpack_scene
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import directional as tdir
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting import gbuffer as tgbuf
from illuminant_tpu_torch.lighting import line as tline
from illuminant_tpu_torch.lighting import probes as tprobes
from illuminant_tpu_torch.lighting import projector as tproj
from illuminant_tpu_torch.lighting import volumetric as tvolum
from illuminant_tpu_torch.sdf.analytic import pack_scene

CPU = "cpu"
MARCH_TOL = 1e-3
ELEMENTWISE_TOL = 1e-4


def _probes(specs):
    """Both packages' packed probes from (position, normal) pairs."""
    j = jprobes.pack_probes([jprobes.LightProbe(position=p, normal=n)
                             for p, n in specs])
    t = tprobes.pack_probes([tprobes.LightProbe(position=p, normal=n)
                             for p, n in specs], device=CPU)
    return j, t


def _scenes(boxes):
    return (jpack_scene([jenv.LightObstruction.box(*b) for b in boxes]),
            pack_scene([tenv.LightObstruction.box(*b) for b in boxes],
                       device=CPU))


def _evaluate(fields, probes, envs, **lights):
    """(port values, JAX values) of evaluate_probes; lights given as
    name -> (jax packed, port packed)."""
    ref = np.asarray(jprobes.evaluate_probes(
        fields[0], probes[0], envs[0], JQuality(),
        **{k: v[0] for k, v in lights.items()}))
    out = tprobes.evaluate_probes(
        fields[1], probes[1], envs[1], QualitySettings(),
        **{k: v[1] for k, v in lights.items()}).numpy()
    assert out.shape == ref.shape
    return out, ref


def _sphere(**kw):
    return (jenv.pack_sphere_lights([jenv.SphereLightSource(**kw)]),
            tenv.pack_sphere_lights([tenv.SphereLightSource(**kw)],
                                    device=CPU))


def _envs(**kw):
    return (jenv.LightingEnvironment(**kw).uniforms(),
            tenv.LightingEnvironment(**kw).uniforms(device=CPU))


def test_probes_match_falloff_and_shadow():
    fields = _scenes([((128.0, 128.0, 16.0), (10.0, 40.0, 16.0))])
    lights = _sphere(position=(60.0, 128.0, 32.0), radius=8.0,
                     ramp_length=200.0, color=(1.0, 1.0, 1.0, 1.0),
                     ambient_occlusion_radius=6.0,
                     ambient_occlusion_opacity=0.8)
    probes = _probes([((70.0, 128.0, 1.0), None),     # near the light
                      ((200.0, 128.0, 1.0), None),    # behind the box
                      ((60.0, 30.0, 1.0), (0, 0, 1)),  # open, farther
                      ((126.0, 80.0, 1.0), (0, 0, 1))])  # beside the box
    out, ref = _evaluate(fields, probes, _envs(), sphere_lights=lights)
    np.testing.assert_allclose(out, ref, rtol=0, atol=MARCH_TOL)
    assert out[0, 0] > 0.5 and out[1, 0] < 0.05  # lit, shadowed
    assert 0.0 < out[2, 0] < out[0, 0]


def test_probe_normal_masks_backfacing_light():
    lights = _sphere(position=(0.0, 0.0, 10.0), radius=4.0,
                     ramp_length=100.0)
    probes = _probes([((20.0, 0.0, 0.0), (0, 0, 1)),
                      ((20.0, 0.0, 0.0), (0, 0, -1)),
                      ((20.0, 0.0, 0.0), None)])
    out, ref = _evaluate((None, None), probes, _envs(), sphere_lights=lights)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ELEMENTWISE_TOL)
    assert out[0, 0] > 0.3 and out[1, 0] < 0.05 and out[2, 0] >= out[0, 0]


def test_directional_probes_match_jax():
    """A shadow-casting sun and an ambient (direction-less) light: the
    box shadows the probe on its far side."""
    fields = _scenes([((40.0, 32.0, 8.0), (4.0, 10.0, 8.0))])
    srcs = [dict(direction=(1.0, 0.2, -0.6), color=(1.0, 0.9, 0.7, 1.0),
                 shadow_trace_length=128.0),
            dict(direction=None, color=(0.1, 0.1, 0.2, 1.0),
                 cast_shadows=False)]
    lights = (jdir.pack_directional_lights(
        [jdir.DirectionalLightSource(**s) for s in srcs]),
        tdir.pack_directional_lights(
            [tdir.DirectionalLightSource(**s) for s in srcs], device=CPU))
    probes = _probes([((20.0, 32.0, 0.5), (0, 0, 1)),
                      ((50.0, 32.0, 0.5), (0, 0, 1)),
                      ((40.0, 60.0, 0.5), None)])
    out, ref = _evaluate(fields, probes, _envs(ambient=(0.02, 0.02, 0.03,
                                                        1.0)),
                         directional_lights=lights)
    np.testing.assert_allclose(out, ref, rtol=0, atol=MARCH_TOL)
    assert out[1, 0] < out[0, 0] - 0.1  # in the box's shadow


H = W = 64
PIXELS = [(10, 18), (33, 50), (56, 30)]


def _lightmap_case():
    fields = _scenes([((40.0, 32.0, 8.0), (4.0, 10.0, 8.0))])
    envs = _envs(maximum_z=64.0)
    probes = _probes([((x + 0.5, y + 0.5, 0.0), (0, 0, 1))
                      for (y, x) in PIXELS])
    gb = tgbuf.flat_ground(H, W, envs[1])
    return fields, envs, probes, gb


def _against_lightmap(out, lightmap, env):
    for i, (y, x) in enumerate(PIXELS):
        np.testing.assert_allclose(
            out[i], lightmap[y, x] + env.ambient.numpy(), atol=2e-3)


def test_line_light_probe_matches_lightmap():
    fields, envs, probes, gb = _lightmap_case()
    kw = dict(start=(8.0, 8.0, 12.0), end=(56.0, 12.0, 12.0), radius=3.0,
              color_start=(1.0, 0.4, 0.2, 1.0),
              color_end=(0.2, 0.4, 1.0, 1.0))
    lights = (jline.pack_line_lights([jline.LineLightSource(**kw)]),
              tline.pack_line_lights([tline.LineLightSource(**kw)],
                                     device=CPU))
    out, ref = _evaluate(fields, probes, envs, line_lights=lights)
    np.testing.assert_allclose(out, ref, rtol=0, atol=MARCH_TOL)
    assert out.max() > 0.01
    _against_lightmap(out, tline.accumulate_line_lights(
        fields[1], gb, lights[1], envs[1], QualitySettings()).numpy(),
        envs[1])


def test_volumetric_light_probe_matches_lightmap():
    fields, envs, probes, gb = _lightmap_case()
    kw = dict(start_position=(20.0, 30.0, 10.0),
              end_position=(44.0, 34.0, 10.0), start_radius=14.0,
              end_radius=8.0, color=(0.9, 0.8, 0.5, 1.0))
    lights = (jvolum.pack_volumetric_lights(
        [jvolum.VolumetricLightSource(**kw)]),
        tvolum.pack_volumetric_lights([tvolum.VolumetricLightSource(**kw)],
                                      device=CPU))
    out, ref = _evaluate(fields, probes, envs, volumetric_lights=lights)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ELEMENTWISE_TOL)
    assert out[:, :3].max() > 0.001
    _against_lightmap(out, tvolum.accumulate_volumetric_lights(
        fields[1], gb, lights[1], envs[1], QualitySettings()).numpy(),
        envs[1])


@pytest.mark.parametrize("origin", [None, (30.0, 4.0, 34.0)])
def test_projector_light_probe_matches_lightmap(origin):
    """Without an origin (no march) and with one and shadows on."""
    fields, envs, probes, gb = _lightmap_case()
    tex = np.zeros((8, 8, 4), np.float32)
    tex[:, :, 0] = np.linspace(0.2, 1.0, 8)[None, :]
    tex[:, :, 3] = 1.0
    kw = dict(texture=tex, position=(16.0, 16.0, 0.0), scale=(4.0, 4.0))
    if origin is not None:
        kw.update(origin=origin, cast_shadows=True, radius=3.0,
                  ramp_length=60.0)
    lights = (jproj.pack_projector_lights([jproj.ProjectorLightSource(**kw)]),
              tproj.pack_projector_lights([tproj.ProjectorLightSource(**kw)],
                                          device=CPU))
    out, ref = _evaluate(fields, probes, envs, projector_lights=lights)
    np.testing.assert_allclose(
        out, ref, rtol=0, atol=ELEMENTWISE_TOL if origin is None
        else MARCH_TOL)
    _against_lightmap(out, tproj.accumulate_projector_lights(
        fields[1], gb, lights[1], envs[1], QualitySettings()).numpy(),
        envs[1])


def test_inactive_probes_read_zero():
    """Probes packed to a capacity: the padding reads 0 on both sides."""
    lights = _sphere(position=(0.0, 0.0, 10.0), radius=4.0,
                     ramp_length=100.0)
    specs = [jprobes.LightProbe(position=(5.0, 0.0, 0.0))]
    jp = jprobes.pack_probes(specs, capacity=4)
    tp = tprobes.pack_probes([tprobes.LightProbe(position=(5.0, 0.0, 0.0))],
                             capacity=4, device=CPU)
    out, ref = _evaluate((None, None), (jp, tp), _envs(),
                         sphere_lights=lights)
    assert (out[1:] == 0.0).all() and out[0, 0] > 0.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=ELEMENTWISE_TOL)


def test_interop_carries_light_probes():
    """core.interop builds the port's LightProbes from a JAX one: the same
    arrays, float32, on the asked device."""
    jp, tp = _probes([((1.0, 2.0, 3.0), (0, 3, 4)), ((4.0, 5.0, 6.0), None)])
    jp = jp.replace(enable_shadows=jnp.asarray([1.0, 0.0]))
    carried = interop.to_torch(tprobes.LightProbes,
                               interop.as_numpy_fields(jp), device=CPU)
    assert isinstance(carried, tprobes.LightProbes)
    for name in ("position", "normal", "enable_shadows", "active"):
        got = getattr(carried, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jp, name)))
    np.testing.assert_array_equal(carried.normal.numpy(), tp.normal.numpy())
