"""The sphere-light options and the LightingRenderer of the port: specular,
ramp textures, the falloff helper and the march against the JAX package on
the same inputs; the renderer's host logic (auto-invalidation, blend
groups, light capacity, functional field updates) on the port, with the
cases of tests/test_auto_invalidate.py and tests/test_blend_modes.py. The
whole scenes against the JAX renderer are in
tests/test_torch_renderer_scenes.py."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import gbuffer as jgbuf
from illuminant_tpu.lighting import sphere as jsphere
from illuminant_tpu.lighting.height_volume import (
    rasterize_height_volumes as jax_rasterize)
from illuminant_tpu.sdf import analytic as jana
from illuminant_tpu.sdf import height_volume as jhv
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.core.config import QualitySettings, RendererConfig
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting import renderer as trend
from illuminant_tpu_torch.lighting import sphere
from illuminant_tpu_torch.lighting.directional import DirectionalLightSource
from illuminant_tpu_torch.lighting.environment import (
    EnvironmentUniforms, LightingEnvironment, LightObstruction,
    SphereLights, SphereLightSource)
from illuminant_tpu_torch.lighting.gbuffer import GBuffer, flat_ground
from illuminant_tpu_torch.lighting.renderer import LightingRenderer
from illuminant_tpu_torch.sdf import sampling
from illuminant_tpu_torch.sdf.analytic import AnalyticScene
from illuminant_tpu_torch.sdf.volume import SdfVolume, SdfVolumeConfig

torch.set_num_threads(1)

H, W = 48, 64


def _carry(cls, obj):
    return interop.to_torch(cls, interop.as_numpy_fields(obj))


def _ramp():
    rng = np.random.default_rng(3)
    return rng.uniform(0.1, 1.0, (3, 8, 3)).astype(np.float32)


def _lights(mod):
    """Four sphere lights with every option: specular colours, an AO
    radius, a ramp texture, the three falloff modes, a shadowless one."""
    S = mod.SphereLightSource
    return [
        S(position=(14.0, 12.0, 14.0), radius=4.0, ramp_length=40.0,
          color=(1.0, 0.6, 0.4, 0.9), specular_color=(0.7, 0.7, 0.5),
          specular_power=9.0),
        S(position=(50.0, 14.0, 10.0), radius=3.0, ramp_length=30.0,
          color=(0.4, 1.0, 0.5, 1.0), ramp_mode=mod.RAMP_EXPONENTIAL,
          ambient_occlusion_radius=5.0, ambient_occlusion_opacity=0.8,
          specular_color=(0.2, 0.3, 0.6), specular_power=3.0),
        S(position=(40.0, 40.0, 12.0), radius=3.0, ramp_length=35.0,
          color=(0.5, 0.6, 1.0, 0.8), ramp_texture=_ramp(), ramp_offset=0.3,
          ramp_rate=0.7, falloff_y_factor=1.5),
        S(position=(10.0, 38.0, 6.0), radius=5.0, ramp_length=10.0,
          color=(1.0, 1.0, 0.6, 0.5), ramp_mode=mod.RAMP_NONE,
          cast_shadows=False, opacity=0.7),
    ]


@pytest.fixture(scope="module")
def scene():
    """A 64 x 48 scene as JAX objects and carried to the port: a G-buffer
    with a height volume's top and front faces, an analytic field with
    that polygon and two primitives, its voxel field, the four lights
    (padded to five lanes)."""
    env = jenv.LightingEnvironment(maximum_z=48.0, z_to_y_multiplier=1.0,
                                   light_occlusion=0.0,
                                   ambient=(0.02, 0.02, 0.03, 1.0))
    env.obstructions += [
        jenv.LightObstruction.box((30.0, 12.0, 8.0), (4.0, 5.0, 8.0)),
        jenv.LightObstruction.cylinder((22.0, 34.0, 6.0), (4.0, 4.0, 6.0))]
    vols = [jhv.HeightVolume(polygon=[(44.0, 24.0), (56.0, 24.0),
                                      (56.0, 34.0), (44.0, 34.0)],
                             height=8.0)]
    env_u = env.uniforms()
    gb = jax_rasterize(jgbuf.flat_ground(H, W, env_u),
                       jhv.pack_height_volumes(vols), env_u)
    field = jana.pack_scene(env.obstructions, height_volumes=vols)
    cfg = jvol.SdfVolumeConfig(virtual_width=W, virtual_height=H,
                               virtual_depth=32, slice_count=8,
                               resolution_scale=0.5)
    volume = jvol.generate_volume(cfg, env.pack_obstructions())
    lights = jenv.pack_sphere_lights(_lights(jenv), capacity=5)
    j = dict(env_u=env_u, gb=gb, field=field, volume=volume, lights=lights)
    t = dict(env_u=_carry(EnvironmentUniforms, env_u),
             gb=_carry(GBuffer, gb), field=_carry(AnalyticScene, field),
             volume=_carry(SdfVolume, volume),
             lights=_carry(SphereLights, lights))
    return j, t


def test_pack_sphere_lights_matches_jax(scene):
    """The packed lanes, ramp textures included, equal the JAX package's
    and what interop carries across; `SphereLights.empty` is the inactive
    pack."""
    j, t = scene
    packed = tenv.pack_sphere_lights(_lights(tenv), capacity=5, device="cpu")
    for f in dataclasses.fields(SphereLights):
        ref = np.asarray(getattr(j["lights"], f.name))
        np.testing.assert_array_equal(getattr(packed, f.name).numpy(), ref,
                                      f.name)
        np.testing.assert_array_equal(getattr(t["lights"], f.name).numpy(),
                                      ref, f.name)
    assert packed.ramp_texture.shape == (5, 3, 8, 3)
    np.testing.assert_array_equal(packed.ramp_offset_rate.numpy()[:, 2],
                                  [0, 0, 1, 0, 0])
    plain = tenv.pack_sphere_lights([SphereLightSource()], device="cpu")
    assert plain.ramp_texture is None and plain.ramp_offset_rate is None
    empty = SphereLights.empty(3, device="cpu")
    ref = jenv.SphereLights.empty(3)
    for f in dataclasses.fields(SphereLights):
        a, b = getattr(empty, f.name), getattr(ref, f.name)
        assert (a is None and b is None) or np.array_equal(a.numpy(),
                                                           np.asarray(b))


def test_replicator_expands_like_jax():
    def expand(mod):
        rep = mod.LightSourceReplicator(template=mod.SphereLightSource(
            radius=2.0, ramp_length=9.0, color=(1.0, 0.5, 0.2, 0.8),
            cast_shadows=False, blend_mode="subtractive"))
        rep.add(mod.ReplicatedLight(position=(1.0, 2.0, 3.0)))
        rep.add(mod.ReplicatedLight(position=(4.0, 5.0, 6.0), radius=7.0,
                                    ramp_length=1.0, opacity=0.25,
                                    color=[0.1, 0.2, 0.3, 0.4],
                                    specular_color=[1.0, 0.0, 1.0],
                                    specular_power=5.0))
        out = rep.expand()
        rep.clear()
        assert rep.expand() == []
        return [dataclasses.asdict(l) for l in out]

    assert expand(tenv) == expand(jenv)
    assert expand(tenv)[1]["blend_mode"] == "subtractive"


@pytest.mark.parametrize("light_occlusion", [0.0, 6.0])
def test_compute_sphere_light_opacity_matches_jax(light_occlusion):
    """The three falloff modes, zero normals and the far-behind occlusion
    on random points: 1e-5 on values in [0, 1] (a sqrt, a pow of 0.85)."""
    rng = np.random.default_rng(0)
    n = 3000
    pos = rng.uniform(-30.0, 30.0, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:50] = 0.0
    centre = np.asarray([2.0, -3.0, 8.0], np.float32)
    props = np.zeros((n, 4), np.float32)
    props[:, 0] = rng.uniform(0.0, 8.0, n)
    props[:, 1] = rng.uniform(0.0, 40.0, n)
    props[:, 2] = rng.integers(0, 3, n)
    ref = np.asarray(jsphere.compute_sphere_light_opacity(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(centre),
        jnp.asarray(props), 1.3, jnp.float32(light_occlusion)))
    out = sphere.compute_sphere_light_opacity(
        torch.as_tensor(pos), torch.as_tensor(nrm), torch.as_tensor(centre),
        torch.as_tensor(props), 1.3, light_occlusion).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert 0.05 < (out > 0).mean() < 0.99


def test_compute_specularity_matches_jax():
    """1e-4 relative on values in [0, 1]: a power up to 20 of a saturated
    dot product amplifies its last ulp twentyfold."""
    rng = np.random.default_rng(1)
    n = 3000
    cam = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    cam[:, 2] = 60.0
    pos = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    centre = np.asarray([1.0, 2.0, 15.0], np.float32)
    power = rng.uniform(0.0, 20.0, n).astype(np.float32)
    ref = np.asarray(jsphere.compute_specularity(
        jnp.asarray(cam), jnp.asarray(pos), jnp.asarray(nrm),
        jnp.asarray(centre), jnp.asarray(power)))
    out = sphere.compute_specularity(
        torch.as_tensor(cam), torch.as_tensor(pos), torch.as_tensor(nrm),
        torch.as_tensor(centre), torch.as_tensor(power)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    assert (out > 0.01).mean() > 0.05


_JAX_ACCUMULATE = jax.jit(jsphere.accumulate_sphere_lights, static_argnames=(
    "quality", "with_specular", "shadow_mode", "with_ao", "with_alpha"))


def _without_ramp(lights):
    return lights.replace(ramp_texture=None, ramp_offset_rate=None)


def _bf16_bound(t):
    """The JAX package contracts opacity and colour * alpha as bfloat16
    (sphere.py:366-370) and sums the opacity in bfloat16 (:395); the port
    sums in float32. Each factor rounds by up to 2^-9 relative, so a term
    moves by at most 2^-8 of itself: the bound is 2^-8 of the sum of the
    lights' |colour * alpha| (opacity <= 1) for rgb, and 2^-8 of the
    number of lights (plus the bf16 sum's own rounding) for the alpha."""
    c = (t["lights"].color[:, :3] * t["lights"].color[:, 3:4]).abs()
    n = int(t["lights"].active.sum())
    return float(c.sum(dim=0).max()) * 2.0 ** -8 + 1e-5, n * 2.0 ** -7


@pytest.mark.parametrize("with_ao", [False, True], ids=["no_ao", "ao"])
@pytest.mark.parametrize("field", ["field", "volume"])
def test_accumulate_specular_matches_jax(scene, field, with_ao):
    """`with_specular=True` without shadows on the 2.5D G-buffer, with and
    without the AO sample (analytic field with a polygon; voxel field):
    within the bf16 bound of the plain term plus 1e-4 for the float32
    specular contraction."""
    j, t = scene
    kw = dict(with_specular=True, shadow_mode="none", with_ao=with_ao)
    lj, lt = _without_ramp(j["lights"]), _without_ramp(t["lights"])
    ref = np.asarray(_JAX_ACCUMULATE(j[field], j["gb"], lj, j["env_u"],
                                     quality=JQuality(), **kw))
    out = sphere.accumulate_sphere_lights(t[field], t["gb"], lt, t["env_u"],
                                          QualitySettings(), **kw).numpy()
    plain = sphere.accumulate_sphere_lights(
        t[field], t["gb"], lt, t["env_u"], QualitySettings(),
        **dict(kw, with_specular=False)).numpy()
    assert out.shape == ref.shape == (H, W, 4)
    rgb_tol, a_tol = _bf16_bound(t)
    d = np.abs(out - ref)
    assert d[..., :3].max() <= rgb_tol + 1e-4, d[..., :3].max()
    assert d[..., 3].max() <= a_tol, d[..., 3].max()
    # The highlight is there, and only in rgb.
    assert (out[..., :3] - plain[..., :3]).max() > 0.05
    np.testing.assert_array_equal(out[..., 3], plain[..., 3])


@pytest.mark.parametrize("with_specular", [False, True])
def test_accumulate_ramp_texture_matches_jax(scene, with_specular):
    """The WithRamp epilogue sums in float32 in both packages: 1e-4 on
    all but the rare pixel whose ramp coordinate lies within rounding of a
    texel edge (atan2, a floor)."""
    j, t = scene
    kw = dict(with_specular=with_specular, shadow_mode="none", with_ao=True)
    ref = np.asarray(_JAX_ACCUMULATE(j["field"], j["gb"], j["lights"],
                                     j["env_u"], quality=JQuality(), **kw))
    out = sphere.accumulate_sphere_lights(
        t["field"], t["gb"], t["lights"], t["env_u"], QualitySettings(),
        **kw).numpy()
    d = np.abs(out[..., :3] - ref[..., :3])
    assert (d <= 1e-4).mean() >= 0.999 and d.max() <= 2e-2, (
        d.max(), (d <= 1e-4).mean())
    assert np.abs(out[..., 3] - ref[..., 3]).max() <= _bf16_bound(t)[1]
    plain = sphere.accumulate_sphere_lights(
        t["field"], t["gb"], _without_ramp(t["lights"]), t["env_u"],
        QualitySettings(), **kw).numpy()
    assert np.abs(out[..., :3] - plain[..., :3]).max() > 0.05


@pytest.mark.parametrize("field", ["field", "volume"])
def test_accumulate_march_matches_jax(scene, field, monkeypatch):
    """`shadow_mode="march"`, the default, through `cone_trace` on the
    analytic field with its polygon and on the voxel field, the lights
    walked two at a time: within the bf16 bound on 99% of the pixels (a
    ray within rounding of a step threshold may take one step more or
    less), mean |d| <= 2e-3."""
    j, t = scene
    monkeypatch.setattr(sphere, "MARCH_CHUNK_RAYS", 2 * H * W)
    kw = dict(with_specular=False, with_ao=True)
    lj, lt = _without_ramp(j["lights"]), _without_ramp(t["lights"])
    assert inspect.signature(sphere.accumulate_sphere_lights).parameters[
        "shadow_mode"].default == "march"
    ref = np.asarray(_JAX_ACCUMULATE(j[field], j["gb"], lj, j["env_u"],
                                     quality=JQuality(), shadow_mode="march",
                                     **kw))
    out = sphere.accumulate_sphere_lights(t[field], t["gb"], lt, t["env_u"],
                                          QualitySettings(), **kw).numpy()
    rgb_tol, a_tol = _bf16_bound(t)
    d = np.abs(out - ref)
    assert (d[..., :3] <= rgb_tol).mean() >= 0.99, (d[..., :3] <= rgb_tol
                                                    ).mean()
    assert (d[..., 3] <= a_tol).mean() >= 0.99
    assert d.mean() <= 2e-3, d.mean()
    # The march shadows: darker than the unshadowed pass somewhere.
    unshadowed = sphere.accumulate_sphere_lights(
        t[field], t["gb"], lt, t["env_u"], QualitySettings(),
        shadow_mode="none", **kw).numpy()
    assert (unshadowed[..., :3].sum(-1) - out[..., :3].sum(-1)).max() > 0.2
    # One chunk of all lights gives the same rays.
    monkeypatch.setattr(sphere, "MARCH_CHUNK_RAYS", 1 << 22)
    whole = sphere.accumulate_sphere_lights(
        t[field], t["gb"], lt, t["env_u"], QualitySettings(), **kw).numpy()
    np.testing.assert_array_equal(whole, out)


def test_unknown_shadow_mode_raises(scene):
    _, t = scene
    with pytest.raises(ValueError, match="shadow_mode"):
        sphere.accumulate_sphere_lights(
            t["field"], t["gb"], t["lights"], t["env_u"], QualitySettings(),
            shadow_mode="trace")


@pytest.mark.parametrize("shadow_mode", ["scan", "march", "none"])
def test_all_inactive_lights_add_nothing(scene, shadow_mode):
    """A blend group without a sphere light runs the sphere pass on one
    inactive lane: the scan's default trace plane (the active-masked mean
    light height) and the march stay finite, and nothing is added."""
    _, t = scene
    lanes = SphereLights.empty(1, device="cpu")
    out = sphere.accumulate_sphere_lights(
        t["field"], t["gb"], lanes, t["env_u"], QualitySettings(),
        shadow_mode=shadow_mode)
    assert out.shape == (H, W, 4)
    np.testing.assert_array_equal(out.numpy(), 0.0)


# --- the renderer's host logic -------------------------------------------


def test_defaults_are_the_jax_packages():
    """`render_lighting` marches by default, `accumulate_sphere_lights`
    adds specular by default and `render_lightmap` does not."""
    from illuminant_tpu.lighting import renderer as jrend

    for name, fn, ref in (
            ("render_lightmap", trend.render_lightmap,
             jrend.render_lightmap.__wrapped__),
            ("render_lighting", LightingRenderer.render_lighting,
             jrend.LightingRenderer.render_lighting),
            ("resolve", LightingRenderer.resolve.__wrapped__,
             jrend.LightingRenderer.resolve),
            ("update_fields", LightingRenderer.update_fields.__wrapped__,
             jrend.LightingRenderer.update_fields),
            ("accumulate_sphere_lights",
             sphere.accumulate_sphere_lights.__wrapped__,
             jsphere.accumulate_sphere_lights.__wrapped__)):
        ours = inspect.signature(fn).parameters
        theirs = inspect.signature(ref).parameters
        assert list(ours) == list(theirs), name
        for k in ours:
            if k != "hdr":  # an HDRConfig of each package
                assert ours[k].default == theirs[k].default, (name, k)
    init = inspect.signature(LightingRenderer.__init__).parameters
    assert list(init)[:6] == list(inspect.signature(
        jrend.LightingRenderer.__init__).parameters)
    assert init["light_capacity"].default == 64


def test_light_obstruction_dirty_flags():
    o = LightObstruction.box((1.0, 2.0, 3.0), (1.0, 1.0, 1.0))
    p = LightObstruction.box((1.0, 2.0, 3.0), (1.0, 1.0, 1.0))
    assert o.serial != p.serial and o == p  # equal values, two identities
    assert o.is_valid is False and o.has_dynamicity_changed is False
    object.__setattr__(o, "is_valid", True)
    o.is_dynamic = False  # no flip
    assert o.has_dynamicity_changed is False and o.is_valid is True
    o.is_dynamic = True
    assert o.has_dynamicity_changed is True and o.is_valid is True
    for name, value in (("center", (2.0, 2.0, 3.0)), ("size", (2.0, 1.0, 1.0)),
                        ("rotation", (0.0, 0.0, 1.0, 0.0)), ("type", 2)):
        object.__setattr__(o, "is_valid", True)
        setattr(o, name, value)
        assert o.is_valid is False, name


def _invalidation_scene():
    env = LightingEnvironment(maximum_z=64.0)
    env.obstructions.append(
        LightObstruction.box((64.0, 64.0, 16.0), (10.0, 10.0, 16.0)))
    env.obstructions.append(
        LightObstruction.box((32.0, 32.0, 8.0), (6.0, 6.0, 8.0),
                             is_dynamic=True))
    r = LightingRenderer(
        RendererConfig(width=128, height=128), env,
        sdf_config=SdfVolumeConfig(
            virtual_width=128, virtual_height=128, virtual_depth=32,
            slice_count=8, resolution_scale=0.5), device="cpu")
    r.update_fields(budget=10 ** 6)
    assert r._invalid_static == [] and r._invalid_dynamic == []
    assert float(r.volume.max_valid_z) == 32.0
    return env, r


def test_moving_dynamic_box_invalidates_only_dynamic_partition():
    env, r = _invalidation_scene()
    env.obstructions[1].center = (40.0, 32.0, 8.0)
    r.auto_invalidate()
    assert r._invalid_static == []
    assert r._invalid_dynamic == list(range(8))
    assert r._invalid_slices == list(range(8))


def test_moving_static_box_invalidates_everything():
    env, r = _invalidation_scene()
    env.obstructions[0].size = (12.0, 10.0, 16.0)
    r.auto_invalidate()
    assert r._invalid_static == list(range(8))
    assert r._invalid_dynamic == list(range(8))


def test_budget_spreads_regeneration_and_field_updates():
    env, r = _invalidation_scene()
    env.obstructions[1].center = (48.0, 32.0, 8.0)
    before = r.volume
    kept = before.data.clone()
    static = r._volume_static
    # Budget 1 = one 3-slice slab a frame; 8 slices -> 3 frames.
    r.update_fields(budget=1)
    assert len(r._invalid_dynamic) == 5 and r._invalid_static == []
    assert float(r.volume.max_valid_z) == 12.0
    r.update_fields(budget=1)
    r.update_fields(budget=1)
    assert r._invalid_dynamic == []
    assert float(r.volume.max_valid_z) == 32.0
    # Field updates are functional: last frame's handle kept its values,
    # the untouched static partition is the same object, and the combined
    # field aliases neither partition.
    np.testing.assert_array_equal(before.data.numpy(), kept.numpy())
    assert r._volume_static is static
    assert r.volume.data.data_ptr() not in (
        r._volume_static.data.data_ptr(), r._volume_dynamic.data.data_ptr())

    def d(p):
        return float(sampling.sample(r.volume, torch.tensor([p]))[0])

    assert d([48.0, 32.0, 8.0]) < 0.0   # inside the moved box
    assert d([16.0, 32.0, 8.0]) > 4.0   # its old place is empty
    assert d([64.0, 64.0, 16.0]) < 0.0  # the static box is still there


def test_adding_dynamic_obstruction_invalidates_dynamic_only():
    env, r = _invalidation_scene()
    env.obstructions.append(LightObstruction.ellipsoid(
        (90.0, 90.0, 8.0), (5.0, 5.0, 8.0), is_dynamic=True))
    r.auto_invalidate()
    assert r._invalid_static == []
    assert r._invalid_dynamic == list(range(8))


def test_dynamicity_flip_invalidates_everything():
    env, r = _invalidation_scene()
    env.obstructions[1].is_dynamic = False
    r.auto_invalidate()
    assert r._invalid_static == list(range(8))


def test_untouched_scene_stays_valid():
    env, r = _invalidation_scene()
    r.auto_invalidate()
    assert r._invalid_static == [] and r._invalid_dynamic == []
    # Without a dynamic obstruction the field is the static partition.
    del env.obstructions[1]
    r.update_fields(budget=10 ** 6)
    assert r.volume is r._volume_static and r._invalid_dynamic == []


def test_replaced_obstruction_invalidates_by_serial():
    """A removed and a re-added obstruction of equal value is a change:
    the snapshot compares serials, not values or addresses."""
    env, r = _invalidation_scene()
    old = env.obstructions[0]
    env.obstructions[0] = LightObstruction.box(old.center, old.size)
    assert env.obstructions[0] == old
    r.auto_invalidate()
    assert r._invalid_static == list(range(8))


def _blend_renderer(lights, ambient=(0.05, 0.05, 0.05, 1.0)):
    env = LightingEnvironment(ground_z=0.0, maximum_z=64.0, ambient=ambient)
    env.obstructions.append(
        LightObstruction.box((40.0, 32.0, 8.0), (6.0, 6.0, 8.0)))
    env.lights.extend(lights)
    return LightingRenderer(RendererConfig(width=96, height=64), env, None,
                            device="cpu")


def _scan(renderer):
    return renderer.render_lighting(shadow_mode="scan").numpy()


BASE = dict(radius=4.0, ramp_length=40.0, cast_shadows=False)
MAX_LIGHT = dict(direction=(-0.4, -0.4, -0.8), color=(0.2, 0.2, 0.25, 0.4),
                 cast_shadows=False)


def test_subtractive_light_darkens():
    add = SphereLightSource(position=(30.0, 32.0, 20.0),
                            color=(1.0, 1.0, 1.0, 0.8), **BASE)
    dark = SphereLightSource(position=(60.0, 32.0, 20.0),
                             color=(1.0, 1.0, 1.0, 0.5),
                             blend_mode="subtractive", **BASE)
    lm_plain = _scan(_blend_renderer([add]))
    lm_dark = _scan(_blend_renderer([add, dark]))
    assert lm_dark[32, 60, :3].sum() < lm_plain[32, 60, :3].sum() - 0.05
    assert np.allclose(lm_dark[32, 2], lm_plain[32, 2], atol=1e-5)
    # Unclamped before the resolve (a float lightmap).
    assert (lm_dark <= lm_plain + 1e-5).all()


def test_max_light_is_a_floor():
    add = SphereLightSource(position=(30.0, 32.0, 20.0),
                            color=(1.0, 1.0, 1.0, 0.3), **BASE)
    mx = DirectionalLightSource(blend_mode="max", **MAX_LIGHT)
    lm_plain = _scan(_blend_renderer([add]))
    lm = _scan(_blend_renderer([add, mx]))
    # The max group's own contribution: the same light added over no
    # ambient.
    dir_full = _scan(_blend_renderer([DirectionalLightSource(**MAX_LIGHT)],
                                     ambient=(0.0, 0.0, 0.0, 0.0)))
    assert np.abs(lm - np.maximum(lm_plain, dir_full)).max() < 1e-4
    assert (lm > lm_plain + 1e-5).any()
    assert np.allclose(lm[32, 2, :3], np.maximum(lm_plain[32, 2, :3],
                                                 dir_full[32, 2, :3]),
                       atol=1e-5)


def test_additive_only_path_unchanged():
    add = SphereLightSource(position=(30.0, 32.0, 20.0),
                            color=(1.0, 0.9, 0.8, 0.6), **BASE)
    lm1 = _scan(_blend_renderer([add]))
    lm2 = _scan(_blend_renderer([add]))
    assert np.array_equal(lm1, lm2)
    assert lm1.shape == (64, 96, 4)
    scaled = _blend_renderer([add]).render_lighting(
        intensity_scale=0.5, shadow_mode="scan").numpy()
    np.testing.assert_array_equal(scaled, lm1 * 0.5)


def test_two_max_lights_compose_as_max_not_sum():
    mx_a = DirectionalLightSource(blend_mode="max", **MAX_LIGHT)
    mx_b = DirectionalLightSource(blend_mode="max", **MAX_LIGHT)
    lm1 = _scan(_blend_renderer([mx_a]))
    lm2 = _scan(_blend_renderer([mx_a, mx_b]))
    assert np.abs(lm2 - lm1).max() < 1e-5


def test_unknown_blend_mode_raises():
    bad = SphereLightSource(position=(30.0, 32.0, 20.0),
                            color=(1.0, 1.0, 1.0, 0.8),
                            blend_mode="Additive", **BASE)
    with pytest.raises(ValueError, match="blend_mode"):
        _blend_renderer([bad]).render_lighting(shadow_mode="scan")


def test_shadowing_max_light_alone_scans_on_an_inactive_lane():
    """A max group of one shadow-casting directional light keeps the
    group's `scan` mode; its sphere pass is one inactive lane."""
    mx = DirectionalLightSource(direction=(-0.4, -0.4, -0.8),
                                color=(0.2, 0.2, 0.25, 0.4),
                                cast_shadows=True, blend_mode="max")
    lm = _scan(_blend_renderer([mx]))
    flat = _scan(_blend_renderer([DirectionalLightSource(
        blend_mode="max", **MAX_LIGHT)]))
    assert np.isfinite(lm).all()
    assert (lm <= flat + 1e-6).all() and (lm < flat - 0.01).any()


@pytest.mark.parametrize("shadow_mode", ["scan", "none"])
def test_live_count_pack_equals_the_64_lane_pack(shadow_mode):
    """The renderer packs a group to its live count; `light_capacity` is
    the JAX package's 64-lane floor. Same image: the inactive lanes add
    exact zeros, and the scan's trace plane masks them out."""
    lights = [SphereLightSource(position=(20.0 + 18 * i, 20.0 + 9 * i, 18.0),
                                radius=4.0, ramp_length=50.0,
                                color=(1.0, 0.8 - 0.2 * i, 0.5, 0.9),
                                specular_color=(0.2, 0.2, 0.2))
              for i in range(3)]
    r = _blend_renderer(lights)
    assert r.light_capacity == 64
    lm = r.render_lighting(shadow_mode=shadow_mode)
    dev = "cpu"
    field = trend.pack_scene(r.environment.obstructions, device=dev)
    padded = trend.render_lightmap(
        field, r.gbuffer, tenv.pack_sphere_lights(lights, capacity=64,
                                                  device=dev),
        r.environment.uniforms(device=dev), r.config,
        shadow_mode=shadow_mode, with_ao=False)
    np.testing.assert_allclose(lm.numpy(), padded.numpy(), rtol=0, atol=1e-6)


def test_live_count_field_equals_the_64_lane_field():
    """The renderer packs a field partition to its live obstructions;
    `obstruction_capacity` is the JAX package's 64-lane pad and the most
    it takes. The field is the padded pack's bit for bit: a TYPE_NONE lane
    never wins the min."""
    from illuminant_tpu_torch.sdf import volume as vol

    env, r = _invalidation_scene()
    assert r.obstruction_capacity == 64
    padded = vol.generate_volume(r.sdf_config, env.pack_obstructions(
        capacity=64, device="cpu"))
    assert torch.equal(r.volume.data, padded.data)
    assert float(r.volume.max_valid_z) == float(padded.max_valid_z)
    small = LightingRenderer(r.config, env, r.sdf_config,
                             obstruction_capacity=1, device="cpu")
    env.obstructions.append(LightObstruction.box((9.0, 9.0, 4.0),
                                                 (2.0, 2.0, 4.0)))
    with pytest.raises(ValueError, match="capacity 1 < 2"):
        small.update_fields()


def test_gbuffer_hooks_and_disabled_gbuffer():
    from illuminant_tpu_torch.sdf.height_volume import HeightVolume

    env = LightingEnvironment(z_to_y_multiplier=1.0)
    env.height_volumes.append(HeightVolume(
        polygon=[(10.0, 10.0), (30.0, 10.0), (30.0, 30.0), (10.0, 30.0)],
        height=6.0))
    seen = []

    def hook(gb, env_u):
        seen.append(float(gb.z.max()))
        return gb.replace(fullbright=torch.ones_like(gb.fullbright))

    r = LightingRenderer(RendererConfig(width=48, height=40,
                                        two_point_five_d=True), env, None,
                         device="cpu")
    r.on_render_gbuffer.append(hook)
    r.update_fields()
    assert seen == [6.5] and float(r.gbuffer.fullbright.min()) == 1.0
    # Height volumes enter the G-buffer only in 2.5D mode.
    flat = LightingRenderer(RendererConfig(width=48, height=40), env, None,
                            device="cpu")
    flat.update_fields()
    assert float(flat.gbuffer.z.max()) == 0.0
    off = LightingRenderer(RendererConfig(width=48, height=40,
                                          enable_gbuffer=False,
                                          two_point_five_d=True), env, None,
                           device="cpu")
    off.update_fields()
    ref = flat_ground(40, 48, env.uniforms(device="cpu"))
    np.testing.assert_array_equal(off.gbuffer.z.numpy(), ref.z.numpy())
