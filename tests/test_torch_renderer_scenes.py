"""Whole scenes through both packages' LightingRenderer: small versions of
the two frames `chip_smoke.py` drives at 1080p (built by its own scene
functions from either package's classes) and of demo.py's single_light_box,
dynamic_obstructions and blend_modes. The G-buffer, the budgeted voxel
field, the lightmap and the resolved uint8 image are compared."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from illuminant_tpu.core import config as jconfig
from illuminant_tpu.lighting import billboard as jbb
from illuminant_tpu.lighting import directional as jdir
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import renderer as jrend
from illuminant_tpu.ops import sdf_primitives as jprim
from illuminant_tpu.raster import resolve as jres
from illuminant_tpu.sdf import height_volume as jhv
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.raster import resolve as tres

torch.set_num_threads(1)

H, W = 64, 96


def jax_api():
    """The JAX package's classes under the names `chip_smoke.port_api`
    gives the port's."""
    return SimpleNamespace(
        HDRConfig=jconfig.HDRConfig, RendererConfig=jconfig.RendererConfig,
        LightingEnvironment=jenv.LightingEnvironment,
        LightObstruction=jenv.LightObstruction,
        SphereLightSource=jenv.SphereLightSource,
        ReplicatedLight=jenv.ReplicatedLight,
        LightSourceReplicator=jenv.LightSourceReplicator,
        DirectionalLightSource=jdir.DirectionalLightSource,
        Billboard=jbb.Billboard, HeightVolume=jhv.HeightVolume,
        SdfVolumeConfig=jvol.SdfVolumeConfig,
        LightingRenderer=jrend.LightingRenderer, TYPE_BOX=jprim.TYPE_BOX)


def _both(build, **kw):
    """(JAX renderer, hdr, move), (port renderer, hdr, move) of one scene.
    The JAX renderer pads its groups to 8 lanes, not 64: inactive lanes
    add nothing (tests/test_torch_renderer.py) and the small pad keeps its
    compile short."""
    return (build(jax_api(), light_capacity=8, **kw),
            build(chip_smoke.port_api(), device="cpu", **kw))


def _compare(out, ref, hdr_t, hdr_j, r_t, r_j):
    """Lightmaps and resolved images of one frame.

    The JAX package contracts opacity and colour in bfloat16 and sums the
    opacity in bfloat16 (lighting/sphere.py:366-370, :395); its scan keeps
    float16 carries and upsamples in bfloat16. The port keeps float32 and
    does not round. A bf16 factor moves a term by up to 2^-9 of itself, two
    factors by 2^-8: the lightmap is held to 2^-8 of its largest value plus
    1e-3 on 99.9% of its values (a ray or a scan column within rounding of
    a threshold may fall the other way), and to a mean |d| of 1.5e-3.
    Measured on these scenes: max 2.9e-3, mean <= 6.5e-4 on values up to
    2.4. The uint8 image: mean |d| <= 0.2 LSB and at most 0.1% of its
    values off by more than 2 (measured: 0.074, none over 1)."""
    out, ref = out.numpy(), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    d = np.abs(out - ref)
    tol = 2.0 ** -8 * float(np.abs(ref).max()) + 1e-3
    assert (d <= tol).mean() >= 0.999, ((d <= tol).mean(), d.max(), tol)
    assert d.mean() <= 1.5e-3, d.mean()
    img_t = tres.to_uint8(r_t.resolve(torch.as_tensor(out), hdr_t)).numpy()
    img_j = np.asarray(jres.to_uint8(r_j.resolve(ref, hdr_j)))
    assert img_t.shape == img_j.shape == out.shape
    d8 = np.abs(img_t.astype(np.int32) - img_j.astype(np.int32))
    assert d8.mean() <= 0.2 and (d8 > 2).mean() <= 0.001, (d8.mean(),
                                                           (d8 > 2).mean())
    assert img_t[..., :3].astype(np.float64).var() > 0.0
    return d


def _gbuffers_match(gt, gj):
    for name in ("normal", "relative_y", "z", "enable_shadows",
                 "fullbright"):
        d = np.abs(getattr(gt, name).numpy() - np.asarray(getattr(gj, name)))
        assert (d <= 1e-4).mean() >= 0.999, (name, d.max())


def test_renderer_25d_frame_matches_jax():
    """The `renderer-25d` chip frame at 64 x 96 with 4 ring lights and 3
    replicas: height volumes, a billboard, specular, AO, a ramp texture,
    the replicator and the three blend groups under scan shadows, two
    frames with the moving light and obstruction; the G-buffer of each
    frame, then lightmap and image to the bounds of `_compare`."""
    (rj, hj, mj), (rt, ht, mt) = _both(
        chip_smoke.renderer_25d_scene, width=W, height=H, n_lights=4,
        n_replicas=3)
    for i in range(2):
        mj(i), mt(i)
        rj.update_fields(), rt.update_fields()
        _gbuffers_match(rt.gbuffer, rj.gbuffer)
        lt = rt.render_lighting(shadow_mode="scan")
        lj = rj.render_lighting(shadow_mode="scan")
        _compare(lt, lj, ht, hj, rt, rj)
    gb = rt.gbuffer
    assert float(gb.z.max()) > 5.0 and float(gb.relative_y.max()) > 5.0
    assert float(gb.enable_shadows.min()) == 1.0
    # The gates of the full-width frame hold at this size too.
    chip_smoke.gates_25d(rt, lt.numpy())


def test_renderer_march_frame_matches_jax():
    """The `renderer-voxel-march` chip frame at 64 x 96 with 3 lights
    (voxel field at half resolution): four frames of moving dynamic boxes
    under `update_fields(budget=2)`, the budgeted field compared after each
    update and the marched lightmap after the last; then the gates of the
    full-width frame. The field agrees to 1e-4 (distance rounding),
    lightmap and image to the bounds of `_compare`."""
    (rj, hj, mj), (rt, ht, mt) = _both(
        chip_smoke.renderer_march_scene, width=W, height=H, n_lights=3,
        resolution_scale=0.5)
    rj.update_fields(budget=10 ** 6), rt.update_fields(budget=10 ** 6)
    for i in range(4):
        mj(i), mt(i)
        rj.update_fields(budget=2), rt.update_fields(budget=2)
        assert rt._invalid_dynamic == rj._invalid_dynamic == list(range(6, 16))
        assert rt._invalid_static == rj._invalid_static == []
        assert float(rt.volume.max_valid_z) == float(rj.volume.max_valid_z) \
            == 24.0
        np.testing.assert_allclose(rt.volume.data.numpy(),
                                   np.asarray(rj.volume.data), rtol=0,
                                   atol=1e-4)
    lt = rt.render_lighting()  # the default mode: the march
    lj = rj.render_lighting()
    _compare(lt, lj, ht, hj, rt, rj)
    gates = chip_smoke.gates_march(rt, 2)
    assert gates["calls_to_converge"] == 2


def _single_light_box(api, **kw):
    env = api.LightingEnvironment(ground_z=0.0, maximum_z=128.0,
                                  ambient=(0.03, 0.03, 0.05, 1.0))
    env.lights.append(api.SphereLightSource(
        position=(33.0, 32.0, 40.0), radius=10.0, ramp_length=75.0,
        color=(1.0, 0.85, 0.6, 1.0)))
    env.obstructions.append(
        api.LightObstruction.box((56.0, 32.0, 20.0), (5.0, 12.0, 20.0)))
    sdf = api.SdfVolumeConfig(virtual_width=W, virtual_height=H,
                              virtual_depth=64, slice_count=24,
                              resolution_scale=0.5)
    r = api.LightingRenderer(api.RendererConfig(width=W, height=H), env, sdf,
                             **kw)
    return r, api.HDRConfig(srgb_output=True), None


def test_single_light_box_matches_jax():
    """demo.py's single_light_box (BASELINE config 1) at 64 x 96: one
    light, one box, the whole voxel field in one update, the march, the
    plain sRGB resolve."""
    (rj, hj, _), (rt, ht, _) = _both(_single_light_box)
    rj.update_fields(budget=100), rt.update_fields(budget=100)
    assert rt._invalid_slices == [] and float(rt.volume.max_valid_z) == 64.0
    lt, lj = rt.render_lighting(), rj.render_lighting()
    _compare(lt, lj, ht, hj, rt, rj)
    lum = lt.numpy()[..., :3].sum(-1)
    assert lum[32, 20] > 4.0 * lum[32, 80]  # lit side, shadow side


def _dynamic_obstructions(api, **kw):
    env = api.LightingEnvironment(ground_z=0.0, maximum_z=64.0,
                                  ambient=(0.04, 0.04, 0.05, 1.0))
    env.lights.append(api.SphereLightSource(
        position=(26.0, 32.0, 40.0), radius=10.0, ramp_length=90.0,
        color=(1.0, 0.85, 0.6, 1.0)))
    env.obstructions.append(
        api.LightObstruction.box((48.0, 32.0, 20.0), (5.0, 5.0, 20.0)))
    dyn = api.LightObstruction.box((68.0, 24.0, 16.0), (4.0, 4.0, 16.0),
                                   is_dynamic=True)
    env.obstructions.append(dyn)
    r = api.LightingRenderer(
        api.RendererConfig(width=W, height=H), env,
        sdf_config=api.SdfVolumeConfig(
            virtual_width=W, virtual_height=H, virtual_depth=48,
            slice_count=12, resolution_scale=0.5), **kw)
    hdr = api.HDRConfig(mode=2, exposure=1.2, white_point=3.0)
    return r, hdr, dyn


def test_dynamic_obstructions_match_jax():
    """demo.py's dynamic_obstructions at 64 x 96: the dynamic box moves,
    then budget 1 over 4 frames regenerates its partition (12 slices in 3
    slabs of 3 a frame -> 4 frames); the field after each frame and the
    marched frame after the last."""
    (rj, hj, dj), (rt, ht, dt) = _both(_dynamic_obstructions)
    rj.update_fields(budget=100), rt.update_fields(budget=100)
    dj.center = dt.center = (64.0, 44.0, 16.0)
    for frame in range(4):
        rj.update_fields(budget=1), rt.update_fields(budget=1)
        assert rt._invalid_dynamic == rj._invalid_dynamic
        assert len(rt._invalid_dynamic) == 9 - 3 * frame
        assert rt._invalid_static == []
        np.testing.assert_allclose(rt.volume.data.numpy(),
                                   np.asarray(rj.volume.data), rtol=0,
                                   atol=1e-4)
        assert float(rt.volume.max_valid_z) == float(rj.volume.max_valid_z)
    lt, lj = (rt.render_lighting(shadow_mode="march"),
              rj.render_lighting(shadow_mode="march"))
    _compare(lt, lj, ht, hj, rt, rj)


def _blend_modes(api, **kw):
    env = api.LightingEnvironment(ground_z=0.0, maximum_z=64.0,
                                  ambient=(0.10, 0.10, 0.12, 1.0))
    env.obstructions.append(
        api.LightObstruction.box((48.0, 32.0, 12.0), (4.0, 4.0, 12.0)))
    env.obstructions.append(
        api.LightObstruction.cylinder((28.0, 44.0, 16.0), (3.0, 3.0, 16.0)))
    env.lights.append(api.SphereLightSource(
        position=(32.0, 20.0, 40.0), radius=8.0, ramp_length=60.0,
        color=(1.0, 0.85, 0.6, 0.9)))
    env.lights.append(api.SphereLightSource(
        position=(72.0, 48.0, 30.0), radius=6.0, ramp_length=40.0,
        color=(0.8, 0.9, 1.0, 0.6), cast_shadows=False,
        blend_mode="subtractive"))
    env.lights.append(api.DirectionalLightSource(
        direction=(-0.5, -0.4, -0.75), color=(0.10, 0.13, 0.2, 0.6),
        cast_shadows=False, blend_mode="max"))
    r = api.LightingRenderer(api.RendererConfig(width=W, height=H), env,
                             None, **kw)
    return r, api.HDRConfig(mode=2, exposure=1.1, white_point=2.0), None


@pytest.mark.parametrize("shadow_mode", ["scan", "march", "none"])
def test_blend_modes_match_jax(shadow_mode):
    """demo.py's blend_modes at 64 x 96: an additive lamp, a subtractive
    darkness blob and a max directional floor in one frame, in each shadow
    mode of a renderer without a voxel field (the analytic scene is packed
    inside `render_lighting`)."""
    (rj, hj, _), (rt, ht, _) = _both(_blend_modes)
    lt = rt.render_lighting(shadow_mode=shadow_mode)
    lj = rj.render_lighting(shadow_mode=shadow_mode)
    _compare(lt, lj, ht, hj, rt, rj)
    lum = lt.numpy()[..., :3].sum(-1)
    assert lum[48, 72] < lum[20, 32] - 0.3  # the blob eats light
    assert lt.numpy()[..., :3].min() >= 0.05  # the floor holds


def test_resolve_of_the_renderer_takes_an_albedo():
    """`LightingRenderer.resolve` passes its arguments on."""
    (rj, hj, _), (rt, ht, _) = _both(_blend_modes)
    rng = np.random.default_rng(0)
    lm = rng.uniform(0.0, 2.0, (H, W, 4)).astype(np.float32)
    albedo = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    kw = dict(inverse_scale=2.0, average_luminance=0.3, albedo_is_srgb=True)
    out = rt.resolve(torch.as_tensor(lm), ht, albedo=torch.as_tensor(albedo),
                     **kw)
    ref = rj.resolve(lm, hj, albedo=albedo, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert math.isfinite(float(out.sum()))
