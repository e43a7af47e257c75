"""The extra light families of the port (directional, line, volumetric,
projector and particle lights), their windowed evaluation and the scan
arguments they need, against the JAX package.

The same numpy inputs go through both packages on the CPU: light sources
packed by each side's own `pack_*`, a 48x64 G-buffer (flat, and tilted
with a non-zero relative_y), and the flagship's four obstructions at
64x48 as an analytic scene and as a ColumnField (the JAX-built fields
carried over through `core.interop`). On the ColumnField the port's plain
column sampler rounds as the JAX package's bf16 map sampler does
(test_torch_columns.sampler_rounding_like_jax), so that the comparison
holds the families and not that rounding.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import directional as jdir
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import gbuffer as jgbuf
from illuminant_tpu.lighting import line as jline
from illuminant_tpu.lighting import particle_light as jpl
from illuminant_tpu.lighting import projector as jproj
from illuminant_tpu.lighting import scan_shadows as jscan
from illuminant_tpu.lighting import sphere as jsphere
from illuminant_tpu.lighting import volumetric as jvolum
from illuminant_tpu.lighting import windowed as jwin
from illuminant_tpu.lighting.environment import LightObstruction
from illuminant_tpu.ops import coords as jcoords
from illuminant_tpu.particles.state import ParticleState as JParticleState
from illuminant_tpu.sdf import columns as jcols
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu.sdf.analytic import pack_scene
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import directional as tdir
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting import line as tline
from illuminant_tpu_torch.lighting import particle_light as tplight
from illuminant_tpu_torch.lighting import projector as tproj
from illuminant_tpu_torch.lighting import scan_shadows as tscan
from illuminant_tpu_torch.lighting import sphere as tsphere
from illuminant_tpu_torch.lighting import volumetric as tvolum
from illuminant_tpu_torch.lighting import windowed as twin
from illuminant_tpu_torch.lighting.cone_trace import cone_trace
from illuminant_tpu_torch.lighting.gbuffer import GBuffer
from illuminant_tpu_torch.ops import coords as tcoords
from illuminant_tpu_torch.particles.state import ParticleState
from illuminant_tpu_torch.sdf.analytic import AnalyticScene
from illuminant_tpu_torch.sdf.columns import ColumnField
from test_torch_analytic import _flagship_obstructions
from test_torch_columns import sampler_rounding_like_jax

torch.set_num_threads(1)

H, W = 48, 64
FIELDS = ["analytic", "columns"]
GBUFFERS = ["flat", "tilted"]


# -- inputs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def fields():
    """The flagship's obstructions at 64x48: ({kind: JAX field}, {kind:
    the port's copy})."""
    obs = _flagship_obstructions(float(W), float(H))
    env = jenv.LightingEnvironment()
    env.obstructions += obs
    cfg = jvol.SdfVolumeConfig(virtual_width=W, virtual_height=H,
                               virtual_depth=64, slice_count=16,
                               resolution_scale=0.5)
    vol_j = jax.jit(jvol.generate_volume)(cfg, env.pack_obstructions())
    fj = {"analytic": pack_scene(obs, group_capacity_round=1),
          "columns": jax.jit(jcols.build_column_maps)(vol_j)}
    classes = {"analytic": AnalyticScene, "columns": ColumnField}
    return fj, {k: interop.to_torch(classes[k], interop.as_numpy_fields(v))
                for k, v in fj.items()}


def _gbuffer_np(kind):
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32) + 0.5,
                         np.arange(W, dtype=np.float32) + 0.5, indexing="ij")
    if kind == "flat":
        n = np.zeros((H, W, 3), np.float32)
        n[..., 2] = 1.0
        rel_y, z = np.zeros((H, W), np.float32), np.zeros((H, W), np.float32)
    else:
        n = np.stack([0.6 * np.sin(xs / 7.0), 0.5 * np.cos(ys / 9.0),
                      np.ones_like(xs)], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        rel_y = 0.05 * (ys - 24.0)
        z = 2.0 + 1.5 * np.sin(xs / 11.0 + ys / 13.0)
    return dict(normal=n.astype(np.float32),
                relative_y=rel_y.astype(np.float32), z=z.astype(np.float32),
                enable_shadows=np.ones((H, W), np.float32),
                fullbright=np.zeros((H, W), np.float32))


def _gbuffers(kind):
    gb = _gbuffer_np(kind)
    return (jgbuf.GBuffer(**{k: jnp.asarray(v) for k, v in gb.items()}),
            GBuffer(**{k: torch.as_tensor(v) for k, v in gb.items()}))


def _envs():
    return (jenv.EnvironmentUniforms.make(),
            tenv.EnvironmentUniforms.make(device="cpu"))


def _rounding(field):
    return sampler_rounding_like_jax() if field == "columns" \
        else contextlib.nullcontext()


def _rgba(seed):
    return tuple(np.random.default_rng(seed).uniform(0.2, 1.0, 4).tolist())


# Light sources by family: keyword arguments for each side's source class.
def _ptex(seed, th=12, tw=20):
    return np.random.default_rng(seed).uniform(0, 1, (th, tw, 4)) \
        .astype(np.float32)


SOURCES = {
    "directional": [
        dict(direction=(0.35, 0.55, -0.76), color=_rgba(1), opacity=0.9,
             shadow_trace_length=60.0, shadow_softness=6.0,
             shadow_ramp_rate=0.5, ambient_occlusion_radius=6.0,
             ambient_occlusion_opacity=0.7),
        dict(direction=None, color=_rgba(2), shadow_distance_falloff=40.0),
    ],
    "line": [
        dict(start=(6.0, 8.0, 14.0), end=(58.0, 12.0, 18.0), radius=3.0,
             color_start=_rgba(3), color_end=_rgba(4), opacity=0.8,
             ambient_occlusion_radius=5.0, ambient_occlusion_opacity=0.6),
        dict(start=(10.0, 40.0, 9.0), end=(30.0, 30.0, 9.0), radius=1.5,
             color_start=_rgba(5), cast_shadows=False),
    ],
    "volumetric": [
        dict(shape=tvolum.SHAPE_ELLIPSOID, start_position=(20.0, 30.0, 12.0),
             end_position=(14.0, 9.0, 10.0), volumetricity=0.75,
             distance_attenuation=0.8, ramp_length=6.0, color=_rgba(6),
             cast_shadows=True),
        dict(shape=tvolum.SHAPE_CONE, start_position=(44.0, 10.0, 30.0),
             end_position=(50.0, 30.0, 4.0), start_radius=3.0,
             end_radius=7.0, ramp_length=2.0, ramp_power=1.5,
             blowout_factor=0.3, color=_rgba(7), opacity=0.7),
        dict(shape=tvolum.SHAPE_BOX, start_position=(40.0, 36.0, 8.0),
             end_position=(9.0, 6.0, 7.0), ramp_length=3.0, color=_rgba(8),
             cast_shadows=True),
    ],
    "projector": [
        dict(texture=_ptex(9), position=(8.0, 6.0, 0.0), scale=(30.0, 24.0),
             opacity=0.8, ambient_occlusion_radius=5.0,
             ambient_occlusion_opacity=0.5),
        dict(texture=_ptex(10, 7, 9), position=(30.0, 20.0, 0.0),
             scale=(11.0, 9.0), wrap=True, mip_bias=0.7, color=_rgba(11),
             origin=(36.0, 24.0, 30.0), texture_region=(0.1, 0.0, 0.9, 0.8)),
    ],
}
PACKS = {
    "directional": (jdir.DirectionalLightSource, jdir.pack_directional_lights,
                    tdir.DirectionalLightSource,
                    tdir.pack_directional_lights),
    "line": (jline.LineLightSource, jline.pack_line_lights,
             tline.LineLightSource, tline.pack_line_lights),
    "volumetric": (jvolum.VolumetricLightSource,
                   jvolum.pack_volumetric_lights,
                   tvolum.VolumetricLightSource,
                   tvolum.pack_volumetric_lights),
    "projector": (jproj.ProjectorLightSource, jproj.pack_projector_lights,
                  tproj.ProjectorLightSource, tproj.pack_projector_lights),
}


def _packed(family, pick=slice(None)):
    jsrc, jpack, tsrc, tpack = PACKS[family]
    kws = SOURCES[family][pick]
    return (jpack([jsrc(**kw) for kw in kws]),
            tpack([tsrc(**kw) for kw in kws], device="cpu"))


def _assert_same_fields(port_obj, jax_obj):
    """Every field of the port's dataclass equals the JAX one's, exactly."""
    for f in dataclasses.fields(port_obj):
        a, b = getattr(port_obj, f.name), getattr(jax_obj, f.name)
        if isinstance(a, tuple):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=f.name)
        elif torch.is_tensor(a):
            assert a.dtype == torch.float32, f.name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)
        else:
            assert a == b, f.name


# -- packs and interop ------------------------------------------------------

@pytest.mark.parametrize("family", sorted(PACKS))
def test_pack_matches_jax(family):
    lj, lt = _packed(family)
    assert lt.capacity == lj.capacity == len(SOURCES[family])
    _assert_same_fields(lt, lj)


@pytest.mark.parametrize("family", sorted(PACKS))
def test_pack_pads_to_capacity(family):
    if family == "projector":
        # pack_projector_lights has no capacity; an empty list packs one
        # inactive light on both sides.
        lj = jproj.pack_projector_lights([])
        lt = tproj.pack_projector_lights([], device="cpu")
    else:
        jsrc, jpack, tsrc, tpack = PACKS[family]
        kw = SOURCES[family][0]
        lj, lt = jpack([jsrc(**kw)], 3), tpack([tsrc(**kw)], 3, device="cpu")
        assert lt.capacity == 3
    _assert_same_fields(lt, lj)


@pytest.mark.parametrize("family", sorted(PACKS))
def test_interop_carries_packed_lights(family):
    lj, lt = _packed(family)
    carried = interop.to_torch(type(lt), interop.as_numpy_fields(lj))
    _assert_same_fields(carried, lj)


def test_interop_carries_windowed_gbuffer():
    gj, _ = _gbuffers("tilted")
    win_j = gj.window(5, 9, 16, 32)
    carried = interop.to_torch(GBuffer, interop.as_numpy_fields(win_j))
    _assert_same_fields(carried, win_j)
    np.testing.assert_array_equal(carried.pixel_origin.numpy(), [9.0, 5.0])


def test_gbuffer_window_matches_jax():
    gj, gt = _gbuffers("tilted")
    win_j, win_t = gj.window(5, 9, 16, 32), gt.window(5, 9, 16, 32)
    _assert_same_fields(win_t, win_j)
    # A window of a window adds the origins; the world positions are those
    # of the full frame's pixels.
    _assert_same_fields(win_t.window(2, 3, 8, 8), win_j.window(2, 3, 8, 8))
    np.testing.assert_allclose(win_t.world_position().numpy(),
                               np.asarray(win_j.world_position()), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(win_t.world_position().numpy(),
                                  gt.world_position().numpy()[5:21, 9:41])


# -- windows ----------------------------------------------------------------

# Centers inside, at every edge and corner of a 48x64 frame, outside it,
# and at half-integer corners (window 16: center - 8 ends in .5, rounded
# half to even in float32).
CENTERS = [(32.0, 24.0), (0.0, 0.0), (64.0, 48.0), (3.2, 46.9),
           (63.9, 0.1), (-5.0, 70.0), (16.5, 12.5), (17.5, 13.5),
           (24.5, 8.5), (8.49999, 8.50001), (40.25, 30.75)]


@pytest.mark.parametrize("center", CENTERS)
@pytest.mark.parametrize("win", [(16, 16), (15, 33), (48, 64), (64, 80)])
def test_window_origin_matches_jax(center, win):
    wh, ww = win
    ref = jwin.window_origin(jnp.asarray(center, jnp.float32), wh, ww, H, W)
    assert all(isinstance(v, int) for v in ref)
    c32 = np.asarray(center, np.float32)
    assert twin.window_origin(c32, wh, ww, H, W) == ref
    assert twin.window_origin(torch.as_tensor(c32), wh, ww, H, W) == ref


@pytest.mark.parametrize("channels", [3, 4, 2])
def test_add_window_matches_jax(channels):
    rng = np.random.default_rng(3)
    lm = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    contrib = rng.uniform(0, 1, (16, 20, channels)).astype(np.float32)
    ref = np.asarray(jwin.add_window(jnp.asarray(lm), jnp.asarray(contrib),
                                     30, 44))
    lm_t = torch.as_tensor(lm.copy())
    out = twin.add_window(lm_t, torch.as_tensor(contrib), 30, 44)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(lm_t.numpy(), lm)  # the input is kept


@pytest.mark.parametrize("support", [0.0, 7.9, 8.0, 8.01, 80.0, 292.02, 1e4])
def test_window_sizes_match_jax(support):
    assert twin.window_for_support(support, H, W) == \
        jwin.window_for_support(support, H, W)
    assert twin.window_for_support(support, 1080, 1920, multiple=8) == \
        jwin.window_for_support(support, 1080, 1920, multiple=8)
    np.testing.assert_array_equal(
        twin.window_deficit_px([support, 3.0], 16).numpy(),
        np.asarray(jwin.window_deficit_px([support, 3.0], 16)))


def test_accumulate_windowed_matches_jax():
    """Windows at the frame's edge and a half-integer center, a
    contribution that depends on the window's world positions, and the
    support deficit."""
    gj, gt = _gbuffers("tilted")
    centers = np.asarray([[3.0, 44.0], [24.5, 8.5], [70.0, 20.0]],
                         np.float32)
    support = np.asarray([7.0, 12.0, 3.0], np.float32)
    ref, deficit_j = jwin.accumulate_windowed(
        jnp.zeros((H, W, 3)), gj, jnp.asarray(centers), 16,
        lambda i, g: g.world_position() * (i + 1.0),
        support_px=jnp.asarray(support))
    out, deficit_t = twin.accumulate_windowed(
        torch.zeros((H, W, 3)), gt, torch.as_tensor(centers), 16,
        lambda i, g: g.world_position() * (i + 1.0),
        support_px=torch.as_tensor(support))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert int(deficit_t) == int(deficit_j) == 8
    assert (np.asarray(ref) != 0).any()


# -- helpers of the families ------------------------------------------------

def test_normal_factor_and_directional_opacity_match_jax():
    rng = np.random.default_rng(4)
    ln = rng.normal(size=(3, 5, 7, 3)).astype(np.float32)
    ln /= np.linalg.norm(ln, axis=-1, keepdims=True)
    sn = rng.normal(size=(1, 5, 7, 3)).astype(np.float32)
    sn[0, 0, :3] = 0.0  # no normal: the factor is 1
    ref = jsphere.compute_normal_factor(jnp.asarray(ln), jnp.asarray(sn))
    out = tsphere.compute_normal_factor(torch.as_tensor(ln),
                                        torch.as_tensor(sn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert (out.numpy()[:, 0, :3] == 1.0).all()
    d4 = np.concatenate([ln, np.ones_like(ln[..., :1])], -1)
    d4[1, ..., 3] = 0.0  # an ambient light: opacity 1
    ref = jdir.compute_directional_opacity(jnp.asarray(d4), jnp.asarray(sn))
    out = tdir.compute_directional_opacity(torch.as_tensor(d4),
                                           torch.as_tensor(sn))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert (out.numpy()[1] == 1.0).all()


@pytest.mark.parametrize("field", FIELDS)
def test_compute_ao_matches_jax(fields, field):
    fj, ft = fields
    gj, gt = _gbuffers("tilted")
    radius = np.asarray([6.0, 0.3, 10.0], np.float32)[:, None, None] \
        * np.ones((1, H, W), np.float32)
    opacity = np.asarray([0.7, 1.0, 0.4], np.float32)[:, None, None]
    visible = np.ones((3, H, W), bool)
    visible[2, :10] = False
    ref = jsphere.compute_ao(fj[field], gj.world_position()[None],
                             gj.normal[None], jnp.asarray(radius),
                             jnp.asarray(opacity), jnp.asarray(visible))
    with _rounding(field):
        out = tsphere.compute_ao(ft[field], gt.world_position()[None],
                                 gt.normal[None], torch.as_tensor(radius),
                                 torch.as_tensor(opacity),
                                 torch.as_tensor(visible))
    # One field sample and a squared ramp, float32 on both sides: max |d|
    # <= 1e-4 (measured at most 6.6e-7).
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    assert (out.numpy()[1] == 1.0).all()  # radius under 0.5: no AO
    assert (out.numpy()[0] < 0.99).any()


def test_shape_distances_match_jax():
    rng = np.random.default_rng(5)
    p = rng.uniform(-30, 30, (4000, 3)).astype(np.float32)
    _, lt = _packed("volumetric")
    lj, _ = _packed("volumetric")
    for i in range(3):
        ref = jvolum.shape_distance(
            jnp.asarray(p) + lj.start[i, :3], lj.start[i], lj.end[i],
            lj.even_more[i, 3])
        out = tvolum.shape_distance(
            torch.as_tensor(p) + lt.start[i, :3], lt.start[i], lt.end[i],
            lt.even_more[i, 3])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
        assert (out.numpy() < 0).any() and (out.numpy() > 0).any()
    np.testing.assert_allclose(
        tvolum.support_radius_px(lt, 0.5).numpy(),
        np.asarray(jvolum.support_radius_px(lj, 0.5)), rtol=1e-6)
    srcs = SOURCES["projector"]
    np.testing.assert_array_equal(
        tproj.support_radius_px(
            [tproj.ProjectorLightSource(**kw) for kw in srcs], 0.5),
        jproj.support_radius_px(
            [jproj.ProjectorLightSource(**kw) for kw in srcs], 0.5))


@pytest.mark.parametrize("factor,offset", [(0.3, 0.0), (0.75, 0.25),
                                           (1.0, 0.0)])
def test_stipple_keep_matches_jax(factor, offset):
    ref = np.asarray(jcoords.stipple_keep(100, factor, offset))
    np.testing.assert_array_equal(
        tcoords.stipple_keep(100, factor, offset).numpy(), ref)
    slots = np.arange(5, 90, 3)
    np.testing.assert_array_equal(
        tcoords.stipple_keep(torch.as_tensor(slots), factor, offset).numpy(),
        np.asarray(jcoords.stipple_keep(jnp.asarray(slots), factor, offset)))
    assert 0 < ref.sum() <= 100


# -- the families' accumulation --------------------------------------------

def _state_pair(seed=6, capacity=256):
    """A particle state with live, dead and transparent slots."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform((0, 0, 2), (W, H, 30), (capacity, 3)),
                          rng.uniform(-0.5, 2.0, (capacity, 1))], -1)
    col = rng.uniform(0.1, 1.0, (capacity, 4))
    col[::5, 3] = 0.0
    d = dict(position=pos.astype(np.float32),
             velocity=np.zeros((capacity, 4), np.float32),
             color=col.astype(np.float32),
             render_color=np.zeros((capacity, 4), np.float32),
             render_data=np.zeros((capacity, 4), np.float32))
    jfields = {f.name for f in dataclasses.fields(JParticleState)}
    extra = {k: np.zeros((), np.int32) for k in jfields - set(d)}
    sj = JParticleState(**{k: jnp.asarray(v) for k, v in {**d, **extra}
                           .items()})
    return sj, interop.to_torch(ParticleState, interop.as_numpy_fields(sj))


def _accumulate(family, side, field, gb, lights, env, quality, shadows):
    """One family's accumulation on one side. `shadows`: False (the
    unshadowed terms: falloff, normal ramp, AO, texture, column integral)
    or True (scan shadows inside)."""
    mod = {"directional": (jdir, tdir), "line": (jline, tline),
           "volumetric": (jvolum, tvolum),
           "projector": (jproj, tproj)}[family][side]
    mode = "scan" if shadows else "none"
    if family == "directional":
        return mod.accumulate_directional_lights(field, gb, lights, env,
                                                 quality, shadow_mode=mode)
    if family == "line":
        return mod.accumulate_line_lights(field, gb, lights, env, quality,
                                          shadow_mode=mode)
    if family == "volumetric":
        return mod.accumulate_volumetric_lights(
            field, gb, lights, env, quality, shadowed=shadows,
            shadow_detail="scan")
    return mod.accumulate_projector_lights(field, gb, lights, env, quality)


@pytest.mark.parametrize("gbuffer", GBUFFERS)
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("family", sorted(PACKS))
def test_unshadowed_terms_match_jax(fields, family, field, gbuffer):
    fj, ft = fields
    gj, gt = _gbuffers(gbuffer)
    ej, et = _envs()
    # The projector's second light has an origin; with shadows off its
    # march runs no step. Its first light is shadowless too.
    lj, lt = _packed(family)
    ref = np.asarray(_accumulate(family, 0, fj[field], gj, lj, ej,
                                 JQuality(), False))
    with _rounding(field):
        out = _accumulate(family, 1, ft[field], gt, lt, et,
                          QualitySettings(), False).numpy()
    assert out.shape == ref.shape == (H, W, 4)
    # Elementwise float32 on both sides (the volumetric column integral
    # sums 64 steps in the same order): max |d| <= 1e-4 (measured at
    # most 8.1e-7 over the 16 cases).
    assert np.abs(out - ref).max() <= 1e-4, np.abs(out - ref).max()
    assert ref[..., 3].max() > 0.05 and ref[..., :3].var() > 0.0


@pytest.mark.parametrize("gbuffer", GBUFFERS)
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("family", ["directional", "line", "volumetric"])
def test_scan_shadowed_terms_match_jax(fields, family, field, gbuffer):
    fj, ft = fields
    gj, gt = _gbuffers(gbuffer)
    ej, et = _envs()
    lj, lt = _packed(family)
    ref = np.asarray(_accumulate(family, 0, fj[field], gj, lj, ej,
                                 JQuality(), True))
    lit = np.asarray(_accumulate(family, 0, fj[field], gj, lj, ej,
                                 JQuality(), False))
    with _rounding(field):
        out = _accumulate(family, 1, ft[field], gt, lt, et,
                          QualitySettings(), True).numpy()
    # A scan is inside (its walk's carries float16 in the JAX package, its
    # upsample bfloat16): mean |d| of the accumulated opacity <= 0.01, the
    # bound of tests/test_torch_scan_analytic.py (measured at
    # most 6.6e-5 over the 12 cases).
    d = np.abs(out[..., 3] - ref[..., 3])
    assert d.mean() <= 0.01, d.mean()
    # The shadows are there: they take light away from part of the frame
    # (the volumetric lights' from a few tenths of a percent of it).
    assert (lit[..., 3] - ref[..., 3] > 0.02).mean() > 0.001


@pytest.mark.parametrize("field", FIELDS)
def test_projector_march_matches_jax(fields, field):
    """A projector with an origin and shadows on: the cone march toward
    the origin (the port's plain `cone_trace`) and the normal factor."""
    fj, ft = fields
    gj, gt = _gbuffers("flat")
    ej, et = _envs()
    kw = dict(SOURCES["projector"][1], cast_shadows=True, wrap=False,
              position=(8.0, 6.0, 0.0), scale=(50.0, 38.0),
              origin=(30.0, 4.0, 34.0), radius=3.0, ramp_length=60.0)
    lj = jproj.pack_projector_lights([jproj.ProjectorLightSource(**kw)])
    lt = tproj.pack_projector_lights([tproj.ProjectorLightSource(**kw)],
                                     device="cpu")
    ref = np.asarray(jproj.accumulate_projector_lights(
        fj[field], gj, lj, ej, JQuality()))
    with _rounding(field):
        out = tproj.accumulate_projector_lights(
            ft[field], gt, lt, et, QualitySettings()).numpy()
    # The same float32 march; a ray whose distance rounds differently may
    # take another step near a threshold: mean |d| <= 1e-3, 99% of pixels
    # within 1e-3 (measured 0.0: every ray takes the same steps).
    d = np.abs(out - ref)
    assert d.mean() <= 1e-3, d.mean()
    assert (d.max(axis=-1) <= 1e-3).mean() >= 0.99
    unshadowed = np.asarray(jproj.accumulate_projector_lights(
        fj[field], gj, jproj.pack_projector_lights(
            [jproj.ProjectorLightSource(**dict(kw, cast_shadows=False))]),
        ej, JQuality()))
    assert (unshadowed[..., 3] - ref[..., 3] > 0.05).mean() > 0.01


@pytest.mark.parametrize("field", FIELDS)
def test_volumetric_march_detail_matches_jax(fields, field):
    """shadow_detail="march": the inner occlusion march per column sample,
    at a cut step budget (8 column samples x 8 inner steps)."""
    fj, ft = fields
    gj, gt = _gbuffers("flat")
    ej, et = _envs()
    lj, lt = _packed("volumetric")
    ref = np.asarray(jax.jit(
        jvolum.accumulate_volumetric_lights,
        static_argnames=("quality", "shadowed", "shadow_detail"))(
            fj[field], gj, lj, ej, quality=JQuality(max_step_count=8),
            shadowed=True, shadow_detail="march"))
    with _rounding(field):
        out = tvolum.accumulate_volumetric_lights(
            ft[field], gt, lt, et, QualitySettings(max_step_count=8),
            shadowed=True, shadow_detail="march").numpy()
    # A float32 march on both sides: mean |d| <= 1e-3, 99% of pixels
    # within 1e-3 (measured mean 2.6e-10, max 6.0e-8).
    d = np.abs(out - ref)
    assert d.mean() <= 1e-3, d.mean()
    assert (d.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert ref[..., 3].max() > 0.05


@pytest.mark.parametrize("stipple", [1.0, 0.5])
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("shadows", [False, True])
def test_particle_lights_match_jax(fields, field, shadows, stipple):
    """The strided subset path: 32 of 256 slots as sphere lights, with AO;
    shadowless (`shadow_mode="none"`) or with the sphere scan."""
    fj, ft = fields
    gj, gt = _gbuffers("tilted")
    ej, et = _envs()
    sj, st = _state_pair()
    template = dict(position=(0.0, 0.0, 0.0), radius=2.0, ramp_length=25.0,
                    color=(1.0, 0.8, 0.6, 0.2), cast_shadows=shadows,
                    ambient_occlusion_radius=4.0,
                    ambient_occlusion_opacity=0.5)
    kw = dict(max_lights=32, stipple_factor=stipple, method="subset")
    src_j = jpl.ParticleLightSource(
        template=jenv.SphereLightSource(**template), **kw)
    src_t = tplight.ParticleLightSource(
        template=tenv.SphereLightSource(**template), **kw)
    lj = jpl.subset_lights_from_particles(sj, src_j.template, 32,
                                          stipple_factor=stipple)
    lt = tplight.subset_lights_from_particles(st, src_t.template, 32,
                                              stipple_factor=stipple)
    for name in ("position", "color", "properties", "more", "active",
                 "specular_color_power"):
        np.testing.assert_allclose(getattr(lt, name).numpy(),
                                   np.asarray(getattr(lj, name)), rtol=1e-6,
                                   atol=0, err_msg=name)
    assert 4 < float(lt.active.sum()) < 32
    ref, dropped_j = jpl.accumulate_particle_lights(
        fj[field], gj, sj, src_j, ej, JQuality(), return_diagnostics=True)
    with _rounding(field):
        out, dropped_t = tplight.accumulate_particle_lights(
            ft[field], gt, st, src_t, et, QualitySettings(),
            return_diagnostics=True)
    ref, out = np.asarray(ref), out.numpy()
    assert out.shape == ref.shape == (H, W, 4)
    assert int(dropped_t) == int(dropped_j) == 0
    d = np.abs(out - ref)
    if shadows:
        # A scan inside, and the JAX package's bfloat16 light sum: mean
        # |d| of the accumulated opacity <= 0.01 (measured at most 4.4e-4
        # at a mean opacity of 0.17 to 0.43).
        assert d[..., 3].mean() <= 0.01, d[..., 3].mean()
    else:
        # The JAX package sums the lights from bfloat16 operands
        # (sphere.py:366-370): 2^-8 relative on each of up to 32 terms;
        # the accumulated opacity likewise. Bound: max |d| <= 2^-7 of the
        # largest value (measured at most 9.8e-3 of 2.45: 2^-8).
        assert d.max() <= 2.0 ** -7 * ref.max(), (d.max(), ref.max())
    assert ref[..., 3].max() > 0.05


@pytest.mark.parametrize("method,capacity", [("tiled", 256), ("auto", 64)])
def test_tiled_particle_lights_match_jax(fields, method, capacity):
    """The tiled culling path, forced and where "auto" routes a small
    shadowless set, gives the JAX package's image within its bfloat16
    light sums' bound, 2^-8 of the largest value + 1e-3."""
    fj, ft = fields
    gj, gt = _gbuffers("flat")
    ej, et = _envs()
    sj, st = _state_pair(capacity=capacity)
    kw = dict(radius=1.0, ramp_length=2.0, cast_shadows=False)
    src = dict(method=method, tile_capacity=256)
    out = tplight.accumulate_particle_lights(
        ft["analytic"], gt, st,
        tplight.ParticleLightSource(template=tenv.SphereLightSource(**kw),
                                    **src), et, QualitySettings()).numpy()
    ref = np.asarray(jpl.accumulate_particle_lights(
        fj["analytic"], gj, sj,
        jpl.ParticleLightSource(template=jenv.SphereLightSource(**kw),
                                **src), ej, JQuality()))
    assert out.shape == ref.shape == (H, W, 4)
    assert np.abs(out - ref).max() <= 2.0 ** -8 * ref.max() + 1e-3
    assert ref[..., 3].max() > 0.05


# -- the scan's new arguments -----------------------------------------------

SCAN_LIGHTS = np.asarray([(10.0, 8.0, 30.0), (60.0, 44.0, 36.0),
                          (-150.0, -260.0, 420.0)], np.float32)
SCAN_RADIUS = np.asarray([4.0, 6.0, 8.0], np.float32)
SCAN_RAMP = np.asarray([60.0, 80.0, 32.0], np.float32)


def _scan_pair(fields, field, gbuffer, quality_kw=None, window=None, **kw):
    """scan_cone_visibility of three lights (the third far off screen,
    like a directional pseudo-center) on both sides; array arguments in
    `kw` as numpy."""
    fj, ft = fields
    gj, gt = _gbuffers(gbuffer)
    if window is not None:
        gj, gt = gj.window(*window), gt.window(*window)
    quality_kw = quality_kw or {}

    def conv(v, to):
        return to(v) if isinstance(v, np.ndarray) else v

    ref = np.asarray(jscan.scan_cone_visibility(
        fj[field], gj, jnp.asarray(SCAN_LIGHTS), jnp.asarray(SCAN_RADIUS),
        jnp.asarray(SCAN_RAMP), JQuality(**quality_kw),
        **{k: conv(v, jnp.asarray) for k, v in kw.items()}), np.float32)
    with _rounding(field):
        out = tscan.scan_cone_visibility(
            ft[field], gt, torch.as_tensor(SCAN_LIGHTS),
            torch.as_tensor(SCAN_RADIUS), torch.as_tensor(SCAN_RAMP),
            QualitySettings(**quality_kw),
            **{k: conv(v, torch.as_tensor) for k, v in kw.items()}).numpy()
    return out, ref


SCAN_CASES = {
    "trace_budget": dict(
        max_trace_distance=np.asarray([1e8, 25.0, 40.0], np.float32),
        trace_z=12.0),
    "array_lift": dict(
        self_occlusion_lift=np.asarray([1.6, 9.0, 0.0], np.float32),
        trace_z=12.0),
    "no_upsample": dict(upsample=False, trace_z=12.0),
    "fused": dict(
        self_occlusion_lift=np.asarray([1.6, 1.5, 1.5], np.float32),
        max_trace_distance=np.asarray([1e8, 1e8, 60.0], np.float32),
        trace_z=12.0, upsample=False),
    "windowed": dict(window=(6, 10, 32, 48), trace_z=12.0),
    "windowed_full_res": dict(window=(7, 11, 32, 48), trace_z=12.0,
                              quality_kw=dict(shadow_scale=1.0)),
    # Odd dims at shadow scale 0.5: both packages fall back to full
    # resolution (anisotropic rounding).
    "windowed_odd": dict(window=(3, 5, 31, 45), trace_z=12.0),
    "flatland_budget": dict(
        max_trace_distance=np.asarray([1e8, 25.0, 40.0], np.float32),
        trace_z=12.0, quality_kw=dict(scan_refine_samples=0)),
}


@pytest.mark.parametrize("gbuffer", GBUFFERS)
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_cone_visibility_arguments_match_jax(fields, case, field,
                                                  gbuffer):
    """`max_trace_distance`, a per-light array lift, `upsample=False`, all
    of them as the fused multi-family scan passes them, and a windowed
    G-buffer (on a ColumnField the window keeps the exact per-candidate
    refine through the column query)."""
    out, ref = _scan_pair(fields, field, gbuffer, **SCAN_CASES[case])
    assert out.shape == ref.shape and np.isfinite(out).all()
    if "no_upsample" in case or case == "fused":
        assert out.shape == (3, H // 2, W // 2)
    # The float16 walk and bfloat16 upsample of the JAX package against
    # float32: mean |d| <= 0.01 for every light, the bound of
    # tests/test_torch_scan_analytic.py (measured at most 1.3e-4 over the
    # cases).
    d = np.abs(out - ref).mean(axis=(1, 2))
    assert (d <= 0.01).all(), d
    # Every light casts a shadow somewhere in the view.
    assert ((ref < 0.5).mean(axis=(1, 2)) > 0.005).all(), \
        (ref < 0.5).mean(axis=(1, 2))


def test_array_lift_is_per_light(fields):
    """Each light's endpoint is lifted by its own entry: against the
    scalar lift 1.6, only the lights whose entry differs move (and the
    second, lifted 9 units along tilted normals, by more than the bound
    above)."""
    case = SCAN_CASES["array_lift"]
    out, _ = _scan_pair(fields, "analytic", "tilted", **case)
    scalar, _ = _scan_pair(fields, "analytic", "tilted", trace_z=12.0,
                           self_occlusion_lift=1.6)
    moved = np.abs(out - scalar).mean(axis=(1, 2))
    assert moved[0] == 0.0 and moved[1] > 0.01 and moved[2] > 0.0, moved


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("family", ["directional", "line", "sphere"])
def test_precomputed_visibility_matches_jax(fields, family, field):
    """`scan_visibility_precomputed`: a caller's visibility planes (for
    the line lights three per light, anchor-major, blended by hat weights
    over u) gate and scale the opacity as in the JAX package."""
    fj, ft = fields
    gj, gt = _gbuffers("tilted")
    ej, et = _envs()
    rng = np.random.default_rng(12)
    if family == "sphere":
        srcs = [dict(position=(12.0, 10.0, 20.0), radius=3.0,
                     ramp_length=40.0, color=_rgba(13)),
                dict(position=(50.0, 36.0, 14.0), radius=2.0,
                     ramp_length=30.0, color=_rgba(14), cast_shadows=False)]
        lj = jenv.pack_sphere_lights(
            [jenv.SphereLightSource(**kw) for kw in srcs], capacity=3)
        lt = tenv.pack_sphere_lights(
            [tenv.SphereLightSource(**kw) for kw in srcs], capacity=3,
            device="cpu")
        n_vis = 3
    else:
        lj, lt = _packed(family)
        n_vis = lt.capacity * (3 if family == "line" else 1)
    # Distinct levels per plane, so a wrong plane or weight shows.
    vis = (rng.uniform(0.0, 0.3, (n_vis, H, W))
           + np.linspace(0.1, 0.7, n_vis)[:, None, None]).astype(np.float32)
    if family == "sphere":
        ref = jsphere.accumulate_sphere_lights(
            fj[field], gj, lj, ej, JQuality(), with_specular=False,
            with_ao=False, scan_visibility_precomputed=jnp.asarray(vis))
        out = tsphere.accumulate_sphere_lights(
            ft[field], gt, lt, et, QualitySettings(), with_specular=False,
            with_ao=False, scan_visibility_precomputed=torch.as_tensor(vis))
        # The JAX package's bfloat16 light sum: 2^-7 of the largest value.
        tol = 2.0 ** -7 * float(np.asarray(ref).max())
    else:
        acc_j, acc_t = {
            "directional": (jdir.accumulate_directional_lights,
                            tdir.accumulate_directional_lights),
            "line": (jline.accumulate_line_lights,
                     tline.accumulate_line_lights)}[family]
        ref = acc_j(fj[field], gj, lj, ej, JQuality(), shadow_mode="none",
                    scan_visibility_precomputed=jnp.asarray(vis),
                    with_ao=False)
        out = acc_t(ft[field], gt, lt, et, QualitySettings(),
                    shadow_mode="none",
                    scan_visibility_precomputed=torch.as_tensor(vis),
                    with_ao=False)
        tol = 1e-5  # elementwise float32 (measured at most 3e-7)
    ref, out = np.asarray(ref), out.numpy()
    assert np.abs(out - ref).max() <= tol, np.abs(out - ref).max()
    assert ref[..., 3].max() > 0.05


def test_unported_shadow_scale_raises(fields):
    """An isotropic shadow scale other than 0.5 and 1 needs the linear
    resize, which is not ported."""
    _, ft = fields
    _, gt = _gbuffers("flat")
    with pytest.raises(NotImplementedError, match="ROADMAP M3"):
        tscan.scan_cone_visibility(
            ft["analytic"], gt, torch.as_tensor(SCAN_LIGHTS),
            torch.as_tensor(SCAN_RADIUS), torch.as_tensor(SCAN_RAMP),
            QualitySettings(shadow_scale=0.25))


def test_trace_budget_lights_far_blockers(fields):
    """A short budget lights pixels whose blocker is farther than it
    along the ray, in the port as in the JAX package."""
    case = SCAN_CASES["trace_budget"]
    out, _ = _scan_pair(fields, "analytic", "flat", **case)
    free, _ = _scan_pair(fields, "analytic", "flat", trace_z=12.0)
    assert (out >= free - 1e-6).all()
    assert (out[1:] - free[1:] > 0.5).mean() > 0.005
    np.testing.assert_array_equal(out[0], free[0])


def test_windowed_scan_equals_the_full_frame_cut(fields):
    """At full shadow resolution with no nomination halving, the scan of a
    window is the full frame's scan cut to the window, wherever the ray
    from the light stays inside the window."""
    _, ft = fields
    _, gt = _gbuffers("flat")
    q = QualitySettings(shadow_scale=1.0, scan_nomination_scale=1.0)
    light = torch.tensor([[30.0, 22.0, 30.0]])
    args = (light, torch.tensor([4.0]), torch.tensor([60.0]), q)
    full = tscan.scan_cone_visibility(ft["analytic"], gt, *args,
                                      trace_z=12.0)
    win = tscan.scan_cone_visibility(
        ft["analytic"], gt.window(6, 10, 32, 40), *args, trace_z=12.0)
    np.testing.assert_allclose(win.numpy(), full[:, 6:38, 10:50].numpy(),
                               rtol=0, atol=1e-4)
    assert (win < 0.5).float().mean() > 0.01


# -- the directional and line scans against the port's own march ------------
# The scenes and bounds of tests/test_directional_scan.py.

def _directional_setup(direction=(-1.0, 0.0, -0.3), trace_length=300.0):
    scene = interop.to_torch(AnalyticScene, interop.as_numpy_fields(
        pack_scene([LightObstruction.box((128.0, 128.0, 16.0),
                                         (10.0, 40.0, 24.0))])))
    env = tenv.EnvironmentUniforms.make(device="cpu")
    from illuminant_tpu_torch.lighting.gbuffer import flat_ground

    gb = flat_ground(256, 256, env)
    lights = tdir.pack_directional_lights([tdir.DirectionalLightSource(
        direction=direction, shadow_trace_length=trace_length,
        shadow_softness=8.0, shadow_ramp_rate=1.0)], device="cpu")
    return scene, gb, lights, env, QualitySettings()


@pytest.fixture(scope="module")
def directional_march():
    scene, gb, lights, env, q = _directional_setup()
    return tdir.accumulate_directional_lights(
        scene, gb, lights, env, q, shadow_mode="march")[..., 3].numpy()


def test_directional_scan_matches_own_march(directional_march):
    scene, gb, lights, env, q = _directional_setup()
    a_scan = tdir.accumulate_directional_lights(
        scene, gb, lights, env, q, shadow_mode="scan")[..., 3].numpy()
    for a in (directional_march, a_scan):
        assert a[120:136, 70:110].max() < 0.10, a[120:136, 70:110].max()
        assert a[120:136, 150:200].min() > 0.5
    open_lvl = directional_march[20:60, 20:60].mean()
    cls = (directional_march > 0.5 * open_lvl) != (a_scan > 0.5 * open_lvl)
    # tests/test_directional_scan.py:78 (measured 0.0090).
    assert cls.mean() < 0.02, cls.mean()


def test_directional_fused_plane_matches_own_march(directional_march):
    """The sun's lane on the fused scan's shared trace plane, with an
    array lift."""
    scene, gb, lights, env, q = _directional_setup()
    centers, rad, ramp, mtd, _ = tdir.directional_scan_args(gb, lights, env)
    vis = tscan.scan_cone_visibility(
        scene, gb, centers, rad, ramp, q, max_trace_distance=mtd,
        trace_z=16.0, self_occlusion_lift=torch.tensor([1.5]))[0].numpy()
    assert vis[120:136, 70:110].max() < 0.15, vis[120:136, 70:110].max()
    assert vis[120:136, 150:200].min() > 0.5
    open_lvl = directional_march[20:60, 20:60].mean()
    cls = (directional_march > 0.5 * open_lvl) != (vis > 0.5)
    # tests/test_directional_scan.py:148 (measured 0.0089).
    assert cls.mean() < 0.03, cls.mean()


def test_directional_scan_respects_trace_length():
    def scan(trace_length):
        scene, gb, lights, env, q = _directional_setup(
            trace_length=trace_length)
        return tdir.accumulate_directional_lights(
            scene, gb, lights, env, q, shadow_mode="scan")[..., 3].numpy()

    a_long, a_short = scan(400.0), scan(60.0)
    assert a_long[120:136, 100:112].max() < 0.15
    assert a_short[120:136, 100:112].max() < 0.25
    assert a_long[120:136, 15:40].mean() < 0.6
    assert a_short[120:136, 15:40].min() > 0.6


def test_line_scan_matches_own_march():
    scene = interop.to_torch(AnalyticScene, interop.as_numpy_fields(
        pack_scene([LightObstruction.box((128.0, 100.0, 16.0),
                                         (30.0, 8.0, 24.0))])))
    env = tenv.EnvironmentUniforms.make(device="cpu")
    from illuminant_tpu_torch.lighting.gbuffer import flat_ground

    gb = flat_ground(256, 256, env)
    lights = tline.pack_line_lights([tline.LineLightSource(
        start=(60.0, 40.0, 30.0), end=(200.0, 40.0, 30.0), radius=8.0)],
        device="cpu")
    q = QualitySettings()
    a_m = tline.accumulate_line_lights(scene, gb, lights, env, q,
                                       shadow_mode="march")[..., 3].numpy()
    a_s = tline.accumulate_line_lights(scene, gb, lights, env, q,
                                       shadow_mode="scan")[..., 3].numpy()
    for a in (a_m, a_s):
        assert a[140:180, 110:145].max() < a[50:70, 110:145].mean() * 0.3
    lvl = a_m[50:70, 110:145].mean()
    cls = (a_m > 0.3 * lvl) != (a_s > 0.3 * lvl)
    # tests/test_directional_scan.py:180 (measured 0.0015).
    assert cls.mean() < 0.06, cls.mean()


def test_line_march_matches_jax(fields):
    """The 3-ray march through `cone_trace(raw=True)`."""
    fj, ft = fields
    gj, gt = _gbuffers("flat")
    ej, et = _envs()
    lj, lt = _packed("line")
    ref = np.asarray(jline.accumulate_line_lights_jit(
        fj["analytic"], gj, lj, ej, JQuality(), shadow_mode="march"))
    out = tline.accumulate_line_lights(
        ft["analytic"], gt, lt, et, QualitySettings(),
        shadow_mode="march").numpy()
    # The same float32 march (measured mean 2.3e-8, max 7.2e-7).
    d = np.abs(out - ref)
    assert d.mean() <= 1e-3, d.mean()
    assert (d.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert cone_trace(None, torch.zeros(3), 1.0, 16.0, torch.ones(4, 3),
                      torch.ones(4, dtype=torch.bool),
                      QualitySettings()).tolist() == [1.0] * 4
