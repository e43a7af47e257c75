"""The map utilities (utils/jumpflood.py, utils/mapgen.py,
utils/visualize.py) in the port against the JAX package, on the same
numpy inputs.

Tolerances: the jump flood exactly equal (its planes hold integer-valued
float32 squared distances and seeds; the update order is the JAX
package's); mapgen elementwise within 1e-6; the SDF visualisation's hit
mask may flip on at most 0.1% of the pixels (a ray whose distance rounds
differently at the hit threshold stops a step apart), its shading within
1e-5 elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.ops import bezier as jbez
from illuminant_tpu.sdf.analytic import pack_scene as jpack_scene
from illuminant_tpu.utils import histogram as jhist
from illuminant_tpu.utils import jumpflood as jjfa
from illuminant_tpu.utils import mapgen as jmap
from illuminant_tpu.utils import visualize as jvis
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.ops import bezier as tbez
from illuminant_tpu_torch.sdf.analytic import pack_scene
from illuminant_tpu_torch.utils import histogram as thist
from illuminant_tpu_torch.utils import jumpflood as tjfa
from illuminant_tpu_torch.utils import mapgen as tmap
from illuminant_tpu_torch.utils import visualize as tvis


def _masks():
    """Three 48 x 64 masks (one shape: the JAX side compiles its rolls
    once): two boxes, demo.py scene_jumpflood's disc and bar cut to size,
    and scattered noise."""
    two_boxes = np.zeros((48, 64), bool)
    two_boxes[10:20, 12:30] = True
    two_boxes[30:40, 40:56] = True
    ys, xs = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    blobs = (((ys - 24) ** 2 + (xs - 20) ** 2) < 12 ** 2) | (
        (np.abs(ys - 20) < 5) & (np.abs(xs - 46) < 12))
    rng = np.random.default_rng(2)
    return {"two_boxes": two_boxes, "blobs": blobs,
            "noise": rng.uniform(size=(48, 64)) > 0.93}


@pytest.mark.parametrize("name", sorted(_masks()))
def test_jump_flood_equals_jax(name):
    mask = _masks()[name]
    out = tjfa.jump_flood_sdf(mask, device="cpu").numpy()
    ref = np.asarray(jjfa.jump_flood_sdf(jnp.asarray(mask)))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    assert (out[mask] < 0).all() and (out[~mask] > 0).all()


def test_jump_flood_feeds_height_from_distance():
    mask = np.zeros((32, 32), bool)
    mask[8:24, 8:24] = True
    h = tmap.height_from_distance(tjfa.jump_flood_sdf(mask, device="cpu"),
                                  0.0, 8.0, 0.0, 1.0).numpy()
    assert h[16, 16, 0] == 1.0
    assert h[0, 0, 0] == 0.0 and h[0, 0, 3] == 0.0


def _close(out, ref, atol=1e-6):
    out, ref = out.numpy(), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


def _slope(h=16, w=32):
    return np.tile(np.linspace(0.0, 1.0, w, dtype=np.float32), (h, 1))


def _cliff():
    h = np.zeros((8, 16), np.float32)
    h[:, 8:] = 1.0
    return h


@pytest.mark.parametrize("name,heightmap,kw", [
    ("slope", _slope(), {}),
    ("flat", np.zeros((8, 8), np.float32), {}),
    ("cliff", _cliff(), {}),
    ("cliff_clamped", _cliff(), dict(normal_elevation_clamping=True)),
    ("slope_signed", _slope(), dict(normals_are_signed=True)),
])
def test_heightmap_to_normals_matches_jax(name, heightmap, kw):
    out = tmap.heightmap_to_normals(torch.as_tensor(heightmap), **kw)
    _close(out, jmap.heightmap_to_normals(jnp.asarray(heightmap), **kw))
    if name == "flat":
        assert out[..., 3].max() == 0.0
    if name == "cliff_clamped":
        assert abs(out[4, 7, 0] * 2 - 1) < 1e-3


def test_heightmap_to_displacement_matches_jax():
    out = tmap.heightmap_to_displacement(torch.as_tensor(_slope()),
                                         (2.0, 2.0))
    _close(out, jmap.heightmap_to_displacement(jnp.asarray(_slope()),
                                               (2.0, 2.0)))
    assert out[..., 2].max() == 0.5 and out[8, 16, 0] < 0.5


@pytest.mark.parametrize("kw", [
    dict(min_distance=0.0, max_distance=32.0, min_height=0.0,
         max_height=1.0),
    dict(min_distance=-40.0, max_distance=24.0, min_height=0.0,
         max_height=1.0, distance_power_1=1.0, distance_power_2=2.0),
    dict(min_distance=2.0, max_distance=12.0, min_height=0.2,
         max_height=0.9, distance_power_1=0.5, distance_power_2=1.5),
])
def test_height_from_distance_matches_jax(kw):
    dist = np.linspace(-50.0, 40.0, 91, dtype=np.float32)[None]
    out = tmap.height_from_distance(torch.as_tensor(dist), **kw)
    _close(out, jmap.height_from_distance(jnp.asarray(dist), **kw))
    assert out[0, :, 3].min() == 0.0 and out[0, :, 3].max() == 1.0


@pytest.mark.parametrize("kw", [{}, dict(input_min=0.1, input_max=0.9,
                                         forward_bias=0.2,
                                         shadows_only=True)])
def test_normals_from_lightmaps_matches_jax(kw):
    rng = np.random.default_rng(6)
    maps = [rng.uniform(0, 1, (24, 32)).astype(np.float32)
            for _ in range(4)]
    for m in maps:
        m[:4, :4] = 0.0  # dead pixels
    out = tmap.normals_from_lightmaps(*map(torch.as_tensor, maps), **kw)
    _close(out, jmap.normals_from_lightmaps(*map(jnp.asarray, maps), **kw))
    assert (out[:4, :4, :3] == 0.0).all()


def _sdf_scene():
    """demo.py scene_visualize_sdf's primitives, cut to 72 x 64."""
    def boxes(env):
        return [env.LightObstruction.ellipsoid((22.0, 28.0, 8.0),
                                               (10.0, 7.0, 8.0)),
                env.LightObstruction.box((48.0, 18.0, 6.0), (6.0, 6.0, 6.0)),
                env.LightObstruction.cylinder((42.0, 48.0, 8.0),
                                              (5.0, 5.0, 8.0))]

    return jpack_scene(boxes(jenv)), pack_scene(boxes(tenv), device="cpu")


@pytest.mark.parametrize("mode", [tvis.VIS_SURFACES, tvis.VIS_OUTLINES])
def test_visualize_distance_field_matches_jax(mode):
    jscene, tscene = _sdf_scene()
    kw = dict(mode=mode, start_z=40.0)
    ref = np.asarray(jvis.visualize_distance_field(jscene, 72, 64, **kw))
    out = tvis.visualize_distance_field(tscene, 72, 64, device="cpu",
                                        **kw).numpy()
    assert out.shape == ref.shape == (72, 64, 4)
    if mode == tvis.VIS_SURFACES:
        hit_t, hit_j = out[..., 0] > 0.0, ref[..., 0] > 0.0
        flips = hit_t != hit_j
        assert flips.mean() <= 0.001, flips.mean()
        assert 0.05 < hit_j.mean() < 0.95
        same = ~flips
        np.testing.assert_allclose(out[same], ref[same], rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
        assert out[..., 0].max() == 1.0 and out[..., 1].max() == 0.5


def test_draw_histogram_and_bezier_match_jax():
    rng = np.random.default_rng(8)
    img = (rng.uniform(0, 1, (32, 40, 3)) ** 3 * 6.0).astype(np.float32)
    bounds = jhist.bucket_boundaries()
    jres = jhist.compute_histogram(jnp.asarray(img), jnp.asarray(bounds))
    tres = thist.compute_histogram(torch.as_tensor(img), bounds)
    kw = dict(width=128, height=48, percentiles=(95.0,), range_min=0.0,
              range_max=4.0)
    np.testing.assert_allclose(tvis.draw_histogram(tres, **kw),
                               jvis.draw_histogram(jres, **kw), atol=1e-6)
    points = [[0.0, 1.0, 0.2], [0.5, 0.2, 0.9], [1.0, 0.6, 0.1]]
    jb = jbez.pack_bezier(points, 0.0, 2.0)
    tb = tbez.pack_bezier(points, 0.0, 2.0, device="cpu")
    np.testing.assert_array_equal(
        tvis.visualize_bezier(tb, 64, 32, 0.0, 2.0),
        jvis.visualize_bezier(jb, 64, 32, 0.0, 2.0))
