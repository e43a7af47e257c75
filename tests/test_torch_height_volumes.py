"""Height volumes and billboards of the port against the JAX package:
the polygon distance, the extruded field term of `pack_scene`, and the
G-buffer rasterization of top / front faces and of each billboard type,
on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.lighting import billboard as jbb
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import gbuffer as jgbuf
from illuminant_tpu.lighting.height_volume import (
    rasterize_height_volumes as jax_rasterize)
from illuminant_tpu.ops import coords as jcoords
from illuminant_tpu.sdf import analytic as jana
from illuminant_tpu.sdf import height_volume as jhv
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.lighting import billboard as bb
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting import gbuffer as gbuf
from illuminant_tpu_torch.lighting.gbuffer import GBuffer
from illuminant_tpu_torch.lighting.height_volume import (
    rasterize_height_volumes)
from illuminant_tpu_torch.ops import coords
from illuminant_tpu_torch.sdf import analytic as ana
from illuminant_tpu_torch.sdf import height_volume as hv

torch.set_num_threads(1)

SQUARE = [(10.0, 10.0), (50.0, 10.0), (50.0, 40.0), (10.0, 40.0)]
LSHAPE = [(0.0, 0.0), (40.0, 0.0), (40.0, 20.0), (20.0, 20.0),
          (20.0, 40.0), (0.0, 40.0)]
HEXAGON = [(60.0, 50.0), (80.0, 46.0), (92.0, 60.0), (78.0, 64.0),
           (84.0, 78.0), (62.0, 74.0)]  # concave at (78, 64)


def _both(volumes, **kw):
    """The same host volumes packed by both packages."""
    j = jhv.pack_height_volumes([jhv.HeightVolume(**v) for v in volumes],
                                **kw)
    t = hv.pack_height_volumes([hv.HeightVolume(**v) for v in volumes],
                               device="cpu", **kw)
    return j, t


def _points(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20.0, 110.0, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-10.0, 60.0, n)
    # Exact vertices, edge points, the z faces.
    p[:6] = [[10, 10, 0], [50, 25, 20], [30, 40, 10], [20, 20, 20],
             [0, 0, -1], [78, 64, 5]]
    return p


def test_pack_height_volumes_matches_jax():
    vols = [dict(polygon=SQUARE, z_base=2.0, height=20.0),
            dict(polygon=LSHAPE, height=12.0, top_face_enable_shadows=False),
            dict(polygon=HEXAGON[:3], front_face_enable_shadows=False)]
    j, t = _both(vols)
    carried = interop.to_torch(hv.HeightVolumes, interop.as_numpy_fields(j))
    for name in ("vertices", "next_vertices", "z_range", "top_shadows",
                 "front_shadows", "active"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
        np.testing.assert_array_equal(getattr(carried, name).numpy(),
                                      getattr(t, name).numpy())
    assert t.capacity == 3 and t.vertices.shape == (3, 6, 2)
    with pytest.raises(ValueError, match="edges"):
        hv.pack_height_volumes([hv.HeightVolume(polygon=LSHAPE)],
                               max_edges=4, device="cpu")
    empty = hv.pack_height_volumes([], device="cpu")
    assert empty.capacity == 1 and float(empty.active.sum()) == 0.0


def test_polygon_sdf_square():
    """The analytic values of tests/test_height_volumes.py, and the JAX
    function on random points (1e-4 on distances up to ~100: one sqrt and
    a handful of float32 products)."""
    _, vols = _both([dict(polygon=SQUARE)])
    pts = torch.tensor([[30.0, 25.0], [60.0, 25.0], [30.0, 0.0], [0.0, 0.0]])
    d = hv.polygon_sdf_2d(pts[:, None, :], vols.vertices[0][None],
                          vols.next_vertices[0][None])[:, 0].numpy()
    np.testing.assert_allclose(d, [-15.0, 10.0, 10.0, np.sqrt(200.0)],
                               atol=1e-3)


@pytest.mark.parametrize("polygon", [SQUARE, LSHAPE, HEXAGON],
                         ids=["square", "lshape", "hexagon"])
def test_polygon_sdf_matches_jax(polygon):
    j, t = _both([dict(polygon=polygon)], max_edges=8)
    p = _points()[:, :2]
    ref = np.asarray(jhv.polygon_sdf_2d(
        jnp.asarray(p)[:, None, :], j.vertices[0][None],
        j.next_vertices[0][None]))[:, 0]
    out = hv.polygon_sdf_2d(torch.as_tensor(p)[:, None, :],
                            t.vertices[0][None],
                            t.next_vertices[0][None])[:, 0].numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert (out < 0).any() and (out > 0).any()


def test_polygon_sdf_concave():
    # The notch of the L is outside, its solid part inside.
    _, vols = _both([dict(polygon=LSHAPE)], max_edges=8)
    pts = torch.tensor([[10.0, 10.0], [30.0, 30.0]])
    d = hv.polygon_sdf_2d(pts[:, None, :], vols.vertices[0][None],
                          vols.next_vertices[0][None])[:, 0]
    assert d[0] < 0 and d[1] > 0


def test_extruded_distance_matches_jax():
    vols = [dict(polygon=SQUARE, z_base=0.0, height=20.0),
            dict(polygon=HEXAGON, z_base=4.0, height=30.0)]
    j, t = _both(vols)
    p = _points()
    ref = np.asarray(jhv.extruded_polygon_distance(jnp.asarray(p), j))
    out = hv.extruded_polygon_distance(torch.as_tensor(p), t).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    inside = float(hv.extruded_polygon_distance(
        torch.tensor([[30.0, 25.0, 10.0]]), t)[0])
    above = float(hv.extruded_polygon_distance(
        torch.tensor([[30.0, 25.0, 35.0]]), t)[0])
    assert inside < 0
    np.testing.assert_allclose(above, 15.0, atol=0.1)
    # An inactive pad never wins the min.
    _, pad = _both([])
    assert float(hv.extruded_polygon_distance(torch.as_tensor(p),
                                              pad).min()) >= 1e9


def _obstructions(mod):
    return [mod.LightObstruction.box((30.0, 70.0, 10.0), (8.0, 6.0, 10.0)),
            mod.LightObstruction.cylinder((80.0, 20.0, 12.0),
                                          (6.0, 6.0, 12.0))]


@pytest.mark.parametrize("many", [False, True], ids=["unrolled", "batched"])
def test_pack_scene_with_height_volumes_matches_jax(many):
    """`pack_scene(..., height_volumes=)`: only obstruction-flagged
    volumes join the field; distances agree on both evaluation paths (the
    per-primitive unroll, and the batched one above 64 primitives)."""
    vols = [dict(polygon=SQUARE, height=20.0),
            dict(polygon=HEXAGON, height=30.0, is_obstruction=False),
            dict(polygon=LSHAPE, z_base=5.0, height=10.0)]
    extra = 70 if many else 0

    def scene(mod, hmod, pack, **kw):
        obs = _obstructions(mod) + [
            mod.LightObstruction.ellipsoid((5.0 + i, 100.0, 3.0),
                                           (1.0, 1.0, 3.0))
            for i in range(extra)]
        return pack(obs, height_volumes=[hmod.HeightVolume(**v)
                                         for v in vols], **kw)

    sj = scene(jenv, jhv, jana.pack_scene)
    st = scene(tenv, hv, ana.pack_scene, device="cpu")
    assert st.polygons.capacity == 2
    carried = interop.to_torch(ana.AnalyticScene,
                               interop.as_numpy_fields(sj))
    np.testing.assert_array_equal(carried.polygons.vertices.numpy(),
                                  st.polygons.vertices.numpy())
    p = _points()
    ref = np.asarray(sj.distance(jnp.asarray(p)))
    for s in (st, carried):
        np.testing.assert_allclose(s.distance(torch.as_tensor(p)).numpy(),
                                   ref, rtol=0, atol=1e-4)
    # The hexagon is no obstruction: inside it the field is far.
    assert float(st.distance(torch.tensor([[72.0, 58.0, 10.0]]))[0]) > 5.0
    # The planar query broadcasts like the positional one.
    x = torch.as_tensor(p[:50, 0])[None, :]
    y = torch.as_tensor(p[:40, 1])[:, None]
    d = st.distance_p(x, y, 10.0)
    assert d.shape == (40, 50)
    ref_p = np.asarray(sj.distance_p(jnp.asarray(p[:50, 0])[None, :],
                                     jnp.asarray(p[:40, 1])[:, None], 10.0))
    np.testing.assert_allclose(d.numpy(), ref_p, rtol=0, atol=1e-4)
    assert ana.pack_scene(_obstructions(tenv), device="cpu").polygons is None
    # No closed-form normal with polygons: the autograd gradient.
    if not many:
        q = torch.as_tensor(p[:200])
        n_fast = st.normal_fast_p(q[:, 0], q[:, 1], q[:, 2])
        n_ad = st.normal_p(q[:, 0], q[:, 1], q[:, 2])
        for a, b in zip(n_fast, n_ad):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def _gbuffers(h, w, z_to_y, render_scale=1.0):
    je = jenv.LightingEnvironment(z_to_y_multiplier=z_to_y, maximum_z=64.0)
    te = tenv.LightingEnvironment(z_to_y_multiplier=z_to_y, maximum_z=64.0)
    ju, tu = je.uniforms(), te.uniforms(device="cpu")
    return (jgbuf.flat_ground(h, w, ju, render_scale), ju,
            gbuf.flat_ground(h, w, tu, render_scale), tu)


def _assert_gbuffer_equal(out: GBuffer, ref, atol=1e-4):
    """Every plane of the port's G-buffer against the JAX one: the flags
    exactly, z / relative_y / normal to `atol` except on the rare pixel
    whose centre lies within float rounding of a face's edge."""
    np.testing.assert_array_equal(out.enable_shadows.numpy(),
                                  np.asarray(ref.enable_shadows))
    np.testing.assert_array_equal(out.fullbright.numpy(),
                                  np.asarray(ref.fullbright))
    for name in ("z", "relative_y", "normal"):
        d = np.abs(getattr(out, name).numpy() - np.asarray(getattr(ref, name)))
        assert (d <= atol).mean() >= 0.999, (name, d.max(),
                                             (d <= atol).mean())


RASTER_CASES = {
    # name: (z_to_y, volumes)
    "sheared": (1.0, [dict(polygon=SQUARE, height=20.0),
                      dict(polygon=HEXAGON, z_base=0.0, height=14.0,
                           front_face_enable_shadows=False)]),
    "no_shear": (0.0, [dict(polygon=SQUARE, height=20.0),
                       dict(polygon=LSHAPE, height=30.0)]),
    # Two volumes of one height that overlap tie in the depth resolve:
    # both packages take the first; the flags tell which one won.
    "equal_height_overlap": (1.0, [
        dict(polygon=SQUARE, height=20.0, top_face_enable_shadows=False),
        dict(polygon=[(30.0, 20.0), (70.0, 20.0), (70.0, 60.0),
                      (30.0, 60.0)], height=20.0)]),
    "half_shear_stacked": (0.5, [dict(polygon=SQUARE, height=20.0),
                                 dict(polygon=[(20.0, 15.0), (40.0, 15.0),
                                               (40.0, 35.0), (20.0, 35.0)],
                                      z_base=20.0, height=10.0)]),
}


@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_rasterize_height_volumes_matches_jax(case):
    z_to_y, vols = RASTER_CASES[case]
    gj, ju, gt, tu = _gbuffers(96, 112, z_to_y)
    vj, vt = _both(vols)
    ref = jax_rasterize(gj, vj, ju)
    out = rasterize_height_volumes(gt, vt, tu)
    for plane in (out.z, out.relative_y, out.normal):
        assert torch.isfinite(plane).all()
    _assert_gbuffer_equal(out, ref)
    z = out.z.numpy()
    assert (z > 0).any() and (z == 0).any()
    n = out.normal.numpy()
    if z_to_y == 0.0:
        # No front face exists without the shear: every normal is +z.
        np.testing.assert_array_equal(n[..., 2], 1.0)
        np.testing.assert_array_equal(out.relative_y.numpy(), 0.0)
    else:
        assert (n[..., 1] > 0.9).any()  # a south-facing front face
    if case == "equal_height_overlap":
        # In the overlap (world 30..50 x 20..40, sheared up by 20) the
        # first volume wins: its top face disables shadows.
        assert out.enable_shadows[5, 40] == 0.0
        assert out.enable_shadows[30, 60] == 1.0
    # Carrying the JAX G-buffer across gives the port's.
    carried = interop.to_torch(GBuffer, interop.as_numpy_fields(ref))
    _assert_gbuffer_equal(carried, ref, atol=0.0)


def test_gbuffer_top_and_front_faces():
    """The analytic values of tests/test_height_volumes.py on the port."""
    _, _, gb, env_u = _gbuffers(96, 96, 1.0)
    _, vols = _both([dict(polygon=SQUARE, z_base=0.0, height=20.0)])
    out = rasterize_height_volumes(gb, vols, env_u, self_occlusion_z=0.0)
    z, n, ry = out.z.numpy(), out.normal.numpy(), out.relative_y.numpy()
    # The top face appears 20 up-screen: polygon y in [10, 40] -> screen y
    # in [-10, 20].
    assert abs(z[15, 30] - 20.0) < 1e-3
    np.testing.assert_allclose(n[15, 30], [0, 0, 1], atol=1e-5)
    # The front face of the south edge (world y = 40): z = 40 - sy.
    assert abs(z[25, 30] - 15.0) < 1.0 and n[25, 30, 1] > 0.9
    assert z[80, 80] == 0.0
    assert abs(ry[15, 30] - 20.0) < 1e-3


def test_camera_position_and_no_gbuffer_match_jax():
    gj, ju, gt, tu = _gbuffers(12, 20, 1.0, render_scale=0.5)
    np.testing.assert_allclose(gt.camera_position(tu).numpy(),
                               np.asarray(gj.camera_position(ju)), atol=1e-6)
    ref = jgbuf.no_gbuffer(12, 20, ju, 0.5)
    out = gbuf.no_gbuffer(12, 20, tu, 0.5)
    _assert_gbuffer_equal(out, ref, atol=0.0)
    assert out.render_scale == 0.5 and float(out.enable_shadows.min()) == 1.0


def test_decode_normal_spherical_matches_jax():
    rng = np.random.default_rng(1)
    enc = rng.uniform(0.0, 1.0, (64, 2)).astype(np.float32)
    enc[0] = 0.0  # "no normal"
    out = coords.decode_normal_spherical(torch.as_tensor(enc)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jcoords.decode_normal_spherical(jnp.asarray(enc))),
        atol=1e-6)
    np.testing.assert_array_equal(out[0], 0.0)
    # It inverts the JAX package's encoder.
    n = rng.normal(size=(32, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    back = coords.decode_normal_spherical(torch.as_tensor(np.array(
        jcoords.encode_normal_spherical(jnp.asarray(n))))).numpy()
    np.testing.assert_allclose(back, n, atol=1e-3)


def _billboards(mod):
    """One billboard of each type (and the variants of the auto type), in
    scrambled sort order, some overlapping."""
    rng = np.random.default_rng(7)
    stripe = np.zeros((8, 8, 4), np.float32)
    stripe[:, 2:6, 3] = 1.0
    sprite = np.zeros((8, 8, 4), np.float32)
    sprite[2:6, 2:6, 3] = 1.0
    data = rng.uniform(0.0, 1.0, (6, 6, 4)).astype(np.float32)
    data[0, 0, :2] = 0.0
    ntex = np.zeros((8, 8, 4), np.float32)
    ntex[..., :3] = [0.5, 0.5, 1.0]
    ntex[..., 3] = 1.0
    ntex[:2, :, :3] = 0.5  # a zero normal: dead texels
    signed = rng.uniform(-1.0, 1.0, (4, 4, 4)).astype(np.float32)
    signed[..., 3] = 1.0
    dist = rng.uniform(0.0, 12.0, (4, 4)).astype(np.float32)
    B = mod.Billboard
    return [
        B(screen_bounds=(16.0, 16.0, 48.0, 48.0), texture=stripe,
          normal=(0.0, 1.0, 0.0), sort_key=3.0),
        B(screen_bounds=(40.0, 8.0, 60.0, 40.0), normal=(0.2, 0.9, 0.1),
          cylinder_factor=0.8, world_elevation=2.0, data_scale=0.5,
          enable_shadows=False, sort_key=1.0),
        B(screen_bounds=(4.0, 40.0, 28.0, 60.0), texture=data,
          type=mod.TYPE_GBUFFER_DATA, data_scale=20.0, sort_key=2.0),
        B(screen_bounds=(50, 30, 66, 46), texture=sprite, type=mod.TYPE_AUTO,
          normal_z=0.3, z_to_y_ratio=1.0, base_z=2.0, fullbright=True,
          sort_key=0.5),
        B(screen_bounds=(70, 4, 78, 12), texture=np.ones((4, 4, 4),
                                                         np.float32),
          type=mod.TYPE_AUTO, normal_z=-999.0, sort_key=4.0),
        B(screen_bounds=(70, 20, 78, 28), texture=np.ones((4, 4, 4),
                                                          np.float32),
          type=mod.TYPE_AUTO, base_z=1.0, distance_texture=dist,
          z_from_distance=(0.0, 5.0, 1.0), sort_key=4.5),
        B(screen_bounds=(60, 44, 76, 60), texture=ntex,
          type=mod.TYPE_NORMAL_BILLBOARD, z_to_y_ratio=0.5, sort_key=5.0),
        B(screen_bounds=(30, 50, 46, 62), texture=signed,
          type=mod.TYPE_NORMAL_BILLBOARD, normals_are_signed=True,
          base_z=3.0, sort_key=0.1),
    ]


@pytest.mark.parametrize("which", ["all"] + list(range(8)))
def test_rasterize_billboards_matches_jax(which):
    """Each billboard type alone and all of them in sort order (the mask
    with and without a texture and with the cylinder bend, G-buffer data,
    the auto type with its normal / no-occlusion / distance-texture
    variants, normal billboards biased and signed)."""
    gj, ju, gt, tu = _gbuffers(64, 80, 1.0)
    pick = (lambda bs: bs) if which == "all" else (lambda bs: [bs[which]])
    ref = jbb.rasterize_billboards(gj, pick(_billboards(jbb)), ju)
    out = bb.rasterize_billboards(gt, pick(_billboards(bb)), tu)
    _assert_gbuffer_equal(out, ref, atol=1e-5)
    changed = (out.z.numpy() != 0.0) | (out.normal.numpy()[..., 2] != 1.0)
    assert changed.any() and not changed.all()


def test_billboard_values():
    """The analytic values of tests/test_height_volumes.py and
    tests/test_auto_gbuffer.py on the port."""
    _, _, gb, env_u = _gbuffers(64, 64, 1.0)
    bs = _billboards(bb)
    out = bb.rasterize_billboards(gb, [bs[0]], env_u)
    z, n, ry = out.z.numpy(), out.normal.numpy(), out.relative_y.numpy()
    assert n[32, 32, 1] > 0.9
    assert z[20, 32] > z[44, 32] > 0.0  # higher on screen = taller
    assert z[32, 20] == 0.0 and n[32, 20, 2] == 1.0
    assert abs(ry[32, 32] - (48.0 - 32.5)) < 1.0

    tex = np.zeros((8, 8, 4), np.float32)
    tex[2:6, 2:6, 3] = 1.0
    auto = bb.Billboard(screen_bounds=(16, 16, 32, 32), texture=tex,
                        type=bb.TYPE_AUTO, normal_z=0.3, z_to_y_ratio=1.0,
                        base_z=2.0)
    out = bb.rasterize_billboards(gb, [auto], env_u)
    exp = np.asarray([0.0, 0.7, 0.3])
    np.testing.assert_allclose(out.normal.numpy()[26, 24],
                               exp / np.linalg.norm(exp), atol=1e-5)
    assert out.z[26, 24] > 2.0 and out.z[40, 40] == 0.0
    assert out.z[17, 17] == 0.0  # a transparent corner of the sprite

    flat = bb.Billboard(screen_bounds=(8, 8, 16, 16),
                        texture=np.ones((4, 4, 4), np.float32),
                        type=bb.TYPE_AUTO, base_z=1.0,
                        distance_texture=np.full((4, 4), 8.0, np.float32),
                        z_from_distance=(0.0, 5.0, 1.0))
    out = bb.rasterize_billboards(gb, [flat], env_u)
    np.testing.assert_allclose(out.z.numpy()[10, 10], 6.0, atol=1e-5)

    with pytest.raises(ValueError, match="billboard type"):
        bb.rasterize_billboards(gb, [bb.Billboard(type=9)], env_u)
