"""The port's multi-device raster (parallel/raster.py), mesh helpers and
tile bins against the JAX package and against its own unsharded raster.

The route and the band rasters are pure functions, so one process chains
them for every rank of a mesh of D (the exchange between them is then a
transpose of the stacked send buffers) and holds the counts to the JAX
function on the virtual CPU devices of tests/conftest.py. Processes of
2 and 4 gloo ranks run the real collective (`spawn_ranks`, rank bodies in
torch_mesh_ranks.py, which imports no jax)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.parallel import mesh as jmesh
from illuminant_tpu.parallel import raster as jraster
from illuminant_tpu.raster import tiled as jtiled
from illuminant_tpu_torch.parallel import mesh as pmesh
from illuminant_tpu_torch.parallel import raster as praster
from illuminant_tpu_torch.raster import tiled

import torch_mesh_ranks

torch.set_num_threads(1)


def _particles(n, h, w, seed=0, cluster=None):
    """tests/test_sharded_raster.py's clouds: uniform over the frame and 8
    px past it, 10% dead; `cluster` (cy, share) piles that share into a
    20-px row band. Positions on the JAX payload's 1/16-px grid, as in
    tests/test_torch_raster.py, so that its bounds hold."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-8, w + 8, n).astype(np.float32)
    y = rng.uniform(-8, h + 8, n).astype(np.float32)
    if cluster is not None:
        cy, frac = cluster
        m = int(n * frac)
        y[:m] = rng.uniform(cy - 10, cy + 10, m)
        x[:m] = rng.uniform(0, w, m)
    x, y = (np.round(a * 16.0) / 16.0 for a in (x, y))
    color = rng.uniform(0.1, 1.0, (n, 4)).astype(np.float32)
    size = rng.uniform(1.0, 7.0, n).astype(np.float32)
    live = rng.uniform(0, 1, n) > 0.1
    return x, y, color, size, live


def _torch(parts):
    return [torch.as_tensor(a) for a in parts]


def in_process(cfg, d, parts, factor=3.0):
    """Every rank's route, the exchange as a transpose, every band's
    raster, in one process -> (stitched image, diagnostics, peak)."""
    x, y, color, size, live = _torch(parts)
    n_loc = x.shape[0] // d
    budget = praster.send_budget(cfg, d, n_loc, factor)
    sends, counts, drops = [], [], 0
    for r in range(d):
        s = slice(r * n_loc, (r + 1) * n_loc)
        lanes, c, dr = praster.route(cfg, d, x[s], y[s], color[s], size[s],
                                     live[s], budget)
        sends.append(lanes)
        counts.append(c)
        drops += int(dr)
    recv = torch.stack(sends).transpose(0, 1).reshape(d, d * budget, 8)
    img = torch.cat([praster.raster_band(cfg, d, r, recv[r])
                     for r in range(d)])
    peak = int(torch.stack(counts).max())
    diag = praster.diagnostics(cfg, d, n_loc, budget, torch.tensor(drops),
                               torch.tensor(peak))
    return img, diag, peak


def _reorder_bound(cfg, parts):
    """n x 2^-23 x max|image|: each pixel's float32 sum of n terms in
    another order (tests/test_torch_splat.py's bound)."""
    x, y, color, size, live = _torch(parts)
    ref, _ = tiled.rasterize_tiled(cfg, x, y, color, size, live)
    n = int(tiled.splat_terms(cfg, x, y, size, live).max())
    return ref, max(n, 1) * 2.0 ** -23 * float(ref.abs().max())


@pytest.fixture(scope="module")
def jax_meshes():
    if len(jax.devices()) < 8:
        pytest.fail("tests/conftest.py sets up 8 virtual CPU devices")
    return {d: jmesh.make_mesh(d) for d in (4, 8)}


CLOUDS = {
    "uniform": dict(seed=0, cluster=None, factor=3.0),
    "clustered": dict(seed=3, cluster=(128.0, 0.9), factor=1.0),
}


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
@pytest.mark.parametrize("d", [4, 8])
def test_route_matches_jax(jax_meshes, d, cloud):
    """tests/test_sharded_raster.py's frame (256 x 192, 4,096 particles):
    the send budget, the send drops and the peak (source, owner) demand
    equal the JAX function's, the fill and the suggested factor within
    1e-6 relative, and the factor `measure_send_budget_factor` gives (on
    the JAX side its own composition, the suggested factor of a lossless
    probe times the slack, under jit: the function itself runs the
    sharded raster op by op, for 40 s); where nothing was dropped the
    image within the port's raster-versus-JAX bounds
    (tests/test_torch_raster.py, rgba8 colours there)."""
    spec = CLOUDS[cloud]
    h, w, n = 256, 192, 1 << 12
    parts = _particles(n, h, w, seed=spec["seed"], cluster=spec["cluster"])
    jcfg = jtiled.TiledRasterConfig(
        height=h, width=w, tile=32, bin_capacity=4096, apron=4,
        rgba8_colors=True, color_scale=2.0, channels=3, overflow_tiles=0)
    mesh = jax_meshes[d]
    args = [jax.device_put(jnp.asarray(a), jmesh.row_sharding(mesh))
            for a in parts]
    jimg, jdiag = jax.jit(lambda *a: jraster.rasterize_tiled_sharded(
        mesh, jcfg, *a, send_budget_factor=spec["factor"]))(*args)
    cfg = tiled.TiledRasterConfig(height=h, width=w, channels=3)
    img, diag, peak = in_process(cfg, d, parts, spec["factor"])
    budget = int(jdiag["send_budget"])
    assert int(diag["send_budget"]) == budget
    assert int(diag["send_dropped"]) == int(jdiag["send_dropped"])
    assert int(diag["dropped"]) == int(jdiag["dropped"])
    assert peak == round(float(jdiag["send_peak_fill"]) * budget)
    for key in ("send_peak_fill", "suggested_send_budget_factor"):
        np.testing.assert_allclose(float(diag[key]), float(jdiag[key]),
                                   rtol=1e-6, err_msg=key)
    if cloud == "clustered":
        assert int(diag["send_dropped"]) > 0
    else:
        assert int(diag["send_dropped"]) == 0
        out, ref = img.numpy().astype(np.float64), np.asarray(jimg,
                                                              np.float64)
        assert out.shape == ref.shape == (h, w, 3)
        rel = (np.abs(out - ref) / np.maximum(np.abs(ref), 0.5)).max()
        assert rel < 0.12, rel
        assert abs(out.sum() - ref.sum()) / ref.sum() < 0.02
    _, probe = jax.jit(lambda x, y, live: jraster.rasterize_tiled_sharded(
        mesh, jcfg, x, y, jnp.zeros((n, 4), jnp.float32),
        jnp.ones((n,), jnp.float32), live, send_budget_factor=float(d)))(
            args[0], args[1], args[4])
    want = float(probe["suggested_send_budget_factor"]) * 1.25
    got = float(diag["suggested_send_budget_factor"]) * 1.25
    np.testing.assert_allclose(got, want, rtol=1e-6)


# Band edges: the last band shorter than the others (200 rows in bands of
# 64), fewer tile rows than ranks (64 rows: two of four ranks own none),
# one tile row a band (a particle has three owners), and particles up to
# 8 px above and below the frame on every one.
EDGES = {"short_last_band": (200, 96), "fewer_rows_than_ranks": (64, 96),
         "one_tile_a_band": (128, 64), "analytic_1080p_rows": (1080, 64)}


@pytest.mark.parametrize("kernel", ["gauss", "round"])
@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_bands_equal_the_unsharded_raster(d, edge, kernel):
    """The stitched bands equal the whole frame's raster within its
    reordered-sum bound, at every band edge; nothing is dropped at the
    lossless budget (factor D)."""
    h, w = EDGES[edge]
    parts = _particles(1032, h, w, seed=d)  # divides by 2, 3, 4 and 8
    cfg = tiled.TiledRasterConfig(height=h, width=w, kernel=kernel,
                                  channels=3)
    img, diag, _ = in_process(cfg, d, parts, factor=float(d))
    ref, tol = _reorder_bound(cfg, parts)
    assert int(diag["send_dropped"]) == 0
    assert img.shape == ref.shape
    assert float((img - ref).abs().max()) <= tol


def test_band_layout_and_rows():
    cfg = tiled.TiledRasterConfig(height=200, width=96)
    assert pmesh.band_layout(200, 32, 4) == (2, 64)
    assert [pmesh.band_rows(cfg, 4, r) for r in range(4)] == [
        (0, 64), (64, 128), (128, 192), (192, 200)]
    assert praster.owners_used(cfg, 4) == 4
    small = tiled.TiledRasterConfig(height=64, width=96)
    assert [pmesh.band_rows(small, 4, r) for r in range(4)] == [
        (0, 32), (32, 64), (64, 64), (64, 64)]
    assert praster.owners_used(small, 4) == 2
    # Ghost rows only inside the frame.
    assert praster.band_grid(cfg, 4, 0)[0] == 0
    assert praster.band_grid(cfg, 4, 0)[1].height == 96
    assert praster.band_grid(cfg, 4, 3)[0] == 160
    assert praster.band_grid(cfg, 4, 3)[1].height == 40
    # B = min(max(ceil(n_loc f / owners_used), 64), 3 n_loc).
    assert praster.send_budget(cfg, 4, 1024, 3.0) == 768
    assert praster.send_budget(small, 4, 1024, 3.0) == 1536
    assert praster.send_budget(cfg, 4, 16, 3.0) == 48


@pytest.fixture(scope="module")
def gloo_runs():
    """rasterize_tiled_sharded on 2 and 4 gloo ranks, every band edge of
    EDGES with a stipple, the clustered cloud at a budget that drops."""
    cases, runs = {}, {}
    for name, (h, w) in sorted(EDGES.items()):
        cases[name] = (tiled.TiledRasterConfig(height=h, width=w,
                                               channels=3),
                       _particles(512, h, w, seed=5), dict(
                           stipple_factor=0.75, send_budget_factor=4.0))
    cases["clustered"] = (tiled.TiledRasterConfig(height=256, width=192,
                                                  channels=3),
                          _particles(1024, 256, 192, seed=3,
                                     cluster=(128.0, 0.9)),
                          dict(send_budget_factor=1.0))
    for d in (2, 4):
        jobs = [(cfg, *_torch(parts), kw) for cfg, parts, kw in
                cases.values()]
        runs[d] = dict(zip(cases, zip(*pmesh.spawn_ranks(
            torch_mesh_ranks.sharded_raster, d, jobs, device="cpu"))))
    return cases, runs


@pytest.mark.parametrize("case", sorted(EDGES) + ["clustered"])
@pytest.mark.parametrize("d", [2, 4])
def test_gloo_sharded_raster_equals_unsharded(gloo_runs, d, case):
    """On d gloo ranks each rank's band, and the frame `gather_rows`
    assembles, equal the unsharded raster within its reordered-sum bound
    (the stipple keyed off global slots); the diagnostics are the same
    on every rank and equal the in-process route's; every rank measures
    the same factor."""
    cases, runs = gloo_runs
    cfg, parts, kw = cases[case]
    ranks = runs[d][case]
    x, y, color, size, live = _torch(parts)
    keep = live
    if "stipple_factor" in kw:
        from illuminant_tpu_torch.ops.coords import stipple_keep

        keep = live & stipple_keep(x.shape[0], kw["stipple_factor"])
    factor = kw["send_budget_factor"]
    ref_img, ref_diag, _ = in_process(
        cfg, d, (x, y, color, size, keep), factor)
    ref, tol = _reorder_bound(cfg, (x, y, color, size, keep))
    # The measurement routes the live particles, stipple or not.
    suggested = float(in_process(cfg, d, parts)[1][
        "suggested_send_budget_factor"])
    for r, (band, diag, rows, measured, whole) in enumerate(ranks):
        assert rows == pmesh.band_rows(cfg, d, r)
        for key, want in ref_diag.items():
            np.testing.assert_allclose(float(diag[key]), float(want),
                                       rtol=1e-6, err_msg=key)
        assert measured == pytest.approx(suggested * 1.25, rel=1e-6)
        if case == "clustered":
            assert int(diag["send_dropped"]) > 0
            continue
        assert int(diag["dropped"]) == 0
        assert band.shape == ref[rows[0]:rows[1]].shape
        if band.numel():
            assert float((band - ref[rows[0]:rows[1]]).abs().max()) <= tol
        assert float((whole - ref).abs().max()) <= tol
    assert torch.equal(ref_img, torch.cat([b[0] for b in ranks]))


def test_quantize_xy_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-40, 2000, 4096).astype(np.float32)
    y = np.round(rng.uniform(-40, 1100, 4096) * 32).astype(np.float32) / 32
    jx, jy = jtiled.quantize_xy(jnp.asarray(x), jnp.asarray(y))
    tx, ty = tiled.quantize_xy(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


@pytest.mark.parametrize("replicate", [False, True])
@pytest.mark.parametrize("capacity", [8, 64])
def test_bin_particles_matches_jax(capacity, replicate):
    """`bin_particles` against the JAX bins (float colours, 4 channels, the
    stable sort): the inputs on the JAX payload's grid (1/16-px
    positions, bfloat16 colours and sizes), so each valid slot is equal
    bit for bit; drops, starts and counts exact."""
    h, w, n = 96, 128, 2048
    x, y, color, size, live = _particles(n, h, w, seed=9,
                                         cluster=(40.0, 0.3))
    x, y = (np.asarray(a) for a in jtiled.quantize_xy(jnp.asarray(x),
                                                      jnp.asarray(y)))
    color, size = _bf16(color), _bf16(size)
    kw = dict(height=h, width=w, tile=32, apron=4, bin_capacity=capacity)
    jb = jtiled.bin_particles(
        jtiled.TiledRasterConfig(rgba8_colors=False, channels=4, **kw),
        *(jnp.asarray(a) for a in (x, y, color, size, live)),
        replicate_footprint=replicate)
    tb = tiled.bin_particles(tiled.TiledRasterConfig(channels=4, **kw),
                             *_torch((x, y, color, size, live)),
                             stable=False, replicate_footprint=replicate)
    for key in ("starts", "counts"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    assert int(tb["dropped"]) == int(jb["dropped"])
    if capacity == 8:
        assert int(tb["dropped"]) > 0
    valid = np.asarray(jb["valid"])
    np.testing.assert_array_equal(tb["valid"].numpy(), valid)
    for key in ("x", "y", "size"):
        np.testing.assert_array_equal(tb[key].numpy()[valid],
                                      np.asarray(jb[key])[valid], key)
    for c in range(4):
        np.testing.assert_array_equal(tb["color"][c].numpy()[valid],
                                      np.asarray(jb["color"][c])[valid])
