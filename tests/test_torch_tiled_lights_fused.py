"""K10's fused route on the CPU: its plain version
(`tiled_lights_kernel.tiled_lights_fused_reference`), the kernel's cull in its
own order (`tiled_lights_kernel.cull_mirror`), the kernel's sub-tile skip
rule (`subtile_reaches`) and the build's staleness check, against the
JAX package where it has a counterpart.

Tolerances:
  * the bins exactly equal (`idx` under the mask, `mask`, `dropped`): the
    cull compares float32 values computed in the binning's operation
    order, and its survivors keep the stable sort's order;
  * the skip rule exactly: a pair it drops has plain opacity exactly 0;
  * the image within 2^-8 x max + 1e-3 of the JAX package (its bfloat16
    contraction, tests/test_torch_tiled_lights.py), `window_deficit_px`
    to 1e-6.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting import gbuffer as jgbuf
from illuminant_tpu.lighting import tiled_lights as jtl
from illuminant_tpu.sdf import columns as jcols
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu.sdf.analytic import pack_scene as jpack_scene
from illuminant_tpu_torch.core import cuda_build, interop
from illuminant_tpu_torch.lighting import environment as tenv
from illuminant_tpu_torch.lighting import gbuffer as tgbuf
from illuminant_tpu_torch.lighting import tiled_lights as ttl
from illuminant_tpu_torch.lighting import tiled_lights_kernel as tk
from illuminant_tpu_torch.sdf import columns
from illuminant_tpu_torch.sdf.analytic import pack_scene
from illuminant_tpu_torch.sdf.volume import SdfVolume

H, W = 100, 150  # 32-px tiles: a partial last row and column


def _template(**kw):
    base = dict(radius=2.0, ramp_length=14.0, color=(1.0, 0.9, 0.8, 0.3),
                cast_shadows=False)
    base.update(kw)
    return base


def _relief(kind):
    rel = np.zeros((H, W), np.float32)
    if kind == "edge":
        # Relief reaching the partial last tile row and column.
        rel[70:, 100:] = -18.0
        rel[96:, 140:] = 9.0
    elif kind == "tall":
        rel[40:, :] = -90.0  # beyond a window of one tile
    return rel


# name -> (relief, template, lights, capacity, max_relative_y)
CULL_CASES = {
    "overflow": ("flat", {}, "pile", 16, 32.0),
    "edge_relief": ("edge", {}, "spread", 64, 32.0),
    "squashed_y": ("edge", dict(falloff_y_factor=0.4), "spread", 64, 32.0),
    "beyond_window": ("tall", {}, "spread", 64, 32.0),
}


def _lights(kind, n=140, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-20, W + 20, n).astype(np.float32)
    y = rng.uniform(-20, H + 20, n).astype(np.float32)
    if kind == "pile":
        x[:60], y[:60] = 70.0, 40.0
    live = rng.uniform(size=n) > 0.2
    return x, y, live


def _jax_bounds(rel, tile, rs):
    """The JAX route's tile y bounds (its padded min / max)."""
    th, tw = -(-H // tile), -(-W // tile)
    rel_t = jtl._to_tiles(jnp.pad(jnp.asarray(rel), ((0, th * tile - H),
                                                     (0, tw * tile - W))),
                          th, tw, tile)
    ty0 = ((jnp.arange(th * tw) // tw) * tile).astype(jnp.float32)
    return (ty0 + jnp.min(rel_t, axis=(1, 2)) * rs,
            ty0 + tile + jnp.max(rel_t, axis=(1, 2)) * rs)


@pytest.mark.parametrize("name", sorted(CULL_CASES))
def test_cull_in_kernel_order_equals_binning(name):
    """Tile by tile, offset then light order, the kernel's cull keeps the
    lights `bin_lights_to_tiles` keeps in the port and in the JAX
    package, in the same slots, and drops as many."""
    relief, tpl, lights, capacity, mry = CULL_CASES[name]
    tile, rs = 32, 1.0
    rel = _relief(relief)
    sh = ttl.shading_for(tenv.SphereLightSource(**_template(**tpl)), tile,
                         capacity, rs, mry)
    x, y, live = _lights(lights)
    lo, hi, rel_max = tk.tile_y_bounds(torch.as_tensor(rel), tile, rs)
    jlo, jhi = _jax_bounds(rel, tile, rs)
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    th, tw = -(-H // tile), -(-W // tile)
    kw = dict(influence_y=sh.influence_y, extra_y_window=sh.extra_y)
    idx, mask, dropped = ttl.bin_lights_to_tiles(
        torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(live),
        sh.influence, tile, th, tw, capacity, tile_y_lo=lo, tile_y_hi=hi,
        **kw)
    jidx, jmask, jdropped = jtl.bin_lights_to_tiles(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(live), sh.influence,
        tile, th, tw, capacity, tile_y_lo=jlo, tile_y_hi=jhi, **kw)
    kept, count, kdropped = tk.cull_mirror(
        torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(live), sh,
        H, W, lo, hi)
    want = np.where(mask.numpy(), idx.numpy(), -1)
    assert np.array_equal(want, np.where(np.asarray(jmask),
                                         np.asarray(jidx), -1))
    assert np.array_equal(kept.numpy(), want)
    assert np.array_equal(count.numpy(), mask.sum(dim=1).numpy())
    assert int(kdropped) == int(dropped) == int(jdropped)
    assert (int(dropped) > 0) == (name == "overflow")
    assert mask.any()
    if relief == "edge":
        # The relief reaches the partial tiles: their bounds moved.
        last = th * tw - 1
        assert float(lo[last]) < (th - 1) * tile
        assert float(hi[last]) > th * tile
    if name == "beyond_window":
        assert float(rel_max) * rs - sh.extra_y > 0.0


def _subtile(rng, ramp_mode, relief=6.0):
    """A 32 x 4 sub-tile's pixel world positions and normals, computed as
    the shading computes them, and its box."""
    rs = 1.0
    gx = np.arange(64, 96)
    gy = np.arange(32, 36)
    xs = (torch.as_tensor(gx, dtype=torch.float32) + 0.5) / rs
    ys = (torch.as_tensor(gy, dtype=torch.float32) + 0.5) / rs
    rel = torch.as_tensor(rng.uniform(-relief, relief, (4, 32))
                          .astype(np.float32))
    wx = xs[None, :].expand(4, 32)
    wy = ys[:, None] + rel
    wz = torch.as_tensor(rng.uniform(0, 3, (4, 32)).astype(np.float32))
    n = rng.normal(size=(4, 32, 3)).astype(np.float32)
    n[..., 2] = np.abs(n[..., 2]) + 0.2
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0, :4] = 0.0
    box = torch.stack([wx.min(), wx.max(), wy.min(), wy.max(), wz.min(),
                       wz.max()])
    return wx, wy, wz, torch.as_tensor(n), box


def _opacity(px, lights, sh, light_occlusion):
    """Plain opacity (L, 4, 32) of each light at each pixel."""
    wx, wy, wz, n, _ = px
    nx, ny, nz = n.unbind(-1)
    no_normal = (nx == 0) & (ny == 0) & (nz == 0)
    lo = torch.tensor(light_occlusion)
    lx, ly, lz = (lights[:, k][:, None, None] for k in range(3))
    return tk.light_opacity(
        wx - lx, (wy - ly) * sh.y_factor, wz - lz, nx, ny, nz, no_normal,
        torch.ones(()), sh.radius, 1.0 / sh.ramp_length, sh.ramp_mode,
        1.0 / torch.clamp(lo, min=1e-6), lo > 0.0)


def _ulps(v, k):
    """v moved by k float32 ulps (k may be negative)."""
    a = np.array(v, np.float32)
    for _ in range(abs(k)):
        a = np.nextafter(a, np.float32(np.inf if k > 0 else -np.inf))
    return float(a)


@pytest.mark.parametrize("occlusion", [0.0, 2.5])
@pytest.mark.parametrize("ramp_mode", [0, 1, 2])
def test_skip_rule_drops_only_zero_opacity(ramp_mode, occlusion):
    """Random lights around a sub-tile, and lights on the support and the
    skip distance plus or minus a few ulps off each face of its box: every
    pair the rule drops has plain opacity exactly 0, with a squashed y
    falloff and with the light occlusion on."""
    rng = np.random.default_rng(17 + ramp_mode)
    tpl = tenv.SphereLightSource(**_template(
        ramp_mode=ramp_mode, falloff_y_factor=0.6, radius=3.0,
        ramp_length=9.0))
    sh = ttl.shading_for(tpl, 32, 64, 1.0, 32.0)
    px = _subtile(rng, ramp_mode)
    box = px[4]
    centre = [(float(box[0]) + float(box[1])) / 2,
              (float(box[2]) + float(box[3])) / 2, 1.0]
    reach = sh.support * 4
    pts = [np.array([rng.uniform(centre[0] - reach, centre[0] + reach),
                     rng.uniform(centre[1] - reach / sh.y_factor,
                                 centre[1] + reach / sh.y_factor),
                     rng.uniform(-2, 14)], np.float32)
           for _ in range(3000)]
    # On each face's normal line: the support and the skip distance, +- a
    # few ulps (the y face's distance stretched by 1 / y_factor).
    for dist in (sh.support, sh.cutoff):
        for k in range(-4, 5):
            for axis, lo_i, hi_i, stretch in ((0, 0, 1, 1.0),
                                              (1, 2, 3, 1 / sh.y_factor),
                                              (2, 4, 5, 1.0)):
                for side in (-1, 1):
                    p = list(centre)
                    edge = float(box[hi_i] if side > 0 else box[lo_i])
                    p[axis] = _ulps(edge + side * dist * stretch, k)
                    pts.append(np.array(p, np.float32))
    lights = torch.as_tensor(np.stack(pts))
    reach_ok = tk.subtile_reaches(box[None], lights, sh.y_factor, sh.cutoff)
    op = _opacity(px, lights, sh, occlusion)
    skipped = ~reach_ok
    assert skipped.sum() > 1000 and reach_ok.sum() > 100
    assert (op[skipped] == 0.0).all()
    # The rule does drop lights a few ulps past the skip distance.
    assert skipped[-2 * 9 * 3 * 2:].any()
    # Pairs on the support itself keep, and some of the kept light.
    assert (op[reach_ok] > 0).any()


def _case(relief="edge", n=150, seed=6, pile=0):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(-12, W + 12, n)
    pos[:, 1] = rng.uniform(-12, H + 12, n)
    pos[:, 2] = rng.uniform(2, 18, n)
    pos[:, 3] = 1.0
    pos[:pile, :2] = (70.0, 40.0)
    col = rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32)
    active = rng.uniform(size=n) > 0.15
    fb = np.zeros((H, W), np.float32)
    fb[:, 120:128] = 1.0
    return pos, col, active, fb, _relief(relief)


def _jax_volume():
    env = jenv.LightingEnvironment()
    env.obstructions += [
        jenv.LightObstruction.box((60.0, 40.0, 8.0), (14.0, 10.0, 8.0)),
        jenv.LightObstruction.cylinder((110.0, 70.0, 10.0),
                                       (10.0, 10.0, 10.0))]
    cfg = jvol.SdfVolumeConfig(virtual_width=W, virtual_height=H,
                               virtual_depth=64, slice_count=16,
                               resolution_scale=0.5)
    return jvol.generate_volume(cfg, env.pack_obstructions())


@pytest.fixture(scope="module")
def volumes():
    vj = _jax_volume()
    cf_j = jax.jit(jcols.build_column_maps)(vj)
    vt = interop.to_torch(SdfVolume, interop.as_numpy_fields(vj))
    box = ((60.0, 40.0, 8.0), (10.0, 10.0, 8.0))
    return dict(
        none=(None, None),
        analytic=(jpack_scene([jenv.LightObstruction.box(*box)]),
                  pack_scene([tenv.LightObstruction.box(*box)],
                             device="cpu")),
        column=(cf_j, columns.build_column_maps(vt)))


# volume -> the factor mode the route takes.
MODES = {"none": "fullbright", "analytic": "pix_f", "column": "column_ao"}


@pytest.mark.parametrize("with_alpha", [True, False])
@pytest.mark.parametrize("volume", sorted(MODES))
def test_fused_reference_matches_jax(volumes, volume, with_alpha):
    """The plain fused version in each factor mode against the JAX route
    on a 2.5D G-buffer with relief in the partial edge tiles, a
    fullbright band, AO and an overflowing tile."""
    jv, tv = volumes[volume]
    pos, col, active, fb, rel = _case(pile=40)
    tpl = _template(ambient_occlusion_radius=4.0,
                    ambient_occlusion_opacity=0.7, falloff_y_factor=0.8)
    jenv_u = jenv.LightingEnvironment(ground_z=0.0, maximum_z=64.0) \
        .uniforms()
    tenv_u = tenv.LightingEnvironment(ground_z=0.0, maximum_z=64.0) \
        .uniforms(device="cpu")
    jgb = jgbuf.flat_ground(H, W, jenv_u).replace(
        relative_y=jnp.asarray(rel), fullbright=jnp.asarray(fb))
    tgb = tgbuf.flat_ground(H, W, tenv_u).replace(
        relative_y=torch.as_tensor(rel), fullbright=torch.as_tensor(fb))
    kw = dict(tile=32, capacity=24, with_alpha=with_alpha,
              max_relative_y=32.0)
    ref, jdiag = jtl.accumulate_sphere_lights_tiled(
        jv, jgb, jnp.asarray(pos), jnp.asarray(col), jnp.asarray(active),
        jenv.SphereLightSource(**tpl), jenv_u, **kw)
    template = tenv.SphereLightSource(**tpl)
    sh = ttl.shading_for(template, 32, 24, 1.0, 32.0,
                         with_alpha=with_alpha)
    mode = MODES[volume]
    factor = tgb.fullbright
    if mode == "pix_f":
        factor = tk.pixel_factor(tv, tgb.z, tgb.relative_y, tgb.normal,
                                  tgb.fullbright, 1.0, 4.0, 0.7)
    out, dropped, deficit, kept, count = tk.tiled_lights_fused(
        tgb.z, tgb.relative_y, tgb.normal, factor, torch.as_tensor(pos),
        torch.as_tensor(col), torch.as_tensor(active),
        tenv_u.light_occlusion.reshape(()), sh, mode,
        tv if mode == "column_ao" else None, debug=True)
    ref = np.asarray(ref)
    err = float(np.abs(out.numpy() - ref).max())
    assert err <= 2.0 ** -8 * float(np.abs(ref).max()) + 1e-3, err
    assert int(dropped) == int(jdiag["dropped"]) > 0
    assert abs(float(deficit) - float(jdiag["window_deficit_px"])) <= 1e-6
    # The debug lists are the kernel cull's.
    lo, hi, _ = tk.tile_y_bounds(tgb.relative_y, 32, 1.0)
    mkept, mcount, _ = tk.cull_mirror(
        torch.as_tensor(pos[:, 0]), torch.as_tensor(pos[:, 1]),
        torch.as_tensor(active), sh, H, W, lo, hi)
    assert torch.equal(kept, mkept) and torch.equal(count, mcount)
    # And the route gives the same image as the plain version it runs.
    img, diag = ttl.accumulate_sphere_lights_tiled(
        tv, tgb, torch.as_tensor(pos), torch.as_tensor(col),
        torch.as_tensor(active), template, tenv_u, **kw)
    assert torch.equal(img, out) and int(diag["dropped"]) == int(dropped)


def test_shading_scalars_and_limits():
    """The route's scalars: the candidate window of the JAX binning, the
    support and the skip distance; sizes past the kernel's limits
    raise before anything launches."""
    tpl = tenv.SphereLightSource(**_template(falloff_y_factor=0.5))
    sh = ttl.shading_for(tpl, 64, 48, 1.0, 64.0)
    assert (sh.reps_x, sh.reps_y) == (1, 2) and sh.offsets == 15
    assert sh.support == 16.0 and sh.cutoff > sh.support
    assert sh.influence == 16.5 and sh.influence_y == 32.5
    mode2 = ttl.shading_for(tenv.SphereLightSource(**_template(
        ramp_mode=2)), 64, 48, 1.0)
    assert mode2.support == 3.0
    for bad in (dict(capacity=tk.MAX_CAPACITY + 1), dict(tile=0),
                dict(max_relative_y=1e6)):
        kw = dict(dict(tile=64, capacity=48, max_relative_y=0.0), **bad)
        sh = ttl.shading_for(tpl, kw["tile"], kw["capacity"], 1.0,
                             kw["max_relative_y"])
        with pytest.raises(ValueError):
            tk.check_sizes(sh)


def test_wrapper_checks_its_arguments():
    tpl = tenv.SphereLightSource(**_template())
    sh = ttl.shading_for(tpl, 32, 16, 1.0)
    z = torch.zeros((8, 8))
    pos, col = torch.zeros((3, 4)), torch.zeros((3, 4))
    act = torch.ones(3, dtype=torch.bool)
    lo = torch.zeros(())
    normal = torch.zeros((8, 8, 3))
    with pytest.raises(ValueError):  # column_ao without a ColumnField
        tk.tiled_lights_fused(z, z, normal, z, pos, col, act, lo, sh,
                              "column_ao")
    with pytest.raises(ValueError):  # colour of the wrong width
        tk.tiled_lights_fused(z, z, normal, z, pos, col[:, :3], act, lo, sh)
    with pytest.raises(ValueError):  # a plane of the wrong shape
        tk.tiled_lights_fused(z, z[:4], normal, z, pos, col, act, lo, sh)
    out, dropped, deficit = tk.tiled_lights_fused(
        z, z, normal, z, pos, col, act, lo, sh)
    assert out.shape == (8, 8, 4) and int(dropped) == 0


def test_build_is_stale_after_a_header_edit(tmp_path):
    """A library is rebuilt when its source or any header beside it is
    newer than it, and not otherwise."""
    src = tmp_path / "k.cu"
    hdr = tmp_path / "shared.cuh"
    lib = tmp_path / "libk.so"
    now = time.time()
    for path, age in ((src, 30), (hdr, 30)):
        path.write_text("//")
        os.utime(path, (now - age, now - age))
    assert cuda_build.is_stale(src, lib)  # no library yet
    lib.write_text("")
    os.utime(lib, (now - 20, now - 20))
    assert not cuda_build.is_stale(src, lib)
    os.utime(hdr, (now - 10, now - 10))
    assert cuda_build.is_stale(src, lib)
    os.utime(lib, (now, now))
    assert not cuda_build.is_stale(src, lib)
    os.utime(src, (now + 5, now + 5))
    assert cuda_build.is_stale(src, lib)
