"""Each particle transform of the port against the JAX package's on one
seeded state: uniforms built by both packages' host classes, then the
device function. Tolerance 1e-5 relative / 1e-4 absolute (elementwise
float32 on both sides; XLA and PyTorch may round a transcendental or a
fused product differently by an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.ops import noise as jnoise
from illuminant_tpu.ops import sdf_primitives as jsp
from illuminant_tpu.ops.bezier import constant_bezier as jconst
from illuminant_tpu.ops.bezier import pack_bezier as jpack
from illuminant_tpu.particles import integrate as jint
from illuminant_tpu.particles import render_data as jrd
from illuminant_tpu.particles import state as jstate
from illuminant_tpu.particles import transforms as jtx
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.ops import noise
from illuminant_tpu_torch.particles import integrate, render_data
from illuminant_tpu_torch.particles import state as tstate
from illuminant_tpu_torch.particles import transforms as tx

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-4)
N = 2048


def _rows(seed=0, n=N):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4), np.float32)
    pos[:, 0] = rng.uniform(-10, 170, n)
    pos[:, 1] = rng.uniform(-10, 106, n)
    pos[:, 2] = rng.uniform(-4, 40, n)
    pos[:, 3] = np.where(rng.uniform(size=n) < 0.8,
                         rng.uniform(0.01, 3.0, n), 0.0)
    vel = np.zeros((n, 4), np.float32)
    vel[:, :3] = rng.normal(0, 60, (n, 3))
    vel[:64, :3] = rng.normal(0, 1e-3, (64, 3))  # near-still particles
    vel[:, 3] = rng.integers(0, 4, n)  # categories 0..3
    color = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    return pos, vel, color


@pytest.fixture(scope="module")
def su():
    j = jstate.SystemUniforms.make(dt=1 / 60, friction=0.1,
                                   maximum_velocity=90.0, life_decay=0.4)
    return j, interop.to_torch(tstate.SystemUniforms,
                               interop.as_numpy_fields(j))


def _area(mod, **kw):
    return mod.TransformArea(type=jsp.TYPE_ELLIPSOID, center=(70.0, 50.0, 8.0),
                             size=(40.0, 25.0, 30.0), falloff=6.0,
                             rotation_z=0.4, **kw)


def _transforms(mod):
    """name -> (transform, apply arguments after (pos, vel, u, su))."""
    turn = np.asarray([[0.9, 0.2, 0.0, 0.0], [-0.2, 0.9, 0.0, 0.0],
                       [0.0, 0.0, 1.1, 0.0], [1.5, -2.0, 0.5, 1.0]],
                      np.float32)
    return {
        "fma": mod.FMA(position_add=(1.0, -2.0, 0.5),
                       velocity_multiply=(0.5, 0.8, 1.2),
                       velocity_add=(3.0, 0.0, -1.0), area=_area(mod),
                       category_filter=(1.0, 2.0)),
        "fma_everywhere_untimed": mod.FMA(position_multiply=(1.01, 0.99, 1.0),
                                          cycles_per_second=None,
                                          strength=0.5),
        "matrix_multiply": mod.MatrixMultiply(
            position_matrix=turn, velocity_matrix=turn.T.copy(),
            area=_area(mod), cycles_per_second=5.0),
        "geometric": mod.GeometricTransform(
            position_pre_translate=(-80.0, -48.0, 0.0),
            position_rotation=(0.1, 0.2, 0.3), position_post_scale=1.02,
            position_post_translate=(80.0, 48.0, 0.0),
            velocity_rotation=(0.0, 0.0, 0.25), velocity_scale=0.9,
            cycles_per_second=None),
        "vector_field": mod.VectorField(
            field=np.random.default_rng(4).uniform(-1, 1, (16, 12, 4))
            .astype(np.float32),
            field_scale=(0.1, 0.07), field_offset=(3.0, -1.0),
            velocity_scale=(40.0, 30.0, 5.0, 2.0), area=_area(mod)),
        "vector_field_replace": mod.VectorField(
            field=np.random.default_rng(5).uniform(-1, 1, (8, 8, 4))
            .astype(np.float32),
            replace_old_velocity=True, category_filter=(0.0, 1.0)),
        "noise": mod.Noise(velocity_scale=(18.0, 18.0, 3.0, 0.5),
                           position_scale=(2.0, 2.0, 0.0, 0.0),
                           position_minimum=(0.1, 0.1, 0.0, 0.0),
                           velocity_minimum=(0.2, 0.0, 0.0, 0.0),
                           replace_old_velocity=False, area=_area(mod),
                           _rng=np.random.default_rng(9)),
        "spatial_noise": mod.spatial_noise(
            velocity_scale=(12.0, 12.0, 0.0, 0.0), space_scale=(7.0, 5.0),
            interval_seconds=0.5, category_filter=(2.0, 3.0),
            _rng=np.random.default_rng(10)),
    }


def _apply(mod, name, t, u, pos, vel, su, field, slot_xy):
    if name.startswith("fma"):
        return mod.apply_fma(pos, vel, u, su)
    if name in ("matrix_multiply", "geometric"):
        return mod.apply_matrix_multiply(pos, vel, u, su)
    if name.startswith("vector_field"):
        return mod.apply_vector_field(pos, vel, u, su)
    fn = mod.apply_spatial_noise if t.spatial else mod.apply_noise
    return fn(pos, vel, u, su, field, slot_xy)


@pytest.fixture(scope="module")
def random_fields():
    jf = jnoise.RandomField.create(jax.random.key(1), height=61, width=83)
    return jf, interop.to_torch(noise.RandomField,
                                interop.as_numpy_fields(jf))


_UNIFORMS = {"fma": tx.FMAUniforms,
             "matrix_multiply": tx.MatrixMultiplyUniforms,
             "geometric": tx.MatrixMultiplyUniforms,
             "vector_field": tx.VectorFieldUniforms,
             "noise": tx.NoiseUniforms}


def _assert_same_uniforms(tu, ju):
    """The port's own uniforms equal the JAX package's field by field."""
    for name, want in interop.as_numpy_fields(ju).items():
        got = getattr(tu, name)
        if isinstance(want, dict):
            _assert_same_uniforms(got, getattr(ju, name))
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("name", sorted(_transforms(tx)))
def test_apply_matches_jax(name, su, random_fields):
    su_j, su_t = su
    jf, tf = random_fields
    pos, vel, _ = _rows(1)
    jt, tt = _transforms(jtx)[name], _transforms(tx)[name]
    slot = np.stack([np.arange(N) % 256.0, np.floor(np.arange(N) / 256.0)],
                    -1).astype(np.float32)
    for now in (0.3, 0.7, 1.9):  # the noise offsets cycle at 0.5 / 1 s
        ju, tu = jt.uniforms(now), tt.uniforms(now, "cpu")
        _assert_same_uniforms(tu, ju)
        # The carried JAX uniforms build the port's class too.
        cls = next(c for k, c in _UNIFORMS.items() if k in name)
        interop.to_torch(cls, interop.as_numpy_fields(ju))
        jp, jv = _apply(jtx, name, jt, ju, jnp.asarray(pos), jnp.asarray(vel),
                        su_j, jf, jnp.asarray(slot))
        tp, tv = _apply(tx, name, tt, tu, torch.as_tensor(pos),
                        torch.as_tensor(vel), su_t, tf, torch.as_tensor(slot))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        assert not (np.array_equal(tp.numpy(), pos)
                    and np.array_equal(tv.numpy(), vel))


def test_trs_matrix_matches_jax():
    for args in [((1.0, 2.0, 3.0), 1.5, (0.1, -0.7, 2.0), (-4.0, 0.0, 9.0),
                  0.5), ((0.0, 0.0, 0.0), 1.0, (0.0, 0.0, 0.0),
                         (0.0, 0.0, 0.0), 1.0)]:
        np.testing.assert_array_equal(tx._trs_matrix(*args),
                                      jtx._trs_matrix(*args))


@pytest.mark.parametrize("type_id", [0, jsp.TYPE_BOX, jsp.TYPE_ELLIPSOID,
                                     jsp.TYPE_CYLINDER])
def test_area_weight_and_category_filter(type_id):
    pos, vel, _ = _rows(2)
    area_j = jtx.TransformArea(type=type_id, center=(80.0, 40.0, 10.0),
                               size=(30.0, 20.0, 15.0), falloff=0.5,
                               rotation_z=-0.3).uniforms(0.75)
    area_t = interop.to_torch(tx.AreaUniforms,
                              interop.as_numpy_fields(area_j))
    own = tx.TransformArea(type=type_id, center=(80.0, 40.0, 10.0),
                           size=(30.0, 20.0, 15.0), falloff=0.5,
                           rotation_z=-0.3).uniforms(0.75)
    _assert_same_uniforms(own, area_j)
    np.testing.assert_allclose(
        tx.area_weight(torch.as_tensor(pos[:, :3]), area_t).numpy(),
        np.asarray(jtx.area_weight(jnp.asarray(pos[:, :3]), area_j)), **TOL)
    flt = np.asarray([1.0, 2.0], np.float32)
    np.testing.assert_array_equal(
        tx._category_mask(torch.as_tensor(vel), torch.as_tensor(flt)).numpy(),
        np.asarray(jtx._category_mask(jnp.asarray(vel), jnp.asarray(flt))))


@pytest.mark.parametrize("category_filter", [(-1e9, 1e9), (1.0, 1.0)])
def test_sensor_measure_matches_jax(category_filter):
    pos, vel, color = _rows(3)
    kw = dict(area=None, category_filter=category_filter)
    js, ts = (m.Sensor(**{**kw, "area": m.TransformArea(
        type=jsp.TYPE_BOX, center=(60.0, 40.0, 0.0),
        size=(30.0, 30.0, 100.0))}) for m in (jtx, tx))
    z = np.zeros((N, 4), np.float32)
    j = jstate.ParticleState(
        position=jnp.asarray(pos), velocity=jnp.asarray(vel),
        color=jnp.asarray(color), render_color=jnp.asarray(z),
        render_data=jnp.asarray(z), write_cursor=jnp.asarray(0, jnp.int32),
        total_spawned=jnp.asarray(0, jnp.int32))
    t = interop.to_torch(tstate.ParticleState, interop.as_numpy_fields(j))
    n = ts.measure(t)
    assert n == js.measure(j) and ts.last_count == n and 0 < n


def _render_uniforms(pack, const, cls, zeros, **extra):
    return cls(
        color_from_life=pack([(0.3, 0.3, 0.6, 0.0), (1.0, 1.0, 1.0, 1.0)],
                             min_value=0.0, max_value=3.0),
        color_from_velocity=const([1.0, 0.9, 0.8, 1.0]),
        size_from_life=pack([[1.0], [2.5], [3.0]], min_value=0.0,
                            max_value=3.0),
        size_from_velocity=const([1.5]),
        rotation_from_life_and_index=zeros((2,)) + 0.25, **extra)


@pytest.mark.parametrize("ramp", ["none", "forward", "inverted"])
def test_integrate_and_render_data_match_jax(su, ramp):
    """The plain Euler integrate and compute_render_data with its life
    ramp and the velocity rotation gate on."""
    su_j, su_t = su
    pos, vel, color = _rows(4)
    extra_j = dict(velocity_rotation=jnp.asarray(0.5, jnp.float32),
                   use_velocity_rotation=True)
    if ramp != "none":
        tex = np.random.default_rng(6).uniform(0, 2, (3, 5, 4)).astype(
            np.float32)
        settings = dict(strength=0.7, minimum=0.2, maximum=2.5,
                        invert=ramp == "inverted", texture_height=4)
        extra_j.update(life_ramp=jnp.asarray(tex),
                       life_ramp_settings=jrd.pack_life_ramp_settings(
                           **settings))
        np.testing.assert_array_equal(
            render_data.pack_life_ramp_settings(**settings).numpy(),
            np.asarray(extra_j["life_ramp_settings"]))
    rd_j = _render_uniforms(jpack, jconst, jrd.RenderDataUniforms, jnp.zeros,
                            **extra_j)
    rd_t = interop.to_torch(render_data.RenderDataUniforms,
                            interop.as_numpy_fields(rd_j))
    assert rd_t.use_velocity_rotation is True
    z = np.zeros((N, 4), np.float32)
    j = jstate.ParticleState(
        position=jnp.asarray(pos), velocity=jnp.asarray(vel),
        color=jnp.asarray(color), render_color=jnp.asarray(z),
        render_data=jnp.asarray(z), write_cursor=jnp.asarray(0, jnp.int32),
        total_spawned=jnp.asarray(0, jnp.int32))
    out_j = jint.integrate(j, su_j, rd_j)
    out_t = integrate.integrate(
        interop.to_torch(tstate.ParticleState, interop.as_numpy_fields(j)),
        su_t, rd_t)
    for name in ("position", "velocity", "render_color", "render_data"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   err_msg=name, **TOL)


def test_friction_and_rotation_helpers_match_jax(su):
    su_j, su_t = su
    _, vel, _ = _rows(5)
    vel[:4, :3] = [[0.0, 0.0, 0.0], [1e-4, 0.0, 0.0], [500.0, 0.0, 0.0],
                   [-3.0, -0.005, 1.0]]
    np.testing.assert_allclose(
        tstate.apply_friction_and_maximum(torch.as_tensor(vel[:, :3]),
                                          su_t).numpy(),
        np.asarray(jstate.apply_friction_and_maximum(
            jnp.asarray(vel[:, :3]), su_j)), **TOL)
    np.testing.assert_allclose(
        render_data.rotation_for_velocity(torch.as_tensor(vel)).numpy(),
        np.asarray(jrd.rotation_for_velocity(jnp.asarray(vel))), **TOL)
