"""Incremental voxel-field updates of the port against the JAX package:
`update_slices`, `invalid_slices_for_bounds` and the budgeted
regeneration (the cases of tests/test_dynamic_budget.py), on the same
obstruction sets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.ops import sdf_primitives as JP
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.ops import sdf_primitives as P
from illuminant_tpu_torch.sdf import sampling
from illuminant_tpu_torch.sdf import volume as vol

torch.set_num_threads(1)


def _cfg(mod, slices=12):
    return mod.SdfVolumeConfig(
        virtual_width=128, virtual_height=128, virtual_depth=96.0,
        slice_count=slices, resolution_scale=0.25,
        max_encoded_distance=64.0)


def _obs(n_dyn, z=40.0, x0=20.0, shift=(0.0, 0.0, 0.0)):
    """The same ellipsoid row as JAX and port obstruction sets."""
    types = [P.TYPE_ELLIPSOID] * n_dyn
    centers = [(x0 + 8.0 * i + shift[0], 64.0 + shift[1], z + shift[2])
               for i in range(n_dyn)]
    sizes = [(6.0, 6.0, 6.0)] * n_dyn
    cap = max(n_dyn, 16)
    assert P.TYPE_ELLIPSOID == JP.TYPE_ELLIPSOID
    return (jvol.SdfObstructions.from_lists(types, centers, sizes,
                                            capacity=cap),
            vol.SdfObstructions.from_lists(types, centers, sizes,
                                           capacity=cap, device="cpu"))


def test_empty_volume_and_obstructions_match_jax():
    cj, ct = _cfg(jvol), _cfg(vol)
    ej, et = jvol.SdfVolume.empty(cj), vol.SdfVolume.empty(ct, device="cpu")
    np.testing.assert_array_equal(et.data.numpy(), np.asarray(ej.data))
    assert float(et.max_valid_z) == float(ej.max_valid_z) == 0.0
    assert et.data.shape == ct.shape == (12, 32, 32)
    oj = jvol.SdfObstructions.empty(5)
    ot = vol.SdfObstructions.empty(5, device="cpu")
    for name in ("types", "centers", "sizes", "rotations"):
        np.testing.assert_array_equal(getattr(ot, name).numpy(),
                                      np.asarray(getattr(oj, name)), name)
    carried = interop.to_torch(vol.SdfObstructions,
                               interop.as_numpy_fields(oj))
    assert carried.types.dtype == torch.int32


def test_update_slices_matches_jax_and_leaves_its_input():
    cj, ct = _cfg(jvol), _cfg(vol)
    oj, ot = _obs(3)
    ej, et = jvol.SdfVolume.empty(cj), vol.SdfVolume.empty(ct, device="cpu")
    before = et.data.clone()
    slab_t = vol.generate_slab(ct, ot, 4, 3)
    out = vol.update_slices(et, 4, slab_t)
    ref = jvol.update_slices(ej, 4, jvol.generate_slab(cj, oj, 4, 3))
    # The slab differs from the JAX one by the rounding of the ellipsoid
    # distance (an ulp or two of values up to 49); the untouched slices are
    # the empty field's exactly.
    np.testing.assert_allclose(out.data.numpy(), np.asarray(ref.data),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.data[:4].numpy(), 64.0)
    np.testing.assert_array_equal(out.data[4:7].numpy(), slab_t.numpy())
    np.testing.assert_array_equal(et.data.numpy(), before.numpy())
    assert out.data.data_ptr() != et.data.data_ptr()
    # A tensor start is read and checked like an int.
    again = vol.update_slices(et, torch.tensor(4), slab_t)
    np.testing.assert_array_equal(again.data.numpy(), out.data.numpy())


@pytest.mark.parametrize("start", [-1, 10, 12, torch.tensor(11)])
def test_update_slices_raises_when_the_slab_does_not_fit(start):
    """A tensor slice assignment would not clamp a start as
    dynamic_update_slice does, and the clamp is a fault anyway: every
    start that does not fit raises."""
    ct = _cfg(vol)
    et = vol.SdfVolume.empty(ct, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        vol.update_slices(et, start, torch.zeros((3, 32, 32)))


def test_generate_slices_at_equals_the_slab():
    """One slice at a tensor index is the slab's slice bit for bit (in
    the JAX package the traced z rounds ~2e-5 away from the static one)."""
    ct = _cfg(vol)
    _, ot = _obs(4)
    slab = vol.generate_slab(ct, ot, 0, ct.slice_count)
    for i in (0, 5, 11):
        one = vol._generate_slices_at(ct, ot, torch.tensor(i))
        assert one.shape == (1, 32, 32)
        np.testing.assert_array_equal(one[0].numpy(), slab[i].numpy())


def test_invalidation_marks_only_band():
    cj, ct = _cfg(jvol), _cfg(vol)
    oj, ot = _obs(1, z=40.0)
    mask = vol.invalid_slices_for_bounds(ct, ot, band=4.0).numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(jvol.invalid_slices_for_bounds(cj, oj, band=4.0)))
    zs = np.arange(ct.slice_count) * ct.slice_z_size
    np.testing.assert_array_equal(
        mask, np.abs(zs - 40.0) <= np.sqrt(3 * 6.0 ** 2) + 4.0)
    assert mask.any() and not mask.all()
    # Inactive pads mark nothing.
    assert not vol.invalid_slices_for_bounds(
        ct, vol.SdfObstructions.empty(4, device="cpu"), band=1e3).any()


def test_budgeted_regen_converges_to_full():
    """After ceil(n_invalid / budget) calls on a set that stands still the
    budgeted volume is the one-shot regeneration, bit for bit in the port
    (the JAX package's agrees to 1e-4), with the same masks on the way as
    the JAX package's."""
    cj, ct = _cfg(jvol), _cfg(vol)
    oj_a, ot_a = _obs(8, z=40.0)
    oj_b, ot_b = _obs(8, z=40.0, shift=(15.0, -10.0, 0.0))
    v = vol.generate_volume(ct, ot_a)
    vj = jvol.generate_volume(cj, oj_a)
    full_b = vol.generate_volume(ct, ot_b)

    budget = 3
    # Every slice whose values changed: an unclipped voxel is within
    # (192/255) m of a surface.
    band = (192.0 / 255.0) * ct.max_encoded_distance + 1e-3
    invalid = (vol.invalid_slices_for_bounds(ct, ot_a, band=band)
               | vol.invalid_slices_for_bounds(ct, ot_b, band=band))
    invalid_j = (jvol.invalid_slices_for_bounds(cj, oj_a, band=band)
                 | jvol.invalid_slices_for_bounds(cj, oj_b, band=band))
    n_invalid = int(invalid.sum())
    assert n_invalid > budget
    step_j = jax.jit(lambda v_, inv: jvol.regenerate_invalid_budgeted(
        v_, oj_b, inv, budget))
    frames = -(-n_invalid // budget)
    for f in range(frames):
        v, invalid = vol.regenerate_invalid_budgeted(v, ot_b, invalid, budget)
        vj, invalid_j = step_j(vj, invalid_j)
        np.testing.assert_array_equal(invalid.numpy(), np.asarray(invalid_j))
        np.testing.assert_allclose(v.data.numpy(), np.asarray(vj.data),
                                   rtol=0, atol=1e-4)
        if f == 0:
            assert int(invalid.sum()) == n_invalid - budget
            assert not torch.equal(v.data, full_b.data)  # still stale
    assert int(invalid.sum()) == 0
    assert torch.equal(v.data, full_b.data)


def test_staleness_is_old_field_not_garbage():
    """Slices not yet regenerated hold the previous field exactly, and the
    volume passed in is not written."""
    ct = _cfg(vol)
    _, ot_a = _obs(2, z=30.0)
    _, ot_b = _obs(2, z=30.0, shift=(25.0, 0.0, 0.0))
    v0 = vol.generate_volume(ct, ot_a)
    keep = v0.data.clone()
    invalid = vol.invalid_slices_for_bounds(ct, ot_b, band=2.0)
    v1, inv1 = vol.regenerate_invalid_budgeted(v0, ot_b, invalid, budget=1)
    still = (invalid & inv1).numpy()
    regen = (invalid & ~inv1).numpy()
    assert regen.sum() == 1 and still.sum() >= 1
    d0, d1 = v0.data.numpy(), v1.data.numpy()
    np.testing.assert_array_equal(d0, keep.numpy())
    np.testing.assert_array_equal(d1[still], d0[still])
    np.testing.assert_array_equal(d1[~invalid.numpy()],
                                  d0[~invalid.numpy()])
    assert np.abs(d1[regen] - d0[regen]).max() > 1.0  # it moved
    assert regen.argmax() == invalid.numpy().argmax()  # lowest index first


@pytest.mark.parametrize("n_dyn", [2, 8, 16])
def test_budget_bounds_work_per_frame(n_dyn):
    """The slices regenerated in a call are the budget, whatever the
    number of dynamic obstructions."""
    ct = _cfg(vol, slices=16)
    _, ot = _obs(n_dyn, z=48.0)
    v = vol.generate_volume(ct, ot)
    invalid = torch.ones((ct.slice_count,), dtype=torch.bool)
    _, inv1 = vol.regenerate_invalid_budgeted(v, ot, invalid, budget=4)
    assert int(invalid.sum()) - int(inv1.sum()) == 4
    np.testing.assert_array_equal(inv1.numpy(), np.arange(16) >= 4)


def test_no_invalid_is_a_noop():
    ct = _cfg(vol)
    _, ot = _obs(1)
    _, moved = _obs(1, shift=(50.0, 50.0, 50.0))
    v = vol.generate_volume(ct, ot)
    v2, inv = vol.regenerate_invalid_budgeted(
        v, moved, torch.zeros((ct.slice_count,), dtype=torch.bool), budget=4)
    np.testing.assert_array_equal(v2.data.numpy(), v.data.numpy())
    assert not bool(inv.any())


def test_partial_volume_carries_across_with_its_max_valid_z():
    """An SdfVolume whose regeneration stopped half way (max_valid_z below
    the top) carried from the JAX package samples like the JAX one: the
    clamp to max_valid_z is part of the sample."""
    from illuminant_tpu.sdf import sampling as jsampling

    cj = _cfg(jvol)
    oj, _ = _obs(3, z=60.0)
    part = jvol.update_slices(jvol.SdfVolume.empty(cj), 0,
                              jvol.generate_slab(cj, oj, 0, 6))
    part = part.replace(max_valid_z=jnp.asarray(6 * cj.slice_z_size,
                                                jnp.float32))
    carried = interop.to_torch(vol.SdfVolume, interop.as_numpy_fields(part))
    assert float(carried.max_valid_z) == 48.0
    assert carried.config == _cfg(vol)
    rng = np.random.default_rng(0)
    p = rng.uniform(-10.0, 140.0, (2000, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-5.0, 100.0, 2000)
    np.testing.assert_allclose(
        sampling.sample(carried, torch.as_tensor(p)).numpy(),
        np.asarray(jsampling.sample(part, jnp.asarray(p))), rtol=0,
        atol=1e-4)
