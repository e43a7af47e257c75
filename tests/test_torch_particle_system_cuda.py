"""A ParticleSystem on a ColumnField on the card against the same system
on the CPU.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_particle_system_cuda.py

Here, without a card, the `cuda` case skips and the CPU case checks that
the small system reaches the collision outcomes the card case compares.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from illuminant_tpu_torch.particles.integrate import BOUNCE_DELAY


def _draws():
    return cs.spawn_draws(cs.small_particle_systems("column_field", "cpu"),
                          cs.PARTICLE_TICKS)


def test_column_field_system_collides_on_the_cpu():
    """The small ColumnField system of `chip_smoke.py`: after 10 ticks
    some particles have collided (their bounce-delay counter is set) and
    some have not."""
    (system,), img, _ = cs.run_small_particles("column_field", "cpu",
                                               _draws())
    vel_w = system.state.velocity[:, 3].numpy()
    live = system.state.live_mask().numpy()
    assert 0 < (vel_w[live] == BOUNCE_DELAY).sum() < live.sum()
    assert img.shape == (cs.PARTICLE_SMALL["height"],
                         cs.PARTICLE_SMALL["width"], 4) and img.sum() > 0


@pytest.mark.cuda
def test_cuda_column_field_system_matches_cpu():
    """10 ticks from the same host draws and Noise field: the fused
    query launches 5
    times a tick (collision at 3 substeps), the live masks are equal and
    99% of live particles agree within 1e-3 (a particle within the float
    rounding of a collision threshold may resolve the other way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the column kernels have no CPU build")
    draws = _draws()
    (cpu,), img_c, _ = cs.run_small_particles("column_field", "cpu", draws)
    (cuda,), img_g, launches = cs.run_small_particles(
        "column_field", "cuda", draws, [cpu.random_field.data])
    assert launches == 5 * cs.PARTICLE_TICKS
    a, b = cpu.state.position.numpy(), cuda.state.position.cpu().numpy()
    live = a[:, 3] > 0
    np.testing.assert_array_equal(live, b[:, 3] > 0)
    err = np.abs(a[live] - b[live]).max(axis=1)
    assert (err <= 1e-3).mean() >= 0.99
    assert np.abs(img_g - img_c).mean() <= 0.01 * np.abs(img_c).mean()
