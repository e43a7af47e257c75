"""The work of one K12 march on given rays, counted with the plain
reference's march (`framebench/reference/march.py`) on those rays, so that
the count is the same whatever implements K12 (as `chip_smoke.py:
_cone_trace_row` counts it):

  bytes       the rays' distinct inputs read once: each light's centre,
              radius and ramp (float32), each point's origin (3 float32),
              each ray's enable flag (a byte); the field's primitives
              (type, centre, size: 7 float32 each); the (L, P) float32
              visibility written once;
  operations  the reference's pointwise operations with no step (the
              trace config and the epilogue, over every ray), plus those
              of one step (a march of one step less one of none, per ray)
              less its masking (MASK_OPS: a dead ray leaves its loop),
              times the steps the reference's enabled rays took.
"""

import torch

from framebench.metrics._k5_work import pointwise_ops
from framebench.reference import march

# The plain loop's masking, per ray and step, that a ray-per-thread march
# does not need: the three torch.where (steps, visibility, offset) and the
# `live &` of the liveness update (chip_smoke.py's MARCH_MASK_OPS).
MASK_OPS = 4
FIELD_FLOATS = 7


def march_work(scene, center, radius, ramp, origin, enable, quality):
    """(bytes, operations) of the march of the rays (`march.march`'s
    arguments)."""
    lights = center.shape[0]
    points = enable[0].numel()
    n = lights * points
    n_bytes = (lights * 4.0 * (3 + 1 + 1) + points * 4.0 * 3 + n * 1.0
               + len(scene.primitives) * 4.0 * FIELD_FLOATS + n * 4.0)
    rays = dict(center=center, radius=radius, ramp=ramp, origin=origin,
                enable=enable)
    with torch.no_grad():
        _, steps = march.march(scene, quality=quality, **rays)
        taken = float(torch.where(enable, quality["max_step_count"] - steps,
                                  0.0).double().sum())
        ops0 = pointwise_ops(lambda: march.march(
            scene, quality=dict(quality, max_step_count=0), **rays))
        ops1 = pointwise_ops(lambda: march.march(
            scene, quality=dict(quality, max_step_count=1), **rays))
    per_step = (ops1 - ops0) / n - MASK_OPS
    return n_bytes, ops0 + per_step * taken
