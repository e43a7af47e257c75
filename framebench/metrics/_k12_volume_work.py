"""The work of one K12 march through a voxel volume on given rays, counted
as `_k12_work.py` counts the march on the analytic field (with the plain
reference's march, here through the renderer reference's trilinear
sample, `VolumeField.distance`), so that the count is the same whatever
implements K12. The field's bytes are the volume read once as K12 reads
it: packed, 16 bytes a texel (each texel's 2 x 2 taps). A step's
operations include the trilinear sample's."""

from framebench.metrics import _k12_work

TEXEL_BYTES = 16


class _Sampled:
    """The volume as `_k12_work` takes a field: no primitive records (the
    volume's bytes are added here), its distance the trilinear sample."""

    primitives = ()

    def __init__(self, field):
        self.distance = field.distance


def march_work(field, center, radius, ramp, origin, enable, quality):
    """(bytes, operations) of the march of the rays (`march.march`'s
    arguments) through `field` (a `VolumeField`)."""
    n_bytes, n_ops = _k12_work.march_work(
        _Sampled(field), center, radius, ramp, origin, enable, quality)
    return n_bytes + field.data.numel() * float(TEXEL_BYTES), n_ops
