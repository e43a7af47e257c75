"""Small geometry helpers (counterpart of illuminant_tpu/ops/coords.py,
only what the particle path, the particle lights and the G-buffer
billboards use)."""

from __future__ import annotations

import math

import torch


def decode_normal_spherical(enc):
    """(..., 2) spherical encoding in [0, 1] -> (..., 3) normals
    (EnvironmentCommon.fxh:34-52); the all-zero encoding decodes to the
    zero vector ("no normal")."""
    ang = enc * 2.0 - 1.0
    s = torch.sin(ang[..., 0] * math.pi)
    c = torch.cos(ang[..., 0] * math.pi)
    z = ang[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    n = torch.stack([c * r, s * r, z], dim=-1)
    is_zero = torch.all(enc == 0.0, dim=-1, keepdim=True)
    return torch.where(is_zero, 0.0, n)


def mul_point_rows(v4, matrix):
    """mul(float4(v.xyz, 1), M) keeping the original w — the row-vector
    point transform of the spawners (SpawnerCommon.fxh:166-180). Written
    as row combinations, like the JAX package, so the float32 arithmetic
    is the same elementwise chain on both sides."""
    out = (v4[:, 0:1] * matrix[0, :3]
           + v4[:, 1:2] * matrix[1, :3]
           + v4[:, 2:3] * matrix[2, :3]
           + matrix[3, :3])
    return torch.cat([out, v4[:, 3:4]], dim=-1)


def stipple_keep(count_or_slots, factor, offset=0.0, device=None):
    """StippleReject keep mask (RasterizeParticleSystem.fx:101-110): a
    deterministic golden-ratio fraction of the slots. `count_or_slots`: a
    count (slots 0..count-1 on `device`) or a tensor of slot indices."""
    slots = (torch.arange(count_or_slots, dtype=torch.float32, device=device)
             if isinstance(count_or_slots, int)
             else count_or_slots.to(torch.float32))
    return torch.remainder(slots * 0.6180339887 + offset, 1.0) < factor
