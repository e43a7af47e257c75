"""Particle force transforms: Gravity (counterpart of the Gravity part of
illuminant_tpu/particles/transforms.py; Transforms.cs:309-372,
Gravity.fx). FMA, MatrixMultiply, Noise, VectorField and the area
weighting are ROADMAP M13."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.pytree import tensor_dataclass
from .state import SystemUniforms, check_category_filter

MAX_ATTRACTORS = 16  # Gravity.fx:3

FALLOFF_PHYSICAL = 0  # 1/d^2
FALLOFF_LINEAR = 1
FALLOFF_EXPONENTIAL = 2


@tensor_dataclass
class GravityUniforms:
    positions: torch.Tensor  # (A, 3)
    radiuses: torch.Tensor  # (A,)
    strengths: torch.Tensor  # (A,)
    falloff_types: torch.Tensor  # (A,)
    active: torch.Tensor  # (A,)
    maximum_acceleration: torch.Tensor  # ()
    category_filter: torch.Tensor  # (2,)


def apply_gravity(position, velocity, u: GravityUniforms,
                  su: SystemUniforms):
    """Gravity.fx:12-61 over (N, 4) state rows -> (position, velocity)."""
    to_center = u.positions[None, :, :] - position[:, None, :3]  # (N, A, 3)
    dist_sq = torch.sum(to_center * to_center, dim=-1)
    dist = torch.sqrt(torch.clamp(dist_sq, min=1e-12))

    att_linear = 1.0 - torch.clamp(dist / torch.clamp(u.radiuses, min=1e-6),
                                   0.0, 1.0)
    att_exp = att_linear * att_linear
    att_ramped = torch.where(u.falloff_types >= 1.5, att_exp, att_linear)
    att_ramped = att_ramped * su.dt  # Gravity.fx:41
    # Physical falloff has no dt scaling (Gravity.fx:45).
    att_physical = 1.0 / torch.clamp(dist_sq - u.radiuses, min=0.001)
    attraction = torch.where(u.falloff_types >= 0.5, att_ramped,
                             att_physical)
    accel = (to_center / dist[..., None]
             * (attraction * u.strengths * u.active)[..., None])
    accel = torch.sum(accel, dim=1)  # (N, 3)

    max_accel = u.maximum_acceleration * su.dt
    alen = torch.sqrt(torch.clamp(torch.sum(accel * accel, dim=-1),
                                  min=1e-12))
    accel = accel * torch.clamp(max_accel / alen, max=1.0)[:, None]

    live = (position[:, 3] > 0.0) & check_category_filter(
        velocity[:, 3], u.category_filter)
    # Componentwise min with the scalar max velocity (Gravity.fx:58-60).
    new_v = torch.minimum(velocity[:, :3] + accel, su.maximum_velocity)
    new_velocity = torch.cat([new_v, velocity[:, 3:4]], dim=-1)
    return position, torch.where(live[:, None], new_velocity, velocity)


@dataclasses.dataclass
class Attractor:
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 1.0
    strength: float = 1.0
    falloff_type: int = FALLOFF_LINEAR


@dataclasses.dataclass
class Gravity:
    attractors: list = dataclasses.field(default_factory=list)
    maximum_acceleration: float = 1e6
    category_filter: Tuple[float, float] = (-1e9, 1e9)

    def uniforms(self, now: float, device=None) -> GravityUniforms:
        if len(self.attractors) > MAX_ATTRACTORS:
            raise ValueError(
                f"at most {MAX_ATTRACTORS} attractors (Gravity.fx:3)")
        # Padded to a multiple of 2, like the JAX package.
        a = max(-(-len(self.attractors) // 2) * 2, 2)
        pos = np.zeros((a, 3), np.float32)
        rad = np.ones((a,), np.float32)
        stren = np.zeros((a,), np.float32)
        fall = np.zeros((a,), np.float32)
        act = np.zeros((a,), np.float32)
        for i, at in enumerate(self.attractors):
            pos[i] = at.position
            rad[i] = at.radius
            stren[i] = at.strength
            fall[i] = float(at.falloff_type)
            act[i] = 1.0

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        return GravityUniforms(
            positions=f32(pos), radiuses=f32(rad), strengths=f32(stren),
            falloff_types=f32(fall), active=f32(act),
            maximum_acceleration=f32(self.maximum_acceleration),
            category_filter=f32(self.category_filter))
