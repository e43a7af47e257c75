"""Spawn-value formulas (counterpart of illuminant_tpu/particles/formula.py).

Device side: evaluateFormula and the random-normal generation of
SpawnerCommon.fxh:34-104; host side: Formula1/3/4 (Formula.cs) — value =
constant + f(random_scale, offset, randomness) of type linear, spherical,
towards or rectangular.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

FORMULA_LINEAR = 0
FORMULA_SPHERICAL = 1
FORMULA_TOWARDS = 2
FORMULA_RECTANGULAR = 3

_SQRT2 = 1.41421356237


def generate_random_normal3(randomness_xy, axis_mask):
    """Sphere point picking (SpawnerCommon.fxh:47-57), axis-masked and
    normalized (:72)."""
    phi = randomness_xy[..., 0] * (2.0 * math.pi)
    cos_theta = (randomness_xy[..., 1] - 0.5) * 2.0
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    n = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                     cos_theta], dim=-1)
    n = n * axis_mask
    norm = torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                  min=1e-12))
    return n / norm


def evaluate_formula(origin, constant, scale, offset, randomness, ftype,
                     axis_mask):
    """evaluateFormula (SpawnerCommon.fxh:59-104), branchless. (..., 4)
    operands; ftype a 0-d tensor; .w is always the linear form."""
    non_circular = (randomness + offset) * scale
    type0 = constant + non_circular

    rn = generate_random_normal3(randomness[..., :2], axis_mask)
    circular = rn * randomness[..., 2:3] * scale[..., :3]
    spherical = constant[..., :3] + circular + rn * offset[..., :3]

    edge = torch.abs(offset[..., :3])
    rect = torch.minimum(torch.maximum(offset[..., :3] * rn * _SQRT2, -edge),
                         edge)
    rectangular = rect + constant[..., :3] + circular

    to = constant[..., :3] - origin[..., :3]
    dist = torch.sqrt(torch.clamp(torch.sum(to * to, dim=-1, keepdim=True),
                                  min=1e-12))
    direction = to / dist
    towards = (randomness[..., 0:1] * scale[..., :3] * direction
               + offset[..., :3] * direction)
    towards = torch.where(dist < 0.1, 0.0, towards)

    t = torch.abs(torch.floor(ftype)).to(torch.int32)
    xyz = torch.where(
        t == FORMULA_SPHERICAL, spherical,
        torch.where(t == FORMULA_RECTANGULAR, rectangular,
                    torch.where(t == FORMULA_TOWARDS, towards,
                                type0[..., :3])))
    w = torch.where(t == FORMULA_TOWARDS,
                    torch.broadcast_to(constant[..., 3:4],
                                       type0[..., 3:4].shape),
                    type0[..., 3:4])
    return torch.cat([xyz, w], dim=-1)


@dataclasses.dataclass
class Formula1:
    """Scalar spawn distribution (Formula.cs Formula1)."""

    constant: float = 0.0
    random_scale: float = 0.0
    offset: float = 0.0


@dataclasses.dataclass
class Formula3:
    """Vector3 spawn distribution."""

    constant: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    random_scale: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    type: int = FORMULA_LINEAR

    @staticmethod
    def unit_normal(scale=1.0):
        """Formula.cs UnitNormal preset: random unit vector * scale."""
        return Formula3(random_scale=(scale,) * 3, type=FORMULA_SPHERICAL)


@dataclasses.dataclass
class Formula4:
    """Vector4 spawn distribution (color)."""

    constant: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    random_scale: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    offset: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
