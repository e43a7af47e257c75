"""Spherical-harmonics GI probes.

Counterpart of illuminant_tpu/lighting/spherical_harmonics.py: the
9-coefficient (l <= 2) basis and cosine-lobe convolution of
SphericalHarmonics.fxh:1-89 and the `GIProbe` host object
(LightProbe.cs:146-152). `project_radiance` builds an SH9Color from
directional radiance samples around a probe, `irradiance` evaluates the
cosine-convolved result for surface normals.

SH layout: a (9, 3) tensor, row r the rgb of coefficient r (the fxh's
SH9Color a..i fields).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# SphericalHarmonics.fxh:3-6.
PI = 3.141592654
COSINE_A0 = PI
COSINE_A1 = (2.0 * PI) / 3.0
COSINE_A2 = PI * 0.25
_COSINE_SCALE = [COSINE_A0] + [COSINE_A1] * 3 + [COSINE_A2] * 5


@dataclasses.dataclass
class GIProbe:
    """Host GI probe (LightProbe.cs:146-152) and its baked coefficients."""

    position: Tuple[float, float, float]
    coefficients: object = None  # (9, 3) once baked


def _cosine_scale(device):
    return torch.tensor(_COSINE_SCALE, dtype=torch.float32, device=device)


def sh9_basis(direction):
    """SHCosineLobe's basis rows (fxh:16-35) without the cosine scale:
    direction (..., 3) -> (..., 9)."""
    x = direction[..., 0]
    y = direction[..., 1]
    z = direction[..., 2]
    return torch.stack([
        torch.full_like(x, 0.282095),
        0.488603 * y,
        0.488603 * z,
        0.488603 * x,
        1.092548 * x * y,
        1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ], dim=-1)


def sh_cosine_lobe(direction):
    """SHCosineLobe + SHScaleByCosine (fxh:16-49): (..., 9)."""
    return sh9_basis(direction) * _cosine_scale(direction.device)


def project_radiance(directions, radiance):
    """Monte-Carlo SH projection (the SH9CAdd9 loop and
    SHScaleColorByCosine, fxh:51-89): directions (N, 3) unit sample
    directions, radiance (N, 3) incoming rgb along each -> SH9Color (9,
    3), cosine-convolved and normalised so that `irradiance` returns the
    diffuse irradiance / pi."""
    n = directions.shape[0]
    coeffs = torch.einsum("nk,nc->kc", sh9_basis(directions),
                          radiance) * (4.0 * PI / n)
    return coeffs * (_cosine_scale(directions.device)[:, None] / PI)


def irradiance(coefficients, normal):
    """SH9CSum9 (fxh:62-74): the SH9Color evaluated for surface normals.
    coefficients (9, 3); normal (..., 3) -> (..., 3)."""
    return torch.einsum("...k,kc->...c", sh9_basis(normal), coefficients)


def fibonacci_sphere(n: int) -> np.ndarray:
    """Uniform unit-sphere sample directions for baking (host numpy)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(phi)], axis=-1).astype(np.float32)


def bake_probe_from_lights(probe_position, sample_radiance_fn,
                           n_samples: int = 128, device="cuda"):
    """Bake a GI probe: sample incoming radiance in `n_samples` directions
    around it (sample_radiance_fn(dirs (N, 3) on `device`) -> (N, 3) rgb)
    and project. Returns the (9, 3) SH9Color."""
    dirs = torch.as_tensor(fibonacci_sphere(n_samples), device=device)
    return project_radiance(dirs, sample_radiance_fn(dirs))
