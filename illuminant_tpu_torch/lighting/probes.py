"""Light probes: scene lighting sampled at arbitrary world points.

Counterpart of illuminant_tpu/lighting/probes.py (LightingRenderer.
LightProbes.cs, LightProbe.cs): every light is evaluated again at the
probe positions with the lightmap's own cores (the *LightProbe.fx
techniques reuse the light cores with the probe buffer standing in for
the G-buffer). The values stay on the device until the host asks.

Zero probe normals disable directional occlusion, as zero G-buffer
normals do (LightCommon.fxh:129-131). The families add up; per-light
blend modes are the renderer's grouping, not the probes'.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import QualitySettings
from ..core.pytree import tensor_dataclass
from .cone_trace import cone_trace
from .directional import DirectionalLights, compute_directional_opacity
from .environment import EnvironmentUniforms, SphereLights
from .sphere import (SELF_OCCLUSION_HACK, SHADOW_OPACITY_THRESHOLD,
                     compute_ao, compute_sphere_light_opacity)


@tensor_dataclass
class LightProbes:
    """SoA probe collection (LightProbe.cs:9-145): position (P, 3), normal
    (P, 4) with .w the has-normal flag, enable_shadows (P,), active (P,)."""

    position: torch.Tensor
    normal: torch.Tensor
    enable_shadows: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.position.shape[0]


@dataclasses.dataclass
class LightProbe:
    """Host probe; `value` is the caller's to fill (LightProbe.cs:60-120)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    normal: Optional[Tuple[float, float, float]] = None
    enable_shadows: bool = True
    value: Optional[np.ndarray] = None


def pack_probes(probes: List[LightProbe], capacity: Optional[int] = None,
                device="cuda") -> LightProbes:
    """Pack host probes into the SoA tensors, padded to `capacity` with
    inactive probes."""
    n = len(probes)
    cap = capacity or max(n, 1)
    pos = np.zeros((cap, 3), np.float32)
    nrm = np.zeros((cap, 4), np.float32)
    shadows = np.ones((cap,), np.float32)
    active = np.zeros((cap,), np.float32)
    for i, p in enumerate(probes):
        pos[i] = p.position
        if p.normal is not None:
            d = np.asarray(p.normal, np.float32)
            norm = np.linalg.norm(d)
            nrm[i] = [*(d / norm if norm > 0 else d), 1.0]
        shadows[i] = 1.0 if p.enable_shadows else 0.0
        active[i] = 1.0

    def t(a):
        return torch.as_tensor(a, device=device)

    return LightProbes(position=t(pos), normal=t(nrm),
                       enable_shadows=t(shadows), active=t(active))


@tensor_dataclass
class ProbePoints:
    """A (P, 1) G-buffer over arbitrary world points: the line, volumetric
    and projector cores evaluate over it as over a frame, in the modes
    `evaluate_probes` runs them (the march, unshadowed volumetric). It
    offers what those read of a G-buffer: `shape`, `normal`,
    `world_position()`, `enable_shadows`, `fullbright`."""

    position: torch.Tensor  # (P, 3)
    normal: torch.Tensor  # (P, 1, 3)
    enable_shadows: torch.Tensor  # (P, 1)
    fullbright: torch.Tensor  # (P, 1)

    @property
    def shape(self):
        return (self.position.shape[0], 1)

    def world_position(self):
        return self.position[:, None, :]


def _normals(probes: LightProbes):
    return torch.where(probes.normal[:, 3:4] > 0.5, probes.normal[:, :3],
                       0.0)


def probe_points(probes: LightProbes) -> ProbePoints:
    return ProbePoints(
        position=probes.position, normal=_normals(probes)[:, None, :],
        enable_shadows=probes.enable_shadows[:, None],
        fullbright=torch.zeros((probes.capacity, 1), dtype=torch.float32,
                               device=probes.position.device))


def _rgb_and_opacity(color, opacity):
    """sum over lights of color.rgb x color.a x opacity, and of opacity:
    color (L, 1, 4), opacity (L, P) -> (P, 4)."""
    rgb = color[..., :3] * color[..., 3:4] * opacity[..., None]
    return torch.cat([rgb.sum(dim=0), opacity.sum(dim=0)[..., None]], dim=-1)


def evaluate_probes(volume, probes: LightProbes, env: EnvironmentUniforms,
                    quality: QualitySettings,
                    sphere_lights: Optional[SphereLights] = None,
                    directional_lights: Optional[DirectionalLights] = None,
                    line_lights=None, volumetric_lights=None,
                    projector_lights=None):
    """-> (P, 4) HDR light values (UpdateLightProbes, LightProbes.cs:
    49-86): ambient plus every light family given, accumulated with the
    cores the lightmap uses. Sphere and directional lights run the exact
    cone march; line lights their 3-ray march."""
    pos = probes.position
    normal = _normals(probes)
    value = env.ambient.to(torch.float32).expand(pos.shape[0], 4)

    if sphere_lights is not None:
        lc = sphere_lights.position[:, None, :]  # (L, 1, 3)
        props = sphere_lights.properties[:, None, :]
        more = sphere_lights.more[:, None, :]
        active = sphere_lights.active[:, None]
        op = compute_sphere_light_opacity(pos[None], normal[None], lc, props,
                                          more[..., 2], env.light_occlusion)
        visible = op > 0.0
        ao_radius = more[..., 0] * torch.clamp(normal[None, ..., 2], min=0.0)
        ao = compute_ao(volume, pos[None], normal[None], ao_radius,
                        more[..., 3], visible)
        pre = op * ao
        enable = (visible
                  & (props[..., 3] * probes.enable_shadows[None] > 0.0)
                  & (pre >= SHADOW_OPACITY_THRESHOLD) & (active > 0.0))
        cone = cone_trace(volume, lc, props[..., 0], props[..., 1],
                          pos[None] + SELF_OCCLUSION_HACK * normal[None],
                          enable, quality)
        opacity = torch.where(visible, pre * cone, 0.0) * active
        value = value + _rgb_and_opacity(sphere_lights.color[:, None, :],
                                         opacity)

    if directional_lights is not None:
        d = directional_lights.direction[:, None, :]
        props = directional_lights.properties[:, None, :]
        active = directional_lights.active[:, None]
        op = compute_directional_opacity(d, normal[None])
        enable = ((props[..., 0] * probes.enable_shadows[None] > 0.0)
                  & (d[..., 3] >= 0.1) & (active > 0.0))
        fake_center = pos[None] - d[..., :3] * props[..., 1:2]
        cone = cone_trace(
            volume, fake_center, props[..., 2],
            torch.clamp(directional_lights.more[:, None, 1], min=16.0)
            / torch.clamp(props[..., 3], min=1e-3),
            pos[None] + 1.5 * normal[None], enable, quality)
        opacity = op * cone * active
        value = value + _rgb_and_opacity(
            directional_lights.color[:, None, :], opacity)

    if (line_lights is not None or volumetric_lights is not None
            or projector_lights is not None):
        pts = probe_points(probes)
        if line_lights is not None:
            from .line import accumulate_line_lights

            value = value + accumulate_line_lights(
                volume, pts, line_lights, env, quality)[:, 0, :]
        if volumetric_lights is not None:
            from .volumetric import accumulate_volumetric_lights

            value = value + accumulate_volumetric_lights(
                volume, pts, volumetric_lights, env, quality)[:, 0, :]
        if projector_lights is not None:
            from .projector import accumulate_projector_lights

            value = value + accumulate_projector_lights(
                volume, pts, projector_lights, env, quality)[:, 0, :]

    return value * probes.active[:, None]
