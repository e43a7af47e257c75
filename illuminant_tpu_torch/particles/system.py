"""Particle system configuration and state holder.

Counterpart of the parts of illuminant_tpu/particles/system.py that the
flagship frame uses: `ParticleSystemConfig`, and a `ParticleSystem` that
owns the initial state, the system uniforms and the render-data uniforms.
The frame itself sequences spawn -> gravity -> integrate; the standalone
tick / update / patch API of the JAX class is ROADMAP M5.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .render_data import RenderDataUniforms
from .state import ParticleState, SystemUniforms


@dataclasses.dataclass(frozen=True)
class ParticleSystemConfig:
    """ParticleSystemConfiguration (ParticleConfiguration.cs:187-303,
    subset); the same fields and defaults as the JAX package's, less
    `collision_substeps`, which only the JAX system's own tick reads (the
    tick is ROADMAP M5; the frame takes its substeps from
    `build_flagship`)."""

    capacity: int = 1 << 20
    updates_per_second: float = 60.0
    maximum_update_delta: float = 1.0 / 20.0
    friction: float = 0.0
    maximum_velocity: float = 16384.0
    life_decay_per_second: float = 1.0
    z_to_y: float = 0.0
    z_formula: tuple = None
    size_from_z: float = 0.0
    collision_distance: float = 0.33
    collision_life_penalty: float = 0.0
    escape_velocity: float = 128.0
    bounce_velocity_multiplier: float = 0.0
    collision_maximum_z: float = 1e9


class ParticleSystem:
    """One particle system: its configuration, transforms (spawners and
    forces), field, render-data uniforms and current state on `device`."""

    def __init__(self, config: ParticleSystemConfig,
                 transforms: Optional[List] = None, volume=None,
                 render_data: Optional[RenderDataUniforms] = None,
                 device="cuda"):
        self.config = config
        self.transforms = list(transforms or [])
        self.volume = volume
        self.device = device
        self.render_data = render_data or RenderDataUniforms.defaults(
            device=device)
        self.state = ParticleState.empty(config.capacity, device=device)

    def system_uniforms(self, dt: float) -> SystemUniforms:
        cfg = self.config
        return SystemUniforms.make(
            dt=dt, friction=cfg.friction,
            maximum_velocity=cfg.maximum_velocity,
            life_decay=cfg.life_decay_per_second,
            escape_velocity=cfg.escape_velocity,
            bounce_velocity_multiplier=cfg.bounce_velocity_multiplier,
            collision_distance=cfg.collision_distance,
            collision_life_penalty=cfg.collision_life_penalty,
            z_to_y=cfg.z_to_y, device=self.device)
