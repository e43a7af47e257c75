"""ParticleSystem: the host orchestrator and its per-tick step.

Counterpart of illuminant_tpu/particles/system.py (ParticleSystem.cs:338 —
Update :634, Reset :518, LiveCount :293, Render :943). A tick runs the
reference's pass sequence: spawners first (:725-741), then the non-spawn
transforms in order (:800-817), then the integrator (:834-855). The JAX
package traces that sequence into one jitted program; here it is an
ordered list of steps built at construction and at `patch`, run on the
system's device (on the card the spawn, the modifier chain and the
integrate are one kernel launch each: K4b, K4c, K4; on the CPU they run
eagerly). The fixed-timestep accumulator of `update`
(ParticleSystem.cs:634-665) runs on the host.

Randomness: the JAX system draws each tick's spawn randomness from
threefry keys, which PyTorch cannot reproduce. The port draws from a
torch.Generator on the system's device seeded from `seed` (`reset`
re-seeds it), or takes the draws from the caller: `tick(dt,
spawn_uniforms=...)` with one triple of (spawn_max, 4) arrays per spawner,
in spawner order. The host streams (spawn counts, Noise offsets) are the
JAX package's own numpy streams.

A tick reads nothing back from the device: spawn counts are host ints and
each transform's uniforms are uploaded only when they change. The spawn
writes its window into the current state's tensors in place (the JAX step
donates them); copy `system.state` to keep one tick's values.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.trace import span
from ..core.upload import upload
from ..ops.noise import RandomField
from . import spawner as spawner_mod
from . import transforms as tx
from .integrate import integrate, integrate_with_distance_field
from .render_data import RenderDataUniforms
from .state import ParticleState, SystemUniforms


@dataclasses.dataclass(frozen=True)
class ParticleSystemConfig:
    """ParticleSystemConfiguration (ParticleConfiguration.cs:187-303,
    subset); the same fields and defaults as the JAX package's."""

    capacity: int = 1 << 20
    updates_per_second: float = 60.0
    maximum_update_delta: float = 1.0 / 20.0
    friction: float = 0.0
    maximum_velocity: float = 16384.0
    life_decay_per_second: float = 1.0
    z_to_y: float = 0.0
    # Render-Z controls (ParticleConfiguration.cs:282-287), read by
    # `render`: screen_z = dot(z_formula, (x, y, z, 1)) orders alpha
    # compositing; size *= max(0, 1 + z * size_from_z).
    z_formula: tuple = None
    size_from_z: float = 0.0
    collision_distance: float = 0.33
    collision_life_penalty: float = 0.0
    escape_velocity: float = 128.0
    bounce_velocity_multiplier: float = 0.0
    collision_maximum_z: float = 1e9
    # Sphere-trace substeps of the collision integrate (MAX_STEP_COUNT=3,
    # UpdateParticleSystemWithDistanceField.fx:12).
    collision_substeps: int = 3


class ParticleSystem:
    """One particle system on `device`; transforms (spawners included) are
    fixed at construction and replaced through `patch`."""

    def __init__(self, config: ParticleSystemConfig,
                 transforms: Optional[List] = None, seed: int = 0,
                 volume=None, render_data: Optional[RenderDataUniforms] = None,
                 device="cuda"):
        self.config = config
        self.transforms = list(transforms or [])
        self.volume = volume
        self.device = torch.device(device)
        self.seed = seed
        self.render_data = self._auto_rotation_gate(
            render_data or RenderDataUniforms.defaults(device=self.device))
        self.random_field = RandomField.create(
            torch.Generator(self.device).manual_seed(seed ^ 0x5EED),
            device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.state = ParticleState.empty(config.capacity, device=self.device)
        self._uniforms_key = None
        self._tick_index = 0
        self._time = 0.0
        self._update_error = 0.0
        self._step = self._build_step()

    @staticmethod
    def _auto_rotation_gate(rd: RenderDataUniforms) -> RenderDataUniforms:
        """Turn the static velocity -> rotation gate on where the uniform
        is nonzero (one host read, at construction and at `patch`)."""
        if (not rd.use_velocity_rotation and rd.velocity_rotation is not None
                and float(rd.velocity_rotation) != 0.0):
            return rd.replace(use_velocity_rotation=True)
        return rd

    # -- step construction -------------------------------------------------

    @property
    def spawners(self):
        return [t for t in self.transforms if getattr(t, "is_spawner", False)]

    @property
    def modifiers(self):
        return [t for t in self.transforms
                if not getattr(t, "is_spawner", False)]

    @staticmethod
    def _modifier_kind(t) -> str:
        """Dispatch kind by isinstance, so that a subclass of a transform
        runs as its base (GeometricTransform as MatrixMultiply)."""
        for cls, kind in ((tx.Sensor, "Sensor"), (tx.FMA, "FMA"),
                          (tx.Gravity, "Gravity"),
                          (tx.VectorField, "VectorField"),
                          (tx.Noise, "Noise"),
                          (tx.MatrixMultiply, "MatrixMultiply")):
            if isinstance(t, cls):
                return kind
        raise TypeError(f"unknown transform kind {type(t).__name__}")

    def _build_step(self):
        """The tick's ordered modifier list: (transform, eager function)
        for each non-spawn transform, which `transforms.apply_modifiers`
        runs with the transform's uniforms; a Sensor has none (it is
        measured on demand)."""
        apply = {
            "FMA": tx.apply_fma,
            "MatrixMultiply": tx.apply_matrix_multiply,
            "Gravity": tx.apply_gravity,
            "VectorField": tx.apply_vector_field,
        }
        steps = []
        for t in self.modifiers:
            kind = self._modifier_kind(t)
            if kind == "Sensor":
                continue
            if kind == "Noise":
                steps.append((t, tx.apply_spatial_noise if t.spatial
                              else tx.apply_noise))
            else:
                steps.append((t, apply[kind]))
        return steps

    # -- public surface -----------------------------------------------------

    def system_uniforms(self, dt: float) -> SystemUniforms:
        """The uniforms of a step of `dt` on the system's device, uploaded
        once per (dt, config)."""
        cfg = self.config
        if self._uniforms_key != (dt, cfg):
            host = SystemUniforms.make(
                dt=dt, friction=cfg.friction,
                maximum_velocity=cfg.maximum_velocity,
                life_decay=cfg.life_decay_per_second,
                escape_velocity=cfg.escape_velocity,
                bounce_velocity_multiplier=cfg.bounce_velocity_multiplier,
                collision_distance=cfg.collision_distance,
                collision_life_penalty=cfg.collision_life_penalty,
                z_to_y=cfg.z_to_y, device="cpu")
            self._uniforms = SystemUniforms(*(
                upload(v.numpy(), self.device)
                for v in (host.global_settings, host.collision_settings,
                          host.animation_and_rotation)))
            self._uniforms_key = (dt, cfg)
        return self._uniforms

    @span("illuminant/particles/tick")
    def tick(self, dt: float, spawn_uniforms: Optional[Sequence] = None):
        """Run exactly one fixed step of length dt. `spawn_uniforms`: one
        triple of (spawn_max, 4) uniform arrays per spawner, in spawner
        order, used instead of the system's generator."""
        spawners = self.spawners
        if spawn_uniforms is not None and len(spawn_uniforms) != len(
                spawners):
            raise ValueError(f"spawn_uniforms has {len(spawn_uniforms)} "
                             f"entries for {len(spawners)} spawners")
        su = self.system_uniforms(dt)
        now = self._time
        dev = self.device
        state = self.state
        for i, s in enumerate(spawners):
            count = s.begin_tick(now, dt)
            draws = dict(generator=self.generator) if spawn_uniforms is None \
                else dict(uniforms=spawn_uniforms[i])
            if getattr(s, "is_feedback", False):
                self_feed = s.source is None or s.source is self
                u = s.feedback_uniforms(now, dev)
                s.advance_window(count, fallback_capacity=self.config.capacity)
                if count:
                    state = spawner_mod.spawn_feedback(
                        state, state if self_feed else s.source.state, u,
                        count, s.spawn_max, time=now, **draws)
            elif count:
                state = spawner_mod.spawn(state, s.uniforms(now, dev), count,
                                          s.spawn_max, time=now, **draws)

        with span("illuminant/particles/transforms"):
            pos, vel = tx.apply_modifiers(
                state.position, state.velocity,
                [(apply, t.uniforms(now, dev)) for t, apply in self._step],
                su, self.random_field)
        state = state.replace(position=pos, velocity=vel)

        cfg = self.config
        if self.volume is not None:
            state = integrate_with_distance_field(
                state, su, self.render_data, self.volume,
                cfg.collision_maximum_z, substeps=cfg.collision_substeps)
        else:
            state = integrate(state, su, self.render_data)
        self.state = state
        self._tick_index += 1
        self._time += dt

    @span("illuminant/particles/update")
    def update(self, delta_time_seconds: float,
               spawn_uniforms: Optional[Sequence] = None) -> int:
        """Frame update with fixed-timestep accumulation
        (ParticleSystem.cs:634-665) -> the number of ticks run.
        `spawn_uniforms`: one `tick` entry per tick run, in order."""
        cfg = self.config
        if cfg.updates_per_second <= 0:
            steps, step_dt = 1, min(delta_time_seconds,
                                    cfg.maximum_update_delta)
        else:
            step_dt = 1.0 / cfg.updates_per_second
            # Clamp the incoming delta only: the carried error must be
            # able to reach a full step (15 ups under a 50 ms cap).
            accumulated = (min(delta_time_seconds, cfg.maximum_update_delta)
                           + self._update_error)
            steps = int(accumulated / step_dt)
            # Bound the carried error to one step (spiral-of-death guard).
            self._update_error = min(accumulated - steps * step_dt, step_dt)
        for i in range(steps):
            self.tick(step_dt, None if spawn_uniforms is None
                      else spawn_uniforms[i])
        return steps

    def reset(self):
        """Clear (ParticleSystem.cs:518). A reset system reproduces its
        seeded run: the generator re-seeds and every spawner re-seeds its
        rate stream."""
        self.state = ParticleState.empty(self.config.capacity,
                                         device=self.device)
        self._time = 0.0
        self._update_error = 0.0
        self._tick_index = 0
        self.generator.manual_seed(self.seed)
        for s in self.spawners:
            s.reset()

    def patch(self, transforms=None, config=None, render_data=None):
        """Live-patch transforms / config / render data without resetting
        the state, the tick index or the generator (Modeling/View.cs:
        199-264). Spawner accumulators carry over when the spawner list
        keeps its length and types. A capacity change is structural and
        raises: rebuild the system instead."""
        if config is not None:
            if config.capacity != self.config.capacity:
                raise ValueError(
                    "capacity change is structural — rebuild the system")
            self.config = config
        if transforms is not None:
            old_spawners = self.spawners
            self.transforms = list(transforms)
            new_spawners = self.spawners
            if len(old_spawners) == len(new_spawners) and all(
                    type(o) is type(n)
                    for o, n in zip(old_spawners, new_spawners)):
                for old, new in zip(old_spawners, new_spawners):
                    new.carry_runtime_from(old)
        if render_data is not None:
            self.render_data = self._auto_rotation_gate(render_data)
        self._step = self._build_step()

    @property
    def live_count(self) -> int:
        return int(self.state.live_count())

    @span("illuminant/particles/render")
    def render(self, raster_config, **kwargs):
        """ParticleSystem.Render (ParticleSystem.cs:943): rasterize the
        current state through raster/render.py's render_particles with
        this system's z_to_y, z_formula and size_from_z; any keyword
        overrides them."""
        from ..raster.render import render_particles

        cfg = self.config
        kwargs.setdefault("z_to_y", cfg.z_to_y)
        kwargs.setdefault("z_formula", cfg.z_formula)
        kwargs.setdefault("size_from_z", cfg.size_from_z)
        return render_particles(self.state, raster_config, **kwargs)


@dataclasses.dataclass
class BitmapDrawCall:
    """Host-side sprite draw call (the AutoReadback result,
    ParticleReadback.cs:21-167): per live particle, numpy arrays."""

    position: object  # (N, 2) screen x, y
    z: object  # (N,)
    size: object  # (N,)
    rotation: object  # (N,)
    color: object  # (N, 4) premultiplied
    category: object  # (N,)


def auto_readback(system: ParticleSystem, sort: bool = True,
                  z_to_y: Optional[float] = None) -> BitmapDrawCall:
    """AutoReadback (ParticleReadback.cs): the live particles as a sprite
    list on the host, one transfer of the state; `sort` orders them by
    screen y like SortedReadback. `z_to_y=None` takes the system's."""
    st = system.state
    if z_to_y is None:
        z_to_y = system.config.z_to_y
    live = st.live_mask().cpu().numpy()
    pos = st.position.cpu().numpy()[live]
    rd = st.render_data.cpu().numpy()[live]
    rc = st.render_color.cpu().numpy()[live]
    screen_y = pos[:, 1] - pos[:, 2] * np.float32(z_to_y)
    order = np.argsort(screen_y) if sort else np.arange(len(pos))
    return BitmapDrawCall(
        position=np.stack([pos[order, 0], screen_y[order]], axis=-1),
        z=pos[order, 2], size=rd[order, 0], rotation=rd[order, 1],
        color=rc[order], category=rd[order, 3])
