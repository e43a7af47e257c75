"""Particle spawning (counterpart of illuminant_tpu/particles/spawner.py:
`Spawner`, `SpawnUniforms` and `spawn` with one ring).

Host side: the stochastic rate with error carry (ParticleSpawner.cs:
152-196). Device side: Spawn_Stage1/2 (SpawnerCommon.fxh:119-190) —
per-slot randomness -> position / velocity / life / color formulas -> post
matrices -> attribute discard, written at the ring cursor. A spawn writes
at most `spawn_max` slots per tick, masked by the actual count.

Randomness: the JAX package draws three (spawn_max, 4) uniform arrays
from a threefry key (spawner.py:108-111), which PyTorch cannot reproduce.
`spawn` takes either a torch.Generator or the three arrays themselves, so
a test can hand both packages the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.pytree import named_scope, tensor_dataclass
from ..ops.bezier import BezierM, evaluate_bezier_matrix
from ..ops.coords import mul_point_rows
from .formula import (FORMULA_SPHERICAL, Formula1, Formula3, Formula4,
                      evaluate_formula)
from .state import ParticleState


@tensor_dataclass
class SpawnUniforms:
    """Configuration[9] and friends (SpawnerCommon.fxh:1-15)."""

    position_constants: torch.Tensor  # (P, 4) xyz + life constant
    position_constant_count: torch.Tensor  # ()
    config: torch.Tensor  # (9, 4), pack order ParticleSpawner.cs:220-227
    formula_types: torch.Tensor  # (4,)
    position_matrix: torch.Tensor  # (4, 4) row-vector convention
    velocity_matrix: torch.Tensor  # (4, 4)
    axis_mask: torch.Tensor  # (3,)
    align_velocity_and_position: torch.Tensor  # ()
    attribute_discard_threshold: torch.Tensor  # ()
    polygon_rate: torch.Tensor  # (); <= 0.05 disables the polygon walk
    polygon_loop: torch.Tensor  # ()


def _draws(spawn_max: int, device, generator, uniforms):
    if (generator is None) == (uniforms is None):
        raise ValueError("spawn takes exactly one of `generator` and "
                         "`uniforms`")
    if uniforms is not None:
        draws = [(u if isinstance(u, torch.Tensor)
                  else torch.from_numpy(np.array(u, np.float32)))
                 .to(device=device, dtype=torch.float32) for u in uniforms]
        if len(draws) != 3 or any(tuple(d.shape) != (spawn_max, 4)
                                  for d in draws):
            raise ValueError(f"spawn wants three ({spawn_max}, 4) uniform "
                             "arrays")
        return draws
    return [torch.rand((spawn_max, 4), generator=generator,
                       dtype=torch.float32, device=device)
            for _ in range(3)]


@named_scope("illuminant/particle_spawn")
def spawn(state: ParticleState, u: SpawnUniforms, count, spawn_max: int,
          generator: Optional[torch.Generator] = None,
          uniforms: Optional[Sequence] = None) -> ParticleState:
    """Write up to `spawn_max` new particles at the ring cursor, the first
    `count` of them (an int or 0-d tensor), as one contiguous window
    modulo the capacity.

    Randomness comes from `generator` (draws on the state's device) or
    from `uniforms`, three (spawn_max, 4) arrays in [0, 1) standing in for
    the JAX package's random1..3.

    Updates state.position / velocity / color IN PLACE (the counterpart of
    the JAX frame donating the state buffers) and returns the state with
    the cursor and total advanced."""
    n = state.capacity
    if spawn_max > n:
        raise NotImplementedError(
            "spawn_max above the capacity (the self-overlapping ring "
            "window) is not ported yet (ROADMAP M5)")
    dev = state.position.device
    f32 = torch.float32
    count = torch.as_tensor(count, dtype=torch.int32, device=dev)
    rel = torch.arange(spawn_max, dtype=torch.int32, device=dev)
    mask = rel < count

    random1, random2, random3 = _draws(spawn_max, dev, generator, uniforms)
    # AlignVelocityAndPosition (SpawnerCommon.fxh:114-117).
    random2 = torch.where(u.align_velocity_and_position > 0.5,
                          torch.cat([random1[:, :2], random2[:, 2:]], dim=-1),
                          random2)

    # Position constant: cycle one per particle, or walk the polygon path
    # (Spawn_Stage1, fxh:136-155). The cross-tick offset wraps in int32
    # at a multiple of the constant count (spawner.py:122-136).
    p_count = torch.clamp(u.position_constant_count, min=1.0)
    p_ci = torch.clamp(u.position_constant_count.to(torch.int32), min=1)
    total_w = torch.remainder(state.total_spawned.to(torch.int32),
                              p_ci * 4096)
    relf = (rel + total_w).to(f32)
    use_poly = u.polygon_rate > 0.05
    pos_f = relf / torch.clamp(u.polygon_rate, min=1e-3)
    pos_i = torch.floor(pos_f)
    poly_t = pos_f - pos_i
    i1_loop = torch.remainder(pos_i, p_count)
    i2_loop = torch.remainder(pos_i + 1.0, p_count)
    i2_clamp = torch.minimum(i1_loop + 1.0, p_count - 1.0)
    idx1 = torch.where(use_poly, i1_loop, torch.remainder(relf, p_count))
    idx2 = torch.where(use_poly,
                       torch.where(u.polygon_loop > 0.5, i2_loop, i2_clamp),
                       idx1)
    t = torch.where(use_poly, poly_t, 0.0)[:, None]
    p1 = u.position_constants[idx1.long()]
    p2 = u.position_constants[idx2.long()]
    position_constant = p1 + (p2 - p1) * t
    towards_next = p2[:, :3] - p1[:, :3]

    zero = torch.zeros_like(position_constant)
    # Spawn_Stage2 (fxh:157-190).
    temp_position = evaluate_formula(
        zero, position_constant, u.config[0], u.config[1], random1,
        u.formula_types[0], u.axis_mask)
    new_position = mul_point_rows(temp_position, u.position_matrix)

    temp_velocity = evaluate_formula(
        temp_position, torch.broadcast_to(u.config[2], temp_position.shape),
        u.config[3], u.config[4], random2, u.formula_types[1], u.axis_mask)
    # Velocity along the polygon path (fxh:172-177): config row 8.
    towards_len = torch.sqrt(torch.clamp(
        torch.sum(towards_next ** 2, dim=-1, keepdim=True), min=1e-12))
    towards_speed = (u.config[8, 0]
                     + (random3[:, 3:4] + u.config[8, 2]) * u.config[8, 1])
    temp_velocity = torch.cat([
        temp_velocity[:, :3] + torch.where(
            towards_len > 1e-4, towards_speed * towards_next / towards_len,
            0.0),
        temp_velocity[:, 3:4]], dim=-1)
    new_velocity = mul_point_rows(temp_velocity, u.velocity_matrix)

    attr_constant = torch.broadcast_to(u.config[5], temp_position.shape)
    new_attributes = evaluate_formula(
        zero, attr_constant, u.config[6], u.config[7], random3,
        u.formula_types[2], u.axis_mask)

    mask = mask & (new_attributes[:, 3] >= u.attribute_discard_threshold)

    # The window [cursor, cursor + spawn_max) is contiguous modulo the
    # capacity and spawn_max <= capacity, so its slots are distinct: a
    # plain indexed write; masked rows keep their old values.
    idx = torch.remainder(state.write_cursor.long() + rel.long(), n)
    keep = mask[:, None]
    for arr, new_rows in ((state.position, new_position),
                          (state.velocity, new_velocity),
                          (state.color, new_attributes)):
        arr[idx] = torch.where(keep, new_rows, arr[idx])

    return state.replace(
        write_cursor=torch.remainder(state.write_cursor + count, n)
        .to(torch.int32),
        total_spawned=(state.total_spawned + count).to(torch.int32),
    )


@dataclasses.dataclass
class Spawner:
    """Host spawner (SpawnerBase + Spawner, ParticleSpawner.cs). Additional
    positions, polygon paths and the feedback / pattern spawners are
    ROADMAP M13."""

    min_rate: float = 0.0  # particles per second
    max_rate: float = 0.0
    life: Formula1 = dataclasses.field(
        default_factory=lambda: Formula1(constant=1.0))
    position: Formula3 = dataclasses.field(default_factory=Formula3)
    velocity: Formula3 = dataclasses.field(default_factory=Formula3)
    color: Formula4 = dataclasses.field(default_factory=Formula4)
    category: Formula1 = dataclasses.field(default_factory=Formula1)
    axis_mask: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    align_velocity_and_position: bool = False
    maximum_total: Optional[int] = None
    position_post_matrix: Optional[object] = None
    velocity_post_matrix: Optional[object] = None
    alpha_discard_threshold: float = 0.0
    spawn_max: int = 8192  # per-tick cap
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.rate_error = 0.0
        self.total_spawned = 0

    def begin_tick(self, now: float, dt: float) -> int:
        """BeginTick (ParticleSpawner.cs:152-196): the stochastic count
        with error carry; the excess over spawn_max re-enters the carry."""
        min_rate = min(self.min_rate, self.max_rate)
        current = (self._rng.uniform() * (self.max_rate - min_rate)
                   + min_rate) * dt
        current += self.rate_error
        self.rate_error = 0.0
        if current < 1.0:
            self.rate_error = max(current, 0.0)
            count = 0
        else:
            count = int(current)
            self.rate_error = current - count
        if self.maximum_total is not None:
            remaining = self.maximum_total - self.total_spawned
            if count >= remaining:
                count = max(remaining, 0)
                self.rate_error = 0.0
        if count > self.spawn_max:
            self.rate_error += count - self.spawn_max
            count = self.spawn_max
        self.total_spawned += count
        return count

    def uniforms(self, now: float, device=None) -> SpawnUniforms:
        pc = np.asarray([(*self.position.constant, self.life.constant)],
                        np.float32)
        config = np.zeros((9, 4), np.float32)
        config[0] = (*self.position.random_scale, self.life.random_scale)
        config[1] = (*self.position.offset, self.life.offset)
        config[2] = (*self.velocity.constant, self.category.constant)
        config[3] = (*self.velocity.random_scale, self.category.random_scale)
        config[4] = (*self.velocity.offset, self.category.offset)
        config[5] = self.color.constant
        config[6] = self.color.random_scale
        config[7] = self.color.offset

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        def post_matrix(m):
            # A BezierM is an animated Parameter<DynamicMatrix>, evaluated
            # at the current time.
            if m is None:
                return f32(np.eye(4))
            if isinstance(m, BezierM):
                return evaluate_bezier_matrix(m, now).to(device)
            return f32(m)

        align = (self.align_velocity_and_position
                 and self.position.type == FORMULA_SPHERICAL
                 and self.velocity.type == FORMULA_SPHERICAL)
        return SpawnUniforms(
            position_constants=f32(pc),
            position_constant_count=f32(1.0),
            config=f32(config),
            formula_types=f32([self.position.type, self.velocity.type,
                               0.0, 0.0]),
            position_matrix=post_matrix(self.position_post_matrix),
            velocity_matrix=post_matrix(self.velocity_post_matrix),
            axis_mask=f32(self.axis_mask),
            align_velocity_and_position=f32(1.0 if align else 0.0),
            attribute_discard_threshold=f32(
                self.alpha_discard_threshold / 255.0),
            polygon_rate=f32(0.0),
            polygon_loop=f32(0.0),
        )
