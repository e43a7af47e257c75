"""Particle spawning (counterpart of illuminant_tpu/particles/spawner.py).

Host side: the stochastic rate with error carry, CountScale and the
MaximumTotal clamp (ParticleSpawner.cs:126-196), with the same seeded
numpy stream as the JAX package, so both count draw for draw. Device side:
Spawn_Stage1/2 (SpawnerCommon.fxh:119-190) — per-slot randomness ->
position / velocity / life / color formulas -> post matrices -> attribute
discard, written at the ring cursor; `spawn_feedback` (SpawnParticles.fx
PS_SpawnFeedback :55-118) takes its inputs from another system's
particles. A spawn writes at most `spawn_max` slots per tick, masked by
the actual count. The ring's `sub_rings` partition is ROADMAP M15.

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
from ..core.upload import cached_upload
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
    # Per-position-constant color multipliers (PatternSpawner's pixel
    # colors); None for plain spawners.
    position_colors: Optional[torch.Tensor] = None  # (P, 4)


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


def _count(count, device):
    """A host int stays an int (no upload); a tensor count moves to the
    state's device as int32."""
    if isinstance(count, torch.Tensor):
        return count.to(device=device, dtype=torch.int32)
    return int(count)


def _window_write(state: ParticleState, rel, mask, rows, n: int,
                  spawn_max: int):
    """Write rows[j] into slot (cursor + j) mod n where mask[j], in place.
    Within the capacity the slots are distinct: a plain indexed write.
    Past it the window overlaps itself and the newest row of each slot
    wins (the reference's ring overwrites in order), picked by a max over
    row numbers, so the write stays deterministic."""
    idx = torch.remainder(state.write_cursor.long() + rel.long(), n)
    arrays = (state.position, state.velocity, state.color)
    if spawn_max <= n:
        keep = mask[:, None]
        for arr, new_rows in zip(arrays, rows):
            arr[idx] = torch.where(keep, new_rows, arr[idx])
        return
    winner = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    winner.scatter_reduce_(0, idx, torch.where(mask, rel.long(), -1),
                           reduce="amax")
    hit = (winner >= 0)[:, None]
    src = torch.clamp(winner, min=0)
    for arr, new_rows in zip(arrays, rows):
        arr.copy_(torch.where(hit, new_rows[src], arr))


def _advance(state: ParticleState, count, n: int) -> ParticleState:
    return state.replace(
        write_cursor=torch.remainder(state.write_cursor + count, n)
        .to(torch.int32),
        total_spawned=(state.total_spawned + count).to(torch.int32))


@named_scope("illuminant/particle_spawn")
def spawn(state: ParticleState, u: SpawnUniforms, count, spawn_max: int,
          generator: Optional[torch.Generator] = None,
          uniforms: Optional[Sequence] = None,
          sub_rings: int = 1) -> ParticleState:
    """Write up to `spawn_max` new particles at the ring cursor, the first
    `count` of them (a host int, or a 0-d tensor), as one window modulo
    the capacity; a window longer than the capacity keeps each slot's
    newest row.

    Randomness comes from `generator` (draws on the state's device) or
    from `uniforms`, three (spawn_max, 4) arrays in [0, 1) standing in for
    the JAX package's random1..3.

    Updates state.position / velocity / color IN PLACE (the counterpart of
    the JAX step donating the state buffers) and returns the state with
    the cursor and total advanced."""
    if sub_rings != 1:
        raise NotImplementedError(
            f"spawn(sub_rings={sub_rings}): the partitioned ring is not "
            "ported yet (ROADMAP M15)")
    n = state.capacity
    dev = state.position.device
    f32 = torch.float32
    count = _count(count, dev)
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
    if u.position_colors is not None:
        # The pattern pixel's color multiplies the color constant
        # (PatternSpawner.fx:70-74); the random terms stay untinted.
        attr_constant = attr_constant * u.position_colors[idx1.long()]
    new_attributes = evaluate_formula(
        zero, attr_constant, u.config[6], u.config[7], random3,
        u.formula_types[2], u.axis_mask)

    mask = mask & (new_attributes[:, 3] >= u.attribute_discard_threshold)
    _window_write(state, rel, mask, (new_position, new_velocity,
                                     new_attributes), n, spawn_max)
    return _advance(state, count, n)


@dataclasses.dataclass
class Spawner:
    """Host spawner (SpawnerBase + Spawner, ParticleSpawner.cs)."""

    min_rate: float = 0.0  # particles per second
    max_rate: float = 0.0
    life: Formula1 = dataclasses.field(
        default_factory=lambda: Formula1(constant=1.0))
    position: Formula3 = dataclasses.field(default_factory=Formula3)
    velocity: Formula3 = dataclasses.field(default_factory=Formula3)
    color: Formula4 = dataclasses.field(default_factory=Formula4)
    category: Formula1 = dataclasses.field(default_factory=Formula1)
    additional_positions: list = dataclasses.field(default_factory=list)
    axis_mask: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    align_velocity_and_position: bool = False
    maximum_total: Optional[int] = None
    position_post_matrix: Optional[object] = None
    velocity_post_matrix: Optional[object] = None
    alpha_discard_threshold: float = 0.0
    spawn_max: int = 8192  # per-tick cap
    seed: int = 0
    # Polygon-path spawning (Spawner, ParticleSpawner.cs:262-419).
    polygon_rate: float = 0.0
    polygon_loop: bool = False
    velocity_along_polygon: Optional[Formula1] = None
    # RatePerPosition (ParticleSpawner.cs:286): the rate is per emission
    # stream and multiplies by count_scale().
    rate_per_position: bool = True
    is_spawner = True

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.rate_error = 0.0
        self.total_spawned = 0

    def reset(self):
        """Zero the accumulators and re-seed the rate stream, so that a
        reset system reproduces its run."""
        self.rate_error = 0.0
        self.total_spawned = 0
        self._rng = np.random.default_rng(self.seed)
        if hasattr(self, "read_cursor"):
            self.read_cursor = 0

    def carry_runtime_from(self, other: "Spawner"):
        """Adopt another spawner's rate error, RNG stream, spawn total and
        feedback cursor (a live property patch keeps emitting smoothly)."""
        self._rng = other._rng
        self.rate_error = other.rate_error
        self.total_spawned = other.total_spawned
        if hasattr(other, "read_cursor") and hasattr(self, "read_cursor"):
            self.read_cursor = other.read_cursor

    def count_scale(self) -> int:
        """CountScale (ParticleSpawner.cs:126-131, 301-305): one emission
        stream per additional position, +1 when the polygon loops."""
        if not self.rate_per_position:
            return 1
        return max(len(self.additional_positions)
                   + (1 if self.polygon_loop else 0), 1)

    def begin_tick(self, now: float, dt: float,
                   granularity: int = 1) -> int:
        """BeginTick (ParticleSpawner.cs:152-196): the stochastic count
        with error carry, scaled by count_scale (MaximumTotal too); the
        excess over spawn_max re-enters the carry. `granularity` > 1
        rounds the count down to a multiple and carries the remainder."""
        min_rate = min(self.min_rate, self.max_rate)
        scale = self.count_scale()
        current = (self._rng.uniform() * (self.max_rate - min_rate)
                   + min_rate) * scale * dt
        current += self.rate_error
        self.rate_error = 0.0
        if current < 1.0:
            self.rate_error = max(current, 0.0)
            count = 0
        else:
            count = int(current)
            self.rate_error = current - count
        finishing = False
        if self.maximum_total is not None:
            remaining = self.maximum_total * scale - self.total_spawned
            if count >= remaining:
                count = max(remaining, 0)
                self.rate_error = 0.0
                finishing = True
        if count > self.spawn_max:
            self.rate_error += count - self.spawn_max
            count = self.spawn_max
            finishing = False
        if granularity > 1:
            rem = count % granularity
            count -= rem
            if finishing:
                # The last sub-granularity remainder can never spawn.
                self.total_spawned += rem
            else:
                self.rate_error += rem
        self.total_spawned += count
        return count

    def estimate_maximum_life(self, now: float) -> float:
        """EstimateMaximumLifeForNewParticle (ParticleSpawner.cs:132-140)."""
        c, o, s = self.life.constant, self.life.offset, self.life.random_scale
        return max(c + o * s, c - o * s)

    def _post_matrix(self, name, m, now, device):
        """A static matrix, or an animated Parameter<DynamicMatrix> (a
        BezierM) evaluated at the current time."""
        if m is None:
            return cached_upload(self, name, np.eye(4), device)
        if isinstance(m, BezierM):
            return evaluate_bezier_matrix(m, now).to(device)
        return cached_upload(self, name, m, device)

    def uniforms(self, now: float, device=None) -> SpawnUniforms:
        pos_constants = [(*self.position.constant, self.life.constant)]
        for p in self.additional_positions:
            pos_constants.append((*p, self.life.constant))
        config = np.zeros((9, 4), np.float32)
        # Pack order (ParticleSpawner.cs:220-227).
        config[0] = (*self.position.random_scale, self.life.random_scale)
        config[1] = (*self.position.offset, self.life.offset)
        config[2] = (*self.velocity.constant, self.category.constant)
        config[3] = (*self.velocity.random_scale, self.category.random_scale)
        config[4] = (*self.velocity.offset, self.category.offset)
        config[5] = self.color.constant
        config[6] = self.color.random_scale
        config[7] = self.color.offset
        if self.velocity_along_polygon is not None:
            vap = self.velocity_along_polygon
            config[8, :3] = [vap.constant, vap.random_scale, vap.offset]

        def up(name, value):
            return cached_upload(self, name, value, device)

        # Only honoured when both formulas are spherical (Formula.cs:114).
        align = (self.align_velocity_and_position
                 and self.position.type == FORMULA_SPHERICAL
                 and self.velocity.type == FORMULA_SPHERICAL)
        return SpawnUniforms(
            position_constants=up("position_constants", pos_constants),
            position_constant_count=up("position_constant_count",
                                       float(len(pos_constants))),
            config=up("config", config),
            formula_types=up("formula_types", [self.position.type,
                                               self.velocity.type, 0.0, 0.0]),
            position_matrix=self._post_matrix(
                "position_matrix", self.position_post_matrix, now, device),
            velocity_matrix=self._post_matrix(
                "velocity_matrix", self.velocity_post_matrix, now, device),
            axis_mask=up("axis_mask", self.axis_mask),
            align_velocity_and_position=up("align", 1.0 if align else 0.0),
            attribute_discard_threshold=up(
                "discard", self.alpha_discard_threshold / 255.0),
            polygon_rate=up("polygon_rate", self.polygon_rate),
            polygon_loop=up("polygon_loop",
                            1.0 if self.polygon_loop else 0.0))


# --------------------------------------------------------------------------
# Feedback spawning (SpecialSpawners.cs:265-442, SpawnParticles.fx
# PS_SpawnFeedback :55-118): consume another system's live particles as
# spawn inputs.


@tensor_dataclass
class FeedbackUniforms:
    base: SpawnUniforms
    source_index: torch.Tensor  # () window start (FeedbackSourceIndex)
    instance_multiplier: torch.Tensor  # ()
    source_velocity_factor: torch.Tensor  # ()
    source_life_range: torch.Tensor  # (2,)
    align_position_constant: torch.Tensor  # ()
    multiply_attribute_constant: torch.Tensor  # ()
    multiply_life: torch.Tensor  # ()


@named_scope("illuminant/particle_spawn")
def spawn_feedback(state: ParticleState, source: ParticleState,
                   u: FeedbackUniforms, count, spawn_max: int,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[Sequence] = None) -> ParticleState:
    """PS_SpawnFeedback as a masked batch over spawn_max slots: new
    particle j reads source slot (source_index + j / instance_multiplier)
    and spawns if that particle's life lies in the source range. `source`
    may be `state` itself (self-feedback): the source rows are gathered
    before the window is written. Randomness and the in-place write as in
    `spawn`."""
    n = state.capacity
    b = u.base
    dev = state.position.device
    count = _count(count, dev)
    rel = torch.arange(spawn_max, dtype=torch.int32, device=dev)
    mask = rel < count

    # Source slot per new particle (fx:69-71).
    src_idx = torch.remainder(
        (rel.to(torch.float32) / torch.clamp(u.instance_multiplier, min=1.0)
         + u.source_index).to(torch.int32), source.capacity).long()
    src_pos = source.position[src_idx]
    src_vel = source.velocity[src_idx]
    src_attr = source.color[src_idx]
    life_ok = ((src_pos[:, 3] > u.source_life_range[0])
               & (src_pos[:, 3] < u.source_life_range[1]))
    mask = mask & life_ok

    random1, random2, random3 = _draws(spawn_max, dev, generator, uniforms)
    random2 = torch.where(b.align_velocity_and_position > 0.5,
                          torch.cat([random1[:, :2], random2[:, 2:]], dim=-1),
                          random2)

    position_constant = torch.broadcast_to(b.position_constants[0],
                                           (spawn_max, 4))
    position_constant = torch.where(
        u.align_position_constant > 0.5,
        torch.cat([position_constant[:, :3] + src_pos[:, :3],
                   position_constant[:, 3:4]], dim=-1),
        position_constant)
    zero = torch.zeros_like(position_constant)
    temp_position = evaluate_formula(
        zero, position_constant, b.config[0], b.config[1], random1,
        b.formula_types[0], b.axis_mask)
    new_position = mul_point_rows(temp_position, b.position_matrix)
    new_position = torch.where(
        u.multiply_life > 0.5,
        torch.cat([new_position[:, :3],
                   new_position[:, 3:4] * src_pos[:, 3:4]], dim=-1),
        new_position)

    temp_velocity = evaluate_formula(
        temp_position, torch.broadcast_to(b.config[2], (spawn_max, 4)),
        b.config[3], b.config[4], random2, b.formula_types[1], b.axis_mask)
    temp_velocity = temp_velocity + src_vel * u.source_velocity_factor
    new_velocity = mul_point_rows(temp_velocity, b.velocity_matrix)

    attribute_constant = torch.broadcast_to(b.config[5], (spawn_max, 4))
    attribute_constant = torch.where(u.multiply_attribute_constant > 0.5,
                                     attribute_constant * src_attr,
                                     attribute_constant)
    new_attributes = evaluate_formula(
        temp_position, attribute_constant, b.config[6], b.config[7],
        random3, b.formula_types[2], b.axis_mask)
    mask = mask & (new_attributes[:, 3] >= b.attribute_discard_threshold)

    _window_write(state, rel, mask, (new_position, new_velocity,
                                     new_attributes), n, spawn_max)
    return _advance(state, count, n)


@dataclasses.dataclass
class FeedbackSpawner(Spawner):
    """Host feedback spawner (SpecialSpawners.cs:265-442). `source` is the
    ParticleSystem consumed (None or the owning system: self-feedback);
    the read window slides by the consumed count over the source's
    capacity."""

    source: object = None  # ParticleSystem
    instance_multiplier: int = 1
    source_velocity_factor: float = 0.0
    source_life_min: float = 0.0
    source_life_max: float = 1e9
    align_position_constant: bool = True
    multiply_attribute_constant: bool = True
    multiply_life: bool = False
    spawn_from_entire_window: bool = False

    def __post_init__(self):
        super().__post_init__()
        self.read_cursor = 0
        self.is_feedback = True

    def begin_tick(self, now: float, dt: float,
                   granularity: int = 1) -> int:
        """SpecialSpawners.cs:353-370: counts round down to a multiple of
        InstanceMultiplier; the remainder carries into the rate error."""
        count = super().begin_tick(now, dt, granularity)
        im = max(self.instance_multiplier, 1)
        if im > 1 and not self.spawn_from_entire_window:
            rounded = (count // im) * im
            if rounded < count:
                self.rate_error += count - rounded
                self.total_spawned -= count - rounded
                count = rounded
        return count

    def feedback_uniforms(self, now: float, device=None) -> FeedbackUniforms:
        def up(name, value):
            return cached_upload(self, name, value, device)

        return FeedbackUniforms(
            base=self.uniforms(now, device),
            source_index=up("source_index", float(self.read_cursor)),
            instance_multiplier=up("instance_multiplier",
                                   float(self.instance_multiplier)),
            source_velocity_factor=up("source_velocity_factor",
                                      self.source_velocity_factor),
            source_life_range=up("source_life_range",
                                 [self.source_life_min,
                                  self.source_life_max]),
            align_position_constant=up(
                "align_position_constant",
                1.0 if self.align_position_constant else 0.0),
            multiply_attribute_constant=up(
                "multiply_attribute_constant",
                1.0 if self.multiply_attribute_constant else 0.0),
            multiply_life=up("multiply_life",
                             1.0 if self.multiply_life else 0.0))

    def advance_window(self, consumed: int, fallback_capacity=None):
        """Slide the read window by the consumed instance groups (at least
        one); `fallback_capacity` serves self-feedback spelled
        source=None. A tick that consumed nothing leaves it."""
        if consumed <= 0:
            return
        if self.source is not None:
            cap = self.source.config.capacity
        elif fallback_capacity:
            cap = fallback_capacity
        else:
            return
        if self.spawn_from_entire_window:
            self.read_cursor = int(self._rng.integers(0, max(cap, 1)))
        else:
            self.read_cursor = (
                self.read_cursor
                + max(consumed // max(self.instance_multiplier, 1), 1)) % cap


@dataclasses.dataclass
class PatternSpawner(Spawner):
    """Spawns particles from image pixels (SpecialSpawners.cs:15-263):
    pixel coordinates (times `pixel_scale`, every `divisor`-th pixel,
    alpha above `alpha_threshold`) become position constants and pixel
    colors multiply the color constant. `image` is (H, W, 4) in [0, 1].
    min/max_rate are absolute particles per second, as in the JAX
    package."""

    image: object = None  # np.ndarray (H, W, 4)
    divisor: int = 1
    alpha_threshold: float = 0.05
    pixel_scale: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        img = np.asarray(self.image if self.image is not None
                         else np.ones((1, 1, 4), np.float32), np.float32)
        h, w = img.shape[:2]
        ys, xs = np.mgrid[0:h:self.divisor, 0:w:self.divisor]
        cols = img[::self.divisor, ::self.divisor].reshape(-1, 4)
        keep = cols[:, 3] > self.alpha_threshold
        self._pattern_positions = np.stack([
            xs.reshape(-1)[keep] * self.pixel_scale,
            ys.reshape(-1)[keep] * self.pixel_scale,
            np.zeros(keep.sum(), np.float32),
            np.zeros(keep.sum(), np.float32)], axis=-1).astype(np.float32)
        self._pattern_colors = cols[keep]

    @property
    def pattern_size(self) -> int:
        return len(self._pattern_positions)

    def uniforms(self, now: float, device=None) -> SpawnUniforms:
        u = super().uniforms(now, device)
        if self.pattern_size == 0:
            return u
        base = np.asarray([(*self.position.constant, self.life.constant)],
                          np.float32)
        pc = self._pattern_positions + base
        return u.replace(
            position_constants=cached_upload(self, "pattern_positions", pc,
                                             device),
            position_constant_count=cached_upload(
                self, "pattern_count", float(len(pc)), device),
            position_colors=cached_upload(self, "pattern_colors",
                                          self._pattern_colors, device))
