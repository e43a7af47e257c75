"""Model -> live engine binding (counterpart of illuminant_tpu/models/
view.py).

Port of the reference's Modeling/View.cs (ParticleEngineView):
instantiates a live ParticleSystem per SystemModel on the view's device,
maps TransformModel property bags onto the port's transform and spawner
host objects, resolves named variables, and steps everything in update
order. Property mapping is by name (the reference uses reflection +
TypeConverters, View.cs:199-264).

Where the port differs from the JAX view, on purpose:
  * A Noise's offset stream is seeded by its place in the model: the k-th
    Noise of the walk over systems (update order) and transforms takes
    seed k (1, 2, ...), the seeds the JAX package's per-process counter
    gives the first view a process builds. So a view, a rebuild of it and
    the SaveAsCode module (codegen.py) draw the same offsets.
  * A live patch keeps each Noise's stream and offsets (the reference
    patches its live objects in place) and wires FeedbackSpawner sources
    again; the JAX view gives a patched Noise a new stream and a patched
    FeedbackSpawner no source (it then feeds on its own system).
  * `update(dt, spawn_uniforms=...)` passes injected spawn draws through
    to each system's `update`, so tests can feed the JAX package's.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.bezier import ClampedBezier, constant_bezier
from ..particles import transforms as tx
from ..particles.formula import Formula1, Formula3, Formula4
from ..particles.render_data import (RenderDataUniforms,
                                     pack_life_ramp_settings)
from ..particles.spawner import FeedbackSpawner, PatternSpawner, Spawner
from ..particles.system import ParticleSystem, ParticleSystemConfig
from ..raster.render import ParticleAppearance
from .model import EngineModel, SystemModel, TransformModel
from .parameter import Bezier, Parameter, value_to_array

NOISE_KINDS = ("Noise", "SpatialNoise")


def _param_value(obj: Any, resolver, t: float = 0.0,
                 width: Optional[int] = None) -> np.ndarray:
    if obj is None:
        return np.zeros((width or 1,), np.float32)
    p = Parameter.from_json(obj) if not isinstance(obj, Parameter) else obj
    v = p.evaluate(t, resolver)
    return value_to_array(v, width)


def _formula3(obj: Any, resolver) -> Formula3:
    if not isinstance(obj, dict):
        return Formula3()
    ftype = int(obj.get("Type", 0)) if not isinstance(
        obj.get("Type"), str
    ) else {"Linear": 0, "Spherical": 1, "Towards": 2,
            "Rectangular": 3}.get(obj["Type"], 0)
    if obj.get("Circular"):
        ftype = max(ftype, 1)
    return Formula3(
        constant=tuple(_param_value(obj.get("Constant"), resolver, 0, 3)),
        random_scale=tuple(
            _param_value(obj.get("RandomScale"), resolver, 0, 3)
        ),
        offset=tuple(_param_value(obj.get("Offset"), resolver, 0, 3)),
        type=ftype,
    )


def _formula1(obj: Any, resolver) -> Formula1:
    if not isinstance(obj, dict):
        return Formula1()
    return Formula1(
        constant=float(_param_value(obj.get("Constant"), resolver, 0, 1)[0]),
        random_scale=float(
            _param_value(obj.get("RandomScale"), resolver, 0, 1)[0]
        ),
        offset=float(_param_value(obj.get("Offset"), resolver, 0, 1)[0]),
    )


def _formula4(obj: Any, resolver) -> Formula4:
    if not isinstance(obj, dict):
        return Formula4()
    return Formula4(
        constant=tuple(_param_value(obj.get("Constant"), resolver, 0, 4)),
        random_scale=tuple(
            _param_value(obj.get("RandomScale"), resolver, 0, 4)
        ),
        offset=tuple(_param_value(obj.get("Offset"), resolver, 0, 4)),
    )


def _has_bezier(obj) -> bool:
    """True when a property bag contains a Bezier-animated Parameter
    anywhere (dict shape {"Bezier": {...}}, parameter.py)."""
    if isinstance(obj, dict):
        if "Bezier" in obj:
            return True
        return any(_has_bezier(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_has_bezier(v) for v in obj)
    return False


def instantiate_transform(tm: TransformModel, resolver, now: float = 0.0,
                          noise_seed: Optional[int] = None):
    """TransformModel -> live host transform (View.cs:199-264).
    `now`: evaluation time for animated (Bezier) parameters — the
    reference evaluates at the current frame time. `noise_seed`: the seed
    of a Noise's offset stream (None: the next of the package's counter,
    as a Noise built directly takes)."""
    p = tm.properties
    kind = tm.type
    if kind in ("Spawner", "PatternSpawner", "FeedbackSpawner"):
        cls = {"Spawner": Spawner, "PatternSpawner": PatternSpawner,
               "FeedbackSpawner": FeedbackSpawner}[kind]
        kw = {}
        if kind == "FeedbackSpawner":
            # SourceSystem wired by EngineView after all systems exist
            # (the reference resolves via SystemResolver, View.cs:63).
            kw = dict(
                instance_multiplier=int(p.get("InstanceMultiplier", 1)),
                source_velocity_factor=float(_param_value(
                    p.get("SourceVelocityFactor"), resolver, now, 1)[0]),
                spawn_from_entire_window=bool(
                    p.get("SpawnFromEntireWindow", False)),
            )
        elif kind == "PatternSpawner":
            if p.get("Texture") is not None:
                kw = dict(image=np.asarray(p["Texture"], np.float32),
                          divisor=int(p.get("Divisor", 1)))
        # Life defaults to Formula1.One (ParticleSpawner.cs:68) — a
        # zero default would spawn already-dead particles.
        life = (_formula1(p["Life"], resolver) if isinstance(
            p.get("Life"), dict) else Formula1(constant=1.0))
        s = cls(
            min_rate=float(_param_value(p.get("MinRate"), resolver, now, 1)[0]),
            max_rate=float(_param_value(p.get("MaxRate"), resolver, now, 1)[0]),
            life=life,
            position=_formula3(p.get("Position"), resolver),
            velocity=_formula3(p.get("Velocity"), resolver),
            color=_formula4(p.get("Color") or p.get("Attributes"),
                            resolver),
            category=_formula1(p.get("Category"), resolver),
            **kw,
        )
        if p.get("MaximumTotal") is not None:
            # Explicit 0 means "spawner disabled" (the count clamps to
            # the remaining total, ParticleSpawner.cs:178-183) — only
            # absence means unbounded.
            s.maximum_total = int(
                _param_value(p["MaximumTotal"], resolver, now, 1)[0]
                if isinstance(p["MaximumTotal"], dict)
                else p["MaximumTotal"])
        if p.get("AdditionalPositions"):
            s.additional_positions = [
                tuple(value_to_array(v, 3))
                for v in p["AdditionalPositions"]
            ]
        return s
    if kind == "Gravity":
        attractors = []
        for a in p.get("Attractors", []) or []:
            attractors.append(
                tx.Attractor(
                    position=tuple(
                        _param_value(a.get("Position"), resolver, now, 3)
                    ),
                    radius=float(
                        _param_value(a.get("Radius"), resolver, now, 1)[0]
                    ),
                    strength=float(
                        _param_value(a.get("Strength"), resolver, now, 1)[0]
                    ),
                    # The reference serializes AttractorType under
                    # "Type" as an INT (Transforms.cs:312-329);
                    # string names cover our own saves.
                    falloff_type=(
                        int(a["Type"]) if isinstance(
                            a.get("Type"), (int, float))
                        else {"Natural": 0, "Physical": 0, "Linear": 1,
                              "Exponential": 2}.get(
                            str(a.get("FalloffType",
                                      a.get("Type", "Linear"))), 1)
                    ),
                )
            )
        # Reference default MaximumAcceleration = 8 (Transforms.cs:334);
        # an explicit 0 means "no acceleration", not unclamped.
        if p.get("MaximumAcceleration") is not None:
            max_acc = float(_param_value(
                p["MaximumAcceleration"], resolver, now, 1)[0])
        else:
            max_acc = 8.0
        return tx.Gravity(
            attractors=attractors,
            maximum_acceleration=max_acc,
        )
    if kind == "FMA":
        pos = p.get("Position") or {}
        vel = p.get("Velocity") or {}
        return tx.FMA(
            position_add=tuple(_param_value(pos.get("Add"), resolver, now, 3)),
            position_multiply=tuple(
                _param_value(pos.get("Multiply"), resolver, now, 3)
                if pos.get("Multiply") is not None else (1.0, 1.0, 1.0)
            ),
            velocity_add=tuple(_param_value(vel.get("Add"), resolver, now, 3)),
            velocity_multiply=tuple(
                _param_value(vel.get("Multiply"), resolver, now, 3)
                if vel.get("Multiply") is not None else (1.0, 1.0, 1.0)
            ),
            cycles_per_second=(
                float(p["CyclesPerSecond"])
                if p.get("CyclesPerSecond") is not None else None
            ),
        )
    if kind in NOISE_KINDS:
        seeded = {} if noise_seed is None else dict(
            _rng=np.random.default_rng(noise_seed))
        n = tx.Noise(spatial=(kind == "SpatialNoise"), **seeded)
        if p.get("Interval") is not None:
            # Reference Interval is MILLISECONDS (IntervalUnit = 1000,
            # Transforms.cs:134: intervalSecs = Interval / 1000), and
            # may be Parameter-wrapped.
            n.interval_seconds = float(_param_value(
                p["Interval"], resolver, now, 1)[0]) / 1000.0
        for model_key, attr in (
            ("Position", "position"),
            ("Velocity", "velocity"),
        ):
            sub = p.get(model_key) or {}
            if sub.get("Offset") is not None:
                setattr(n, f"{attr}_offset",
                        tuple(_param_value(sub["Offset"], resolver, 0, 4)))
            if sub.get("Scale") is not None:
                setattr(n, f"{attr}_scale",
                        tuple(_param_value(sub["Scale"], resolver, 0, 4)))
        if p.get("ReplaceOldVelocity") is not None:
            n.replace_old_velocity = bool(p["ReplaceOldVelocity"])
        return n
    if kind in ("MatrixMultiply", "GeometricTransform"):
        return tx.MatrixMultiply()
    if kind == "Sensor":
        return tx.Sensor()
    raise ValueError(f"unsupported transform type: {kind}")


def system_config_from_model(sm: SystemModel,
                             resolver=None) -> ParticleSystemConfig:
    """ParticleSystemConfiguration subset (ParticleConfiguration.cs).
    `resolver` resolves named-variable references inside Parameter-
    wrapped configuration values."""
    c = sm.configuration or {}
    collision = c.get("Collision") or {}

    def f(key, default, src=c):
        v = src.get(key, default)
        if isinstance(v, dict):  # Parameter-wrapped
            return float(_param_value(v, resolver, 0, 1)[0])
        return float(v) if v is not None else default

    return ParticleSystemConfig(
        capacity=1 << 16,
        updates_per_second=f("UpdatesPerSecond", 60.0),
        friction=f("Friction", 0.0),
        maximum_velocity=f("MaximumVelocity", 16384.0),
        life_decay_per_second=f("LifeDecayPerSecond", 1.0),
        z_to_y=f("ZToY", 0.0),
        z_formula=(
            tuple(float(v) for v in
                  _param_value(c.get("ZFormula"), resolver, 0, 4))
            if c.get("ZFormula") is not None else None
        ),
        size_from_z=f("SizeFromZ", 0.0),
        collision_distance=f("Distance", 0.33, collision),
        collision_life_penalty=f("LifePenalty", 0.0, collision),
        escape_velocity=f("EscapeVelocity", 128.0, collision),
        bounce_velocity_multiplier=f(
            "BounceVelocityMultiplier", 0.0, collision
        ),
    )


def instantiate_systems(systems: List[SystemModel], resolver,
                        now: float = 0.0) -> List[List[Any]]:
    """The live transforms of `systems` (in the order given), each Noise
    seeded by its place among the Noises of the walk (1, 2, ...)."""
    seeds = itertools.count(1)
    return [[instantiate_transform(
        t, resolver, now,
        noise_seed=next(seeds) if t.type in NOISE_KINDS else None)
        for t in sm.transforms] for sm in systems]


def _clamped_bezier(obj, width, default, device=None) -> ClampedBezier:
    """JSON Bezier dict | plain constant | None -> ClampedBezier on
    `device`."""
    if obj is None:
        return constant_bezier(default, device=device)
    if isinstance(obj, dict) and "Count" in obj:
        return Bezier.from_json(obj, width).packed(device)
    return constant_bezier(value_to_array(obj, width), device=device)


def render_data_from_model(sm: SystemModel, resolver=None,
                           device=None) -> RenderDataUniforms:
    """Configuration.{Color, Size*, Rotation*} -> RenderDataUniforms on
    `device` (the SetSystemUniforms upload, ParticleSystem.cs:547-576):
    OpacityFromLife o != 0 synthesizes the 2-point alpha ramp
    ((1,1,1,0)->(1,1,1,1) over [0, o], :554-561); Color.LifeRamp binds
    the POINT-sampled ramp texture + settings (:920-939)."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    c = sm.configuration or {}
    color = c.get("Color") or {}

    o = float(color.get("OpacityFromLife") or 0.0)
    if o != 0.0:
        cfl = ClampedBezier(
            range_and_count=f32([0.0, 1.0 / o, 2.0, 0.0]),
            points=f32([[1, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0],
                        [0, 0, 0, 0]]))
    else:
        cfl = _clamped_bezier(
            color.get("FromLife") or color.get("ColorFromLife"), 4,
            [1.0, 1.0, 1.0, 1.0], device)

    size = c.get("Size") or 1.0
    base_size = (float(size[0]) if isinstance(size, (list, tuple))
                 else float(size))
    sfl = c.get("SizeFromLife")
    if sfl is None:
        size_from_life = constant_bezier([base_size], device=device)
    else:
        size_from_life = _clamped_bezier(sfl, 1, [1.0], device)
        if base_size != 1.0:
            size_from_life = size_from_life.replace(
                points=size_from_life.points * base_size)

    life_ramp = None
    ramp_settings = None
    lr = color.get("LifeRamp")
    if isinstance(lr, dict):
        tex = lr.get("Texture")
        if tex is not None and not isinstance(tex, (str, dict)):
            # Inline array texture; file-backed NullableLazyResource refs
            # have no loader in this environment and leave the feature
            # off (the reference falls back to DummyRampTexture too,
            # ParticleSystem.cs:920-925).
            life_ramp = f32(np.asarray(tex, np.float32))
            if life_ramp.dim() == 2:
                life_ramp = life_ramp[..., None] * torch.ones(
                    (1, 1, 4), dtype=torch.float32, device=device)
            ramp_settings = pack_life_ramp_settings(
                strength=float(lr.get("Strength", 1.0)),
                minimum=float(lr.get("Minimum", 0.0)),
                maximum=float(lr.get("Maximum", 100.0)),
                invert=bool(lr.get("Invert", False)),
                texture_height=life_ramp.shape[0], device=device)

    return RenderDataUniforms(
        color_from_life=cfl,
        color_from_velocity=_clamped_bezier(
            color.get("ColorFromVelocity"), 4, [1.0, 1.0, 1.0, 1.0], device),
        size_from_life=size_from_life,
        size_from_velocity=_clamped_bezier(
            c.get("SizeFromVelocity"), 1, [1.0], device),
        rotation_from_life_and_index=f32(
            [float(c.get("RotationFromLife") or 0.0),
             float(c.get("RotationFromIndex") or 0.0)]),
        velocity_rotation=f32(1.0 if c.get("RotationFromVelocity") else 0.0),
        life_ramp=life_ramp,
        life_ramp_settings=ramp_settings,
    )


def appearance_from_model(sm: SystemModel, resolver=None):
    """Configuration.Appearance -> raster ParticleAppearance (None when
    every knob is at its default — callers fall through to the plain
    additive quad path, ParticleConfiguration.cs:42-109)."""
    c = sm.configuration or {}
    a = c.get("Appearance")
    if not isinstance(a, dict):
        return None
    kw = {}
    tex = a.get("Texture")
    if tex is not None and not isinstance(tex, (str, dict)):
        tex = np.asarray(tex, np.float32)
        kw["texture"] = tex
        size_px = a.get("SizePx")
        if size_px:
            kw["columns"] = max(int(tex.shape[1] // float(size_px[0])), 1)
            kw["rows"] = max(int(tex.shape[0] // float(size_px[1])), 1)
    if a.get("AnimationRate"):
        kw["animation_rate"] = tuple(
            float(v) for v in a["AnimationRate"])
    for key, attr in (("Rounded", "rounded"),
                      ("DitheredOpacity", "dithered_opacity"),
                      ("RelativeSize", "relative_size"),
                      ("RowFromVelocity", "row_from_velocity"),
                      ("ColumnFromVelocity", "column_from_velocity")):
        if a.get(key) is not None:
            kw[attr] = bool(a[key])
    rp = a.get("RoundingPowerFromLife")
    if rp is not None:
        if isinstance(rp, dict) and "Count" in rp:
            kw["rounding_power_from_life"] = Bezier.from_json(rp, 1)
        else:
            kw["rounding_power_from_life"] = float(rp)
    if not kw:
        return None
    return ParticleAppearance(**kw)


@dataclasses.dataclass
class SystemView:
    model: SystemModel
    system: ParticleSystem
    appearance: object = None


def _carry_noise(old, new):
    """A patched Noise continues its predecessor's offset stream."""
    if isinstance(old, tx.Noise) and isinstance(new, tx.Noise):
        new._rng = old._rng
        new._offset_a, new._offset_b = old._offset_a, old._offset_b
        new._last_cycle = old._last_cycle


class EngineView:
    """ParticleEngineView (Modeling/View.cs:36-138): one live
    ParticleSystem per SystemModel on `device`, in update order."""

    def __init__(self, model: EngineModel, volume=None,
                 overrides: Optional[Dict[str, Any]] = None,
                 capacity: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        self.model = model
        self.device = torch.device(device)
        self.resolver = model.make_resolver(overrides)
        self._overrides = overrides
        self._capacity = capacity
        self._seed = seed
        self._now = 0.0
        self.systems: List[SystemView] = []
        ordered = sorted(model.systems, key=lambda s: s.update_order)
        live = instantiate_systems(ordered, self.resolver)
        for sm, transforms in zip(ordered, live):
            config = system_config_from_model(sm, self.resolver)
            if capacity:
                config = dataclasses.replace(config, capacity=capacity)
            self.systems.append(
                SystemView(
                    model=sm,
                    system=ParticleSystem(
                        config, transforms, volume=volume, seed=seed,
                        render_data=render_data_from_model(
                            sm, self.resolver, self.device),
                        device=self.device),
                    appearance=appearance_from_model(sm, self.resolver),
                )
            )
        self._wire_feedback_sources()
        # Bezier-animated properties re-derive per update (the reference
        # evaluates parameters at `now` every frame, Transforms.cs:364);
        # static models skip the per-tick re-instantiation entirely.
        self._animated = any(
            _has_bezier(t.properties)
            for sm in model.systems for t in sm.transforms
        )

    def _wire_feedback_sources(self):
        """Resolve FeedbackSpawner.SourceSystem by system name (the
        reference's SystemResolver, Modeling/View.cs:63); an unknown or
        missing name feeds the spawner's own system."""
        by_name = {sv.model.name: sv.system for sv in self.systems}
        for sv in self.systems:
            for tm, live in zip(sv.model.transforms,
                                sv.system.transforms):
                if isinstance(live, FeedbackSpawner):
                    src_name = tm.properties.get("SourceSystem")
                    if isinstance(src_name, dict):
                        src_name = src_name.get("Name")
                    live.source = by_name.get(src_name, sv.system)

    def patch_system(self, sm: SystemModel) -> bool:
        """Re-derive a system's config + transforms from its (edited)
        model and apply them to the LIVE ParticleSystem without resetting
        its state (Modeling/View.cs:199-264 reflection-patch semantics).
        Returns False when the edit is structural (capacity / transform
        count changed) and the caller must rebuild instead."""
        for sv in self.systems:
            if sv.model is sm:
                config = system_config_from_model(sm, self.resolver)
                if self._capacity:
                    config = dataclasses.replace(
                        config, capacity=self._capacity)
                if config.capacity != sv.system.config.capacity:
                    return False
                if len(sm.transforms) != len(sv.system.transforms):
                    return False
                transforms = [
                    instantiate_transform(t, self.resolver,
                                          now=self._now)
                    for t in sm.transforms
                ]
                for old, new in zip(sv.system.transforms, transforms):
                    _carry_noise(old, new)
                sv.system.patch(
                    transforms=transforms, config=config,
                    render_data=render_data_from_model(
                        sm, self.resolver, self.device))
                sv.appearance = appearance_from_model(sm, self.resolver)
                self._wire_feedback_sources()
                return True
        return False

    def refresh_variables(self,
                          overrides: Optional[Dict[str, Any]] = None
                          ) -> bool:
        """Named-variable change: rebuild the resolver and live-patch
        every system so transforms referencing the variable pick up the
        new value without a reset."""
        if overrides is not None:
            self._overrides = overrides
        self.resolver = self.model.make_resolver(self._overrides)
        # Materialize BEFORE all(): the lazy generator would stop at the
        # first structural mismatch and leave later systems stale.
        results = [self.patch_system(sv.model) for sv in self.systems]
        return all(results)

    def update(self, dt: float,
               spawn_uniforms: Optional[Dict[str, Any]] = None):
        """Advance every system by `dt` through its fixed-timestep
        `update`. `spawn_uniforms`: injected draws by system name, each
        what that system's `update` takes (one entry per tick it runs);
        a system missing from it draws from its own generator."""
        self._now += dt
        if self._animated:
            for sv in self.systems:
                self.patch_system(sv.model)
        for sv in self.systems:
            sv.system.update(dt, None if spawn_uniforms is None
                             else spawn_uniforms.get(sv.model.name))

    @property
    def live_count(self) -> int:
        return sum(sv.system.live_count for sv in self.systems)
