"""Headless editor/controller — the Lumined analog (counterpart of
illuminant_tpu/models/editor.py).

Port of the reference ParticleEditor's Controller/View layer
(ParticleEditor/Controller.cs:24 — add/remove systems and
transforms, selection state; View.cs:34-39 MockTimeProvider deterministic
stepping; View.cs:72-102 pause / queued single-step), minus the Nuklear UI:
the controller IS the capability — a notebook/CLI/UI front-end drives it
programmatically.

Editing model: every edit mutates the `EngineModel` (the persistent scene
document). PROPERTY edits then live-patch the running `EngineView`
(particle state continues — the reference's reflection-patch path,
Modeling/View.cs:199-264); STRUCTURAL edits (add/remove/duplicate) rebuild
it with a FIXED RNG seed and a mock time provider (Controller.cs
QueueReset). Either way a scripted editor session is fully deterministic
and replayable (the same edit script reproduces bit-identical state; see
tests/test_torch_editor.py). The view's systems live on the controller's
`device`; `state_digest` reads them back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from .model import (
    EngineModel,
    NamedVariableDefinition,
    SystemModel,
    TransformModel,
)
from .parameter import Parameter
from .view import EngineView


@dataclasses.dataclass
class MockTime:
    """MockTimeProvider (ParticleEditor/View.cs:34-39): time advances only
    when told to — frame stepping is exact and replayable."""

    seconds: float = 0.0

    def advance(self, dt: float):
        self.seconds += dt


@dataclasses.dataclass
class Selection:
    """Controller.cs selection state (system + transform indices)."""

    system: int = -1
    transform: int = -1


class EditorController:
    """Add/remove/edit systems & transforms, pause/step, save/load.

    All edits go through the model; property edits live-patch the running
    view (state continues mid-flight), structural edits rebuild it
    deterministically — matching the reference's split between
    reflection-patching (View.cs:199-264) and QueueReset.
    """

    def __init__(self, model: Optional[EngineModel] = None, volume=None,
                 capacity: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        self.model = model or EngineModel()
        self.volume = volume
        self.capacity = capacity
        self.seed = seed
        self.device = device
        self.time = MockTime()
        self.selection = Selection()
        self.paused = False
        self._step_pending = False  # StepPending (View.cs:73, 93)
        self._steps_taken = 0
        self.view: Optional[EngineView] = None
        self._rebuild()

    # -- structural edits (Controller.cs AddSystem/RemoveSystem etc.) ----

    def add_system(self, name: Optional[str] = None,
                   configuration: Optional[Dict[str, Any]] = None
                   ) -> SystemModel:
        sm = SystemModel(
            name=name or f"System {len(self.model.systems) + 1}",
            update_order=len(self.model.systems),
            draw_order=len(self.model.systems),
            configuration=dict(configuration or {}),
        )
        self.model.systems.append(sm)
        self.selection = Selection(system=len(self.model.systems) - 1)
        self._rebuild()
        return sm

    def remove_system(self, index: int):
        del self.model.systems[index]
        self.selection = Selection(
            system=min(index, len(self.model.systems) - 1)
        )
        self._rebuild()

    def duplicate_system(self, index: int) -> SystemModel:
        import copy

        sm = copy.deepcopy(self.model.systems[index])
        sm.name = f"{sm.name} (copy)"
        self.model.systems.append(sm)
        self.selection = Selection(system=len(self.model.systems) - 1)
        self._rebuild()
        return sm

    def add_transform(self, system_index: int, type_name: str,
                      properties: Optional[Dict[str, Any]] = None,
                      name: Optional[str] = None) -> TransformModel:
        sm = self.model.systems[system_index]
        tm = TransformModel(
            type=type_name,
            name=name or type_name,
            update_order=len(sm.transforms),
            properties=dict(properties or {}),
        )
        sm.transforms.append(tm)
        sm.sort()
        self.selection = Selection(
            system=system_index, transform=sm.transforms.index(tm)
        )
        self._rebuild()
        return tm

    def remove_transform(self, system_index: int, transform_index: int):
        sm = self.model.systems[system_index]
        del sm.transforms[transform_index]
        self.selection = Selection(system=system_index)
        self._rebuild()

    def duplicate_transform(self, system_index: int,
                            transform_index: int) -> TransformModel:
        """Controller.cs:338-345 DuplicateTransform (template.Clone() +
        append)."""
        import copy

        sm = self.model.systems[system_index]
        tm = copy.deepcopy(sm.transforms[transform_index])
        tm.update_order = len(sm.transforms)
        sm.transforms.append(tm)
        sm.sort()
        self.selection = Selection(
            system=system_index, transform=sm.transforms.index(tm)
        )
        self._rebuild()
        return tm

    def move_transform_to_back(self, system_index: int,
                               transform_index: int) -> int:
        """Controller.cs:347-357 MoveTransformToBack: reorder a transform
        to run last in its system's pass sequence."""
        sm = self.model.systems[system_index]
        tm = sm.transforms.pop(transform_index)
        sm.transforms.append(tm)
        for order, t in enumerate(sm.transforms):
            t.update_order = order
        sm.sort()
        self.selection = Selection(
            system=system_index, transform=len(sm.transforms) - 1
        )
        self._rebuild()
        return len(sm.transforms) - 1

    def change_transform_type(self, system_index: int,
                              transform_index: int, type_name: str):
        """Controller.cs:359-363 ChangeTransformType: retype in place —
        properties that exist on the new type carry over, the rest drop
        at view construction (the reference rebuilds the view the same
        way via TypeChanged)."""
        tm = self.model.systems[system_index].transforms[transform_index]
        tm.type = type_name
        self._rebuild()

    # -- property editing (PropertyEditor over the model's bags) ---------
    # Property edits LIVE-PATCH the running view — particle state, RNG
    # stream and spawn accumulators carry over, so tweaking gravity while
    # particles fly adjusts their trajectories without a restart (the
    # reference patches live objects via reflection, View.cs:199-264;
    # only structural changes queue a reset, Controller.cs QueueReset).

    def set_transform_property(self, system_index: int,
                               transform_index: int, key: str, value: Any):
        tm = self.model.systems[system_index].transforms[transform_index]
        tm.properties[key] = value
        self._patch(self.model.systems[system_index])

    def set_system_configuration(self, system_index: int, key: str,
                                 value: Any):
        self.model.systems[system_index].configuration[key] = value
        self._patch(self.model.systems[system_index])

    def set_named_variable(self, name: str, value: Any,
                           is_external: bool = True):
        """Define/overwrite a named variable (Model.cs:291-332); live
        transforms referencing it by name pick up the new value."""
        param = value if isinstance(value, Parameter) else \
            Parameter.of(value)
        self.model.named_variables[name] = NamedVariableDefinition(
            default_value=param, is_external=is_external
        )
        if self.view is None or not self.view.refresh_variables():
            self._rebuild()

    def rename_variable(self, from_name: str, to_name: str) -> bool:
        """Controller.cs:149-169 RenameVariable: fails (returns False)
        on no-op, missing source, blank or colliding target. NOTE like
        the reference, by-name references inside transforms keep the OLD
        name (they then resolve to nothing until redefined)."""
        if (not from_name or not to_name or from_name == to_name
                or not to_name.strip()):
            return False
        if from_name not in self.model.named_variables:
            return False
        if to_name in self.model.named_variables:
            return False
        self.model.named_variables[to_name] = \
            self.model.named_variables.pop(from_name)
        if self.view is None or not self.view.refresh_variables():
            self._rebuild()
        return True

    def remove_variable(self, name: str):
        """Controller.cs:171-175 RemoveVariable."""
        if name in self.model.named_variables:
            del self.model.named_variables[name]
            if self.view is None or not self.view.refresh_variables():
                self._rebuild()

    # -- selection --------------------------------------------------------

    def select(self, system: int = -1, transform: int = -1):
        self.selection = Selection(system=system, transform=transform)

    @property
    def selected_system(self) -> Optional[SystemModel]:
        if 0 <= self.selection.system < len(self.model.systems):
            return self.model.systems[self.selection.system]
        return None

    @property
    def selected_transform(self) -> Optional[TransformModel]:
        sm = self.selected_system
        if sm and 0 <= self.selection.transform < len(sm.transforms):
            return sm.transforms[self.selection.transform]
        return None

    # -- time control (View.cs:72-102) ------------------------------------

    def toggle_pause(self):
        self.paused = not self.paused

    def queue_step(self):
        """Queue exactly one step while paused (StepPending)."""
        self._step_pending = True

    def queue_reset(self):
        """Controller.cs:181-192 QueueReset: restart the simulation from
        the model (fresh state, fixed seed, MockTime zero)."""
        self._rebuild()

    def update(self, dt: float = 1.0 / 60.0, spawn_uniforms=None):
        """One editor frame: advances the engine unless paused (a queued
        single-step runs even while paused, then clears).
        `spawn_uniforms`: injected draws, as `EngineView.update` takes."""
        if self.paused and not self._step_pending:
            return
        self._step_pending = False
        self.time.advance(dt)
        if self.view is not None:
            self.view.update(dt, spawn_uniforms)
        self._steps_taken += 1

    # -- persistence / replay ----------------------------------------------

    def save(self, path: str):
        self.model.save(path)

    @staticmethod
    def load(path: str, volume=None, capacity: Optional[int] = None,
             seed: int = 0, device="cuda") -> "EditorController":
        return EditorController(EngineModel.load(path), volume=volume,
                                capacity=capacity, seed=seed, device=device)

    def state_digest(self) -> Dict[str, np.ndarray]:
        """Raw engine state per system, copied to the host — for
        replay-determinism checks (an editor action, not part of a tick;
        a copy, since the next spawn writes the state in place)."""
        out = {}
        for i, sv in enumerate(self.view.systems):
            st = sv.system.state
            for name in ("position", "velocity", "color"):
                out[f"{i}:{name}"] = getattr(st, name).cpu().numpy().copy()
        return out

    @property
    def live_count(self) -> int:
        return self.view.live_count if self.view else 0

    # -- internals ----------------------------------------------------------

    def _patch(self, sm):
        """Property edit: live-patch if possible, else fall back to the
        structural rebuild."""
        if self.view is None or not self.view.patch_system(sm):
            self._rebuild()

    def _rebuild(self):
        """Reinstantiate the live view from the model with a fixed seed
        and reset MockTime — STRUCTURAL edits only (add/remove/duplicate;
        the reference's Controller.cs QueueReset). Sessions stay
        replayable bit-for-bit: both rebuilds and live patches are
        deterministic functions of the edit script."""
        self.time = MockTime()
        self._steps_taken = 0
        self.view = EngineView(
            self.model, volume=self.volume, capacity=self.capacity,
            seed=self.seed, device=self.device,
        )
