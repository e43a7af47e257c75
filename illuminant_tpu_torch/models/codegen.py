"""SaveAsCode: compile an EngineModel to explicit construction code
(counterpart of illuminant_tpu/models/codegen.py).

The reference's Model.Codegen.cs (invoked from Model.cs:122-132) emits a
C# class that reconstructs every system, transform, and named variable
with explicit constructor calls — the "compiled model" path that
TestGame's LoadCompiledModel scene builds against (TestGame.cs:93-95).

`save_as_code` walks the model through the same instantiation mapping the
live binding uses (view.py) and emits a standalone module whose
`build_systems(volume=None, capacity=None, device="cuda")` constructs the
port's ParticleSystemConfig / spawner / transform objects DIRECTLY on
`device` — no JSON parsing, no property-bag reflection at load time.
Beyond the JAX package's emitter, the module wires each FeedbackSpawner
to its source system as the view does, and seeds each Noise as the view
does (its place among the model's Noises), so that a model with either
compiles. Fidelity contract: the emitted systems step bit-identically to
EngineView(model)'s on the same device (tests/test_torch_codegen.py,
`chip_smoke.py`'s `reference_models` on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np

from ..particles.spawner import FeedbackSpawner
from .model import EngineModel
from .view import instantiate_systems, system_config_from_model

_HEADER = '''"""Machine-generated by illuminant_tpu_torch.models.codegen.save_as_code
from {source!r} — edit the scene, not this file."""

from illuminant_tpu_torch.particles.formula import Formula1, Formula3, Formula4
from illuminant_tpu_torch.particles.spawner import (
    FeedbackSpawner,
    PatternSpawner,
    Spawner,
)
from illuminant_tpu_torch.particles.system import (
    ParticleSystem,
    ParticleSystemConfig,
)
from illuminant_tpu_torch.particles.transforms import (
    FMA,
    Attractor,
    GeometricTransform,
    Gravity,
    MatrixMultiply,
    Noise,
    Sensor,
    TransformArea,
    VectorField,
)

import numpy as np

NAMED_VARIABLES = {named_variables}


def build_systems(volume=None, capacity=None, device="cuda"):
    """Construct the model's live systems explicitly (no JSON) on
    `device`."""
    systems = []
{body}
    return systems
'''


def _emit(value: Any, indent: int = 0) -> str:
    """Emit a constructor expression for a host-side config value."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        cls = type(value).__name__
        args = []
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            d = f.default
            if d is not dataclasses.MISSING and _equal(v, d):
                continue  # omit defaults for readable output
            if d is dataclasses.MISSING and \
                    f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                if _equal(v, f.default_factory()):  # type: ignore[misc]
                    continue
            args.append(f"{f.name}={_emit(v)}")
        return f"{cls}({', '.join(args)})"
    if isinstance(value, (np.floating, np.integer)):
        return repr(value.item())
    if isinstance(value, np.ndarray):
        return f"np.array({value.tolist()!r}, np.float32)"
    if isinstance(value, tuple):
        inner = ", ".join(_emit(v) for v in value)
        return f"({inner},)" if len(value) == 1 else f"({inner})"
    if isinstance(value, list):
        return "[" + ", ".join(_emit(v) for v in value) + "]"
    if isinstance(value, np.random.Generator):
        return _emit_generator(value)
    if isinstance(value, (bool, int, str, type(None))):
        return repr(value)
    if isinstance(value, float):
        return repr(value)
    raise TypeError(
        f"save_as_code cannot emit {type(value).__name__}: {value!r}"
    )


def _equal(a, b) -> bool:
    try:
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return bool(np.array_equal(a, b))
        return bool(a == b)
    except Exception:
        return False


def _emit_generator(g: np.random.Generator) -> str:
    """A numpy Generator that has drawn nothing yet, as the call that
    seeds it; one that has drawn cannot be rebuilt from its seed."""
    seed = g.bit_generator.seed_seq.entropy
    if (not isinstance(seed, int) or np.random.default_rng(
            seed).bit_generator.state != g.bit_generator.state):
        raise TypeError("save_as_code cannot emit a Generator that has "
                        "drawn numbers")
    return f"np.random.default_rng({seed!r})"


def save_as_code(model: EngineModel, writer=None) -> str:
    """Emit the compiled-model module source (and write it if `writer`)."""
    resolver = model.make_resolver()
    ordered = sorted(model.systems, key=lambda s: s.update_order)
    index = {sm.name: i for i, sm in enumerate(ordered)}
    body_lines: List[str] = []
    wiring: List[str] = []
    for i, (sm, live) in enumerate(
            zip(ordered, instantiate_systems(ordered, resolver))):
        body_lines.append(f"    # -- system {sm.name!r} --")
        config = system_config_from_model(sm)
        body_lines.append(
            "    config = dataclasses_replace_capacity("
            f"{_emit(config)}, capacity)"
        )
        body_lines.append("    transforms = [")
        for j, (tm, t) in enumerate(zip(sm.transforms, live)):
            body_lines.append(f"        {_emit(t)},")
            if isinstance(t, FeedbackSpawner):
                src_name = tm.properties.get("SourceSystem")
                if isinstance(src_name, dict):
                    src_name = src_name.get("Name")
                wiring.append(f"    systems[{i}].transforms[{j}].source = "
                              f"systems[{index.get(src_name, i)}]")
        body_lines.append("    ]")
        body_lines.append(
            "    systems.append(ParticleSystem(config, transforms, "
            "volume=volume, device=device))"
        )
    if wiring:
        body_lines.append("    # FeedbackSpawner sources, by SourceSystem "
                          "name (the spawner's own system by default)")
        body_lines.extend(wiring)

    named = {
        name: (
            defn.default_value.evaluate(0.0, resolver).tolist(),
            defn.is_external,
        )
        for name, defn in model.named_variables.items()
    }

    src = _HEADER.format(
        source=model.filename or "<memory>",
        named_variables=repr(named),
        body="\n".join(body_lines) if body_lines else "    pass",
    )
    src += '''

def dataclasses_replace_capacity(config, capacity):
    if capacity is None:
        return config
    import dataclasses

    return dataclasses.replace(config, capacity=capacity)
'''
    if writer is not None:
        writer.write(src)
    return src
