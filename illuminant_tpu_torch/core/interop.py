"""Carry state and fields across from the JAX package.

The JAX package's objects are frozen dataclasses of arrays. `as_numpy_fields`
turns any such dataclass into a dict of numpy arrays keyed by field name
(nested dataclasses become nested dicts, Python values pass through); it
walks `dataclasses.fields` and calls `np.asarray`, so it needs no jax.
`to_torch` builds the port's counterpart from such a dict on a device.
It covers SdfVolume (with its config), ColumnField, ParticleState,
SphereLights, EnvironmentUniforms, GBuffer, SpawnUniforms, GravityUniforms
and SystemUniforms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..lighting.environment import EnvironmentUniforms, SphereLights
from ..lighting.gbuffer import GBuffer
from ..particles.spawner import SpawnUniforms
from ..particles.state import ParticleState, SystemUniforms
from ..particles.transforms import GravityUniforms
from ..sdf.columns import ColumnField
from ..sdf.volume import SdfVolume, SdfVolumeConfig

# Fields that hold a nested dataclass, by owner type.
_NESTED = {
    SdfVolume: {"config": SdfVolumeConfig},
    ColumnField: {"volume": SdfVolume},
}

SUPPORTED = (SdfVolume, SdfVolumeConfig, ColumnField, ParticleState,
             SphereLights, EnvironmentUniforms, GBuffer, SpawnUniforms,
             GravityUniforms, SystemUniforms)


def as_numpy_fields(obj) -> Dict[str, Any]:
    """Dataclass -> {field name: numpy array | nested dict | value}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = as_numpy_fields(v)
        elif v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def to_torch(cls, fields: Dict[str, Any], device=None):
    """Build the port's `cls` from a dict keyed by field name. Arrays
    become tensors on `device` (dtype kept); nested dicts become the
    nested dataclass; other values pass through. Keys the port's class
    does not have must hold None (JAX-side options the port leaves out)."""
    if cls not in SUPPORTED:
        raise TypeError(f"no interop for {cls.__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    extra = [k for k, v in fields.items() if k not in names and v is not None]
    if extra:
        raise ValueError(f"{cls.__name__} has no fields {extra} in the port")
    kwargs = {}
    for name in names:
        if name not in fields:
            continue
        v = fields[name]
        nested = _NESTED.get(cls, {}).get(name)
        if nested is not None:
            v = to_torch(nested, v, device)
        elif isinstance(v, np.ndarray):
            v = torch.as_tensor(np.array(v), device=device)
        kwargs[name] = v
    return cls(**kwargs)
