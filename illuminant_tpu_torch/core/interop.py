"""Carry state and fields across from the JAX package.

The JAX package's objects are frozen dataclasses of arrays. `as_numpy_fields`
turns any such dataclass into a dict of numpy arrays keyed by field name
(nested dataclasses become nested dicts, tuples stay tuples converted
element by element, Python values pass through); it walks
`dataclasses.fields` and calls `np.asarray`, so it needs no jax.
`to_torch` builds the port's counterpart from such a dict on a device.
It covers AnalyticScene (with its packed height-volume polygons),
HeightVolumes, SdfVolume (with its config and whatever `max_valid_z` a
partial regeneration left), SdfObstructions, ColumnField, ParticleState,
SphereLights (with ramp textures), DirectionalLights, LineLights,
VolumetricLights, ProjectorLights (with its tuple of mip levels),
LightProbes, EnvironmentUniforms, GBuffer (a windowed view with its
`pixel_origin`, or one written by height volumes and billboards),
SystemUniforms, the
particle engine's uniforms (SpawnUniforms, FeedbackUniforms,
GravityUniforms, FMAUniforms, MatrixMultiplyUniforms, NoiseUniforms,
VectorFieldUniforms, AreaUniforms; RenderDataUniforms with its beziers and
life ramp), RandomField and SpriteTable. Static fields
(`use_velocity_rotation`, `is_constant`, a sprite table's bin counts, size
range and residual) stay Python ints and floats.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..lighting.directional import DirectionalLights
from ..lighting.environment import EnvironmentUniforms, SphereLights
from ..lighting.gbuffer import GBuffer
from ..lighting.line import LineLights
from ..lighting.probes import LightProbes
from ..lighting.projector import ProjectorLights
from ..lighting.volumetric import VolumetricLights
from ..ops.bezier import ClampedBezier
from ..ops.noise import RandomField
from ..particles.render_data import RenderDataUniforms
from ..particles.spawner import FeedbackUniforms, SpawnUniforms
from ..particles.state import ParticleState, SystemUniforms
from ..particles.transforms import (AreaUniforms, FMAUniforms,
                                    GravityUniforms, MatrixMultiplyUniforms,
                                    NoiseUniforms, VectorFieldUniforms)
from ..raster.sprites import SpriteTable
from ..sdf.analytic import AnalyticScene
from ..sdf.columns import ColumnField
from ..sdf.height_volume import HeightVolumes
from ..sdf.volume import SdfObstructions, SdfVolume, SdfVolumeConfig

# Fields that hold a nested dataclass (or None), by owner type.
_NESTED = {
    SdfVolume: {"config": SdfVolumeConfig},
    ColumnField: {"volume": SdfVolume},
    AnalyticScene: {"polygons": HeightVolumes},
    FeedbackUniforms: {"base": SpawnUniforms},
    RenderDataUniforms: {name: ClampedBezier for name in (
        "color_from_life", "color_from_velocity", "size_from_life",
        "size_from_velocity")},
    **{cls: {"area": AreaUniforms} for cls in (
        FMAUniforms, MatrixMultiplyUniforms, NoiseUniforms,
        VectorFieldUniforms)},
}

SUPPORTED = (AnalyticScene, HeightVolumes, SdfVolume, SdfVolumeConfig,
             SdfObstructions, ColumnField, ParticleState, SphereLights,
             DirectionalLights, LineLights, LightProbes,
             VolumetricLights, ProjectorLights, EnvironmentUniforms, GBuffer,
             SystemUniforms, SpawnUniforms, FeedbackUniforms, GravityUniforms,
             FMAUniforms, MatrixMultiplyUniforms, NoiseUniforms,
             VectorFieldUniforms, AreaUniforms, RenderDataUniforms,
             ClampedBezier, RandomField, SpriteTable)


def _as_numpy(v):
    if dataclasses.is_dataclass(v):
        return as_numpy_fields(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        # Per-group arrays of differing lengths and static ints: never
        # stacked into one array.
        return tuple(_as_numpy(e) for e in v)
    return np.asarray(v)


def as_numpy_fields(obj) -> Dict[str, Any]:
    """Dataclass -> {field name: numpy array | nested dict | tuple | value}."""
    return {f.name: _as_numpy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _tensors(v, device):
    if isinstance(v, np.ndarray):
        return torch.as_tensor(np.array(v), device=device)
    if isinstance(v, tuple):
        return tuple(_tensors(e, device) for e in v)
    return v


def to_torch(cls, fields: Dict[str, Any], device=None):
    """Build the port's `cls` from a dict keyed by field name. Arrays
    become tensors on `device` (dtype kept), also inside tuples; nested
    dicts become the nested dataclass; other values pass through. Keys
    the port's class does not have must hold None (JAX-side options the
    port leaves out)."""
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
        kwargs[name] = (to_torch(nested, v, device)
                        if nested is not None and v is not None
                        else _tensors(v, device))
    return cls(**kwargs)
