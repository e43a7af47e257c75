"""The scan readout's cases, shared by its CPU tests
(tests/test_torch_scan_readout.py, against the JAX package) and its card
tests (tests/test_torch_scan_readout_cuda.py, K2 against the plain
version): small scenes of every field kind and the `scan_visibility`
options that reach each branch of the readout. Imports neither jax nor
the JAX package."""

from __future__ import annotations

import math

import numpy as np
import torch

from illuminant_tpu_torch.core.config import QualitySettings
from illuminant_tpu_torch.lighting import scan_shadows
from illuminant_tpu_torch.lighting.environment import (LightingEnvironment,
                                                       LightObstruction)
from illuminant_tpu_torch.ops import sdf_primitives as sp
from illuminant_tpu_torch.sdf import analytic
from illuminant_tpu_torch.sdf import height_volume as hv
from illuminant_tpu_torch.sdf.columns import build_column_maps
from illuminant_tpu_torch.sdf.volume import SdfVolumeConfig, generate_volume

GRID = (48, 80)
# A box turned 30 degrees about z (half-angle 15), as the 2.5D cell's.
TURNED = (0.0, 0.0, math.sin(math.radians(15.0)),
          math.cos(math.radians(15.0)))
# Lights: inside the frame, high; low near a corner; outside the frame.
LIGHTS = np.asarray([[20.0, 14.0, 30.0], [66.0, 38.0, 18.0],
                     [-40.0, 20.0, 26.0]], np.float32)
RADIUS = np.asarray([4.0, 2.0, 6.0], np.float32)
RAMP = np.asarray([200.0, 120.0, 400.0], np.float32)
TRACE_Z = 9.0
WINDOW = (12.0, 6.0)


def obstructions(kind: str):
    """Host obstructions: "prisms" (a turned box, a cylinder, an
    ellipsoid, a box: the 2.5D cell's kinds) or "four" (four unturned
    primitives, the flagship's kind of scene)."""
    box, cyl, ell = sp.TYPE_BOX, sp.TYPE_CYLINDER, sp.TYPE_ELLIPSOID
    if kind == "prisms":
        spec = [(box, (30.0, 16.0, 10.0), (5.0, 3.0, 10.0), TURNED),
                (cyl, (56.0, 12.0, 12.0), (3.0, 3.0, 12.0), None),
                (ell, (12.0, 30.0, 9.0), (4.0, 3.0, 9.0), None),
                (box, (42.0, 40.0, 5.0), (3.0, 2.0, 5.0), None)]
    else:
        spec = [(box, (24.0, 24.0, 8.0), (6.0, 4.0, 8.0), None),
                (cyl, (52.0, 16.0, 10.0), (4.0, 4.0, 10.0), None),
                (ell, (60.0, 36.0, 6.0), (5.0, 3.0, 6.0), None),
                (sp.TYPE_SPHEROID, (14.0, 12.0, 7.0), (3.0, 4.0, 5.0),
                 None)]
    return [LightObstruction(t, c, s, rotation=q or (0.0, 0.0, 0.0, 1.0))
            for t, c, s, q in spec]


# Height volumes of the "prisms" scene as (polygon, z_base, height): a
# square block and a concave hexagon, extruded prisms of 4 and 6 edges.
VOLUMES = [([(36.0, 24.0), (44.0, 24.0), (44.0, 32.0), (36.0, 32.0)], 0.0,
            14.0),
           ([(62.0, 20.0), (70.0, 22.0), (72.0, 28.0), (66.0, 27.0),
             (70.0, 34.0), (60.0, 32.0)], 0.0, 11.0)]


def volume_config(grid=GRID):
    h, w = grid
    return SdfVolumeConfig(virtual_width=w, virtual_height=h,
                           virtual_depth=64, slice_count=16,
                           resolution_scale=0.5)


def field(kind: str, device, grid=GRID):
    """The port's field of a case: "prisms" (an AnalyticScene with the
    turned box and two extruded polygons), "four" (an AnalyticScene),
    "volume" (an SdfVolume of "four"), "columns" (its ColumnField)."""
    if kind in ("prisms", "four"):
        vols = ([hv.HeightVolume(polygon=p, z_base=z, height=h)
                 for p, z, h in VOLUMES] if kind == "prisms" else None)
        return analytic.pack_scene(obstructions(kind), height_volumes=vols,
                                   device=device)
    env = LightingEnvironment()
    env.obstructions += obstructions("four")
    vol = generate_volume(volume_config(grid),
                          env.pack_obstructions(device=device))
    return vol if kind == "volume" else build_column_maps(vol)


# Each case: its field and the options that differ from the default (one
# exact candidate, nomination at half the grid, no heights, no offsets).
CASES = {
    "prisms": dict(field="prisms", pz="hw", oxy="hw"),
    "four": dict(field="four"),
    "volume": dict(field="volume"),
    "volume_s3_h0": dict(field="volume", samples=3, nomination=1.0),
    "columns_carried": dict(field="columns"),
    "columns_carried_s3_h2": dict(field="columns", samples=3,
                                  nomination=0.25),
    "carried_all_s2": dict(field="four", mode="carried_all", samples=2),
    "flat_budget": dict(field="prisms", samples=0, mtd=True, pz="hw"),
    "flat_h0": dict(field="four", samples=0, nomination=1.0),
    "s2_lanes": dict(field="prisms", samples=2, pz="lhw", oxy="lhw"),
    "s3_h2": dict(field="prisms", samples=3, nomination=0.25, pz="hw"),
    "budget": dict(field="four", mtd=True, pz="lhw"),
    "windowed": dict(field="prisms", window=True, pz="hw", oxy="hw"),
    "columns_windowed": dict(field="columns", window=True),
    "odd_edges": dict(field="prisms", grid=(100, 164), nomination=0.25,
                      pz="hw", oxy="hw"),
    "power": dict(field="four", power=1.7),
}


def quality(case: dict) -> dict:
    """The case's QualitySettings keywords."""
    return dict(scan_refine_samples=case.get("samples", 1),
                scan_nomination_scale=case.get("nomination", 0.5),
                scan_refine_mode=case.get("mode", "carried"),
                occlusion_to_opacity_power=case.get("power", 1.0))


def inputs(case: dict) -> dict:
    """The case's arrays as numpy float32: lights, heights, offsets,
    trace budget, window."""
    h, w = case.get("grid", GRID)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32) + 0.5,
                         np.arange(w, dtype=np.float32) + 0.5,
                         indexing="ij")
    lanes = np.arange(len(LIGHTS), dtype=np.float32)[:, None, None]
    out = dict(light_position=LIGHTS, light_radius=RADIUS,
               light_ramp_length=RAMP)
    pz = (2.0 + 1.5 * np.sin(xs / 7.0 + ys / 5.0)).astype(np.float32)
    if case.get("pz") == "hw":
        out["pixel_z"] = pz
    elif case.get("pz") == "lhw":
        out["pixel_z"] = (pz[None] + 0.5 * lanes).astype(np.float32)
    oxy = np.stack([0.8 * np.sin(xs / 9.0), 0.6 * np.cos(ys / 6.0)
                    + 0.05 * (ys - h / 2)], -1).astype(np.float32)
    if case.get("oxy") == "hw":
        out["pixel_offset_xy"] = oxy
    elif case.get("oxy") == "lhw":
        out["pixel_offset_xy"] = (oxy[None] * (1.0 + 0.25 * lanes[..., None])
                                  ).astype(np.float32)
    if case.get("mtd"):
        out["max_trace_distance"] = np.asarray([30.0, 12.0, 1e8],
                                               np.float32)
    if case.get("window"):
        out["world_offset"] = np.asarray(WINDOW, np.float32)
    return out


def port_scan(fld, case: dict, device):
    """`scan_visibility` of the case on the port's field -> the
    visibility (L, H, W) and the (args, kwargs) of its one
    `scan_readout` call."""
    h, w = case.get("grid", GRID)
    arrays = {k: torch.as_tensor(v, device=device)
              for k, v in inputs(case).items()}
    calls = []
    real = scan_shadows.scan_readout

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    scan_shadows.scan_readout = spy
    try:
        vis = scan_shadows.scan_visibility(
            fld, h, w, quality=QualitySettings(**quality(case)),
            trace_z=TRACE_Z, **arrays)
    finally:
        scan_shadows.scan_readout = real
    assert len(calls) == 1
    return vis, calls[0]
