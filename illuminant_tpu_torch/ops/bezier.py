"""Clamped bezier evaluation (counterpart of illuminant_tpu/ops/bezier.py).

A `ClampedBezier` packs up to four control points of C channels and a
(min, inv_divisor, count, mode) header (Bezier.fxh:21-177, Bezier.cs:
432-833). Evaluation is branchless over any batch of input values:
count <= 1 constant, 2 lerp, 3 the "shelf" step, 4 cubic de Casteljau;
mode % 256 picks linear / sine / exp time, bit 256 loops, bit 512 bounces,
a negative inv_divisor reverses time. `BezierM` interpolates
DynamicMatrix control points (Bezier.cs:379-424).
"""

from __future__ import annotations

import math

import torch

from ..core.pytree import tensor_dataclass

MODE_LINEAR = 0
MODE_SINE = 1
MODE_EXP = 2
MODE_LOOP_BIT = 256
MODE_BOUNCE_BIT = 512


@tensor_dataclass
class ClampedBezier:
    """range_and_count (4,) = (min_value, inv_divisor, count, mode);
    points (4, C) control points a, b, c, d (unused rows 0).
    `is_constant`: a single-point bezier evaluates to points[0]."""

    range_and_count: torch.Tensor
    points: torch.Tensor
    is_constant: bool = False

    @property
    def channels(self) -> int:
        return self.points.shape[-1]


def pack_bezier(points, min_value: float = 0.0, max_value: float = 1.0,
                mode: int = MODE_LINEAR, device=None) -> ClampedBezier:
    """ClampedBezier from a list of control points (Bezier.cs
    ClampedBezier1/2/4): inv_divisor = 1 / (max - min)."""
    pts = torch.as_tensor(points, dtype=torch.float32, device=device)
    pts = torch.atleast_2d(pts)
    count = pts.shape[0]
    if count > 4:
        raise ValueError("bezier supports at most 4 control points")
    pad = torch.zeros((4 - count, pts.shape[1]), dtype=torch.float32,
                      device=pts.device)
    divisor = max_value - min_value
    inv = 1.0 if divisor == 0.0 else 1.0 / divisor
    rc = torch.tensor([min_value, inv, float(count), float(mode)],
                      dtype=torch.float32, device=pts.device)
    return ClampedBezier(range_and_count=rc,
                         points=torch.cat([pts, pad], dim=0))


def constant_bezier(value, device=None) -> ClampedBezier:
    v = torch.atleast_1d(torch.as_tensor(value, dtype=torch.float32,
                                         device=device))
    return pack_bezier(v[None, :], device=device).replace(is_constant=True)


def t_for_scaled_bezier(range_and_count, value):
    """tForScaledBezier (Bezier.fxh:21-63) -> (count, t). fmod keeps the
    sign of the dividend, like HLSL `%`."""
    rc = range_and_count
    min_value, inv_divisor, count, mode_f = rc[0], rc[1], rc[2], rc[3]
    mode = torch.abs(mode_f).to(torch.int32)
    repeating = mode > 255
    bouncing = mode > 511
    reverse = inv_divisor < 0

    t = (value - min_value) * torch.abs(inv_divisor)

    tb = t * 2.0
    tb = torch.where(reverse, 2.0 - torch.fmod(tb, 2.0), torch.fmod(tb, 2.0))
    tb = torch.where(tb > 1.0, 2.0 - tb, tb)

    tr = torch.where(reverse, 1.0 - torch.fmod(t, 1.0), torch.fmod(t, 1.0))

    tc = torch.clamp(t, 0.0, 1.0)
    tc = torch.where(reverse, 1.0 - tc, tc)

    t = torch.where(bouncing, tb, torch.where(repeating, tr, tc))

    base_mode = torch.remainder(mode, 256)
    t = torch.where(base_mode == MODE_SINE, torch.sin(t * (math.pi * 0.5)), t)
    t = torch.where(base_mode == MODE_EXP, t * t, t)
    return count, t


def evaluate_at_t(points, count, t):
    """De Casteljau with constant / linear / shelf shortcuts
    (Bezier.fxh:65-95). points (4, C), t (...) -> (..., C)."""
    a, b, c, d = points[0], points[1], points[2], points[3]
    tt = t[..., None]

    ab = a + (b - a) * tt
    bc = b + (c - b) * tt
    cd = c + (d - c) * tt
    abbc = ab + (bc - ab) * tt
    bccd = bc + (cd - bc) * tt
    cubic = abbc + (bccd - abbc) * tt

    shelf = torch.where(tt <= 0.0, a, torch.where(tt >= 1.0, c, b))

    result = torch.where(
        count <= 1.5, a,
        torch.where(count <= 2.5, ab, torch.where(count <= 3.5, shelf,
                                                  cubic)))
    return torch.broadcast_to(result, tuple(t.shape) + (points.shape[-1],))


def evaluate_bezier(bezier: ClampedBezier, value):
    """Evaluate at `value` (any batch shape) -> value.shape + (C,)."""
    value = torch.as_tensor(value, dtype=torch.float32,
                            device=bezier.points.device)
    if bezier.is_constant:
        return torch.broadcast_to(bezier.points[0],
                                  tuple(value.shape) + (bezier.channels,))
    count, t = t_for_scaled_bezier(bezier.range_and_count, value)
    return evaluate_at_t(bezier.points, count, t)


@tensor_dataclass
class DynamicMatrix:
    """Squared.Render DynamicMatrix: an explicit 4x4 row-vector matrix, or
    one generated from (angle degrees, scale, translation) when
    `is_dynamic` > 0.5."""

    matrix: torch.Tensor  # (4, 4)
    angle: torch.Tensor  # ()
    scale: torch.Tensor  # ()
    translation: torch.Tensor  # (3,)
    is_dynamic: torch.Tensor  # ()

    @staticmethod
    def from_components(angle=0.0, scale=1.0, translation=(0.0, 0.0, 0.0),
                        device=None):
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        return DynamicMatrix(
            matrix=torch.eye(4, dtype=torch.float32, device=device),
            angle=f32(angle), scale=f32(scale),
            translation=f32(translation), is_dynamic=f32(1.0))

    def regenerate(self):
        """rotation(angle) * scale + translation when dynamic, the
        explicit matrix otherwise."""
        rad = self.angle * (math.pi / 180.0)
        c = torch.cos(rad) * self.scale
        s = torch.sin(rad) * self.scale
        tx, ty, tz = (self.translation[..., 0], self.translation[..., 1],
                      self.translation[..., 2])
        z = torch.zeros_like(c)
        one = torch.ones_like(c)
        gen = torch.stack([
            torch.stack([c, s, z, z], dim=-1),
            torch.stack([-s, c, z, z], dim=-1),
            torch.stack([z, z, self.scale * one, z], dim=-1),
            torch.stack([tx, ty, tz, one], dim=-1),
        ], dim=-2)
        return torch.where(self.is_dynamic > 0.5, gen, self.matrix)


@tensor_dataclass
class BezierM:
    """Bezier over DynamicMatrix: the time header plus four controls."""

    range_and_count: torch.Tensor
    a: DynamicMatrix
    b: DynamicMatrix
    c: DynamicMatrix
    d: DynamicMatrix


def pack_bezier_matrix(points, min_value=0.0, max_value=1.0,
                       mode=MODE_LINEAR, device=None) -> BezierM:
    pts = list(points)
    if not 1 <= len(pts) <= 4:
        raise ValueError("BezierM supports 1-4 control matrices")
    while len(pts) < 4:
        pts.append(pts[-1])
    header = pack_bezier([[0.0]] * min(len(points), 4), min_value,
                         max_value, mode, device=device).range_and_count
    header = header.clone()
    header[2] = float(len(points))
    return BezierM(range_and_count=header, a=pts[0], b=pts[1], c=pts[2],
                   d=pts[3])


def evaluate_bezier_matrix(bm: BezierM, value) -> torch.Tensor:
    """Bezier.cs:379-424: fully dynamic controls interpolate (angle,
    scale) and translation, then regenerate; otherwise the four matrix
    rows interpolate componentwise. -> (4, 4)."""
    value = torch.as_tensor(value, dtype=torch.float32,
                            device=bm.range_and_count.device)
    count, t = t_for_scaled_bezier(bm.range_and_count, value)
    ctrl = (bm.a, bm.b, bm.c, bm.d)
    fully_dynamic = ((bm.a.is_dynamic > 0.5) & (bm.b.is_dynamic > 0.5)
                     & (bm.c.is_dynamic > 0.5) & (bm.d.is_dynamic > 0.5))

    ang_scale = torch.stack([torch.stack([m.angle, m.scale]) for m in ctrl])
    p = evaluate_at_t(ang_scale, count, t)
    trans = torch.stack([
        torch.cat([m.translation, torch.ones(1, dtype=torch.float32,
                                             device=value.device)])
        for m in ctrl])
    tr = evaluate_at_t(trans, count, t)
    dyn = DynamicMatrix(
        matrix=torch.eye(4, dtype=torch.float32, device=value.device),
        angle=p[..., 0], scale=p[..., 1], translation=tr[..., :3],
        is_dynamic=torch.ones((), dtype=torch.float32, device=value.device),
    ).regenerate()

    rows = []
    for r in range(4):
        rows_ctrl = torch.stack([m.regenerate()[r] for m in ctrl])
        rows.append(evaluate_at_t(rows_ctrl, count, t))
    mat = torch.stack(rows, dim=-2)
    return torch.where(fully_dynamic, dyn, mat)
