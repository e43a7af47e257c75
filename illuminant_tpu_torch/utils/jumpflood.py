"""Jump-flood 2D distance fields from masks.

Counterpart of illuminant_tpu/utils/jumpflood.py (the JumpFlooding scene's
JFA, TestGame/Scenes/JumpFlooding.cs:19,35): each pass reads the 8
neighbours at stride k as rolls of the (seed_x, seed_y, best_d2) planes
with a min-select. The update order is the JAX package's: each offset of
a pass rolls the planes the previous offset already updated (not a
Jacobi pass over a frozen copy). log2(max(H, W)) + 2 passes; the result
is a signed distance, negative inside the mask.
"""

from __future__ import annotations

import math

import torch


def _flood(inside_mask):
    """One-sided JFA: squared distance (H, W) float32 from every pixel to
    the nearest masked pixel."""
    h, w = inside_mask.shape
    dev = inside_mask.device
    f32 = torch.float32
    ys = torch.arange(h, dtype=f32, device=dev)[:, None] * torch.ones(
        (1, w), dtype=f32, device=dev)
    xs = torch.arange(w, dtype=f32, device=dev)[None, :] * torch.ones(
        (h, 1), dtype=f32, device=dev)
    seed_y = torch.where(inside_mask, ys, -1e6)
    seed_x = torch.where(inside_mask, xs, -1e6)
    best = torch.where(inside_mask, 0.0, 1e12)

    k = 1 << max(int(math.ceil(math.log2(max(h, w)))) - 1, 0)
    steps = []
    while k >= 1:
        steps.append(k)
        k //= 2
    steps.append(1)  # JFA+1 clean-up pass

    for k in steps:
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cy = torch.roll(seed_y, (dy, dx), dims=(0, 1))
                cx = torch.roll(seed_x, (dy, dx), dims=(0, 1))
                # Wrapped-in pixels carry far seeds (-1e6) and lose.
                d2 = (cy - ys) ** 2 + (cx - xs) ** 2
                better = d2 < best
                best = torch.where(better, d2, best)
                seed_y = torch.where(better, cy, seed_y)
                seed_x = torch.where(better, cx, seed_x)
    return best


def jump_flood_sdf(mask, device="cuda"):
    """(H, W) bool / 0-1 mask (numpy or tensor) -> (H, W) float32 signed
    distance in pixels on `device`, negative inside (the
    Squared.Render.DistanceField.JumpFlood equivalent)."""
    inside = torch.as_tensor(mask, device=device).to(torch.float32) > 0.5
    d_out = _sqrt(_flood(inside))
    d_in = _sqrt(_flood(~inside))
    return torch.where(inside, -d_in, d_out)


def _sqrt(d2):
    """The float32 square root, rounded once on every device: taken in
    float64 and rounded to float32, which is the correctly rounded float32
    root. torch's float32 sqrt on the H100 is not correctly rounded
    everywhere (it differed from the CPU's by an ulp on 116 of the
    131,072 distances of a 256 x 256 mask)."""
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32)
