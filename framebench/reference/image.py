"""The particle splat, the luminance histogram and the tonemap, in plain
PyTorch.

The splat adds each live on-screen particle's colour times a row and a
column profile (the Gaussian glow's (1 - q/8)^8 chain, or the quad's
linear edge) to every pixel of its footprint inside its screen tile's
window (`tile` pixels plus `apron` on each side). The histogram buckets
Rec.601 luma on log-spaced bounds (Histogram.cs:62-75) and interpolates a
percentile inside its bucket; the tonemap is the Uncharted2 curve
(HDR.fxh:24-45) with a 1/2.2 gamma.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def profile(kernel: str, d, radius):
    """1-D coverage at signed distance d from a particle's centre."""
    if kernel == "quad":
        return torch.clamp(radius - torch.abs(d) + 0.5, 0.0, 1.0)
    if kernel == "gauss":
        sigma = torch.clamp(radius * 0.5, min=0.3)
        q = 0.5 * (d / sigma) ** 2
        base = torch.clamp(1.0 - q * 0.125, min=0.0)
        b2 = base * base
        b4 = b2 * b2
        return b4 * b4
    raise ValueError(f"no reference for the {kernel!r} kernel")


def support(kernel: str, radius: float) -> float:
    """The half-width past which `profile` is exactly 0."""
    if kernel == "gauss":
        return 4.0 * max(radius * 0.5, 0.3)
    return radius + 0.5


def selection(cfg, x, y, size, live):
    """The live on-screen particles -> (indices, x, y, radius)."""
    a = cfg["apron"]
    onscreen = ((x > -(a + 1.0)) & (x < cfg["width"] + a + 1.0)
                & (y > -(a + 1.0)) & (y < cfg["height"] + a + 1.0))
    sel = torch.nonzero(live & onscreen).squeeze(1)
    return sel, x[sel], y[sel], torch.clamp(size[sel] * 0.5, 0.5, a + 0.5)


def footprints(cfg, x, y, radius):
    """((pixel x, wx), (pixel y, wy)), each (n, 2k + 1): every particle's
    taps on both axes, weight 0 outside its tile's window."""
    t, a = cfg["tile"], cfg["apron"]
    gy, gx = -(-cfg["height"] // t), -(-cfg["width"] // t)
    k = int(math.ceil(support(cfg["kernel"], float(torch.amax(radius))))) + 1
    offsets = torch.arange(-k, k + 1, device=x.device)

    def axis(p, g, extent):
        tile = torch.clamp((p / t).to(torch.int64), 0, g - 1)
        lo = torch.clamp(tile * t - a, min=0)
        hi = torch.clamp(tile * t + t + a, max=extent)
        pix = torch.floor(p).to(torch.int64)[:, None] + offsets
        w = profile(cfg["kernel"], pix.to(torch.float32) + 0.5 - p[:, None],
                    radius[:, None])
        inside = (pix >= lo[:, None]) & (pix < hi[:, None])
        return torch.clamp(pix, 0, extent - 1), torch.where(inside, w, 0.0)

    return axis(x, gx, cfg["width"]), axis(y, gy, cfg["height"])


def splat(cfg, x, y, color, size, live):
    """The additive image (H, W, C) of C = cfg["channels"]."""
    h, w, ch = cfg["height"], cfg["width"], cfg["channels"]
    sel, x, y, radius = selection(cfg, x, y, size, live)
    img = torch.zeros((h * w, ch), dtype=torch.float32, device=x.device)
    if sel.numel() == 0:
        return img.reshape(h, w, ch)
    rgb = color[sel, :ch]
    (px, wx), (py, wy) = footprints(cfg, x, y, radius)
    for j in range(wy.shape[1]):
        wgt = wy[:, j:j + 1] * wx
        img.index_add_(0, (py[:, j:j + 1] * w + px).reshape(-1),
                       (wgt[..., None] * rgb[:, None, :]).reshape(-1, ch))
    return img.reshape(h, w, ch)


def bucket_bounds(max_value=64.0, power=2.0, buckets=64):
    max_log = np.log(1.0 + max_value) / np.log(power)
    i = np.arange(1, buckets + 1, dtype=np.float64)
    return (np.power(power, max_log / buckets * i) - 1.0).astype(np.float32)


def luminance(rgb):
    rgb = rgb.float()
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def percentile_of_luma(hdr, pct, max_value=64.0, power=2.0, buckets=64):
    """The pct-th percentile of the image's luma by bucket interpolation
    over 64 log-spaced buckets up to `max_value`."""
    bounds = torch.as_tensor(bucket_bounds(max_value, power, buckets),
                             device=hdr.device)
    lum = luminance(hdr[..., :3]).reshape(-1)
    max_log = float(np.log(1.0 + max_value) / np.log(power))
    scale = buckets / (max_log * float(np.log(power)))
    u = torch.log1p(torch.clamp(lum, min=0.0)) * scale
    idx = torch.clamp(torch.floor(u).to(torch.int64), 0, buckets - 1)
    counts = torch.zeros(buckets, dtype=torch.int64,
                         device=hdr.device).index_add_(
        0, idx, torch.ones_like(idx)).to(torch.int32).to(torch.float32)
    total = torch.clamp(torch.sum(counts), min=1.0)
    cum = torch.cumsum(counts, dim=0)
    target = total * (pct / 100.0)
    i = torch.argmax((cum >= target).to(torch.int32))
    prev = torch.clamp(i - 1, min=0)
    prev_cum = torch.where(i > 0, cum[prev], 0.0)
    in_bucket = torch.clamp(counts[i], min=1.0)
    frac = torch.clamp((target - prev_cum) / in_bucket, 0.0, 1.0)
    lo = torch.where(i > 0, bounds[prev], 0.0)
    return lo + (bounds[i] - lo) * frac


def uncharted2(v):
    ka, kb, kc, kd, ke, kf = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((v * (ka * v + kc * kb) + kd * ke)
            / (v * (ka * v + kb) + kd * kf)) - ke / kf


def tonemap_u8(hdr, avg_lum, white_in=4.0):
    """Uncharted2 at exposure 1.1 / max(avg_lum, 0.05), white point
    `white_in`, gamma 1/2.2, rounded half up to uint8."""
    white = uncharted2(torch.tensor(white_in, dtype=torch.float32,
                                    device=hdr.device))
    exposure = 1.1 / torch.clamp(avg_lum, min=0.05)
    mapped = uncharted2(hdr.to(torch.float32) * exposure)
    rgb = torch.clamp(mapped / white, 0.0, 1.0) ** (1.0 / 2.2)
    return (rgb * 255.0 + 0.5).to(torch.uint8)
