"""Luminance histogram (counterpart of illuminant_tpu/utils/histogram.py):
log-spaced buckets (Histogram.cs:62-75), min / max / mean, and percentile
by bucket interpolation. The JAX package counts with a bfloat16 one-hot
reduction accumulated in float32 (histogram.py:103), which is exact for
integer counts; the port counts with an integer index_add.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pytree import tensor_dataclass
from ..ops.tonemap import luminance


@tensor_dataclass
class HistogramResult:
    counts: torch.Tensor  # (B,) int32
    boundaries: torch.Tensor  # (B,) bucket max values
    min: torch.Tensor
    max: torch.Tensor
    mean: torch.Tensor
    sample_count: torch.Tensor  # () int32


def bucket_boundaries(max_value: float = 64.0, power: float = 2.0,
                      bucket_count: int = 64) -> np.ndarray:
    """value_i = power^(log_power(1 + max) / N * (i + 1)) - 1
    (Histogram.cs:62-75)."""
    max_log = np.log(1.0 + max_value) / np.log(power)
    i = np.arange(1, bucket_count + 1, dtype=np.float64)
    return (np.power(power, max_log / bucket_count * i) - 1.0).astype(
        np.float32)


def compute_histogram(lightmap, boundaries: np.ndarray,
                      ignore_zeroes: bool = False, power: float = 2.0,
                      max_value: float = 64.0) -> HistogramResult:
    """(H, W, >=3) HDR image -> HistogramResult. `boundaries` is a host
    array. When it is the log spacing of bucket_boundaries(max_value,
    power, B), the bucket index is the formula's exact inverse
    floor(log_power(1 + lum) * B / log_power(1 + max)); any other sorted
    boundaries are searched (Histogram.cs PickBucketForValue)."""
    lum = luminance(lightmap[..., :3]).reshape(-1)
    dev = lum.device
    boundaries = np.asarray(boundaries, np.float32)
    b = boundaries.shape[0]
    bounds_t = torch.as_tensor(boundaries, device=dev)
    valid = (lum > 0.0) if ignore_zeroes else torch.ones_like(
        lum, dtype=torch.bool)
    expected = bucket_boundaries(max_value, power, b)
    if np.allclose(boundaries, expected, rtol=1e-4, atol=1e-5):
        max_log = float(np.log(1.0 + max_value) / np.log(power))
        scale = b / (max_log * float(np.log(power)))
        u = torch.log1p(torch.clamp(lum, min=0.0)) * scale
        idx = torch.clamp(torch.floor(u).to(torch.int64), 0, b - 1)
    else:
        idx = torch.clamp(torch.searchsorted(bounds_t, lum, right=True),
                          0, b - 1)
    # Invalid samples count into a spare bucket b, dropped after.
    idx = torch.where(valid, idx, b)
    counts = torch.zeros(b + 1, dtype=torch.int64, device=dev).index_add_(
        0, idx, torch.ones_like(idx))[:b].to(torch.int32)
    n = torch.sum(valid.to(torch.int32))
    big = 3.4e38
    return HistogramResult(
        counts=counts, boundaries=bounds_t,
        min=torch.amin(torch.where(valid, lum, big)),
        max=torch.amax(torch.where(valid, lum, -big)),
        mean=torch.sum(torch.where(valid, lum, 0.0))
        / torch.clamp(n, min=1),
        sample_count=n)


def percentile(result: HistogramResult, pct: float):
    """Percentile by interpolation inside the first bucket whose
    cumulative count reaches the target."""
    counts = result.counts.to(torch.float32)
    total = torch.clamp(torch.sum(counts), min=1.0)
    cum = torch.cumsum(counts, dim=0)
    target = total * (pct / 100.0)
    idx = torch.argmax((cum >= target).to(torch.int32))
    prev = torch.clamp(idx - 1, min=0)
    prev_cum = torch.where(idx > 0, cum[prev], 0.0)
    in_bucket = torch.clamp(counts[idx], min=1.0)
    frac = torch.clamp((target - prev_cum) / in_bucket, 0.0, 1.0)
    lo = torch.where(idx > 0, result.boundaries[prev], 0.0)
    hi = result.boundaries[idx]
    return lo + (hi - lo) * frac
