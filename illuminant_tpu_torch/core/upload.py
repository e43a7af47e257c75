"""Host-to-device uploads that do not stall the host.

A plain `torch.tensor(value, device="cuda")` copies from pageable memory
and waits for the device's stream to drain first, so a per-tick upload of
a transform's uniforms would fence every tick. `upload` copies through
pinned memory without blocking; `cached_upload` keeps each named value's
last upload on its owner and uploads again only when the host value
changed, so static uniforms cross to the device once.
"""

from __future__ import annotations

import numpy as np
import torch

_NUMPY = {torch.float32: np.float32, torch.int32: np.int32}


def upload(value, device=None, dtype=torch.float32) -> torch.Tensor:
    """Host value (number, sequence or numpy array) -> a new tensor of
    `dtype` on `device`; never shares memory with `value`."""
    host = torch.tensor(np.asarray(value, _NUMPY[dtype]), dtype=dtype)
    if device is None or torch.device(device).type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def cached_upload(owner, name: str, value, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """`upload(value)`, reused while `owner`'s value under `name` is
    unchanged on `device` (compared on the host)."""
    host = np.array(value, _NUMPY[dtype])
    cache = owner.__dict__.setdefault("_uploads", {})
    key = (name, str(device))
    hit = cache.get(key)
    if hit is not None and hit[0].shape == host.shape and \
            np.array_equal(hit[0], host):
        return hit[1]
    tensor = upload(host, device, dtype)
    cache[key] = (host, tensor)
    return tensor
