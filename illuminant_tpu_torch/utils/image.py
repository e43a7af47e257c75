"""Image IO helpers (the port's copy of illuminant_tpu/utils/image.py):
numpy and PIL only, PIL imported inside the call."""

from __future__ import annotations

import numpy as np


def write_png(path: str, image) -> None:
    """Write an (H, W), (H, W, 3) or (H, W, 4) uint8 or float-in-[0, 1]
    image (a numpy array or a tensor on any device) as PNG."""
    from PIL import Image

    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        mode = "L"
    elif arr.shape[-1] == 3:
        mode = "RGB"
    else:
        mode = "RGBA"
    Image.fromarray(arr, mode=mode).save(path)


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))
