"""ParticleSystem.Render: the user-facing particle draw (counterpart of
illuminant_tpu/raster/render.py).

ParticleAppearance (ParticleConfiguration.cs:42-109) picks how a system's
particles are drawn. The port draws untextured particles additively,
through the direct splat of raster/tiled.py: the quad, the rounded disc
(`rounded`) or the Gaussian glow (`glow`), or an explicit `kernel`. The
sprite-table route (a texture), the rounding-power disc tables
(`rounding_power_from_life`) and the ordered alpha compositor
(`additive_blend=False`) are ROADMAP M11 and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.coords import stipple_keep
from ..particles.state import ParticleState
from .tiled import (KERNEL_GAUSS, KERNEL_QUAD, KERNEL_ROUND,
                    TiledRasterConfig, rasterize_tiled)


@dataclasses.dataclass
class ParticleAppearance:
    """ParticleAppearance (ParticleConfiguration.cs:42-109): the JAX
    package's fields. Untextured particles draw as quads; `rounded` picks
    the disc, `glow` the Gaussian, an explicit `kernel` (tiled.KERNEL_*)
    wins over both."""

    texture: Optional[np.ndarray] = None  # (TH, TW[, C])
    columns: int = 1  # sprite sheet layout
    rows: int = 1
    animation_rate: Tuple[float, float] = (0.0, 0.0)
    rounded: bool = False
    glow: bool = False
    dithered_opacity: bool = False
    relative_size: bool = False
    row_from_velocity: bool = False
    column_from_velocity: bool = False
    size_min: float = 2.0
    size_max: float = 12.0
    angle_bins: int = 8
    size_bins: int = 4
    rank: int = 4
    kernel: Optional[str] = None
    rounding_power_from_life: object = None
    power_bins: int = 8


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"render_particles: {what} is not ported yet (ROADMAP M11); "
        "untextured additive particles are")


def _on(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


def render_particles(state: ParticleState, config: TiledRasterConfig,
                     appearance: Optional[ParticleAppearance] = None,
                     additive_blend: bool = True, global_color=None,
                     stipple_factor: float = 1.0, z_to_y: float = 0.0,
                     size_scale: float = 1.0, background=None,
                     z_formula=None, size_from_z: float = 0.0):
    """Render a particle system's live slots -> ((H, W, C) image, diag).

    Screen y = y - z * z_to_y; colors times `global_color`; sizes times
    `size_scale` and max(0, 1 + z * size_from_z) (fx:86); a
    `stipple_factor` below 1 keeps that golden-ratio fraction of the slots
    (fx:101-110, phase `config.stipple_offset`); `background` is added
    under the additive splat. `z_formula` orders alpha compositing, so it
    does nothing to an additive image."""
    app = appearance or ParticleAppearance()
    if app.texture is not None:
        raise _unported("a textured appearance (the sprite-table route)")
    if app.rounded and app.rounding_power_from_life is not None:
        raise _unported("rounding_power_from_life (the power-disc tables)")
    if not additive_blend:
        raise _unported("additive_blend=False (the ordered alpha route)")
    del z_formula  # additive blending is order-invariant
    dev = state.position.device
    x = state.position[:, 0]
    y = state.position[:, 1] - state.position[:, 2] * z_to_y
    color = state.render_color
    if global_color is not None:
        color = color * _on(global_color, dev)
    size = state.render_data[:, 0] * size_scale
    if not (isinstance(size_from_z, (int, float)) and size_from_z == 0.0):
        size = size * torch.clamp(1.0 + state.position[:, 2] * size_from_z,
                                  min=0.0)
    live = state.live_mask()
    if not (isinstance(stipple_factor, (int, float))
            and stipple_factor >= 1.0):
        live = live & stipple_keep(state.capacity, stipple_factor,
                                   config.stipple_offset, device=dev)
    kernel = app.kernel or (KERNEL_GAUSS if app.glow
                            else KERNEL_ROUND if app.rounded else KERNEL_QUAD)
    if config.kernel != kernel:
        config = dataclasses.replace(config, kernel=kernel)
    img, diag = rasterize_tiled(config, x, y, color, size, live)
    if background is not None:
        img = img + _on(background, dev)[..., :img.shape[-1]]
    return img, diag
