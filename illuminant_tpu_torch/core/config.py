"""Configuration dataclasses.

Counterpart of illuminant_tpu/core/config.py: the same fields and defaults
as plain frozen dataclasses (hashable, compared by value). The field
comments there explain each knob; only the port's deviations are noted
here.
"""

from __future__ import annotations

import dataclasses

SCAN_REFINE_MODES = ("exact", "carried", "carried_all")


@dataclasses.dataclass(frozen=True)
class QualitySettings:
    """Cone-trace quality knobs (LightingRenderer.Configuration.cs:254-291).

    Deviation: an unknown `scan_refine_mode` raises here. The JAX package
    accepts any string and silently runs the exact refine for it."""

    min_step_size: float = 3.0
    long_step_factor: float = 1.0
    max_step_count: int = 64
    max_cone_radius: float = 24.0
    cone_growth_factor: float = 1.0
    occlusion_to_opacity_power: float = 1.0
    shadow_scale: float = 0.5
    scan_refine_samples: int = 1
    scan_nomination_scale: float = 0.5
    scan_refine_mode: str = "carried"
    extra_family_scale: float = 0.5

    def __post_init__(self):
        if self.scan_refine_mode not in SCAN_REFINE_MODES:
            raise ValueError(
                f"unknown scan_refine_mode {self.scan_refine_mode!r} "
                f"(valid: {SCAN_REFINE_MODES})")


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Lighting renderer configuration
    (LightingRenderer.Configuration.cs:13-253, subset)."""

    width: int = 1920
    height: int = 1080
    render_scale: float = 1.0
    two_point_five_d: bool = False
    render_ground_plane: bool = True
    enable_gbuffer: bool = True
    maximum_field_updates_per_frame: int = 1
    enable_brightness_estimation: bool = False
    quality: QualitySettings = dataclasses.field(
        default_factory=QualitySettings)

    @property
    def lightmap_shape(self):
        h = int(round(self.height * self.render_scale))
        w = int(round(self.width * self.render_scale))
        return (h, w)


@dataclasses.dataclass(frozen=True)
class HDRConfig:
    """HDR resolve configuration (LightingRenderer.HDR.cs:198-258).

    mode: 0 = none, 1 = gamma-compress, 2 = Uncharted2 tonemap.
    """

    mode: int = 0
    exposure: float = 1.0
    gamma: float = 1.0
    white_point: float = 1.0
    middle_gray: float = 0.6
    maximum_luminance_sq: float = 1.0
    offset: float = 0.0
    dithering: bool = False
    srgb_output: bool = False


HDR_MODE_NONE = 0
HDR_MODE_GAMMA_COMPRESS = 1
HDR_MODE_TONEMAP = 2
