"""Plain reference of the flagship frame on the analytic field under the
sphere lights' exact cone march (the "fast" preset, `shadow_mode=
"march"`): the frame of `flagship-analytic-1080p.py`, computed by this
module's own copy of that file, in which the sphere lights' sum is the
march's (`march.sphere_lights`, whose module docstring lists where it
departs from the shaders) in place of the scan's. The particle tick, the
splat, the exposure, the tonemap and the `lowp` control (every stage's
float result rounded to bfloat16) are that file's.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from framebench.lib.loader import module
from framebench.reference import lighting, march

_scan = module("reference", "flagship-analytic-1080p")
QUALITY = dict(_scan.QUALITY, **march.STEPS)
# The copy's frame calls `lighting.sphere_lights(..., QUALITY)`: here the
# march, with its step settings.
_scan.lighting = SimpleNamespace(flat_ground=lighting.flat_ground,
                                 sphere_lights=march.sphere_lights)
_scan.QUALITY = QUALITY


class Reference(_scan.Reference):
    def __init__(self, config: dict, device):
        if (config["field"], config["preset"], config["shadow_mode"]) != (
                "analytic", "fast", "march"):
            raise ValueError("this reference computes the analytic field's "
                             "fast frame under the cone march only")
        super().__init__(dict(config, shadow_mode="scan"), device)

    def march_rays(self, frame_index: int):
        """What the march traces in frame `frame_index`: (the scene, the
        keyword arguments of `march.march` but the scene)."""
        i = torch.tensor(float(frame_index), dtype=torch.float32,
                         device=self.device)
        t = i * _scan.DT
        lights = self.lights_at(i, t)
        enable = march.terms(self.gbuf, lights,
                             self.light_occlusion)["trace_enable"]
        return self.field(t), dict(march.rays(self.gbuf, lights, enable),
                                   quality=QUALITY)
