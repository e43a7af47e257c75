"""The flagship frame on the analytic field under the sphere lights' exact
cone march (`build_flagship(field="analytic", preset="fast",
shadow_mode="march")`), driven frame by frame through the scene's own
`frame` entry, with the traffic of `flagship-analytic-1080p.py`: the
ring's every slot filled from the seed, `spawn_max` spawns a frame whose
draws cycle through a pool of `draw_pool` frames' draws, the frame index
advancing one a frame from 0.

Besides, the cell remembers the index of the last frame run while a
profiler recorded, so that a reader can count the work of the march that
frame made (`traced_march`).
"""

from __future__ import annotations

import torch
from torch.autograd import _profiler_enabled

from framebench.lib.loader import module

NAME = "flagship-analytic-march-1080p"
_scan = module("scenes", "flagship-analytic-1080p")
# This module's own copy of the scan scene builds the cell, its population
# and draws made by this configuration's reference (the scan reference's
# refuses the march).
_scan.NAME = NAME


class Cell(_scan.Cell):
    def __init__(self, config, params, seed, device):
        super().__init__(config, params, seed, device)
        self.config = config
        self.traced_frame = None

    def step(self):
        if _profiler_enabled():
            self.traced_frame = self.k
        return super().step()

    def traced_march(self):
        """The march of the last frame run under a profiler, as the plain
        reference makes it from the frame's index: (the scene, the
        keyword arguments of `march.march` but the scene), or None where
        no frame was traced."""
        if self.traced_frame is None:
            return None
        ref = module("reference", NAME).Reference(self.config, self.device)
        return ref.march_rays(self.traced_frame)


def build(config, params, seed, device):
    return Cell(config, params, seed, device)
