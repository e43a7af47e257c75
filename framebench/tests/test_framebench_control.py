"""The comparison fails what it must: the control (the plain reference in
the precision below the configuration's, in the program's place) and the
timed path broken underneath in each way a cell can be, on the CPU at a
small size, the harness driven past its look for a card. (Both cells run
on one card, so neither has an exchange between cards to leave out.)"""

from __future__ import annotations

import time

import pytest
import torch

from framebench.lib import bench
from illuminant_tpu_torch import scenes
from illuminant_tpu_torch.particles import system as psys
from illuminant_tpu_torch.raster import resolve as rres

FLAGSHIP = "flagship-scan-1080p"
PARTICLES = "particles-collide-1080p"
Frame = scenes._FlagshipFrame


def _run(bench_json, base, cell, **kw):
    return bench.run(cell, 2 ** 31 + 99, 1.0, False, "cpu",
                     time.perf_counter(), bench=bench_json, base=base, **kw)


@pytest.mark.parametrize("cell", [FLAGSHIP, PARTICLES])
def test_control_fails_every_number(bench_json, small_base, cell):
    r = _run(bench_json, small_base, cell, control=True)
    assert r["correct"]
    failing = {name for name, value in r["control"].items()
               if value > r["checks"][name]["limit"]}
    assert failing == set(r["checks"]), r["control"]


def _half(state):
    """The first half of the slots, their colour doubled: the rest left
    out and the image's mean kept."""
    keep = torch.arange(state.capacity) < state.capacity // 2
    return state.replace(
        position=torch.where(keep[:, None], state.position, 0.0),
        render_color=state.render_color * 2.0)


# -- the flagship frame ------------------------------------------------------

def _tick_returns_its_state(monkeypatch):
    monkeypatch.setattr(Frame, "particles",
                        lambda self, state, *a, **kw: state)


def _splat_half_the_particles(monkeypatch):
    orig = Frame.raster
    monkeypatch.setattr(Frame, "raster",
                        lambda self, state: orig(self, _half(state)))


def _lightmap_pixel_altered(monkeypatch):
    orig = Frame.lighting

    def lighting(self, *a, **kw):
        out = orig(self, *a, **kw).clone()
        out[7, 11] += 0.25
        return out

    monkeypatch.setattr(Frame, "lighting", lighting)


def _frame_pixel_altered(monkeypatch):
    orig = Frame.tonemap

    def tonemap(self, *a, **kw):
        out = orig(self, *a, **kw).clone()
        out[5, 9, 1] ^= 128
        return out

    monkeypatch.setattr(Frame, "tonemap", tonemap)


# -- the particle frame ------------------------------------------------------

def _system_tick_does_nothing(monkeypatch):
    monkeypatch.setattr(psys.ParticleSystem, "tick",
                        lambda self, dt, spawn_uniforms=None: None)


def _render_half_the_particles(monkeypatch):
    orig = psys.ParticleSystem.render

    def render(self, raster_config, **kw):
        whole = self.state
        self.state = _half(whole)
        try:
            return orig(self, raster_config, **kw)
        finally:
            self.state = whole

    monkeypatch.setattr(psys.ParticleSystem, "render", render)


def _particle_moved(monkeypatch):
    orig = psys.ParticleSystem.tick

    def tick(self, dt, spawn_uniforms=None):
        orig(self, dt, spawn_uniforms)
        pos = self.state.position.clone()
        pos[3, 0] += 0.5
        self.state = self.state.replace(position=pos)

    monkeypatch.setattr(psys.ParticleSystem, "tick", tick)


def _resolved_pixel_altered(monkeypatch):
    orig = rres.to_uint8

    def to_uint8(image):
        out = orig(image).clone()
        out[5, 9, 1] ^= 128
        return out

    monkeypatch.setattr(rres, "to_uint8", to_uint8)


@pytest.mark.parametrize("cell, fault", [
    (FLAGSHIP, _tick_returns_its_state),
    (FLAGSHIP, _splat_half_the_particles),
    (FLAGSHIP, _lightmap_pixel_altered),
    (FLAGSHIP, _frame_pixel_altered),
    (PARTICLES, _system_tick_does_nothing),
    (PARTICLES, _render_half_the_particles),
    (PARTICLES, _particle_moved),
    (PARTICLES, _resolved_pixel_altered),
])
def test_a_broken_timed_path_is_not_correct(bench_json, small_base,
                                            monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(bench_json, small_base, cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0
