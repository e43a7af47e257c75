"""The port's one span API (`core/trace.py:span`) on the CPU: the spans a
flagship frame, a particle system's update -> render -> resolve ->
to_uint8 and a `LightingRenderer` frame open, each inside the span that
encloses it; a span that enters no profiler range while no profiler
records; and no other way into `record_function` in the package."""

from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import illuminant_tpu_torch
from illuminant_tpu_torch.core import trace
from illuminant_tpu_torch.core.trace import launch, span

FRAME_SPANS = {
    "illuminant/frame/animate_field": None,
    "illuminant/frame/animate_lights": None,
    "illuminant/frame/lighting": None,
    "illuminant/lighting/fused_scan": "illuminant/frame/lighting",
    "illuminant/scan_shadows": "illuminant/sphere_lights",
    "illuminant/scan_shadows/readout": "illuminant/scan_shadows",
    "illuminant/sphere_lights": "illuminant/frame/lighting",
    "illuminant/frame/particles": None,
    "illuminant/particle_spawn": "illuminant/frame/particles",
    "illuminant/particles/transforms": "illuminant/frame/particles",
    "illuminant/particle_integrate": "illuminant/frame/particles",
    "illuminant/frame/raster": None,
    "illuminant/frame/exposure": None,
    "illuminant/frame/tonemap": None,
}

SYSTEM_SPANS = {
    "illuminant/particles/update": None,
    "illuminant/particles/tick": "illuminant/particles/update",
    "illuminant/particle_spawn": "illuminant/particles/tick",
    "illuminant/particles/transforms": "illuminant/particles/tick",
    "illuminant/particle_integrate": "illuminant/particles/tick",
    "illuminant/particles/render": None,
    "illuminant/raster/resolve": None,
    "illuminant/raster/to_uint8": None,
}

RENDERER_SPANS = {
    "illuminant/renderer/update_fields": None,
    "illuminant/renderer/gbuffer": "illuminant/renderer/update_fields",
    "illuminant/renderer/field_regen": "illuminant/renderer/update_fields",
    "illuminant/renderer/field_slab": "illuminant/renderer/field_regen",
    "illuminant/renderer/render_lighting": None,
    "illuminant/renderer/light_pass/additive":
        "illuminant/renderer/render_lighting",
    "illuminant/sphere_lights": "illuminant/renderer/light_pass/additive",
    "illuminant/renderer/resolve": None,
    "illuminant/raster/resolve": "illuminant/renderer/resolve",
}


def opened(fn) -> dict:
    """fn() under a CPU profiler -> {span: the nearest enclosing span, or
    None}, every span of the port that it opened; a span found under two
    different parents fails."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = {}
    for e in prof.events():
        if not e.name.startswith("illuminant/"):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(
                "illuminant/"):
            parent = parent.cpu_parent
        name = parent.name if parent is not None else None
        assert spans.setdefault(e.name, name) == name, (e.name, name)
    return spans


def test_flagship_frame_spans():
    from illuminant_tpu_torch.scenes import build_flagship

    sc = build_flagship(height=32, width=48, capacity=64, spawn_max=16,
                        n_lights=2, device="cpu")

    def frame():
        sc.frame(sc.system.state, torch.tensor(0.5),
                 torch.Generator().manual_seed(3), sc.volume, sc.gbuffer,
                 sc.sphere_lights, sc.environment.uniforms(device="cpu"), 16)

    assert opened(frame) == FRAME_SPANS


def test_particle_system_spans():
    from illuminant_tpu_torch.core.config import HDRConfig
    from illuminant_tpu_torch.particles import formula as f
    from illuminant_tpu_torch.particles import transforms as tx
    from illuminant_tpu_torch.particles.spawner import Spawner
    from illuminant_tpu_torch.particles.system import (ParticleSystem,
                                                       ParticleSystemConfig)
    from illuminant_tpu_torch.raster.resolve import resolve, to_uint8
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    spawner = Spawner(min_rate=600.0, max_rate=600.0, spawn_max=16,
                      position=f.Formula3(constant=(24.0, 16.0, 0.0),
                                          random_scale=(8.0, 8.0, 0.0)))
    gravity = tx.Gravity(attractors=[tx.Attractor(position=(24.0, 16.0, 0.0),
                                                  radius=30.0)])
    system = ParticleSystem(ParticleSystemConfig(capacity=64),
                            [spawner, gravity], seed=1, device="cpu")

    def frame():
        assert system.update(1.0 / 60.0) == 1
        img, _ = system.render(TiledRasterConfig(height=32, width=48))
        to_uint8(resolve(img, HDRConfig()))

    assert opened(frame) == SYSTEM_SPANS
    assert system.live_count > 0


def test_renderer_spans():
    from illuminant_tpu_torch.core.config import RendererConfig
    from illuminant_tpu_torch.lighting.environment import (
        LightingEnvironment, LightObstruction, SphereLightSource)
    from illuminant_tpu_torch.lighting.renderer import LightingRenderer
    from illuminant_tpu_torch.sdf.volume import SdfVolumeConfig

    env = LightingEnvironment(maximum_z=64.0)
    env.obstructions.append(
        LightObstruction.box((32.0, 24.0, 8.0), (6.0, 6.0, 8.0)))
    env.lights.append(SphereLightSource(position=(12.0, 12.0, 10.0),
                                        radius=4.0, ramp_length=40.0))
    r = LightingRenderer(
        RendererConfig(width=64, height=48), env,
        sdf_config=SdfVolumeConfig(virtual_width=64, virtual_height=48,
                                   virtual_depth=32, slice_count=4,
                                   resolution_scale=0.5), device="cpu")

    def frame():
        r.update_fields(budget=10 ** 6)
        r.resolve(r.render_lighting())

    assert opened(frame) == RENDERER_SPANS


class _Counting:
    """A stand-in for record_function that counts the ranges entered."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _Counting.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_span_enters_no_range_without_a_profiler(monkeypatch):
    """Stage spans and launch spans enter their ranges only while a
    profiler records."""
    monkeypatch.setattr(trace, "record_function", _Counting)
    monkeypatch.setattr(trace, "_RecordFunctionFast", _Counting)
    monkeypatch.setattr(_Counting, "entered", 0)

    @span("illuminant/test/decorated")
    def work(x):
        return x + 1

    def every_kind():
        with span("illuminant/test/block"), launch("k0_test"):
            assert work(1) == 2

    every_kind()
    assert _Counting.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        every_kind()
    assert _Counting.entered == 3
    every_kind()
    assert _Counting.entered == 3


def test_launch_opens_an_operator_range():
    """A launch span is `illuminant/kernel/<k>`, an operator's range (the
    kind the profiler attributes launches to), inside the stage span
    around it; a stage span is a user annotation."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("illuminant/test/stage"):
            with launch("k0_test"):
                torch.ones(2)
    ev = {e.name: e for e in prof.events()}
    k = ev["illuminant/kernel/k0_test"]
    assert k.cpu_parent.name == "illuminant/test/stage"
    assert not k.is_user_annotation
    assert ev["illuminant/test/stage"].is_user_annotation
    assert ev["aten::ones"].cpu_parent is k


def test_span_nests_and_reraises():
    s = span("illuminant/test/outer")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        try:
            with s:
                with span("illuminant/test/inner"):
                    raise KeyError("inside")
        except KeyError:
            pass
        with s:  # the same object serves a second `with`
            pass
    names = [e.name for e in prof.events()
             if e.name.startswith("illuminant/test/")]
    assert sorted(names) == ["illuminant/test/inner", "illuminant/test/outer",
                             "illuminant/test/outer"]


def test_decorator_keeps_name_and_docstring():
    def stage(a, b=2):
        """One stage."""
        return a * b

    wrapped = span("illuminant/test/stage")(stage)
    assert wrapped.__name__ == "stage"
    assert wrapped.__doc__ == "One stage."
    assert wrapped.__wrapped__ is stage
    assert wrapped(3) == 6 and wrapped(3, b=4) == 12


def test_record_function_only_in_the_span_module():
    root = Path(illuminant_tpu_torch.__file__).parent
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "record_function" in p.read_text())
    assert users == ["core/trace.py"]
