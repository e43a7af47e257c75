"""The port's one span API (`core/trace.py:span`) on the CPU: the spans a
flagship frame, a particle system's update -> render -> resolve ->
to_uint8 and a `LightingRenderer` frame open, each inside the span that
encloses it, under the profiler and under the recorder alike; a span that
enters no profiler range and records nothing while neither is on; the
recorder's records, self times, counters and clock; the benchmark's
readers of a recording; and no other way into `record_function` in the
package."""

import types
import warnings
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import illuminant_tpu_torch
from framebench.lib import loader
from framebench.metrics import _recorded
from illuminant_tpu_torch.core import cuda_build, trace
from illuminant_tpu_torch.core.trace import launch, span

FRAME_SPANS = {
    "illuminant/frame/inputs": None,
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
    "illuminant/frame/composite": None,
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


def flagship_frame():
    """A small flagship frame on the CPU, as a callable."""
    from illuminant_tpu_torch.scenes import build_flagship

    sc = build_flagship(height=32, width=48, capacity=64, spawn_max=16,
                        n_lights=2, device="cpu")

    def frame():
        sc.frame(sc.system.state, torch.tensor(0.5),
                 torch.Generator().manual_seed(3), sc.volume, sc.gbuffer,
                 sc.sphere_lights, sc.environment.uniforms(device="cpu"), 16)

    return frame


def system_frame():
    """A small particle system's update -> render -> resolve -> to_uint8
    on the CPU, as a callable."""
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

    frame.system = system
    return frame


def renderer_frame():
    """A small `LightingRenderer` frame on the CPU, as a callable."""
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

    return frame


def test_flagship_frame_spans():
    assert opened(flagship_frame()) == FRAME_SPANS


def test_particle_system_spans():
    frame = system_frame()
    assert opened(frame) == SYSTEM_SPANS
    assert frame.system.live_count > 0


def test_renderer_spans():
    assert opened(renderer_frame()) == RENDERER_SPANS


def recorded_tree(fn) -> dict:
    """fn() under the recorder -> {span: its parent span, or None}, every
    span it recorded; a span found under two different parents fails."""
    with trace.recording() as rec:
        fn()
    spans = {}
    for r in rec.records:
        parent = rec.records[r.parent].name if r.parent >= 0 else None
        assert spans.setdefault(r.name, parent) == parent, (r.name, parent)
    return spans


@pytest.mark.parametrize("build, spans", [
    (flagship_frame, FRAME_SPANS), (system_frame, SYSTEM_SPANS),
    (renderer_frame, RENDERER_SPANS)], ids=["flagship", "system",
                                            "renderer"])
def test_recorder_tree_is_the_profilers(build, spans):
    """The recorder, with no profiler on, finds the parent of every span
    that the profiler finds (each on a first frame)."""
    assert recorded_tree(build()) == spans


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
    profiler records, and record only while a recording runs: with
    neither on they enter nothing and record nothing."""
    monkeypatch.setattr(trace, "record_function", _Counting)
    monkeypatch.setattr(trace, "_RecordFunctionFast", _Counting)
    monkeypatch.setattr(_Counting, "entered", 0)
    entered = []
    monkeypatch.setattr(trace.Recorder, "enter",
                        lambda self, name: entered.append(name) or 0)
    monkeypatch.setattr(trace.Recorder, "exit", lambda self, i: None)

    @span("illuminant/test/decorated")
    def work(x):
        return x + 1

    def every_kind():
        with span("illuminant/test/block"), launch("k0_test"):
            assert work(1) == 2

    every_kind()
    assert _Counting.entered == 0 and entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        every_kind()
    assert _Counting.entered == 3 and entered == []
    with trace.recording():
        every_kind()
    assert _Counting.entered == 3
    assert entered == ["illuminant/test/block", "illuminant/kernel/k0_test",
                       "illuminant/test/decorated"]
    every_kind()
    assert _Counting.entered == 3 and len(entered) == 3
    assert trace._RECORDER is None


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


def _record(name, parent, start, end, launches=0, syncs=0):
    r = trace.Record(name, parent, start)
    r.end_ns, r.launches, r.syncs = end, launches, syncs
    return r


def test_self_time_is_duration_less_the_union_of_children():
    """Children that overlap count once, a child's part past its parent's
    end counts not at all, and a grandchild counts only in its parent."""
    rec = trace.Recorder()
    rec.records = [_record("a", -1, 0, 100),
                   _record("b", 0, 10, 30), _record("c", 0, 20, 50),
                   _record("g", 2, 25, 45), _record("d", 0, 90, 120),
                   _record("e", -1, 200, 260)]
    assert rec.self_ns() == [100 - (40 + 10), 20, 30 - 20, 20, 30, 60]
    names = rec.by_name()
    assert names["a"] == dict(calls=1, ns=100, self_ns=50, launches=0,
                              syncs=0)
    assert names["c"]["self_ns"] == 10 and names["c"]["ns"] == 30


def test_by_name_counts_a_nested_span_of_the_same_name_once():
    rec = trace.Recorder()
    rec.records = [_record("s", -1, 0, 100, launches=1),
                   _record("s", 0, 10, 60, launches=2, syncs=1),
                   _record("s", -1, 200, 230)]
    assert rec.by_name()["s"] == dict(calls=3, ns=130, self_ns=130,
                                      launches=3, syncs=1)


def test_a_span_that_raises_still_closes_its_record():
    with trace.recording() as rec:
        try:
            with span("illuminant/test/outer"):
                with span("illuminant/test/inner"):
                    raise KeyError("inside")
        except KeyError:
            pass
        with span("illuminant/test/after"):
            pass
    names = [(r.name, r.parent) for r in rec.records]
    assert names == [("illuminant/test/outer", -1),
                     ("illuminant/test/inner", 0),
                     ("illuminant/test/after", -1)]
    assert all(r.end_ns >= r.start_ns for r in rec.records)
    assert rec.records[0].end_ns >= rec.records[1].end_ns
    assert rec.records[2].start_ns >= rec.records[0].end_ns


def test_one_span_object_serves_two_withs():
    s = span("illuminant/test/reused")
    with trace.recording() as rec:
        with s:
            pass
        with s:
            with span("illuminant/test/inner"):
                pass
    assert [(r.name, r.parent) for r in rec.records] == [
        ("illuminant/test/reused", -1), ("illuminant/test/reused", -1),
        ("illuminant/test/inner", 1)]
    assert rec.records[1].start_ns >= rec.records[0].end_ns


def test_the_decorator_records():
    @span("illuminant/test/decorated")
    def work(x):
        with span("illuminant/test/inside"):
            return x * 2

    with trace.recording() as rec:
        assert work(2) == 4
        assert work(3) == 6
    assert [(r.name, r.parent) for r in rec.records] == [
        ("illuminant/test/decorated", -1), ("illuminant/test/inside", 0),
        ("illuminant/test/decorated", -1), ("illuminant/test/inside", 2)]


def test_one_recording_at_a_time_and_spans_open_at_the_stop_end_there():
    s = span("illuminant/test/left_open")
    with trace.recording() as rec:
        with pytest.raises(RuntimeError):
            trace.Recorder().start()
        s.__enter__()
    assert trace._RECORDER is None
    (r,) = rec.records
    ended = r.end_ns
    assert ended > r.start_ns
    s.__exit__(None, None, None)
    assert r.end_ns == ended
    assert trace._RECORDER is None


def test_counters_go_to_the_innermost_open_span():
    filters = list(warnings.filters)
    with trace.recording() as rec:
        trace.count("launches", 2)
        with span("illuminant/test/outer"):
            warnings.warn(trace.SYNC_WARNING)
            with launch("k0_test"):
                trace.count("launches", 3)
                warnings.warn(trace.SYNC_WARNING + " (a read)")
                warnings.warn(trace.SYNC_WARNING + " (a read)")
        with pytest.warns(UserWarning, match="another warning"):
            warnings.warn("another warning")
        warnings.warn(trace.SYNC_WARNING)
    assert [(r.name, r.launches, r.syncs) for r in rec.records] == [
        ("illuminant/test/outer", 0, 1), ("illuminant/kernel/k0_test", 3, 2)]
    assert rec.totals == dict(launches=5, syncs=4)
    assert rec.outside == dict(launches=2, syncs=1)
    assert warnings.filters == filters
    trace.count("launches", 7)  # no recording: counts nowhere
    assert rec.totals["launches"] == 5


def test_a_library_launch_counts_once_in_both(monkeypatch):
    """`Library.launch` adds the kernels its entry point reports to
    `cuda_build.launches()` and to its launch span's record."""
    import contextlib
    import ctypes

    def entry(*args):
        ctypes.cast(args[-2], ctypes.POINTER(ctypes.c_int))[0] = 4
        return 0

    monkeypatch.setitem(cuda_build._LAUNCHES, "k0_fake", 0)
    monkeypatch.setattr(cuda_build.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(cuda_build.torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    lib = cuda_build.Library("fake.cu", {}, ["k0_fake"])
    lib._lib = types.SimpleNamespace(fake_entry=entry)
    before = cuda_build.launches()["k0_fake"]
    with trace.recording() as rec:
        with span("illuminant/test/stage"):
            lib.launch("k0_fake", "fake_entry", "cpu", 1, reports=True)
    assert cuda_build.launches()["k0_fake"] - before == 4
    assert [(r.name, r.launches) for r in rec.records] == [
        ("illuminant/test/stage", 0), ("illuminant/kernel/k0_fake", 4)]
    assert rec.totals["launches"] == 4


def test_recorded_spans_hold_their_profiler_ranges():
    """With the recorder and a CPU profiler both on, every recorded span,
    put on the profiler's timeline by the recorder's anchor, lies on its
    own range within 200 us at each end."""
    frame = system_frame()
    frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame()  # the ranges' first entries
        with trace.recording() as rec:
            frame()
            frame()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in prof.events():
        if e.name.startswith("illuminant/"):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    by_name = {}
    for r in rec.records:
        by_name.setdefault(r.name, []).append(r)
    assert set(by_name) == set(SYSTEM_SPANS)
    for name, records in by_name.items():
        # The last two frames' ranges of the name, in order.
        mine = sorted(ranges[name])[-len(records):]
        for r, (a, b) in zip(records, mine):
            assert abs(rec.profiler_us(start_ns, r.start_ns) - a) <= 200.0
            assert abs(rec.profiler_us(start_ns, r.end_ns) - b) <= 200.0


def _hand_recording():
    """Two frames of 10 ms: in each a sphere_lights span of 4 ms holding a
    nested one of the same name, two kernel launches of 30 and 50 us,
    a field slab, the transforms and a sync; one sync outside."""
    rec = trace.Recorder()
    ms, us = 1_000_000, 1_000
    for k in range(2):
        t = 20 * ms * k
        f = len(rec.records)
        rec.records += [
            _record(_recorded.FRAME, -1, t, t + 10 * ms, syncs=1),
            _record("illuminant/sphere_lights", f, t + ms, t + 5 * ms),
            _record("illuminant/sphere_lights", f + 1, t + 2 * ms,
                    t + 3 * ms),
            _record("illuminant/kernel/k1_scan_walk", f + 2, t + 2 * ms,
                    t + 2 * ms + 30 * us, launches=1),
            _record("illuminant/kernel/k2_scan_readout", f, t + 6 * ms,
                    t + 6 * ms + 50 * us, launches=1),
            _record("illuminant/renderer/field_slab", f, t + 7 * ms,
                    t + 7 * ms + 500 * us),
            _record("illuminant/particles/transforms", f, t + 8 * ms,
                    t + 8 * ms + 250 * us, syncs=1)]
    rec.totals = dict(launches=4, syncs=5)
    rec.outside = dict(launches=0, syncs=1)
    return rec


@pytest.mark.parametrize("metric, value", [
    ("frame_host_ms", 10.0), ("host_syncs_per_frame", 2.0),
    ("launch_host_us", 40.0), ("sphere_lights_host_ms", 4.0),
    ("field_slab_host_ms", 0.5), ("transforms_host_ms", 0.25)])
def test_recorded_metric_readers(metric, value):
    trace_ = types.SimpleNamespace(
        recorded=_recorded.Recorded(_hand_recording()))
    got = loader.module("metrics", metric).read(trace_)
    assert got == pytest.approx(value, rel=1e-12)


def test_recorded_stretch_runs_paced_frames_once():
    """The stretch runs lead and recorded frames of the cell, each in
    `framebench/frame`, keeps the recording on the trace and prints its
    table; a program without the recorder, or a trace without a cell,
    reads None."""
    frame = system_frame()
    cell = types.SimpleNamespace(device=torch.device("cpu"), step=frame)
    got = _recorded.record(cell, seconds=0.0, min_frames=3, lead=1)
    assert got.frames == 3
    assert got.names["illuminant/particles/tick"]["calls"] == 3
    assert got.names[_recorded.FRAME]["self_ns"] > 0
    assert got.host_ms(_recorded.FRAME) >= got.host_ms(
        "illuminant/particles/tick")
    assert got.syncs_per_frame() == 0.0 and got.launch_host_us() is None
    assert "illuminant/particles/tick" in got.table()
    assert _recorded.recorded(types.SimpleNamespace(cell=None)) is None
    kept = types.SimpleNamespace(recorded=got)
    assert _recorded.recorded(kept) is got


def test_recorded_stretch_reads_none_without_a_recorder(monkeypatch):
    monkeypatch.delattr(trace, "recording")
    cell = types.SimpleNamespace(device=torch.device("cpu"),
                                 step=lambda: None)
    assert _recorded.record(cell, seconds=0.0, min_frames=2) is None
    assert loader.module("metrics", "frame_host_ms").read(
        types.SimpleNamespace(cell=cell)) is None
