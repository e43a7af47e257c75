"""The hand-written kernels' launch spans on the card: in a torch.profiler
trace, the device time of a kernel's `illuminant/kernel/<k>` span is
that kernel's own device operations, read by name, and the stage span
around it counts it in its own. Under the recorder, each kind of queue
drain counts once on the span it ran in, and the launches recorded over
a frame are those `cuda_build.launches()` counts.

This file imports neither jax nor the JAX package, so that it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_trace_cuda.py

Here, without a card, the `cuda` cases skip and the CPU case checks that
the kernels' names select what the card cases compare.

The cell: BASELINE config 4 at 1080p on the voxel flagship's ColumnField
(`chip_smoke.config4_system`) with every one of its 1,048,576 slots
live. A tick launches the collision integrate K4, which samples the
field itself; the column query K7 and its map pack are launched on the
cell's positions directly; a render launches the additive splat K5 (four
kernels after a memset of its tile counts).
"""

import re

import pytest
import torch

import chip_smoke as cs

# The kernels as the profiler names them (`framebench/metrics/k5_roofline`
# reads K5 by the same names).
K5 = r"\b(bin|scan|scatter|accumulate)_kernel(<\d+>)?\(.*Splat"
K7_QUERY = r"\bcolumn_query_kernel\b"
K7_PACK = r"\bpack_quad_kernel\b"
K4 = r"\bcollide_integrate_kernel\b"
TOLERANCE = 0.01
# The profiler's own event for a buffer of device records: it takes the id
# of the operator open when the buffer was asked for, and so holds that
# operator's kernels a second time, under it.
OVERHEAD = "Activity Buffer Request"


def held_us(event) -> float:
    """`event`'s device time, less what overhead events under it hold a
    second time."""
    twice, stack = 0.0, list(event.cpu_children)
    while stack:
        child = stack.pop()
        if child.name == OVERHEAD:
            twice += child.device_time_total
        else:
            stack.extend(child.cpu_children)
    return event.device_time_total - twice


def k5_own(ops):
    """K5's device operations among `ops` ((name, start, end), in start
    order): its four kernels by name, and the memset of its tile counts
    that the splat issues right before its bin kernel."""
    own = []
    for i, op in enumerate(ops):
        if re.search(K5, op[0]):
            own.append(op)
            if "bin_kernel" in op[0] and i and ops[i - 1][0].startswith(
                    "Memset"):
                own.append(ops[i - 1])
    return own


def test_kernel_names_select_the_splat_on_the_cpu():
    ops = [("Memset (Device)", 0, 1),
           ("(anonymous namespace)::bin_kernel((anonymous namespace)::Splat,"
            " (anonymous namespace)::Bins)", 1, 3),
           ("(anonymous namespace)::scan_kernel((anonymous namespace)::Splat,"
            " (anonymous namespace)::Bins)", 3, 4),
           ("void at::native::vectorized_elementwise_kernel<4>", 4, 5),
           ("(anonymous namespace)::scatter_kernel((anonymous namespace)::"
            "Splat, (anonymous namespace)::Bins)", 5, 6),
           ("void (anonymous namespace)::accumulate_kernel<4>((anonymous "
            "namespace)::Splat, (anonymous namespace)::Bins)", 6, 9),
           ("Memset (Device)", 9, 10),
           ("void (anonymous namespace)::column_query_kernel(float const*)",
            10, 11)]
    assert [op[1] for op in k5_own(ops)] == [1, 0, 3, 5, 6]
    assert [op[1] for op in ops if re.search(K7_QUERY, op[0])] == [10]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")


@pytest.fixture(scope="module")
def cell():
    """The config-4 system with every slot live, after one tick."""
    _needs_card()
    from illuminant_tpu_torch.particles.state import ParticleState

    dev = torch.device("cuda")
    _, field = cs._slice_field(dev)
    system, _ = cs.config4_system(cs.particle_api(dev), field,
                                  **cs.PARTICLE_FULL)
    n, h, w = system.config.capacity, cs.PARTICLE_FULL["height"], \
        cs.PARTICLE_FULL["width"]
    g = torch.Generator(device=dev).manual_seed(17)

    def u(*shape):
        return torch.rand(*shape, device=dev, generator=g)

    position = torch.stack([u(n) * w, u(n) * h, u(n) * 20.0,
                            0.5 + 2.0 * u(n)], dim=1)
    velocity = torch.cat([(u(n, 2) - 0.5) * 60.0,
                          torch.zeros(n, 2, device=dev)], dim=1)
    zeros = torch.zeros_like(position)
    system.state = ParticleState(
        position=position, velocity=velocity, color=u(n, 4),
        render_color=zeros, render_data=zeros.clone(),
        write_cursor=torch.zeros((), dtype=torch.int32, device=dev),
        total_spawned=torch.tensor(n, dtype=torch.int32, device=dev))
    system.update(cs.DT)  # builds the libraries, fills the render data
    torch.cuda.synchronize()
    assert int(system.state.live_count()) >= n - cs.PARTICLE_FULL[
        "spawn_max"]
    return system


def _profile(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, ops = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith("illuminant/"):  # annotations' twins
                ops.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name.startswith("illuminant/"):
            spans[e.name] = spans.get(e.name, 0.0) + held_us(e)
    return spans, sorted(ops, key=lambda op: op[1])


def _us(ops):
    return float(sum(b - a for _, a, b in ops))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gauss", "quad"])
def test_cuda_k5_span_holds_the_splat(cell, kernel):
    """A render of the 1M slots: `illuminant/kernel/k5_splat`'s device time
    is K5's operations by name within 1%, and `illuminant/particles/render`
    holds every device operation of the render, K5's among them."""
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig

    raster = TiledRasterConfig(height=cs.PARTICLE_FULL["height"],
                               width=cs.PARTICLE_FULL["width"], kernel=kernel)
    spans, ops = _profile(lambda: cell.render(raster))
    own = _us(k5_own(ops))
    assert len(k5_own(ops)) == 5 and own > 0.0
    assert abs(spans["illuminant/kernel/k5_splat"] - own) <= TOLERANCE * own
    every = _us(ops)
    render = spans["illuminant/particles/render"]
    assert abs(render - every) <= TOLERANCE * every
    assert render >= spans["illuminant/kernel/k5_splat"]


@pytest.mark.cuda
def test_cuda_k7_spans_hold_the_column_queries(cell):
    """The fused column query with its unit gradient at the cell's
    1,048,576 positions on its ColumnField (`columns.query`, which packs
    the maps and queries them; a tick samples the field inside K4): the
    spans `k7_column_query` and `k7_column_pack` hold K7's kernels by name
    within 1%."""
    from illuminant_tpu_torch.sdf import columns

    pos = cell.state.position
    spans, ops = _profile(lambda: columns.query(
        cell.volume, pos[:, 0], pos[:, 1], pos[:, 2], want_grad=True,
        normalize=True))
    for span_name, pattern in (("k7_column_query", K7_QUERY),
                               ("k7_column_pack", K7_PACK)):
        own = _us([op for op in ops if re.search(pattern, op[0])])
        assert own > 0.0, span_name
        got = spans[f"illuminant/kernel/{span_name}"]
        assert abs(got - own) <= TOLERANCE * own, (span_name, got, own)


@pytest.mark.cuda
def test_cuda_k4_span_holds_the_tick_collision(cell):
    """A tick on the ColumnField: no column query K7 and no map pack run
    (K4 samples the field on the pack kept from the first tick), the span
    `k4_integrate` holds K4's kernel by name within 1%, and
    `illuminant/particles/tick` (inside `illuminant/particles/update`)
    holds every device operation of the tick, K4's among them."""
    spans, ops = _profile(lambda: cell.update(cs.DT))
    for span_name, pattern in (("k7_column_query", K7_QUERY),
                               ("k7_column_pack", K7_PACK)):
        assert not [op for op in ops if re.search(pattern, op[0])]
        assert f"illuminant/kernel/{span_name}" not in spans
    own = _us([op for op in ops if re.search(K4, op[0])])
    assert own > 0.0
    got = spans["illuminant/kernel/k4_integrate"]
    assert abs(got - own) <= TOLERANCE * own, (got, own)
    every = _us(ops)
    for stage in ("illuminant/particles/tick", "illuminant/particles/update"):
        assert abs(spans[stage] - every) <= TOLERANCE * every, stage


@pytest.mark.cuda
def test_cuda_recorder_counts_each_queue_drain():
    """A scalar read, a blocking upload and a copy to the host each count
    one sync on the span they ran in; the pinned upload counts none."""
    _needs_card()
    from illuminant_tpu_torch.core import trace
    from illuminant_tpu_torch.core.upload import upload

    x = torch.arange(8.0, device="cuda")
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with trace.recording() as rec:
        with trace.span("test/item"):
            x.sum().item()
        with trace.span("test/blocking_upload"):
            torch.tensor(1.5, device="cuda")
        with trace.span("test/cpu"):
            x.cpu()
        with trace.span("test/pinned_upload"):
            upload([1.0, 2.0], "cuda")
    assert torch.cuda.get_sync_debug_mode() == mode
    assert {r.name: r.syncs for r in rec.records} == {
        "test/item": 1, "test/blocking_upload": 1, "test/cpu": 1,
        "test/pinned_upload": 0}
    assert rec.totals["syncs"] == 3 and rec.outside["syncs"] == 0


@pytest.mark.cuda
def test_cuda_recorder_launches_match_the_launch_counts(cell):
    """Over one flagship frame and one particle frame (update, render),
    the launches the recorder adds up on its records are the change in
    `cuda_build.launches()`."""
    from illuminant_tpu_torch.core import cuda_build, trace
    from illuminant_tpu_torch.raster.tiled import TiledRasterConfig
    from illuminant_tpu_torch.scenes import build_flagship

    dev = torch.device("cuda")
    sc = build_flagship(height=135, width=240, capacity=1 << 14,
                        spawn_max=256, n_lights=4, device=dev)
    env_u = sc.environment.uniforms(device=dev)
    state = {"s": sc.system.state}

    def flagship():
        _, state["s"], _, _ = sc.frame(
            state["s"], torch.tensor(0.5, device=dev),
            torch.Generator(device=dev).manual_seed(3), sc.volume,
            sc.gbuffer, sc.sphere_lights, env_u, 256)

    raster = TiledRasterConfig(height=cs.PARTICLE_FULL["height"],
                               width=cs.PARTICLE_FULL["width"])

    def particles():
        cell.update(cs.DT)
        cell.render(raster)

    for frame in (flagship, particles):
        frame()  # builds what the frame launches
        torch.cuda.synchronize()
        before = sum(cuda_build.launches().values())
        with trace.recording() as rec:
            frame()
        torch.cuda.synchronize()
        counted = sum(cuda_build.launches().values()) - before
        assert counted > 0, frame.__name__
        assert sum(r.launches for r in rec.records) == counted
        assert rec.totals["launches"] == counted
        assert rec.outside["launches"] == 0
        assert all(r.launches == 0 for r in rec.records
                   if not r.name.startswith("illuminant/kernel/"))
