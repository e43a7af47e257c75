"""The scan shadows' readout after the column walk on the CPU: the plain
version (`scan_shadows.scan_readout_reference`), which `scan_readout`
takes for CPU tensors, against the JAX package's `scan_visibility` over
the option grid of `scan_readout_cases`; K2's launch plan; and the
checks `scan_readout_kernel.scan_readout_cuda` makes of its arguments
before it needs the card. K2 itself is held to the plain version on the
card (tests/test_torch_scan_readout_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scan_readout_cases as cases
from illuminant_tpu.core.config import QualitySettings as JQuality
from illuminant_tpu.lighting import environment as jenv
from illuminant_tpu.lighting.scan_shadows import scan_visibility_jit
from illuminant_tpu.sdf import analytic as janalytic
from illuminant_tpu.sdf import columns as jcols
from illuminant_tpu.sdf import height_volume as jhv
from illuminant_tpu.sdf import volume as jvol
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.lighting import scan_readout_kernel as k2
from illuminant_tpu_torch.lighting import scan_shadows
from illuminant_tpu_torch.sdf.analytic import AnalyticScene
from illuminant_tpu_torch.sdf.columns import ColumnField
from illuminant_tpu_torch.sdf.volume import SdfVolume

torch.set_num_threads(1)


def _jax_field(kind: str, grid):
    """The JAX package's field of a case and the port's copy of it."""
    obs = [jenv.LightObstruction(type=o.type, center=o.center, size=o.size,
                                 rotation=o.rotation)
           for o in cases.obstructions("prisms" if kind == "prisms"
                                       else "four")]
    if kind in ("prisms", "four"):
        vols = ([jhv.HeightVolume(polygon=p, z_base=z, height=h)
                 for p, z, h in cases.VOLUMES] if kind == "prisms" else None)
        j, cls = janalytic.pack_scene(obs, height_volumes=vols), \
            AnalyticScene
    else:
        c = cases.volume_config(grid)
        env = jenv.LightingEnvironment()
        env.obstructions += obs
        j = jvol.generate_volume(jvol.SdfVolumeConfig(
            virtual_width=c.virtual_width, virtual_height=c.virtual_height,
            virtual_depth=c.virtual_depth, slice_count=c.slice_count,
            resolution_scale=c.resolution_scale), env.pack_obstructions())
        cls = SdfVolume
        if kind == "columns":
            j, cls = jcols.build_column_maps(j), ColumnField
    return j, interop.to_torch(cls, interop.as_numpy_fields(j))


@pytest.mark.parametrize("name", list(cases.CASES))
def test_readout_matches_jax(name, monkeypatch):
    """`scan_visibility` on the CPU, its readout the plain version (the
    kernel's wrapper is never called), against the JAX package's: every
    field kind, 0-3 candidates, 0-2 halvings, heights and offsets shared
    or per lane, the trace budget, a window, odd tile edges, a power."""
    case = cases.CASES[name]
    grid = case.get("grid", cases.GRID)
    field_j, field_t = _jax_field(case["field"], grid)

    def no_kernel(*a, **kw):
        raise AssertionError("the CPU readout called the kernel's wrapper")

    monkeypatch.setattr(k2, "scan_readout_cuda", no_kernel)
    out, (args, kw) = cases.port_scan(field_t, case, "cpu")
    ref_t = scan_shadows.scan_readout_reference(*args, **kw)
    assert torch.equal(out, ref_t)
    arrays = {k: jnp.asarray(v) for k, v in cases.inputs(case).items()}
    ref = np.asarray(scan_visibility_jit(
        field_j, grid[0], grid[1], arrays.pop("light_position"),
        arrays.pop("light_radius"), arrays.pop("light_ramp_length"),
        JQuality(**cases.quality(case)), trace_z=jnp.float32(cases.TRACE_Z),
        **arrays), np.float32)
    out = out.numpy()
    assert out.shape == ref.shape == (len(cases.LIGHTS),) + grid
    assert np.isfinite(out).all()
    # The JAX walk stores its carries and nominated fields in float16 and
    # upsamples in bfloat16; the port keeps float32: the bound of
    # tests/test_torch_scan_analytic.py, mean |d| <= 0.01.
    d = np.abs(out - ref)
    assert d.mean() <= 0.01, d.mean()
    # Not two flat images: the scene shadows part of each.
    assert (ref < 0.5).any() and (ref > 0.9).any()


@pytest.mark.parametrize("grid,halvings", [
    ((48, 80), 0), ((48, 80), 1), ((48, 80), 2), ((96, 160), 3),
    ((540, 960), 1), ((1080, 1920), 2), ((100, 164), 2), ((6, 10), 1),
    ((1, 1), 0), ((4096, 4096), 8)])
@pytest.mark.parametrize("instance", ["analytic", "carried", "none"])
def test_launch_plan_covers_every_grid(grid, halvings, instance):
    """Every tile of every staged level fits the source's region; the grid
    covers the readout; shared memory holds the staged scene and two
    levels of the instance's channels."""
    h, w = grid
    plan = k2.launch_plan(h, w, 3, halvings, instance, scene_floats=150)
    assert plan["grid"] == (-(-w // k2.TILE_X), -(-h // k2.TILE_Y), 3)
    assert len(plan["levels"]) == halvings
    for rows, cols in plan["levels"]:
        assert 1 <= rows <= k2.REGION[0] and 1 <= cols <= k2.REGION[1]
    staged = (2 * k2.CHANNELS[instance == "carried"] * k2.REGION[0]
              * k2.REGION[1] * 4 if halvings else 0)
    scene = 4 * 152 if instance == "analytic" else 0
    assert plan["smem_bytes"] == staged + scene
    assert plan["instance"] == 2 * k2.INSTANCES[instance] + (halvings > 0)


@pytest.mark.parametrize("args", [
    (48, 80, 3, 5, "analytic"),        # 80 is not 2^5 x an integer
    (48, 80, 3, 9, "analytic"),        # above the source's 8 halvings
    (48, 80, 0, 1, "analytic"),        # no lane
    (48, 80, 3, 1, "octree"),          # no such instance
    (32768, 32768, 2, 1, "carried"),   # the output reaches 2^31
])
def test_launch_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        k2.launch_plan(*args)


@pytest.mark.parametrize("power,mode", [
    (1.0, 1), (0.0, 0), (0.5, 2), (2.0, 3), (3.0, 4), (-1.0, 5), (-2.0, 6),
    (-0.5, 7), (1.7, 8)])
def test_pow_mode_names_torch_pow_special_cases(power, mode):
    assert k2.pow_mode(power) == mode


def _cpu_call(name="prisms"):
    case = cases.CASES[name]
    fld = cases.field(case["field"], "cpu", case.get("grid", cases.GRID))
    _, (args, kw) = cases.port_scan(fld, case, "cpu")
    return list(args), dict(kw)


def _break(what, args, kw):
    """Spoil one argument of a readout call (args as scan_readout's)."""
    if what == "walk_dtype":
        args[1] = args[1].double()
    elif what == "walk_layout":
        args[1] = args[1].transpose(3, 4).contiguous().transpose(3, 4)
    elif what == "walk_channels":
        args[1] = args[1][:, :2].contiguous()
    elif what == "walk_grid":
        args[10] = args[10] + 2
    elif what == "lane_shape":
        args[2] = args[2][:2]
    elif what == "light_dtype":
        args[4] = args[4].double()
    elif what == "radius_device":
        args[5] = args[5].to("meta")
    elif what == "trace_z":
        args[8] = torch.zeros(2)
    elif what == "pixel_z_layout":
        kw["pixel_z"] = kw["pixel_z"].T.contiguous().T
    elif what == "pixel_z_shape":
        kw["pixel_z"] = kw["pixel_z"][:, :-1].contiguous()
    elif what == "offsets_shape":
        kw["pixel_offset_xy"] = kw["pixel_offset_xy"][..., :1].contiguous()
    elif what == "world_offset":
        kw["world_offset"] = torch.zeros(3)
    elif what == "budget_shape":
        kw["max_trace_distance"] = torch.zeros(2)
    return args, kw


@pytest.mark.parametrize("what,says", [
    ("walk_dtype", "walk"), ("walk_layout", "walk"),
    ("walk_channels", "walk"), ("walk_grid", "halvings"),
    ("lane_shape", "lx"), ("light_dtype", "light_position"),
    ("radius_device", "light_radius"), ("trace_z", "trace_z"),
    ("pixel_z_layout", "pixel_z"), ("pixel_z_shape", "pixel_z"),
    ("offsets_shape", "pixel_offset_xy"), ("world_offset", "world_offset"),
    ("budget_shape", "max_trace_distance"), ("none", "no kernel for device"),
])
def test_wrapper_checks_its_arguments(what, says):
    """The wrapper refuses, before it needs the card, a walk or an array
    of another type, layout, shape or device than the kernel reads; CPU
    tensors it refuses for the device."""
    args, kw = _break(what, *_cpu_call())
    with pytest.raises(ValueError, match=says):
        k2.scan_readout_cuda(*args, **kw)
