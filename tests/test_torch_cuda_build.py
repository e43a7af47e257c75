"""`core/cuda_build.Library`, the one seam of the hand-written kernels,
on the CPU: a fake library stands in for the ctypes one, so the order of
load, launch, check and count is checked without a card; and every
library's declared entry points are held to the `extern "C"` signatures
of its source."""

import contextlib
import ctypes
import re
import types

import pytest
import torch

from illuminant_tpu_torch.core import cuda_build
from illuminant_tpu_torch.lighting import (cone_trace_kernel,
                                           scan_walk_kernel,
                                           tiled_lights_kernel)
from illuminant_tpu_torch.particles import integrate_kernel, spawn_kernel
from illuminant_tpu_torch.raster import splat_kernel, tile_kernel
from illuminant_tpu_torch.sdf import columns_kernel

STREAM = 0xC0FFEE
LIBRARIES = {m.LIBRARY.source.name: m.LIBRARY for m in (
    scan_walk_kernel, cone_trace_kernel, tiled_lights_kernel,
    integrate_kernel, spawn_kernel, splat_kernel, tile_kernel,
    columns_kernel)}


class FakeEntry:
    """An entry point that records its arguments, returns `code` and, with
    `reports`, sets its out-parameter before the stream to that count."""

    def __init__(self, code=0, reports=None):
        self.code, self.reports, self.calls = code, reports, []

    def __call__(self, *args):
        self.calls.append(args)
        if self.reports is not None:
            args[-2]._obj.value = self.reports
        return self.code


@pytest.fixture
def fake(monkeypatch):
    """A Library of two fake entry points over a registry of its own; the
    loads it makes are in `.loads`."""
    monkeypatch.setattr(cuda_build, "_LAUNCHES", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(
                            cuda_stream=STREAM))
    entries = dict(fake_launch=FakeEntry(), fake_plan=FakeEntry())
    loads = []

    def load(source, path, argtypes):
        loads.append((source, path, argtypes))
        return types.SimpleNamespace(**entries)

    monkeypatch.setattr(cuda_build, "load", load)
    argtypes = {"fake_launch": [ctypes.c_int, ctypes.c_void_p],
                "fake_plan": [ctypes.c_int]}
    lib = cuda_build.Library("fake.cu", argtypes, ["k0_fake", "k0_other"])
    lib.entries, lib.loads = entries, loads
    return lib


def test_nothing_loads_before_the_first_call(fake):
    assert not fake.loaded and fake.loads == []
    assert cuda_build.launches() == {"k0_fake": 0, "k0_other": 0}
    fake.call("fake_plan", 3)
    assert fake.loaded
    assert fake.loads == [(cuda_build.CSRC / "fake.cu",
                           cuda_build.library_path(cuda_build.CSRC
                                                   / "fake.cu"),
                           fake.entry_points)]
    fake.launch("k0_fake", "fake_launch", "cuda:0", 5)
    assert len(fake.loads) == 1
    assert fake.entries["fake_plan"].calls == [(3,)]


def test_a_library_path_builds_a_variant(tmp_path, fake):
    variant = cuda_build.Library(tmp_path / "variant.cu", fake.entry_points,
                                 fake.kernels, path=tmp_path / "libv.so")
    assert variant.source == tmp_path / "variant.cu"
    assert variant.path == tmp_path / "libv.so"
    variant.call("fake_plan", 1)
    assert fake.loads[-1][:2] == (tmp_path / "variant.cu",
                                  tmp_path / "libv.so")


@pytest.mark.parametrize("how", ["call", "launch"])
def test_a_nonzero_code_raises_naming_the_entry(fake, how):
    name = f"fake_{how if how == 'launch' else 'plan'}"
    fake.entries[name].code = 719
    with pytest.raises(RuntimeError, match=f"{name} launch failed: CUDA "
                                           "error 719"):
        if how == "call":
            fake.call(name, 1)
        else:
            fake.launch("k0_fake", name, "cuda:0", 1)
    assert cuda_build.launches()["k0_fake"] == 0


def test_a_launch_counts_once_under_its_span_name(fake):
    fake.launch("k0_fake", "fake_launch", "cuda:0", 5)
    fake.launch("k0_fake", "fake_launch", "cuda:0", 6)
    assert cuda_build.launches() == {"k0_fake": 2, "k0_other": 0}
    # The current stream's handle goes last.
    assert fake.entries["fake_launch"].calls == [(5, STREAM), (6, STREAM)]


def test_a_launch_counts_what_the_entry_reports(fake):
    fake.entries["fake_launch"].reports = 4
    fake.launch("k0_other", "fake_launch", "cuda:0", 5, reports=True)
    assert cuda_build.launches() == {"k0_fake": 0, "k0_other": 4}
    args = fake.entries["fake_launch"].calls[0]
    assert args[0] == 5 and args[-1] == STREAM and len(args) == 3


def test_launches_is_a_copy(fake):
    counts = cuda_build.launches()
    counts["k0_fake"] = 9
    assert cuda_build.launches()["k0_fake"] == 0
    # A kernel no imported library declares launched nothing.
    assert cuda_build.launches()["k0_never_declared"] == 0


def test_reset_launches_zeroes_every_count(fake):
    fake.launch("k0_fake", "fake_launch", "cuda:0", 1)
    fake.entries["fake_launch"].reports = 3
    fake.launch("k0_other", "fake_launch", "cuda:0", 1, reports=True)
    assert cuda_build.launches() == {"k0_fake": 1, "k0_other": 3}
    cuda_build.reset_launches()
    assert cuda_build.launches() == {"k0_fake": 0, "k0_other": 0}


def test_a_launch_opens_its_launch_span(fake):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fake.launch("k0_fake", "fake_launch", "cuda:0", 1)
    names = [e.name for e in prof.events()]
    assert names.count("illuminant/kernel/k0_fake") == 1


def _signatures(source):
    """The source's `extern "C"` entry points -> name: parameters."""
    text = re.sub(r"//[^\n]*", "", source.read_text())
    return {name: [p.strip() for p in params.split(",")]
            for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text)}


def _takes(param: str, argtype) -> bool:
    if "*" in param or param.startswith("cudaStream_t"):
        return argtype is ctypes.c_void_p or issubclass(argtype,
                                                        ctypes._Pointer)
    if param.startswith("long long"):
        return argtype is ctypes.c_longlong
    return param.startswith("int ") and argtype is ctypes.c_int


@pytest.mark.parametrize("source", sorted(LIBRARIES))
def test_entry_points_match_the_source(source):
    """Each declared entry point is one of the source's, with as many
    arguments of matching kinds; an entry point with a stream takes it
    last (where `Library.launch` appends it)."""
    lib = LIBRARIES[source]
    signatures = _signatures(lib.source)
    assert sorted(lib.entry_points) == sorted(signatures)
    for name, argtypes in lib.entry_points.items():
        params = signatures[name]
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            assert _takes(param, argtype), (name, param, argtype)
        streams = [i for i, p in enumerate(params)
                   if re.search(r"\bstream_?$", p)]
        assert streams in ([], [len(params) - 1]), (name, params)
    assert lib.kernels and not lib.loaded
