"""Build, load, launch, check and count the package's hand-written CUDA
kernels.

Each kernel wrapper holds one `Library` for its source in
`illuminant_tpu_torch/csrc/`. At its first call the library is compiled
with nvcc for sm_90a into `build/illuminant_tpu_torch/` beside the
package, unless an up-to-date library is already there, opened with
ctypes and its entry points declared; every entry point returns a CUDA
error code. `Library.launch` is the one place a kernel is launched: in
the launch span (`trace.launch`), on the device's current stream, and
counted by that span's name in `launches()` and on that span's record
(`trace.count`).
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "illuminant_tpu_torch")
# -fmad=false: products and sums round one by one, as in the kernels'
# plain versions (see each source's header).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# nvcc's output (the ptxas register and shared-memory report) of each
# library this process built, by library path.
BUILD_LOGS: dict[Path, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}.so"


def is_stale(source: Path, library: Path) -> bool:
    """True unless `library` exists and is at least as new as `source`
    and as every header (`*.cuh`) beside it, which a source may include."""
    if not library.exists():
        return True
    built = library.stat().st_mtime
    inputs = [source, *source.parent.glob("*.cuh")]
    return any(p.stat().st_mtime > built for p in inputs)


def build(source: Path, library: Path | None = None) -> Path:
    """Compile `source` into `library` (by default `library_path(source)`)
    unless the library is up to date (`is_stale`). The library is written
    under a temporary name and renamed into place, so concurrent builds
    never load a half-written file."""
    library = library or library_path(source)
    if not is_stale(source, library):
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=library.parent)
    os.close(fd)
    try:
        # -I CSRC: a variant of a source written elsewhere (the study
        # tools') finds the headers its original includes.
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                               tmp, str(source)], capture_output=True,
                              text=True)
        BUILD_LOGS[library] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n"
                               f"{BUILD_LOGS[library]}")
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return library


def load(source: Path, library: Path, argtypes: dict) -> ctypes.CDLL:
    """Build `source` into `library` if needed and open it, giving each
    entry point named in `argtypes` its argument types and an int result."""
    lib = ctypes.CDLL(str(build(source, library)))
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str):
    """Raise on a nonzero CUDA error code returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# Kernel launches since import (or since `reset_launches`), by the
# kernel's launch-span name (`trace.launch`): each `Library` enters its
# kernels at 0, and `Library.launch` is the only place that adds.
_LAUNCHES: dict[str, int] = {}


def launches() -> collections.Counter:
    """A copy of the launch counts, e.g. {"k1_scan_walk": 1, ...}; a
    kernel whose wrapper was never imported launched nothing and reads
    0."""
    return collections.Counter(_LAUNCHES)


def reset_launches():
    """Set every launch count to 0."""
    for kernel in _LAUNCHES:
        _LAUNCHES[kernel] = 0


class Library:
    """One CUDA source of `CSRC` (or at `source`, a path), compiled into
    `path` (by default `library_path(source)`) and loaded at the first
    call, never before. `entry_points` gives each entry point's argument
    types, the stream last for those that launch; `kernels` names the
    launch spans of the kernels it launches."""

    def __init__(self, source, entry_points: dict, kernels,
                 path: Path | None = None):
        self.source = CSRC / source
        self.path = path or library_path(self.source)
        self.entry_points = entry_points
        self.kernels = tuple(kernels)
        self._lib = None
        for kernel in self.kernels:
            _LAUNCHES.setdefault(kernel, 0)

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def build(self) -> Path:
        """Compile the source unless an up-to-date library is there."""
        return build(self.source, self.path)

    def _entry(self, name: str):
        if self._lib is None:
            self._lib = load(self.source, self.path, self.entry_points)
        return getattr(self._lib, name)

    def call(self, entry: str, *args):
        """Call an entry point that launches nothing (a `*_plan` query);
        raise on its error code."""
        check(self._entry(entry)(*args), entry)

    def launch(self, kernel: str, entry: str, device, *args,
               reports: bool = False):
        """Launch `kernel` through `entry` on `device`'s current stream,
        in the span `illuminant/kernel/<kernel>`; raise on its error code,
        then count the launch, in `launches()` and on the span's record
        of a running recording. `reports`: the entry point's last argument
        before the stream is an int it sets to the kernels it launched,
        which the count adds instead of 1."""
        fn = self._entry(entry)
        launched = ctypes.c_int(1)
        if reports:
            args += (ctypes.byref(launched),)
        with trace.launch(kernel), torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
            check(err, entry)
            _LAUNCHES[kernel] += launched.value
            trace.count("launches", launched.value)
