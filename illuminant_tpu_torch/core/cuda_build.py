"""Build and load the package's hand-written CUDA kernels.

Each kernel wrapper names its source in `illuminant_tpu_torch/csrc/`.
`build` compiles it with nvcc for sm_90a at first use, into
`build/illuminant_tpu_torch/` beside the package, unless an up-to-date
library is already there; `load` builds, opens the library with ctypes and
declares its entry points, all of which return a CUDA error code.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

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
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
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
