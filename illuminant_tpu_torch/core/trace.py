"""The port's one tracing mechanism: named spans of host time.

`span(name)` marks a stage of the program, as a context manager or as a
decorator — the counterpart of the JAX package's `jax.named_scope`.
While a profiler records (`torch.profiler.profile`, `emit_nvtx`), a span
opens a `torch.profiler.record_function` range, which lies on the
profiler's clock with the device operations; the profiler adds to its
device time that of the kernels launched inside it. With no profiler
recording, a span costs one check and enters nothing.

`launch(k)` is the span `illuminant/kernel/<k>` around one call into a
hand-written kernel's library (ctypes). The profiler attributes a kernel
to the innermost operator open when it was launched, and a
`record_function` range is no operator (its launches are tied only to
its device-side annotation). So a launch opens an operator's range (a
function-scope RecordFunction): the kernels it launches count in its
device time, and through it in every span around it, as an eager aten
operator's kernels do.

Span names, "illuminant/<layer>/<stage>":
  illuminant/frame/*           the flagship frame's stages (`scenes.py`)
  illuminant/lighting/*, illuminant/scan_shadows, illuminant/sphere_lights,
  illuminant/tiled_particle_lights
                               the light families and the shadow scan
  illuminant/scan_shadows/readout
                               the scan's readout, from the column walk's
                               return to the visibility returned
  illuminant/sphere_lights/ao  the sphere lights' AO sample
  illuminant/renderer/*        `LightingRenderer`'s public calls, its
                               G-buffer (`gbuffer`, inside it
                               `gbuffer/height_volumes` and
                               `gbuffer/billboards`), its field
                               regeneration (`field_regen`, one
                               `field_slab` a slab written) and its light
                               passes
  illuminant/particles/*       `ParticleSystem.update`, `tick`, the
                               transforms, `render`
  illuminant/particle_spawn, illuminant/particle_integrate
                               the tick's spawn and integration
  illuminant/raster/*          `resolve`, `to_uint8`
  illuminant/kernel/*          one hand-written kernel's launch (`launch`)
"""

from __future__ import annotations

import functools

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled
from torch.profiler import record_function


class span:
    """A named span: `with span(name): ...` or `@span(name)`. A span
    object serves one `with` at a time; a decorated function opens a
    fresh range on every call."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def _open(self):
        return record_function(self.name)

    def __enter__(self):
        if _profiler_enabled():
            self._range = self._open()
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with self._open():
                return fn(*args, **kwargs)

        return inner


class launch(span):
    """The span `illuminant/kernel/<kernel>` around one library call that
    launches a hand-written kernel: `with launch("k5_splat"): ...`."""

    __slots__ = ()

    def __init__(self, kernel: str):
        super().__init__(f"illuminant/kernel/{kernel}")

    def _open(self):
        return _RecordFunctionFast(self.name)
