"""Frozen tensor dataclasses and profiler scopes.

Counterpart of illuminant_tpu/core/pytree.py. JAX registers its state as
pytrees so that jit can trace it; PyTorch runs eagerly, so a port
dataclass is a plain frozen dataclass of tensors with the same
`.replace(**updates)` functional update. Equality is identity (eq=False):
an elementwise tensor comparison has no single truth value.
"""

from __future__ import annotations

import dataclasses
import functools

import torch


def tensor_dataclass(cls):
    """Decorator: frozen dataclass with a `.replace(**updates)` method."""
    cls = dataclasses.dataclass(frozen=True, eq=False)(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls


def named_scope(name: str):
    """Decorator: run the function inside torch.profiler.record_function —
    the counterpart of the JAX package's jax.named_scope; the scope shows
    up as a range in torch.profiler traces."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
