"""Copies of a frame's inputs and results, taken as the timed path makes
them, for the comparison after the window. The copies go to host memory
without waiting for the device (pinned on the card), so the device's
memory peak does not hold them and the host does not stall."""

from __future__ import annotations

import torch


class Recorder:
    """`keep(name, value)` enqueues a copy of a tensor into a host buffer
    (the matching one of `buffers`, or a new one) and keeps other values
    as they are; `out` holds the copies."""

    def __init__(self, buffers=None, pin: bool = False):
        self.buffers = buffers
        self.pin = pin
        self.out = {}

    def keep(self, name: str, value):
        if not torch.is_tensor(value):
            self.out[name] = value
            return
        if self.buffers is not None and name in self.buffers:
            buf = self.buffers[name]
        else:
            buf = torch.empty(value.shape, dtype=value.dtype,
                              pin_memory=self.pin)
        buf.copy_(value, non_blocking=self.pin)
        self.out[name] = buf


def like(host: dict, pin: bool) -> dict:
    """Empty host buffers shaped as the tensors of `host`."""
    return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
            for k, v in host.items() if torch.is_tensor(v)}
