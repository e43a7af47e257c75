"""The comparison that decides `correct`: each number of a cell's workload
file ("checks") reduces the program's and the reference's results of every
compared frame to one reading, the largest over the frames, and holds it
to its limit.

Kinds of number:
  rel      the largest |program - reference| over the listed results, as a
           share of the reference's largest magnitude of that result; an
           integer result that differs at all, a non-finite value or a
           result of another shape reads MISMATCH;
  u8_max   the largest difference of a uint8 image, in levels;
  u8_mean  the mean difference of a uint8 image, in levels.
"""

from __future__ import annotations

import torch

# The reading of results that cannot be compared number by number (a
# finite stand-in for infinity, which JSON does not have).
MISMATCH = 1e30


def _rel(prog, ref) -> float:
    if prog.shape != ref.shape:
        return MISMATCH
    if not ref.dtype.is_floating_point:
        return 0.0 if torch.equal(prog, ref) else MISMATCH
    prog, ref = prog.to(torch.float64), ref.to(torch.float64)
    if not bool(torch.isfinite(prog).all()):
        return MISMATCH
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((prog - ref).abs().max()) if ref.numel() else 0.0
    return err / scale if scale > 0.0 else (0.0 if err == 0.0 else MISMATCH)


def reading(kind: str, keys, prog: dict, ref: dict) -> float:
    if kind == "rel":
        return max(_rel(prog[k].to(ref[k].device), ref[k]) for k in keys)
    (key,) = keys
    a = prog[key].to(ref[key].device)
    if a.shape != ref[key].shape:
        return MISMATCH
    d = (a.to(torch.int32) - ref[key].to(torch.int32)).abs()
    if kind == "u8_max":
        return float(d.max())
    if kind == "u8_mean":
        return float(d.to(torch.float64).mean())
    raise ValueError(f"unknown kind of number {kind!r}")


def readings(checks: dict, prog: dict, ref: dict) -> dict:
    """checks: {name: {"kind", "keys", "limit"}} -> {name: the reading of
    one frame's program and reference results}."""
    return {name: reading(spec["kind"], spec["keys"], prog, ref)
            for name, spec in checks.items()}


def verdict(checks: dict, frames: list):
    """frames: a list of (program results, reference results). ->
    (correct, frames failed, {name: {"value", "limit"}}), each value the
    largest over the frames; a frame fails where a reading passes its
    limit."""
    per = [readings(checks, p, r) for p, r in frames]
    failed = sum(any(v[n] > spec["limit"] for n, spec in checks.items())
                 for v in per)
    shown = {n: dict(value=max(v[n] for v in per), limit=spec["limit"])
             for n, spec in checks.items()}
    return failed == 0, failed, shown
