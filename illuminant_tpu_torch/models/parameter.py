"""Host-side animatable parameters: Bezier + Parameter<T> (the port's own
copy of illuminant_tpu/models/parameter.py, which it does not import).

Ports the configuration surface of the reference's Bezier.cs
(Bezier<T>: Count/MinValue/MaxValue/Mode + up to 4 control points,
BezierTimeMode enum :14-24) and Parameter.cs (tagged union: constant |
bezier | named reference | binary expression, evaluated with a
NamedConstantResolver). JSON shapes follow Modeling/JSON.cs so Lumined
scene files round-trip:

  Parameter: {"ValueType": ..., "Constant": v} | {"Bezier": {...},
  "BezierType": ...} | {"Name": "..."} | {"Expression": {...}}
  Bezier: {"Mode": int, "Count": n, "MinValue": f, "MaxValue": f,
  "A": v, "B": v, "C": v, "D": v}

Vector values serialize as XNA-style {"X":..,"Y":..[,"Z","W"]} objects;
plain numbers/lists are also accepted. Evaluation stays numpy on the host;
`Bezier.packed(device)` makes the device-side ClampedBezier of the port's
ops/bezier.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np

# BezierTimeMode (Bezier.cs:14-24).
MODE_ONCE = 0
MODE_SINE = 1
MODE_EXP = 2
MODE_LOOP = 256
MODE_BOUNCE = 512

_XYZW = ("X", "Y", "Z", "W")


def value_to_array(v, width: Optional[int] = None) -> np.ndarray:
    """Accept scalar / list / XNA-style dict."""
    if isinstance(v, dict):
        keys = [k for k in _XYZW if k in v]
        arr = np.asarray([float(v[k]) for k in keys], np.float32)
    elif isinstance(v, (list, tuple, np.ndarray)):
        arr = np.asarray(v, np.float32).reshape(-1)
    else:
        arr = np.asarray([float(v)], np.float32)
    if width is not None and arr.shape[0] != width:
        out = np.zeros((width,), np.float32)
        out[: min(width, arr.shape[0])] = arr[:width]
        arr = out
    return arr


def array_to_value(arr: np.ndarray):
    arr = np.asarray(arr).reshape(-1)
    if arr.shape[0] == 1:
        return float(arr[0])
    return {k: float(arr[i]) for i, k in enumerate(_XYZW[: arr.shape[0]])}


@dataclasses.dataclass
class Bezier:
    """Host bezier (Bezier.cs:46-151). points: list of np arrays (C,)."""

    points: List[np.ndarray] = dataclasses.field(default_factory=list)
    min_value: float = 0.0
    max_value: float = 1.0
    mode: int = MODE_ONCE

    @property
    def count(self) -> int:
        return len(self.points)

    @property
    def channels(self) -> int:
        return self.points[0].shape[0] if self.points else 1

    def evaluate(self, value: float) -> np.ndarray:
        """CPU mirror of the GPU evaluator (Bezier.fxh / ops/bezier.py)."""
        pts = self.points
        if not pts:
            return np.zeros((1,), np.float32)
        if len(pts) == 1:
            return pts[0]
        divisor = self.max_value - self.min_value
        inv = 1.0 / divisor if divisor != 0 else 1.0
        t = (value - self.min_value) * abs(inv)
        bouncing = self.mode > 511
        repeating = self.mode > 255
        if bouncing:
            t *= 2
            t = 2 - math.fmod(t, 2) if inv < 0 else math.fmod(t, 2)
            if t > 1:
                t = 2 - t
        elif repeating:
            t = 1 - math.fmod(t, 1) if inv < 0 else math.fmod(t, 1)
        else:
            t = min(max(t, 0.0), 1.0)
            if inv < 0:
                t = 1 - t
        base = self.mode % 256
        if base == MODE_SINE:
            t = math.sin(t * math.pi * 0.5)
        elif base == MODE_EXP:
            t = t * t
        a = pts[0]
        b = pts[1]
        ab = a + (b - a) * t
        if len(pts) == 2:
            return ab
        c = pts[2]
        if len(pts) == 3:  # shelf
            if t <= 0:
                return a
            if t >= 1:
                return c
            return b
        d = pts[3]
        bc = b + (c - b) * t
        cd = c + (d - c) * t
        abbc = ab + (bc - ab) * t
        bccd = bc + (cd - bc) * t
        return abbc + (bccd - abbc) * t

    def packed(self, device=None):
        """Device-side ClampedBezier (ops/bezier.py) on `device`."""
        from ..ops.bezier import pack_bezier

        pts = self.points or [np.zeros((1,), np.float32)]
        return pack_bezier(
            np.stack(pts), self.min_value, self.max_value, self.mode,
            device=device
        )

    @staticmethod
    def from_json(obj: dict, width: Optional[int] = None) -> "Bezier":
        count = int(obj.get("Count", 0))
        pts = []
        for i, key in enumerate(("A", "B", "C", "D")):
            if i >= count:
                break
            pts.append(value_to_array(obj.get(key, 0.0), width))
        return Bezier(
            points=pts,
            min_value=float(obj.get("MinValue", 0.0)),
            max_value=float(obj.get("MaxValue", 1.0)),
            mode=int(obj.get("Mode", 0)),
        )

    def to_json(self) -> dict:
        out = {
            "Mode": self.mode,
            "Count": self.count,
            "MinValue": self.min_value,
            "MaxValue": self.max_value,
        }
        for i, key in enumerate(("A", "B", "C", "D")):
            if i < self.count:
                out[key] = array_to_value(self.points[i])
        return out


# Binary expression operators (Parameter.cs Operators).
OP_ADD = "Add"
OP_SUBTRACT = "Subtract"
OP_MULTIPLY = "Multiply"
OP_DIVIDE = "Divide"

_OPS: dict = {
    OP_ADD: lambda a, b: a + b,
    OP_SUBTRACT: lambda a, b: a - b,
    OP_MULTIPLY: lambda a, b: a * b,
    OP_DIVIDE: lambda a, b: a / np.maximum(np.abs(b), 1e-9) * np.sign(b),
}

Resolver = Callable[[str, float], Optional[np.ndarray]]


@dataclasses.dataclass
class Parameter:
    """Parameter<T> (Parameter.cs:12-666): constant | bezier | named
    reference | binary expression, width = channel count."""

    constant: Optional[np.ndarray] = None
    bezier: Optional[Bezier] = None
    name: Optional[str] = None
    expression: Optional[tuple] = None  # (lhs Parameter, op, rhs Parameter)
    width: int = 1
    value_type: str = "System.Single"

    @staticmethod
    def of(value: Union[float, Sequence, "Parameter", Bezier]) -> "Parameter":
        if isinstance(value, Parameter):
            return value
        if isinstance(value, Bezier):
            return Parameter(bezier=value, width=value.channels)
        arr = value_to_array(value)
        return Parameter(constant=arr, width=arr.shape[0])

    def evaluate(self, t: float, resolver: Optional[Resolver] = None,
                 _depth: int = 0) -> np.ndarray:
        """Parameter.Evaluate with the recursion guard (Parameter.cs)."""
        if _depth > 8:
            return np.zeros((self.width,), np.float32)
        if self.name is not None and resolver is not None:
            resolved = resolver(self.name, t)
            if resolved is not None:
                return value_to_array(resolved, self.width)
        if self.expression is not None:
            lhs, op, rhs = self.expression
            a = lhs.evaluate(t, resolver, _depth + 1)
            b = rhs.evaluate(t, resolver, _depth + 1)
            return _OPS[op](a, b).astype(np.float32)
        if self.bezier is not None:
            return value_to_array(self.bezier.evaluate(t), self.width)
        if self.constant is not None:
            return self.constant
        return np.zeros((self.width,), np.float32)

    # -- JSON (Modeling/JSON.cs Parameter`1 case) ------------------------

    _WIDTHS = {
        "System.Single": 1,
        "Microsoft.Xna.Framework.Vector2": 2,
        "Microsoft.Xna.Framework.Vector3": 3,
        "Microsoft.Xna.Framework.Vector4": 4,
        "Microsoft.Xna.Framework.Color": 4,
    }

    @staticmethod
    def from_json(obj: Any) -> "Parameter":
        if not isinstance(obj, dict) or not (
            "ValueType" in obj or "Name" in obj or "Bezier" in obj
            or "Expression" in obj or "Constant" in obj
        ):
            # Raw value form (JSON.cs:158-161).
            arr = value_to_array(obj)
            return Parameter(constant=arr, width=arr.shape[0])
        vt = str(obj.get("ValueType", "System.Single")).split(",")[0].strip()
        width = Parameter._WIDTHS.get(vt, 1)
        if "Expression" in obj:
            e = obj["Expression"]
            return Parameter(
                expression=(
                    Parameter.from_json(e["LeftHandSide"]),
                    e.get("Operator", OP_ADD),
                    Parameter.from_json(e["RightHandSide"]),
                ),
                width=width,
                value_type=vt,
            )
        if "Name" in obj and obj["Name"]:
            return Parameter(name=str(obj["Name"]), width=width,
                             value_type=vt)
        if "Bezier" in obj:
            return Parameter(
                bezier=Bezier.from_json(obj["Bezier"], width),
                width=width,
                value_type=vt,
            )
        return Parameter(
            constant=value_to_array(obj.get("Constant", 0.0), width),
            width=width,
            value_type=vt,
        )

    def to_json(self) -> dict:
        vt = self.value_type
        if self.name is not None:
            return {"ValueType": vt, "Name": self.name}
        if self.expression is not None:
            lhs, op, rhs = self.expression
            return {
                "ValueType": vt,
                "Expression": {
                    "LeftHandSide": lhs.to_json(),
                    "Operator": op,
                    "RightHandSide": rhs.to_json(),
                },
            }
        if self.bezier is not None:
            return {
                "ValueType": vt,
                "BezierType": f"Bezier{self.width}",
                "Bezier": self.bezier.to_json(),
            }
        return {
            "ValueType": vt,
            "Constant": array_to_value(
                self.constant
                if self.constant is not None
                else np.zeros((self.width,), np.float32)
            ),
        }
