"""Scene model: the Lumined-compatible schema (the port's own copy of
illuminant_tpu/models/model.py, which it does not import).

Port of the reference's Modeling/Model.cs: EngineModel {NamedVariables,
Systems[], UserData} (:19-141), SystemModel {Name, Update/DrawOrder,
AdditiveBlend, Configuration, Transforms[]} (:143), TransformModel {Type,
UpdateOrder, Properties bag} (:187), NamedVariableDefinition (:291-332).
JSON layout matches Modeling/JSON.cs (C# type names preserved in "Type"
fields so files round-trip with the reference editor).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from .parameter import Parameter, value_to_array

# Reference transform type names -> our short kinds.
_TYPE_PREFIX = "Squared.Illuminant.Particles.Transforms."
KNOWN_TRANSFORMS = (
    "Spawner",
    "PatternSpawner",
    "FeedbackSpawner",
    "FMA",
    "MatrixMultiply",
    "GeometricTransform",
    "Noise",
    "SpatialNoise",
    "Gravity",
    "Sensor",
)


@dataclasses.dataclass
class NamedVariableDefinition:
    """Model.cs:291-332: an editor-exposed external parameter."""

    default_value: Parameter
    is_external: bool = False

    @staticmethod
    def from_json(obj: dict) -> "NamedVariableDefinition":
        if "DefaultValue" in obj and isinstance(obj["DefaultValue"], dict):
            param = Parameter.from_json(obj["DefaultValue"])
        else:
            param = Parameter.from_json(obj)
        return NamedVariableDefinition(
            default_value=param,
            is_external=bool(obj.get("IsExternal", False)),
        )

    def to_json(self) -> dict:
        return {
            "DefaultValue": self.default_value.to_json(),
            "IsExternal": self.is_external,
        }


@dataclasses.dataclass
class TransformModel:
    """Model.cs:187-223."""

    type: str  # short kind, e.g. "Gravity"
    name: Optional[str] = None
    update_order: int = 0
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_json(obj: dict) -> "TransformModel":
        full = str(obj.get("Type", ""))
        short = full.split(",")[0].strip()
        if short.startswith(_TYPE_PREFIX):
            short = short[len(_TYPE_PREFIX):]
        props: Dict[str, Any] = {}
        for key, mp in (obj.get("Properties") or {}).items():
            if mp is None:
                continue
            # ModelProperty {Type, Value} (JSON.cs:167-180).
            value = mp.get("Value") if isinstance(mp, dict) and "Type" in mp \
                else mp
            props[key] = value
        return TransformModel(
            type=short,
            name=obj.get("Name"),
            update_order=int(obj.get("UpdateOrder", 0)),
            properties=props,
        )

    def to_json(self) -> dict:
        return {
            "Name": self.name,
            "Type": _TYPE_PREFIX + self.type,
            "UpdateOrder": self.update_order,
            "Properties": {
                k: {"Type": "System.Object", "Value": v}
                for k, v in self.properties.items()
            },
        }


@dataclasses.dataclass
class SystemModel:
    """Model.cs:143-185."""

    name: Optional[str] = None
    update_order: int = 0
    draw_order: int = 0
    additive_blend: bool = False
    configuration: Dict[str, Any] = dataclasses.field(default_factory=dict)
    transforms: List[TransformModel] = dataclasses.field(
        default_factory=list
    )

    def sort(self):
        self.transforms.sort(key=lambda t: t.update_order)

    @staticmethod
    def from_json(obj: dict) -> "SystemModel":
        m = SystemModel(
            name=obj.get("Name"),
            update_order=int(obj.get("UpdateOrder", 0)),
            draw_order=int(obj.get("DrawOrder", 0)),
            additive_blend=bool(obj.get("AdditiveBlend", False)),
            configuration=obj.get("Configuration") or {},
            transforms=[
                TransformModel.from_json(t)
                for t in obj.get("Transforms", [])
            ],
        )
        m.sort()
        return m

    def to_json(self) -> dict:
        return {
            "Name": self.name,
            "UpdateOrder": self.update_order,
            "DrawOrder": self.draw_order,
            "AdditiveBlend": self.additive_blend,
            "Configuration": self.configuration,
            "Transforms": [t.to_json() for t in self.transforms],
        }


@dataclasses.dataclass
class EngineModel:
    """Model.cs:19-141."""

    named_variables: Dict[str, NamedVariableDefinition] = dataclasses.field(
        default_factory=dict
    )
    systems: List[SystemModel] = dataclasses.field(default_factory=list)
    user_data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    filename: Optional[str] = None

    # -- IO ----------------------------------------------------------------

    @staticmethod
    def loads(text: str) -> "EngineModel":
        obj = json.loads(text)
        return EngineModel(
            named_variables={
                k: NamedVariableDefinition.from_json(v)
                for k, v in (obj.get("NamedVariables") or {}).items()
            },
            systems=[
                SystemModel.from_json(s) for s in obj.get("Systems", [])
            ],
            user_data=obj.get("UserData") or {},
        )

    @staticmethod
    def load(path: str) -> "EngineModel":
        with open(path, "r", encoding="utf-8-sig") as f:
            model = EngineModel.loads(f.read())
        model.filename = path
        return model

    def dumps(self) -> str:
        return json.dumps(
            {
                "NamedVariables": {
                    k: v.to_json() for k, v in self.named_variables.items()
                },
                "Systems": [s.to_json() for s in self.systems],
                "UserData": self.user_data,
            },
            indent=2,
        )

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.dumps())
        self.filename = path

    # -- named variable resolution (ParticleEngine.cs:172-216) -------------

    def make_resolver(self, overrides: Optional[Dict[str, Any]] = None):
        """NamedConstantResolver: name, t -> value (or None)."""
        overrides = overrides or {}

        def resolve(name: str, t: float):
            if name in overrides:
                return value_to_array(overrides[name])
            defn = self.named_variables.get(name)
            if defn is None:
                return None
            return defn.default_value.evaluate(t, resolve)

        return resolve


def save_as_code(model: "EngineModel", writer=None) -> str:
    """SaveAsCode (Model.cs:122-132, Model.Codegen.cs): emit a module of
    explicit constructor calls rebuilding the model's systems with no JSON
    or reflection at load time — see models/codegen.py."""
    from .codegen import save_as_code as _impl

    return _impl(model, writer=writer)
