"""SaveAsCode on the port (illuminant_tpu_torch/models/codegen.py): the
emitted module builds the port's systems explicitly (no JSON), on the
device it is given, and they step bit-identically to the port's JSON view
on the CPU (tests/test_codegen.py's contract); the emitted named
variables equal the JAX module's."""

import inspect
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from illuminant_tpu.models import codegen as jcodegen
from illuminant_tpu.models import model as jmodel
from illuminant_tpu_torch.models.codegen import save_as_code
from illuminant_tpu_torch.models.model import EngineModel
from illuminant_tpu_torch.models.view import EngineView
from test_codegen import MODEL_JSON
from test_models import SAMPLE

torch.set_num_threads(1)

# name -> (JSON, collides with a small ColumnField). The engine cell's
# model has a Noise and a FeedbackSpawner fed by another system, which
# the JAX package's emitter cannot write.
MODELS = {"codegen": (MODEL_JSON, False), "sample": (json.dumps(SAMPLE),
                                                      False),
          "engine_cell": (cs.model_json(**cs.MODEL_SMALL), True)}


def _compile(model):
    ns: dict = {}
    exec(compile(save_as_code(model), "<generated>", "exec"), ns)
    return ns


@pytest.mark.parametrize("name", sorted(MODELS))
def test_codegen_matches_json_view_bit_for_bit(name):
    text, collide = MODELS[name]
    model = EngineModel.loads(text)
    src = save_as_code(model)
    assert "loads(" not in src and "MODEL_JSON" not in src
    assert "illuminant_tpu_torch.particles" in src
    assert "from illuminant_tpu." not in src
    ns = _compile(model)
    assert inspect.signature(ns["build_systems"]).parameters[
        "device"].default == "cuda"
    field = (cs.small_column_field(cs.particle_api("cpu"), 96, 160, "cpu")
             if collide else None)
    compiled = ns["build_systems"](volume=field, capacity=1 << 10,
                                   device="cpu")
    view = EngineView(model, volume=field, capacity=1 << 10, device="cpu")
    assert len(compiled) == len(view.systems) == len(model.systems)
    for s, sv in zip(compiled, view.systems):
        assert s.config == sv.system.config
        assert s.state.position.device == torch.device("cpu")
    for _ in range(20):
        for s in compiled:
            s.update(cs.DT)
        view.update(cs.DT)
    for s, sv in zip(compiled, view.systems):
        assert sv.system.live_count > 0
        assert torch.equal(s.state.live_mask(), sv.system.state.live_mask())
        for f in ("position", "velocity", "color"):
            assert torch.equal(getattr(s.state, f),
                               getattr(sv.system.state, f)), (name, f)


def test_codegen_wires_feedback_and_seeds_noise_like_the_view():
    """The emitted FeedbackSpawner feeds on the system its SourceSystem
    names, and the emitted Noise starts the view's offset stream."""
    model = EngineModel.loads(MODELS["engine_cell"][0])
    compiled = _compile(model)["build_systems"](capacity=64, device="cpu")
    view = EngineView(model, capacity=64, device="cpu")
    fb = compiled[1].transforms[0]
    assert fb.source is compiled[0]
    assert view.systems[1].system.transforms[0].source is \
        view.systems[0].system
    noise = compiled[0].transforms[2]
    assert noise._rng.bit_generator.state == \
        view.systems[0].system.transforms[2]._rng.bit_generator.state


@pytest.mark.parametrize("name", ["codegen", "sample"])
def test_named_variables_match_jax(name):
    text = MODELS[name][0]
    ns = _compile(EngineModel.loads(text))
    jns: dict = {}
    exec(compile(jcodegen.save_as_code(jmodel.EngineModel.loads(text)),
                 "<generated>", "exec"), jns)
    assert ns["NAMED_VARIABLES"] == jns["NAMED_VARIABLES"]
    if name == "codegen":
        assert ns["NAMED_VARIABLES"]["rate"][0] == [300.0]


def test_named_variables_of_the_engine_cell():
    model = EngineModel.loads(MODELS["engine_cell"][0])
    resolve = jmodel.EngineModel.loads(
        MODELS["engine_cell"][0]).make_resolver()
    named = _compile(model)["NAMED_VARIABLES"]
    assert set(named) == {"rate", "tint"}
    for k, (value, external) in named.items():
        np.testing.assert_array_equal(value, resolve(k, 0.0))
        assert external == model.named_variables[k].is_external


def test_codegen_empty_model():
    ns = _compile(EngineModel())
    assert ns["build_systems"](device="cpu") == []
    assert ns["NAMED_VARIABLES"] == {}


def test_codegen_refuses_a_noise_that_has_drawn():
    """A Generator that has drawn cannot be rebuilt from its seed, so the
    emitter refuses it rather than write a different stream."""
    from illuminant_tpu_torch.models import codegen

    g = np.random.default_rng(5)
    assert codegen._emit(g) == "np.random.default_rng(5)"
    g.uniform()
    with pytest.raises(TypeError, match="drawn"):
        codegen._emit(g)
