"""The port's modeling layer (illuminant_tpu_torch/models/) against the JAX
package's on the CPU: the same JSON through both packages' EngineModel and
EngineView gives equal system configs, transform and spawner uniforms,
render data and appearances; views ticked with the JAX systems' own spawn
draws injected agree under tests/test_torch_particle_system.py's rule;
Parameter and Bezier evaluate exactly as the JAX copy does; and the nine
cases of tests/test_models.py and the JSON binding of
tests/test_life_ramp.py hold for the port."""

import copy
import dataclasses
import importlib.util
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from illuminant_tpu.models import model as jmodel
from illuminant_tpu.models import parameter as jparam
from illuminant_tpu.models import view as jview
from illuminant_tpu.ops.bezier import evaluate_bezier as jevaluate
from illuminant_tpu_torch.core import interop
from illuminant_tpu_torch.models.model import (EngineModel, SystemModel,
                                               TransformModel, save_as_code)
from illuminant_tpu_torch.models.parameter import (MODE_SINE, Bezier,
                                                   Parameter)
from illuminant_tpu_torch.models.view import (EngineView,
                                              instantiate_transform,
                                              render_data_from_model)
from illuminant_tpu_torch.ops.bezier import evaluate_bezier
from illuminant_tpu_torch.ops.noise import RandomField
from illuminant_tpu_torch.particles import transforms as tx
from illuminant_tpu_torch.particles.spawner import FeedbackSpawner
from test_codegen import MODEL_JSON
from test_models import SAMPLE
from test_torch_columns import sampler_rounding_like_jax
from test_torch_particle_system import FIELDS, _column_fields, jax_draws

torch.set_num_threads(1)

LIFE_RAMP_JSON = json.dumps({"Systems": [{
    "Name": "s",
    "Configuration": {
        "Color": {"LifeRamp": {"Minimum": 0.0, "Maximum": 2.0,
                               "Strength": 0.5, "Invert": True,
                               "Texture": [[[0.0, 0.5, 1.0, 1.0],
                                            [1.0, 0.5, 0.0, 1.0]]]}},
        "Appearance": {"Rounded": True, "RoundingPowerFromLife": {
            "Count": 2, "MinValue": 0.0, "MaxValue": 1.0,
            "A": 0.3, "B": 1.0}},
        "Size": 6.0,
        "RotationFromVelocity": True,
    },
    "Transforms": [],
}]})
# name -> the JSON text both packages load.
MODELS = {
    "sample": json.dumps(SAMPLE),
    "codegen": MODEL_JSON,
    "life_ramp": LIFE_RAMP_JSON,
    "engine_cell": cs.model_json(**cs.MODEL_SMALL),
}


def _tree(x):
    """Host values of a dataclass tree: tensors and JAX arrays as numpy,
    dataclasses as dicts of their public fields (a FeedbackSpawner's
    `source`, a live system, left out)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _tree(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if not f.name.startswith("_") and f.name != "source"}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (list, tuple)):
        return [_tree(v) for v in x]
    if hasattr(x, "shape"):
        return np.asarray(x)
    return x


def _same(port, ref, path="."):
    """Every field of the JAX tree `ref` is in `port` and equal to it."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        for k, v in ref.items():
            assert k in port, f"{path}{k}"
            _same(port[k], v, f"{path}{k}.")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{path}{i}.")
    elif isinstance(ref, np.ndarray) or isinstance(port, np.ndarray):
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                      err_msg=path)
    else:
        assert port == ref, (path, port, ref)


def _carry_noise(jv, tv):
    """The JAX Noise streams (seeded from its per-process counter) and the
    JAX random fields, into the port's view."""
    for js, ts in zip(jv.systems, tv.systems):
        ts.system.random_field = interop.to_torch(
            RandomField, interop.as_numpy_fields(js.system.random_field))
        for j, t in zip(js.system.transforms, ts.system.transforms):
            if isinstance(t, tx.Noise):
                t._rng = copy.deepcopy(j._rng)
                t._offset_a, t._offset_b = j._offset_a, j._offset_b
                t._last_cycle = j._last_cycle


def _views(name, capacity=1 << 10, volumes=(None, None)):
    text = MODELS[name]
    jv = jview.EngineView(jmodel.EngineModel.loads(text), volume=volumes[0],
                          capacity=capacity)
    tv = EngineView(EngineModel.loads(text), volume=volumes[1],
                    capacity=capacity, device="cpu")
    _carry_noise(jv, tv)
    return jv, tv


def _uniforms(t, now, device=None):
    kw = {} if device is None else {"device": device}
    if getattr(t, "is_feedback", False):
        return t.feedback_uniforms(now, **kw)
    return t.uniforms(now, **kw)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_binding_matches_jax(name):
    """Configs, every transform's host fields and uniforms, the feedback
    wiring, the render data and the appearance of each system."""
    jv, tv = _views(name)
    assert [s.model.name for s in tv.systems] == \
        [s.model.name for s in jv.systems]
    for js, ts in zip(jv.systems, tv.systems):
        assert dataclasses.asdict(ts.system.config) == \
            dataclasses.asdict(js.system.config)
        assert [type(t).__name__ for t in ts.system.transforms] == \
            [type(t).__name__ for t in js.system.transforms]
        for j, t in zip(js.system.transforms, ts.system.transforms):
            _same(_tree(t), _tree(j), f"{name}.{type(t).__name__}.")
            _same(_tree(_uniforms(t, 0.0, "cpu")), _tree(_uniforms(j, 0.0)),
                  f"{name}.{type(t).__name__}.uniforms.")
            if isinstance(t, FeedbackSpawner):
                k = [s.system for s in jv.systems].index(j.source)
                assert t.source is tv.systems[k].system
        _same(_tree(render_data_from_model(ts.model, tv.resolver, "cpu")),
              _tree(jview.render_data_from_model(js.model, jv.resolver)),
              f"{name}.render_data.")
        assert (ts.appearance is None) == (js.appearance is None)
        if js.appearance is not None:
            _same(_tree(ts.appearance), _tree(js.appearance),
                  f"{name}.appearance.")


def _step_both(jv, tv, rounded=False):
    """One `update` of each view, the port's with the JAX ticks' draws."""
    before = [s.system._tick_index for s in jv.systems]
    jv.update(cs.DT)
    draws = {s.model.name: [jax_draws(s.system, k)
                            for k in range(b, s.system._tick_index)]
             for s, b in zip(jv.systems, before)}
    if rounded:
        with sampler_rounding_like_jax():
            tv.update(cs.DT, spawn_uniforms=draws)
    else:
        tv.update(cs.DT, spawn_uniforms=draws)


def _agree(js, ts, share):
    """tests/test_torch_particle_system.py's rule."""
    live_j = np.asarray(js.state.live_mask())
    np.testing.assert_array_equal(ts.state.live_mask().numpy(), live_j)
    assert ts.live_count == js.live_count > 0
    assert int(ts.state.write_cursor) == int(js.state.write_cursor)
    assert int(ts.state.total_spawned) == int(js.state.total_spawned)
    ok = np.ones(live_j.shape, bool)
    for f in FIELDS:
        a = getattr(ts.state, f).numpy()
        b = np.asarray(getattr(js.state, f))
        ok &= np.all(np.abs(a - b) <= 1e-4 + 1e-5 * np.abs(b), axis=1)
    assert ok[live_j].mean() >= share, ok[live_j].mean()


# case -> (model, on the ColumnField, share of live particles that must
# agree). Without a field every particle takes the same path; on the
# ColumnField the port's sampler rounds as XLA's does (bf16 maps) for the
# comparison, and then every particle does too.
TICK_CASES = {"sample": ("sample", False), "engine_cell": ("engine_cell",
                                                            False),
              "engine_cell_column_field": ("engine_cell", True)}


@pytest.mark.parametrize("case", sorted(TICK_CASES))
def test_view_ticks_match_jax(case):
    name, field = TICK_CASES[case]
    volumes = _column_fields() if field else (None, None)
    jv, tv = _views(name, volumes=volumes)
    for _ in range(cs.MODEL_TICKS):
        _step_both(jv, tv, rounded=field)
    for js, ts in zip(jv.systems, tv.systems):
        _agree(js.system, ts.system, 1.0)
    assert tv.live_count == jv.live_count


def _random_beziers(rng, n):
    modes = (0, 1, 2, 256, 257, 258, 512, 513, 514)
    for _ in range(n):
        count = int(rng.integers(0, 5))
        width = int(rng.integers(1, 5))
        lo = float(rng.uniform(-2, 2))
        hi = lo + float(rng.choice([-1.5, 0.0, 0.7, 3.0]))
        pts = [rng.uniform(-5, 5, width).astype(np.float32)
               for _ in range(count)]
        yield (dict(points=pts, min_value=lo, max_value=hi,
                    mode=int(rng.choice(modes))),
               rng.uniform(-3.0, 5.0, 12))


def test_bezier_and_parameter_evaluate_like_jax():
    """Host evaluation, JSON round trips and the packed device form are
    equal to the JAX copy's exactly; the device evaluator of each package
    agrees with its packed form to float32 rounding."""
    rng = np.random.default_rng(11)
    for kw, ts in _random_beziers(rng, 60):
        b = Bezier(**copy.deepcopy(kw))
        j = jparam.Bezier(**copy.deepcopy(kw))
        assert b.to_json() == j.to_json()
        for t in ts:
            np.testing.assert_array_equal(b.evaluate(t), j.evaluate(t))
            np.testing.assert_array_equal(
                Bezier.from_json(b.to_json(), b.channels).evaluate(t),
                j.evaluate(t))
        if kw["points"]:
            pb, pj = b.packed(), j.packed()
            np.testing.assert_array_equal(pb.range_and_count.numpy(),
                                          np.asarray(pj.range_and_count))
            np.testing.assert_array_equal(pb.points.numpy(),
                                          np.asarray(pj.points))
            tt = torch.as_tensor(ts.astype(np.float32))
            np.testing.assert_allclose(
                evaluate_bezier(pb, tt).numpy(),
                np.asarray(jevaluate(pj, ts.astype(np.float32))),
                rtol=1e-5, atol=1e-5)
    model = json.loads(json.dumps(SAMPLE))["NamedVariables"]
    for obj in ({"ValueType": "System.Single", "Expression": {
                    "LeftHandSide": {"Name": "rate"}, "Operator": op,
                    "RightHandSide": {"ValueType": "System.Single",
                                      "Constant": 7.0}}}
                for op in ("Add", "Subtract", "Multiply", "Divide")):
        resolve_t = EngineModel.loads(json.dumps(
            {"NamedVariables": model})).make_resolver()
        resolve_j = jmodel.EngineModel.loads(json.dumps(
            {"NamedVariables": model})).make_resolver()
        for t in (0.0, 1.3):
            np.testing.assert_array_equal(
                Parameter.from_json(obj).evaluate(t, resolve_t),
                jparam.Parameter.from_json(obj).evaluate(t, resolve_j))
        assert Parameter.from_json(obj).to_json() == \
            jparam.Parameter.from_json(obj).to_json()


# --- tests/test_models.py's cases, on the port ---------------------------

def test_parameter_constant_and_named():
    p = Parameter.from_json({"ValueType": "System.Single", "Constant": 3.5})
    np.testing.assert_allclose(p.evaluate(0.0), [3.5])
    p2 = Parameter.from_json({"ValueType": "System.Single", "Name": "x"})
    np.testing.assert_allclose(
        p2.evaluate(0.0, lambda name, t: 7.0 if name == "x" else None),
        [7.0])


def test_parameter_bezier_json_roundtrip():
    b = Bezier(points=[np.asarray([0.0], np.float32),
                       np.asarray([4.0], np.float32)],
               min_value=0.0, max_value=2.0, mode=MODE_SINE)
    b2 = Bezier.from_json(b.to_json())
    for t in (0.0, 0.5, 1.0, 1.7, 2.0):
        np.testing.assert_allclose(b2.evaluate(t), b.evaluate(t))
    packed = b.packed()
    for t in (0.0, 0.5, 1.3, 2.0):
        np.testing.assert_allclose(
            evaluate_bezier(packed, torch.tensor(t)).numpy(), b.evaluate(t),
            rtol=1e-5, atol=1e-6)


def test_parameter_expression():
    p = Parameter.from_json({"ValueType": "System.Single", "Expression": {
        "LeftHandSide": {"ValueType": "System.Single", "Constant": 3.0},
        "Operator": "Multiply",
        "RightHandSide": {"ValueType": "System.Single", "Constant": 4.0}}})
    np.testing.assert_allclose(p.evaluate(0.0), [12.0])


def test_model_roundtrip(tmp_path):
    model = EngineModel.loads(json.dumps(SAMPLE))
    assert len(model.systems) == 1 and model.systems[0].additive_blend
    assert model.systems[0].transforms[0].type == "Spawner"
    assert model.user_data["EditorData"]["Zoom"] == 2
    path = str(tmp_path / "scene.json")
    model.save(path)
    model2 = EngineModel.load(path)
    assert model2.systems[0].transforms[1].type == "Gravity"
    assert "rate" in model2.named_variables
    # The port writes the text the JAX package writes.
    assert model.dumps() == jmodel.EngineModel.loads(
        json.dumps(SAMPLE)).dumps()


def test_named_variable_resolution():
    model = EngineModel.loads(json.dumps(SAMPLE))
    resolve = model.make_resolver()
    np.testing.assert_allclose(resolve("rate", 0.0), [600.0])
    np.testing.assert_allclose(resolve("tint", 0.0), [1.0, 0.5, 0.25, 1.0])
    assert resolve("missing", 0.0) is None
    np.testing.assert_allclose(model.make_resolver({"rate": 50.0})(
        "rate", 0.0), [50.0])


def test_view_instantiates_and_runs():
    view = EngineView(EngineModel.loads(json.dumps(SAMPLE)), capacity=2048,
                      device="cpu")
    system = view.systems[0].system
    assert len(system.spawners) == 1 and len(system.modifiers) == 1
    for _ in range(30):
        system.tick(1.0 / 60.0)
    assert view.live_count == 300  # 600/s * 0.5s
    live = system.state.live_mask().numpy()
    assert system.state.velocity.numpy()[live][:, 0].mean() > 0.01


def test_save_as_code_roundtrip(tmp_path):
    src = save_as_code(EngineModel.loads(json.dumps(SAMPLE)))
    path = tmp_path / "compiled_scene.py"
    path.write_text(src)
    spec = importlib.util.spec_from_file_location("compiled_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    systems = mod.build_systems(capacity=512, device="cpu")
    systems[0].tick(1.0 / 60.0)
    assert systems[0].live_count == 10  # 600/s / 60
    assert systems[0].state.position.device == torch.device("cpu")


def test_deterministic_replay():
    model = EngineModel.loads(json.dumps(SAMPLE))

    def run():
        s = EngineView(model, capacity=1024, device="cpu").systems[0].system
        for _ in range(20):
            s.tick(1.0 / 60.0)
        return s.state.position.clone(), s.state.velocity.clone()

    (p1, v1), (p2, v2) = run(), run()
    assert torch.equal(p1, p2) and torch.equal(v1, v2)


def test_view_binding_review_fixes():
    s = instantiate_transform(TransformModel(type="Sensor", name="s"), None)
    assert isinstance(s, tx.Sensor)
    g = instantiate_transform(TransformModel(type="Gravity", name="g",
        properties={"Attractors": [
            {"Position": [0, 0, 0], "Radius": 10.0, "Strength": 5.0,
             "Type": 2}]}), None)
    assert g.attractors[0].falloff_type == 2
    assert g.maximum_acceleration == 8.0
    g0 = instantiate_transform(TransformModel(type="Gravity", name="g",
        properties={"Attractors": [], "MaximumAcceleration": 0.0}), None)
    assert g0.maximum_acceleration == 0.0
    sp = instantiate_transform(TransformModel(type="Spawner", name="sp",
        properties={"MinRate": 60.0, "MaxRate": 60.0}), None)
    assert sp.life.constant == 1.0
    sp0 = instantiate_transform(TransformModel(type="Spawner", name="sp",
        properties={"MinRate": 60.0, "MaxRate": 60.0,
                    "MaximumTotal": 0}), None)
    assert sp0.maximum_total == 0 and sp0.begin_tick(0.0, 1.0) == 0
    m = EngineModel(systems=[
        SystemModel(name="src", transforms=[
            TransformModel(type="Spawner", name="s",
                           properties={"MinRate": 60.0, "MaxRate": 60.0})]),
        SystemModel(name="dst", transforms=[
            TransformModel(type="FeedbackSpawner", name="f",
                           properties={"MinRate": 30.0, "MaxRate": 30.0,
                                       "SourceSystem": "src",
                                       "InstanceMultiplier": 2})]),
    ])
    view = EngineView(m, capacity=1 << 10, device="cpu")
    fb = view.systems[1].system.transforms[0]
    assert isinstance(fb, FeedbackSpawner)
    assert fb.source is view.systems[0].system
    assert fb.instance_multiplier == 2
    # The port keeps the wiring through a live patch (the JAX view's
    # patched FeedbackSpawner feeds on its own system).
    assert view.refresh_variables()
    fb = view.systems[1].system.transforms[0]
    assert fb.source is view.systems[0].system


def test_view_bezier_parameters_animate():
    bez = {"Bezier": {"Mode": 0, "Count": 2, "MinValue": 0.0,
                      "MaxValue": 1.0, "A": 0.0, "B": 100.0}}
    m = EngineModel(systems=[SystemModel(name="s", transforms=[
        TransformModel(type="Gravity", name="g", properties={
            "Attractors": [{"Position": [0, 0, 0], "Radius": 50.0,
                            "Strength": bez, "Type": 1}],
            "MaximumAcceleration": 100.0})])])
    view = EngineView(m, capacity=1 << 8, device="cpu")
    assert view._animated
    g0 = view.systems[0].system.transforms[0].attractors[0].strength
    for _ in range(30):
        view.update(1.0 / 60.0)
    g1 = view.systems[0].system.transforms[0].attractors[0].strength
    assert g1 > g0 + 10.0, (g0, g1)


def test_noise_is_seeded_by_its_place_and_kept_by_a_patch():
    """The k-th Noise of a view draws the stream of seed k, in every view
    of the model; a live patch continues it."""
    text = MODELS["engine_cell"]
    a = EngineView(EngineModel.loads(text), capacity=64, device="cpu")
    b = EngineView(EngineModel.loads(text), capacity=64, device="cpu")
    na, nb = (next(t for t in v.systems[0].system.transforms
                   if isinstance(t, tx.Noise)) for v in (a, b))
    assert na._rng.bit_generator.state == nb._rng.bit_generator.state == \
        np.random.default_rng(1).bit_generator.state
    for _ in range(20):
        a.update(cs.DT)
    offsets = (na._offset_a, na._offset_b)
    a.refresh_variables({"rate": 60.0})
    patched = next(t for t in a.systems[0].system.transforms
                   if isinstance(t, tx.Noise))
    assert patched is not na
    assert (patched._offset_a, patched._offset_b) == offsets
    assert patched._rng is na._rng


def test_json_binding_life_ramp_and_rounding():
    """tests/test_life_ramp.py::test_json_binding_life_ramp_and_rounding
    on the port."""
    view = EngineView(EngineModel.loads(LIFE_RAMP_JSON), device="cpu")
    sv = view.systems[0]
    rd = sv.system.render_data
    assert rd.life_ramp is not None
    s = rd.life_ramp_settings.numpy()
    assert s[0] == -0.5 and s[2] == 2.0
    assert sv.appearance is not None and sv.appearance.rounded
    table, powers = sv.appearance.power_disc_table("cpu")
    assert abs(powers[0] - 0.3) < 1e-6 and abs(powers[-1] - 1.0) < 1e-6
    assert float(rd.size_from_life.points[0, 0]) == 6.0
    assert rd.use_velocity_rotation
