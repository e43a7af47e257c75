"""The port's headless editor (illuminant_tpu_torch/models/editor.py):
tests/test_editor.py's seven scenarios, each run on the port's controller
and the JAX package's in lockstep, the port's ticks fed the JAX systems'
own spawn draws. After every scenario the saved documents (`dumps()`) are
equal and the states agree under tests/test_torch_particle_system.py's
rule; the port's own checks are the JAX test's."""

import numpy as np

import chip_smoke as cs
from illuminant_tpu.models import editor as jeditor
from illuminant_tpu_torch.models.editor import EditorController
from test_torch_particle_system import jax_draws

DT = 1.0 / 60.0


class Pair:
    """A port controller on the CPU and a JAX controller driven by the
    same calls: an edit goes to both (the port's result is returned),
    `update` feeds the JAX ticks' draws to the port."""

    def __init__(self, ported=None, reference=None, **kw):
        self.t = ported or EditorController(device="cpu", **kw)
        self.j = reference or jeditor.EditorController(**kw)

    def __getattr__(self, name):
        def both(*args, **kwargs):
            getattr(self.j, name)(*args, **kwargs)
            return getattr(self.t, name)(*args, **kwargs)
        return both

    def update(self, dt=DT):
        systems = self.j.view.systems
        before = [s.system._tick_index for s in systems]
        self.j.update(dt)
        draws = {s.model.name: [jax_draws(s.system, k)
                                for k in range(b, s.system._tick_index)]
                 for s, b in zip(systems, before)}
        self.t.update(dt, spawn_uniforms=draws)

    def check(self):
        """Equal documents, equal live masks and states within 1e-4 +
        1e-5 |b| on the live slots."""
        assert self.t.model.dumps() == self.j.model.dumps()
        assert self.t.live_count == self.j.live_count
        dt, dj = self.t.state_digest(), self.j.state_digest()
        assert sorted(dt) == sorted(dj)
        for k in dj:
            i = k.split(":")[0]
            live = dj[f"{i}:position"][:, 3] > 0
            np.testing.assert_array_equal(dt[f"{i}:position"][:, 3] > 0,
                                          live)
            a, b = dt[k][live], dj[k][live]
            assert np.all(np.abs(a - b) <= 1e-4 + 1e-5 * np.abs(b)), k


def _build_session():
    ed = Pair(capacity=1 << 10)
    ed.add_system("sparks")
    ed.add_transform(0, "Spawner", {
        "MinRate": 600.0,
        "MaxRate": 600.0,
        "Life": {"Constant": 2.0, "RandomScale": 0.5},
        "Position": {"Constant": [64.0, 64.0, 0.0],
                     "RandomScale": [8.0, 8.0, 0.0], "Type": "Spherical"},
        "Velocity": {"RandomScale": [30.0, 30.0, 0.0],
                     "Type": "Spherical"},
        "Color": {"Constant": [1.0, 0.8, 0.2, 1.0]},
    })
    ed.add_transform(0, "Gravity", {
        "Attractors": [{"Position": [64.0, 120.0, 0.0], "Radius": 200.0,
                        "Strength": 50.0, "FalloffType": "Linear"}],
        "MaximumAcceleration": 500.0,
    })
    return ed


STRONGER = [{"Position": [64.0, 120.0, 0.0], "Radius": 200.0,
             "Strength": 150.0, "FalloffType": "Linear"}]


def _run_scripted_session():
    ed = _build_session()
    for _ in range(10):
        ed.update()
    ed.set_transform_property(0, 1, "Attractors", STRONGER)
    for _ in range(10):
        ed.update()
    return ed


def test_scripted_session_mutate_step_save_reload_replay(tmp_path):
    ed = _build_session()
    assert len(ed.t.model.systems[0].transforms) == 2
    assert ed.t.selection.system == 0
    for _ in range(10):
        ed.update()
    assert ed.t.live_count > 0
    ed.check()
    digest_a = ed.t.state_digest()
    live_before = ed.t.live_count
    ed.set_transform_property(0, 1, "Attractors", STRONGER)
    assert ed.t.live_count == live_before  # no restart
    np.testing.assert_array_equal(digest_a["0:position"],
                                  ed.t.state_digest()["0:position"])
    for _ in range(10):
        ed.update()
    ed.check()
    digest_b = ed.t.state_digest()
    assert ed.t.live_count > live_before
    # The edit changed the trajectory against an unedited session.
    ctl = _build_session()
    for _ in range(20):
        ctl.update()
    assert not np.array_equal(ctl.t.state_digest()["0:velocity"],
                              digest_b["0:velocity"])
    # The same edit script replays bit for bit.
    digest_r = _run_scripted_session().t.state_digest()
    for k in digest_b:
        np.testing.assert_array_equal(digest_b[k], digest_r[k])
    # Save -> reload: the port's file loads in both packages.
    path = str(tmp_path / "scene.json")
    ed.t.save(path)
    ed2 = Pair(EditorController.load(path, capacity=1 << 10, device="cpu"),
               jeditor.EditorController.load(path, capacity=1 << 10))
    for _ in range(10):
        ed2.update()
    ed2.check()
    a0 = ed2.t.model.systems[0].transforms[1].properties["Attractors"][0]
    assert float(a0["Strength"]) == 150.0


def test_pause_and_single_step():
    ed = _build_session()
    ed.update()
    live_1 = ed.t.live_count
    assert live_1 > 0
    ed.toggle_pause()
    ed.update()
    ed.update()
    assert ed.t.live_count == live_1
    assert ed.t.time.seconds == DT
    ed.queue_step()
    ed.update()
    assert ed.t.time.seconds == 2 * DT
    live_2 = ed.t.live_count
    assert live_2 > live_1
    ed.update()
    assert ed.t.live_count == live_2
    ed.check()


def test_add_remove_and_selection():
    ed = _build_session()
    ed.add_system("smoke")
    assert ed.t.selection.system == 1
    assert ed.t.selected_system.name == "smoke"
    ed.add_transform(1, "Spawner", {"MinRate": 10.0, "MaxRate": 10.0,
                                    "Life": {"Constant": 1.0}})
    assert ed.t.selected_transform.type == "Spawner"
    for _ in range(3):
        ed.update()
    ed.check()
    ed.remove_transform(1, 0)
    assert len(ed.t.model.systems[1].transforms) == 0
    ed.remove_system(1)
    assert len(ed.t.model.systems) == 1 and ed.t.selection.system == 0
    dup = ed.duplicate_system(0)
    assert "copy" in dup.name
    assert len(ed.t.model.systems) == 2
    assert len(ed.t.model.systems[1].transforms) == 2
    for _ in range(3):
        ed.update()
    ed.check()


def test_named_variable_editing_feeds_transforms():
    ed = Pair(capacity=1 << 10)
    ed.add_system("s")
    ed.set_named_variable("spawnRate", 120.0)
    ed.add_transform(0, "Spawner", {
        "MinRate": {"Name": "spawnRate"},
        "MaxRate": {"Name": "spawnRate"},
        "Life": {"Constant": 5.0},
        "Position": {"Constant": [0.0, 0.0, 0.0]},
    })
    for _ in range(60):
        ed.update()
    assert abs(ed.t.live_count - 120) <= 12
    ed.set_named_variable("spawnRate", 240.0)
    for _ in range(60):
        ed.update()
    assert abs(ed.t.live_count - 360) <= 36, ed.t.live_count
    ed.check()


def test_duplicate_and_retype_and_reorder_transforms():
    ed = _build_session()
    tm = ed.duplicate_transform(0, 1)
    sm = ed.t.model.systems[0]
    assert len(sm.transforms) == 3 and tm.type == "Gravity"
    assert ed.t.selection.transform == sm.transforms.index(tm)
    idx = sm.transforms.index(tm)
    ed.change_transform_type(0, idx, "FMA")
    assert sm.transforms[idx].type == "FMA"
    for _ in range(3):
        ed.update()
    assert ed.t.live_count > 0
    spawner_idx = next(i for i, t in enumerate(sm.transforms)
                       if t.type == "Spawner")
    assert ed.move_transform_to_back(0, spawner_idx) == \
        len(sm.transforms) - 1
    assert sm.transforms[-1].type == "Spawner"
    for _ in range(3):
        ed.update()
    ed.check()


def test_rename_and_remove_variable():
    ed = _build_session()
    ed.set_named_variable("strength", 50.0)
    assert not ed.rename_variable("strength", "strength")
    assert not ed.rename_variable("missing", "x")
    assert not ed.rename_variable("strength", "  ")
    ed.set_named_variable("other", 1.0)
    assert not ed.rename_variable("strength", "other")
    assert ed.rename_variable("strength", "power")
    assert "power" in ed.t.model.named_variables
    assert "strength" not in ed.t.model.named_variables
    ed.remove_variable("power")
    assert "power" not in ed.t.model.named_variables
    ed.check()


def test_queue_reset_restarts_simulation():
    ed = _build_session()
    for _ in range(8):
        ed.update()
    before = ed.t.state_digest()
    ed.queue_reset()
    assert ed.t.time.seconds == 0.0
    for _ in range(8):
        ed.update()
    ed.check()
    after = ed.t.state_digest()
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])


def test_session_on_the_model_cell_runs_on_the_cpu():
    """`chip_smoke.editor_session`, the script `reference_models` runs on
    the card, gives the same document and state on two CPU runs."""
    a, draws = cs.editor_session("cpu")
    b, _ = cs.editor_session("cpu", draws)
    assert a.model.dumps() == b.model.dumps() and a.live_count > 0
    for k, v in a.state_digest().items():
        np.testing.assert_array_equal(v, b.state_digest()[k])
