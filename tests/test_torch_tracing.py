"""The port's stage spans (gssr_tpu_torch/utils/tracing.py): without a
profiler a span is the shared no-op; under torch.profiler a train step of
each method emits its documented stage spans, the render's nested in the
scene's, one sync.binning per render; and the profiler leaves the step's
state bit for bit as it is."""
import dataclasses
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gssr_tpu_torch.utils import tracing

sys.path.insert(0, os.path.dirname(__file__))

# the stage spans of one step, by the train step's prefix
SCENE = {"3dgs": "vanilla", "2dgs": "vanilla", "pgsr": "pgsr",
         "octree-2dgs": "scaffold", "octree-pgsr": "scaffold"}
STAGES = ("render_and_loss", "loss", "backward", "adam", "stats")
RENDER_FWD = ("render.preprocess", "render.binning", "render.blend")
RENDER_BWD = ("render.blend_backward", "render.gather_backward")
TRAINER = ("trainer.next_train", "trainer.log", "trainer.densify")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("scene_tracing")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32, gt_mode="noise")
    return str(d)


def trainer_for(method, scene_dir, out_dir):
    from gssr_tpu_torch.configs.methods import get_method_config
    from gssr_tpu_torch.engine.trainer import Trainer
    config = get_method_config(method)
    config.source_path, config.output_path = scene_dir, out_dir
    config.machine.device = "cpu"
    config.writer = "none"
    t = config.trainer
    t.test_iterations, t.save_iterations, t.log_interval = [], [], 1
    trainer = Trainer(config)
    trainer.setup()
    return trainer


def train_one(trainer, step):
    trainer.start_step = step - 1
    trainer.config.trainer.iterations = step
    trainer.train()


def leaves(x):
    """The tensors of a state (dataclasses and dicts), in a fixed order."""
    if torch.is_tensor(x):
        return [x]
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    return []


def test_a_span_without_a_profiler_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("render.blend") is tracing.OFF
    with tracing.span("render.blend") as s:
        assert s is None
    x = torch.ones(3, requires_grad=True)
    y = torch.prod(x * 2.0, 0)
    assert tracing.span_backward("sync.scaling_loss", y) is y


def test_a_span_under_the_profiler_is_a_range():
    x = torch.rand(4, 3, dtype=torch.float64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("render.blend"):
            y = tracing.span_backward("sync.scaling_loss",
                                      torch.prod(x, -1)).sum()
        g, = torch.autograd.grad(y, x)
    names = [e.name for e in prof.events()]
    assert names.count("render.blend") == 1
    assert names.count("sync.scaling_loss") == 1
    g0, = torch.autograd.grad(torch.prod(x, -1).sum(), x)
    assert torch.equal(g, g0)


@pytest.mark.parametrize("method", list(SCENE))
def test_a_step_emits_its_stage_spans(method, scene_dir, tmp_path):
    trainer = trainer_for(method, scene_dir, str(tmp_path))
    train_one(trainer, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_one(trainer, 2)
    events = [e for e in prof.events()
              if e.name.split(".")[0] in (SCENE[method], "render", "trainer",
                                          "sync")]
    names = [e.name for e in events]
    prefix = SCENE[method]
    want = [f"{prefix}.{s}" for s in STAGES] + list(RENDER_FWD) \
        + list(RENDER_BWD) + list(TRAINER)
    if prefix == "scaffold":
        want += ["scaffold.prefilter", "scaffold.decode", "sync.decode"]
    else:
        want += ["render.color", "sync.grad_scale"]
    assert set(want) <= set(names), sorted(set(want) - set(names))
    # every span the step emits is one the module documents
    for n in set(names):
        assert "." + n.split(".", 1)[1] in tracing.__doc__, n
    # one render a step: one sync.binning (binning's only sync), one
    # camera's nine uploads
    assert names.count("sync.binning") == names.count("render.binning") == 1
    assert names.count("sync.binning_scatter") == 0
    assert names.count("sync.camera") == 9

    def inside(name, outer):
        spans = [e.time_range for e in events if e.name == outer]
        return all(any(o.start <= e.time_range.start
                       and e.time_range.end <= o.end for o in spans)
                   for e in events if e.name == name)
    for n in RENDER_FWD:
        assert inside(n, f"{prefix}.render_and_loss"), n
    for n in RENDER_BWD:
        assert inside(n, f"{prefix}.backward"), n
    assert inside("sync.binning", "render.binning")
    assert inside(f"{prefix}.loss", f"{prefix}.render_and_loss")


@pytest.mark.parametrize("method", list(SCENE))
def test_the_profiler_leaves_the_step_bit_for_bit(method, scene_dir,
                                                   tmp_path):
    trainer = trainer_for(method, scene_dir, str(tmp_path))
    train_one(trainer, 1)
    scene = trainer.scene
    state = scene.state
    cam = scene.dataloader.train_cameras[1]
    extra = getattr(scene, "extra_stats", None)
    plain, m_plain = scene.train_step(state, cam, 2)
    if extra is not None:
        scene.extra_stats = extra
    with profile(activities=[ProfilerActivity.CPU]):
        traced, m_traced = scene.train_step(state, cam, 2)
    a, b = leaves(plain), leaves(traced)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for k in m_plain:
        assert torch.equal(torch.as_tensor(m_plain[k]),
                           torch.as_tensor(m_traced[k])), k


@pytest.mark.parametrize("two_camera", [False, True],
                         ids=["single-camera", "two-camera"])
def test_a_pgsr_step_marks_its_neighbour_and_terms(two_camera, scene_dir,
                                                   tmp_path):
    trainer = trainer_for("pgsr", scene_dir, str(tmp_path))
    if two_camera:
        trainer.scene.config.multi_view_from = 1
    train_one(trainer, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_one(trainer, 3)
    events = [e for e in prof.events()
              if e.name.split(".")[0] in ("pgsr", "sync")]
    names = [e.name for e in events]
    # one neighbour render and one set of terms a two-camera step; the
    # terms' three bilinear samples (two clamps of two uploads each) and
    # their NCC (one clamp) upload 14 bounds
    n = 1 if two_camera else 0
    assert names.count("pgsr.near_render") == n
    assert names.count("pgsr.multiview") == n
    assert names.count("sync.sample_clip") == 14 * n

    def inside(name, outer):
        spans = [e.time_range for e in events if e.name == outer]
        return all(any(o.start <= e.time_range.start
                       and e.time_range.end <= o.end for o in spans)
                   for e in events if e.name == name)
    assert inside("sync.sample_clip", "pgsr.multiview")
    assert inside("pgsr.multiview", "pgsr.loss")
    assert inside("pgsr.near_render", "pgsr.render_and_loss")


@pytest.mark.parametrize("two_camera", [False, True],
                         ids=["single-camera", "two-camera"])
def test_an_octree_pgsr_step_marks_its_neighbour_pipeline_and_terms(
        two_camera, scene_dir, tmp_path):
    trainer = trainer_for("octree-pgsr", scene_dir, str(tmp_path))
    if two_camera:
        trainer.scene.config.multi_view_from = 1
    train_one(trainer, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_one(trainer, 3)
    events = [e for e in prof.events()
              if e.name.split(".")[0] in ("scaffold", "sync")]
    names = [e.name for e in events]

    def within(name, outer):
        """The spans called `name` that lie inside one called `outer`."""
        spans = [e.time_range for e in events if e.name == outer]
        return [e for e in events if e.name == name
                and any(o.start <= e.time_range.start
                        and e.time_range.end <= o.end for o in spans)]
    # a two-camera step runs the neighbour's prefilter, level gate, decode
    # and render in one scaffold.near_render, holding one prefilter and one
    # decode of its own, and its terms in one scaffold.multiview inside
    # scaffold.loss, with their 14 bound uploads
    n = 1 if two_camera else 0
    assert names.count("scaffold.near_render") == n
    assert names.count("scaffold.multiview") == n
    assert names.count("scaffold.prefilter") == 1 + n
    assert names.count("scaffold.decode") == 1 + n
    assert len(within("scaffold.prefilter", "scaffold.near_render")) == n
    assert len(within("scaffold.decode", "scaffold.near_render")) == n
    assert names.count("sync.sample_clip") == 14 * n
    assert len(within("sync.sample_clip", "scaffold.multiview")) == 14 * n
    assert len(within("scaffold.near_render", "scaffold.loss")) == n
    assert len(within("scaffold.multiview", "scaffold.loss")) == n
