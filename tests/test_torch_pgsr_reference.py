"""The benchmark's plain PGSR reference (portbench/reference/pgsr.py) against
the port's PGSRScene.train_step on the CPU at 64 x 48 with 3,000 points:
each loss term and each leaf's gradient of a single-camera step, a
two-camera step with another camera and a self-paired one agree within the
3dgs cells' limits; the pgsr.two-camera cell's check fails when the program's
multi-view terms are dropped; the planar work counts on hand-made tiles;
and the reference loads with no JAX and nothing of the program."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import calibrate, harness  # noqa: E402
from portbench.scene import Scene, write_scene  # noqa: E402

SEED = 2 ** 31 + 977
CELL = "pgsr.two-camera"
# the NCC draws 1,024 of the 3,072 pixels, so the seeded sample is used
TINY = dict(points=3000, width=64, height=48, cameras=8)
SETTINGS = {"gaussians.capacity": 3072, "num_sample": 1024}
# one step from one state: its terms and gradients agree to rounding (on
# the card the first step's terms within 1.6e-5 of the loss), so they are
# held to the 3dgs cells' loss and gradient limits; the pgsr cell's own
# limits are wider for its steps 2-3, where Adam's first update breaks the
# isotropic start's smallest-axis ties by rounding (PERF.md section 2)
TERM_TOL = harness.load("workloads", "3dgs.full")["limits"]["loss_gap"]
GRAD_TOL = harness.load("workloads", "3dgs.full")["limits"]["grad_gap"]


def tiny_cell() -> harness.Cell:
    c = harness.Cell.named(CELL, **TINY)
    c.workload["settings"] = {**c.workload["settings"], **SETTINGS}
    return c


@pytest.fixture(scope="module")
def ref():
    r = harness.reference(tiny_cell().config)
    r.configure()
    return r


@pytest.fixture(scope="module")
def setup(tmp_path_factory, ref):
    """The program's scene and a state with random rotations and unequal
    scales (the start's gaussians are isotropic, so the smallest axis
    would be a tie), and the reference on the same scene."""
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    c = tiny_cell()
    tmp = str(tmp_path_factory.mktemp("pgsr_reference"))
    d = os.path.join(tmp, "scene")
    scene = Scene(d, write_scene(d, SEED, c.points, c.cameras, c.width,
                                 c.height, "cpu"))
    trainer = harness.build_trainer(harness.program_argv(
        c, d, os.path.join(tmp, "out"), SEED, "cpu"), SEED)
    state = trainer.scene.state
    gen = torch.Generator().manual_seed(5)
    p = state.params
    p["rotation"] = torch.randn(p["rotation"].shape, generator=gen)
    p["scaling"] = p["scaling"] + 1.4 * (
        torch.rand(p["scaling"].shape, generator=gen) - 0.5)
    before = {k: v.detach().clone() for k, v in p.items()}
    steps = ref.Steps(c, scene, SEED, "cpu", torch.float32)
    return c, trainer.scene, state, before, steps


@pytest.mark.parametrize("case", ["single", "other", "self"])
def test_a_step_agrees_with_the_reference(case, setup):
    c, prog, state, before, steps = setup
    train = prog.dataloader.train_cameras
    # a camera that lists itself among its neighbours (the training
    # list's positions 3-7 in a scene without tracks)
    camera = next(cam for cam in train
                  if cam.image_name in steps.near[cam.image_name])
    name = camera.image_name
    step = c.start_step + 1
    k = 0
    if case == "single":
        step = c.settings["multi_view_from"]
    else:
        k = next(k for k in range(1000)
                 if (steps.neighbour(name, k) == name) == (case == "self"))
    prog._near_draws = k
    new, metrics = prog.train_step(state, camera, step)
    terms, grads, near = steps.step(before, name, step, k)
    assert (near is None) == (case == "single")
    assert (near == name) == (case == "self")
    want = {"L1_loss", "ssim_loss"} | (
        set() if case == "single" else {"normal_loss", "geo_loss",
                                        "ncc_loss"})
    assert set(terms) == want
    # every term within TERM_TOL of the step's loss
    total = float(sum(terms.values()))
    for t in want:
        gap = abs(float(metrics[t]) - float(terms[t])) / total
        assert gap <= TERM_TOL, (t, gap)
    # each leaf's gradient (Adam's first moment from zero over 0.1): the
    # whole vector within GRAD_TOL of the larger of its norm and the
    # median leaf's
    norms = {k_: float(torch.linalg.norm(g)) for k_, g in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    for k_, g in grads.items():
        diff = float(torch.linalg.norm(new.adam_m[k_] / 0.1 - g))
        assert diff / max(norms[k_], med) <= GRAD_TOL, k_


def test_dropping_the_multi_view_terms_fails_the_check(tmp_path, monkeypatch,
                                                       ref):
    from gssr_tpu_torch.scene.pgsr import PGSRScene
    keep = PGSRScene.multi_view_terms

    def dropped(self, *args):
        return {k: v * 0.0 for k, v in keep(self, *args).items()}
    monkeypatch.setattr(PGSRScene, "multi_view_terms", dropped)
    c = tiny_cell()
    scene, steps = calibrate.program_steps(c, SEED, "cpu", str(tmp_path))
    nums = ref.readings(c, scene, steps, "cpu", SEED)
    failed = [k for k, v in nums.items() if not v <= c.limits[k]]
    assert failed, nums


def one_tile(ops):
    """A 16 x 16 render of planar gaussians whose conic is 0, so that every
    pixel sees alpha = op: attrs [N, 13] and the tile's list in order."""
    n = len(ops)
    attrs = torch.zeros(n, 13)
    attrs[:, 0:2] = 8.0
    attrs[:, 5] = torch.tensor(ops)
    attrs[:, 6:9] = 0.5
    attrs[:, 9:12] = torch.tensor([0.0, 0.0, -1.0])
    attrs[:, 12] = 2.0
    return attrs, torch.arange(n), torch.tensor([0, n])


def test_planar_pair_counts_on_a_hand_made_tile(ref):
    from portbench.reference import gs3d
    attrs, gid, start = one_tile([0.5, 0.5])
    # T: 1 -> 0.5 -> 0.25: both contribute at every pixel
    assert gs3d.screen_pair_counts(attrs, gid, start, 1) == (512, 2)
    ch, T = ref.blend_group(attrs, gid, start, torch.tensor([0]), 2, 1)
    # weights 0.5 and 0.25: colour 0.375, normal (0, 0, -0.75), distance 1.5
    assert torch.allclose(ch[0], torch.tensor(
        [0.375, 0.375, 0.375, 0.0, 0.0, -0.75, 1.5]).expand(256, 7))
    assert torch.allclose(T, torch.full((1, 256), 0.25))
    # op 0.95: the fourth would take T below 1e-4 and holds no pair
    assert gs3d.screen_pair_counts(*one_tile([0.95] * 4), 1) == (768, 3)

    one = ref.planar_step([(512, 2, 2)], 100, 4, 16, 16)
    assert one["blend_pgsr_fwd"] == {"ops": 38 * 512,
                                     "bytes": 2 * 52 + 256 * 32}
    assert one["blend_pgsr_bwd"] == {"ops": 91 * 512,
                                     "bytes": 2 * 2 * 52 + 2 * 256 * 32}
    assert one["step"]["ops"] == (129 * 512 + 750 * 2
                                  + (5 * 2 * 2 * 11 * 3 + 40) * 768
                                  + 12 * 59 * 4)
    two = ref.planar_step([(512, 2, 2), (256, 1, 1)], 100, 4, 16, 16)
    assert two["blend_pgsr_fwd"] == {"ops": 38 * 768,
                                     "bytes": 3 * 52 + 2 * 256 * 32}
    assert two["step"]["ops"] == (129 * 768 + 750 * 3
                                  + (5 * 2 * 2 * 11 * 3 + 40) * 768
                                  + 12 * 59 * 4 + (210 + 390) * 256
                                  + ref.NCC_SAMPLE_OPS * 100)


def test_the_reference_loads_without_jax_or_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "harness.load_module(harness.HERE / 'reference' / 'pgsr.py')\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(','.join(sorted(top & {'jax', 'jaxlib', 'flax', 'gssr_tpu',"
        " 'gssr_tpu_torch'})))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "", out.stdout
