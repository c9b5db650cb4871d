"""The benchmark's plain Octree-PGSR reference (portbench/reference/
octree_pgsr.py) against the port's OctreePGSRScene.train_step on the CPU at
64 x 48 with 3,000 points (5,397 anchors on two levels in 6,144 slots, one
in four of them active): each
loss term and each leaf's gradient of a single-camera step, a two-camera
step with another camera and a self-paired one agree within the 3dgs
cells' limits, and a program that renders the neighbour from the reference
camera's decode fails the cell's own limits on the first step's readings;
the work counts on a hand-made case; and the reference loads with no JAX
and nothing of the program."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.scene import Scene, write_scene  # noqa: E402

SEED = 2 ** 31 + 977
CELL = "octree-pgsr.two-camera"
TINY = dict(points=3000, width=64, height=48, cameras=8)
# the NCC draws 1,024 of the 3,072 pixels, so the seeded sample is used
SETTINGS = {"gaussians.capacity": 6144, "num_sample": 1024}
# one step from one state agrees to rounding, so its terms and gradients
# are held to the 3dgs cells' loss and gradient limits
TERM_TOL = harness.load("workloads", "3dgs.full")["limits"]["loss_gap"]
GRAD_TOL = harness.load("workloads", "3dgs.full")["limits"]["grad_gap"]
TERMS = {"L1_loss", "ssim_loss", "scaling_loss"}
MULTI_VIEW = {"normal_loss", "geo_loss", "ncc_loss"}
# torch threads of this file's steps: the suite runs six workers on a few
# cores, where more threads per worker only wait for each other
THREADS = 1


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
    """The program's scene and a state whose features and offsets are drawn
    from a seed (the start's are zero, which makes every anchor's neural
    gaussians depend on the view alone and sit at the anchor), with one
    anchor in four left active (1,350 of 5,397: the plain blends walk every
    neural gaussian a tile lists, so this keeps the file's time down), and
    the reference on the same scene."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, THREADS))
    c = tiny_cell()
    tmp = str(tmp_path_factory.mktemp("octree_pgsr_reference"))
    d = os.path.join(tmp, "scene")
    scene = Scene(d, write_scene(d, SEED, c.points, c.cameras, c.width,
                                 c.height, "cpu"))
    trainer = harness.build_trainer(harness.program_argv(
        c, d, os.path.join(tmp, "out"), SEED, "cpu"), SEED)
    state = trainer.scene.state
    gen = torch.Generator().manual_seed(5)
    a = state.anchors
    a["feat"] = 0.5 * torch.randn(a["feat"].shape, generator=gen)
    a["offset"] = 0.3 * torch.randn(a["offset"].shape, generator=gen)
    state.active[1::4] = False
    state.active[2::4] = False
    state.active[3::4] = False
    before = ref.program_params(state)
    steps = ref.Steps(c, scene, SEED, "cpu", torch.float32)
    yield c, trainer.scene, state, before, steps, {}
    torch.set_num_threads(threads)


def one_step(case, setup, ref):
    """The program's step (new state, metrics) and the reference's (terms,
    gradients, neighbour) from the same state on a camera that lists
    itself among its neighbours (the training list's positions 3-7 in a
    scene without tracks): a single-camera step, or a two-camera one whose
    neighbour is another camera or the camera itself. The reference's are
    kept in the setup for the later tests."""
    c, prog, state, before, steps, kept = setup
    camera = next(cam for cam in prog.dataloader.train_cameras
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
    program = prog.train_step(state, camera, step)
    if case not in kept:
        kept[case] = steps.step(
            ref.octree2dgs._state(before, "cpu", torch.float32), name, step,
            k)
    return program, kept[case]


def gradients(new):
    """Each leaf's gradient of the program's step: Adam's first moment from
    zero over 0.1."""
    return {k: m / 0.1 for k, m in {**new.adam_anchor.m,
                                    **new.adam_mlp.m}.items()}


def first_checks(ref, new, metrics, terms, grads) -> dict:
    """The reference's first-step readings (loss_gap, grad_gap) of
    the program's step against its own, beside the cell's limits."""
    nums = ref.first_step(
        {"losses": [float(metrics["loss"])], "grads": gradients(new)},
        {"losses": [float(sum(terms.values()))], "grads": grads})
    limits = harness.load("workloads", CELL)["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}


@pytest.mark.parametrize("case", ["single", "other", "self"])
def test_a_step_agrees_with_the_reference(case, setup, ref):
    (new, metrics), (terms, grads, near) = one_step(case, setup, ref)
    name = next(c.image_name for c in setup[1].dataloader.train_cameras
                if c.image_name in setup[4].near[c.image_name])
    assert (near is None) == (case == "single")
    assert (near == name) == (case == "self")
    want = TERMS | (set() if case == "single" else MULTI_VIEW)
    assert set(terms) == want
    # every term within TERM_TOL of the step's loss
    total = float(sum(terms.values()))
    for t in want:
        gap = abs(float(metrics[t]) - float(terms[t])) / total
        assert gap <= TERM_TOL, (t, gap)
    # each leaf's gradient: the whole vector within GRAD_TOL of the larger
    # of its norm and the median leaf's
    got = gradients(new)
    norms = {k_: float(torch.linalg.norm(g)) for k_, g in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    assert med > 0
    for k_, g in grads.items():
        diff = float(torch.linalg.norm(got[k_] - g))
        assert diff / max(norms[k_], med) <= GRAD_TOL, k_
    # and the first-step readings within the cell's own limits
    checks = first_checks(ref, new, metrics, terms, grads)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_the_neighbour_from_the_reference_decode_fails_the_check(
        setup, monkeypatch, ref):
    """A program that renders the neighbour from the reference camera's
    decoded gaussians (its visible anchors, and its view's opacities,
    colours and shapes) in place of the neighbour's own decode: on the
    two-camera step with another camera, the first step's readings
    (reference/octree_pgsr.py::first_step) fail the cell's own limits."""
    from gssr_tpu_torch.scene.scaffold_pgsr import ScaffoldPGSRScene
    keep = ScaffoldPGSRScene.step_terms
    calls = []

    def reused(self, state, anchors, mlp, ng, *args):
        self.gaussians.decode = lambda *a, **k: calls.append(1) or ng
        try:
            return keep(self, state, anchors, mlp, ng, *args)
        finally:
            del self.gaussians.decode
    monkeypatch.setattr(ScaffoldPGSRScene, "step_terms", reused)
    (new, metrics), (terms, grads, near) = one_step("other", setup, ref)
    assert len(calls) == 1
    checks = first_checks(ref, new, metrics, terms, grads)
    assert [k for k, c in checks.items() if c["value"] > c["limit"]], checks


def test_the_work_counts_on_a_hand_made_case(ref):
    st = {"gaussians.feat_dim": 4, "gaussians.n_offsets": 2,
          "gaussians.use_feat_bank": False}
    mlp = {f"{h}_w1": torch.zeros(7, 4) for h in ("op", "cov", "col")}
    mlp.update(op_w2=torch.zeros(4, 2), cov_w2=torch.zeros(4, 14),
               col_w2=torch.zeros(4, 6), fb_w1=torch.zeros(4, 4),
               fb_w2=torch.zeros(4, 3))
    # three heads of 7 x 4 and their 4 x 2, 4 x 14 and 4 x 6 outputs
    assert ref.head_macs(mlp, st) == 3 * 28 + 8 + 56 + 24
    assert ref.head_macs(mlp, {**st, "gaussians.use_feat_bank": True}) \
        == 3 * 28 + 8 + 56 + 24 + 16 + 12
    # one render: 512 contributing pairs, 2 instances, 3 drawn neural
    # gaussians from 2 anchors; 4 slots of 3 + 6 + 4 + 6 + 4 + 1 = 24
    # elements and an MLP of 100 elements; a 16 x 16 image
    one = ref.anchor_planar_step([(512, 2, 3, 2)], 100, 4, 100, 172, 16,
                                 16, st)
    assert one["blend_pgsr_fwd"] == {"ops": 38 * 512,
                                     "bytes": 2 * 52 + 256 * 32}
    assert one["blend_pgsr_bwd"] == {"ops": 91 * 512,
                                     "bytes": 2 * 2 * 52 + 2 * 256 * 32}
    assert one["step"]["ops"] == (129 * 512 + (5 * 2 * 2 * 11 * 3 + 40) * 768
                                  + 6 * 172 * 2 + 900 * 3
                                  + 12 * (24 * 4 + 100))
    two = ref.anchor_planar_step([(512, 2, 3, 2), (256, 1, 1, 1)], 100, 4,
                                 100, 172, 16, 16, st)
    assert two["blend_pgsr_fwd"] == {"ops": 38 * 768,
                                     "bytes": 3 * 52 + 2 * 256 * 32}
    assert two["step"]["ops"] == (129 * 768 + (5 * 2 * 2 * 11 * 3 + 40) * 768
                                  + 6 * 172 * 3 + 900 * 4
                                  + 12 * (24 * 4 + 100) + (210 + 390) * 256
                                  + ref.pgsr.NCC_SAMPLE_OPS * 100)


def test_the_reference_loads_without_jax_or_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "harness.load_module(harness.HERE / 'reference' / 'octree_pgsr.py')\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(','.join(sorted(top & {'jax', 'jaxlib', 'flax', 'gssr_tpu',"
        " 'gssr_tpu_torch'})))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "", out.stdout
