"""What each rank of tests/test_torch_parallel.py and
tests/test_torch_split_parallel.py runs, in a process that
parallel/launch.py::spawn started (gloo on the CPU). It imports torch and
gssr_tpu_torch only; every result goes back to the test as numpy, and
what it needs of gssr_tpu (an initial state, the octree's host
attributes, densify draws) comes in as numpy."""
import dataclasses
import math
import os

import numpy as np
import torch

from gssr_tpu_torch.parallel import comm

W = H = 64
N_GAUSS = 384
# the (method, mode) steps held against gssr_tpu's shard_map steps, and
# the methods whose state after a densify is held too
REF_CASES = (("3dgs", "dp"), ("3dgs", "band"), ("3dgs", "gshard"),
             ("octree-2dgs", "dp"), ("octree-2dgs", "band"),
             ("octree-2dgs", "gshard"), ("pgsr", "dp"), ("pgsr", "band"))
REF_DENSIFY = ("3dgs", "octree-2dgs")
# each method's scene options in those cases: pgsr on its two-camera step
REF_SCENE = {"pgsr": {"multi_view_from": 0}}


def render_inputs(seed=0):
    """A camera and N_GAUSS random gaussians with SH degree 3, as numpy
    (the test feeds the same to gssr_tpu)."""
    rng = np.random.default_rng(seed)
    return dict(means=rng.uniform(-2, 2, (N_GAUSS, 3)),
                scales=np.exp(rng.uniform(-3.5, -1.5, (N_GAUSS, 3))),
                rots=rng.normal(size=(N_GAUSS, 4)),
                opac=rng.uniform(0.1, 0.9, N_GAUSS),
                sh=rng.normal(0, 0.3, (N_GAUSS, 16, 3)))


def camera():
    from gssr_tpu_torch.cameras import Camera
    return Camera(uid=0, colmap_id=0, image_name="band", R=np.eye(3),
                  T=np.array([0.0, 0.0, 3.0]), fovx=math.radians(70),
                  fovy=math.radians(55), width=W, height=H)


def render_grads(kind, par=None, shard=False):
    """(image, the gradients of a loss over every map of the payload
    `kind` ("3dgs", "2dgs", "pgsr") with respect to means, scales, rots,
    opac, sh) of one render with the rasterizer arguments `par`; with
    `shard`, of this rank's rows of the inputs."""
    from gssr_tpu_torch.ops.rasterize import rasterize
    from gssr_tpu_torch.ops.rasterize2d import rasterize_2d
    from gssr_tpu_torch.ops.rasterize_pgsr import rasterize_pgsr
    x = {k: torch.tensor(np.asarray(v, np.float32))
         for k, v in render_inputs().items()}
    if shard:
        x = {k: comm.shard_rows(v) for k, v in x.items()}
    x = {k: v.requires_grad_(True) for k, v in x.items()}
    fn = {"3dgs": rasterize, "2dgs": rasterize_2d,
          "pgsr": rasterize_pgsr}[kind]
    scales = x["scales"][:, :2] if kind == "2dgs" else x["scales"]
    out = fn(x["means"], scales, x["rots"], x["opac"], camera().arrays("cpu"),
             W, H, torch.tensor([0.1, 0.2, 0.3]), sh_coeffs=x["sh"],
             sh_degree=3, **(par or {}))
    loss = (out.image * torch.tensor([1.0, -0.5, 0.25])).sum() \
        + (out.final_T ** 2).sum()
    if kind == "2dgs":
        loss = loss + out.surf_depth.sum() + out.normal.sum() \
            + out.dist.sum()
    if kind == "pgsr":
        loss = loss + out.plane_depth.sum() + out.normal.sum() \
            + out.distance.sum()
    grads = torch.autograd.grad(loss, list(x.values()))
    return (out.image.detach().numpy(), [g.numpy() for g in grads],
            int(out.num_rendered))


def configure(config, scene_dir, out_dir, **scene):
    """The method preset cut to the test scene (the anchor ones narrow, as
    tests/test_torch_train_octree.py cuts them); `scene` sets fields of
    the scene config."""
    config.source_path = scene_dir
    config.output_path = out_dir
    g = config.scene.gaussians
    if hasattr(g, "n_offsets"):
        extra = {"levels": 3} if hasattr(g, "levels") else {
            "appearance_dim": 4, "voxel_size": 0.1}
        g = dataclasses.replace(
            g, capacity=512, feat_dim=8, n_offsets=4, start_stat=0,
            densify_from_iter=1, densification_interval=2,
            densify_grad_threshold=2e-5, success_threshold=0.5, **extra)
    else:
        g = dataclasses.replace(
            g, capacity=512, densify_from_iter=1, densification_interval=2,
            densify_grad_threshold=2e-5)
    config.scene.gaussians = g
    for k, v in scene.items():
        setattr(config.scene, k, v)
    return config


def build(method, scene_dir, out_dir, **scene):
    from gssr_tpu_torch.configs.methods import build_scene, get_method_config
    config = configure(get_method_config(method), scene_dir, out_dir,
                       **scene)
    return build_scene(config, "cpu")


def leaves(state):
    """A state's tensors as numpy by their path ("params.xyz",
    "adam_anchor.m.feat", "n_active", ...)."""
    out = {}

    def walk(x, path):
        if torch.is_tensor(x):
            out[path] = x.detach().cpu().numpy()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")
    walk(state, "")
    return {k[1:]: v for k, v in out.items()}


def record_adam(scene):
    """The gradients the step hands to Adam (after the merge), recorded
    per call into the returned list."""
    import gssr_tpu_torch.scene.scaffold as scaffold_mod
    seen = []
    if hasattr(scene.state, "anchors"):
        inner = scaffold_mod.adam_update

        def spy(params, grads, adam, lrs):
            seen.append({k: v.detach().numpy().copy()
                         for k, v in grads.items()})
            return inner(params, grads, adam, lrs)
        scaffold_mod.adam_update = spy
    else:
        inner_step = scene.gaussians.adam_step

        def spy_step(state, grads, lrs):
            seen.append({k: v.detach().numpy().copy()
                         for k, v in grads.items()})
            return inner_step(state, grads, lrs)
        scene.gaussians.adam_step = spy_step
    return seen


def step_record(method, scene_dir, out_dir, mode, camera_index=0,
                **scene_cfg):
    """One train step of `method` on the camera_index-th camera, in mode
    ("none" on this rank alone): (the merged gradients, the metrics, the
    step's state in the whole layout, extra records)."""
    scene = build(method, scene_dir, out_dir, **scene_cfg)
    if mode != "none":
        scene.setup_parallel(mode)
    seen = record_adam(scene)
    observe = []
    if hasattr(scene.gaussians, "update_stats_pgsr"):
        inner = scene.gaussians.update_stats_pgsr

        def spy(stats, extra, radii, m2d, m2d_abs, obs, scale):
            observe.append(obs.numpy().copy())
            return inner(stats, extra, radii, m2d, m2d_abs, obs, scale)
        scene.gaussians.update_stats_pgsr = spy
    cam = scene.dataloader.train_cameras[camera_index]
    cams = [cam] * scene.parallel.world if mode == "dp" else cam
    state = scene.step_state(scene.state)
    n_visible = None
    if hasattr(state, "anchors"):
        visible, _, _ = scene.visible_anchors(
            state, cam.arrays(scene.device), 1)
        n_visible = int((visible & state.active).sum())
    state, metrics = scene.train_step(state, cams, 1)
    full = scene.full_state(state)
    return dict(grads=seen, observe=observe, n_visible=n_visible,
                metrics={k: float(v) for k, v in metrics.items()},
                state=leaves(full))


def ref_cameras(scene, mode, step):
    """A step's cameras in the cases held against gssr_tpu: dp, the
    train cameras [2(step - 1), 2(step - 1) + 1], one per rank; otherwise
    camera step - 1."""
    cams = scene.dataloader.train_cameras
    if mode == "dp":
        return cams[2 * (step - 1):2 * step]
    return cams[step - 1]


def record_picks(scene):
    """The neighbour draws of a planar scene (key_host_choice), recorded
    into the returned list."""
    picks, choose = [], scene.key_host_choice

    def record(ids):
        picks.append(choose(ids))
        return picks[-1]
    scene.key_host_choice = record
    return picks


def ref_case(method, mode, scene_dir, out_dir, given):
    """Steps 1 and 2 of `method` in `mode` from gssr_tpu's initial state
    (`given`: its leaves, the octree's host attributes, the densify
    draws), on ref_cameras, then the densify after step 2 (methods in
    REF_DENSIFY): the whole state after step 1 and after the densify in
    gssr_tpu's leaf order, the step's metrics, PGSR's extra statistics
    and neighbour draws."""
    from gssr_tpu_torch.models.convert import set_octree_host_attrs
    scene = build(method, scene_dir, out_dir, **REF_SCENE.get(method, {}))
    if given.get("host"):
        set_octree_host_attrs(scene.gaussians, **given["host"])
    scene.state = scene.state_from_numpy(given["leaves"])
    scene.setup_parallel(mode)
    picks = record_picks(scene) if hasattr(scene, "key_host_choice") else []
    state = scene.step_state(scene.state)
    state, metrics = scene.train_step(state, ref_cameras(scene, mode, 1), 1)
    out = dict(step=scene.state_to_numpy(scene.full_state(state)),
               metrics={k: float(v) for k, v in metrics.items()},
               picks=picks)
    if hasattr(scene, "extra_stats"):
        out["extra"] = {k: v.numpy() for k, v in scene.extra_stats.items()}
    if method in REF_DENSIFY:
        state, _ = scene.train_step(state, ref_cameras(scene, mode, 2), 2)
        assert scene.densify_due(2)
        draws = {k: torch.from_numpy(v) for k, v in given["draws"].items()}
        state = scene.train_densify(state, 2, **draws)
        out["densified"] = scene.state_to_numpy(scene.full_state(state))
    return out


def scaling_grads(scene_dir, out_dir):
    """The gradient of octree-2dgs's scaling loss (its only term that
    reaches the anchors outside the render) with respect to the anchors'
    scaling on this rank, alone ("none") and in band and gshard mode, on
    camera 0."""
    from gssr_tpu_torch.parallel.comm import Parallel
    scene = build("octree-2dgs", scene_dir, out_dir)
    cam = scene.dataloader.train_cameras[0]
    out = {}
    for mode in ("none", "band", "gshard"):
        if mode == "none":
            scene.parallel = Parallel()
        else:
            scene.setup_parallel(mode)
        state = scene.step_state(scene.state)
        anchors = {k: v.detach().requires_grad_(True)
                   for k, v in state.anchors.items()}
        arrays = cam.arrays(scene.device)
        visible, gate, _ = scene.visible_anchors(state, arrays, 1)
        ng = scene.gaussians.decode(anchors, state.mlp, arrays.campos,
                                    cam.uid, visible, state.active,
                                    level_scale_gate=gate)
        loss = scene.scaling_loss(ng)
        out[mode] = torch.autograd.grad(loss, anchors["scaling"])[0].numpy()
    return out


def checks(scene_dir, scene_dir_48, out_dir, given):
    """Every two-rank check of tests/test_torch_parallel.py, on one group:
    a dict of named results (rank 0 also computes the single-device
    references of the step checks); `given`: per method, what ref_case
    needs of gssr_tpu."""
    from gssr_tpu_torch.parallel.sharded import build_band_render
    torch.set_num_threads(1)
    r, w = comm.rank(), comm.world()
    res = {"rank": r, "world": w}

    x = {k: torch.tensor(np.asarray(v, np.float32))
         for k, v in render_inputs().items()}
    render = build_band_render(W, H, sh_degree=3)
    res["band_render"] = render(x["means"], x["scales"], x["rots"],
                                x["opac"], x["sh"], camera().arrays("cpu"),
                                torch.zeros(3)).numpy()
    for kind in ("3dgs", "2dgs", "pgsr"):
        res[f"band_{kind}"] = render_grads(
            kind, dict(band_rank=r, band_count=w))
    for kind in ("3dgs", "2dgs"):
        res[f"gshard_{kind}"] = render_grads(kind, dict(gauss_shard=True),
                                             shard=True)

    out = f"{out_dir}/rank{r}"
    for method in ("3dgs", "octree-2dgs"):
        res[f"dp_{method}"] = step_record(method, scene_dir, out, "dp")
    res["band_pgsr_step"] = step_record("pgsr", scene_dir, out, "band",
                                        multi_view_from=0)
    for mode in ("band", "gshard"):
        res[f"{mode}_octree-2dgs"] = step_record("octree-2dgs", scene_dir,
                                                 out, mode)
    res["scaling_grads"] = scaling_grads(scene_dir, out)
    for method, mode in REF_CASES:
        res[f"ref {method} {mode}"] = ref_case(method, mode, scene_dir, out,
                                               given[method])
    if r == 0:
        for method in ("3dgs", "octree-2dgs"):
            res[f"single_{method}"] = step_record(method, scene_dir, out,
                                                  "none")
        res["single_pgsr_step"] = step_record("pgsr", scene_dir, out, "none",
                                              multi_view_from=0)

    # the replicated state after two steps and a densify pass
    for mode in ("dp", "band", "gshard"):
        scene = build("3dgs", scene_dir, out, random_background=True)
        scene.setup_parallel(mode)
        state = scene.step_state(scene.state)
        n0 = int(state.n_active)
        for step in (1, 2):
            # dp: one camera per rank from the shared sequence
            cams = [scene.dataloader.next_train()
                    for _ in range(w if mode == "dp" else 1)]
            state, _ = scene.train_step(
                state, cams if mode == "dp" else cams[0], step)
            state = scene.train_densify(state, step)
        res[f"densified_{mode}"] = (n0, leaves(scene.full_state(state)))

    try:
        build("3dgs", scene_dir_48, out).setup_parallel("band")
    except ValueError as e:
        res["band_refused"] = str(e)
    return res


def fail(message):
    """A rank function that fails on rank 1 (spawn must raise)."""
    if comm.rank() == 1:
        raise RuntimeError(message)
    return comm.rank()


def split_sweep(argv):
    """`python -m gssr_tpu_torch.train_split` with `argv` on this rank of
    the group that is up, as under a launcher: the tiles it trained and
    skipped, and per trained tile its final state's leaves (gssr_tpu's
    order) and its losses."""
    from gssr_tpu_torch import train, train_split
    torch.set_num_threads(1)
    tiles = {}

    def tile(config):
        trainer = train.main(config)
        scene = trainer.scene
        tiles[os.path.basename(config.source_path)] = dict(
            leaves=scene.state_to_numpy(scene.state),
            losses=[h[1] for h in trainer.history])
    trained, skipped = train_split.main(argv, train_tile=tile)
    return dict(rank=comm.rank(), trained=trained, skipped=skipped,
                tiles=tiles)
