"""Vanilla 3DGS scene: render + L1/D-SSIM losses + train step, one device
(port of gssr_tpu/scene/vanilla.py).

A train step renders through the CUDA blend kernels, differentiates the
loss with autograd (the blend's backward is the hand-written backward
kernel), applies Adam and accumulates the densification statistics.
Densification and opacity reset run on their schedule after the step.
The reference's K-step scan blocks have no counterpart here: they were a
workaround for XLA dispatch cost that eager PyTorch does not pay.

Multi-device training (setup_parallel), one process per device inside a
torch.distributed group, every collective explicit (parallel/comm.py):

* "dp": a step takes one camera per rank (the list of every rank's, in
  rank order) and rank r trains the r-th; the parameter gradients are
  averaged over the ranks and the statistics' deltas summed.
* "band": every rank renders the same camera, binning and blending its
  tile-row band (ops/band.py); the parameter and screen gradients, each
  rank's band times the number of ranks (parallel/comm.py::gather_bands),
  are averaged over the ranks.
* "gshard": each rank holds rows [r * C/D, (r + 1) * C/D) of the
  capacity-axis fields of the state (SHARDED: parameters, Adam moments,
  statistics, the active mask) and renders through gathered screen
  attributes; its gradients are exact for its rows and need no merge.

Every rank builds the same scene from the same seed and draws the same
random numbers (background, densify noise), so the replicated state stays
the same on every rank.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import field
from typing import Dict, List, Optional

import numpy as np
import torch

from gssr_tpu_torch.cameras import Camera
from gssr_tpu_torch.configs.base import DataLoaderConfig
from gssr_tpu_torch.dataio.dataset import ColmapDataLoader
from gssr_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from gssr_tpu_torch.models.vanilla import (
    PARAM_NAMES,
    GaussianState,
    VanillaGaussianConfig,
    VanillaGaussians,
)
from gssr_tpu_torch.ops.projection import TILE
from gssr_tpu_torch.ops.rasterize import pad_to_tiles, rasterize
from gssr_tpu_torch.ops.ssim import l1_loss, psnr, ssim
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.parallel.comm import Parallel

GT_CACHE_FRAMES = 64


@dataclasses.dataclass
class VanillaSceneConfig:
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    gaussians: VanillaGaussianConfig = field(
        default_factory=VanillaGaussianConfig)
    lambda_dssim: float = 0.2
    random_background: bool = False
    scaling_modifier: float = 1.0


class VanillaScene:
    # the state's capacity-axis fields (dotted paths through its dataclass
    # and dict nodes): gshard splits every tensor under them by rows;
    # every other leaf (Adam's count, n_active) is replicated
    SHARDED = ("params", "adam_m", "adam_v", "stats", "active")

    def __init__(self, config: VanillaSceneConfig, source_dir: str, device,
                 eval: bool = False, seed: int = 0,
                 dataloader: Optional[ColmapDataLoader] = None):
        self.config = config
        self.device = torch.device(device)
        self.dataloader = dataloader or ColmapDataLoader(
            config.dataloader, source_dir, eval, seed=seed)
        self.cameras_extent = self.dataloader.cameras_extent
        self.background = torch.as_tensor(self.dataloader.background,
                                          device=self.device)
        self.gaussians = self.make_gaussians()
        self.state = self.init_state()
        cam0 = self.dataloader.train_cameras[0]
        self.width, self.height = cam0.width, cam0.height
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._gt_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self.parallel = Parallel()

    # ------------------------------------------------------------------
    def setup_parallel(self, mode: str):
        """Train in `mode` ("dp", "band" or "gshard", the module
        docstring) over the ranks of the torch.distributed group (a group
        of one without one). Band needs the tile rows to divide over the
        ranks, gshard the capacity."""
        world = comm.world()
        if mode == "band":
            rows = pad_to_tiles(self.width, self.height)[1] // TILE
            if rows % world:
                raise ValueError(f"band mode needs the {rows} tile rows to "
                                 f"divide evenly over {world} ranks")
        elif mode == "gshard":
            cap = self.gshard_capacity()
            if cap % world:
                raise ValueError(f"gshard needs capacity {cap} divisible "
                                 f"by {world} ranks")
        elif mode != "dp":
            raise ValueError(f"unknown parallel mode {mode!r}")
        self.parallel = Parallel(mode, comm.rank(), world)

    def gshard_capacity(self) -> int:
        """The capacity axis gshard splits; a scene that cannot shard its
        model raises NotImplementedError here."""
        return self.state.active.shape[0]

    def render_par(self) -> dict:
        """The rasterizer's multi-device arguments of a train render."""
        par = self.parallel
        if par.mode == "band":
            return {"band_rank": par.rank, "band_count": par.world}
        if par.mode == "gshard":
            return {"gauss_shard": True}
        return {}

    def merge_grads(self, grads, shared: bool = False) -> list:
        """Per-rank parameter gradients merged over the ranks as the
        reference's pmean: averaged in dp (each rank's own camera) and in
        band (each rank's band of one camera, times the number of ranks:
        the mean is the sum over the bands). Under gshard a rank's
        gradients are exact for its own rows; `shared` ones (a replicated
        parameter that saw only this rank's rows) are summed."""
        mode, world = self.parallel.mode, self.parallel.world
        if mode == "gshard" and shared:
            return comm.all_reduce_many(grads)
        if mode in ("dp", "band"):
            return [g / world for g in comm.all_reduce_many(grads)]
        return list(grads)

    def merge_screen_grads(self, grads) -> list:
        """Screen-space (densify statistic) gradients: in band mode each
        rank's band times the number of ranks, averaged; a rank's own
        otherwise."""
        if self.parallel.mode == "band":
            return [g / self.parallel.world
                    for g in comm.all_reduce_many(grads)]
        return list(grads)

    def step_cameras(self, camera):
        """(every camera of a step, the one this rank renders): in dp
        `camera` is the list of every rank's camera, in rank order, as the
        reference's dp step takes its batch; one camera otherwise."""
        if self.parallel.mode != "dp":
            return [camera], camera
        cams = list(camera)
        if len(cams) != self.parallel.world:
            raise ValueError(f"a dp step takes {self.parallel.world} "
                             f"cameras, one per rank; got {len(cams)}")
        return cams, cams[self.parallel.rank]

    def merge_metrics(self, metrics: dict) -> dict:
        """The step's metrics as gssr_tpu's _pmerge_metrics merges them:
        the mean over the ranks, the maximum for num_rendered and
        overflow."""
        if self.parallel.mode == "none":
            return metrics
        vals = {k: torch.as_tensor(v).to(self.device, torch.float32)
                for k, v in metrics.items()}
        top = [k for k in vals if k in ("num_rendered", "overflow")]
        avg = [k for k in vals if k not in top]
        sums = comm.all_reduce_many([vals[k] for k in avg])
        maxs = comm.all_reduce_many([vals[k] for k in top], "max")
        out = {k: v / self.parallel.world for k, v in zip(avg, sums)}
        out.update(zip(top, maxs))
        return {k: out[k] for k in metrics}

    def _map_sharded(self, state, fn, rows: int):
        """The state with fn applied to each tensor under a SHARDED field,
        each of which must have `rows` rows; every other leaf is kept as
        it is."""
        def walk(x, path, sharded):
            if torch.is_tensor(x):
                if not sharded:
                    return x
                if x.shape[:1] != (rows,):
                    raise ValueError(f"gshard: state field {path} has shape "
                                     f"{tuple(x.shape)}, not {rows} rows")
                return fn(x)
            if isinstance(x, dict):
                items = x.items()
            elif dataclasses.is_dataclass(x):
                items = [(f.name, getattr(x, f.name))
                         for f in dataclasses.fields(x)]
            else:
                return x
            out = {}
            for k, v in items:
                sub = f"{path}.{k}" if path else k
                out[k] = walk(v, sub, sharded or sub in self.SHARDED)
            return out if isinstance(x, dict) else \
                dataclasses.replace(x, **out)
        return walk(state, "", False)

    def step_state(self, state):
        """The state in the train step's layout: this rank's rows of the
        capacity axis under gshard, the state itself otherwise."""
        if self.parallel.mode != "gshard":
            return state
        return self._map_sharded(state, comm.shard_rows,
                                 self.gshard_capacity())

    def full_state(self, state):
        """The whole state from the train step's layout (a gather of every
        rank's rows under gshard; every rank must call it)."""
        if self.parallel.mode != "gshard":
            return state
        return self._map_sharded(
            state, comm.all_gather,
            self.gshard_capacity() // self.parallel.world)

    def densify_events(self, step: int):
        """(densify and prune, opacity reset): what densify runs after
        `step`, on the reference's schedule."""
        cfg = self.config.gaussians
        if step >= cfg.densify_until_iter:
            return False, False
        return (step > cfg.densify_from_iter
                and step % cfg.densification_interval == 0,
                step % cfg.opacity_reset_interval == 0)

    def densify_due(self, step: int) -> bool:
        """Whether densify(state, step) changes the state."""
        return any(self.densify_events(step))

    def train_densify(self, state, step: int, **draws):
        """densify on the train step's layout. Under gshard every rank
        gathers the whole state, runs the single-device densify with the
        same draws and keeps its rows again: each rank holds the whole
        state for the moment of the densify, as the reference's densify
        under plain jit does (GSPMD gathers the sharded arrays). `draws`
        go to densify (tests inject the reference's)."""
        if self.parallel.mode != "gshard":
            return self.densify(state, step, **draws)
        if not self.densify_due(step):
            return state
        return self.step_state(self.densify(self.full_state(state), step,
                                            **draws))

    def make_gaussians(self) -> VanillaGaussians:
        return VanillaGaussians(self.config.gaussians,
                                spatial_lr_scale=self.cameras_extent)

    def init_state(self):
        """The initial state from the scene's SfM points (the octree
        scenes also pass the training cameras)."""
        pcd = self.dataloader.point_cloud
        return self.gaussians.create_from_points(pcd.points, pcd.colors,
                                                 self.device)

    # ------------------------------------------------------------------
    def render_params(self, params, camera, sh_degree: int, active, bg,
                      mean2d_offset=None, **par):
        """A render of the gaussians `params`; `par`: the rasterizer's
        multi-device arguments (render_par)."""
        g = self.gaussians
        return rasterize(
            params["xyz"], g.get_scaling(params), g.get_rotation(params),
            g.get_opacity(params)[:, 0], camera, self.width, self.height, bg,
            sh_coeffs=g.get_features(params), sh_degree=sh_degree,
            active_mask=active, scaling_modifier=self.config.scaling_modifier,
            mean2d_offset=mean2d_offset, **par)

    def loss_terms(self, out, gt, step: int, camera):
        """Method losses of a render; `camera` (CameraArrays) is the one
        it came from. Subclasses extend them."""
        lam = self.config.lambda_dssim
        return {
            "L1_loss": (1.0 - lam) * l1_loss(out.image, gt),
            "ssim_loss": lam * (1.0 - ssim(out.image, gt)),
        }

    def gt_device(self, camera: Camera) -> torch.Tensor:
        """The camera's GT frame on the device, through a bounded LRU so
        a frame is uploaded once, not every step."""
        key = (camera.uid, np.shape(camera.image))
        v = self._gt_cache.pop(key, None)
        if v is None:
            v = torch.as_tensor(np.asarray(camera.image, np.float32),
                                device=self.device)
        self._gt_cache[key] = v
        while len(self._gt_cache) > GT_CACHE_FRAMES:
            self._gt_cache.popitem(last=False)
        return v

    def get_background(self):
        if self.config.random_background:
            return torch.rand(3, generator=self.generator, device=self.device)
        return self.background

    # ------------------------------------------------------------------
    def train_step(self, state: GaussianState, camera, step: int):
        """One step: render, loss, backward, Adam, densify statistics, on
        `camera` (in dp the list of every rank's, step_cameras). Returns
        (new state, metrics as 0-d tensors)."""
        _, camera = self.step_cameras(camera)
        g = self.gaussians
        sh_degree = g.active_sh_degree(step)
        cam = camera.arrays(self.device)
        gt = self.gt_device(camera)
        bg = self.get_background()
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        m2d_offset = torch.zeros_like(state.params["xyz"][:, :2],
                                      requires_grad=True)
        out = self.render_params(params, cam, sh_degree, state.active, bg,
                                 mean2d_offset=m2d_offset,
                                 **self.render_par())
        terms = self.loss_terms(out, gt, step, cam)
        loss = sum(terms.values())
        inputs = [params[k] for k in PARAM_NAMES] + [m2d_offset]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(inputs, grads)]
        grads = self.merge_grads(grads[:-1]) + \
            self.merge_screen_grads(grads[-1:])
        with torch.no_grad():
            new_state = g.adam_step(state, dict(zip(PARAM_NAMES, grads)),
                                    g.learning_rates(step))
            new_state.stats = g.update_stats(
                state.stats, out.radii, grads[-1],
                g.ndc_grad_scale(self.width, self.height, self.device))
            if self.parallel.mode == "dp":
                new_state.stats = g.dp_merge_stats(state.stats,
                                                   new_state.stats)
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics.update(loss=loss.detach(), num_rendered=out.num_rendered,
                       overflow=out.overflow)
        return new_state, self.merge_metrics(metrics)

    # ------------------------------------------------------------------
    def densify(self, state: GaussianState, step: int,
                noise=None) -> GaussianState:
        """Densify/prune and opacity reset on the reference's schedule.
        `noise` replaces the model's position samples, [2, C, 3] for the
        split children here (tests inject the reference's draw)."""
        prune, reset = self.densify_events(step)
        with torch.no_grad():
            if prune:
                state = self.densify_and_prune(
                    state,
                    step > self.config.gaussians.opacity_reset_interval,
                    noise)
            if reset:
                state = self.gaussians.reset_opacity(state)
        return state

    def densify_and_prune(self, state: GaussianState, use_size_prune: bool,
                          noise=None) -> GaussianState:
        return self.gaussians.densify_and_prune(
            state, use_size_prune, generator=self.generator, noise=noise)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_render(self, state: GaussianState, camera: Camera, step: int):
        return self.render_params(
            state.params, camera.arrays(self.device),
            self.gaussians.active_sh_degree(step), state.active,
            self.background)

    def evaluate(self, state: GaussianState, step: int) -> Dict[str, float]:
        cams = self.dataloader.test_cameras or \
            self.dataloader.train_cameras[:8]
        l1s, psnrs = [], []
        for cam in cams:
            out = self.eval_render(state, cam, step)
            gt = torch.as_tensor(np.asarray(cam.image, np.float32),
                                 device=self.device)
            l1s.append(float(l1_loss(out.image, gt)))
            psnrs.append(float(psnr(out.image, gt)))
        return {"eval_l1": float(np.mean(l1s)),
                "eval_psnr": float(np.mean(psnrs))}

    def get_training_callbacks(self, trainer) -> list:
        """Host-side hooks the trainer runs before and after every train
        iteration (engine/callbacks.py::TrainingCallback). The per-step
        schedules (LR, SH degree) live in the train step, so the default is
        empty; a subclass returns its own."""
        return []

    # ------------------------------------------------------------------
    def aux_arrays(self) -> List[np.ndarray]:
        """Scene state beyond the gaussians that rides in checkpoints, in
        the reference's aux order: RNG state, sampler draws."""
        return [self.generator.get_state().numpy(),
                np.asarray(self.dataloader.draws)]

    def restore_aux(self, aux: List[np.ndarray]):
        rng, draws = aux
        if rng.dtype == np.uint8:
            self.generator.set_state(torch.as_tensor(rng))
        else:
            # a gssr_tpu checkpoint holds a JAX key, which no torch
            # generator can reproduce: seed from its words instead
            words = np.asarray(rng, np.uint64).ravel()
            self.generator.manual_seed(int(words[0]) << 32 | int(words[-1]))
        self.dataloader.restore_sampler(int(draws))

    def state_to_numpy(self, state: GaussianState) -> List[np.ndarray]:
        """The state's leaves in gssr_tpu's checkpoint order."""
        return state_to_numpy(state)

    def state_from_numpy(self, leaves) -> GaussianState:
        return state_from_numpy(leaves, self.device)

    def save_gaussians(self, state: GaussianState, path: str):
        self.gaussians.save_ply(state, path)

    def load_gaussians(self, path: str) -> GaussianState:
        return self.gaussians.load_ply(path, self.device)
