"""Octree-GS: level-of-detail anchors on top of Scaffold-GS (port of
gssr_tpu/models/octree.py).

Every anchor carries an integer octree level. The levels come from the
training cameras' distance quantiles; the init samples the SfM points on
one voxel grid per level and weeds out the positions too fine for the
cameras to see. A render keeps the anchors whose level is at most the
level its camera distance asks for (the LOD mask), optionally ramping the
finest level's opacity in (the `progressive` gate), and anchor growing
runs per level, into the level itself and into the next finer one.

The init and its weed-out run in float64 numpy on the host, as the
reference; the LOD mask, the densify-time weed-out and the growing run in
float32 on the state's device. Where the reference divides by an array
(the LOD mask's distances) the port divides by a device tensor; where its
jitted densify divides by a voxel size, a compile-time constant that XLA
turns into a multiply by the rounded reciprocal, the port multiplies by
that reciprocal (models/scaffold.py::reciprocal_f32). A one-ulp
difference moves a coordinate across a `round` boundary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gssr_tpu_torch.models.scaffold import (
    OPACITY_INIT,
    ScaffoldGaussianConfig,
    ScaffoldGaussians,
    ScaffoldState,
    reciprocal_f32,
)
from gssr_tpu_torch.ops.knn import mean_knn_dist2_host
from gssr_tpu_torch.ops.voxel import (
    KEY_MAX,
    dedup_against,
    hash_coords,
    segment_max_sorted,
)
from gssr_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class OctreeGaussianConfig(ScaffoldGaussianConfig):
    fork: int = 2
    add_level: bool = False
    visible_threshold: float = -1.0
    dist2level: str = "round"       # floor, round, ceil or progressive
    base_layer: int = -1
    progressive: bool = False
    extend: float = 1.1
    dist_ratio: float = 0.999
    levels: int = -1                # -1: from the camera distances
    init_level: int = -1            # -1: levels // 2
    update_anchor: bool = True
    update_ratio: float = 0.2
    extra_ratio: float = 0.25
    extra_up: float = 0.01
    appearance_dim: int = 0         # the octree-gs preset has none


@dataclasses.dataclass
class OctreeState(ScaffoldState):
    """The scaffold state plus each anchor slot's octree level and its
    learned level bump."""
    level: torch.Tensor = None         # [CA] int32
    extra_level: torch.Tensor = None   # [CA] float32


def _f32(value: float, like):
    """value as a float32 scalar on like's device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def with_levels(base: ScaffoldState, level, extra_level) -> OctreeState:
    """The octree state of a scaffold state and the two level arrays."""
    return OctreeState(**{f.name: getattr(base, f.name)
                          for f in dataclasses.fields(ScaffoldState)},
                       level=level, extra_level=extra_level)


class OctreeGaussians(ScaffoldGaussians):
    config: OctreeGaussianConfig

    def __init__(self, config: OctreeGaussianConfig,
                 spatial_lr_scale: float = 1.0, num_cameras: int = 1):
        super().__init__(config, spatial_lr_scale, num_cameras)
        self.fork = config.fork
        self.levels = config.levels
        self.init_level = config.init_level
        self.standard_dist = 1.0
        self.init_pos = np.zeros(3, np.float32)
        self.visible_threshold = config.visible_threshold
        self.cam_infos = np.zeros((0, 4), np.float32)
        self.coarse_intervals: list = []

    # ---------------- levels (host) -----------------------------------
    def set_level(self, points: np.ndarray, cameras):
        """The level count from the cameras' distance quantiles: each
        camera gives its dist_ratio and 1 - dist_ratio quantiles of the
        point distances, and the levels span their quantiles in powers of
        `fork`. cameras: host Camera objects."""
        cfg = self.config
        all_dist, cam_infos = [], []
        for cam in cameras:
            c = np.asarray(cam.campos, np.float64)
            cam_infos.append([c[0], c[1], c[2], 1.0])
            d = np.linalg.norm(points - c, axis=1)
            all_dist += [np.quantile(d, cfg.dist_ratio),
                         np.quantile(d, 1 - cfg.dist_ratio)]
        self.cam_infos = np.asarray(cam_infos, np.float32)
        all_dist = np.asarray(all_dist)
        dist_max = np.quantile(all_dist, cfg.dist_ratio)
        dist_min = np.quantile(all_dist, 1 - cfg.dist_ratio)
        self.standard_dist = float(dist_max)
        if self.levels == -1:
            self.levels = int(round(
                math.log2(dist_max / dist_min) / math.log2(self.fork))) + 1
        if self.init_level == -1:
            self.init_level = self.levels // 2

    def set_coarse_interval(self, coarse_iter: int, coarse_factor: float):
        """The steps at which progressive training opens each level finer
        than init_level: a geometric series of ratio 1 / coarse_factor
        summing to coarse_iter."""
        self.coarse_intervals = []
        num_level = self.levels - 1 - self.init_level
        if num_level > 0:
            q = 1.0 / coarse_factor
            if abs(1.0 - q) < 1e-9:
                a1 = coarse_iter / num_level
            else:
                a1 = coarse_iter * (1 - q) / (1 - q ** num_level)
            acc = 0.0
            for i in range(num_level):
                acc += a1 * q ** i
                self.coarse_intervals.append(acc)

    def _pred_level_np(self, positions: np.ndarray, cam: np.ndarray):
        d = np.linalg.norm(positions - cam[:3], axis=1) * cam[3]
        return np.log2(self.standard_dist / np.maximum(d, 1e-9)) \
            / math.log2(self.fork)

    def _map_to_int_level_np(self, pred, cur_level: int):
        mode = self.config.dist2level
        if mode == "floor":
            lv = np.floor(pred)
        elif mode == "round":
            lv = np.round(pred)
        elif mode == "ceil":
            lv = np.ceil(pred)
        elif mode == "progressive":
            lv = np.floor(np.clip(pred + 1.0, 0.9999, cur_level + 0.9999))
        else:
            raise ValueError(mode)
        return np.clip(lv, 0, cur_level).astype(np.int32)

    def weed_out_np(self, positions: np.ndarray, levels: np.ndarray):
        """Keep the positions whose level some share above
        visible_threshold of the training cameras would render. Returns
        (positions, levels, the mean share)."""
        count = np.zeros(len(positions))
        for cam in self.cam_infos:
            int_level = self._map_to_int_level_np(
                self._pred_level_np(positions, cam), self.levels - 1)
            count += (levels <= int_level)
        ratio = count / max(len(self.cam_infos), 1)
        mask = ratio > self.visible_threshold
        return positions[mask], levels[mask], float(ratio.mean())

    # ---------------- init --------------------------------------------
    def create_from_points(self, points: np.ndarray, colors=None,
                           device="cpu", cameras=None,
                           capacity: Optional[int] = None,
                           seed: int = 0) -> OctreeState:
        """Anchors on one voxel grid per level (each level's voxel half the
        last's), weeded out twice against the training cameras `cameras`
        (the first pass sets visible_threshold when it is negative), with
        scales from the 3-NN distance and the MLP from init_mlp(seed).
        `colors` is not used."""
        cfg = self.config
        if cameras is None:
            raise ValueError("the octree init needs the training cameras")
        points = np.asarray(points, np.float64)[::cfg.sampling_ratio]
        self.set_level(points, cameras)

        box_min = float(points.min()) * cfg.extend
        box_max = float(points.max()) * cfg.extend
        box_d = box_max - box_min
        base_layer = cfg.base_layer
        if base_layer < 0:
            base_layer = int(round(math.log2(box_d / 0.02))) \
                - (self.levels // 2) + 1
        self.voxel_size = box_d / (float(self.fork) ** base_layer)
        self.init_pos = np.full(3, box_min, np.float32)

        positions, levels = [], []
        for lv in range(self.levels):
            sz = self.voxel_size / (float(self.fork) ** lv)
            coords = np.unique(np.round((points - self.init_pos) / sz),
                               axis=0)
            positions.append(coords * sz + self.init_pos)
            levels.append(np.full(len(coords), lv, np.int32))
        positions = np.concatenate(positions)
        levels = np.concatenate(levels)

        if self.visible_threshold < 0:
            self.visible_threshold = 0.0
            positions, levels, self.visible_threshold = self.weed_out_np(
                positions, levels)
        positions, levels, _ = self.weed_out_np(positions, levels)

        n = len(positions)
        cap = capacity or cfg.capacity or int(
            max(n * cfg.capacity_multiplier, 1 << 12))
        cap = -(-cap // 128) * 128
        K, F = cfg.n_offsets, cfg.feat_dim
        dist2 = np.maximum(mean_knn_dist2_host(positions), 1e-7)
        scales = np.log(np.sqrt(dist2))[:, None].repeat(6, axis=1)

        def alloc(arr, shape, fill=0.0, dtype=np.float32):
            out = np.full((cap,) + shape, fill, dtype)
            out[:n] = arr
            return torch.as_tensor(out, device=device)

        anchors = {
            "anchor": alloc(positions, (3,)),
            "offset": torch.zeros((cap, K, 3), device=device),
            "feat": torch.zeros((cap, F), device=device),
            "scaling": alloc(scales, (6,), fill=-10.0),
            "rotation": alloc(np.tile([1.0, 0, 0, 0], (n, 1)), (4,),
                              fill=1.0),
            "opacity": torch.full((cap, 1), OPACITY_INIT, device=device),
        }
        base = self._new_state(anchors, self.init_mlp(device, seed), n)
        return with_levels(base, alloc(levels, (), dtype=np.int32),
                            torch.zeros(cap, device=device))

    def level_counts(self, state: OctreeState):
        """The active anchors of each level, a list of `levels` ints."""
        lv = state.level[state.active].to(torch.int64)
        return torch.bincount(lv, minlength=self.levels).tolist()

    # ---------------- the LOD mask ------------------------------------
    def _pred_level(self, positions, campos):
        """The level the camera at campos asks for at each position,
        before rounding: log_fork(standard_dist / distance)."""
        dist = torch.linalg.norm(positions - campos, dim=-1)
        with span("sync.lod"):
            standard = _f32(self.standard_dist, dist)
        with span("sync.lod"):
            log_fork = _f32(math.log2(self.fork), dist)
        return torch.log2(standard / torch.clamp(dist, min=1e-9)) / log_fork

    def coarse_level(self, step, is_training: bool) -> int:
        """The finest level a render may use: the last under progressive
        training before its coarse schedule ends, else levels - 1."""
        cfg = self.config
        if cfg.progressive and is_training and self.coarse_intervals:
            # the reference compares the step as float32 with the float32
            # intervals (searchsorted, left side)
            return int(np.searchsorted(
                np.asarray(self.coarse_intervals, np.float32),
                np.float32(step), side="left")) + self.init_level
        return self.levels - 1

    def pred_int_level(self, state: OctreeState, campos, step,
                       is_training: bool):
        """The LOD mask of one camera: (anchor mask [CA] bool, opacity gate
        [CA] or None). In `progressive` mode the gate ramps each anchor at
        the camera's fractional level by that fraction."""
        cfg = self.config
        level_f = state.level.to(torch.float32)
        with span("sync.lod"):
            half = _f32(self.voxel_size / 2.0, level_f)
        with span("sync.lod"):
            fork = _f32(float(self.fork), level_f)
        anchor_pos = state.anchors["anchor"] + (
            half / torch.pow(fork, level_f))[:, None]
        pred = self._pred_level(anchor_pos, campos) + state.extra_level
        cur_level = self.coarse_level(step, is_training)

        gate = None
        mode = cfg.dist2level
        if mode == "floor":
            int_level = torch.clamp(torch.floor(pred), 0, cur_level)
        elif mode == "round":
            int_level = torch.clamp(torch.round(pred), 0, cur_level)
        elif mode == "ceil":
            int_level = torch.clamp(torch.ceil(pred), 0, cur_level)
        elif mode == "progressive":
            p = torch.clamp(pred + 1.0, 0.9999,
                            float(np.float32(cur_level) + np.float32(0.9999)))
            int_level = torch.floor(p)
            gate = torch.where(level_f == int_level, p - int_level,
                               torch.ones_like(p))
        else:
            raise ValueError(mode)
        return level_f <= int_level, gate

    # ---------------- densification -----------------------------------
    def _weed_out(self, positions, level: int):
        """weed_out_np on the device for candidate anchors of one level:
        the share of training cameras whose rounded level reaches it must
        pass visible_threshold."""
        cams = torch.as_tensor(self.cam_infos, device=positions.device)
        d = torch.linalg.norm(positions[:, None, :] - cams[None, :, :3],
                              dim=-1) * cams[None, :, 3]
        ratio = _f32(self.standard_dist, d) / torch.clamp(d, min=1e-9)
        pred = torch.log2(ratio) / _f32(math.log2(self.fork), d)
        int_level = torch.clamp(torch.round(pred), 0, self.levels - 1)
        count = (float(level) <= int_level).to(torch.float32).sum(1) \
            / _f32(float(cams.shape[0]), d)
        return count > self.visible_threshold

    def _grow_octree_set(self, state: OctreeState, cand_flat, new_level: int,
                         cur_size: float, with_feat: bool) -> OctreeState:
        """The candidate offsets `cand_flat` [CA*K] propose the voxel of
        size cur_size they fall in; voxels new to the level's anchors that
        the cameras would render at new_level become anchors of that level
        (with their candidates' largest feature, or zero without
        with_feat)."""
        an = state.anchors
        CA, K = an["offset"].shape[:2]
        dev = an["anchor"].device
        size = torch.tensor(cur_size, dtype=torch.float32, device=dev)
        inv_size = reciprocal_f32(cur_size, dev)
        init_pos = torch.as_tensor(self.init_pos, device=dev)

        anchor_scaling = torch.exp(an["scaling"][:, :3])
        all_xyz = an["anchor"][:, None, :] + an["offset"] * anchor_scaling[
            :, None]
        coords = torch.round((all_xyz.reshape(CA * K, 3) - init_pos)
                             * inv_size).to(torch.int32)
        keys = hash_coords(coords)
        exist_keys = torch.where(
            state.active & (state.level == new_level),
            hash_coords(torch.round((an["anchor"] - init_pos)
                                    * inv_size).to(torch.int32)),
            torch.full((CA,), KEY_MAX, dtype=torch.int32, device=dev))
        dd = dedup_against(keys, cand_flat, torch.sort(exist_keys).values)
        new_anchor = coords[dd.order].to(torch.float32) * size + init_pos
        is_new = dd.is_new & self._weed_out(new_anchor, new_level)

        if with_feat:
            feat_sorted = torch.repeat_interleave(an["feat"], K,
                                                  dim=0)[dd.order]
            new_feat = segment_max_sorted(feat_sorted, dd.seg_id,
                                          CA * K)[dd.seg_id]
        else:
            new_feat = an["feat"].new_zeros((CA * K, an["feat"].shape[1]))
        grown, newly = self._insert_anchors(state, is_new, new_anchor,
                                            new_feat, torch.log(size))
        return dataclasses.replace(
            grown,
            level=torch.where(newly, torch.full_like(state.level, new_level),
                              state.level),
            extra_level=torch.where(newly, torch.zeros_like(
                state.extra_level), state.extra_level))

    def adjust_anchor_octree(self, state: OctreeState,
                             step) -> OctreeState:
        """Anchor growing level by level, then the scaffold's statistics
        reset and opacity prune. Level lv's offsets between its threshold
        and the next level's grow anchors at lv, those above grow anchors
        at lv + 1 (without features); an anchor whose mean offset gradient
        passes a fraction of the threshold raises its extra_level. Under
        progressive training both of the latter wait for the end of the
        coarse schedule. Draws nothing."""
        cfg = self.config
        CA, K = state.stats["offset_denom"].shape
        grads, offset_mask = self.offset_gradients(state.stats)
        grads = torch.where(offset_mask, grads, torch.zeros_like(grads))
        anchor_grads = grads.sum(1) / (
            offset_mask.to(torch.float32).sum(1) + 1e-6)

        update_value = float(self.fork) ** cfg.update_ratio
        past_coarse = True
        if cfg.progressive and self.coarse_intervals:
            past_coarse = bool(np.float32(step)
                               > np.float32(self.coarse_intervals[-1]))

        for lv in range(self.levels):
            cur_size = self.voxel_size / (float(self.fork) ** lv)
            cur_thr = cfg.densify_grad_threshold * (update_value ** lv)
            ds_thr = cur_thr * update_value
            extra_thr = cur_thr * cfg.extra_ratio
            live = ((state.level == lv) & state.active)[:, None]
            cand = (grads >= cur_thr) & (grads < ds_thr) & live
            cand_ds = (grads >= ds_thr) & live & past_coarse
            bump = (anchor_grads >= extra_thr) & state.active & past_coarse
            state = dataclasses.replace(
                state, extra_level=state.extra_level
                + cfg.extra_up * bump.to(torch.float32))
            state = self._grow_octree_set(state, cand.reshape(CA * K), lv,
                                          cur_size, with_feat=True)
            if lv < self.levels - 1:
                state = self._grow_octree_set(
                    state, cand_ds.reshape(CA * K), lv + 1,
                    cur_size / self.fork, with_feat=False)
        return self._reset_and_prune(state, offset_mask)

    # ---------------- serialization -----------------------------------
    def _ply_columns(self, state: OctreeState):
        """The scaffold columns with level (as float32), extra_level and
        info after the normals; info[0] holds voxel_size and info[1]
        standard_dist."""
        cols = super()._ply_columns(state)
        act = state.active.cpu().numpy()
        n = len(cols["x"])
        info = np.zeros(n, np.float32)
        if n > 0:
            info[0] = self.voxel_size
        if n > 1:
            info[1] = self.standard_dist
        head = {k: cols.pop(k) for k in ("x", "y", "z", "nx", "ny", "nz")}
        return {**head,
                "level": state.level.cpu().numpy()[act].astype(np.float32),
                "extra_level": state.extra_level.cpu().numpy()[act],
                "info": info, **cols}

    def load_ply(self, path: str, device, capacity: Optional[int] = None,
                 seed: int = 0) -> OctreeState:
        """The octree PLY schema: the scaffold anchors, their levels, and
        voxel_size and standard_dist from the info column."""
        from gssr_tpu_torch.dataio.ply import read_ply
        cols = read_ply(path)
        n = len(cols["x"])
        if n > 0:
            self.voxel_size = float(cols["info"][0])
        if n > 1:
            self.standard_dist = float(cols["info"][1])
        levels = cols["level"].astype(np.int32)
        if self.levels <= 0:
            self.levels = int(levels.max()) + 1 if n else 1
        base = ScaffoldGaussians.load_ply(self, path, device,
                                          capacity=capacity, seed=seed)
        cap = base.active.shape[0]
        lv = np.zeros(cap, np.int32)
        lv[:n] = levels
        ex = np.zeros(cap, np.float32)
        ex[:n] = cols["extra_level"]
        return with_levels(base, torch.as_tensor(lv, device=device),
                            torch.as_tensor(ex, device=device))
