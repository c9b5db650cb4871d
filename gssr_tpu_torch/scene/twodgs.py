"""2DGS scene: surfel rendering plus the normal and distortion
regularisers (port of gssr_tpu/scene/twodgs.py).

Same loss schedule as the reference (the normal loss after step 7000, the
distortion after step 3000), the depth_ratio surf-depth mix, and the
depth-to-pseudo-normal consistency term. A regulariser whose weight is 0
at this step is not evaluated; its term is a zero.
"""
from __future__ import annotations

import dataclasses
from dataclasses import field

import torch
import torch.nn.functional as F

from gssr_tpu_torch.models.twod import TwoDGaussianConfig, TwoDGaussians
from gssr_tpu_torch.ops.rasterize2d import rasterize_2d
from gssr_tpu_torch.scene.vanilla import VanillaScene, VanillaSceneConfig


@dataclasses.dataclass
class TwoDGSSceneConfig(VanillaSceneConfig):
    gaussians: TwoDGaussianConfig = field(default_factory=TwoDGaussianConfig)
    lambda_dist: float = 0.0
    lambda_normal: float = 0.05
    depth_ratio: float = 0.0


def surf_normal_from_depth(surf_depth, alpha, camera):
    """Unproject surf_depth to world points and finite-difference a pseudo
    surface normal, scaled by the detached alpha."""
    H, W = surf_depth.shape
    dev = surf_depth.device
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    dir_cam = torch.stack([(gx - camera.cx) / camera.fx,
                           (gy - camera.cy) / camera.fy,
                           torch.ones_like(gx)], dim=-1)        # [H,W,3]
    dir_world = dir_cam @ camera.w2c[:3, :3]          # rows times R_c2w^T
    points = surf_depth[..., None] * dir_world + camera.campos
    dv = points[2:, 1:-1] - points[:-2, 1:-1]
    dh = points[1:-1, 2:] - points[1:-1, :-2]
    nrm = torch.linalg.cross(dv, dh)
    # rsqrt(sum + eps): the norm's gradient at an exactly-zero vector
    # (empty image regions) is NaN
    nrm = nrm * torch.rsqrt((nrm * nrm).sum(-1, keepdim=True) + 1e-12)
    nrm = F.pad(nrm, (0, 0, 1, 1, 1, 1))
    return nrm * alpha.detach()[..., None]


def surfel_reg_losses(out, camera, step: int, lambda_normal: float,
                      lambda_dist: float):
    """The 2DGS regularisers on their step schedules."""
    lam_n = lambda_normal if step > 7000 else 0.0
    lam_d = lambda_dist if step > 3000 else 0.0
    zero = out.dist.new_zeros(())
    normal_loss = dist_loss = zero
    if lam_n:
        surf_normal = surf_normal_from_depth(out.surf_depth, out.alpha,
                                             camera)
        normal_error = 1.0 - (out.normal * surf_normal).sum(-1)
        normal_loss = lam_n * normal_error.mean()
    if lam_d:
        dist_loss = lam_d * out.dist.mean()
    return {"normal_loss": normal_loss, "dist_loss": dist_loss}


class TwoDGSScene(VanillaScene):
    config: TwoDGSSceneConfig

    def make_gaussians(self):
        return TwoDGaussians(self.config.gaussians,
                             spatial_lr_scale=self.cameras_extent)

    def render_params(self, params, camera, sh_degree: int, active, bg,
                      mean2d_offset=None, **par):
        g = self.gaussians
        return rasterize_2d(
            params["xyz"], g.get_scaling(params), g.get_rotation(params),
            g.get_opacity(params)[:, 0], camera, self.width, self.height, bg,
            sh_coeffs=(params["f_dc"], params["f_rest"]), sh_degree=sh_degree,
            active_mask=active, scaling_modifier=self.config.scaling_modifier,
            depth_ratio=self.config.depth_ratio, mean2d_offset=mean2d_offset,
            **par)

    def loss_terms(self, out, gt, step: int, camera):
        terms = super().loss_terms(out, gt, step, camera)
        terms.update(surfel_reg_losses(out, camera, step,
                                       self.config.lambda_normal,
                                       self.config.lambda_dist))
        return terms
