"""Per-gaussian preprocess: project, EWA 2D covariance, radii, tile rects
(port of gssr_tpu/ops/projection.py).

Branch-free masked math over the fixed-capacity gaussian arrays; autograd
differentiates it. Integer outputs (radius, rect, tile counts, the
intersect mask) are int32 like the reference's, so binning's bit packing
carries over unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gssr_tpu_torch.utils.general import build_covariance

TILE = 16          # tile edge in pixels
NEAR_CULL = 0.2    # view-space z cull threshold
COV2D_DILATE = 0.3  # low-pass filter added to the cov2D diagonal
MASK_TILES = 32    # rect tiles covered by the per-gaussian intersect bitmask


class Projected(NamedTuple):
    """Per-gaussian screen-space quantities (fixed capacity N)."""
    mean2d: torch.Tensor        # [N,2] pixel coords
    conic: torch.Tensor         # [N,3] inverse 2D covariance (xx, xy, yy)
    depth: torch.Tensor         # [N] view-space z
    radius: torch.Tensor        # [N] int32 screen radius, 0 => culled
    rect: torch.Tensor          # [N,4] int32 tile rect, exclusive max
    tiles_touched: torch.Tensor  # [N] int32
    cov2d: torch.Tensor         # [N,3] 2D covariance (xx, xy, yy)
    tile_mask: torch.Tensor     # [N] int32 intersect bits
    exact_tiles: torch.Tensor   # [N] int32 exact valid-instance count


def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def tile_intersect_mask(mean2d, conic, rect, cutoff, visible):
    """Which of the first MASK_TILES rect tiles the alpha >= 1/255 ellipse
    touches (row-major within the rect). The minimum of the convex conic
    quadratic over a tile's pixel-center box is exact: zero if the mean is
    inside, else the best of the four closed-form edge minima. Returns
    (mask [N] int32, exact_count [N] int32); rect tiles beyond MASK_TILES
    count as hits."""
    x0, y0 = rect[..., 0], rect[..., 1]
    area = (rect[..., 2] - x0) * (rect[..., 3] - y0)
    w = torch.clamp(rect[..., 2] - x0, min=1)
    mx, my = mean2d[..., 0], mean2d[..., 1]
    cxx, cxy, cyy = conic[..., 0], conic[..., 1], conic[..., 2]
    rx = cxy / torch.clamp(cxx, min=1e-12)
    ry = cxy / torch.clamp(cyy, min=1e-12)
    n_hit = torch.clamp(area, max=MASK_TILES)

    def q_of(px, py):
        dx = px - mx
        dy = py - my
        return 0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy

    mask = torch.zeros_like(x0)
    for p in range(MASK_TILES):
        tx = x0 + torch.remainder(torch.full_like(w, p), w)
        ty = y0 + torch.div(torch.full_like(w, p), w, rounding_mode="floor")
        bx0 = (tx * TILE).float()
        by0 = (ty * TILE).float()
        bx1 = bx0 + (TILE - 1)
        by1 = by0 + (TILE - 1)
        q = torch.minimum(
            torch.minimum(
                q_of(bx0, torch.clamp(my - ry * (bx0 - mx), by0, by1)),
                q_of(bx1, torch.clamp(my - ry * (bx1 - mx), by0, by1))),
            torch.minimum(
                q_of(torch.clamp(mx - rx * (by0 - my), bx0, bx1), by0),
                q_of(torch.clamp(mx - rx * (by1 - my), bx0, bx1), by1)))
        inside = (mx >= bx0) & (mx <= bx1) & (my >= by0) & (my <= by1)
        q = torch.where(inside, torch.zeros_like(q), q)
        hit = (p < n_hit) & (q <= cutoff) & visible
        mask = mask | (hit.to(torch.int32) << p)
    count = _popcount32(mask) + torch.clamp(area - MASK_TILES, min=0) \
        * visible.to(torch.int32)
    return mask, count


def ndc_to_pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def project_points(means3d, w2c, full_proj):
    """View-space points and projective coords divided by w."""
    hom = torch.cat([means3d, torch.ones_like(means3d[..., :1])], dim=-1)
    p_view = hom @ w2c[:3, :].T                     # [N,3]
    p_hom = hom @ full_proj.T                       # [N,4]
    p_proj = p_hom[..., :3] / (p_hom[..., 3:4] + 1e-7)
    return p_view, p_proj


def compute_cov2d(means3d, cov3d, w2c, fx, fy, tan_fovx, tan_fovy,
                  valid=None):
    """EWA projection of the 3D covariance with the +0.3 dilation.

    cov3d: [N,6] packed (xx,xy,xz,yy,yz,zz). Returns [N,3] (xx,xy,yy).
    `valid` sanitizes the view-space z of culled gaussians so no inf/nan
    reaches the backward pass."""
    t = torch.cat([means3d, torch.ones_like(means3d[..., :1])],
                  dim=-1) @ w2c[:3, :].T
    tz = t[..., 2]
    if valid is not None:
        tz = torch.where(valid, tz, torch.ones_like(tz))
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    txtz = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
    tytz = torch.clamp(t[..., 1] / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txtz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tytz * inv_z2

    W = w2c[:3, :3]
    m00 = j00 * W[0, 0] + j02 * W[2, 0]
    m01 = j00 * W[0, 1] + j02 * W[2, 1]
    m02 = j00 * W[0, 2] + j02 * W[2, 2]
    m10 = j11 * W[1, 0] + j12 * W[2, 0]
    m11 = j11 * W[1, 1] + j12 * W[2, 1]
    m12 = j11 * W[1, 2] + j12 * W[2, 2]

    c0, c1, c2 = cov3d[..., 0], cov3d[..., 1], cov3d[..., 2]
    c3, c4, c5 = cov3d[..., 3], cov3d[..., 4], cov3d[..., 5]
    s00 = m00 * c0 + m01 * c1 + m02 * c2
    s01 = m00 * c1 + m01 * c3 + m02 * c4
    s02 = m00 * c2 + m01 * c4 + m02 * c5
    s10 = m10 * c0 + m11 * c1 + m12 * c2
    s11 = m10 * c1 + m11 * c3 + m12 * c4
    s12 = m10 * c2 + m11 * c4 + m12 * c5
    cxx = s00 * m00 + s01 * m01 + s02 * m02 + COV2D_DILATE
    cxy = s00 * m10 + s01 * m11 + s02 * m12
    cyy = s10 * m10 + s11 * m11 + s12 * m12 + COV2D_DILATE
    return torch.stack([cxx, cxy, cyy], dim=-1)


def tile_rect(mean2d, radius_x, tiles_x, tiles_y, radius_y):
    """Touched-tile rect (x0, y0, x1, y1), exclusive max, from per-axis
    extents. The exclusive end is floor((x+r)/T) + 1: the boundary pixel
    at exactly x+r can still pass the alpha cut."""
    x, y = mean2d[..., 0], mean2d[..., 1]
    rx = radius_x.float()
    ry = radius_y.float()
    x0 = torch.clamp(torch.floor((x - rx) / TILE), 0, tiles_x)
    y0 = torch.clamp(torch.floor((y - ry) / TILE), 0, tiles_y)
    x1 = torch.clamp(torch.floor((x + rx) / TILE) + 1, 0, tiles_x)
    y1 = torch.clamp(torch.floor((y + ry) / TILE) + 1, 0, tiles_y)
    return torch.stack([x0, y0, x1, y1], dim=-1).to(torch.int32)


def opacity_sigma_factor(opacity, visible):
    """Extent in sigmas of the alpha >= 1/255 level set, capped at 3."""
    op = opacity.detach().reshape(-1)
    s_fac = torch.sqrt(2.0 * torch.log(torch.clamp(op * 255.0,
                                                   min=1.0 + 1e-6)))
    return torch.clamp(s_fac, max=3.0), visible & (op * 255.0 > 1.0)


def preprocess(means3d, scales, rotations, camera, width: int, height: int,
               opacity=None, scaling_modifier: float = 1.0,
               active_mask=None) -> Projected:
    """Vanilla-3DGS preprocess. width/height are the tile-padded image size;
    camera is a CameraArrays; opacity (activated, [N]) tightens the tile
    rect to the visible level set. Without it (the anchor models'
    visibility prefilter) the radius and rect are the fixed 3 sigma and
    the intersect cutoff is 3^2 / 2, as in the reference."""
    tiles_x, tiles_y = width // TILE, height // TILE
    cov3d = build_covariance(scales, rotations, scaling_modifier)

    p_view, p_proj = project_points(means3d, camera.w2c, camera.full_proj)
    depth = p_view[..., 2]
    visible = depth > NEAR_CULL
    if active_mask is not None:
        visible = visible & active_mask
    near_ok = visible

    cov2d = compute_cov2d(means3d, cov3d, camera.w2c, camera.fx, camera.fy,
                          camera.tan_fovx, camera.tan_fovy, valid=near_ok)
    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] ** 2
    visible = visible & (det > 0.0)
    inv_det = 1.0 / torch.where(visible, det, torch.ones_like(det))
    conic = torch.stack([cov2d[..., 2] * inv_det,
                         -cov2d[..., 1] * inv_det,
                         cov2d[..., 0] * inv_det], dim=-1)
    conic = torch.where(visible[..., None], conic, torch.zeros_like(conic))

    if opacity is None:
        s_fac = 3.0
    else:
        s_fac, visible = opacity_sigma_factor(opacity, visible)
    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(s_fac * torch.sqrt(torch.clamp(mid + disc,
                                                         min=1e-12)))
    p_proj = torch.where(near_ok[..., None], p_proj, torch.zeros_like(p_proj))
    mean2d = torch.stack([ndc_to_pix(p_proj[..., 0], width),
                          ndc_to_pix(p_proj[..., 1], height)], dim=-1)

    radius = torch.where(visible, radius_f,
                         torch.zeros_like(radius_f)).to(torch.int32)
    rx = torch.ceil(s_fac * torch.sqrt(torch.clamp(cov2d[..., 0], min=1e-12)))
    ry = torch.ceil(s_fac * torch.sqrt(torch.clamp(cov2d[..., 2], min=1e-12)))
    zero = torch.zeros_like(rx)
    m2d = mean2d.detach()
    rect = tile_rect(m2d, torch.where(visible, rx, zero).detach(), tiles_x,
                     tiles_y, torch.where(visible, ry, zero).detach())
    # the intersect test's cutoff is the kernel's own uncapped alpha cut
    # (power <= ln(255*op)), so culled rect tiles hold no visible pixel
    if opacity is None:
        cutoff = torch.full_like(depth, 0.5 * 3.0 * 3.0).detach()
    else:
        cutoff = torch.log(torch.clamp(
            opacity.detach().reshape(-1) * 255.0, min=1.0 + 1e-6))
    mask, exact = tile_intersect_mask(m2d, conic.detach(), rect, cutoff,
                                      visible)
    tiles = (rect[..., 2] - rect[..., 0]) * (rect[..., 3] - rect[..., 1])
    tiles = torch.where(visible, tiles, torch.zeros_like(tiles))
    radius = torch.where(tiles > 0, radius, torch.zeros_like(radius))
    exact = torch.where(tiles > 0, exact, torch.zeros_like(exact))
    return Projected(mean2d=mean2d, conic=conic, depth=depth, radius=radius,
                     rect=rect, tiles_touched=tiles, cov2d=cov2d,
                     tile_mask=mask, exact_tiles=exact)
