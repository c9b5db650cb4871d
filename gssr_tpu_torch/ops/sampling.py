"""Image sampling, patch warp and NCC primitives of the PGSR losses, and the
bilinear sampling of TSDF fusion (port of gssr_tpu/ops/sampling.py).

The reference builds a quad table of 2x2 footprints and switches to four
1-D gathers above 2^23 taps; both are TPU layout workarounds with the
same values as the four corner gathers here. Each corner gather's backward
is the sorted segment sum of ops/blend.py, so a gradient through sampled
texels (PGSR's geo loss samples a rendered depth map) is reproducible run
to run: an advanced-index gather's backward would accumulate with atomics
on the card. Clamps that a gradient passes through are a maximum then a
minimum, as the reference's `jnp.clip` is, so that a coordinate exactly on
a bound splits its gradient between the two sides as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from gssr_tpu_torch.ops.blend import CHUNK, segment_sum_sorted
from gssr_tpu_torch.utils.tracing import span


def _clip(x, lo: float, hi: float):
    """jnp.clip's max-then-min, with its even split of a tie's gradient."""
    with span("sync.sample_clip"):
        lo_t = x.new_tensor(lo)
    with span("sync.sample_clip"):
        hi_t = x.new_tensor(hi)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


class _GatherTexels(torch.autograd.Function):
    """f[idx] over the rows of f [N, ...]; the backward sums the
    cotangents per row with the sorted segment sum, without atomics."""

    @staticmethod
    def forward(ctx, f, idx):
        ctx.save_for_backward(idx)
        ctx.rows = f.shape[0]
        return f[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n, m = ctx.rows, idx.shape[0]
        pad = -m % CHUNK
        gid = torch.cat([idx, idx.new_full((pad,), n)]).to(torch.int32)
        vals = torch.cat([g.reshape(m, -1), g.new_zeros(pad, g[0].numel())])
        bounds = torch.searchsorted(
            torch.sort(gid).values,
            torch.arange(n + 1, dtype=torch.int32, device=idx.device))
        out = segment_sum_sorted(vals, gid, bounds)
        return out.reshape((n,) + g.shape[1:]), None


def bilinear_sample_xy(img, x, y):
    """Sample img [H,W] or [H,W,C] at pixel coordinates x, y (separate
    [...] tensors) with border clamp, as F.grid_sample(align_corners=True,
    padding_mode='border') after a [-1, 1] normalisation round trip.
    Corners anchor at (clip(floor), <= size-2), so the footprint is always
    in bounds; at the right and bottom border the weight saturates to 1 on
    the edge texel."""
    H, W = img.shape[:2]
    x = _clip(x, 0.0, W - 1.0)
    y = _clip(y, 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x), 0.0, W - 2.0)
    y0 = torch.clamp(torch.floor(y), 0.0, H - 2.0)
    wx = x - x0
    wy = y - y0
    base = (y0.long() * W + x0.long()).reshape(-1)
    f = img.reshape((H * W,) + img.shape[2:])
    v00, v01, v10, v11 = (_GatherTexels.apply(f, base + k)
                          for k in (0, 1, W, W + 1))
    if img.dim() == 3:
        wx = wx.reshape(-1, 1)
        wy = wy.reshape(-1, 1)
    else:
        wx = wx.reshape(-1)
        wy = wy.reshape(-1)
    out = (1 - wy) * ((1 - wx) * v00 + wx * v01) \
        + wy * ((1 - wx) * v10 + wx * v11)
    return out.reshape(x.shape + img.shape[2:])


def bilinear_sample(img, xy):
    """bilinear_sample_xy with the coordinates stacked as xy [..., 2]."""
    return bilinear_sample_xy(img, xy[..., 0], xy[..., 1])


def patch_offsets(half: int, device=None):
    """[(2h+1)^2, 2] integer offsets (x, y), y fastest."""
    r = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(r, r, indexing="xy")
    return torch.stack([oy, ox], dim=-1).reshape(-1, 2).flip(-1)


def patch_warp(Hmat, uv):
    """Apply per-sample homographies. Hmat [N,3,3], uv [N,P,2] -> [N,P,2]."""
    homo = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    out = torch.einsum("nij,npj->npi", Hmat, homo)
    return out[..., :2] / (out[..., 2:] + 1e-10)


def lncc(ref, nea):
    """Local NCC over flattened patches. ref/nea: [N, P]. Returns
    (ncc [N], mask [N]): ncc clamped to [0, 2], mask = ncc < 0.9."""
    P = ref.shape[-1]
    ref_sum = ref.sum(-1)
    nea_sum = nea.sum(-1)
    ref2_sum = (ref * ref).sum(-1)
    nea2_sum = (nea * nea).sum(-1)
    ref_nea_sum = (ref * nea).sum(-1)
    ref_avg = ref_sum / P
    nea_avg = nea_sum / P
    cross = ref_nea_sum - nea_avg * ref_sum
    ref_var = ref2_sum - ref_avg * ref_sum
    nea_var = nea2_sum - nea_avg * nea_sum
    cc = cross * cross / (ref_var * nea_var + 1e-8)
    ncc = _clip(1.0 - cc, 0.0, 2.0)
    return ncc, ncc < 0.9


def dilate(img, ksize: int = 5):
    """Max-pool dilation with reflect padding. img: [H,W]."""
    pad = (ksize - 1) // 2
    x = F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")
    return F.max_pool2d(x, ksize, stride=1)[0, 0]


def erode(img, ksize: int = 5):
    return 1.0 - dilate(1.0 - img, ksize)


def image_grad_weight(img):
    """Normalised max |central difference| per pixel, border 1. img:
    [H,W,C] -> [H,W]."""
    gx = (img[1:-1, 2:] - img[1:-1, :-2]).abs().mean(-1)
    gy = (img[:-2, 1:-1] - img[2:, 1:-1]).abs().mean(-1)
    g = torch.maximum(gx, gy)
    g = (g - g.min()) / (g.max() - g.min() + 1e-12)
    return F.pad(g, (1, 1, 1, 1), value=1.0)


def rgb_to_gray(img):
    """torchvision Grayscale weights (ITU-R 601-2)."""
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
