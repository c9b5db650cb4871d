"""Bilinear image sampling with border clamp (port of the part of
gssr_tpu/ops/sampling.py that TSDF fusion uses).

The reference builds a quad table of 2x2 footprints and switches to four
1-D gathers above 2^23 taps; both are TPU layout workarounds with the
same values as the four corner gathers here.
"""
from __future__ import annotations

import torch


def bilinear_sample_xy(img, x, y):
    """Sample img [H,W] or [H,W,C] at pixel coordinates x, y (separate
    [...] tensors) with border clamp, as F.grid_sample(align_corners=True,
    padding_mode='border') after a [-1, 1] normalisation round trip.
    Corners anchor at (clip(floor), <= size-2), so the footprint is always
    in bounds; at the right and bottom border the weight saturates to 1 on
    the edge texel."""
    H, W = img.shape[:2]
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x), 0.0, W - 2.0)
    y0 = torch.clamp(torch.floor(y), 0.0, H - 2.0)
    wx = x - x0
    wy = y - y0
    base = (y0.long() * W + x0.long()).reshape(-1)
    f = img.reshape((H * W,) + img.shape[2:])
    v00, v01, v10, v11 = f[base], f[base + 1], f[base + W], f[base + W + 1]
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
