"""L1, SSIM (11x11 gaussian window, sigma 1.5) and PSNR (port of
gssr_tpu/ops/ssim.py).

The 2D window is the outer product of a 1D gaussian, so the blur runs as
two 1D grouped convolutions with zero "same" padding; up to rounding that
is the reference's 11x11 stencil, boundary truncation included. On the
card the convolutions run in full fp32: the package turns cuDNN's TF32
off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x, window_size: int):
    """Separable same-padded gaussian blur of [1, C, H, W]."""
    c = x.shape[1]
    g = torch.as_tensor(_gaussian_1d(window_size), device=x.device)
    pad = window_size // 2
    x = F.conv2d(x, g.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                 padding=(pad, 0), groups=c)
    return F.conv2d(x, g.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                    padding=(0, pad), groups=c)


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM over the image. img1/img2: [H,W,C] in [0,1]."""
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2
    c = img1.shape[-1]
    x = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                  dim=-1).permute(2, 0, 1)[None]
    mu1, mu2, e11, e22, e12 = _blur(x, window_size)[0].split(c, dim=0)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    num = (2 * mu1_mu2 + C1) * (2 * sigma12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    return torch.mean(num / den)


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def psnr(a, b):
    mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(mse + 1e-12)
