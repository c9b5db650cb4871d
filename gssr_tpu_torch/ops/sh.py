"""Real spherical-harmonics evaluation (port of gssr_tpu/ops/sh.py).

Coefficient layout: [..., K, C] with K = (deg+1)^2, DC first. Degrees 0-3
are the ones 3DGS trains; degree 4 waits for a method that needs it.

The renders' colour, `sh_to_color`, takes the model's two coefficient
tensors where they lie, f_dc [C,1,3] and f_rest [C,K-1,3]. On CUDA
tensors it is one autograd Function whose forward and backward are the
kernels of csrc/sh.cu (`sh_fwd`, `sh_bwd`): the forward equals the eager
chain bit for bit, the backward writes dense gradients (zero past the
degree) with no atomics. `sh_to_color_plain`, the eager chain, and
`sh_bwd_plain`, autograd's gradients of it, are their plain versions,
which CPU tensors take.
"""
from __future__ import annotations

import ctypes

import torch

from gssr_tpu_torch.ops import _kernels

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

# kernel launches since the last reset (the CPU plain path is not counted)
LAUNCHES = {"sh_fwd": 0, "sh_bwd": 0}


def rgb_to_sh(rgb):
    """RGB in [0,1] -> DC SH coefficient."""
    return (rgb - 0.5) / C0


def eval_sh(deg: int, sh, dirs):
    """Evaluate SH at unit directions. sh: [..., K, C] with
    K >= (deg+1)^2 (extra coefficients are ignored); dirs: [..., 3].
    Returns [..., C]."""
    assert 0 <= deg <= 3
    result = C0 * sh[..., 0, :]
    if deg == 0:
        return result
    x = dirs[..., 0:1]
    y = dirs[..., 1:2]
    z = dirs[..., 2:3]
    result = (result - C1 * y * sh[..., 1, :] + C1 * z * sh[..., 2, :]
              - C1 * x * sh[..., 3, :])
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + C2[0] * xy * sh[..., 4, :]
                  + C2[1] * yz * sh[..., 5, :]
                  + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                  + C2[3] * xz * sh[..., 7, :]
                  + C2[4] * (xx - yy) * sh[..., 8, :])
        if deg > 2:
            result = (result
                      + C3[0] * y * (3 * xx - yy) * sh[..., 9, :]
                      + C3[1] * xy * z * sh[..., 10, :]
                      + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11, :]
                      + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12, :]
                      + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13, :]
                      + C3[5] * z * (xx - yy) * sh[..., 14, :]
                      + C3[6] * x * (xx - 3 * yy) * sh[..., 15, :])
    return result


def sh_to_color_plain(deg: int, sh, means3d, campos):
    """SH -> RGB as the rasterizer preprocess does: +0.5, clamped at 0.
    sh: [..., K, 3]."""
    dirs = means3d - campos
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    rgb = eval_sh(deg, sh, dirs) + 0.5
    return torch.clamp(rgb, min=0.0)


def sh_to_color(deg: int, sh, means3d, campos):
    """The renders' colour [C,3] from sh, the pair (f_dc [C,1,3], f_rest
    [C,K-1,3]) as the model holds them or one [C,K,3] tensor, means3d
    [C,3] and campos [3]: the kernels of csrc/sh.cu for CUDA tensors
    (sh_fwd, and sh_bwd in the backward), sh_to_color_plain for CPU
    ones."""
    pair = isinstance(sh, tuple)
    if means3d.device.type != "cuda":
        return sh_to_color_plain(deg, torch.cat(sh, 1) if pair else sh,
                                 means3d, campos)
    f_dc, f_rest = sh if pair else (sh[:, :1], sh[:, 1:])
    return SHColor.apply(means3d.contiguous(), f_dc.contiguous(),
                         f_rest.contiguous(), campos.contiguous(), deg)


class SHColor(torch.autograd.Function):
    """clamp(eval_sh + 0.5, min 0) of the direction from campos to each
    mean, from the coefficients where they lie. It saves its inputs alone
    (the backward recomputes the direction and the colour), and its
    backward gives dense, contiguous d_f_dc and d_f_rest, zero past the
    degree, as autograd's of the plain chain does."""

    @staticmethod
    def forward(ctx, means3d, f_dc, f_rest, campos, deg):
        ctx.deg = deg
        ctx.save_for_backward(means3d, f_dc, f_rest, campos)
        return sh_fwd(deg, means3d, f_dc, f_rest, campos)

    @staticmethod
    def backward(ctx, d_color):
        means3d, f_dc, f_rest, campos = ctx.saved_tensors
        d_means, d_dc, d_rest = sh_bwd(ctx.deg, means3d, f_dc, f_rest,
                                       campos, d_color.contiguous())
        if not ctx.needs_input_grad[0]:
            d_means = None
        return d_means, d_dc, d_rest, None, None


def _check(deg, means3d, f_dc, f_rest, campos, *more):
    """The kernels' inputs: float32, contiguous, on one CUDA device, at a
    degree that f_rest's rows cover."""
    n = means3d.shape[0]
    rest = f_rest.shape[1] if f_rest.dim() == 3 else -1
    if not 0 <= deg <= 3 or not (deg + 1) ** 2 - 1 <= rest <= 15:
        raise ValueError(f"sh_fwd takes degree 0-3 and f_rest [C, K-1, 3] "
                         f"with (degree+1)^2 - 1 <= K-1 <= 15, got degree "
                         f"{deg} and f_rest {tuple(f_rest.shape)}")
    for t, shape in ((means3d, (n, 3)), (f_dc, (n, 1, 3)),
                     (f_rest, (n, rest, 3)), (campos, (3,)),
                     *((t, (n, 3)) for t in more)):
        if t.dtype != torch.float32 or t.shape != shape \
                or t.device != means3d.device or not t.is_contiguous():
            raise ValueError(f"sh_fwd takes contiguous float32 {shape} on "
                             f"{means3d.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return n, rest


def _ptrs(*tensors):
    return [ctypes.c_void_p(t.data_ptr()) for t in tensors]


def sh_fwd(deg: int, means3d, f_dc, f_rest, campos):
    """The colour [C,3]: csrc/sh.cu's forward kernel for CUDA tensors, bit
    for bit sh_to_color_plain, which CPU tensors take. One launch, none
    for C = 0."""
    if means3d.device.type != "cuda":
        return sh_to_color_plain(deg, torch.cat([f_dc, f_rest], 1), means3d,
                                 campos)
    n, rest = _check(deg, means3d, f_dc, f_rest, campos)
    color = torch.empty((n, 3), dtype=torch.float32, device=means3d.device)
    if n:
        _kernels.launch("gssr_sh_fwd", means3d.device,
                        *_ptrs(means3d, campos, f_dc, f_rest),
                        ctypes.c_int64(n), ctypes.c_int(rest),
                        ctypes.c_int(deg), *_ptrs(color))
        LAUNCHES["sh_fwd"] += 1
    return color


def sh_bwd(deg: int, means3d, f_dc, f_rest, campos, d_color):
    """(d_means [C,3], d_f_dc [C,1,3], d_f_rest [C,K-1,3]) from the
    colour's cotangent d_color [C,3]: csrc/sh.cu's backward kernel for
    CUDA tensors, sh_bwd_plain for CPU ones. One launch, none for C = 0;
    no atomics."""
    if means3d.device.type != "cuda":
        return sh_bwd_plain(deg, means3d, f_dc, f_rest, campos, d_color)
    n, rest = _check(deg, means3d, f_dc, f_rest, campos, d_color)
    d_means = torch.empty_like(means3d)
    d_dc = torch.empty_like(f_dc)
    d_rest = torch.empty_like(f_rest)
    if n:
        _kernels.launch("gssr_sh_bwd", means3d.device,
                        *_ptrs(means3d, campos, f_dc, f_rest, d_color),
                        ctypes.c_int64(n), ctypes.c_int(rest),
                        ctypes.c_int(deg), *_ptrs(d_means, d_dc, d_rest))
        LAUNCHES["sh_bwd"] += 1
    return d_means, d_dc, d_rest


def sh_bwd_plain(deg: int, means3d, f_dc, f_rest, campos, d_color):
    """sh_bwd's plain version: autograd's gradients of sh_to_color_plain,
    (d_means, d_f_dc, d_f_rest), contiguous, zero where the chain does not
    reach an input."""
    leaves = [t.detach().requires_grad_() for t in (means3d, f_dc, f_rest)]
    with torch.enable_grad():
        color = sh_to_color_plain(deg, torch.cat(leaves[1:], 1), leaves[0],
                                  campos)
        grads = torch.autograd.grad(color, leaves, d_color,
                                    allow_unused=True, materialize_grads=True)
    return tuple(g.contiguous() for g in grads)
