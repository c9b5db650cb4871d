"""The launch layer that the three tile-blend families share: vanilla
(ops/blend.py, csrc/blend.cu), surfel (ops/blend2d.py, csrc/blend2d.cu)
and planar (ops/blend_pgsr.py, csrc/blend_pgsr.cu).

Every blend kernel takes the same arguments before its buffers: the
instance attributes [rows, I] float32, attribute-major, with I a multiple
of CHUNK; their count I; `ranges` [T+1] int32, the chunk-aligned per-tile
starts (ops/binning.py); and the tile grid. It runs one block per 16x16
tile on the current stream. `TileKernels` checks those inputs, allocates
a kernel's output, launches it and counts the launch; for CPU tensors it
takes the family's plain version instead. `TileBlend` is every family's
autograd function: the forward kernel in forward, the backward kernel in
backward.
"""
from __future__ import annotations

import ctypes

import torch

from gssr_tpu_torch.ops import _kernels
from gssr_tpu_torch.ops.projection import TILE
from gssr_tpu_torch.utils.tracing import span

CHUNK = 128           # instances per chunk; binning pads ranges to this


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


class TileKernels:
    """One family's kernels: entry points gssr_<name>_<kernel>, each launch
    counted in launches["<name>_<kernel>"]; attributes of `attr_rows` rows,
    maps of `out_rows` channels a pixel, called `maps_name` in the errors."""

    def __init__(self, name: str, attr_rows: int, out_rows: int,
                 maps_name: str, launches: dict):
        self.name, self.attr_rows, self.out_rows = name, attr_rows, out_rows
        self.maps_name, self.launches = maps_name, launches

    def check(self, attrs, ranges, tiles_x: int, tiles_y: int, *maps):
        """Raise ValueError unless the inputs are what the kernels take."""
        if attrs.dtype != torch.float32 or attrs.dim() != 2 \
                or attrs.shape[0] != self.attr_rows \
                or attrs.shape[1] % CHUNK:
            raise ValueError(f"attrs must be float32 [{self.attr_rows}, I] "
                             f"with I a multiple of {CHUNK}, got "
                             f"{attrs.dtype} {tuple(attrs.shape)}")
        if ranges.dtype != torch.int32 \
                or ranges.shape != (tiles_x * tiles_y + 1,):
            raise ValueError("ranges must be int32 [tiles + 1]")
        shape = (tiles_y * TILE, tiles_x * TILE, self.out_rows)
        for m in maps:
            if m.dtype != torch.float32 or tuple(m.shape) != shape:
                raise ValueError(f"{self.maps_name} must be float32 {shape}")
        for x in (attrs, ranges) + maps:
            if x.device != attrs.device or not x.is_contiguous():
                raise ValueError("blend inputs must be contiguous, one "
                                 "device")

    def _launch(self, kernel: str, attrs, ranges, tiles_x: int,
                tiles_y: int, *buffers):
        key = f"{self.name}_{kernel}"
        _kernels.launch(f"gssr_{key}", attrs.device, _ptr(attrs),
                        ctypes.c_int64(attrs.shape[1]), _ptr(ranges),
                        ctypes.c_int(tiles_x), ctypes.c_int(tiles_y),
                        *(_ptr(b) for b in buffers))
        self.launches[key] += 1

    def forward(self, plain, attrs, ranges, tiles_x: int, tiles_y: int):
        """The forward kernel's maps [H, W, out_rows]; plain(attrs,
        ranges, tiles_x, tiles_y) for CPU tensors."""
        if attrs.device.type == "cpu":
            return plain(attrs, ranges, tiles_x, tiles_y)
        self.check(attrs, ranges, tiles_x, tiles_y)
        out = torch.empty((tiles_y * TILE, tiles_x * TILE, self.out_rows),
                          dtype=torch.float32, device=attrs.device)
        self._launch("fwd", attrs, ranges, tiles_x, tiles_y, out)
        return out

    def observe(self, plain, attrs, ranges, tiles_x: int, tiles_y: int):
        """The observe kernel's count per instance slot [I]; plain(...)
        for CPU tensors."""
        if attrs.device.type == "cpu":
            return plain(attrs, ranges, tiles_x, tiles_y)
        self.check(attrs, ranges, tiles_x, tiles_y)
        # chunks past a tile's saturation and slots past ranges[T] stay zero
        obs = torch.zeros(attrs.shape[1], dtype=torch.float32,
                          device=attrs.device)
        self._launch("obs", attrs, ranges, tiles_x, tiles_y, obs)
        return obs

    def backward(self, plain, attrs, ranges, fwd_out, cot, tiles_x: int,
                 tiles_y: int):
        """The backward kernel's d(attrs) [attr_rows, I] from the forward's
        maps and their cotangent; plain(...) for CPU tensors."""
        if attrs.device.type == "cpu":
            return plain(attrs, ranges, fwd_out, cot, tiles_x, tiles_y)
        self.check(attrs, ranges, tiles_x, tiles_y, fwd_out, cot)
        # chunks past a tile's saturation and rows the kernel does not
        # write stay zero
        dattrs = torch.zeros_like(attrs)
        self._launch("bwd", attrs, ranges, tiles_x, tiles_y, fwd_out, cot,
                     dattrs)
        return dattrs


class TileBlend(torch.autograd.Function):
    """A family's forward kernel in forward, its backward kernel in
    backward: apply(fwd, bwd, split, cotangent, attrs, ranges, tiles_x,
    tiles_y), with fwd and bwd the family's wrappers. Forward returns the
    maps, or split(maps) where split is not None; backward hands bwd the
    cotangent that cotangent(*grads of those outputs) makes."""

    @staticmethod
    def forward(ctx, fwd, bwd, split, cotangent, attrs, ranges,
                tiles_x: int, tiles_y: int):
        out = fwd(attrs, ranges, tiles_x, tiles_y)
        ctx.save_for_backward(attrs, ranges, out)
        ctx.bwd, ctx.cotangent = bwd, cotangent
        ctx.tiles = (tiles_x, tiles_y)
        return out if split is None else split(out)

    @staticmethod
    def backward(ctx, *grads):
        with span("render.blend_backward"):
            attrs, ranges, out = ctx.saved_tensors
            d_attrs = ctx.bwd(attrs, ranges, out, ctx.cotangent(*grads),
                              *ctx.tiles)
        return None, None, None, None, d_attrs, None, None, None
