"""Tile binning: duplicate gaussians into (tile, depth)-sorted instances
(port of the chunked path of gssr_tpu/ops/binning.py).

The layout is the reference's, because the blend kernels rely on it:

* per-tile instance ranges padded to a multiple of `chunk`, so every
  128-instance chunk belongs to exactly one tile;
* filler instances in the padding slots with `hit = 0` (blend as exact
  alpha = 0 no-ops and receive zero gradient);
* one stable sort of a fused int32 (tile | quantized depth) key, whose
  top bit is flipped so signed order equals unsigned order;
* the `gid_reduce` / `seg_bounds` pair behind the deterministic
  per-gaussian gradient sum.

The reference's `chunk_map` / `n_live_chunks` (chunk -> tile, for its flat
chunk grid) are not built: the CUDA kernels run one block per tile and
read only `tile_ranges`.

Unlike the reference's static capacity, the instance buffer is sized
exactly for each render: the padded total rounded up to a chunk (one host
sync per render, in the span sync.binning, the only one binning makes).
So it can never overflow and `overflow` is always false.

Each slot's sort key and payload (`expand_instances`) come, for CUDA
tensors, from the kernel of csrc/binning.cu; `expand_instances_plain`,
its plain version, is taken for CPU tensors only.

All index math here is non-differentiable; callers pass detached inputs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gssr_tpu_torch.ops import _kernels
from gssr_tpu_torch.utils.tracing import span

# kernel launches since the last reset (the CPU plain path is not counted)
LAUNCHES = {"bin_expand": 0}


class Binning(NamedTuple):
    gauss_id: torch.Tensor       # [I] int32 source gaussian per slot
    tile_ranges: torch.Tensor    # [num_tiles + 1] int32 chunk-aligned starts
    num_rendered: torch.Tensor   # [] int32 real (rect-slot) instances
    overflow: torch.Tensor       # [] bool, always false (exact sizing)
    tile_counts: torch.Tensor    # [num_tiles] int32 unpadded counts
    hit: torch.Tensor            # [I] float32 in {0, 1}
    gid_reduce: torch.Tensor     # [I] int32 gaussian id, sentinel N if none
    seg_bounds: torch.Tensor     # [N + 1] int32 per-gaussian segment starts


def tile_cover_counts(rect, visible, tiles_x: int, tiles_y: int):
    """Per-tile rect-coverage counts as one matmul of 0/1 interval
    indicators, count = U^T V. Exact only in full fp32 (counts < 2^24);
    the package turns TF32 off for that reason among others."""
    dev = rect.device
    ty = torch.arange(tiles_y, dtype=torch.int32, device=dev)
    tx = torch.arange(tiles_x, dtype=torch.int32, device=dev)
    v = visible[:, None]
    U = ((rect[:, 1:2] <= ty[None, :]) & (ty[None, :] < rect[:, 3:4])
         & v).float()
    V = ((rect[:, 0:1] <= tx[None, :]) & (tx[None, :] < rect[:, 2:3])
         & v).float()
    return (U.T @ V).reshape(-1).to(torch.int32)


def expand_instances(rect, depth, tile_mask, offsets, fill_starts,
                     num_rendered, instance_cap: int, tiles_x: int,
                     depth_bits: int):
    """expand_instances_plain's (key, payload), from csrc/binning.cu's
    kernel for CUDA tensors, bit for bit the same: one launch, no host
    sync."""
    if depth.device.type != "cuda":
        return expand_instances_plain(rect, depth, tile_mask, offsets,
                                      fill_starts, num_rendered,
                                      instance_cap, tiles_x, depth_bits)
    n, dev = depth.shape[0], depth.device
    num_tiles = fill_starts.shape[0] - 1
    args = [(rect, torch.int32, (n, 4)), (depth, torch.float32, (n,)),
            (offsets, torch.int32, (n,)),
            (fill_starts, torch.int32, (num_tiles + 1,)),
            (num_rendered, torch.int32, ())]
    if tile_mask is not None:
        args.append((tile_mask, torch.int32, (n,)))
    for t, dtype, shape in args:
        if t.dtype != dtype or t.shape != shape or t.device != dev:
            raise ValueError(f"expand_instances takes {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if not 0 < instance_cap < 2 ** 31:
        raise ValueError(f"instance_cap {instance_cap} is not a positive "
                         "int32")
    # kept referenced until the launch has been enqueued; no mask is a
    # null pointer
    ins = [None if t is None else t.contiguous()
           for t in (rect, depth, tile_mask, offsets, fill_starts,
                     num_rendered)]
    key = torch.empty(instance_cap, dtype=torch.int32, device=dev)
    payload = torch.empty_like(key)
    _kernels.launch("gssr_bin_expand", dev,
                    *(ctypes.c_void_p(None if t is None else t.data_ptr())
                      for t in ins),
                    ctypes.c_int64(n), ctypes.c_int64(instance_cap),
                    ctypes.c_int(tiles_x), ctypes.c_int(num_tiles),
                    ctypes.c_int(depth_bits),
                    ctypes.c_void_p(key.data_ptr()),
                    ctypes.c_void_p(payload.data_ptr()))
    LAUNCHES["bin_expand"] += 1
    return key, payload


def expand_instances_plain(rect, depth, tile_mask, offsets, fill_starts,
                           num_rendered, instance_cap: int, tiles_x: int,
                           depth_bits: int):
    """Every instance slot's sort key (already ^ sign) and payload, in slot
    order: [instance_cap] int32 each.

    rect [N,4] int32, depth [N] float32, tile_mask [N] int32 or None as
    bin_gaussians takes them; offsets [N] int32 the inclusive sum of the
    rect areas (tiles_touched); fill_starts [T + 1] int32 the filler runs'
    starts, one a tile in tile order after the num_rendered real slots,
    and their end; num_rendered [] int32. Real slots [0, num_rendered)
    carry their gaussian's (tile, quantized depth) key and the payload
    bits 0-28 gaussian index, 29 real-instance flag, 30 hit; filler slots
    their tile with an all-ones depth and payload 0.
    """
    dev = depth.device
    i32 = dict(dtype=torch.int32, device=dev)
    n = depth.shape[0]
    num_tiles = fill_starts.shape[0] - 1
    sign = -(2 ** 31)
    tag = 1 << 30
    tidx = torch.arange(num_tiles, **i32)
    tiles_touched = torch.diff(offsets, prepend=torch.zeros(1, **i32))
    pad_counts = torch.diff(fill_starts)
    fill_starts = fill_starts[:-1]

    # instance -> gaussian (and filler slot -> tile) through one scatter of
    # segment-start marks and a running max: real slots carry gaussian+1,
    # filler segments their tile id+1 tagged with bit 30 so they dominate.
    # Runs with no slot scatter to a dump slot past the end.
    starts = offsets - tiles_touched
    ii = torch.arange(instance_cap, **i32)
    marks = torch.zeros(instance_cap + 1, **i32)
    marks[torch.where(tiles_touched > 0, starts,
                      instance_cap).long()] = torch.arange(n, **i32) + 1
    fill_pos = torch.where(pad_counts > 0, fill_starts, instance_cap)
    marks = marks.scatter_reduce(0, fill_pos.long(), tag | (tidx + 1),
                                 "amax")[:instance_cap]
    v = torch.cummax(marks, 0).values
    g_c = torch.clamp(v - 1, 0, max(n - 1, 0))

    # one packed gather of the per-gaussian fields; rect fits one int32
    rect_w = torch.clamp(rect[:, 2] - rect[:, 0], min=1)
    rect_pack = rect[:, 0] | (rect[:, 1] << 10) | ((rect_w - 1) << 20)
    rcp_w = (1.0 / rect_w.float()).view(torch.int32)
    cols = [rect_pack, starts, depth.float().view(torch.int32), rcp_w]
    if tile_mask is not None:
        cols.append(tile_mask.to(torch.int32))
    table = torch.stack(cols, dim=1)
    if n == 0:
        # no gaussian (an anchor render with no visible anchor): every
        # slot is a filler, which reads one zero row
        table = table.new_zeros((1, table.shape[1]))
    r = table[g_c.long()]
    x0 = r[:, 0] & 0x3FF
    y0 = (r[:, 0] >> 10) & 0x3FF
    rw = ((r[:, 0] >> 20) & 0x3FF) + 1
    local = ii - r[:, 1]
    if tile_mask is not None:
        hit = (((r[:, 4] >> torch.clamp(local, max=31)) & 1) == 1) \
            | (local >= 32)
    else:
        hit = torch.ones_like(local, dtype=torch.bool)
    # local // rw through the f32 reciprocal: off by at most one, fixed by
    # the remainder test
    rcp = r[:, 3].view(torch.float32)
    q0 = torch.floor(torch.clamp(local, min=0).float() * rcp).to(torch.int32)
    r0 = local - q0 * rw
    ty_off = q0 + (r0 >= rw).to(torch.int32) - (r0 < 0).to(torch.int32)
    tx = x0 + local - ty_off * rw
    ty = y0 + ty_off
    tile_id = ty * tiles_x + tx

    # payload bits: 0-28 gaussian index, 29 real-instance flag, 30 hit
    dq = (r[:, 2] >> (31 - depth_bits)) & ((1 << depth_bits) - 1)
    key = (tile_id << depth_bits) | dq
    payload = g_c | (hit.to(torch.int32) << 30) | (1 << 29)

    # filler keys: their tile with an all-ones depth, so they sort after
    # every real instance of the tile
    fill_tile = torch.clamp((v & (tag - 1)) - 1, 0, num_tiles)
    fill_key = (fill_tile << depth_bits) | ((1 << depth_bits) - 1)
    is_real = ii < num_rendered
    key = torch.where(is_real, key, fill_key) ^ sign
    payload = torch.where(is_real, payload, torch.zeros_like(payload))
    return key, payload


def bin_gaussians(rect, depth, tiles_touched, tiles_x: int, tiles_y: int,
                  tile_mask=None, chunk: int = 128,
                  key_tiles: Optional[int] = None) -> Binning:
    """Build the depth-sorted, chunk-padded per-tile instance list.

    rect: [N,4] int32 tile rects (exclusive max); depth: [N] float32
    view-space depth; tiles_touched: [N] int32 rect area (0 = culled);
    tile_mask: [N] int32 exact ellipse-tile bits over the first 32 rect
    tiles (non-hit rect slots become hit = 0 no-op lanes), or None: every
    rect slot of a real instance is a hit (the 2DGS path). Fillers get
    hit = 0 either way. key_tiles: the tile count whose bit width the sort
    key gives the tile id (default tiles_x * tiles_y); a band of a frame
    passes the frame's, so that its depths quantize as the frame's do and
    its instances sort in the frame's order.
    """
    dev = depth.device
    i32 = dict(dtype=torch.int32, device=dev)
    num_tiles = tiles_x * tiles_y
    n = depth.shape[0]
    assert tiles_x <= 1024, "rect pack field overflow"
    assert n < (1 << 29), "gaussian capacity exceeds payload index bits"
    tile_bits = max(1, int((key_tiles or num_tiles) + 1).bit_length())
    depth_bits = 32 - tile_bits

    counts = tile_cover_counts(rect, tiles_touched > 0, tiles_x, tiles_y)
    num_rendered = tiles_touched.sum(dtype=torch.int32)
    padded_counts = (counts + chunk - 1) // chunk * chunk
    padded_starts = torch.cat([torch.zeros(1, **i32),
                               torch.cumsum(padded_counts, 0,
                                            dtype=torch.int32)])
    with span("sync.binning"):
        instance_cap = max(int(padded_starts[-1]), chunk)
    offsets = torch.cumsum(tiles_touched, 0, dtype=torch.int32)
    # the filler runs' starts, one a tile, and their end: after the real
    # slots, each tile's padding in tile order
    fill_starts = num_rendered + torch.cat(
        [torch.zeros(1, **i32),
         torch.cumsum(padded_counts - counts, 0, dtype=torch.int32)])
    key, payload = expand_instances(rect, depth, tile_mask, offsets,
                                    fill_starts, num_rendered, instance_cap,
                                    tiles_x, depth_bits)
    _, order = torch.sort(key, stable=True)
    spayload = payload[order]
    gauss_id = spayload & 0x1FFFFFFF
    hit = (spayload >> 30).float()
    gid_reduce = torch.where(((spayload >> 29) & 1) == 1, gauss_id,
                             torch.full_like(gauss_id, n))
    seg_bounds = torch.cat([torch.zeros(1, **i32), offsets])

    return Binning(gauss_id=gauss_id, tile_ranges=padded_starts,
                   num_rendered=num_rendered,
                   overflow=torch.zeros((), dtype=torch.bool, device=dev),
                   tile_counts=counts, hit=hit, gid_reduce=gid_reduce,
                   seg_bounds=seg_bounds)
