"""Named stages of a training step, as torch.profiler ranges.

`span(name)` is a `torch.profiler.record_function` range while a profiler
records, and a shared no-op context otherwise (one check a span). Its
ranges land in the profiler's trace beside the CUDA kernels and runtime
calls, on the same clock, so a reader can put each kernel (by its
launch) and each idle gap of the device (by its midpoint) down to the
innermost stage the host was in. The benchmark's readers
(portbench/spans.py) do that; they map a span to its stage by the name's
suffix, so the names below are a contract.

Stage spans (where; stage):

* trainer.next_train (engine/trainer.py, the dataloader's next camera;
  dataio), trainer.log (host_metrics at a log point and the progress
  line; loop), trainer.densify (the scene's train_densify; loop).
* vanilla.render_and_loss, .loss, .backward, .adam, .stats
  (scene/vanilla.py::train_step, which twodgs.py inherits);
  pgsr.* (scene/pgsr.py::train_step; past multi_view_from its step
  adds pgsr.near_render, the neighbour camera's render, whose kernels
  stay in their render.* stages, and pgsr.multiview inside pgsr.loss,
  the normal, geo and NCC terms, stage loss: neither suffix names a
  stage); scaffold.prefilter, .decode,
  .render_and_loss, .loss, .backward, .adam, .stats
  (scene/scaffold.py::train_step, which the octree, anchor-surfel and
  anchor-planar scenes inherit); past multi_view_from the anchor-planar
  step (scene/scaffold_pgsr.py::step_terms, scaffold-pgsr and
  octree-pgsr) adds, inside scaffold.loss, scaffold.near_render, the
  neighbour camera's prefilter, level gate, decode and render forward
  (its own scaffold.prefilter and scaffold.decode inside it, its render
  kernels in their render.* stages, the rest stage loss), and
  scaffold.multiview, the normal, geo and NCC terms (stage loss).
  `*.render_and_loss` names no stage of its own: its
  renders are render.* and its losses `*.loss` (stage loss); `*.backward`
  is autograd's own backward (stage backward), `*.adam` and `*.stats` the
  update (stage update), `*.prefilter` and `*.decode` their own.
* render.preprocess (projection, and the planar geometry of
  ops/rasterize_pgsr.py), render.color (SH; absent for precomputed
  colours) (stage preprocess); render.binning (binning); render.blend
  (the instance gather, the blend forward and the maps' crop and
  composite) and render.blend_backward (the blend kernels' backward, on
  autograd's thread) (blend); render.gather_backward (the gather's
  per-gaussian float64 sum in binning's order, one kernel launch,
  ops/blend.py::_GatherRows.backward; gather_bwd).
  The render.* ranges wrap the calls in ops/rasterize.py,
  rasterize2d.py and rasterize_pgsr.py, not ops/projection.py, so that
  the anchor prefilter's own preprocess stays in scaffold.prefilter.

Sync spans, `sync.<site>`: each wraps one host sync with the device (a
read of a device value, a boolean-mask index or a nonzero, or an upload
from pageable host memory, which PyTorch follows with a stream
synchronize); a sync span counts as its parent stage. Their number per
step is the number of syncs, their length the host's wait:

* sync.camera: each of the nine uploads of a camera's arrays
  (cameras/__init__.py::Camera.arrays), once per render camera;
* sync.gt_frame: the upload of a camera's target frame, the first time
  the scene's cache meets it (scene/vanilla.py::gt_device);
* sync.conic_level: the upload of the surfel cutoff level
  (ops/projection2d.py::_conic_aabb), once per surfel render;
* sync.binning: the padded instance total that sizes a render's
  instance buffer (ops/binning.py::bin_gaussians), binning's only sync;
* sync.blend_rows: the surfel backward's upload of the rows it zeroes
  and of their zero (ops/blend2d.py::_cotangent), two per
  surfel render;
* sync.ssim_window: the upload of the SSIM window (ops/ssim.py);
* sync.sample_clip: each of the two bound uploads of a clamp in the
  PGSR losses' sampling (ops/sampling.py::_clip): two per bilinear
  coordinate, four per bilinear sample and two per patch NCC, so 14 a
  two-camera PGSR step (its geo sample, both NCC samples and the NCC);
* sync.near_gray: the upload of a neighbour camera's frame for its
  grayscale, the first time the PGSR scene's cache meets it
  (scene/pgsr.py::near_for);
* sync.grad_scale: the upload of the screen-gradient scale
  (models/vanilla.py::ndc_grad_scale), once per step in `*.stats`;
* sync.decode: the nonzero that sizes the anchor decode
  (models/scaffold.py::decode);
* sync.lod: the four float32 constants of the octree's LOD mask
  (models/octree.py::pred_int_level and _pred_level);
* sync.scaling_loss: the backward of the scaling loss's product, which
  counts its input's zeros on the host (scene/scaffold.py::scaling_loss,
  through span_backward);
* sync.log: a log point's metrics to the host (engine/trainer.py::
  host_metrics); sync.progress: the progress line's active count.

Metrics (BENCHMARK.json, portbench/metrics/): idle.<stage>_ms and
device.<stage>_ms per stage; dataio.host_ms (trainer.next_train's host
time); host_syncs_per_step (the sync spans' count), host_sync_wait_ms
(their host time) and unmarked_syncs_per_step (synchronizing runtime
calls in no sync span: 0 when this list is complete); anchor.prefilter_ms
(scaffold.prefilter's host time); near_render.device_ms,
multiview.device_ms, multiview.idle_ms and multiview.syncs_per_step
(pgsr.near_render and pgsr.multiview, read by the spans' names);
anchor_near.device_ms, anchor_near.idle_ms and anchor_near.syncs_per_step
(scaffold.near_render and scaffold.multiview).
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range called `name` while a profiler records; the shared
    no-op context OFF otherwise."""
    if not torch.autograd._profiler_enabled():
        return OFF
    return record_function(name)


def span_backward(name: str, tensor):
    """`tensor`, whose autograd node's backward runs inside a range called
    `name` while a profiler records (the node's pre-hook opens it, its
    post-hook closes it): for a sync inside a built-in op's backward,
    which no Python code wraps. Without a profiler, `tensor` as it is."""
    node = tensor.grad_fn
    if node is None or not torch.autograd._profiler_enabled():
        return tensor
    opened = []

    def enter(grad_outputs):
        opened.append(record_function(name).__enter__())

    def leave(grad_inputs, grad_outputs):
        opened.pop().__exit__(None, None, None)

    node.register_prehook(enter)
    node.register_hook(leave)
    return tensor
