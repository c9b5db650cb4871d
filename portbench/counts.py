"""The work a step needs, and the card's peaks: the arithmetic behind the
rooflines and step_mfu_pct.

The peaks and the per-pair operation counts are chip_smoke.py's (its
`bound` and the constants above it, counted from the blend kernels: the exp
as one operation). They are applied here to the pairs and instances the
inputs need, as the configuration's reference counts them from the model
and the camera (never from the program's own buffers): a contributing
(pixel, gaussian) pair, one with a blend weight, and a (tile, gaussian)
instance that holds one. Whatever else a blend evaluates adds nothing to
the image, so no implementation needs less, and a share of these bounds
cannot pass 100 %. Each input byte is counted once and each output byte
once.
"""
from __future__ import annotations

# NVIDIA H100 SXM, data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

# operations per contributing pair of the vanilla blend (csrc/blend.cu)
VANILLA_FWD_OPS = 28
VANILLA_BWD_OPS = 56

# per contributing pair of the surfel blend (csrc/blend2d.cu): the
# intersection and the walk, then the sums forward, the gradient terms
# backward
SURFEL_PAIR_OPS = 49
SURFEL_FWD_CONTRIB_OPS = 30
SURFEL_BWD_CONTRIB_OPS = 103
# a surfel instance's attributes (mean 2, three invariants 9, Tw 3,
# opacity, colour 3, normal 3) and a pixel's 16 output maps, float32
SURFEL_INSTANCE_BYTES = 21 * 4
SURFEL_PIXEL_BYTES = 16 * 4

# a blend instance's attributes (mean 2, conic 3, opacity, colour 3) and a
# pixel's output (colour 3 and the transmittance), float32
INSTANCE_BYTES = 9 * 4
PIXEL_BYTES = 4 * 4

# the rest of a step, per element, forward and backward together: the L1 +
# D-SSIM loss per pixel channel (five 11-tap separable blurs, 2 x 2 x 11
# operations each, twice for the backward, and ~40 of pointwise terms);
# Adam per parameter element (the two moments, the bias corrections, the
# update); a gaussian's projection, covariance and degree-3 SH colour per
# visible gaussian (~250 forward, twice that backward)
LOSS_OPS_PER_CHANNEL = 5 * 2 * 2 * 11 * 3 + 40
ADAM_OPS_PER_ELEMENT = 12
GAUSSIAN_OPS = 750
VANILLA_ELEMENTS = 3 + 3 + 45 + 3 + 4 + 1


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the FP32 peak or
    bytes at the memory rate, whichever is longer."""
    return max(ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES)


def blend_bytes(instances: int, pixels: int, backward: bool) -> int:
    """Forward: the instances in, the image out. Backward: the instances,
    the forward's image and its cotangent in, the instances' gradients
    out."""
    if backward:
        return 2 * instances * INSTANCE_BYTES + 2 * pixels * PIXEL_BYTES
    return instances * INSTANCE_BYTES + pixels * PIXEL_BYTES


def vanilla_step(pairs: int, instances: int, visible: int, capacity: int,
                 width: int, height: int) -> dict:
    """One 3dgs training step's least work: each blend kernel's operations
    and bytes, and the whole step's operations."""
    pixels = width * height
    fwd = {"ops": VANILLA_FWD_OPS * pairs,
           "bytes": blend_bytes(instances, pixels, False)}
    bwd = {"ops": VANILLA_BWD_OPS * pairs,
           "bytes": blend_bytes(instances, pixels, True)}
    step = (fwd["ops"] + bwd["ops"] + LOSS_OPS_PER_CHANNEL * 3 * pixels
            + ADAM_OPS_PER_ELEMENT * VANILLA_ELEMENTS * capacity
            + GAUSSIAN_OPS * visible)
    return {"blend_fwd": fwd, "blend_bwd": bwd, "step": {"ops": step}}


# the anchor step's decode per visible anchor: three 2-layer heads of width
# feat_dim on feat_dim + 3 inputs, forward and backward (3 x 2 x 2 per
# multiply-add); its surfel's preprocess per drawn surfel (~300 forward,
# twice that backward); Adam per anchor element (offsets, features, scales,
# position, rotation, opacity)
SURFEL_OPS = 900


def surfel_step(pairs: int, instances: int, anchors: int, surfels: int,
                capacity: int, width: int, height: int, st: dict) -> dict:
    """One octree-2dgs training step's least work: each surfel blend
    kernel's operations and bytes, and the whole step's operations."""
    F, K = st["gaussians.feat_dim"], st["gaussians.n_offsets"]
    pixels = width * height
    fwd = {"ops": (SURFEL_PAIR_OPS + SURFEL_FWD_CONTRIB_OPS) * pairs,
           "bytes": instances * SURFEL_INSTANCE_BYTES
           + pixels * SURFEL_PIXEL_BYTES}
    bwd = {"ops": (SURFEL_PAIR_OPS + SURFEL_BWD_CONTRIB_OPS) * pairs,
           "bytes": 2 * instances * SURFEL_INSTANCE_BYTES
           + 2 * pixels * SURFEL_PIXEL_BYTES}
    head = (F + 3) * F + F * K + (F + 3) * F + F * 7 * K + (F + 3) * F \
        + F * 3 * K
    anchor_elements = 3 + 3 * K + F + 6 + 4 + 1
    step = (fwd["ops"] + bwd["ops"] + LOSS_OPS_PER_CHANNEL * 3 * pixels
            + 6 * head * anchors + SURFEL_OPS * surfels
            + ADAM_OPS_PER_ELEMENT * anchor_elements * capacity)
    return {"blend2d_fwd": fwd, "blend2d_bwd": bwd, "step": {"ops": step}}
