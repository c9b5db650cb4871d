"""gssr_tpu_torch — the PyTorch/CUDA port of gssr_tpu for one NVIDIA H100.

The JAX package `gssr_tpu` stays the reference; this package mirrors its
module names (ops/projection.py, ops/binning.py, models/vanilla.py, ...)
and never imports it or `jax`. Plain tensor code is PyTorch; each TPU
(Pallas) kernel on the ported path is a hand-written Hopper kernel under
csrc/ with a plain PyTorch twin beside its wrapper.

All math is fp32. Reduced-precision geometry was the reference's worst
bug (docs/known-issues.md "Root cause"), and Hopper's TF32 is the same
trap: cuBLAS matmuls and cuDNN convolutions (ops/ssim.py) would otherwise
run fp32 inputs at ~3 decimal digits.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
# deterministic gradients by default: the SSIM blur's backward must not
# pick a cuDNN algorithm that accumulates with atomics
_torch.backends.cudnn.deterministic = True

# On the CPU, torch.exp, torch.log and their kin run oneMKL's vector math
# (VML), which picks its CPU code path on its first call and caches it
# without a lock: it stores the raw CPU id, then the table index. When the
# first call comes from several OpenMP threads at once, a thread that reads
# the raw id in between runs that call with a low-accuracy kernel (relative
# error up to 1.5e-4 in its share). One call on this thread, below the
# intra-op grain, makes the choice before any parallel call can race it.
_torch.exp(_torch.zeros(16))
