"""ddcmd_tpu_torch -- the PyTorch + CUDA port of ddcmd_tpu.

The JAX package `ddcmd_tpu` is the reference; this package keeps its
module layout so each counterpart is easy to find, and runs on one
NVIDIA H100 (sm_90a).  Plain tensor code is PyTorch; every Pallas kernel
on the ported path is a hand-written CUDA kernel under `csrc/`, built on
first use into `_build/` (ops/cellpair_half.py).

Nothing here imports jax: the jax-free host modules of the JAX package
(deck parser, units, collection I/O, model builders) are copied, not
imported, because importing `ddcmd_tpu` imports jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Every matmul in this package is geometry or physics (kinetic stress,
# box transforms).  TF32 keeps ~3 decimal digits and would round
# positions and forces the way the TPU's default bf16 passes did; pin
# full f32 for matmuls and cuDNN alike (counterpart of ddcmd_tpu's
# jax_default_matmul_precision="highest").
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
