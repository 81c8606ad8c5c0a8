"""flvis_tpu_torch — the PyTorch/CUDA port of the flvis_tpu SLAM engine.

The JAX package `flvis_tpu` is the reference this package is held against:
module for module the layout mirrors it (geometry/, ops/, frontend/,
backend/, pipeline/), and the state records keep its field names, so a
test can hand the same numpy state to both (see `interop`).

Rules of the port:
  - This package imports `torch` and never `jax`, and nothing of the JAX
    package either, not even its modules that import no JAX: what it needs
    of them it keeps as its own copy, with a header line naming the module
    it mirrors (`config.py`, `io/synthetic.py`).
  - Every function takes tensors on an explicit device; nothing picks a
    device by itself.  Randomness comes from an explicit `torch.Generator`
    or from draws passed in by the caller.
  - Each TPU kernel on the ported path is a CUDA C++ kernel for sm_90a under
    `csrc/`, bound with ctypes in `ops/kernels/`, beside a plain PyTorch
    version of the same function: a CPU tensor takes the plain version, a
    CUDA tensor launches the kernel or raises.

Precision: importing this package sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, so float32 matrix products and
convolutions on the card run in full float32 — the JAX package pins
`precision="highest"` on every solver contraction, and TF32 (about three
decimal digits) would break the normal equations of the two BA solvers.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
