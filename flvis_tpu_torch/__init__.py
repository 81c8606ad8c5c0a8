"""flvis_tpu_torch — the PyTorch/CUDA port of the flvis_tpu SLAM engine.

The JAX package `flvis_tpu` is the reference this package is held against:
module for module the layout mirrors it (geometry/, ops/, frontend/,
backend/, vio/, loop/, pipeline/, parallel/), and the state records keep its field names, so a
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

Profiling: importing this package also sets the environment variables
TEARDOWN_CUPTI=0 and DISABLE_CUPTI_LAZY_REINIT=1 where the caller has not
set them, as torch does for its own CUDA graphs (torch/profiler/
profiler.py, when inductor captures).  With CUPTI torn down after a trace
and set up again, a captured step's replays hit an illegal address under
torch.profiler (a MultiSeqSlam of one sequence on the card), and later
traces miss the graphs' kernels; kept up, neither happens
(tools/torch_profiler_fault.py).  One case remains, a fault of the
profiler's tracing, not of the graph: a graph of 8 concurrent branches
with ~13k kernels each in WHILE bodies, captured after the process had
traced, faults when its replays are traced — also a graph of in-place
kernels on buffers made before the capture.  Profile such a step
(MultiSeqSlam(num_seqs=8) on the card) in a process that captures it
before its first trace.
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for _var, _value in (("TEARDOWN_CUPTI", "0"), ("DISABLE_CUPTI_LAZY_REINIT", "1")):
    os.environ.setdefault(_var, _value)

__version__ = "0.1.0"
