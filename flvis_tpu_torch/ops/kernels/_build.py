"""Build the CUDA C++ sources in flvis_tpu_torch/csrc/ into one shared
library at first use, and load it with ctypes.

Route: nvcc, one process per source started together, then one link →
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes), loaded with ctypes;
wrappers pass `data_ptr()` pointers and PyTorch's current stream.  The
library lands in flvis_tpu_torch/_build/ (git-ignored) under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached build.  Nothing is fetched: nvcc comes from
$CUDA_HOME, /usr/local/cuda or PATH.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# C entry points of csrc/*.cu: (name, argtypes).  Every entry returns the
# cudaError_t of its launches (0 = success) as an int.
_SIGNATURES = {
    "flvis_grad_blur": [_P, _P, _P, _P, _I, _I, _I, _P],
    "flvis_schur_scratch_floats": [_I, _I],
    "flvis_schur_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _P, _P,
                         _P, _P, _P],
    "flvis_attitude_chain": [_P, _P, _P, _P, _P, _I, _I, _P],
    "flvis_fast_score_nms_blur": [_P, _P, _P, _I, _I, _F, _I, _F, _P],
    "flvis_sweep_maps": [_P, _P, _P, _P, _P, _I, _I, _P],
    "flvis_hamming_matrix": [_P, _P, _P, _I, _I, _P],
    "flvis_bow_tf": [_P, _P, _P, _P, _I, _I, _I, _P],
    "flvis_gather_windows": [_P, _P, _P, _P, _I, _I, _I, _P, _L, _P, _L, _P, _I, _I, _I, _P],
    "flvis_gather_patches": [_P, _P, _P, _P, _I, _I, _I, _P, _L, _L, _P, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found ($CUDA_HOME, /usr/local/cuda, PATH): "
                           "the CUDA kernels of flvis_tpu_torch cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libflvis_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library():
    """Build (if needed) and load the kernel library.  Returns
    (ctypes.CDLL, info dict with build seconds and the ptxas report)."""
    so = library_path()
    info = {"path": str(so), "build_s": 0.0, "ptxas": ""}
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # One nvcc per source, all started together, then one link.
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = so.with_name(f"{so.stem}.{src.stem}.{os.getpid()}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
        logs = []
        for cmd, proc in procs + [(None, None)]:
            if proc is None:        # every object built: link them
                cmd = [nvcc, "-shared", NVCC_FLAGS[0], NVCC_FLAGS[1], "-o", str(tmp),
                       *map(str, objs)]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)
            out, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                for p in procs:
                    p[1].kill()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{out}\n{err}")
        info["build_s"] = time.perf_counter() - t0
        info["ptxas"] = "".join(logs)
        for obj in objs:
            obj.unlink()
        so.with_suffix(".log").write_text(info["ptxas"])
        os.replace(tmp, so)
    elif so.with_suffix(".log").exists():
        info["ptxas"] = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, info


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_of(t) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device (the
    getter Inductor's generated launchers use: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch_on(index: int, fn, *args) -> int:
    """fn(*args) with CUDA device `index` current (a C entry launches on the
    current device); the common case — it already is — costs one query."""
    if index == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)


def require_cuda_f32(name: str, **tensors) -> None:
    """Validate what the C entry points take: CUDA float32, contiguous, one
    device.  Shapes are checked by each wrapper."""
    devs = set()
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        devs.add(t.device)
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
