"""Build, binding and wrapper of the CUDA VQ-assignment kernel.

The kernel source is ``vq_seg_tpu_torch/csrc/vq_assign.cu``.  At first use it
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface under ``vq_seg_tpu_torch/_build/``, keyed by a hash of the source
and the flags, and loaded with ``ctypes``.  Nothing is built or loaded when
this module is imported.  A failed build raises.

``vq_assign_cuda`` takes CUDA tensors only; the plain version for CPU tensors
is ``ops/vq.py::vq_assign_reference``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "vq_assign.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Kernel launches made by vq_assign_cuda: a plain count that a run resets
# and reads to show that its path went through the kernel.
launches = 0

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found (looked in {cand} and on PATH)")
    return found


def library_path(source: str = SOURCE) -> str:
    """Where the library for ``source`` and the flags lives."""
    with open(source, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libvq_assign-{h}.so")


def build(source: str = SOURCE) -> dict:
    """Compile the kernel library from ``source`` unless it exists.  Returns
    ``{"path", "seconds", "built", "log"}``; ``log`` is nvcc's output
    (``-Xptxas=-v`` prints registers and shared memory per kernel)."""
    path = library_path(source)
    log_path = path + ".log"
    if os.path.exists(path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"path": path, "seconds": 0.0, "built": False, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source}:\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"path": path, "seconds": seconds, "built": True, "log": log}


def load(path: str) -> ctypes.CDLL:
    """Load a built library and declare ``vq_assign_launch``."""
    lib = ctypes.CDLL(path)
    # every pointer and the stream as c_void_p: an undeclared argument would
    # be passed as a 32-bit int and cut the address
    lib.vq_assign_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.vq_assign_launch.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load(build()["path"])
        return _lib


_INT_MAX = 2**31 - 1


def _check(name: str, t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"vq_assign_cuda: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"vq_assign_cuda: {name} must be float32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"vq_assign_cuda: {name} must be 2-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"vq_assign_cuda: {name} must be contiguous")
    if max(t.shape) > _INT_MAX:
        raise ValueError(f"vq_assign_cuda: {name} shape {tuple(t.shape)} exceeds int32")


@torch.no_grad()
def vq_assign_cuda(x: torch.Tensor, codebook: torch.Tensor, metric: str = "euclidean",
                   lib: ctypes.CDLL | None = None):
    """x (N, C), codebook (K, C), both f32 contiguous on one CUDA device ->
    (idx (N,) int32, quantized (N, C) f32, counts (K,) int32).

    The kernels write idx and counts through a 64-bit (score, code) key per
    row; ||e||^2 (euclidean) is a torch reduction before them and the exact
    row gather an ``index_select`` after them, as in the JAX package.
    ``lib`` is a library from ``load``; by default the one built from
    ``SOURCE``."""
    global launches
    if metric not in ("euclidean", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    _check("x", x)
    _check("codebook", codebook)
    if codebook.device != x.device:
        raise ValueError(f"vq_assign_cuda: x on {x.device}, codebook on {codebook.device}")
    n, c = x.shape
    k, c2 = codebook.shape
    if c2 != c:
        raise ValueError(f"vq_assign_cuda: x has C={c}, codebook has C={c2}")
    if c == 0 or k == 0:
        raise ValueError(f"vq_assign_cuda: empty codebook or rows (C={c}, K={k})")
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    counts = torch.zeros(k, dtype=torch.int32, device=x.device)
    if n > 0:
        cosine = metric == "cosine"
        cb_sq = None
        if not cosine:
            with torch.autocast("cuda", enabled=False):
                cb_sq = torch.sum(codebook * codebook, dim=-1)
        best = torch.empty(n, dtype=torch.int64, device=x.device)  # the kernel fills it
        if lib is None:
            lib = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.vq_assign_launch(
                x.data_ptr(), codebook.data_ptr(),
                None if cb_sq is None else cb_sq.data_ptr(),
                n, c, k, int(cosine), best.data_ptr(), idx.data_ptr(), counts.data_ptr(),
                stream)
        if rc != 0:
            raise RuntimeError(f"vq_assign kernel launch failed: CUDA error {rc}")
        launches += 1
    quantized = codebook.index_select(0, idx)
    return idx, quantized, counts
