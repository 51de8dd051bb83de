"""Build and load the port's hand-written CUDA kernels, and the launch
helpers their wrappers share.

Each kernel source under ``medaka_tpu_torch/csrc`` exposes a plain C
interface. On first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``medaka_tpu_torch/_build``
(named by the hash of its source and the ``csrc/*.cuh`` headers, so an
edit rebuilds it) and loaded with
:mod:`ctypes`. Nothing is compiled when a module is imported: the CPU
tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: dynamic shared memory one block may use on sm_90
SMEM_LIMIT = 232448

_LOCK = threading.Lock()
_SOURCE_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``ptxas -v`` report of each library built by this process
BUILD_LOGS: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """Raised when a CUDA kernel library cannot be compiled or loaded."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$NVCC``, ``PATH``, then the CUDA default."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (set $NVCC or put the CUDA toolkit on PATH); the "
        "CUDA kernels are built on first use on the machine with the GPU.")


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if needed and load it (once a process).

    Sources build under a lock of their own, so threads can run one
    ``nvcc`` for each source at the same time.
    """
    with _LOCK:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        # the source and the headers it may include: an edit to either
        # rebuilds
        sha = hashlib.sha1()
        for name in [source] + sorted(
                f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as fh:
                sha.update(fh.read())
        digest = sha.hexdigest()[:16]
        so_path = os.path.join(BUILD_DIR, "lib{}_{}.so".format(
            os.path.splitext(source)[0], digest))
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "{}.{}.tmp".format(so_path, os.getpid())
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(
                    "nvcc failed for {} (exit {}):\n{}{}".format(
                        source, proc.returncode, proc.stdout, proc.stderr))
            BUILD_LOGS[source] = proc.stdout + proc.stderr
            os.replace(tmp, so_path)
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            raise KernelBuildError(
                "could not load {}: {}".format(so_path, e)) from e
        _LIBS[source] = lib
        return lib


# ---------------------------------------------------------------------------
# launch helpers of the recurrent kernels
# ---------------------------------------------------------------------------


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def tile_shape(batch: int, n_sm: int):
    """(columns per thread, column groups) of a block for ``batch``.

    One block owns one direction and ``cpt * nq`` batch columns and keeps
    its recurrent weights in shared memory, so one block fits an SM. The
    smallest tile that still fits the grid in one wave keeps the most SMs
    busy.
    """
    for cpt, nq in ((1, 1), (2, 1), (2, 2), (4, 2)):
        if 2 * -(-batch // (cpt * nq)) <= n_sm:
            return cpt, nq
    return 4, 2


def interleave_chunks(w: torch.Tensor) -> torch.Tensor:
    """(2, R, K) -> 16-byte chunks laid out (2, K/chunk, R, chunk)."""
    per = 16 // w.element_size()
    d, rows, k = w.shape
    return w.reshape(d, rows, k // per, per).permute(0, 2, 1, 3).contiguous()


def check_inputs(name, hidden, specs):
    """Raise unless each (tensor, shape, dtype or None) matches, all on one
    device, and the kernels' tiling takes ``hidden``."""
    dev = specs[0][0].device
    for t, shape, dtype in specs:
        if t.device != dev:
            raise ValueError("{}: all tensors must be on {}".format(name, dev))
        if tuple(t.shape) != tuple(shape):
            raise ValueError("{}: expected shape {}, got {}".format(
                name, tuple(shape), tuple(t.shape)))
        if dtype is not None and t.dtype != dtype:
            raise ValueError("{}: expected {}, got {}".format(
                name, dtype, t.dtype))
    if hidden % 32 or hidden > 512:
        raise ValueError(
            "{}: hidden size {} must be a multiple of 32 and at most "
            "512".format(name, hidden))
