"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``medaka_tpu_torch/csrc`` exposes a plain C
interface. On first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``medaka_tpu_torch/_build``
(named by the hash of its source, so an edit rebuilds it) and loaded with
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

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
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
    """Compile ``csrc/<source>`` if needed and load it (once a process)."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is not None:
            return lib
        with open(os.path.join(CSRC_DIR, source), "rb") as fh:
            digest = hashlib.sha1(fh.read()).hexdigest()[:16]
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
