"""Build-at-first-use for the package's native sources.

A ``NativeLib`` compiles one source file into a shared library with a plain
C interface, under ``yunet_tpu_torch/_build/`` (listed in .gitignore), and
loads it with ctypes. The file name carries a hash of the source and the
compile command, so an edited source or flag rebuilds and an unchanged one
loads what is already there. Nothing is built when a module is imported:
the CPU paths never build at all.

CUDA sources go through ``nvcc`` for ``sm_90a`` (Hopper); the host C++
source through ``g++``. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "yunet_tpu_torch are built at first use and "
                           "need the CUDA toolkit")
    return path


class NativeLib:
    """One source file -> one shared library, built and loaded lazily.

    ``signatures`` maps each exported C function to (restype, argtypes).
    """

    def __init__(self, source: str, compiler: Sequence[str],
                 signatures: Dict[str, tuple]):
        self.source = source
        self.compiler = list(compiler)
        self.signatures = signatures
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def _command(self) -> List[str]:
        cmd = list(self.compiler)
        if cmd[0] == "nvcc":
            cmd[0] = nvcc_path()
        return cmd

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        with open(self.source, "rb") as f:
            src = f.read()
        key = hashlib.sha256(
            src + "\0".join(self.compiler).encode()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(self.source))[0]
        out = os.path.join(BUILD_DIR, f"lib{stem}-{key}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = self._command()
            r = subprocess.run(cmd + ["-o", tmp, self.source],
                               capture_output=True, text=True, timeout=600)
            self.build_log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(
                    f"building {self.source} failed ({' '.join(cmd)}):\n"
                    f"{self.build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        for name, (restype, argtypes) in self.signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        return lib


def cuda_signatures(**entry_points) -> Dict[str, tuple]:
    """ctypes signatures of a CUDA library's entry points (each returning
    a cudaError_t as int) plus its ``yunet_cuda_error_string``."""
    sigs = {name: (ctypes.c_int, list(args))
            for name, args in entry_points.items()}
    sigs["yunet_cuda_error_string"] = (ctypes.c_char_p, [ctypes.c_int])
    return sigs


def check_cuda_status(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if code != 0:
        msg = lib.yunet_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
