"""Build and load the port's hand-written CUDA kernels.

Each source under ``repro_torch/csrc`` has a plain C interface.  At
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library, cached by the hash of the source and the flags under
``csrc/build/`` (listed in ``.gitignore``), and loaded with ctypes.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


#: the dtype argument of the kernels' C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, the one a launch goes on."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise if the C function ``name`` returned a nonzero CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _nvcc(source: Path) -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found: the kernel in {source.name} is built with the CUDA toolkit"
        )
    return nvcc


class CudaLibrary:
    """One kernel source, built once and loaded once per process.

    ``bind`` declares ``argtypes`` / ``restype`` of the library's C
    functions on the loaded ``ctypes.CDLL``."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None

    def build(self, verbose: bool = False) -> Path:
        """Compile the library if this source has not been built yet;
        returns its path.  ``verbose`` adds ``-Xptxas -v`` and prints the
        compiler's report (registers, shared memory, spills)."""
        src = self.source.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"lib{self.source.stem}-{tag}.so"
        if lib.exists() and not verbose:
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename into place, so concurrent
        # builds never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(self.source), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(self.source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {self.source.name}:\n{proc.stderr}"
                )
            if verbose:
                print(proc.stderr.strip(), flush=True)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return lib

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library, once per process."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib
