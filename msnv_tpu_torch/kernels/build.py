"""nvcc build of one CUDA source into a ctypes-loadable shared library.

Each kernel module compiles its own source at first use: sm_90a, a plain C
interface, the library named by the source's content hash in the git-ignored
msnv_tpu_torch/build/, so a source that has not changed is not rebuilt within
one checkout. Builds of different sources may run at the same time (one nvcc
process each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build_library(source: Path):
    """Compile `source` for sm_90a (once per content) and load it.

    Returns (ctypes.CDLL, nvcc's -Xptxas -v report; empty when the library
    was already built)."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log
