"""ctypes bindings for the native data-path library (native/msnv_data.cc).

The port's counterpart of the JAX package's data/native.py. It compiles the
repository's `native/msnv_data.cc` with the host's C++ compiler at first use
into the git-ignored msnv_tpu_torch/build/ (the library named by the
source's content hash, so an unchanged source is not rebuilt within one
checkout). Every entry point has a pure-Python fallback (wavio /
np.loadtxt / ops.quantize) with bit-identical behavior, so the native
library is a speedup, never a requirement. This is a host library: nothing
here touches the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "msnv_data.cc"
BUILD_DIR = _PKG / "build"

_lib = None
_tried = False


def _build():
    """Compile SOURCE once per content; the library's path, or None when
    there is no source or no compiler, or the build fails."""
    if not SOURCE.is_file():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libmsnv_data-{digest}.so"
    if so.exists():
        return so
    cxx = os.environ.get("CXX", "g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, "-O3", "-fPIC", "-Wall", "-std=c++17", "-shared",
                        "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"msnv native build skipped: {e}", file=sys.stderr)
        return None
    os.replace(tmp, so)
    return so


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.msnv_read_wav.restype = ctypes.c_int
    lib.msnv_read_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.msnv_parse_floats.restype = ctypes.c_int
    lib.msnv_parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.msnv_uquantize.restype = None
    lib.msnv_uquantize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.msnv_free.restype = None
    lib.msnv_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def read_wav(path: str):
    """Native WAV decode; falls back to wavio.read_wav."""
    lib = _load()
    if lib is None:
        from msnv_tpu_torch.data.wavio import read_wav as py_read
        return py_read(path)
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = lib.msnv_read_wav(path.encode(), ctypes.byref(out),
                           ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"msnv_read_wav({path}) failed: rc={rc}")
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.msnv_free(out)
    return arr, int(sr.value)


def loadtxt(path: str) -> np.ndarray:
    """Native whitespace-float parser; np.loadtxt-shaped result
    (1-D for single-column files, 2-D otherwise)."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path)
    out = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.msnv_parse_floats(path.encode(), ctypes.byref(out),
                               ctypes.byref(n), ctypes.byref(cols))
    if rc != 0:
        raise IOError(f"msnv_parse_floats({path}) failed: rc={rc}")
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    lib.msnv_free(out)
    c = int(cols.value)
    if c > 1:
        return arr.reshape(-1, c)
    return arr


def uquantize(x: np.ndarray, q_levels: int = 256) -> np.ndarray:
    """Native mu-law quantize of float32 samples; the fallback is
    ops.quantize.uquantize on a float32 tensor."""
    lib = _load()
    if lib is None:
        import torch
        from msnv_tpu_torch.ops.quantize import uquantize as tq
        x32 = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        return tq(x32, q_levels).numpy().astype(np.int32)
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.int32)
    lib.msnv_uquantize(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size,
        q_levels, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
