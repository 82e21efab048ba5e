"""Zstandard frames and CRC32C for orbax checkpoints, without a zstd package.

orbax's OCDBT checkpoints (training/ocdbt.py) hold their B-tree nodes and
array chunks as zstd frames (RFC 8878) and close every node and manifest
with a CRC32C. The decoder and the checksum are the repository's own host
C++ (`msnv_tpu_torch/csrc/zstd_decode.cc`), compiled at first use with the
host's C++ compiler into the git-ignored msnv_tpu_torch/build/ (named by
the source's content hash) and bound through ctypes. There is no fallback:
a failed build, or a frame the decoder refuses, raises with the reason.

Writing needs no encoder: `frame` wraps bytes as a valid zstd frame of raw
(stored) blocks, which every zstd decoder reads; `frame_parts` gives the
same frame as buffers to write without joining them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "zstd_decode.cc"
BUILD_DIR = _PKG / "build"
MAGIC = 0xFD2FB528
BLOCK_MAX = 128 << 10          # a block's largest size, raw ones too
_ERRLEN = 512

_lib = None


class ZstdError(ValueError):
    """A frame the decoder refuses: truncated, corrupt, or needing a
    dictionary."""


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libmsnv_zstd-{digest}.so"
    if so.exists():
        return so
    cxx = os.environ.get("CXX", "g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp),
           str(SOURCE)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", "") or ""
        raise RuntimeError(f"building the zstd decoder failed ({' '.join(cmd)}"
                           f"): {e}\n{detail}") from e
    os.replace(tmp, so)
    return so


def build() -> Path:
    """Compile the decoder if this source has not been (a failure raises
    RuntimeError with the compiler's output) and load it; its path."""
    _load()
    return Path(_lib._name)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    u8p, size = ctypes.c_void_p, ctypes.c_size_t
    lib.msnv_zstd_decompress_into.restype = ctypes.c_int64
    lib.msnv_zstd_decompress_into.argtypes = [u8p, size, u8p, size,
                                              ctypes.c_char_p, size]
    lib.msnv_zstd_decompress_alloc.restype = ctypes.c_int64
    lib.msnv_zstd_decompress_alloc.argtypes = [
        u8p, size, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, size]
    lib.msnv_zstd_content_size.restype = ctypes.c_int64
    lib.msnv_zstd_content_size.argtypes = [u8p, size, ctypes.c_char_p, size]
    lib.msnv_zstd_free.restype = None
    lib.msnv_zstd_free.argtypes = [u8p]
    lib.msnv_crc32c.restype = ctypes.c_uint32
    lib.msnv_crc32c.argtypes = [ctypes.c_uint32, u8p, size]
    _lib = lib
    return lib


def _view(data) -> np.ndarray:
    """A contiguous uint8 view of bytes, bytearray, memoryview or array."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def decompress(data, size: int | None = None) -> np.ndarray:
    """Every zstd frame of `data`, decoded, as a uint8 array. `size`, when
    the caller knows it, is the decoded length the frames must give
    (ZstdError otherwise); without it the frames' declared sizes are used,
    or the output grows."""
    lib = _load()
    src = _view(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    if size is None:
        size = lib.msnv_zstd_content_size(src.ctypes.data, src.size, err,
                                          _ERRLEN)
        if size == -2:
            raise ZstdError(err.value.decode())
    if size < 0:
        ptr = ctypes.c_void_p()
        n = lib.msnv_zstd_decompress_alloc(src.ctypes.data, src.size,
                                           ctypes.byref(ptr), err, _ERRLEN)
        if n < 0:
            raise ZstdError(err.value.decode())
        try:
            return np.frombuffer(ctypes.string_at(ptr, n), np.uint8).copy() \
                if n else np.empty(0, np.uint8)
        finally:
            lib.msnv_zstd_free(ptr)
    out = np.empty(size, np.uint8)
    n = lib.msnv_zstd_decompress_into(src.ctypes.data, src.size,
                                      out.ctypes.data, size, err, _ERRLEN)
    if n < 0:
        raise ZstdError(err.value.decode())
    if n != size:
        raise ZstdError(f"frames decode to {n} bytes, {size} expected")
    return out


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of `data`, extending `crc`."""
    src = _view(data)
    return int(_load().msnv_crc32c(crc, src.ctypes.data, src.size))


def frame_parts(data) -> list:
    """`data` as one zstd frame of raw blocks (single segment, with its
    content size, no checksum), as a list of buffers to write in order:
    the frame's header, then each block's header and its slice of
    `data`."""
    raw = memoryview(_view(data))
    n = len(raw)
    if n < 256:
        header = struct.pack("<IBB", MAGIC, 0x20, n)         # FCS 1 byte
    elif n < 65536 + 256:
        header = struct.pack("<IBH", MAGIC, 0x60, n - 256)   # FCS 2 bytes
    elif n < 1 << 32:
        header = struct.pack("<IBI", MAGIC, 0xA0, n)         # FCS 4 bytes
    else:
        header = struct.pack("<IBQ", MAGIC, 0xE0, n)         # FCS 8 bytes
    parts = [header]
    for start in range(0, n, BLOCK_MAX) if n else [0]:
        block = raw[start:start + BLOCK_MAX]
        last = start + BLOCK_MAX >= n
        parts.append((len(block) << 3 | int(last)).to_bytes(3, "little"))
        parts.append(block)
    return parts


def frame(data) -> bytes:
    """`data` as one zstd frame of raw blocks (frame_parts, joined)."""
    return b"".join(frame_parts(data))
