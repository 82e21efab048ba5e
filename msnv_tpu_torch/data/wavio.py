"""WAV I/O in pure numpy: the port's own copy of the JAX package's
data/wavio.py.

- `read_wav` == librosa.load(sr=None, mono=True) for PCM16/PCM24/PCM32/
  float32 files: float32 in [-1, 1) and the native sample rate (ref
  dataset.py:86).
- `write_wav` == librosa.output.write_wav for float32 data (ref
  generate.py:105-112): PCM16 by default (or float32).
- `pcm16_bytes` / `wav_bytes`: the PCM16 payload of a /stream chunk and the
  complete WAV file of a /synthesize answer.
"""

from __future__ import annotations

import struct
import numpy as np


def read_wav(path) -> tuple:
    """Read a WAV file; returns (float32 mono samples in [-1,1), sample_rate)."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            payload = f.read(csize)
            if csize % 2:
                f.read(1)  # chunks are word-aligned
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        audio_format, n_channels, sample_rate, _brate, _balign, bits = fmt
        if audio_format == 1 and bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif audio_format == 1 and bits == 24:
            # 3-byte little-endian: widen to i4 via a zero low byte, then
            # shift-divide (keeps the sign from the top byte)
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[:len(raw) - len(raw) % 3].reshape(-1, 3)
            quads = np.zeros((raw.shape[0], 4), np.uint8)
            quads[:, 1:] = raw
            x = (quads.view("<i4")[:, 0].astype(np.float32)
                 / 2147483648.0)
        elif audio_format == 1 and bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif audio_format == 3 and bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported format {audio_format}/{bits}bit")
        if n_channels > 1:
            # mono=True downmix (mean over channels, librosa semantics)
            x = x.reshape(-1, n_channels).mean(axis=1)
        return x, sample_rate


def pcm16_bytes(samples: np.ndarray) -> bytes:
    """float [-1,1] -> little-endian PCM16 payload (no header)."""
    return (np.clip(np.asarray(samples), -1.0, 1.0 - 1.0 / 32768)
            * 32768.0).astype("<i2").tobytes()


def wav_bytes(samples: np.ndarray, sample_rate: int,
              dtype: str = "pcm16") -> bytes:
    """Mono WAV file contents. dtype: 'pcm16' (default) or 'float32'."""
    if dtype == "pcm16":
        payload = pcm16_bytes(samples)
        audio_format, bits = 1, 16
    elif dtype == "float32":
        payload = np.asarray(samples).astype("<f4").tobytes()
        audio_format, bits = 3, 32
    else:
        raise ValueError(dtype)
    byte_rate = sample_rate * bits // 8
    block_align = bits // 8
    return b"".join([
        struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"),
        struct.pack("<4sI", b"fmt ", 16),
        struct.pack("<HHIIHH", audio_format, 1, sample_rate,
                    byte_rate, block_align, bits),
        struct.pack("<4sI", b"data", len(payload)),
        payload,
    ])


def write_wav(path, samples: np.ndarray, sample_rate: int,
              dtype: str = "pcm16") -> None:
    """Write mono WAV. dtype: 'pcm16' (default) or 'float32'."""
    with open(path, "wb") as f:
        f.write(wav_bytes(samples, sample_rate, dtype))
