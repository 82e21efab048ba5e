"""WAV bytes in pure numpy — the port's own copy of the two functions of
the JAX package's data/wavio.py that serving needs: the PCM16 payload of a
/stream chunk and the complete WAV file of a /synthesize answer.
"""

from __future__ import annotations

import struct
import numpy as np


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
