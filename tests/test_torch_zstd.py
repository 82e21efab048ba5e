"""The port's zstd decoder (msnv_tpu_torch/csrc/zstd_decode.cc through
training/zstd.py) against the `zstandard` package, on the CPU.

Frames from zstandard at levels -5, 1, 3 and 19, with and without the
content checksum and the content size, of 0 B to 4 MB of random, float32,
repetitive and text data (multi-block frames above 128 KiB), decode to the
same bytes; so do concatenated frames, skippable frames between them, and
frames with a zero dictionary id. A truncated frame, a flipped checksum, a
dictionary id, a reserved bit and garbage raise ZstdError. The frames that
the port writes (raw blocks) decode in zstandard, and the CRC32C equals
google_crc32c's. Tolerance: none; bytes are compared.
"""

import struct

import numpy as np
import pytest

from msnv_tpu_torch.training import zstd

zstandard = pytest.importorskip("zstandard")

SIZES = (0, 1, 100, 4096, 131072, 131073, 600_000, 4 << 20)
KINDS = ("random", "float32", "repetitive", "text")


def _data(kind, n, seed=0):
    rng = np.random.RandomState(seed + n)
    if kind == "random":
        return rng.bytes(n)
    if kind == "float32":
        return rng.randn(n // 4 + 1).astype(np.float32).tobytes()[:n]
    if kind == "repetitive":
        return (b"abcdefghij" * (n // 10 + 1))[:n]
    return " ".join(str(i * i % 997) for i in range(n // 3 + 1)).encode()[:n]


def _compress(data, level, checksum=False, size=True):
    return zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=size).compress(data)


@pytest.mark.parametrize("level", (-5, 1, 3, 19))
@pytest.mark.parametrize("kind", KINDS)
def test_decoder_equals_zstandard(kind, level):
    for n in SIZES:
        if level == 19 and n > 600_000:
            continue                    # level 19 is slow to compress
        data = _data(kind, n)
        for checksum in (False, True):
            for size in (True, False):
                frame = _compress(data, level, checksum, size)
                out = zstd.decompress(frame)
                assert out.dtype == np.uint8
                assert out.tobytes() == data, (n, checksum, size)
                if size:
                    assert zstd.decompress(frame, len(data)).tobytes() \
                        == data


def test_streamed_frames_without_content_size():
    """zstandard's streaming compressor writes a window descriptor and no
    content size, in many blocks."""
    data = _data("float32", 1 << 20) + _data("text", 1 << 20)
    cobj = zstandard.ZstdCompressor(level=3,
                                    write_checksum=True).compressobj()
    frame = cobj.compress(data) + cobj.flush()
    assert zstandard.get_frame_parameters(frame).content_size == \
        zstandard.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(frame).tobytes() == data


def test_concatenated_and_skippable_frames():
    parts = [_data(k, 70_000, seed=i) for i, k in enumerate(KINDS)]
    skip = struct.pack("<II", 0x184D2A5A, 5) + b"12345"
    stream = skip + _compress(parts[0], 1) + _compress(parts[1], 3, True) \
        + skip + _compress(parts[2], -5, size=False) + _compress(b"", 1) \
        + _compress(parts[3], 19)
    assert zstd.decompress(stream).tobytes() == b"".join(parts)


def _with_dictionary_id(frame, dict_id: bytes):
    """`frame` with a dictionary id field (1, 2 or 4 bytes) in its
    header."""
    frame = bytearray(frame)
    fhd = frame[4]
    at = 5 if fhd & 0x20 else 6     # after the window descriptor, if any
    frame[4] = fhd | {1: 1, 2: 2, 4: 3}[len(dict_id)]
    frame[at:at] = dict_id
    return bytes(frame)


def test_zero_dictionary_id_reads():
    data = _data("text", 5000)
    for frame in (_compress(data, 1), _compress(data, 1, size=False)):
        assert zstd.decompress(_with_dictionary_id(frame, b"\0")).tobytes() \
            == data
        assert zstd.decompress(
            _with_dictionary_id(frame, b"\0\0\0\0")).tobytes() == data


@pytest.mark.parametrize("case", ["truncated", "checksum", "dictionary",
                                  "reserved", "garbage", "empty",
                                  "short_size"])
def test_corrupt_frames_raise(case):
    data = _data("float32", 300_000)
    frame = bytearray(_compress(data, 3, checksum=True))
    if case == "truncated":
        for cut in (1, 10, len(frame) // 2, len(frame) - 1):
            with pytest.raises(zstd.ZstdError, match="truncated"):
                zstd.decompress(bytes(frame[:-cut]))
        return
    if case == "checksum":
        frame[-1] ^= 0x40
        match = "checksum mismatch"
    elif case == "dictionary":
        frame = _with_dictionary_id(bytes(frame), struct.pack("<H", 1234))
        match = "needs dictionary 1234"
    elif case == "reserved":
        frame[4] |= 0x08
        match = "reserved"
    elif case == "garbage":
        frame = b"\x00" * 64
        match = "not a zstd frame"
    elif case == "empty":
        frame = b""
        match = "empty"
    else:
        with pytest.raises(zstd.ZstdError, match="exceeds"):
            zstd.decompress(bytes(frame), len(data) - 1)
        return
    with pytest.raises(zstd.ZstdError, match=match):
        zstd.decompress(bytes(frame))


@pytest.mark.parametrize("n", (0, 1, 255, 256, 65791, 65792, 131072,
                               131073, 1 << 20))
def test_raw_frames_decode_in_zstandard(n):
    data = _data("random", n)
    frame = zstd.frame(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstandard.frame_content_size(frame) == n
    assert zstd.decompress(frame).tobytes() == data
    assert b"".join(bytes(p) for p in zstd.frame_parts(data)) == frame


def test_crc32c():
    google_crc32c = pytest.importorskip("google_crc32c")
    for n in (0, 1, 7, 8, 31, 32, 33, 1000, 1 << 16):
        data = _data("random", n)
        assert zstd.crc32c(data) == google_crc32c.value(data)
        assert zstd.crc32c(data[n // 2:], zstd.crc32c(data[:n // 2])) \
            == google_crc32c.value(data)


def test_library_is_built_from_the_repository_source():
    """The decoder is the repository's C++ source, built into the
    git-ignored build directory under its content hash."""
    import hashlib
    digest = hashlib.sha256(zstd.SOURCE.read_bytes()).hexdigest()[:16]
    zstd.crc32c(b"x")
    assert (zstd.BUILD_DIR / f"libmsnv_zstd-{digest}.so").is_file()
    assert zstd.SOURCE.name == "zstd_decode.cc"


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails is an error with the reason."""
    monkeypatch.setattr(zstd, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building the zstd decoder"):
        zstd._build()
