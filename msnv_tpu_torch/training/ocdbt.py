"""The OCDBT key-value store that orbax checkpoints live in, read and written
in Python over numpy (no tensorstore).

OCDBT ("optionally cooperative distributed B+tree") is tensorstore's
database on a plain directory. What this module knows of it was worked out
from the files that orbax writes, with tensorstore as the oracle:

- Every file that the format frames (a manifest, a B-tree node, a version
  tree node) is: a magic (u32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de
  B-tree node), the frame's length (u64 LE,
  the whole frame), a format version (varint, 0), a compression (varint:
  0 none, 1 zstd), the body (a zstd frame when compressed), and a CRC32C
  of everything before it (u32 LE). Nodes sit at an offset inside the data
  files under `d/`, beside the values they reference.
- Bodies are columns: for N entries, the first field of every entry, then
  the second, and so on. Integers are LEB128 varints, heights u8, commit
  times u64 LE nanoseconds.
- A data file table opens every node and the manifest's version list:
  count; the path prefix shared with the previous path (entries 1..N-1);
  the suffix lengths; the base path lengths; the suffix bytes. A path is
  base path + relative path, relative to the database's directory (a
  merged database's base path names the process database it came from,
  `ocdbt.process_0/`).
- The manifest (`manifest.ocdbt`): a 16-byte uuid, the manifest kind
  (0: one manifest file), max_inline_value_bytes, max_decoded_node_bytes,
  version_tree_arity_log2 (u8), the compression method (0, or 1 and an
  int32 LE zstd level); then its inline version tree leaf: a data file
  table, the newest versions (generation, root height, root data file,
  offset and length, the tree's key count, node bytes and indirect value
  bytes, commit time) and the references to version tree nodes holding
  the older ones (generation, file, offset, length, generation count,
  commit time, height). The newest version is always inline; the older
  ones are not read.
- A B-tree node: its height (u8), a data file table, the entry count, the
  key prefix lengths (shared with the previous key), the key suffix
  lengths, for an interior node each child's common key prefix length,
  the key bytes. A leaf then has value lengths, value kinds (0 inline, 1
  in a data file), the data file and offset of each indirect value, and
  the inline values' bytes; an interior node each child's data file,
  offset, length, key count, node bytes and indirect value bytes. A
  child's keys omit the common prefix its parent's entry names.

Written databases have one B-tree leaf and one version; their nodes are
zstd frames of raw blocks (training/zstd.frame).
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass

import numpy as np

from msnv_tpu_torch.training import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"

# orbax's settings (tensorstore's defaults for a checkpoint's database)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class OcdbtError(ValueError):
    """A file that is not a valid OCDBT frame, or a feature not read."""


@dataclass(frozen=True)
class Ref:
    """An indirect value or a node: bytes [offset, offset + length) of the
    data file at `path` (absolute)."""
    path: str
    offset: int
    length: int


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Ref | None            # None: the empty tree
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


# ------------------------------------------------------------- encoding

class _Body:
    """A cursor over a frame's decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated body")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> list:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self):
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} "
                             f"bytes after the body")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """The decoded body of a framed file, its magic, length and CRC32C
    checked."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: {len(data)} bytes, too short for a frame")
    (got,) = struct.unpack(">I", data[:4])
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:08x}, expected {magic:08x}")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise OcdbtError(f"{what}: frame says {length} bytes, has "
                         f"{len(data)}")
    (crc,) = struct.unpack("<I", data[-4:])
    if zstd.crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC32C mismatch")
    head = _Body(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (only 0 is "
                         f"read)")
    compression = head.varint()
    body = data[12 + head.pos:-4]
    if compression == 1:
        return zstd.decompress(body).tobytes()
    if compression != 0:
        raise OcdbtError(f"{what}: unknown compression {compression}")
    return body


def frame(magic: int, body: bytes) -> bytes:
    """`body` framed as zstd (raw blocks) with its CRC32C."""
    payload = _varint(0) + _varint(1) + zstd.frame(body)
    head = struct.pack(">I", magic) + struct.pack(
        "<Q", 4 + 8 + len(payload) + 4)
    data = head + payload
    return data + struct.pack("<I", zstd.crc32c(data))


def _read_files(b: _Body, directory: str) -> list:
    """A data file table: absolute paths."""
    n = b.varint()
    prefix = [0] + b.varints(n - 1) if n else []
    suffix = b.varints(n)
    base = b.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{b.what}: data file prefix beyond the "
                             f"previous path")
        path = prev[:prefix[i]] + b.take(suffix[i])
        if base[i] > len(path):
            raise OcdbtError(f"{b.what}: base path beyond the path")
        prev = path
        paths.append(os.path.join(directory, path.decode()))
    return paths


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _write_files(paths: list) -> bytes:
    """A data file table of (base path, relative path) pairs, in order."""
    full = [(base + rel).encode() for base, rel in paths]
    prefix = [_common(full[i - 1], full[i]) for i in range(1, len(full))]
    suffix = [full[0]] + [full[i][prefix[i - 1]:]
                          for i in range(1, len(full))] if full else []
    return (_varint(len(full)) + _varints(prefix)
            + _varints(len(s) for s in suffix)
            + _varints(len(base.encode()) for base, _ in paths)
            + b"".join(suffix))


def read_ref(ref: Ref) -> bytes:
    """The bytes a Ref names."""
    with open(ref.path, "rb") as f:
        f.seek(ref.offset)
        data = f.read(ref.length)
    if len(data) != ref.length:
        raise OcdbtError(f"{ref.path}: {len(data)} bytes at {ref.offset}, "
                         f"{ref.length} expected (file truncated?)")
    return data


def _file(files: list, i: int, what: str) -> str:
    if i >= len(files):
        raise OcdbtError(f"{what}: data file {i} of {len(files)}")
    return files[i]


# --------------------------------------------------------------- reading

def _versions(b: _Body, files: list) -> list:
    n = b.varint()
    gen = b.varints(n)
    height = list(b.take(n))
    fid, off, length = b.varints(n), b.varints(n), b.varints(n)
    keys, tree, indirect = b.varints(n), b.varints(n), b.varints(n)
    commit = b.u64s(n)
    return [Version(gen[i], height[i],
                    Ref(_file(files, fid[i], b.what), off[i], length[i])
                    if keys[i] else None,
                    keys[i], tree[i], indirect[i], commit[i])
            for i in range(n)]


def _skip_version_refs(b: _Body, files: list) -> None:
    """Consume a manifest's references to version tree nodes (the older
    versions), each checked to name a data file."""
    n = b.varint()
    b.varints(n)                                  # last generations
    for i in b.varints(n):                        # data files
        _file(files, i, b.what)
    b.varints(n), b.varints(n)                    # offsets, lengths
    b.varints(n)                                  # generation counts
    b.u64s(n)                                     # commit times
    b.take(n)                                     # heights


class Database:
    """An OCDBT database in `directory`, read at its newest version:
    items(), whose values are bytes (inline) or a Ref into a data file
    (read with read_ref)."""

    def __init__(self, directory: str):
        self.dir = os.path.abspath(directory)
        path = os.path.join(self.dir, MANIFEST)
        with open(path, "rb") as f:
            body = _Body(unframe(f.read(), MANIFEST_MAGIC, path), path)
        self.uuid = body.take(16).hex()
        kind = body.varint()
        if kind != 0:
            raise OcdbtError(f"{path}: manifest kind {kind} (only a single "
                             f"manifest file, kind 0, is read)")
        self.max_inline_value_bytes = body.varint()
        self.max_decoded_node_bytes = body.varint()
        self.version_tree_arity_log2 = body.u8()
        method = body.varint()
        if method == 1:
            (level,) = struct.unpack("<i", body.take(4))
            self.compression = {"id": "zstd", "level": level}
        elif method == 0:
            self.compression = None
        else:
            raise OcdbtError(f"{path}: unknown compression method {method}")
        files = _read_files(body, self.dir)
        newest = _versions(body, files)
        _skip_version_refs(body, files)
        body.end()
        if not newest:
            raise OcdbtError(f"{path}: no version")
        self.version = newest[-1]
        self._entries = None

    def items(self) -> dict:
        """{key: bytes or Ref} of every key, in key order."""
        if self._entries is None:
            out = {}
            if self.version.root is not None:
                self._walk(self.version.root, self.version.root_height, b"",
                           out)
            self._entries = out
        return self._entries

    def _walk(self, ref: Ref, height: int, prefix: bytes, out: dict):
        what = f"{ref.path}@{ref.offset}"
        body = unframe(read_ref(ref), BTREE_MAGIC, what)
        if len(body) > self.max_decoded_node_bytes:
            raise OcdbtError(f"{what}: node of {len(body)} bytes above "
                             f"max_decoded_node_bytes")
        b = _Body(body, what)
        got = b.u8()
        if got != height:
            raise OcdbtError(f"{what}: node of height {got}, {height} "
                             f"expected")
        files = _read_files(b, self.dir)
        n = b.varint()
        if n == 0:
            raise OcdbtError(f"{what}: a node without entries")
        shared = [0] + b.varints(n - 1)
        suffix = b.varints(n)
        common = b.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise OcdbtError(f"{what}: key prefix beyond the previous "
                                 f"key")
            prev = prev[:shared[i]] + b.take(suffix[i])
            keys.append(prev)
        if height == 0:
            lengths = b.varints(n)
            kinds = b.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise OcdbtError(f"{what}: unknown value kind")
            fid = b.varints(len(indirect))
            off = b.varints(len(indirect))
            values = [None] * n
            for j, i in enumerate(indirect):
                values[i] = Ref(_file(files, fid[j], what), off[j],
                                lengths[i])
            for i in range(n):
                out[prefix + keys[i]] = (b.take(lengths[i]) if kinds[i] == 0
                                         else values[i])
            b.end()
            return
        fid, off, length = b.varints(n), b.varints(n), b.varints(n)
        b.varints(n), b.varints(n), b.varints(n)       # child statistics
        b.end()
        for i in range(n):
            if common[i] > len(keys[i]):
                raise OcdbtError(f"{what}: common prefix beyond the key")
            self._walk(Ref(_file(files, fid[i], what), off[i], length[i]),
                       height - 1, prefix + keys[i][:common[i]], out)


# --------------------------------------------------------------- writing

def _manifest(files: list, root_file: int, root_offset: int,
              root_length: int, num_keys: int,
              indirect_bytes: int) -> bytes:
    """A manifest of orbax's configuration (a new uuid) whose one version,
    generation 1, is a tree of one leaf node."""
    body = [uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
            _varint(MAX_DECODED_NODE_BYTES),
            bytes([VERSION_TREE_ARITY_LOG2]), _varint(1),
            struct.pack("<i", 0), _write_files(files),
            _varint(1), _varint(1), bytes([0]), _varint(root_file),
            _varint(root_offset), _varint(root_length), _varint(num_keys),
            _varint(root_length), _varint(indirect_bytes),
            struct.pack("<Q", time.time_ns()),
            _varint(0)]                           # no version tree nodes
    return frame(MANIFEST_MAGIC, b"".join(body))


def _leaf(entries: list, files: list) -> bytes:
    """A B-tree leaf of sorted (key, value) pairs, each value bytes (inline)
    or (data file index, offset, length)."""
    keys = [k for k, _ in entries]
    shared = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffixes = [keys[0]] + [keys[i][shared[i - 1]:]
                            for i in range(1, len(keys))]
    lengths = [len(v) if isinstance(v, bytes) else v[2] for _, v in entries]
    kinds = [0 if isinstance(v, bytes) else 1 for _, v in entries]
    refs = [v for _, v in entries if not isinstance(v, bytes)]
    return b"".join([
        bytes([0]), _write_files(files), _varint(len(keys)),
        _varints(shared), _varints(len(s) for s in suffixes),
        b"".join(suffixes), _varints(lengths), _varints(kinds),
        _varints(r[0] for r in refs), _varints(r[1] for r in refs),
        b"".join(v for _, v in entries if isinstance(v, bytes))])


def _nbytes(buf) -> int:
    return memoryview(buf).nbytes


def _write_tree(directory: str, entries: list, files: list,
                own_values: list) -> None:
    """One data file under `directory`/d/ holding `own_values` (buffers,
    which the indirect entries naming data file len(files) point into)
    and the leaf after them; then the manifest."""
    name = "d/" + uuid.uuid4().hex
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    all_files = sorted(set(files) | {("", name)})
    index = {f: i for i, f in enumerate(all_files)}
    remap = [index[f] for f in files] + [index[("", name)]]
    entries = [(k, v if isinstance(v, bytes) else (remap[v[0]],) + v[1:])
               for k, v in entries]
    node = frame(BTREE_MAGIC, _leaf(entries, all_files))
    offset = sum(_nbytes(v) for v in own_values)
    with open(os.path.join(directory, name), "wb") as f:
        for v in own_values:
            f.write(v)
        f.write(node)
    manifest = _manifest(all_files, index[("", name)], offset, len(node),
                         len(entries),
                         sum(v[2] for _, v in entries
                             if not isinstance(v, bytes)))
    tmp = os.path.join(directory, MANIFEST + ".tmp")
    with open(tmp, "wb") as f:
        f.write(manifest)
    os.replace(tmp, os.path.join(directory, MANIFEST))


def write_database(directory: str, values: dict) -> None:
    """A new database in `directory` holding `values` ({key bytes: a
    buffer, or a list of buffers that make the value in order}): values up
    to MAX_INLINE_VALUE_BYTES in the leaf, larger ones in its data file
    ahead of it."""
    os.makedirs(directory, exist_ok=True)
    entries, own, offset = [], [], 0
    for key in sorted(values):
        parts = values[key]
        if not isinstance(parts, list):
            parts = [parts]
        n = sum(_nbytes(p) for p in parts)
        if n <= MAX_INLINE_VALUE_BYTES:
            entries.append((key, b"".join(bytes(p) for p in parts)))
        else:
            entries.append((key, (0, offset, n)))
            own += parts
            offset += n
    _check_node_size(entries)
    _write_tree(directory, entries, [], own)


def merge_databases(directory: str, children: list) -> None:
    """A database in `directory` whose one leaf holds every key of the
    databases in its subdirectories `children` (each a name relative to
    `directory`): inline values copied, indirect ones referencing the
    children's data files, as orbax's root over its per-process
    databases. A key in two children raises."""
    merged = {}
    for child in children:
        db = Database(os.path.join(directory, child))
        for key, v in db.items().items():
            if key in merged:
                raise OcdbtError(f"key {key!r} in two process databases")
            if isinstance(v, Ref):
                rel = os.path.relpath(v.path, db.dir).replace(os.sep, "/")
                v = (child.rstrip("/") + "/", rel, v.offset, v.length)
            merged[key] = v
    files = sorted({(v[0], v[1]) for v in merged.values()
                    if not isinstance(v, bytes)})
    index = {f: i for i, f in enumerate(files)}
    entries = [(k, v if isinstance(v, bytes)
                else (index[(v[0], v[1])], v[2], v[3]))
               for k, v in sorted(merged.items())]
    _check_node_size(entries)
    _write_tree(directory, entries, files, [])


def _check_node_size(entries: list) -> None:
    size = sum(len(k) + (len(v) if isinstance(v, bytes) else 8) + 8
               for k, v in entries)
    if size > MAX_DECODED_NODE_BYTES:
        raise OcdbtError(f"{len(entries)} keys need a leaf of about {size} "
                         f"bytes, above max_decoded_node_bytes; only "
                         f"one-leaf databases are written")


def value_array(value) -> np.ndarray:
    """A value (bytes or Ref) as a uint8 array."""
    data = read_ref(value) if isinstance(value, Ref) else value
    return np.frombuffer(data, np.uint8)
