"""The port's OCDBT store (msnv_tpu_torch/training/ocdbt.py) against
tensorstore's, on the CPU.

Every key and value that tensorstore lists in the committed orbax fixtures
(tests/data/orbax: one process, the 8-device sharded layout, two
processes; the root database and each process's) and in fresh saves of the
JAX package's save_checkpoint_orbax equals the port's reading. So does
the newest version of tensorstore's own databases with interior B-tree
nodes, many commits (older versions in version tree nodes) and
uncompressed nodes. The other way round,
tensorstore reads the databases the port writes (one a process, and the
root over them). Damaged files raise. Tolerance: none; bytes are compared.
"""

import os
import shutil
import struct

import numpy as np
import pytest

from msnv_tpu_torch.training import ocdbt

ts = pytest.importorskip("tensorstore")

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "orbax")


def _ts_items(directory):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{directory}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _port_items(directory):
    items = ocdbt.Database(directory).items()
    assert list(items) == sorted(items)
    return {k: ocdbt.value_array(v).tobytes() for k, v in items.items()}


def _databases(root):
    return [root] + [os.path.join(root, d) for d in sorted(os.listdir(root))
                     if d.startswith("ocdbt.process_")]


@pytest.mark.parametrize("name", ["trainer", "sharded", "twoproc"])
def test_fixtures_read_as_tensorstore_reads_them(name):
    root = os.path.join(FIXTURES, f"{name}.orbax")
    dbs = _databases(root)
    assert len(dbs) == (3 if name == "twoproc" else 2)
    for d in dbs:
        want = _ts_items(d)
        assert want and _port_items(d) == want, d


def test_fresh_jax_saves_read_as_tensorstore_reads_them(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from msnv_tpu.training.checkpoint import save_checkpoint_orbax
    rng = np.random.RandomState(3)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    state = {f"a{i:02d}": jnp.asarray(rng.rand(40 + i), jnp.float32)
             for i in range(24)}              # 24 commits: older versions
    state["big"] = jnp.asarray(rng.randn(300, 200), jnp.float32)
    state["w"] = jax.device_put(jnp.asarray(rng.randn(64, 32), jnp.float32),
                                NamedSharding(mesh, P("data", "model")))
    state["h"] = jnp.asarray(rng.randn(8, 8), jnp.bfloat16)
    state["n"] = 5
    path = str(tmp_path / "fresh.orbax")
    save_checkpoint_orbax(path, state, {"epoch": 1})
    for d in _databases(path):
        want = _ts_items(d)
        assert _port_items(d) == want, d
    root = ocdbt.Database(path)
    assert root.compression == {"id": "zstd", "level": 0}
    assert root.max_inline_value_bytes == ocdbt.MAX_INLINE_VALUE_BYTES
    assert root.max_decoded_node_bytes == ocdbt.MAX_DECODED_NODE_BYTES
    assert isinstance(root.items()[b"big/0.0"], ocdbt.Ref)


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 5}])
def test_interior_nodes_and_version_tree(tmp_path, compression):
    """Small nodes give a B-tree several levels high; arity 2 and many
    commits put the older versions in version tree nodes; the newest
    reads as tensorstore reads it."""
    d = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{d}/",
                          "config": {"max_decoded_node_bytes": 150,
                                     "max_inline_value_bytes": 8,
                                     "version_tree_arity_log2": 1,
                                     "compression": compression}}).result()
    for g in range(9):
        with ts.Transaction() as txn:
            for i in range(7):
                kv.with_transaction(txn).write(
                    f"key{g:02d}/{i:03d}".encode(),
                    (f"v{g}.{i}" * (i + 1)).encode()).result()
        if g == 4:
            kv.delete_range(ts.KvStore.KeyRange(b"key01/003",
                                                b"key01/004")).result()
    db = ocdbt.Database(d)
    assert db.version.root_height > 1
    assert db.version.generation >= 10       # beyond the manifest's 2
    assert _port_items(d) == _ts_items(d)


def test_tensorstore_reads_the_port_databases(tmp_path):
    rng = np.random.RandomState(4)
    root = str(tmp_path / "ck")
    zero = {b"a/.zarray": b'{"x": 1}', b"a/0": rng.bytes(5000),
            b"b/0": rng.bytes(10), b"c/0.0": np.arange(300, dtype=np.float32),
            b"e": b""}
    one = {b"a/1": [rng.bytes(200_000), rng.bytes(7)],
           b"b/1": rng.bytes(1025), b"b/2": rng.bytes(1024)}
    ocdbt.write_database(os.path.join(root, "ocdbt.process_0"), zero)
    ocdbt.write_database(os.path.join(root, "ocdbt.process_1"), one)
    ocdbt.merge_databases(root, ["ocdbt.process_0", "ocdbt.process_1"])

    def flat(values):
        return {k: b"".join(bytes(memoryview(p).cast("B"))
                            for p in (v if isinstance(v, list) else [v]))
                for k, v in values.items()}

    assert _ts_items(os.path.join(root, "ocdbt.process_0")) == flat(zero)
    assert _ts_items(os.path.join(root, "ocdbt.process_1")) == flat(one)
    both = {**flat(zero), **flat(one)}
    assert _ts_items(root) == both == _port_items(root)
    items = ocdbt.Database(root).items()
    assert isinstance(items[b"b/1"], ocdbt.Ref)        # above 1024 bytes
    assert isinstance(items[b"b/2"], bytes)            # inline
    assert items[b"b/1"].path.startswith(
        os.path.join(root, "ocdbt.process_1", "d"))


def _copy(src, tmp_path):
    dst = str(tmp_path / "copy.orbax")
    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("damage", ["crc", "magic", "length", "version",
                                    "truncated", "compression"])
def test_damaged_files_raise(tmp_path, damage):
    root = _copy(os.path.join(FIXTURES, "sharded.orbax"), tmp_path)
    manifest = os.path.join(root, ocdbt.MANIFEST)
    with open(manifest, "rb") as f:
        data = bytearray(f.read())
    if damage == "crc":
        data[20] ^= 1
        match = "CRC32C"
    elif damage == "magic":
        data[0] ^= 0xFF
        match = "magic"
    elif damage == "length":
        data += b"\0"
        match = "frame says"
    elif damage == "truncated":
        data = data[:10]
        match = "too short"
    else:
        # a frame with another format version or compression, its CRC
        # made right
        body = data[12:-4]
        body[0 if damage == "version" else 1] = 7
        data = data[:12] + body
        data += struct.pack("<I", ocdbt.zstd.crc32c(bytes(data)))
        match = "format version 7" if damage == "version" \
            else "unknown compression 7"
    with open(manifest, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ocdbt.OcdbtError, match=match):
        ocdbt.Database(root).items()


def test_damaged_node_raises(tmp_path):
    root = _copy(os.path.join(FIXTURES, "trainer.orbax"), tmp_path)
    db = ocdbt.Database(root)
    node = db.version.root
    with open(node.path, "r+b") as f:
        f.seek(node.offset + node.length - 10)
        b = f.read(1)
        f.seek(node.offset + node.length - 10)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(ocdbt.OcdbtError, match="CRC32C"):
        ocdbt.Database(root).items()
