"""Checkpointing: params + optimizer state + TBPTT hidden + data cursor.

The port's counterpart of the JAX package's training/checkpoint.py, in the
same file format, so a checkpoint written by either package loads in the
other:

- one `.npz` with every leaf under "leaf:" + the JAX tree_util.keystr of its
  path in the JAX trainer's state, plus a JSON "__meta__" entry
  ({"epoch", "iteration", "tag", "chunk", "val_loss"});
- the port's trainer state {"params", "opt_state", "tier_state"} (and for
  the GAN variant "disc_params", "disc_opt_state") maps to the JAX keys
  leaf for leaf: params, tier_state and disc_params under their own paths;
  an optimizer state {"count", "mu", "nu"} under its optax chain
  (ClipState, (ScaleByAdamState, EmptyState)), whose only leaves are
  "['opt_state'][1][0].count" (an int32 0-d array), ".mu[...]" and
  ".nu[...]" (the same under ['disc_opt_state']); with the scheduler the
  chain also holds the schedule's state, whose one leaf "[1][1].count"
  equals the Adam count: a save with `scheduled=True` writes it from
  "count", and loading ignores it;
- `ep{E}-it{I}.npz` per epoch (older "last" checkpoints deleted unless
  keep_old) and `best-ep{E}-it{I}.npz` tracked on validation loss (ref
  plugins.py:113-155), written first and deleted after, each write atomic
  (`.tmp` + os.replace); epoch / iteration parse back out of the file name
  on resume (ref train.py:110-126); a new manager recovers the best loss
  from an existing best checkpoint's meta.

Loading walks a template in the port's layout (partial templates work:
generate and evaluate read {"params": ...} only) and places each leaf on
the template leaf's device, or on `device`.

Under torch.distributed (one process per GPU) the manager keeps the JAX
package's npz discipline: the state handed to it is the full one
(Trainer.checkpoint_state gathers model-sharded leaves and lanes), only
rank 0 writes and deletes, a barrier follows each save, and rank 0's best
loss is broadcast at start (as its float64 bit pattern), so every rank
makes the same save decisions. The ranks need one shared checkpoints
directory: `resume_point` is rank 0's newest checkpoint, and every rank
must see it there, so every rank loads the same file.

The directory backend, `backend="dcp"`: `ep{E}-it{I}.dcp/` directories
written with torch.distributed.checkpoint, the port's counterpart of the
JAX package's orbax backend (orbax's own format needs jax and
tensorstore). It keeps the same leaf keys. Every rank calls the save (a
collective): each writes the slices it stores, given as DTensors over the
mesh (Trainer.checkpoint_state(sharded=True): the 'model' slices of the
params and moments, the tier state's lanes over 'data'), and a replicated
leaf is written once. The meta is `msnv_meta.json`, which rank 0 writes;
the directory is written as `<name>.tmp` and renamed by rank 0 between
barriers, so a `.dcp` name is always whole. Loading reshards into the
template's layout (DTensor leaves take their slices, plain leaves the
whole tensor; one process reads any), and a partial template reads its
subtree.

The JAX package's orbax backend, `backend="orbax"`: `ep{E}-it{I}.orbax/`
directories in orbax's own layout, read and written without jax, orbax or
tensorstore, so that a checkpoint of either package loads in the other.
Each leaf is a zarr v2 array named by its JAX tree path ("opt_state.1.0.mu.
mlp.hidden.w": the same keys as the .npz, dotted) in an OCDBT database
(training/ocdbt.py), its chunks zstd frames (training/zstd.py: the
repository's decoder; writes store raw blocks); `_METADATA` holds the tree
(with the optax chain's empty states) and `msnv_meta.json` the meta. The
save is a collective like dcp's: each rank writes the chunks it stores (a
DTensor's 'model' or 'data' slices, one chunk each; rank 0 every plain
leaf and every array's metadata) into its own database,
`ocdbt.process_<rank>/`, and rank 0 writes the root database over them
and the rest, renaming `<name>.tmp` between barriers. Loading reads any
chunking (orbax's own splits replicated arrays across processes) into the
template's layout, DTensor leaves their slices; a chunk the store lacks
is the array's fill value where `_METADATA` says chunks equal to it were
skipped, and raises KeyError where it says every chunk is stored.
`load_any` reads every format; the manager finds them all.
"""

from __future__ import annotations

import base64
import contextlib
import glob
import io
import itertools
import json
import os
import re
import shutil
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from msnv_tpu_torch.parallel.mesh import (any_rank, barrier,
                                          broadcast_int64, is_main_process)
from msnv_tpu_torch.training import ocdbt, zstd
from msnv_tpu_torch.tree import keystr, leaves_with_paths, map_with_paths

LAST_PATTERN = "ep{}-it{}.npz"                    # ref plugins.py:117
BEST_PATTERN = "best-ep{}-it{}.npz"               # ref plugins.py:118
_LAST_RE = re.compile(r"^ep(\d+)-it(\d+)\.(npz|dcp|orbax)$")
_BEST_RE = re.compile(r"^best-ep(\d+)-it(\d+)\.(npz|dcp|orbax)$")
META_FILE = "msnv_meta.json"   # the meta of a directory checkpoint
BACKENDS = ("npz", "dcp", "orbax")

# the optimizer states, each an optax chain whose ScaleByAdamState is at
# [1][0] and, with the scheduler, whose ScaleByScheduleState is at [1][1]
_OPT_STATES = ("opt_state", "disc_opt_state")


def _key(path) -> str:
    """The JAX key of a port state leaf: an optimizer's {count, mu, nu}
    under its optax chain, everything else under its own path."""
    if path[:1] and path[0] in _OPT_STATES and path[1:2] in (
            ("count",), ("mu",), ("nu",)):
        return ("leaf:" + keystr(path[:1]) + "[1][0]." + path[1]
                + keystr(path[2:]))
    return "leaf:" + keystr(path)


def _to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, int):
        return np.asarray(x, np.int32)      # the optimizer's step count
    return np.asarray(x)


def flatten_state(state, scheduled: bool = False) -> dict:
    """{checkpoint key: host array} of a port state tree; `scheduled`
    (the run's TrainConfig.scheduler) adds each optimizer chain's schedule
    count."""
    flat = {_key(path): _to_numpy(x)
            for path, x in leaves_with_paths(state)}
    if scheduled:
        for name in _OPT_STATES:
            if name in state:
                flat[f"leaf:{keystr((name,))}[1][1].count"] = _to_numpy(
                    state[name]["count"])
    return flat


def save_checkpoint(path: str, state, meta: dict | None = None,
                    scheduled: bool = False) -> None:
    """Save a port state tree (+ JSON-serializable `meta`) to `path`;
    `scheduled` as in flatten_state.

    Every leaf is copied to the host before the file is written, so the
    state may be updated in place as soon as this returns."""
    arrays = flatten_state(state, scheduled)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic


def load_checkpoint(path: str, template, device=None):
    """Load into the structure of `template`; returns (state, meta).

    Every template path must exist in the checkpoint (KeyError names the
    missing path otherwise); extra checkpoint entries are ignored. A tensor
    leaf comes back in the template leaf's dtype on `device`, or on the
    template leaf's device; an int leaf (the optimizer's count) as an int.
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")

        def fill(path_in_tree, t):
            key = _key(path_in_tree)
            if key not in z:
                raise KeyError(f"checkpoint {path} has no entry {key}")
            arr = z[key]
            if isinstance(t, int):
                return int(arr)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint {path}: shape mismatch at {key}: "
                    f"saved {tuple(arr.shape)} vs expected "
                    f"{tuple(t.shape)} — wrong config/tag for this "
                    f"checkpoint?")
            arr = np.ascontiguousarray(arr).reshape(arr.shape)  # keeps 0-d
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                # bfloat16 (ml_dtypes), which numpy saves as 2 raw bytes
                out = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                out = torch.from_numpy(arr)
            out = out.to(t.dtype)
            return out.to(device if device is not None else t.device)

        state = map_with_paths(fill, template)
    return state, meta


# -- the directory backend (torch.distributed.checkpoint) -------------------

def _norm_ckpt_path(path: str) -> str:
    """Without trailing slashes, so that a tab-completed `x.dcp/` dispatches
    on its extension."""
    return os.path.abspath(os.path.normpath(path))


def is_dcp(path: str) -> bool:
    return _norm_ckpt_path(path).endswith(".dcp")


@contextlib.contextmanager
def _one_process_quiet():
    """DCP warns at every save and load without a process group; one
    process is a use this module intends."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        yield


def _dcp_leaf(x):
    # the optimizer's step count is an int in the port's state
    return torch.tensor(x, dtype=torch.int32) if isinstance(x, int) else x


def save_checkpoint_dcp(path: str, state, meta: dict | None = None) -> None:
    """Save a state tree (tensors, DTensors, ints) as a `.dcp` directory.

    Under a process group every rank calls it (a collective): each writes
    the slices it stores, a replicated leaf is written once, and rank 0
    writes the meta and renames `<path>.tmp` to `path` between barriers."""
    import torch.distributed.checkpoint as dcp
    path = _norm_ckpt_path(path)
    tmp = path + ".tmp"
    main = is_main_process()
    if main and os.path.exists(tmp):
        shutil.rmtree(tmp)
    barrier()
    with _one_process_quiet():
        dcp.save({_key(p): _dcp_leaf(x)
                  for p, x in leaves_with_paths(state)}, checkpoint_id=tmp)
    if main:
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta or {}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    barrier()


def load_checkpoint_dcp(path: str, template, device=None):
    """Load a `.dcp` directory into the structure of `template`; returns
    (state, meta). The load_checkpoint contract (missing entries raise
    KeyError, a shape that differs ValueError; extra entries are ignored;
    plain tensor leaves come back in the template leaf's dtype on `device`
    or the template leaf's device, int leaves as ints). DTensor leaves are
    loaded in place, each rank reading its slices; under a process group
    every rank calls it."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor
    path = _norm_ckpt_path(path)
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    buffers = {}
    for path_in_tree, t in leaves_with_paths(template):
        key = _key(path_in_tree)
        if key not in saved:
            raise KeyError(f"checkpoint {path} has no entry {key}")
        shape = () if isinstance(t, int) else tuple(t.shape)
        if tuple(saved[key].size) != shape:
            raise ValueError(
                f"checkpoint {path}: shape mismatch at {key}: saved "
                f"{tuple(saved[key].size)} vs expected {shape} — wrong "
                f"config/tag for this checkpoint?")
        if isinstance(t, int):
            buffers[key] = torch.zeros((), dtype=torch.int32)
        elif isinstance(t, DTensor):
            buffers[key] = t
        else:
            buffers[key] = torch.empty(shape, dtype=t.dtype)
    with _one_process_quiet():
        dcp.load(buffers, checkpoint_id=path)

    def fill(path_in_tree, t):
        out = buffers[_key(path_in_tree)]
        if isinstance(t, int):
            return int(out)
        if isinstance(t, DTensor):
            return out
        return out.to(device if device is not None else t.device)

    return map_with_paths(fill, template), _load_meta(path)


# -- orbax's format (an OCDBT database of zarr v2 arrays) -------------------

_PROCESS_DB = "ocdbt.process_{}"
_ZARR_DTYPES = {torch.float32: "<f4", torch.float64: "<f8",
                torch.float16: "<f2", torch.bfloat16: "bfloat16",
                torch.int8: "|i1", torch.int16: "<i2", torch.int32: "<i4",
                torch.int64: "<i8", torch.uint8: "|u1", torch.bool: "|b1"}
_TORCH_DTYPES = {v: k for k, v in _ZARR_DTYPES.items()}
# where msnv_tpu's load_checkpoint_orbax places each array it restores
# (orbax reads the placement from `_sharding`): replicated over a mesh of
# every JAX device of every process (no device_mesh: orbax takes
# jax.devices(), reshaped to [-1]), so one process or many restore it
_REPLICATED = json.dumps({
    "sharding_type": "NamedSharding", "shape": [-1], "axis_names": ["data"],
    "partition_spec": []})
_CHECKPOINT_HANDLER = ("orbax.checkpoint._src.handlers."
                       "pytree_checkpoint_handler.PyTreeCheckpointHandler")


def is_orbax(path: str) -> bool:
    return _norm_ckpt_path(path).endswith(".orbax")


def is_sharded_format(path: str) -> bool:
    """A directory format whose save is a collective of every rank's
    slices (dcp, orbax): the state to load into or save is
    Trainer.checkpoint_state(sharded=True)."""
    return is_dcp(path) or is_orbax(path)


def _tree_path(path) -> tuple:
    """The JAX tree path of a port state leaf as orbax keys it: (key,
    key_type) pairs, key_type 1 for a sequence index and 2 for a dict key
    or a NamedTuple field; an optimizer's {count, mu, nu} under its optax
    chain ([1][0], as _key)."""
    if path[:1] and path[0] in _OPT_STATES and path[1:2] in (
            ("count",), ("mu",), ("nu",)):
        path = (path[0], 1, 0) + tuple(path[1:])
    return tuple((str(p), 1 if isinstance(p, int) else 2) for p in path)


def _name(tree_path) -> str:
    """orbax's parameter name: the keys joined by dots (the zarr array's
    directory in the database)."""
    return ".".join(k for k, _ in tree_path)


def _sort_key(tree_path):
    # JAX's flattening order: dict keys sorted, sequences in index order
    return [(t, int(k) if t == 1 else k) for k, t in tree_path]


def _zarray(shape, chunks, dtype: str) -> bytes:
    return json.dumps(
        {"chunks": list(chunks), "compressor": {"id": "zstd", "level": 1},
         "dimension_separator": ".", "dtype": dtype, "fill_value": None,
         "filters": None, "order": "C", "shape": list(shape),
         "zarr_format": 2}, separators=(",", ":"), sort_keys=True).encode()


def _chunk_key(name: str, index) -> bytes:
    return f"{name}/{'.'.join(map(str, index)) if index else '0'}".encode()


def _host(x: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host in C order (bfloat16 as its bits)."""
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy()


def _layout(x):
    """(shape, chunk shape, dtype, this rank's chunk as (index, host
    array) or None when another rank writes it) of a state leaf. A
    DTensor's chunks are its slices over the mesh's Shard placements, and
    the replica at coordinate 0 of every Replicate axis writes them; a
    plain tensor or an int (written as int32, as the JAX trainer's
    count) is one chunk, which rank 0 writes."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, int):
        x = torch.tensor(x, dtype=torch.int32)
    if not isinstance(x, DTensor):
        shape = tuple(x.shape)
        mine = ((0,) * len(shape), _host(x)) if is_main_process() else None
        return shape, shape, _ZARR_DTYPES[x.dtype], mine
    shape = tuple(x.shape)
    chunks, index = list(shape), [0] * len(shape)
    coord = x.device_mesh.get_coordinate()
    writer = True
    for axis, placement in enumerate(x.placements):
        if placement.is_shard():
            dim = placement.dim % len(shape)
            if chunks[dim] != shape[dim]:
                raise ValueError(f"a leaf sharded twice along dim {dim}")
            chunks[dim] = max(1, -(-shape[dim] // x.device_mesh.size(axis)))
            index[dim] = coord[axis]
        elif placement.is_replicate():
            writer = writer and coord[axis] == 0
        else:
            raise ValueError(f"orbax checkpoints take Shard and Replicate "
                             f"placements, not {placement}")
    mine = None
    if writer and all(i * c < n for i, c, n in zip(index, chunks, shape)):
        local = _host(x.to_local())
        if local.shape != tuple(chunks):          # the last, partial slice
            full = np.zeros(chunks, local.dtype)
            full[tuple(slice(0, n) for n in local.shape)] = local
            local = full
        mine = (tuple(index), local)
    return shape, tuple(chunks), _ZARR_DTYPES[x.dtype], mine


def _orbax_leaves(state, scheduled: bool):
    """(tree path, leaf) of every array of a port state in orbax's tree,
    and the tree paths of the empty optax states (the clip's, and the
    schedule's without the scheduler), which orbax records as None."""
    arrays = [(_tree_path(p), x) for p, x in leaves_with_paths(state)]
    empty = []
    for name in _OPT_STATES:
        if name in state:
            empty.append(((name, 2), ("0", 1)))
            schedule = ((name, 2), ("1", 1), ("1", 1))
            if scheduled:
                arrays.append((schedule + (("count", 2),),
                               state[name]["count"]))
            else:
                empty.append(schedule)
    return arrays, empty


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def save_checkpoint_orbax(path: str, state, meta: dict | None = None,
                          scheduled: bool = False) -> None:
    """Save a state tree (tensors, DTensors, ints) as an orbax checkpoint
    directory, which msnv_tpu's load_checkpoint_orbax restores; `scheduled`
    as in flatten_state.

    The layout is orbax's: every leaf a zarr v2 array (zstd "compressor"
    named, the chunks stored as raw zstd blocks) in an OCDBT database, one
    chunk a 'model' or 'data' slice of a DTensor, one database a rank
    (`ocdbt.process_<rank>/`) and rank 0's root database over them; the
    tree in `_METADATA`, `_sharding`, `_CHECKPOINT_METADATA`,
    `array_metadatas/process_<rank>`, and the meta in `msnv_meta.json`.
    Under a process group every rank calls it (a collective); rank 0 merges
    the databases, writes the rest and renames `<path>.tmp` to `path`
    between barriers."""
    path = _norm_ckpt_path(path)
    tmp = path + ".tmp"
    main = is_main_process()
    rank = dist.get_rank() if dist.is_initialized() else 0
    started = time.time_ns()
    if main and os.path.exists(tmp):
        shutil.rmtree(tmp)
    barrier()
    arrays, empty = _orbax_leaves(state, scheduled)
    values, written, tree = {}, [], {}
    for tree_path, x in arrays:
        name = _name(tree_path)
        shape, chunks, dtype, mine = _layout(x)
        tree[tree_path] = {"value_type": "jax.Array",
                           "skip_deserialize": False,
                           "write_shape": list(chunks)}
        if main:
            values[f"{name}/.zarray".encode()] = _zarray(shape, chunks,
                                                         dtype)
        if mine is not None:
            index, data = mine
            values[_chunk_key(name, index)] = zstd.frame_parts(data)
            written.append({"array_metadata": {
                "param_name": name, "write_shape": list(chunks),
                "chunk_shape": list(chunks), "ext_metadata": None}})
    for tree_path in empty:
        tree[tree_path] = {"value_type": "None", "skip_deserialize": True}
    if values:
        ocdbt.write_database(os.path.join(tmp, _PROCESS_DB.format(rank)),
                             values)
    os.makedirs(os.path.join(tmp, "array_metadatas"), exist_ok=True)
    _write_json(os.path.join(tmp, "array_metadatas", f"process_{rank}"),
                {"array_metadatas": written})
    barrier()
    if main:
        children = sorted(d for d in os.listdir(tmp)
                          if d.startswith("ocdbt.process_"))
        ocdbt.merge_databases(tmp, children)
        _write_json(os.path.join(tmp, "_METADATA"), {
            "tree_metadata": {
                str(tuple(k for k, _ in tp)): {
                    "key_metadata": [{"key": k, "key_type": t}
                                     for k, t in tp],
                    "value_metadata": tree[tp]}
                for tp in sorted(tree, key=_sort_key)},
            "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None})
        _write_json(os.path.join(tmp, "_sharding"), {
            base64.b64encode(_name(tp).encode()).decode(): _REPLICATED
            for tp in sorted(tree, key=_sort_key)
            if tree[tp]["value_type"] == "jax.Array"})
        _write_json(os.path.join(tmp, META_FILE), meta or {})
        _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
            "item_handlers": _CHECKPOINT_HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": started,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}})
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    barrier()


def _numpy_dtype(zarray: dict, where: str):
    dtype = zarray["dtype"]
    if dtype == "bfloat16":
        return np.dtype(np.int16)
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"{where}: zarr dtype {dtype!r} is not read")
    return np.dtype(dtype)


def _fill(zarray: dict, dtype: np.dtype):
    """The zarr fill value of a chunk the database lacks (null reads as 0,
    as tensorstore's)."""
    v = zarray.get("fill_value")
    if v is None:
        return 0
    if zarray["dtype"] == "bfloat16":
        return torch.tensor(float(v), dtype=torch.bfloat16).view(
            torch.int16).item()
    return np.asarray(float(v) if isinstance(v, str) else v).astype(dtype)


class _OrbaxReader:
    """A checkpoint's arrays: the database's entries and the zarr
    metadata, each array read whole or a region of it."""

    def __init__(self, path: str):
        self.path = path
        self.entries = ocdbt.Database(path).items()
        # orbax stores every chunk when _METADATA says so (as it and this
        # module write): then a chunk the store lacks is damage, not the
        # fill value of a chunk that was skipped
        metadata = os.path.join(path, "_METADATA")
        self.every_chunk = False
        if os.path.isfile(metadata):
            with open(metadata) as f:
                self.every_chunk = bool(json.load(f).get(
                    "store_array_data_equal_to_fill_value"))

    def zarray(self, name: str, key: str) -> dict:
        raw = self.entries.get(f"{name}/.zarray".encode())
        if raw is None:
            raise KeyError(f"checkpoint {self.path} has no entry {key}")
        z = json.loads(ocdbt.value_array(raw).tobytes())
        if z.get("zarr_format") != 2 or z.get("order", "C") != "C" \
                or z.get("filters") not in (None, []):
            raise ValueError(f"checkpoint {self.path}: {name} is not a C "
                             f"order zarr v2 array without filters")
        if z.get("dimension_separator", ".") != ".":
            raise ValueError(f"checkpoint {self.path}: {name} has dimension "
                             f"separator {z['dimension_separator']!r} (only "
                             f"'.' is read)")
        compressor = z.get("compressor")
        if compressor is not None and compressor.get("id") != "zstd":
            raise ValueError(f"checkpoint {self.path}: {name} has "
                             f"compressor {compressor}")
        return z

    def region(self, name: str, z: dict, starts, sizes) -> torch.Tensor:
        """The block [starts, starts + sizes) of array `name`."""
        shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
        dtype = _numpy_dtype(z, name)
        out = np.empty(sizes, dtype)
        if len(shape) == 0:
            grid = [()]
        else:
            grid = itertools.product(*[
                range(s // c, -(-(s + n) // c)) if n else range(0)
                for s, n, c in zip(starts, sizes, chunks)])
        for index in grid:
            raw = self.entries.get(_chunk_key(name, index))
            if raw is None and self.every_chunk:
                raise KeyError(f"checkpoint {self.path} has no chunk "
                               f"{_chunk_key(name, index).decode()}, though "
                               f"_METADATA says every chunk is stored")
            if raw is None:
                chunk = np.full(chunks, _fill(z, dtype), dtype)
            else:
                data = ocdbt.value_array(raw)
                nbytes = int(np.prod(chunks)) * dtype.itemsize
                if z.get("compressor") is not None:
                    data = zstd.decompress(data, nbytes)
                elif data.size != nbytes:
                    raise ValueError(f"checkpoint {self.path}: chunk "
                                     f"{name}/{index} of {data.size} bytes")
                chunk = data.view(dtype).reshape(chunks)
            src, dst = [], []
            for i, c, s, n in zip(index, chunks, starts, sizes):
                lo, hi = max(i * c, s), min((i + 1) * c, s + n)
                src.append(slice(lo - i * c, hi - i * c))
                dst.append(slice(lo - s, hi - s))
            out[tuple(dst)] = chunk[tuple(src)]
        t = torch.from_numpy(out)
        return t.view(torch.bfloat16) if z["dtype"] == "bfloat16" else t


def _local_region(t, shape):
    """(starts, sizes) of a DTensor's local slice (torch.chunk's split of
    each Shard dim over its mesh axis)."""
    starts, sizes = [0] * len(shape), list(shape)
    coord = t.device_mesh.get_coordinate()
    for axis, placement in enumerate(t.placements):
        if placement.is_shard():
            dim = placement.dim % len(shape)
            step = -(-shape[dim] // t.device_mesh.size(axis))
            lo = min(shape[dim], coord[axis] * step)
            starts[dim], sizes[dim] = lo, min(shape[dim], lo + step) - lo
        elif not placement.is_replicate():
            raise ValueError(f"orbax checkpoints load into Shard and "
                             f"Replicate placements, not {placement}")
    return starts, sizes


def load_checkpoint_orbax(path: str, template, device=None):
    """Load an orbax checkpoint directory (msnv_tpu's save_checkpoint_orbax
    or this module's) into the structure of `template`; returns (state,
    meta). The load_checkpoint contract (missing entries raise KeyError, a
    shape that differs ValueError; extra entries are ignored, so a partial
    template such as {"params": ...} reads its subtree; plain tensor leaves
    come back in the template leaf's dtype on `device` or the template
    leaf's device, int leaves as ints). A DTensor leaf comes back as a
    DTensor of the same placements holding this rank's slice, read from
    the chunks it overlaps, whatever mesh wrote them; one process reads
    any checkpoint."""
    from torch.distributed.tensor import DTensor
    path = _norm_ckpt_path(path)
    reader = _OrbaxReader(path)

    def fill(path_in_tree, t):
        key = _key(path_in_tree)
        name = _name(_tree_path(path_in_tree))
        z = reader.zarray(name, key)
        shape = () if isinstance(t, int) else tuple(t.shape)
        if tuple(z["shape"]) != shape:
            raise ValueError(
                f"checkpoint {path}: shape mismatch at {key}: saved "
                f"{tuple(z['shape'])} vs expected {shape} — wrong "
                f"config/tag for this checkpoint?")
        if isinstance(t, int):
            return int(reader.region(name, z, (), ()))
        if isinstance(t, DTensor):
            starts, sizes = _local_region(t, shape)
            local = reader.region(name, z, starts, sizes).to(t.dtype)
            return DTensor.from_local(
                local.to(t.device), t.device_mesh, t.placements,
                run_check=False, shape=t.shape, stride=t.stride())
        out = reader.region(name, z, [0] * len(shape), shape).to(t.dtype)
        return out.to(device if device is not None else t.device)

    return map_with_paths(fill, template), _load_meta(path)


def load_any(path: str, template, device=None):
    """Format-dispatching load: a `.dcp` or `.orbax` directory, or an
    `.npz` file."""
    path = _norm_ckpt_path(path)
    if is_dcp(path):
        return load_checkpoint_dcp(path, template, device)
    if is_orbax(path):
        return load_checkpoint_orbax(path, template, device)
    return load_checkpoint(path, template, device)


def _load_meta(path: str) -> dict:
    """The meta dict of any format."""
    if is_sharded_format(path):
        meta_path = os.path.join(_norm_ckpt_path(path), META_FILE)
        if not os.path.isfile(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")


class CheckpointManager:
    """last/best retention policy over a checkpoints directory.

    backend: "npz" (single files, rank 0 writes the full state), "dcp" or
    "orbax" (directories, every rank writes its slices). latest() and
    best() find every format, so a run can switch backends and resume its
    history."""

    def __init__(self, checkpoints_dir: str, keep_old: bool = False,
                 backend: str = "npz", scheduled: bool = False):
        if backend not in BACKENDS:
            raise ValueError(f"checkpoint backend {backend!r}: one of "
                             f"{BACKENDS}")
        self.dir = checkpoints_dir
        self.keep_old = keep_old
        self.backend = backend
        self.scheduled = scheduled      # see flatten_state (npz, orbax)
        os.makedirs(checkpoints_dir, exist_ok=True)
        # recover the historical best from an existing best checkpoint's
        # meta, so a resumed run never overwrites a better past best
        self._best_loss = float("inf")
        existing = self.best()
        if existing is not None:
            try:
                meta = _load_meta(existing[0])
                self._best_loss = float(meta.get("val_loss", float("inf")))
            except (OSError, ValueError, KeyError):
                pass
        # a rank whose read of the best checkpoint failed (the except
        # above) would hold another best loss, and a save decision that
        # differs between ranks leaves them at different barriers: adopt
        # rank 0's, sent losslessly as the float64's bit pattern
        bits = np.asarray(self._best_loss, np.float64).view(np.int64)
        self._best_loss = float(np.asarray(
            broadcast_int64(int(bits)), np.int64).view(np.float64))

    def _save(self, path, state, meta):
        """npz: rank 0 writes, and the barrier keeps the other ranks from
        resuming or reading around a write in flight. dcp, orbax: every
        rank writes its part (fenced inside)."""
        if self.backend == "dcp":
            save_checkpoint_dcp(path, state, meta)
            return
        if self.backend == "orbax":
            save_checkpoint_orbax(path, state, meta, self.scheduled)
            return
        if is_main_process():
            save_checkpoint(path, state, meta, self.scheduled)
        barrier()

    def _path(self, pattern, epoch, iteration):
        name = pattern.format(epoch, iteration)
        if self.backend != "npz":
            name = name.removesuffix(".npz") + "." + self.backend
        return os.path.join(self.dir, name)

    def _retain_only(self, keep_path, regex):
        """Delete checkpoints matching `regex` except `keep_path`."""
        for p in glob.glob(os.path.join(self.dir, "*ep*-it*.*")):
            if regex.match(os.path.basename(p)) and \
                    os.path.abspath(p) != os.path.abspath(keep_path):
                (shutil.rmtree if os.path.isdir(p) else os.remove)(p)

    @property
    def best_loss(self) -> float:
        """Best validation loss seen by save_epoch (inf before any)."""
        return self._best_loss

    def save_epoch(self, state, epoch: int, iteration: int,
                   val_loss: float | None = None, meta: dict | None = None,
                   save_last: bool = True):
        """save_last=False saves/retains only the best-checkpoint side
        (SaverPlugin's every_n_epochs thinning: an off-schedule epoch that
        improved validation still pins a best checkpoint). Returns the path
        written (the last one if both), or None."""
        meta = dict(meta or {}, epoch=epoch, iteration=iteration)
        # WRITE-then-delete: the new checkpoint lands before old ones are
        # removed, so a crash mid-save never leaves the run with zero
        # resumable checkpoints. Deletes are rank 0's; the barrier in
        # _save fences them from the other ranks' reads.
        main = is_main_process()
        path = self._path(LAST_PATTERN, epoch, iteration)
        written = None
        if save_last:
            self._save(path, state, meta)
            if not self.keep_old and main:
                self._retain_only(path, _LAST_RE)
            written = path
        if val_loss is not None and val_loss < self._best_loss:
            self._best_loss = val_loss
            best = self._path(BEST_PATTERN, epoch, iteration)
            self._save(best, state, dict(meta, val_loss=val_loss))
            if main:
                self._retain_only(best, _BEST_RE)
            written = written or best
        return written

    def _newest(self, pattern, regex):
        found = []
        for p in glob.glob(os.path.join(self.dir, pattern)):
            m = regex.match(os.path.basename(p))
            if m:
                found.append((int(m.group(1)), int(m.group(2)), p))
        if not found:
            return None
        e, i, p = max(found)
        return p, e, i

    def latest(self):
        """Newest last-checkpoint (path, epoch, iteration), or None:
        natural sort on the numbers in the file name (ref
        train.py:110-126)."""
        return self._newest("ep*-it*.*", _LAST_RE)

    def resume_point(self):
        """latest() as rank 0 sees it, on every rank (itself without a
        process group). Every rank must see the same newest checkpoint in
        its own directory, which the ranks share: where one does not, every
        rank raises FileNotFoundError (none is left at a collective)."""
        mine = self.latest()
        key = (-1, -1) if mine is None else (mine[1], mine[2])
        want = (broadcast_int64(key[0]), broadcast_int64(key[1]))
        if any_rank(key != want):
            raise FileNotFoundError(
                f"the ranks see different newest checkpoints in {self.dir} "
                f"(rank 0: epoch {want[0]}, iteration {want[1]}; -1 for "
                f"none): multi-process training needs one checkpoints "
                f"directory that every rank shares")
        return mine

    def best(self):
        return self._newest("best-ep*-it*.*", _BEST_RE)
