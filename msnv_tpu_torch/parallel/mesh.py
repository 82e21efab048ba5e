"""Device mesh and sharding layout for data-parallel training and generation.

The port's counterpart of the JAX package's parallel/mesh.py. JAX drives
every chip from one controller and lets XLA insert the collectives; the
port runs one process per GPU (SPMD: `torchrun --nproc_per_node N`, the
same program on every host), each process one rank of the
torch.distributed process group, so one host and many hosts share the
code. NCCL allows one rank per GPU, which is why the single-controller form
cannot carry it.

- `make_mesh` arranges the ranks of the initialized process group as a
  ('data', 'model') DeviceMesh, row-major: rank = data_index * n_model +
  model_index. Each rank's device is explicit (`Mesh.device`).
- Batch-like tensors (data, target, cond, spk; the tier state on its axis
  1; a packed corpus) are sharded along the lanes over 'data': a rank holds
  the lanes of its data index (`Lanes.local`). The lane<->rank assignment
  is fixed, as TBPTT state carry requires.
- Params are replicated over 'data'. Over 'model' (`param_sharding`, the
  JAX package's rules) each rank STORES only its slice of the wide leaves,
  and its Adam moments alike. This is storage sharding, not a split of the
  matmuls: the train step all-gathers the full weights over 'model' once
  per step before the forward (`gather_params`), so the hand-written
  kernels always see whole weights and no collective runs inside the GRU
  recurrence; each rank then updates its slice from the 'data'-reduced
  gradient. The numbers are those of one rank.
- Gradients and losses are means over 'data' (`data_mean`): the shards
  are equal, so the mean of the shard means is the global batch's mean.
- Every replica starts from global rank 0's state (`broadcast_tree`, as
  PyTorch's DDP does at construction): the steps update each replica in
  place from the same reduced gradient, so replicas that start apart
  never meet. The Trainer and the serving service broadcast the full
  params they are given; the step builders take the caller's storage.

Every collective is an all_reduce, a broadcast or an all_gather (a
reduce-scatter is an all-reduce, then a slice), so the same code runs on
NCCL, on gloo CPU ranks, and on gloo ranks that share one GPU (gloo takes
CUDA tensors for those three). The backend is the one the process group
was created with; nothing here switches it.

Multi-host: `torch.distributed.init_process_group` (from the launcher's
environment) before `make_mesh`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from msnv_tpu_torch.device import resolve_device
from msnv_tpu_torch.tree import map_with_paths, tree_leaves, tree_map

AXES = ("data", "model")


class Mesh:
    """A ('data', 'model') DeviceMesh and this rank's place and device in
    it. `shape` is {"data": n_data, "model": n_model}, as the JAX Mesh's."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = {a: int(device_mesh.size(i)) for i, a in enumerate(AXES)}
        self.data_index = int(device_mesh.get_local_rank("data"))
        self.model_index = int(device_mesh.get_local_rank("model"))
        self.data_group = device_mesh.get_group("data")
        self.model_group = device_mesh.get_group("model")


def make_mesh(n_data=None, n_model: int = 1, device=None) -> Mesh:
    """A ('data', 'model') mesh over the initialized process group; by
    default every rank on 'data'. n_data * n_model must be the world size
    (1 is allowed). `device` is this rank's device (default: the current
    CUDA device), made the current one before the mesh's groups exist."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group first (torchrun sets "
            "its environment)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh does not cover the "
                         f"{world} ranks of the process group")
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(device.type, (n_data, n_model),
                                 mesh_dim_names=AXES), device)


def check_mesh(mesh) -> None:
    """Refuse what `make_mesh` did not make (None passes)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a parallel.mesh.Mesh from make_mesh, "
                        f"got {type(mesh).__name__}")


@dataclass(frozen=True)
class Lanes:
    """This rank's lanes along `axis`: the block of the data index, as the
    JAX package's NamedSharding over 'data' places them."""
    mesh: Mesh
    axis: int = 0

    def local(self, x):
        """The local lanes of a global numpy array or tensor (a view)."""
        n = self.mesh.shape["data"]
        size = x.shape[self.axis]
        if size % n:
            raise ValueError(f"{size} lanes must divide by the mesh 'data' "
                             f"axis size {n} (each shard carries "
                             f"lanes/shards lanes)")
        if n == 1:
            return x
        per = size // n
        index = [slice(None)] * x.ndim
        index[self.axis] = slice(self.mesh.data_index * per,
                                 (self.mesh.data_index + 1) * per)
        return x[tuple(index)]


def batch_sharding(mesh: Mesh) -> Lanes:
    """The leading (batch / lane) axis over 'data'."""
    return Lanes(mesh, 0)


def state_sharding(mesh: Mesh) -> Lanes:
    """Tier hidden state (n_rnn, B, dim): the batch axis is dim 1."""
    return Lanes(mesh, 1)


def corpus_sharding(mesh: Mesh) -> dict:
    """Lanes of a device-resident packed corpus (data/loader.device_arrays):
    qdata (B, N) and cond (B, F, C) on axis 0, the per-chunk speaker table
    (num_chunks, B) on axis 1."""
    return {"qdata": Lanes(mesh, 0), "cond": Lanes(mesh, 0),
            "spk": Lanes(mesh, 1)}


def param_sharding(mesh: Mesh, params):
    """The 'model' shard dim of every leaf of a FULL param tree, or None
    for a replicated leaf: the rules of the JAX package's param_sharding.
    GRU w_ih / w_hh / b_ih / b_hh rows (gate-stacked), dense `.w` outputs
    (out, in) and the upsample's and the MLP conv_in's axis 2, each where
    it divides by n_model; everything else replicated, and everything when
    n_model is 1."""
    n_model = mesh.shape["model"]

    def spec(path, x):
        if n_model == 1 or x.ndim == 0:
            return None
        # list indices carry no name in the JAX key path
        name = ".".join(p if isinstance(p, str) else "" for p in path)
        if ("w_ih" in name or "w_hh" in name or "b_ih" in name
                or "b_hh" in name) and x.shape[0] % n_model == 0:
            return 0
        if name.endswith(".w") and x.ndim == 2 and x.shape[0] % n_model == 0:
            return 0
        if ("upsample" in name or "conv_in" in name) and x.ndim == 3 \
                and x.shape[2] % n_model == 0:
            return 2
        return None

    return map_with_paths(spec, params)


def _zip_specs(fn, tree, specs):
    """tree with every leaf x replaced by fn(x, its spec)."""
    it = iter(tree_leaves(specs))
    return tree_map(lambda x: fn(x, next(it)), tree)


def shard_params(mesh: Mesh, params, specs):
    """This rank's storage of a full tree: the model_index-th slice of each
    sharded leaf (a copy), the replicated leaves themselves; the tree
    itself when `specs` is None (every leaf replicated)."""
    if specs is None:
        return params
    n, i = mesh.shape["model"], mesh.model_index

    def take(x, dim):
        if dim is None:
            return x
        return x.chunk(n, dim)[i].clone(memory_format=torch.contiguous_format)

    return _zip_specs(take, params, specs)


def as_dtensors(mesh: Mesh, tree, specs=None, lane_axis=None):
    """Copies of this rank's storage of `tree` as DTensors over the mesh,
    the global view that torch.distributed.checkpoint saves and loads: a
    leaf is sharded over 'model' along its spec's dim (`specs`, as
    param_sharding gives them; None: every leaf replicated over 'model')
    and, with `lane_axis`, over 'data' along that axis (the tier state's
    lanes); replicated elsewhere. Int leaves stay ints."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    data = Replicate() if lane_axis is None else Shard(lane_axis)

    def wrap(x, dim):
        if isinstance(x, int):
            return x
        return DTensor.from_local(
            x.detach().clone(memory_format=torch.contiguous_format),
            mesh.device_mesh,
            [data, Replicate() if dim is None else Shard(dim)],
            run_check=False)

    if specs is None:
        specs = tree_map(lambda _: None, tree)
    return _zip_specs(wrap, tree, specs)


def local_tensors(tree):
    """`tree` with every DTensor leaf replaced by this rank's part of it
    (the inverse of as_dtensors)."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                    tree)


def gather_params(mesh: Mesh, params, specs):
    """The full tree from this rank's storage: every sharded leaf
    all-gathered over 'model'; the same tree when n_model is 1 or `specs`
    is None."""
    n = mesh.shape["model"]
    if n == 1 or specs is None:
        return params

    def gather(x, dim):
        if dim is None:
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
        return torch.cat(parts, dim)

    return _zip_specs(gather, params, specs)


def data_mean(mesh: Mesh, tensors):
    """The means over 'data' of a list of float32 tensors, in ONE
    all-reduce of a flat buffer (sum, then / n_data); every rank gets the
    same bits. Returns new tensors in the input shapes."""
    n = mesh.shape["data"]
    if n == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(n)
    out = flat.split([t.numel() for t in tensors])
    return [o.view(t.shape) for o, t in zip(out, tensors)]


def reduce_gradients(mesh: Mesh, grads, specs, *scalars):
    """(this rank's slice of the 'data'-mean gradient tree, the whole tree
    when `specs` is None; the means of `scalars`): one all-reduce for the
    whole tree and the scalars."""
    leaves = tree_leaves(grads)
    means = data_mean(mesh, leaves + list(scalars))
    it = iter(means)
    full = tree_map(lambda _: next(it), grads)
    return (shard_params(mesh, full, specs), *means[len(leaves):])


def gather_lanes(mesh: Mesh, x, axis: int = 0):
    """The global tensor from every data index's lanes along `axis`
    (all-gathered over 'data')."""
    n = mesh.shape["data"]
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts, axis)


# -- process-wide helpers (the world group, with or without a mesh) --------

def rank_device(name: str) -> torch.device:
    """This process's device: cuda:LOCAL_RANK under a launcher that sets
    it (made the current device), else the named one."""
    device = resolve_device(name)
    if device.type == "cuda" and device.index is None \
            and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    return device


_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(multihost: bool, device) -> int:
    """The world size. A process group the caller made is used as it is;
    with `multihost` or a launcher's WORLD_SIZE above 1 one is made here
    from the launcher's environment (NCCL on CUDA, gloo on the CPU);
    otherwise there is one process. The CLIs of training and serving share
    it."""
    if not dist.is_initialized():
        if not multihost and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return 1
        missing = [v for v in _LAUNCHER_ENV if v not in os.environ]
        if missing:
            raise ValueError(
                f"a multi-process run needs the launcher's environment "
                f"(torchrun sets it): {', '.join(missing)} not set")
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo")
    return dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or no process group: the one process that writes files and
    prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _world_device() -> torch.device:
    """Where a world collective's tensor lives: NCCL takes CUDA tensors
    only, gloo takes CPU ones."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Every rank waits for every other (an all-reduce of one element that
    the host reads back); nothing without a process group."""
    if world_size() > 1:
        t = torch.zeros(1, device=_world_device())
        dist.all_reduce(t)
        t.item()


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (an all-reduce); the
    flag itself without a process group."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int64, device=_world_device())
    dist.all_reduce(t)
    return bool(t.item())


def broadcast_tree(tree, src: int = 0):
    """Every rank's tensor tree made global rank `src`'s, in place: each
    leaf keeps this rank's storage, device and dtype and takes `src`'s
    bits. One broadcast over the world group per dtype of the leaves, of
    one flat buffer packing them (as data_mean packs its all-reduce, with
    no cast, so every dtype arrives bit for bit). Every rank passes a tree
    of the same structure, shapes and dtypes on one device. Without a
    process group, or in a world of 1, nothing is sent. Returns the
    tree."""
    if world_size() == 1:
        return tree
    buckets = {}        # in tree order of first use: the same on every rank
    for x in tree_leaves(tree):
        buckets.setdefault(x.dtype, []).append(x)
    receive = dist.get_rank() != src
    with torch.no_grad():
        for leaves in buckets.values():
            flat = torch.cat([x.reshape(-1) for x in leaves])
            dist.broadcast(flat, src=src)
            if receive:
                parts = flat.split([x.numel() for x in leaves])
                for x, part in zip(leaves, parts):
                    x.copy_(part.view(x.shape))
    return tree


def broadcast_int64(value: int) -> int:
    """Rank 0's int64 on every rank (itself without a process group)."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=_world_device())
    dist.broadcast(t, src=0)
    return int(t.item())
