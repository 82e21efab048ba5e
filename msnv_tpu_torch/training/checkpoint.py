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
subtree. `load_any` reads either format; the manager finds both.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import shutil
import warnings

import numpy as np
import torch

from msnv_tpu_torch.parallel.mesh import (any_rank, barrier,
                                          broadcast_int64, is_main_process)
from msnv_tpu_torch.tree import keystr, leaves_with_paths, map_with_paths

LAST_PATTERN = "ep{}-it{}.npz"                    # ref plugins.py:117
BEST_PATTERN = "best-ep{}-it{}.npz"               # ref plugins.py:118
_LAST_RE = re.compile(r"^ep(\d+)-it(\d+)\.(npz|dcp)$")
_BEST_RE = re.compile(r"^best-ep(\d+)-it(\d+)\.(npz|dcp)$")
DCP_META = "msnv_meta.json"
BACKENDS = ("npz", "dcp")

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
            out = torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype)
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
        with open(os.path.join(tmp, DCP_META), "w") as f:
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


def load_any(path: str, template, device=None):
    """Format-dispatching load: a `.dcp` directory or an `.npz` file."""
    path = _norm_ckpt_path(path)
    if is_dcp(path):
        return load_checkpoint_dcp(path, template, device)
    return load_checkpoint(path, template, device)


def _load_meta(path: str) -> dict:
    """The meta dict of either format."""
    if is_dcp(path):
        meta_path = os.path.join(_norm_ckpt_path(path), DCP_META)
        if not os.path.isfile(meta_path):
            return {}
        with open(meta_path) as f:
            return json.load(f)
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")


class CheckpointManager:
    """last/best retention policy over a checkpoints directory.

    backend: "npz" (single files, rank 0 writes the full state) or "dcp"
    (directories, every rank writes its slices). latest() and best() find
    both formats, so a run can switch backends and resume its history."""

    def __init__(self, checkpoints_dir: str, keep_old: bool = False,
                 backend: str = "npz", scheduled: bool = False):
        if backend == "orbax":
            raise NotImplementedError(
                "checkpoint backend 'orbax' is not available in the port: "
                "orbax's format needs jax and tensorstore. Its counterpart "
                "is backend 'dcp' (torch.distributed.checkpoint "
                "directories, --ckpt_backend dcp)")
        if backend not in BACKENDS:
            raise ValueError(f"checkpoint backend {backend!r}: one of "
                             f"{BACKENDS}")
        self.dir = checkpoints_dir
        self.keep_old = keep_old
        self.backend = backend
        self.scheduled = scheduled      # see flatten_state (npz)
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
        resuming or reading around a write in flight. dcp: every rank
        writes its part (fenced inside)."""
        if self.backend == "dcp":
            save_checkpoint_dcp(path, state, meta)
            return
        if is_main_process():
            save_checkpoint(path, state, meta, self.scheduled)
        barrier()

    def _path(self, pattern, epoch, iteration):
        name = pattern.format(epoch, iteration)
        if self.backend == "dcp":
            name = name.removesuffix(".npz") + ".dcp"
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
