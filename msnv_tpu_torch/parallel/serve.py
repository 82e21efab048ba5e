"""Serving over a device mesh: rank 0 leads, every other rank follows.

JAX drives every chip of a serving mesh from one controller. The port runs
one process per GPU (parallel/mesh.py), so whatever rank 0's HTTP front
asks of the mesh has to reach every rank. Every rank builds the same
VocoderService(mesh=); rank 0 runs the front, the batcher and the
multiplexer's pump, and every other rank waits in `follow(service)`. For
each operation rank 0 broadcasts a small fixed-size header (HEADER int64
slots) over a gloo group of the channel's own, then the operation's
tensors over the mesh's group (NCCL on the cards), and every rank runs its
shard of the operation:

  SYNTH  lanes, frames, temperature (float64 bits), speaker kind (0: ids,
         1: mix rows), folded seed; then cond (lanes, frames, C) float32
         and spk (lanes,) int32 or (lanes, spk_dim) float32. One
         /synthesize group: VocoderService._mesh_synth.
  TICK   attach, push, buffer size; then one float32 buffer holding the
         attach mask and the speaker rows (attach) and the active mask and
         cond (lanes, K, C) (push). One multiplexer pump tick:
         StreamMultiplexer._mesh_tick.
  NOOP   nothing: the heartbeat.
  STOP   the followers return.

What keeps the ranks in step:
- Rank 0 sends a header and runs its operation's collectives while it
  holds the service's device lock (which the pump takes inside its carry
  lock), so the lock's order is the collective order on every rank. A
  request is parsed, rounded and checked before its header goes out: a bad
  request never reaches a follower.
- An idle follower waits in the header broadcast, on gloo, and never
  inside an NCCL collective (NCCL's watchdog ends a process whose
  collective outlives its timeout). Rank 0 sends a NOOP whenever no header
  went out for `heartbeat_s` (a fifth of the header group's timeout).
- Each operation's local part ends in a vote over the header group
  (`run`): when any rank failed, every rank learns it before the output
  collective, so none is left waiting in it. A follower that failed logs
  its traceback and `follow` raises (its process exits non-zero); rank 0
  marks the channel failed (the request answers 500, every later operation
  fails at once) and calls `on_failure` (the serving CLI stops its front
  and exits non-zero). Nothing carries on with a rank missing.
"""

from __future__ import annotations

import contextlib
import logging
import struct
import threading
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from msnv_tpu_torch.parallel.mesh import check_mesh

SYNTH, TICK, NOOP, STOP = 1, 2, 3, 4
HEADER = 8
_MASK64 = (1 << 64) - 1

log = logging.getLogger(__name__)


class MeshFailed(RuntimeError):
    """A rank of the serving mesh failed an operation."""


def float_bits(x: float) -> int:
    """A float64 as the int64 of its bit pattern (a header slot)."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def bits_float(b: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(b)))[0]


def seed_slot(seed: int) -> int:
    """A request seed as an int64 slot: its low 64 bits, signed.
    fold_generator masks to the low 64 bits, so the shards' generators
    are those of the seed itself."""
    s = int(seed) & _MASK64
    return s - (1 << 64) if s >> 63 else s


class ControlChannel:
    """Rank 0's headers to the other ranks of a serving mesh, and the
    vote that ends each operation. Built on every rank (a collective: the
    header group is made here). `lock` is the service's device lock, under
    which rank 0 sends every header; `timeout_s` is the header group's: a
    follower idle for longer without a heartbeat fails."""

    def __init__(self, mesh, lock, timeout_s: float = 600.0):
        check_mesh(mesh)
        self.mesh = mesh
        self._lock = lock
        self.leader = dist.get_rank() == 0
        self.group = dist.new_group(backend="gloo",
                                    timeout=timedelta(seconds=timeout_s))
        # the tensors' broadcast root: rank 0's rank in the mesh's group
        self._root = dist.get_global_rank(mesh.data_group, 0)
        self.heartbeat_s = timeout_s / 5
        self.failed = None          # rank 0: the first failure
        self.on_failure = None      # rank 0: called once with it
        self._last = time.monotonic()
        self._stopped = threading.Event()
        self._beat = None

    # -- every rank ---------------------------------------------------------

    def share(self, tensors) -> None:
        """Broadcast rank 0's tensors into the others' (same shapes and
        dtypes, on the mesh device) over the mesh's group."""
        for t in tensors:
            dist.broadcast(t, src=self._root, group=self.mesh.data_group)

    def run(self, local):
        """local() on this rank, then the vote: raises MeshFailed on every
        rank when any rank's local() raised (this rank's own error is
        raised as it is). Returns local()'s result."""
        try:
            out = local()
        except BaseException:
            with contextlib.suppress(MeshFailed):
                self._vote(False)
            raise
        self._vote(True)
        return out

    def _vote(self, ok: bool) -> None:
        flag = torch.tensor([0 if ok else 1], dtype=torch.int64)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        if flag.item():
            raise MeshFailed("a rank of the serving mesh failed this "
                             "operation (its log has the traceback)")

    # -- rank 0 -------------------------------------------------------------

    def send(self, op: int, *fields: int) -> None:
        """Rank 0: broadcast one header. Call under the device lock."""
        header = torch.zeros(HEADER, dtype=torch.int64)
        header[0] = op
        header[1:1 + len(fields)] = torch.tensor(fields, dtype=torch.int64)
        dist.broadcast(header, src=0, group=self.group)
        self._last = time.monotonic()

    @contextlib.contextmanager
    def leading(self):
        """Rank 0's side of one operation (header, tensors, run, output
        collective). A failure anywhere in it fails the channel for good
        and raises MeshFailed (the fronts answer it with 500)."""
        if self.failed is not None:
            raise MeshFailed(f"the serving mesh failed earlier: "
                             f"{self.failed!r}")
        try:
            yield
        except Exception as e:
            self.failed = e
            if self.on_failure is not None:
                self.on_failure(e)
            if isinstance(e, MeshFailed):
                raise
            raise MeshFailed(f"the serving mesh failed: {e!r}") from e

    def start_heartbeat(self) -> None:
        """Rank 0: send a NOOP whenever no header went out for
        heartbeat_s."""
        def beat():
            while not self._stopped.wait(self.heartbeat_s / 4):
                if time.monotonic() - self._last < self.heartbeat_s:
                    continue
                with self._lock:
                    if self._stopped.is_set() or self.failed is not None:
                        return
                    try:
                        with self.leading():
                            self.send(NOOP)
                    except MeshFailed:       # recorded in self.failed
                        return

        self._beat = threading.Thread(target=beat, daemon=True,
                                      name="msnv-mesh-heartbeat")
        self._beat.start()

    def stop(self) -> None:
        """Rank 0: stop the heartbeat and send STOP (once; not after a
        failure: the followers have gone)."""
        if self._stopped.is_set():
            return
        with self._lock:
            self._stopped.set()
            if self.failed is None:
                with self.leading():
                    self.send(STOP)
        if self._beat is not None:
            self._beat.join(timeout=10)

    # -- the other ranks ----------------------------------------------------

    def recv(self) -> list:
        header = torch.empty(HEADER, dtype=torch.int64)
        dist.broadcast(header, src=0, group=self.group)
        return header.tolist()


def follow(service) -> None:
    """Every rank but 0: run rank 0's operations on this rank's shard
    until STOP. A failed operation logs its traceback and raises."""
    channel = service._channel
    if channel is None or channel.leader:
        raise ValueError("follow() runs on the ranks other than 0 of a "
                         "VocoderService(mesh=)")
    cfg, dev = service.cfg, service.device
    while True:
        op, *f = channel.recv()
        try:
            if op == NOOP:
                continue
            if op == STOP:
                return
            if op == SYNTH:
                lanes, frames, t_bits, mix, seed = f[:5]
                cond = torch.empty((lanes, frames, cfg.effective_cond_dim),
                                   dtype=torch.float32, device=dev)
                spk = (torch.empty((lanes, cfg.spk_dim), dtype=torch.float32,
                                   device=dev) if mix else
                       torch.empty((lanes,), dtype=torch.int32, device=dev))
                service._mesh_synth(bits_float(t_bits), cond, spk, seed)
            elif op == TICK:
                attach, push, size = f[:3]
                buf = torch.empty((size,), dtype=torch.float32, device=dev)
                service._mux._mesh_tick(bool(attach), bool(push), buf)
            else:
                raise MeshFailed(f"unknown serving-mesh operation {op}")
        except BaseException:
            log.exception("rank %d: serving-mesh operation %d failed",
                          dist.get_rank(), op)
            raise
