"""Lane-batched /stream multiplexer: N streams share one device carry.

Port of the JAX package's serving/mux.py.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.kernels.sample_window import sample_window
from msnv_tpu_torch.models.generate import streaming_fn
from msnv_tpu_torch.parallel.generate import shard_generator
from msnv_tpu_torch.parallel.mesh import (batch_sharding, check_mesh,
                                          gather_lanes)
from msnv_tpu_torch.parallel.serve import TICK
from msnv_tpu_torch.serving.common import Overloaded, _Fetch
from msnv_tpu_torch.utils import profiling

# ticks the card holds: the one running and one queued behind it
_ON_CARD = 2


def _tensors(carry):
    spk_vec, buf, hs, _ = carry
    return [spk_vec, buf, *hs]


def _own(carry):
    """The carry with each tensor a contiguous copy of its own (`fresh()`
    gives the hidden state as expand views of the learned h0)."""
    spk_vec, buf, hs, generator = carry
    own = lambda t: t.clone(memory_format=torch.contiguous_format)  # noqa
    return (own(spk_vec), own(buf), [own(h) for h in hs], generator)


def _write(carry, new):
    """Copy `new`'s tensors into `carry`'s, in place."""
    for dst, src in zip(_tensors(carry), _tensors(new)):
        if dst is not src:
            dst.copy_(src)


class StreamMultiplexer:
    """Lane-batched /stream engine: up to `lanes` concurrent streams share
    ONE device-resident streaming carry and one pump thread.

    The per-connection path pays a whole push (its ~280 small launches of
    the tier ops) PER STREAM, and streams serialize on the device lock:
    per-stream RTF ~ 1/N. Here every pump tick advances ALL lanes with
    pending conditioner frames in a single masked K-frame push, and the
    sample-window kernel takes the lanes as its batch, so the launches are
    paid once per tick for all lanes. On a card without a mesh they are
    paid once in all: the pump captures the masked push as a CUDA graph at
    its first tick and replays it every tick (`_PushGraph`; `replays`
    counts the ticks that ran so), its conditioners and mask copied in
    from pinned host buffers without blocking the host.

    Mechanics:
    - lanes attach/detach dynamically: acquire() records the lane's speaker
      row host-side and queues a DEFERRED splice; the pump's
      `_flush_attaches` splices fresh state (q_zero buffer, learned-h0
      hidden, speaker vector) into every pending lane in ONE masked call at
      the start of its tick — N concurrent connects cost one splice, not N.
      `_masked_push` advances the batch and keeps inactive lanes' state
      frozen with torch.where.
    - the carry's tensors keep their addresses for the multiplexer's life:
      `_masked_push` and `_attach_many` return a new carry, and the pump
      copies it into those tensors in place (`_write`, `_advance`), which
      is what lets a captured graph read and write them on every replay.
    - the pump fetch-pipelines: each tick's audio copy starts at dispatch
      (pinned memory + an event), and the pump delivers a tick as soon as
      its fetch has completed. The card holds at most two ticks, the one
      running and one queued behind it: the pump pops tick n's blocks only
      once tick n - 2's fetch has completed, so a stream acquired while
      tick n - 1 runs rides tick n. One queued tick keeps the card fed
      while the host's share of a tick is the smaller; `starved` counts
      the ticks pushed after the card had finished every earlier one.
    - randomness: ONE torch.Generator on the params' device lives in the
      carry and advances per tick for the whole batch (like batched
      generation) — a multiplexed stream gets the same distribution but a
      different sample stream than a solo run, and per-request `seed` is
      ignored. Streams needing seed-exact audio use the per-connection path.

    On CUDA at temperature > 0 the push runs bf16 weights and the
    sample-window kernel (Philox mode) at B = lanes; greedy decoding and
    the CPU keep the per-sample path in the params' dtype.

    Over a device mesh (`mesh=`, one process per GPU; the lanes must
    divide by the 'data' size) every rank holds lanes / shards lanes of
    the carry, the streaming_fn carry that sharded_streaming_fn builds
    (its generator folded with the rank's data index), and the masked
    push and the attach splice run on the rank's slice of their inputs
    (`_mesh_tick`). Rank 0's pump leads each tick through the serving
    `channel` (parallel/serve.py); the other ranks tick in follow(). The
    audio is all-gathered, and only rank 0 converts and delivers it. The
    ranks' params must be equal; VocoderService(mesh=) sees to that.

    While a torch.profiler records, the pump records spans
    (utils/profiling.py): `mux.attach` (the splice), `mux.push` (the
    tick's host-to-device copies, the masked push and the audio fetch's
    start; over a mesh the whole led tick, its splice nested in it),
    `mux.replay` (the graph's replay, nested in `mux.push`),
    `mux.starved` (zero-length, nested in the `mux.push` of a tick that
    `starved` counts), `mux.wait` and `mux.deliver` (a tick's fetch,
    then its PCM conversion and delivery), and two intervals: `mux.queue`
    a stream (acquire to the push that first carries its block; request
    id (lane, gen)) and `mux.inflight` a tick (push end to deliver end).
    """

    # ticks pushed when the card had already finished every earlier tick
    # (it waited on the host); declared on the class, so a reader can tell
    # a pump that counts them from one that does not
    starved = 0

    def __init__(self, params, cfg: ModelConfig, lanes: int = 32,
                 frames_per_push: int = 4, temperature: float = 1.0,
                 seed: int = 0, mesh=None, channel=None):
        check_mesh(mesh)
        self.cfg = cfg
        self.lanes = int(lanes)
        self.K = int(frames_per_push)
        self.temperature = float(temperature)
        self.device = params["mlp"]["embedding"].device
        self.mesh = mesh
        self._channel = channel
        shards = mesh.shape["data"] if mesh is not None else 1
        if self.lanes % shards:
            raise ValueError(f"mux lanes {self.lanes} must divide by the "
                             f"mesh 'data' axis size {shards}")
        self._local_lanes = self.lanes // shards   # this rank's carry
        use_kernel = self.device.type == "cuda" and self.temperature > 0.0
        self._init_state, self._push = streaming_fn(
            params, cfg, frames_per_push=self.K,
            compute_dtype=torch.bfloat16 if use_kernel else None,
            use_kernel=use_kernel, temperature=self.temperature)
        self._generator = (
            shard_generator(mesh, int(seed)) if mesh is not None else
            torch.Generator(device=self.device).manual_seed(int(seed)))
        self._carry = _own(self._init_state(
            self._local_lanes,
            torch.zeros((self._local_lanes,), dtype=torch.int64,
                        device=self.device), self._generator))
        # on a card without a mesh the pump's push is a CUDA graph (made at
        # its first tick) fed through pinned buffers, and so is the splice's
        # input; over a mesh the collectives sit inside the tick
        self._graphed = self.device.type == "cuda" and mesh is None
        self._graph = None
        self._attach_in = (_Staging(
            [torch.zeros((self.lanes,), dtype=torch.bool, device=self.device),
             torch.zeros((self.lanes, cfg.spk_dim), device=self.device)],
            _ON_CARD) if self._graphed else None)
        self._zeros_cond = np.zeros(
            (self.lanes, self.K, cfg.effective_cond_dim), np.float32)
        self._cv = threading.Condition()
        self._free = list(range(self.lanes))
        self._pending = {}     # lane -> list of (K, C) np blocks, FIFO
        self._out = {}         # lane -> queue.Queue of int16 audio rows
        self._sinks = {}       # lane -> callable(bytes): direct delivery
        #                        (async front-end); bypasses _out
        self._gen = [0] * self.lanes   # lane reuse epoch: in-flight audio
        #                                of a released stream must never
        #                                reach the lane's NEXT occupant
        self._stop = False
        self._thread = None
        self._inflight = []    # [(_Fetch of audio, [(lane, gen) served],
        #                           its mux.push record or None)]
        self._queued = {}      # lane -> acquire's time.time_ns(), while
        #                        a profiler records (mux.queue)
        self.ticks = 0         # masked pushes run by the pump
        self.replays = 0       # of them, those run as a graph replay
        # deferred attaches: acquire() only records the lane's speaker row;
        # the pump splices ALL pending lanes in one _attach_many call at the
        # start of its next tick (before any block of theirs is pushed —
        # feed() happens after acquire() returns, and the tick pops attaches
        # and blocks under the same _cv hold)
        self._spk_rows = np.zeros((self.lanes, cfg.spk_dim), np.float32)
        self._pending_attach = set()
        # carry mutations (attach splices vs pump ticks) must be atomic:
        # _carry_lock is the outer lock; the device lock (shared with
        # /synthesize and the per-connection /stream) nests inside it
        self._carry_lock = threading.Lock()
        self._device_lock = threading.Lock()

    # -- device side ------------------------------------------------------

    @torch.no_grad()
    def _masked_push(self, carry, cond, active):
        """One K-frame push of every lane; lanes where `active` (lanes,)
        bool is False keep their buffer and hidden state. cond is
        (lanes, K, C), or (lanes, C) at K == 1."""
        # the streaming push takes (B, C) at K == 1 but (B, K, C) at K > 1;
        # the pump always builds (lanes, K, C) blocks
        if self.K == 1 and cond.dim() == 3:
            cond = cond[:, 0]
        spk_vec, buf, hs, generator = carry
        (_, buf2, hs2, generator), audio, _ = self._push(carry, cond)
        buf3 = torch.where(active[:, None], buf2, buf)
        hs3 = [torch.where(active[None, :, None], h2, h)
               for h2, h in zip(hs2, hs)]
        return (spk_vec, buf3, hs3, generator), audio

    @torch.no_grad()
    def _advance(self, carry, cond, active):
        """The pump's masked push: the new buffer and hidden state copied
        into `carry`'s own tensors -> audio."""
        new, audio = self._masked_push(carry, cond, active)
        _write(carry, new)
        return audio

    def _tick(self, cond, active):
        """One masked push of the carry from host `cond` (lanes, K, C) and
        `active` (lanes,) -> the audio on the device. MUST be called under
        _carry_lock + _device_lock."""
        self.ticks += 1
        if not self._graphed:
            return self._advance(self._carry,
                                 torch.from_numpy(cond).to(self.device),
                                 torch.from_numpy(active).to(self.device))
        if self._graph is None:
            self._graph = _PushGraph(self)
        self.replays += 1
        return self._graph.replay(cond, active)

    @torch.no_grad()
    def _attach_many(self, carry, mask, spk_rows):
        """Splice fresh stream state into every lane where `mask`: the
        q_zero buffer, the learned h0 and the speaker vector of the float
        one-hot / mix rows (a one-hot matmul selects the embedding row
        exactly, so int-id and row speakers give the same numbers). The
        fresh state draws nothing: the carry keeps the mux's generator."""
        fs, fb, fh, _ = self._init_state(self._local_lanes, spk_rows,
                                         self._generator)
        spk_vec, buf, hs, generator = carry
        spk_vec = torch.where(mask[:, None], fs.to(spk_vec.dtype), spk_vec)
        buf = torch.where(mask[:, None], fb, buf)
        hs = [torch.where(mask[None, :, None], fhi, h)
              for fhi, h in zip(fh, hs)]
        return (spk_vec, buf, hs, generator)

    # -- connection side --------------------------------------------------

    @staticmethod
    def _spk_row(spk, spk_dim):
        """Normalize a speaker spec (int id, (1,) int array, or (1, S) /
        (S,) float mix) to a float32 mix row."""
        arr = np.asarray(spk)
        if arr.dtype.kind in "iu":
            row = np.zeros((spk_dim,), np.float32)
            row[int(arr.reshape(-1)[0])] = 1.0
            return row
        row = arr.astype(np.float32).reshape(-1)
        if row.shape[0] != spk_dim:
            raise ValueError(f"spk mix needs {spk_dim} weights, got "
                             f"{row.shape[0]}")
        return row

    def acquire(self, spk):
        """Reserve a lane and queue a fresh stream-state splice for it;
        returns the lane id. Raises Overloaded when all lanes are busy.

        The splice is DEFERRED to the pump's next tick (_flush_attaches):
        it applies before any of this stream's conditioner blocks is pushed,
        because feed() runs after acquire() returns and the pump pops
        pending attaches and pending blocks under the same _cv hold."""
        row = self._spk_row(spk, self.cfg.spk_dim)
        with self._cv:
            if not self._free:
                raise Overloaded(f"all {self.lanes} multiplexer lanes busy")
            lane = self._free.pop()
            self._gen[lane] += 1
            if profiling.enabled():
                self._queued[lane] = time.time_ns()
            self._pending[lane] = []
            self._out[lane] = queue.Queue()
            self._spk_rows[lane] = row
            self._pending_attach.add(lane)
        return lane

    def _flush_attaches(self, attach_lanes):
        """Apply deferred attach splices for `attach_lanes` in ONE call.
        MUST be called under _carry_lock + _device_lock."""
        if not attach_lanes:
            return
        with profiling.span("mux.attach"):
            mask = np.zeros((self.lanes,), bool)
            mask[list(attach_lanes)] = True
            if self._attach_in is not None:
                mask, rows = self._attach_in.put(mask, self._spk_rows)
            else:
                mask = torch.from_numpy(mask).to(self.device)
                rows = torch.from_numpy(self._spk_rows.copy()).to(self.device)
            _write(self._carry, self._attach_many(self._carry, mask, rows))

    # -- over a mesh --------------------------------------------------------

    def _lead_tick(self, attach_lanes, cond, active):
        """Rank 0's pump, under _carry_lock + _device_lock: one tick on
        every rank of the mesh (the attach splice of `attach_lanes`, and
        with `cond` the masked push) -> the gathered audio, or None."""
        attach, push = bool(attach_lanes), cond is not None
        if not (attach or push):
            return None
        parts = []
        if attach:
            mask = np.zeros((self.lanes,), np.float32)
            mask[list(attach_lanes)] = 1.0
            parts += [mask, self._spk_rows.reshape(-1)]
        if push:
            parts += [active.astype(np.float32), cond.reshape(-1)]
        buf = torch.from_numpy(np.concatenate(parts)).to(self.device)
        with self._channel.leading():
            self._channel.send(TICK, int(attach), int(push), buf.numel())
            return self._mesh_tick(attach, push, buf)

    @torch.no_grad()
    def _mesh_tick(self, attach, push, buf):
        """Every rank: rank 0's tick buffer (broadcast into `buf`), the
        attach splice and the masked push on this rank's lanes, the vote,
        then the audio (lanes, K * lookback) gathered over 'data' (None
        without a push)."""
        self._channel.share([buf])
        L, S = self.lanes, self.cfg.spk_dim
        local = batch_sharding(self.mesh).local

        def tick():
            rest = buf
            if attach:
                mask, rows, rest = rest.split([L, L * S, rest.numel()
                                               - L - L * S])
                with profiling.span("mux.attach"):
                    _write(self._carry, self._attach_many(
                        self._carry, local(mask > 0.5),
                        local(rows.view(L, S))))
            if not push:
                return None
            active, cond = rest.split([L, rest.numel() - L])
            audio = self._advance(
                self._carry, local(cond.view(L, self.K, -1)),
                local(active > 0.5))
            self.ticks += 1
            return audio

        audio = self._channel.run(tick)
        return None if audio is None else gather_lanes(self.mesh, audio)

    def feed(self, lane: int, cond_blocks):
        """Queue (K, C) conditioner blocks for a lane and wake the pump."""
        with self._cv:
            self._pending[lane].extend(cond_blocks)
            self._cv.notify_all()

    def release(self, lane: int) -> None:
        with self._cv:
            self._pending.pop(lane, None)
            self._queued.pop(lane, None)
            self._out.pop(lane, None)
            self._sinks.pop(lane, None)
            self._pending_attach.discard(lane)
            self._free.append(lane)

    def out_queue(self, lane: int):
        return self._out[lane]

    def set_sink(self, lane: int, cb) -> None:
        """Route the lane's audio to `cb(pcm16_bytes)` instead of its
        out-queue. `cb` runs on the PUMP thread once per drained tick — it
        must be cheap and non-blocking (the async front-end's sink records
        the bytes and schedules one event-loop wakeup). Cleared on
        release()."""
        with self._cv:
            self._sinks[lane] = cb

    # -- pump -------------------------------------------------------------

    def start(self, device_lock=None) -> None:
        if self.mesh is not None and self._channel is None:
            raise ValueError("a pump over a mesh leads the other ranks "
                             "through a serving channel (channel=)")
        if device_lock is not None:
            self._device_lock = device_lock
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="msnv-mux-pump")
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _drain_one(self):
        """Wait for the oldest tick's fetch, then deliver its audio."""
        fetch, served, pushed = self._inflight.pop(0)
        with profiling.span("mux.wait"):
            audio = fetch.result()
        with profiling.span("mux.deliver") as delivered:
            # one vectorized float -> PCM16 convert per tick instead of one
            # per lane per handler: out_queue consumers receive int16 rows
            pcm = (np.clip(audio, -1.0, 1.0 - 1.0 / 32768)
                   * 32768.0).astype("<i2")
            for lane, gen in served:
                # drop audio of released streams; the gen check stops a
                # recycled lane's new occupant from receiving it
                if self._gen[lane] != gen:
                    continue
                sink = self._sinks.get(lane)
                if sink is not None:
                    sink(pcm[lane].tobytes())
                    continue
                q = self._out.get(lane)
                if q is not None:
                    q.put(pcm[lane])
        if pushed is not None and delivered is not None:
            profiling.interval("mux.inflight", pushed.end_ns,
                               delivered.end_ns)

    def _revalidate_served(self, served, active):
        """Drop lanes recycled between their block pop and the push.

        MUST be called under _carry_lock. A lane released and re-acquired
        after the pump popped its cond block holds the NEW stream's state
        (or will, once its attach is flushed); a push with the OLD stream's
        conditioners must not advance it (_drain_one's gen check only drops
        the stale audio, not the state advance). acquire increments _gen
        first, so any recycle is visible here as a gen change."""
        stale = [i for i, (lane, gen) in enumerate(served)
                 if self._gen[lane] != gen]
        for i in reversed(stale):
            lane, _ = served.pop(i)
            active[lane] = False

    def _pump(self):
        # grad mode and the current CUDA device are per thread
        on_device = (torch.cuda.device(self.device)
                     if self.device.type == "cuda"
                     else contextlib.nullcontext())
        with torch.no_grad(), on_device:
            self._pump_loop()

    def _count_starved(self):
        """Before a push: count it in `starved`, with a zero-length
        `mux.starved` span, if every earlier tick's fetch has completed
        (the card has nothing left to run and waits on the host)."""
        if all(fetch.done() for fetch, _, _ in self._inflight):
            self.starved += 1
            with profiling.span("mux.starved"):
                pass

    def _pump_loop(self):
        while True:
            # deliver every tick that has finished, in order; then, with
            # ticks n - 2 and n - 1 still on the card, wait for n - 2
            # before popping tick n, so the card holds at most _ON_CARD
            while self._inflight and self._inflight[0][0].done():
                self._drain_one()
            while len(self._inflight) >= _ON_CARD:
                self._drain_one()
            with self._cv:
                while not self._stop and not any(self._pending.values()):
                    # nothing to push: finish draining, then sleep
                    if self._inflight:
                        break
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    break
                served, cond = [], None
                attach_lanes, queued = (), {}
                if any(self._pending.values()):
                    cond = self._zeros_cond.copy()
                    for lane, blocks in self._pending.items():
                        if blocks:
                            cond[lane] = blocks.pop(0)
                            served.append((lane, self._gen[lane]))
                    # streams whose first block this is (mux.queue)
                    if self._queued:
                        queued = {(lane, gen): self._queued.pop(lane)
                                  for lane, gen in served
                                  if lane in self._queued}
                    # pop deferred attaches under the SAME _cv hold as the
                    # block pop: every acquire whose feed produced a popped
                    # block is in this snapshot (or an earlier tick's)
                    attach_lanes = self._pending_attach
                    self._pending_attach = set()
            if cond is None:
                # woke only to drain
                self._drain_one()
                continue
            active = np.zeros((self.lanes,), bool)
            active[[lane for lane, _ in served]] = True
            with self._carry_lock, self._device_lock:
                if self.mesh is not None:
                    self._revalidate_served(served, active)
                    if not served:
                        self._lead_tick(attach_lanes, None, active)
                        continue
                    with profiling.span("mux.push") as pushed:
                        self._count_starved()
                        fetch = _Fetch(self._lead_tick(attach_lanes, cond,
                                                       active))
                else:
                    self._flush_attaches(attach_lanes)
                    self._revalidate_served(served, active)
                    if not served:
                        continue
                    with profiling.span("mux.push") as pushed:
                        self._count_starved()
                        fetch = _Fetch(self._tick(cond, active))
            if pushed is not None:
                for req in served:
                    if req in queued:
                        profiling.interval("mux.queue", queued[req],
                                           pushed.start_ns, request=req)
            self._inflight.append((fetch, served, pushed))
        while self._inflight:
            self._drain_one()


# the sample-window kernel's launch counters
_COUNTERS = ("launches", "resident", "grid", "lanes", "passes")


def _window_counts():
    return {k: getattr(sample_window, k) for k in _COUNTERS}


def _add_window_counts(counts):
    for k, n in counts.items():
        setattr(sample_window, k, getattr(sample_window, k) + n)


class _Staging:
    """Host arrays into fixed device tensors without blocking the host:
    `put` writes them into a slot of pinned host buffers and copies the
    slot into the tensors with non_blocking=True on the current stream.

    A slot is written again only after an event recorded behind its
    copies has completed. With one slot for each tick the card holds
    (_ON_CARD) and one put a tick that wait never blocks: tick n's put
    takes the slot of tick n - _ON_CARD's, and the pump pops tick n only
    once every tick up to n - _ON_CARD has finished, whose fetch event
    was recorded after its inputs' copies. Should a slot come round
    sooner (a splice in a tick whose lanes were all recycled), the wait
    holds the host until that slot's copies have run."""

    def __init__(self, targets, slots):
        self.targets = targets
        self._host = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       for t in targets] for _ in range(slots)]
        self._copied = [torch.cuda.Event() for _ in range(slots)]
        self._next = 0

    def put(self, *arrays):
        """-> the target tensors, their copies from `arrays` enqueued."""
        i = self._next
        self._next = (i + 1) % len(self._host)
        self._copied[i].synchronize()
        for host, array, target in zip(self._host[i], arrays, self.targets):
            host.numpy()[...] = array
            target.copy_(host, non_blocking=True)
        self._copied[i].record()
        return self.targets


class _PushGraph:
    """The pump's masked push (`StreamMultiplexer._advance` on the carry),
    captured once as a CUDA graph and replayed every tick: its ~1,100
    launches (K frames of the tiers, K x lookback / fs0 sample windows)
    reach the card as one graph launch.

    The graph reads the conditioners and the mask from fixed device
    tensors, which `replay` fills from pinned host buffers (`_Staging`),
    and writes the carry's own tensors and a fixed audio tensor. It
    replays on the pump's current stream, where the tick's `_Fetch`
    records its copy of the audio, so the next replay overwrites the audio
    only after that copy.

    Making it draws nothing from the carry's generator and leaves the
    carry as it is: one push on copies of both, on the capture's stream,
    meets every lazy initialisation of the push (cuBLAS's workspace, the
    window kernel's plan) outside the capture, and the capture runs
    nothing. The generator is registered with the graph, so each replay
    draws what the eager push would have drawn and advances the generator
    as far.

    `sample_window`'s counters count the windows of the pump's ticks: the
    scratch push and the capture leave them as they were, and each replay
    adds the windows of the captured push.
    """

    def __init__(self, mux):
        dev = mux.device
        self.cond = torch.zeros(
            (mux.lanes, mux.K, mux.cfg.effective_cond_dim), device=dev)
        self.active = torch.zeros((mux.lanes,), dtype=torch.bool, device=dev)
        self._inputs = _Staging([self.cond, self.active], _ON_CARD)
        generator = mux._carry[3]
        scratch = torch.Generator(device=dev)
        scratch.set_state(generator.get_state())
        before = _window_counts()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            mux._advance(_own(mux._carry[:3] + (scratch,)), self.cond,
                         self.active)
        self.windows = {k: n - before[k]
                        for k, n in _window_counts().items()}
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.audio = mux._advance(mux._carry, self.cond, self.active)
        _add_window_counts({k: before[k] - n
                            for k, n in _window_counts().items()})

    def replay(self, cond, active):
        """One tick from host `cond` and `active` -> the audio tensor."""
        self._inputs.put(cond, active)
        with profiling.span("mux.replay"):
            self.graph.replay()
        _add_window_counts(self.windows)
        return self.audio
