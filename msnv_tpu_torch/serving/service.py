"""VocoderService: the model + generation callables behind HTTP.

Port of the JAX package's serving/service.py. Endpoints (served by httpd.py):

  GET  /healthz     -> JSON {status, model, spk_dim, cond_dim, ...}
  POST /synthesize  -> complete WAV (audio/wav)
       JSON body: {"cond": [[...frame vectors (effective_cond_dim)...]],
                   "spk": int | [mix weights], "temperature": 1.0,
                   "seed": 0}
       "cond" may also be a base64 string of little-endian float32
       frame-major data (~4x smaller and far cheaper to parse).
  POST /stream      -> chunked PCM16 (audio/L16;rate=16000): same body;
       audio is flushed per conditioner-frame group as it is generated
       (models/generate.streaming_fn, O(1) server-side state).

Kernel dispatch, as in the JAX service: on CUDA, /stream at temperature
> 0 runs bf16 weights and the sample-window kernel; greedy (T == 0) keeps
the per-sample path; /synthesize runs the per-sample generate_fn in the
params' dtype. Requests are padded up to a multiple of `frame_bucket`
frames (the last frame repeats) and trimmed, as in the JAX service.

For many concurrent streams, `mux_lanes=N` starts the lane-batched
StreamMultiplexer (serving/mux.py): seed-less /stream requests at the
default temperature share one device carry and advance together per pump
tick, every window of a tick one launch of the sample-window kernel at
B = N. A request with a "seed" or another temperature takes the
per-connection path above.

With a serving artifact (export.py, `artifact=`), requests whose lanes,
frames, temperature and speaker kind hit an exported bucket run its
programs; /stream pushes likewise where it holds a 1-lane stream bucket
of the push's width. Everything else takes the live path. The artifact is
checked against the served model and device at construction.

Over a device mesh (`mesh=`, an N x 1 ('data', 'model') mesh of
parallel/mesh.py, one process per GPU), every rank builds the same
service, whose constructor makes every rank's params global rank 0's
(`broadcast_tree`, in place, before any other collective): rank 0 serves
(front, batcher, multiplexer pump) and leads, the other ranks run
`parallel.serve.follow(service)`. A /synthesize group's lanes (padded to
a power of two, then to a multiple of the 'data' size) are sharded over
'data': every rank generates its lanes with the folded generator
(parallel/generate.py), and rank 0 gathers the audio. Mux lanes are
sharded likewise (serving/mux.py). The artifact's programs are
single-device: a mesh's /synthesize never takes them. The per-connection
/stream stays on rank 0's device.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading

import numpy as np
import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.data.wavio import pcm16_bytes, wav_bytes
from msnv_tpu_torch.models.generate import generate_fn, streaming_fn
from msnv_tpu_torch.parallel.generate import sharded_generate_fn
from msnv_tpu_torch.parallel.mesh import (broadcast_tree, check_mesh,
                                          gather_lanes)
from msnv_tpu_torch.parallel.serve import (SYNTH, ControlChannel,
                                           float_bits, seed_slot)
from msnv_tpu_torch.serving.batcher import _Batcher
from msnv_tpu_torch.serving.common import (SAMPLE_RATE, Overloaded, _armed,
                                           _Fetch)
from msnv_tpu_torch.serving.mux import StreamMultiplexer


class VocoderService:
    """Holds the model + generation callables for the server."""

    def __init__(self, params, cfg: ModelConfig, temperature_default=1.0,
                 frame_bucket: int = 16, frames_per_push: int = 1,
                 max_batch: int = 1, linger_ms: float = 10.0,
                 max_streams: int = 8, name: str = "msnv", artifact=None,
                 mux_lanes: int = 0, mesh=None, mesh_timeout_s=600.0):
        check_mesh(mesh)
        if mesh is not None and mesh.shape["model"] > 1:
            raise ValueError(
                f"serving shards lanes over 'data' only (an N x 1 mesh, as "
                f"the JAX service's), got {mesh.shape}")
        if mesh is not None:
            # every replica serves global rank 0's weights; sent before
            # the channel exists, so the collective order stays serve.py's
            broadcast_tree(params)
        self.params = params
        self.cfg = cfg
        self.device = params["mlp"]["embedding"].device
        if artifact is not None:
            self._validate_artifact(artifact, cfg, self.device)
        self.artifact = artifact
        self.temperature_default = float(temperature_default)
        self.frame_bucket = int(frame_bucket)
        if self.frame_bucket < 1:
            raise ValueError(
                f"frame_bucket must be >= 1 (1 disables rounding), got "
                f"{frame_bucket}")
        self.frames_per_push = int(frames_per_push)
        if self.frames_per_push < 1:
            raise ValueError(
                f"frames_per_push must be >= 1, got {frames_per_push}")
        self.name = name
        # multi-device serving: rank 0 leads every other rank through the
        # control channel (parallel/serve.py); `mesh_timeout_s` is its
        # header group's timeout, which the heartbeat stays well under
        self.mesh = mesh
        self._mesh_shards = mesh.shape["data"] if mesh is not None else 1
        self._lock = threading.Lock()  # one device user at a time
        self._channel = (ControlChannel(mesh, self._lock, mesh_timeout_s)
                         if mesh is not None else None)
        leader = self._channel is None or self._channel.leader
        self._gen_cache = {}       # temperature -> generate fn
        self._stream_cache = {}    # (T, K) -> (init_state, push)
        # dynamic batching (max_batch > 1): concurrent /synthesize
        # requests coalesce into one device call; per-request `seed`
        # reproducibility then holds only for identical batch composition
        self._batcher = (_Batcher(self._run_group, max_batch,
                                  linger_ms / 1000.0)
                         if max_batch > 1 and leader else None)
        # concurrent-stream cap: each open /stream holds device state and
        # an HTTP thread for its lifetime; excess requests get 429
        self.max_streams = int(max_streams)
        self._stream_slots = threading.BoundedSemaphore(
            max(self.max_streams, 1))
        # lane-batched /stream multiplexer (mux_lanes > 0): concurrent
        # default-temperature streams share one device carry and advance
        # together per pump tick (see StreamMultiplexer). Other
        # temperatures and seed-exact requests use the per-connection path.
        self._mux = None
        if mux_lanes > 0:
            # over a mesh every rank holds its lanes of the carry; only
            # rank 0 pumps (the others tick in follow())
            self._mux = StreamMultiplexer(
                params, cfg, lanes=mux_lanes,
                frames_per_push=max(self.frames_per_push, 1),
                temperature=self.temperature_default, mesh=mesh,
                channel=self._channel)
            if leader:
                self._mux.start(device_lock=self._lock)
        if self._channel is not None and leader:
            self._channel.start_heartbeat()

    def close(self) -> None:
        """Stop background machinery (the mux pump); over a mesh, rank 0
        then sends the followers STOP. Idempotent."""
        if self._mux is not None:
            self._mux.stop()
        if self._channel is not None and self._channel.leader:
            self._channel.stop()

    @staticmethod
    def _validate_artifact(artifact, cfg: ModelConfig, device) -> None:
        """Fail at startup, not per request: an artifact exported from a
        different architecture would either fail in every bucket hit or,
        for same-shaped configs like ulaw:T vs ulaw:F, silently make wrong
        audio; one traced for another device type cannot run here."""
        manifest = getattr(artifact, "manifest", None)
        if not isinstance(manifest, dict):
            raise ValueError(f"not a loaded artifact: {artifact!r}")
        # engine-choice fields are numerics-equivalent and not part of the
        # programs (the artifact's engine is its manifest's "engine")
        engine_fields = ("gru_impl", "mlp_grad_impl")

        def norm(d):
            return {k: list(v) if isinstance(v, (list, tuple)) else v
                    for k, v in d.items() if k not in engine_fields}

        want = norm(dataclasses.asdict(cfg))
        got = norm(dict(manifest.get("model") or {}))
        if want != got:
            diff = sorted(k for k in set(want) | set(got)
                          if want.get(k) != got.get(k))
            raise ValueError(
                f"artifact/model config mismatch on {diff}: "
                f"artifact {[got.get(k) for k in diff]} vs served model "
                f"{[want.get(k) for k in diff]}")
        platforms = manifest.get("platforms") or []
        if device.type not in platforms:
            raise ValueError(
                f"artifact was exported for platforms {platforms}; this "
                f"server runs on '{device.type}' (re-export with "
                f"msnv-export-torch --device {device.type})")

    # -- request plumbing ------------------------------------------------

    def _parse(self, body: dict):
        C = self.cfg.effective_cond_dim
        raw = body["cond"]
        if isinstance(raw, str):
            # binary conditioners: base64 of little-endian float32,
            # frame-major (frames, C)
            import base64
            import binascii
            try:
                buf = base64.b64decode(raw, validate=True)
            except binascii.Error as e:
                raise ValueError(f"cond base64: {e}")
            if len(buf) % (4 * C):
                raise ValueError(
                    f"cond base64 payload ({len(buf)} bytes) is not a "
                    f"whole number of {C}-dim float32 frames")
            cond = np.frombuffer(buf, "<f4").reshape(-1, C)
        else:
            cond = np.asarray(raw, np.float32)
        if cond.ndim != 2 or cond.shape[1] != C:
            raise ValueError(
                f"cond must be (frames, {C}), got {cond.shape}")
        spk = body.get("spk", 0)
        if isinstance(spk, (list, tuple)):
            spk_arr = np.asarray([spk], np.float32)   # embedding mix
            if spk_arr.shape[1] != self.cfg.spk_dim:
                raise ValueError(f"spk mix needs {self.cfg.spk_dim} weights")
        else:
            if not 0 <= int(spk) < self.cfg.spk_dim:
                raise ValueError(f"spk id out of range [0, {self.cfg.spk_dim})")
            spk_arr = np.asarray([int(spk)], np.int32)
        temperature = float(body.get("temperature",
                                     self.temperature_default))
        seed = int(body.get("seed", 0))
        # cond/spk stay host-side numpy; they are uploaded once per device
        # call
        return cond, spk_arr, temperature, seed

    def healthz(self) -> dict:
        return {"status": "ok", "model": self.name,
                "spk_dim": self.cfg.spk_dim,
                "cond_dim": self.cfg.effective_cond_dim,
                "samples_per_frame": self.cfg.lookback,
                "sample_rate": SAMPLE_RATE,
                "frames_per_push": self.frames_per_push,
                "max_batch": (self._batcher.max_batch
                              if self._batcher else 1),
                "max_streams": self.max_streams,
                "mux_lanes": self._mux.lanes if self._mux else 0,
                "mesh_shards": self._mesh_shards,
                "artifact_buckets": (list(self.artifact.buckets)
                                     if self.artifact else None),
                "artifact_streams": (list(self.artifact.stream_buckets)
                                     if self.artifact else None),
                "device": str(self.device)}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- batch synthesis ---------------------------------------------------

    def synthesize(self, body: dict) -> bytes:
        """Full-utterance synthesis -> WAV bytes."""
        cond, spk, temperature, seed = self._parse(body)
        n = cond.shape[0]
        padded = -(-n // self.frame_bucket) * self.frame_bucket
        if padded != n:
            cond = np.concatenate(
                [cond, np.repeat(cond[-1:], padded - n, axis=0)], axis=0)
        item = {"cond": cond, "spk": spk, "seed": seed, "n": n}
        gkey = (padded, temperature,
                "f" if np.asarray(spk).dtype.kind == "f" else "i")
        if self._batcher is not None:
            audio = self._batcher.submit(gkey, item)
        else:
            audio = self._run_group(gkey, [item])[0]
        return wav_bytes(audio, SAMPLE_RATE)

    def warm(self, frames: int, temperature=None, lanes=None) -> None:
        """Run one /synthesize group per power-of-two lane count up to
        max_batch, so the first live requests of each size find the
        callables built (and the CUDA allocator warm)."""
        temperature = (self.temperature_default if temperature is None
                       else float(temperature))
        padded = -(-frames // self.frame_bucket) * self.frame_bucket
        if lanes is None:
            mb = self._batcher.max_batch if self._batcher else 1
            lanes, b = [], 1
            while b <= mb:
                lanes.append(b)
                b *= 2
        cond = np.zeros((padded, self.cfg.effective_cond_dim), np.float32)
        spk = np.zeros((1,), np.int32)
        gkey = (padded, temperature, "i")
        for b in lanes:
            items = [{"cond": cond, "spk": spk, "seed": 0, "n": frames}
                     for _ in range(b)]
            self._run_group(gkey, items)

    def _run_group(self, gkey, items) -> list:
        """One device call for a group of same-shape requests; returns the
        per-request float audio (trimmed to each request's frames)."""
        _padded, temperature, kind = gkey
        b = len(items)
        # pad lanes to the next power of two (padded lanes repeat lane 0
        # and are sliced away), then to a multiple of the mesh's 'data'
        # size (an equal slice per shard), as the JAX service does
        lanes = 1 << (b - 1).bit_length()
        lanes = -(-lanes // self._mesh_shards) * self._mesh_shards
        conds = np.stack([it["cond"] for it in items]
                         + [items[0]["cond"]] * (lanes - b))
        spks = np.concatenate([it["spk"] for it in items]
                              + [items[0]["spk"]] * (lanes - b))
        # one generator for the whole batch: fold the request seeds
        seed = items[0]["seed"]
        for it in items[1:]:
            seed = (seed * 1000003 + it["seed"]) % (1 << 63)
        art = self.artifact
        with self._lock:
            if self.mesh is not None:
                # the artifact's programs are single-device: a mesh always
                # takes the live sharded path
                audio = self._lead_synth(temperature, conds, spks, seed)
            else:
                if self._artifact_serves(temperature, kind) and \
                        art.has_bucket(lanes, conds.shape[1]):
                    gen = functools.partial(art.call, self.params)
                else:
                    if temperature not in self._gen_cache:
                        self._evict(self._gen_cache)
                        self._gen_cache[temperature] = generate_fn(
                            self.params, self.cfg, temperature=temperature)
                    gen = self._gen_cache[temperature]
                audio, _ = gen(torch.from_numpy(conds).to(self.device),
                               torch.from_numpy(spks).to(self.device),
                               self._generator(seed))
            audio = audio.cpu().numpy()
        return [audio[i, :it["n"] * self.cfg.lookback]
                for i, it in enumerate(items)]

    def _sharded_gen(self, temperature):
        """This rank's shard of a group call at `temperature` (cached; the
        build checks the temperature)."""
        if temperature not in self._gen_cache:
            self._evict(self._gen_cache)
            self._gen_cache[temperature] = sharded_generate_fn(
                self.params, self.cfg, self.mesh, temperature=temperature,
                gather=False)
        return self._gen_cache[temperature]

    def _lead_synth(self, temperature, conds, spks, seed):
        """Rank 0, under the device lock: one /synthesize group on every
        rank of the mesh -> the gathered audio (lanes, samples)."""
        self._sharded_gen(temperature)   # a bad temperature stops here
        seed = seed_slot(seed)
        with self._channel.leading():
            self._channel.send(SYNTH, conds.shape[0], conds.shape[1],
                               float_bits(temperature),
                               int(spks.dtype.kind == "f"), seed)
            return self._mesh_synth(
                temperature, torch.from_numpy(conds).to(self.device),
                torch.from_numpy(spks).to(self.device), seed)

    def _mesh_synth(self, temperature, cond, spk, seed):
        """Every rank: rank 0's request tensors (broadcast into `cond` and
        `spk`), this rank's lanes generated with the folded generator, the
        vote, then the audio gathered over 'data'."""
        self._channel.share([cond, spk])
        audio = self._channel.run(
            lambda: self._sharded_gen(temperature)(cond, spk, seed)[0])
        return gather_lanes(self.mesh, audio)

    MAX_CACHED_CALLABLES = 8

    def _evict(self, cache: dict) -> None:
        """Bound the callable caches: the key is the client-supplied
        temperature, and each /stream entry holds a cast copy of the
        weights."""
        while len(cache) >= self.MAX_CACHED_CALLABLES:
            cache.pop(next(iter(cache)))   # oldest-inserted first

    def _artifact_serves(self, temperature, spk_kind) -> bool:
        """Whether the artifact's programs make what a request asks for:
        its temperature and speaker kind ("f": mix weights, "i": ids)."""
        art = self.artifact
        return (art is not None
                and temperature == art.manifest["temperature"]
                and art.manifest["spk_mix"] == (spk_kind == "f"))

    # -- streaming synthesis ----------------------------------------------

    def _stream_push(self, temperature, k, spk_kind="i"):
        """(init_state(batch, spk, generator), push(carry, cond)) for
        K-frame pushes: the artifact's 1-lane stream programs where it
        holds them for this request, else live. Live on CUDA at
        temperature > 0: bf16 weights and the sample-window kernel (one
        launch per 20-sample window instead of a per-sample loop); greedy
        and CPU keep the per-sample path."""
        art = self.artifact
        if self._artifact_serves(temperature, spk_kind) and \
                art.has_stream(1, k):
            a_init, a_push = art.streaming(k, lanes=1)

            def init_state(batch, spk, generator):
                if batch != 1:
                    raise ValueError("exported stream buckets are 1-lane")
                return a_init(self.params, spk, generator)

            return init_state, functools.partial(a_push, self.params)
        with self._lock:
            if (temperature, k) not in self._stream_cache:
                self._evict(self._stream_cache)
                use_kernel = self.device.type == "cuda" and temperature > 0.0
                self._stream_cache[(temperature, k)] = streaming_fn(
                    self.params, self.cfg, frames_per_push=k,
                    temperature=temperature,
                    compute_dtype=torch.bfloat16 if use_kernel else None,
                    use_kernel=use_kernel)
            return self._stream_cache[(temperature, k)]

    def parse_stream(self, body: dict):
        """Parse a /stream body and classify its path. Returns
        (cond, spk, temperature, seed, mux_eligible); raises
        ValueError/KeyError on malformed requests BEFORE any resource is
        taken. The async front-end (serving/aio.py) uses it, since it
        drives the mux lanes itself rather than the blocking iterator."""
        cond, spk, temperature, seed = self._parse(body)
        eligible = (self._mux is not None
                    and temperature == self._mux.temperature
                    and "seed" not in body)
        return cond, spk, temperature, seed, eligible

    def stream(self, body: dict, _parsed=None):
        """Yield PCM16 chunks as frame groups are generated. Trailing
        frames beyond a multiple of `frames_per_push` finish with 1-frame
        pushes (a K-frame push is sample-exact vs K single pushes).

        Raises Overloaded (HTTP 429) beyond `max_streams` concurrent
        per-connection streams, or when every mux lane is taken; the slot
        or lane is released when the generator finishes or is closed
        (client disconnect included). `_parsed` lets a front-end that
        already ran parse_stream forward the result instead of decoding the
        cond payload a second time."""
        # 400s must not consume a slot: parse before acquiring anything
        cond, spk, temperature, seed, eligible = (
            _parsed if _parsed is not None else self.parse_stream(body))
        if eligible:
            # seed-less default-temperature streams ride the multiplexer; an
            # explicit seed asks for reproducible audio, which the shared
            # generator cannot give — that falls through to per-connection
            return self._mux_stream_iter(cond, spk)
        if self.max_streams <= 0 or \
                not self._stream_slots.acquire(blocking=False):
            raise Overloaded(
                f"too many concurrent streams (cap {self.max_streams})")
        # _armed: the slot must be released even if the caller errors
        # before ever iterating the returned generator
        return _armed(self._stream_iter(cond, spk, temperature, seed),
                      self._stream_slots.release)

    def _mux_stream_iter(self, cond, spk):
        """Serve one stream through the lane multiplexer: pad the cond
        track to a K-multiple (repeating the last frame), feed the lane,
        yield PCM16 chunks as its ticks drain, trim the pad."""
        mux = self._mux
        K = mux.K
        cond_np = np.asarray(cond, np.float32)
        n = len(cond_np)
        pad = (-n) % K
        if pad:
            cond_np = np.concatenate(
                [cond_np, np.repeat(cond_np[-1:], pad, axis=0)])
        lane = mux.acquire(spk)          # raises Overloaded when full

        def body():
            blocks = [cond_np[i:i + K] for i in range(0, len(cond_np), K)]
            mux.feed(lane, blocks)
            q = mux.out_queue(lane)
            remaining = n * self.cfg.lookback
            got = 0
            while got < len(blocks):
                # coalesce whatever ticks have already drained into ONE
                # chunk: a handler that fell behind catches up with one
                # write instead of one per K-frame tick (rows arrive as
                # PCM16 from the pump's vectorized convert)
                pieces = [q.get(timeout=120.0)]
                got += 1
                while got < len(blocks):
                    try:
                        pieces.append(q.get_nowait())
                        got += 1
                    except queue.Empty:
                        break
                buf = (np.concatenate(pieces) if len(pieces) > 1
                       else pieces[0])
                take = min(len(buf), remaining)
                remaining -= take
                if take > 0:
                    yield buf[:take].tobytes()

        # _armed: the lane must be released even if the caller errors
        # before ever iterating the returned generator
        return _armed(body(), lambda: mux.release(lane))

    # fetch-pipeline depth for /stream: chunks in flight between device
    # dispatch and host fetch. Each chunk's copy starts at dispatch
    # (_Fetch); the handler drains chunk k-D while pushes k-D+1..k run.
    stream_fetch_depth = 8

    def _stream_iter(self, cond, spk, temperature, seed):
        kind = "f" if spk.dtype.kind == "f" else "i"
        K = self.frames_per_push
        init_state, push = self._stream_push(temperature, K, kind)
        # a copy: a base64 payload arrives as a read-only numpy view
        cond_t = torch.tensor(cond, dtype=torch.float32, device=self.device)
        with self._lock:
            carry = init_state(1, torch.from_numpy(spk).to(self.device),
                               self._generator(seed))
        n = cond.shape[0]
        inflight = []

        def flush(fetch):
            return pcm16_bytes(fetch.result()[0])

        def enqueue(audio):
            inflight.append(_Fetch(audio))
            if len(inflight) > self.stream_fetch_depth:
                return flush(inflight.pop(0))
            return None

        for start in range(0, n - n % K, K):
            block = cond_t[start:start + K]
            with self._lock:
                carry, audio, _ = push(
                    carry, block[None] if K > 1 else block[None, 0])
            out = enqueue(audio)
            if out is not None:
                yield out
        if n % K:
            # the artifact's and the live carries are the same
            # (spk_vec, buf, hs, generator): the trailing 1-frame pushes
            # may come from either
            _, push1 = self._stream_push(temperature, 1, kind)
            for j in range(n - n % K, n):
                with self._lock:
                    carry, audio, _ = push1(carry, cond_t[None, j])
                out = enqueue(audio)
                if out is not None:
                    yield out
        for fetch in inflight:
            yield flush(fetch)
