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

Not ported in this slice: the AOT artifact, the device mesh and the lane
multiplexer (`mux_lanes`); the constructor raises NotImplementedError for
them.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.data.wavio import pcm16_bytes, wav_bytes
from msnv_tpu_torch.models.generate import generate_fn, streaming_fn
from msnv_tpu_torch.serving.batcher import _Batcher
from msnv_tpu_torch.serving.common import SAMPLE_RATE, Overloaded, _armed


class _Fetch:
    """Device -> host copy of one audio chunk, started at dispatch time:
    a non-blocking copy into pinned memory plus a CUDA event; `result()`
    waits on the event only. CPU tensors are already on the host."""

    def __init__(self, audio: torch.Tensor):
        self.event = None
        if audio.is_cuda:
            self.host = torch.empty(audio.shape, dtype=audio.dtype,
                                    pin_memory=True)
            self.host.copy_(audio, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = audio

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class VocoderService:
    """Holds the model + generation callables for the server."""

    def __init__(self, params, cfg: ModelConfig, temperature_default=1.0,
                 frame_bucket: int = 16, frames_per_push: int = 1,
                 max_batch: int = 1, linger_ms: float = 10.0,
                 max_streams: int = 8, name: str = "msnv", artifact=None,
                 mux_lanes: int = 0, mesh=None):
        if artifact is not None or mux_lanes or mesh is not None:
            raise NotImplementedError(
                "artifact, mux_lanes and mesh are not ported yet")
        self.params = params
        self.cfg = cfg
        self.device = params["mlp"]["embedding"].device
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
        self._gen_cache = {}       # temperature -> generate fn
        self._stream_cache = {}    # (T, K) -> (init_state, push)
        self._lock = threading.Lock()  # one device user at a time
        # dynamic batching (max_batch > 1): concurrent /synthesize
        # requests coalesce into one device call; per-request `seed`
        # reproducibility then holds only for identical batch composition
        self._batcher = (_Batcher(self._run_group, max_batch,
                                  linger_ms / 1000.0)
                         if max_batch > 1 else None)
        # concurrent-stream cap: each open /stream holds device state and
        # an HTTP thread for its lifetime; excess requests get 429
        self.max_streams = int(max_streams)
        self._stream_slots = threading.BoundedSemaphore(
            max(self.max_streams, 1))

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
        _padded, temperature, _kind = gkey
        b = len(items)
        # pad lanes to the next power of two (padded lanes repeat lane 0
        # and are sliced away), as the JAX service does
        lanes = 1 << (b - 1).bit_length()
        conds = np.stack([it["cond"] for it in items]
                         + [items[0]["cond"]] * (lanes - b))
        spks = np.concatenate([it["spk"] for it in items]
                              + [items[0]["spk"]] * (lanes - b))
        # one generator for the whole batch: fold the request seeds
        seed = items[0]["seed"]
        for it in items[1:]:
            seed = (seed * 1000003 + it["seed"]) % (1 << 63)
        with self._lock:
            if temperature not in self._gen_cache:
                self._evict(self._gen_cache)
                self._gen_cache[temperature] = generate_fn(
                    self.params, self.cfg, temperature=temperature)
            audio, _ = self._gen_cache[temperature](
                torch.from_numpy(conds).to(self.device),
                torch.from_numpy(spks).to(self.device),
                self._generator(seed))
            audio = audio.cpu().numpy()
        return [audio[i, :it["n"] * self.cfg.lookback]
                for i, it in enumerate(items)]

    MAX_CACHED_CALLABLES = 8

    def _evict(self, cache: dict) -> None:
        """Bound the callable caches: the key is the client-supplied
        temperature, and each /stream entry holds a cast copy of the
        weights."""
        while len(cache) >= self.MAX_CACHED_CALLABLES:
            cache.pop(next(iter(cache)))   # oldest-inserted first

    # -- streaming synthesis ----------------------------------------------

    def _stream_push(self, temperature, k):
        """(init_state(batch, spk, generator), push(carry, cond)) for
        K-frame pushes. On CUDA at temperature > 0: bf16 weights and the
        sample-window kernel (one launch per 20-sample window instead of
        a per-sample loop); greedy and CPU keep the per-sample path."""
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
        """Parse a /stream body -> (cond, spk, temperature, seed); raises
        ValueError/KeyError on malformed requests before any resource is
        taken."""
        return self._parse(body)

    def stream(self, body: dict):
        """Yield PCM16 chunks as frame groups are generated. Trailing
        frames beyond a multiple of `frames_per_push` finish with 1-frame
        pushes (a K-frame push is sample-exact vs K single pushes).

        Raises Overloaded (HTTP 429) beyond `max_streams` concurrent
        streams; the slot is released when the generator finishes or is
        closed (client disconnect included)."""
        # 400s must not consume a slot: parse before acquiring anything
        cond, spk, temperature, seed = self.parse_stream(body)
        if self.max_streams <= 0 or \
                not self._stream_slots.acquire(blocking=False):
            raise Overloaded(
                f"too many concurrent streams (cap {self.max_streams})")
        # _armed: the slot must be released even if the caller errors
        # before ever iterating the returned generator
        return _armed(self._stream_iter(cond, spk, temperature, seed),
                      self._stream_slots.release)

    # fetch-pipeline depth for /stream: chunks in flight between device
    # dispatch and host fetch. Each chunk's copy starts at dispatch
    # (_Fetch); the handler drains chunk k-D while pushes k-D+1..k run.
    stream_fetch_depth = 8

    def _stream_iter(self, cond, spk, temperature, seed):
        K = self.frames_per_push
        init_state, push = self._stream_push(temperature, K)
        cond_t = torch.from_numpy(np.ascontiguousarray(cond)).to(self.device)
        with self._lock:
            carry = init_state(1, torch.from_numpy(spk).to(self.device),
                               self._generator(seed))
        n = cond.shape[0]
        queue = []

        def flush(fetch):
            return pcm16_bytes(fetch.result()[0])

        def enqueue(audio):
            queue.append(_Fetch(audio))
            if len(queue) > self.stream_fetch_depth:
                return flush(queue.pop(0))
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
            _, push1 = self._stream_push(temperature, 1)
            for j in range(n - n % K, n):
                with self._lock:
                    carry, audio, _ = push1(carry, cond_t[None, j])
                out = enqueue(audio)
                if out is not None:
                    yield out
        for fetch in queue:
            yield flush(fetch)
