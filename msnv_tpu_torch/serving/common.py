"""Shared serving primitives: constants, error types, generator arming,
and the pipelined device -> host audio fetch.

The port's own copy of the JAX package's serving/common.py, plus `_Fetch`
(the counterpart of jax.Array.copy_to_host_async), which the
per-connection /stream and the multiplexer's pump share; public names
re-export from `msnv_tpu_torch.serving`.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 16000


class Overloaded(Exception):
    """Raised when the concurrent-stream cap is hit (HTTP 429)."""


class _TooLarge(Exception):
    """Request body over the handler's max_body cap (HTTP 413)."""

    def __init__(self, length: int):
        super().__init__(length)
        self.length = length


def _armed(body_gen, cleanup):
    """Return a STARTED generator whose `cleanup` is guaranteed to run
    when it is closed, exhausted, or garbage-collected.

    An unstarted generator's ``finally`` never executes (close() on it
    skips the body), so acquiring a resource before returning a fresh
    generator leaks it permanently if the caller errors before the first
    ``next()`` — e.g. an HTTP handler whose header write fails on a
    disconnected client. Priming past a sentinel yield enters the
    ``try`` block, arming the cleanup for every subsequent outcome
    (CPython refcounting closes an abandoned suspended generator
    immediately)."""
    def run():
        try:
            yield None           # priming sentinel (consumed below)
            yield from body_gen
        finally:
            cleanup()

    g = run()
    next(g)                      # enter try: cleanup is now armed
    return g


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

    def done(self) -> bool:
        """Whether the copy has completed (an event query, no wait)."""
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()
