"""Profiling: torch.profiler traces, and the program's own spans.

`trace(log_dir)` writes a Chrome trace of a block, every thread's operators
in it. While a torch.profiler records (`trace()` or any other profile; the
module flag `torch.autograd.profiler._is_profiler_enabled`, which every
thread sees), the program records spans into one bounded ring in memory:

- `span(name, request=None)`: a stretch of host code, on the clock that
  torch.profiler gives host events (`time.time_ns()`), with the span
  enclosing it on its thread (the parent) and a request id (spans of one
  stream share it). It also opens `record_function(name)`, so the same
  range sits in the Chrome trace beside the device's kernels.
- `interval(name, start_ns, end_ns, request=None)`: a span that opens in
  one place and closes in another (a queue wait, audio in flight).
- `section(name, device)`: a stretch of the device's current CUDA stream,
  timed by a pair of CUDA events; the pair is read once its end event has
  completed (polled at the next section; a reading waits for it), never by
  a synchronize on the path it times. On the CPU, the host clock.

With no profiler recording, each costs one flag test and records nothing.
A span records only if a profiler records when it opens and when it
closes: one that outlasts the profiler's stop (which can hold the other
threads for seconds while it gathers its events) is dropped. Readings
(`records`, `totals`, `percentile`) see every record of the ring, those
made while the profiler recorded, also after it stopped.

The JAX package's `enable_compile_cache` has no counterpart here: the port
compiles nothing per process but its CUDA kernels, and their build
directory (msnv_tpu_torch/build/, one library per source content hash) is
already its cache.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

RING = 1 << 16        # records kept; the oldest go first


class Record:
    """One span: its name, its host start and end (ns, `time.time_ns()`),
    its duration in seconds (a section's on the device), the name of the
    span that encloses it on its thread, and its request id."""

    __slots__ = ("name", "start_ns", "end_ns", "seconds", "parent",
                 "request")

    def __init__(self, name, start_ns, parent, request):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.seconds, self.parent, self.request = None, parent, request

    def __repr__(self):
        return (f"Record({self.name!r}, {self.seconds!r} s, "
                f"parent={self.parent!r}, request={self.request!r})")


_ring = collections.deque(maxlen=RING)
_local = threading.local()
_pending = []          # (record, device, start event, end event)
#                        of the sections not yet read
_pool = {}             # device -> free timing events
_lock = threading.Lock()
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a torch.profiler records now (on any thread)."""
    return _autograd_profiler._is_profiler_enabled


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    def __init__(self, name, request):
        self.name, self.request = name, request

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack = _stack()
        self.record = Record(self.name, time.time_ns(),
                             stack[-1] if stack else None, self.request)
        stack.append(self.name)
        return self.record

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = time.time_ns()
        _stack().pop()
        self._range.__exit__(*exc)
        if _autograd_profiler._is_profiler_enabled:
            rec.seconds = (rec.end_ns - rec.start_ns) * 1e-9
            _ring.append(rec)


class _Section(_Span):
    def __init__(self, name, device):
        super().__init__(name, None)
        self.device = device

    def __enter__(self):
        rec = super().__enter__()
        _resolve(wait=False)
        with _lock:
            free = _pool.setdefault(self.device, [])
            self._events = [free.pop() if free else
                            torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
        self._stream = torch.cuda.current_stream(self.device)
        self._events[0].record(self._stream)
        return rec

    def __exit__(self, *exc):
        self._events[1].record(self._stream)
        rec = self.record
        rec.end_ns = time.time_ns()
        _stack().pop()
        self._range.__exit__(*exc)
        with _lock:
            if _autograd_profiler._is_profiler_enabled:
                _pending.append((rec, self.device, *self._events))
            else:
                _pool[self.device] += self._events


def span(name: str, request=None):
    """Context manager: a host span (module docstring); yields its Record,
    whose `end_ns` is set on exit, or None when no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request)


def section(name: str, device):
    """Context manager: a stretch of `device`'s current CUDA stream timed
    on the device (module docstring); on a CPU device, a host span."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if torch.device(device).type != "cuda":
        return _Span(name, None)
    return _Section(name, torch.device(device))


def interval(name: str, start_ns: int, end_ns: int, request=None) -> None:
    """Record a span that opened at `start_ns` and closed at `end_ns`
    (`time.time_ns()`), when a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _stack()
    rec = Record(name, start_ns, stack[-1] if stack else None, request)
    rec.end_ns = end_ns
    rec.seconds = (end_ns - start_ns) * 1e-9
    _ring.append(rec)


def _resolve(wait: bool) -> None:
    """Move the sections whose end event has completed (all of them with
    `wait`) into the ring; their events go back to the pool."""
    with _lock:
        if not _pending:
            return
        open_ = []
        for rec, device, start, end in _pending:
            if wait:
                end.synchronize()
            elif not end.query():
                open_.append((rec, device, start, end))
                continue
            rec.seconds = start.elapsed_time(end) * 1e-3
            _ring.append(rec)
            _pool[device] += [start, end]
        _pending[:] = open_


def records(name: str = None) -> list:
    """The ring's records (those named `name`), oldest first; waits for
    the device sections still open."""
    _resolve(wait=True)
    return [r for r in list(_ring) if name is None or r.name == name]


def totals() -> dict:
    """name -> (count, seconds) over the ring."""
    out = {}
    for r in records():
        count, secs = out.get(r.name, (0, 0.0))
        out[r.name] = (count + 1, secs + r.seconds)
    return out


def percentile(name: str, q: float):
    """The q-th percentile (numpy's) of the durations, in seconds, of the
    records named `name`; None without one."""
    secs = [r.seconds for r in records(name)]
    return float(np.percentile(secs, q)) if secs else None


def clear() -> None:
    """Forget every record and open section."""
    with _lock:
        _ring.clear()
        _pending.clear()


def _all_threads():
    """torch.profiler's option to record every thread's operators (not
    only the thread that started it), where this PyTorch has it."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:
        return {}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (host and, where a card is
    present, CUDA activities; every thread's operators and spans where
    this PyTorch can) and write a Chrome trace (view it in Perfetto or
    chrome://tracing) into `log_dir`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, **_all_threads()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


_CHIP_LOCK_HANDLE = None


def acquire_chip_lock(path: str | None = None) -> None:
    """Serialize device-using study/benchmark processes on this host
    (`path`: the lock file, default msnv_chip.lock in the temporary
    directory).

    A second process that attaches to a device mid-run can disturb the
    first one's work; long-running entry points call this before touching
    the device. The exclusive flock blocks until the current owner exits
    and is released by process exit. No-op without fcntl (non-Linux)."""
    global _CHIP_LOCK_HANDLE
    if _CHIP_LOCK_HANDLE is not None:
        return
    try:
        import fcntl
    except ImportError:
        return
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "msnv_chip.lock")
    handle = open(path, "w")
    try:
        fcntl.flock(handle, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:
        print(f"waiting for the chip lock ({path}): another chip job "
              f"owns the device...", flush=True)
        fcntl.flock(handle, fcntl.LOCK_EX)
    _CHIP_LOCK_HANDLE = handle
    print("chip lock acquired", flush=True)
