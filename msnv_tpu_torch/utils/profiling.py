"""Profiling hooks: torch.profiler traces, a step timer, roofline numbers.

Port of the JAX package's utils/profiling.py. The JAX package's
`enable_compile_cache` has no counterpart here: the port compiles nothing
per process but its CUDA kernels, and their build directory
(msnv_tpu_torch/build/, one library per source content hash) is already
its cache.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (host and, where a card is
    present, CUDA activities) and write a Chrome trace (view it in Perfetto
    or chrome://tracing) into `log_dir`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock step statistics with warmup discard.

    CUDA work is asynchronous: with `sync=True` each step ends with a
    device synchronize, so that its time covers the work it launched."""

    def __init__(self, warmup: int = 1, sync: bool = False):
        self.warmup = warmup
        self.sync = sync
        self.times = []
        self._n = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self):
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.median(a)),
                "p95_s": float(np.percentile(a, 95)), "n": len(a)}


def roofline(flops: float, bytes_moved: float, wall_s: float,
             peak_flops: float = 989e12, peak_bw: float = 3.35e12):
    """Roofline utilization numbers for one kernel/step on an NVIDIA H100
    SXM (defaults: dense bf16 tensor-core peak 989 TFLOP/s, HBM3 3.35
    TB/s)."""
    return {
        "achieved_tflops": flops / wall_s / 1e12,
        "flops_util": flops / wall_s / peak_flops,
        "achieved_gbps": bytes_moved / wall_s / 1e9,
        "bw_util": bytes_moved / wall_s / peak_bw,
        "arithmetic_intensity": flops / max(bytes_moved, 1.0),
    }


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
