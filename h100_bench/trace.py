"""torch.profiler traces reduced to what the metrics read.

A traced window gives: the device time and launch count of every kernel by
name, the seconds in which any operation ran on the device (the union of
kernel, copy and set intervals), the window's length on the host's clock,
and the idle gaps between device operations labelled by the host event
that began last before each gap.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "cuda_runtime", "cuda_driver",
                   "user_annotation", "python_function")


@dataclass
class Event:
    name: str
    device: bool
    start: float      # seconds
    end: float


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [seconds, count]
    idle_by_host: dict = field(default_factory=dict)  # label -> seconds

    def kernel_time(self, match) -> tuple:
        """(seconds, launches) of the kernels whose name satisfies
        `match`."""
        secs = count = 0
        for name, (s, n) in self.kernels.items():
            if match(name):
                secs += s
                count += n
        return secs, count

    def breakdown(self, top: int = 10) -> dict:
        ops = {}
        for name, (secs, _) in self.kernels.items():
            short = short_name(name)
            ops[short] = ops.get(short, 0.0) + secs
        ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without "void ", "(anonymous namespace)::" and its
    parameter list, at most `width` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def events_of(prof):
    """The profiler's events as Event records (the kineto results; where
    this PyTorch does not expose them, its FunctionEvents)."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is None:
        return [Event(e.name, e.device_type != torch.autograd.DeviceType.CPU,
                      e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in prof.events()]
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for e in results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if kind is None:
            # older PyTorch: the device side by its type, without the
            # annotations of host ranges that CUPTI mirrors on it
            if e.is_user_annotation() if hasattr(e, "is_user_annotation") \
                    else False:
                device = None
            else:
                device = e.device_type() == cuda
        elif kind in DEVICE_ACTIVITIES:
            device = True
        elif kind in HOST_ACTIVITIES:
            device = False
        else:
            device = None
        if device is None:
            continue
        start = e.start_ns() * 1e-9
        out.append(Event(e.name(), device, start,
                         start + e.duration_ns() * 1e-9))
    return out


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce events (device and host) to a TraceSummary."""
    dev = sorted((e for e in events if e.device), key=lambda e: e.start)
    host = sorted((e for e in events if not e.device), key=lambda e: e.start)
    kernels = {}
    for e in dev:
        row = kernels.setdefault(e.name, [0.0, 0])
        row[0] += e.end - e.start
        row[1] += 1
    merged = []
    for e in dev:
        if merged and e.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.start, e.end])
    busy = sum(b - a for a, b in merged)
    idle = {}
    starts = [h.start for h in host]
    for (_, a), (b, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(starts, a) - 1
        label = host[i].name if i >= 0 else "no host event"
        idle[label] = idle.get(label, 0.0) + (b - a)
    return TraceSummary(window_s=window_s, busy_s=busy, kernels=kernels,
                        idle_by_host=idle)


def traced(fn, device):
    """Run fn() under torch.profiler (host and CUDA activities) and return
    (its result, TraceSummary). The window is fn's span on the host's
    clock, ended by a device synchronize."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = device.type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return out, summarize(events_of(prof), window)


class Span:
    """A profiler held open from start() to stop(), for a window that ends
    in another loop than the one that opens it."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        self.device = device
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._t0 = None

    def start(self):
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        return summarize(events_of(self._prof), window)
