"""One run of one cell: set-up, the measured window, the metrics, the check.

Driven by data: the cell's entry in BENCHMARK.json names its configuration
and traffic; configs/<config>.json, traffic/<traffic>.json (which names the
driver) and limits/<cell>.json hold their numbers; drivers/<driver>.py runs
the window and metrics/<metric>.py reads each per-layer metric. Adding a
cell, a configuration or a per-layer metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BANNED = ("jax", "jaxlib", "flax", "msnv_tpu")
FAR = 1e30           # a number compared that is not finite reads as this


class BenchError(Exception):
    """A run that must print no result."""


@dataclass
class Context:
    """What a driver gets: the cell, its configuration's and traffic's
    numbers, the seed, the device and the window's length."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    seconds: float

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def train(self) -> dict:
        return self.config["train"]


@dataclass
class Window:
    """What a driver's window gives: the end-to-end metrics, units attempted
    and failed, the raw counts the per-layer readers use, and the traced
    part's summary (trace.TraceSummary) when it was traced."""
    metrics: dict
    attempted: int
    failed: int
    raw: dict = field(default_factory=dict)
    trace: object = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(root: Path, name: str):
    return _module(root / "drivers" / f"{name}.py",
                   f"h100_bench_driver_{name}")


def load_reader(root: Path, name: str):
    return _module(root / "metrics" / f"{name}.py",
                   f"h100_bench_metric_{name.replace('.', '_')}")


def find_cell(bench: dict, name: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def _in_cell(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def metric_names(bench: dict, cell: str, trace: bool):
    """The end-to-end metrics of a --trace 0 line, or the per-layer metrics
    of a --trace 1 line, that this cell reports."""
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, cell)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if _in_cell(m, cell) and m["moves"] in moved]


def model_config(m: dict):
    """The port's ModelConfig of a configuration's "model" object, its GRU
    sweeps in the fused kernels (as the CLIs take them on a card)."""
    from msnv_tpu_torch.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in m.items() if k in fields}
    return ModelConfig(**kw, gru_impl="pallas")


def banned_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             repo: Path = REPO, t_start: float = None) -> dict:
    """Run one cell and return its result (the line's object, with the
    numbers compared under "checks")."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    root = repo / "h100_bench"
    bench = load_json(repo / "BENCHMARK.json")
    cell, conf = find_cell(bench, name)
    config = load_json(repo / conf["file"])
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(root / "limits" / f"{name}.json")
    names = metric_names(bench, name, trace)
    readers = ({m["name"]: load_reader(root, m["name"]) for m in names}
               if trace else {})
    driver_mod = load_driver(root, traffic["driver"])
    ctx = Context(name, config, traffic, seed, device, seconds)

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    driver = driver_mod.Driver(ctx)
    setup_s = time.perf_counter() - t_start
    win = driver.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    values = {}
    if trace:
        for m in names:
            v = readers[m["name"]].read(ctx, win)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in names:
            v = setup_s if m["name"] == "setup_s" else \
                win.metrics.get(m["name"])
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    driver.finish()
    numbers = driver.check()
    checks = {}
    # the numbers compared are those the cell's limits name (a number the
    # driver reads that no control or fault separates is not compared)
    for key, lim in limits.items():
        if key not in numbers:
            raise BenchError(f"limits/{name}.json names {key!r}, which the "
                             f"{traffic['driver']} driver does not read")
        value = numbers[key]
        if not math.isfinite(value):     # NaN or infinite: no JSON number
            value = FAR
        checks[key] = {"value": value, "limit": lim["limit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win.attempted),
           "failed": int(win.failed), "metrics": values, "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        out["breakdown"] = win.trace.breakdown()
    out["checks"] = checks
    return out
