"""Readings that set the limits of `correct`: the program's numbers and the
controls' on many seeds, in one process (the set-up is paid per seed, the
CUDA start once).

    python h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--controls fp8,half] [--seconds 2]

For each seed: the cell's set-up, a window of --seconds, the check of the
program, then of each control put in the program's place: "fp8" or "tf32",
the reference in that precision; "half", the reference's float32 steps on
half of each batch (train cells). Prints one JSON line a reading. The
benchmark's runs never run this.
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from h100_bench import harness

    bench = harness.load_json(REPO / "BENCHMARK.json")
    cell, conf = harness.find_cell(bench, args.workload)
    config = harness.load_json(REPO / conf["file"])
    root = REPO / "h100_bench"
    traffic = harness.load_json(root / "traffic" / f"{cell['traffic']}.json")
    driver_mod = harness.load_driver(root, traffic["driver"])
    device = torch.device(args.device)
    controls = [c for c in args.controls.split(",") if c]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(args.workload, config, traffic, seed, device,
                              args.seconds)
        driver = driver_mod.Driver(ctx)
        win = driver.window(args.seconds, False)
        driver.finish()
        readings = {"program": driver.check()}
        for c in controls:
            readings[c] = driver.check(c)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "metrics": win.metrics, "readings": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del driver
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
