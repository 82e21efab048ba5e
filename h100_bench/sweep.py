"""The knee of a stream cell: the highest arrival rate at which the
multiplexer refuses no stream and the streams in progress do not grow
across the window. Run once on the card to set the cell's rate (0.8 of the
knee, written into its traffic file); the benchmark's runs never run this.

    python h100_bench/sweep.py --workload samplernn.stream.mux128 \
        --rates 30,35,40,45,50 --seconds 15 --seed 1

For each rate, in one process: the cell's set-up and window at that rate,
the streams in progress sampled every 0.25 s (their mean over the window's
second and last thirds: it grows when the last is above the second by more
than a tenth), refusals, and the two tails.
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    import torch

    from h100_bench import harness

    bench = harness.load_json(REPO / "BENCHMARK.json")
    cell, conf = harness.find_cell(bench, args.workload)
    config = harness.load_json(REPO / conf["file"])
    root = REPO / "h100_bench"
    base = harness.load_json(root / "traffic" / f"{cell['traffic']}.json")
    driver_mod = harness.load_driver(root, base["driver"])
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(base, rate=rate)
        ctx = harness.Context(args.workload, config, traffic, args.seed,
                              torch.device("cuda"), args.seconds)
        driver = driver_mod.Driver(ctx)
        samples, stop = [], threading.Event()

        def watch():
            t0 = time.perf_counter()
            while not stop.wait(0.25):
                busy = sum(1 for s in driver.streams
                           if s.lane >= 0 and not s.done)
                samples.append((time.perf_counter() - t0, busy))

        th = threading.Thread(target=watch)
        th.start()
        win = driver.window(args.seconds, False)
        stop.set()
        th.join()
        driver.finish()
        third = args.seconds / 3
        mid = [b for t, b in samples if third <= t < 2 * third]
        last = [b for t, b in samples if 2 * third <= t <= args.seconds]
        mean = lambda xs: sum(xs) / max(len(xs), 1)  # noqa: E731
        refused = sum(1 for s in driver.streams if s.refused)
        print(json.dumps({
            "rate": rate, "streams": win.attempted, "refused": refused,
            "failed": win.failed, "in_progress_mid": mean(mid),
            "in_progress_last": mean(last),
            "grows": mean(last) > 1.1 * mean(mid),
            "metrics": win.metrics,
            "raw": {k: v for k, v in win.raw.items()
                    if not dataclasses.is_dataclass(v)}}), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
