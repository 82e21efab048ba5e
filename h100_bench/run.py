"""Run one cell of the benchmark on this machine's GPUs.

    python h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON object as the last line of its output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared with its limit; the
same numbers end its standard error. Exits non-zero, printing no result,
without enough CUDA devices, when the port or a file of the cell is
missing, or when jax or the JAX package was loaded.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the repository's root, not this directory: its modules' names (trace,
# stats) must not shadow the standard library's
sys.path[0] = str(REPO)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from h100_bench import harness

    bench = harness.load_json(REPO / "BENCHMARK.json")
    try:
        cell, _ = harness.find_cell(bench, args.workload)
    except harness.BenchError as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", REPO, T_START)
    except harness.BenchError as e:
        print(e, file=sys.stderr)
        return 2
    found = harness.banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for key, c in out["checks"].items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
