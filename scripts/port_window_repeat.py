#!/usr/bin/env python3
"""Repeat the resident sample-window kernel on fixed inputs and count runs
whose samples differ from the first run's: a race shows up as a rare run
that differs.

    python3 scripts/port_window_repeat.py [--source FILE.cu ...]
        [--batches 1024 128] [--runs 4000]

Each `--source` (default the package's csrc/sample_window.cu) is built and
driven in turn, in the order given (name one twice to interleave, e.g.
old, new, new, old); an older source comes from git, e.g.
`git show <commit>:msnv_tpu_torch/csrc/sample_window.cu > old.cu`, and
must read the weights as `pack_window_weights` packs them (a source from
before each CTA owned rows of W_o, not columns, does not). Full
width (fs0 20, q 256, dim 1024), bf16, unsharpened random weights, both
noise modes, a bf16 matmul after every 7th window so that other kernels
run in between. Prints one line per (source, batch, mode) and a JSON line
of all counts with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", action="append", type=Path)
    p.add_argument("--batches", type=int, nargs="+", default=[1024, 128])
    p.add_argument("--runs", type=int, default=4000)
    args = p.parse_args(argv)

    import torch

    import chip_smoke as cs
    from msnv_tpu_torch.kernels import sample_window as sw

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = []
    for source in args.source or [sw.SOURCE]:
        sw._lib = None
        sw.SOURCE = source.resolve()
        sw.build()
        t0 = time.perf_counter()
        for batch in args.batches:
            table, wh, bh, wo, bo, slots, buf, g = cs.random_window_inputs(
                cs.FS0, cs.Q, cs.DIM, batch, bf16, dev, seed=100 + batch)
            noise = sw.gumbel_noise((batch, cs.FS0, cs.Q), g, dev)
            seed = torch.randint(0, 2 ** 62, (1,), generator=g, device=dev,
                                 dtype=torch.int64)
            w = (table, wh, bh, wo, bo, slots, buf)
            packed = sw.resident_weights(wh, wo, cs.FS0)
            a = torch.randn(2048, 2048, device=dev, dtype=bf16)
            for mode, kw in (("noise", {"noise": noise}),
                             ("philox", {"seed": seed})):
                first = sw.sample_window(*w, packed=packed, **kw)
                # counted on the card: no synchronize between launches
                differ = torch.zeros((), dtype=torch.int64, device=dev)
                cells = torch.zeros((), dtype=torch.int64, device=dev)
                for i in range(args.runs):
                    n = (sw.sample_window(*w, packed=packed, **kw)
                         != first).sum()
                    differ += n > 0
                    cells = torch.maximum(cells, n)
                    if i % 7 == 0:
                        a = (a @ a).clamp_(-1, 1)
                differ, cells = int(differ), int(cells)
                rows.append({"source": str(source), "batch": batch,
                             "mode": mode, "runs": args.runs,
                             "differ": differ, "most_cells": cells})
                print(f"{source.name} B={batch} {mode}: {differ} of "
                      f"{args.runs} runs differ from the first (most "
                      f"samples in one run {cells})", flush=True)
        print(f"{source.name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"card": cs.card_line(), "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
