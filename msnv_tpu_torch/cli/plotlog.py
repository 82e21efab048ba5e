"""Offline log plotting — ref plotlog.py:12-108 capability.

`msnv-plotlog-torch`, the port's counterpart of the JAX package's
msnv-plotlog: the same parsing and plots of a results directory that
either package's trainer wrote (numpy and matplotlib only).

Parses a results directory's `log` (the tee'd stdout) and/or `stats.json`
into NLL or perplexity curves (PNG). Perplexity = 2^NLL, matching the
reference's plot modes (ref plotlog.py:82, 96-103).

Usage:
  python -m msnv_tpu_torch.cli.plotlog results/<tag> [--perplexity] \
      [--out loss.png]
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

_IT_RE = re.compile(
    r"^it (\d+)\ttraining_loss: ([\d.]+)(?:\ttraining_loss/running_avg: "
    r"([\d.]+))?")
_EP_RE = re.compile(
    r"^epoch (\d+)\t.*?validation_loss: ([\d.]+)\ttest_loss: ([\d.]+)")


def parse_log(path: str):
    """Extract iteration/epoch loss series from a tee'd log file."""
    iters, train, ravg = [], [], []
    epochs, val, test = [], [], []
    with open(path) as fh:
        for line in fh:
            m = _IT_RE.match(line)
            if m:
                iters.append(int(m.group(1)))
                train.append(float(m.group(2)))
                ravg.append(float(m.group(3)) if m.group(3) else None)
                continue
            m = _EP_RE.match(line)
            if m:
                epochs.append(int(m.group(1)))
                val.append(float(m.group(2)))
                test.append(float(m.group(3)))
    return {"iterations": iters, "training_loss": train,
            "running_avg": ravg, "epochs": epochs,
            "validation_loss": val, "test_loss": test}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("results_dir")
    p.add_argument("--perplexity", action="store_true",
                   help="plot 2^NLL instead of NLL bits")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    stats_path = os.path.join(args.results_dir, "stats.json")
    log_path = os.path.join(args.results_dir, "log")
    if os.path.isfile(stats_path):
        with open(stats_path) as fh:
            data = json.load(fh)
    elif os.path.isfile(log_path):
        data = parse_log(log_path)
    else:
        raise SystemExit(f"no stats.json or log in {args.results_dir}")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def tx(values):
        a = np.asarray([v for v in values if v is not None], dtype=float)
        return np.power(2.0, a) if args.perplexity else a

    fig, ax = plt.subplots(figsize=(9, 5))
    it = data.get("iterations", [])
    tl = tx(data.get("training_loss", []))
    if len(tl):
        ax.plot(it[:len(tl)], tl, alpha=0.4, label="train")
    eps = data.get("epochs", [])
    if eps and it:
        ex = np.linspace(0, max(it), len(eps) + 1)[1:]
        for f in ("validation_loss", "test_loss"):
            ys = tx(data.get(f, []))
            if len(ys):
                ax.plot(ex[:len(ys)], ys, marker="o", label=f.split("_")[0])
    ax.set_xlabel("iteration")
    ax.set_ylabel("perplexity (2^NLL)" if args.perplexity else "NLL (bits)")
    ax.legend()
    ax.grid(alpha=0.3)
    out = args.out or os.path.join(
        args.results_dir,
        "perplexity.png" if args.perplexity else "nll.png")
    fig.savefig(out, dpi=120)
    print("wrote", out)


if __name__ == "__main__":
    main()
