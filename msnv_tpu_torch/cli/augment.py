"""msnv-augment-torch — stage speed/gain-perturbed variants of a wav corpus.

The port's counterpart of the JAX package's msnv-augment (the same flags,
the same files). Multiplies a small corpus with acoustically consistent
variants before `msnv-train-torch` (data/augment.py; the reference has no
augmentation — this exists for the small-data regime of
docs/REAL_SPEECH.md):

  msnv-augment-torch --datasets_path data --speeds 0.9,1.1 [--gains 0.79]
      [--dataset wav/] [--list wav_train.list]

Writes `<name>s090`-style WAVs next to the sources and rewrites the
train list (originals first, variants round-robin across utterances so
lane packing can't truncate whole speakers). Idempotent.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="msnv-augment-torch",
                                description=__doc__.splitlines()[0])
    p.add_argument("--datasets_path", required=True,
                   help="directory holding the wav subdir and the lists")
    p.add_argument("--dataset", default="wav/",
                   help="wav subdirectory (same flag as msnv-train)")
    p.add_argument("--list", dest="list_name", default="wav_train.list")
    p.add_argument("--speeds", default="0.9,1.1",
                   help="comma-separated speed-perturb factors ('' = none)")
    p.add_argument("--gains", default="",
                   help="comma-separated gain factors ('' = none)")
    args = p.parse_args(argv)

    from msnv_tpu_torch.data.augment import augment_corpus

    speeds = tuple(float(s) for s in args.speeds.split(",") if s)
    gains = tuple(float(g) for g in args.gains.split(",") if g)
    if not speeds and not gains:
        raise SystemExit("nothing to do: --speeds and --gains both empty")
    out = augment_corpus(args.datasets_path, speeds=speeds, gains=gains,
                         subdir=args.dataset.rstrip("/"),
                         list_name=args.list_name)
    n_orig = len(out) // (1 + len(speeds) + len(gains))
    print(f"augmented {os.path.join(args.datasets_path, args.list_name)}: "
          f"{n_orig} originals -> {len(out)} train utterances "
          f"(speeds {list(speeds)}, gains {list(gains)})")


if __name__ == "__main__":
    main()
