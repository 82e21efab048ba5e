"""Objective metrics CLI: MCD / F0 RMSE / V-UV error over WAV pairs.

`msnv-metrics-torch`, the port's counterpart of the JAX package's
msnv-metrics: the same flags and JSON lines, on the port's eval/metrics.py
(numpy) and data/wavio.py.

The reference has no objective evaluation tooling (quality was judged by
MOS panels, ref doc/paper.pdf Table 1); this scores copy-synthesis output
against the natural recordings, and optionally scores generated F0 against
the Ahocoder ground-truth `.lf0` tracks the model was conditioned on.

Pairing: --gen may be a WAV file or a directory of them. Generated files
follow the reference naming `<ckpt>_file-<utt>_spk-<id>.wav`
(ref generate.py:98-112); the utterance id is parsed back out and matched
to `<utt>.wav` under --ref (and `<utt>.lf0` under --lf0, if given).
Plain `<utt>.wav` generated names work too.

Usage:
  python -m msnv_tpu_torch.cli.metrics --gen results/<tag>/samples --ref wav/ \
      [--lf0 cond/] [--hop 80]

Prints one JSON line per pair plus an `aggregate` line (means).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

_FILE_RE = re.compile(r"file-(.+?)_spk-")


def utt_id(gen_name: str) -> str:
    """Utterance id from a generated-file name (reference naming or plain)."""
    stem = os.path.splitext(os.path.basename(gen_name))[0]
    m = _FILE_RE.search(stem)
    return m.group(1) if m else stem


def _wav_list(path: str) -> list:
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.lower().endswith(".wav"))
    return [path]


def _find(root: str, name: str) -> str | None:
    """Locate `name` under `root` (flat or one speaker-subdir deep —
    mirrors the reference corpus layout <wav_path>/<spk>/<utt>.wav)."""
    cand = os.path.join(root, name)
    if os.path.exists(cand):
        return cand
    if os.path.isdir(root):
        for sub in sorted(os.listdir(root)):
            cand = os.path.join(root, sub, name)
            if os.path.exists(cand):
                return cand
    return None


def main(argv=None):
    from msnv_tpu_torch.data.wavio import read_wav
    from msnv_tpu_torch.eval.metrics import (
        evaluate_pair, f0_metrics, frame_f0, lf0_track_to_f0)

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gen", required=True,
                   help="generated WAV file or directory")
    p.add_argument("--ref", required=True,
                   help="reference WAV file or directory")
    p.add_argument("--lf0", default=None,
                   help="directory of Ahocoder .lf0 ground-truth tracks")
    p.add_argument("--hop", type=int, default=80,
                   help="metric frame hop in samples (model cond rate)")
    p.add_argument("--n_mfcc", type=int, default=25)
    args = p.parse_args(argv)

    gen_files = _wav_list(args.gen)
    if not gen_files:
        print(f"no WAV files under {args.gen}", file=sys.stderr)
        return 1

    rows = []
    for gpath in gen_files:
        utt = utt_id(gpath)
        if os.path.isdir(args.ref):
            rpath = _find(args.ref, utt + ".wav")
            if rpath is None:
                print(f"skip {os.path.basename(gpath)}: no {utt}.wav "
                      f"under {args.ref}", file=sys.stderr)
                continue
        else:
            rpath = args.ref
        gen, sr_g = read_wav(gpath)
        ref, sr_r = read_wav(rpath)
        if sr_g != sr_r:
            print(f"skip {os.path.basename(gpath)}: sample-rate mismatch "
                  f"{sr_g} vs {sr_r}", file=sys.stderr)
            continue
        row = {"utt": utt, "gen": gpath, "ref": rpath}
        row.update(evaluate_pair(
            np.asarray(ref), np.asarray(gen), sr=sr_g, hop=args.hop,
            n_mfcc=args.n_mfcc))
        if args.lf0:
            lpath = _find(args.lf0, utt + ".lf0")
            if lpath is not None:
                # atleast_1d: a one-frame .lf0 loads as a 0-d array (same
                # guard as data/corpus.load_cond_tracks)
                f0_true, v_true = lf0_track_to_f0(
                    np.atleast_1d(np.loadtxt(lpath)))
                f0_gen, v_gen = frame_f0(np.asarray(gen), sr=sr_g,
                                         hop=args.hop)
                ahof0 = f0_metrics(f0_true, v_true, f0_gen, v_gen)
                row["ahocoder_f0_rmse_hz"] = ahof0["f0_rmse_hz"]
                row["ahocoder_vuv_error_rate"] = ahof0["vuv_error_rate"]
        rows.append(row)
        # strict JSON: json.dumps would emit a bare NaN literal (e.g.
        # f0_rmse_hz with no both-voiced frames) — map non-finite to null
        print(json.dumps({
            k: (None if isinstance(v, float) and not np.isfinite(v) else v)
            for k, v in row.items()}))

    if not rows:
        print("no scorable pairs", file=sys.stderr)
        return 1
    agg = {"aggregate": True, "n_pairs": len(rows)}
    for key in ("mcd_db", "f0_rmse_hz", "vuv_error_rate",
                "ahocoder_f0_rmse_hz", "ahocoder_vuv_error_rate"):
        vals = [r[key] for r in rows
                if key in r and np.isfinite(r[key])]
        if vals:
            agg[key] = float(np.mean(vals))
    print(json.dumps(agg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
