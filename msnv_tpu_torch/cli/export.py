"""msnv-export-torch: build a serving artifact from a checkpoint.

Traces the generation programs of a set of (lanes, frames) buckets, and
optionally 1-lane streaming pushes, into one file (msnv_tpu_torch/
export.py), which `msnv-serve-torch --artifact` serves. The checkpoint is
the JAX trainer's `.npz`; the model architecture is re-hydrated from the
experiment tag in its path (ref generate.py:126-129).

Usage:
  python -m msnv_tpu_torch.cli.export \
      --model results/<tag>/checkpoints/best-ep...npz --out model.msnvt \
      --lanes 1,2,4 --seconds 8 [--engine pallas] [--bf16] \
      [--temperature 0.7] [--spk_mix] [--stream 1,4] [--device cuda|cpu]

The flags of the JAX package's msnv-export, plus --device (default cuda;
raises without a card). The programs run on the device type they were
traced on: --platforms, if given, must name it.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True,
                   help="checkpoint under results/<tag>/checkpoints/")
    p.add_argument("--out", required=True, help="artifact file to write")
    p.add_argument("--lanes", default="1",
                   help="comma list of lane (batch) bucket sizes")
    p.add_argument("--seconds", type=float, default=None,
                   help="audio seconds per bucket (rounded up to whole "
                        "conditioner frames)")
    p.add_argument("--frames", type=int, default=None,
                   help="conditioner frames per bucket (alternative to "
                        "--seconds)")
    p.add_argument("--frame_bucket", type=int, default=16,
                   help="round frame counts up to this multiple — MUST "
                        "match the server's frame_bucket or its padded "
                        "requests never hit a bucket (msnv-serve-torch "
                        "default 16); 1 disables rounding for direct .call "
                        "users")
    p.add_argument("--engine", default="xla", choices=["xla", "pallas"],
                   help="pallas: the bottom tier's windows in the "
                        "sample-window kernel; xla: the per-sample path")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute inside the programs")
    p.add_argument("--spk_mix", action="store_true",
                   help="float speaker-mixing arguments (eigen-voice) "
                        "instead of int32 speaker ids")
    p.add_argument("--stream", default=None,
                   help="comma list of frames_per_push values to export "
                        "as 1-lane streaming init+push programs (e.g. "
                        "'1,4'); include both the server's frames_per_push "
                        "and 1 (trailing frames)")
    p.add_argument("--platforms", default=None,
                   help="the device type the programs are traced for; "
                        "must be --device's (default: it)")
    p.add_argument("--device", default="cuda",
                   help="torch device the programs are traced for and run "
                        "on; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    import torch

    from msnv_tpu_torch.config import parse_tag, tag_from_checkpoint_path
    from msnv_tpu_torch.device import resolve_device
    from msnv_tpu_torch.export import save_artifact
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.training.checkpoint import load_any

    if (args.seconds is None) == (args.frames is None):
        p.error("exactly one of --seconds / --frames is required")
    if args.frame_bucket < 1:
        raise SystemExit(f"--frame_bucket must be >= 1 (1 disables "
                         f"rounding), got {args.frame_bucket}")
    device = resolve_device(args.device)
    platforms = args.platforms.split(",") if args.platforms else None
    if platforms and platforms != [device.type]:
        raise SystemExit(f"--platforms {args.platforms}: the programs are "
                         f"traced for --device's type ({device.type})")
    tag = tag_from_checkpoint_path(args.model)
    cfg = parse_tag(tag)
    m = cfg.model
    if args.frames is not None:
        n_frames = args.frames
    else:
        n_frames = -(-int(args.seconds * 16000) // m.lookback)
    n_frames = -(-n_frames // args.frame_bucket) * args.frame_bucket
    lanes = [int(x) for x in args.lanes.split(",") if x]
    for b in lanes:
        if b & (b - 1):
            print(f"warning: lanes={b} is not a power of two — "
                  f"msnv-serve-torch pads live batches to powers of two "
                  f"and will never dispatch to this bucket (direct "
                  f"GenerationArtifact.call users are unaffected)",
                  file=sys.stderr)

    state, _ = load_any(args.model, {"params": init_params(m, device="meta")},
                        device=device)
    params = state["params"]
    stream_buckets = None
    if args.stream:
        stream_buckets = [(1, int(k)) for k in args.stream.split(",") if k]

    manifest = save_artifact(
        args.out, cfg, [(b, n_frames) for b in lanes],
        temperature=args.temperature,
        use_kernel=args.engine == "pallas",
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        spk_mix=args.spk_mix, platforms=platforms, params=params,
        stream_buckets=stream_buckets)
    print(json.dumps({"artifact": args.out,
                      "bytes": os.path.getsize(args.out),
                      "tag": manifest["tag"],
                      "engine": manifest["engine"],
                      "platforms": manifest["platforms"],
                      "buckets": manifest["buckets"],
                      "streams": manifest["streams"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
