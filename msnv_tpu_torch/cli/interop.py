"""Checkpoint interop CLI (`msnv-interop-torch`): bring the original
repository's PyTorch checkpoints to the port's `.npz` format and take ours
back (msnv_tpu_torch/interop.py has the layout mapping).

The port's counterpart of the JAX package's msnv-interop: the same modes,
flags and files, plus --device (default cuda) for the params in between.

Usage:
  # original checkpoint -> .npz (then msnv-generate-torch / -serve-torch)
  python -m msnv_tpu_torch.cli.interop import \
      --torch_ckpt results/<tag>/checkpoints/best-ep334-it632930 \
      [--tag <tag>] [--out <path.npz>] [--device cpu]

  # .npz -> the original repository's state_dict file
  python -m msnv_tpu_torch.cli.interop export \
      --model results/<tag>/checkpoints/ep10-it820.npz \
      [--tag <tag>] [--out <path.pt>] [--device cpu]

The model config comes from the experiment tag, read from the checkpoint's
results/<tag>/checkpoints/ parent (the original's own config store, ref
train.py:72-107 / generate.py:126-129) unless --tag overrides.
"""

from __future__ import annotations

import argparse
import os
import sys


def _tag_from_path(path: str, override: str | None) -> str:
    if override:
        return override
    from msnv_tpu_torch.config import tag_from_checkpoint_path
    return tag_from_checkpoint_path(path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["import", "export"])
    p.add_argument("--torch_ckpt", help="original checkpoint (import)")
    p.add_argument("--model",
                   help=".npz, .dcp or .orbax checkpoint (export)")
    p.add_argument("--tag", default=None,
                   help="experiment tag (default: from the checkpoint's "
                        "results/<tag>/checkpoints/ path)")
    p.add_argument("--out", default=None)
    p.add_argument("--unsafe_load", action="store_true",
                   help="allow full-pickle torch.load for pre-weights_only "
                        "checkpoints (runs arbitrary code from the file — "
                        "only for checkpoints you trust)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the params between the two files")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from msnv_tpu_torch.config import parse_tag
    from msnv_tpu_torch.device import resolve_device
    from msnv_tpu_torch.interop import (params_from_reference_state_dict,
                                        reference_state_dict_from_params)
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.training.checkpoint import load_any, save_checkpoint

    device = resolve_device(args.device)
    if args.mode == "import":
        if not args.torch_ckpt:
            p.error("import needs --torch_ckpt")
        # pre-weights_only-era files (e.g. torch 0.4 saves) need the full
        # unpickler; the flag is explicit consent
        sd = torch.load(args.torch_ckpt, map_location="cpu",
                        weights_only=not args.unsafe_load)
        tag = _tag_from_path(args.torch_ckpt, args.tag)
        cfg = parse_tag(tag)
        params = params_from_reference_state_dict(sd, cfg.model,
                                                  device=device)
        out = args.out or args.torch_ckpt + ".npz"
        save_checkpoint(out, {"params": params},
                        meta={"tag": tag,
                              "imported_from": os.path.abspath(
                                  args.torch_ckpt)})
        print(f"imported {len(sd)} reference tensors -> {out} (tag {tag})")
    else:
        if not args.model:
            p.error("export needs --model")
        tag = _tag_from_path(args.model, args.tag)
        cfg = parse_tag(tag)
        state, _ = load_any(
            args.model, {"params": init_params(cfg.model, device="meta")},
            device=device)
        params = state["params"]
        sd = reference_state_dict_from_params(params, cfg.model)
        out = args.out or os.path.splitext(
            os.path.normpath(args.model))[0] + ".pt"
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in sd.items()}, out)
        print(f"exported {len(sd)} tensors -> {out} (reference "
              f"state_dict, tag {tag})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
