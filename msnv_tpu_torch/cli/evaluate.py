"""Offline evaluation CLI (`msnv-evaluate-torch`): NLL-bits of a checkpoint
over corpus partitions, in the port.

The reference only evaluates inside training (ValidationPlugin,
ref trainer/plugins.py:26-92); this standalone scorer re-hydrates the model
from the checkpoint's experiment tag and streams any partition. The same
arguments and the same JSON line as the JAX package's msnv-evaluate, plus
--device (default cuda). float32 params; the tiers' GRU sweeps run in the
fused GRU-layer kernels on a CUDA device and as the plain loop on the CPU.

Usage:
  python -m msnv_tpu_torch.cli.evaluate \
      --model results/<tag>/checkpoints/ep...npz \
      --datasets_path <dir> [--partitions validation test] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main(argv=None):
    import torch

    from msnv_tpu_torch.cli.train import resolve_gru_impl
    from msnv_tpu_torch.config import parse_tag, tag_from_checkpoint_path
    from msnv_tpu_torch.data.corpus import CorpusConfig, build_corpus
    from msnv_tpu_torch.data.loader import ChunkLoader
    from msnv_tpu_torch.device import float32_convolutions, resolve_device
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.checkpoint import load_any
    from msnv_tpu_torch.training.step import eval_device_corpus, make_eval_step
    from msnv_tpu_torch.training.trainer import Trainer

    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--datasets_path", required=True)
    p.add_argument("--dataset", default="wav/")
    p.add_argument("--cond_set", default="cond/")
    p.add_argument("--partitions", nargs="+",
                   default=["validation", "test"])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    float32_convolutions()

    tag = tag_from_checkpoint_path(args.model)
    cfg = parse_tag(tag)
    m = dataclasses.replace(
        cfg.model, gru_impl=resolve_gru_impl("auto", device))
    print("config from tag:", tag)

    state, _ = load_any(
        args.model, {"params": init_params(m, device="meta")}, device=device)
    params = state["params"]

    ccfg = CorpusConfig(
        datasets_path=args.datasets_path,
        wav_path=os.path.join(args.datasets_path, args.dataset),
        cond_path=os.path.join(args.datasets_path, args.cond_set),
        overlap_len=m.lookback, q_levels=m.q_levels, ulaw=m.ulaw,
        seq_len=cfg.train.seq_len, batch_size=cfg.train.batch_size,
        cond_dim=m.cond_dim, cond_len=m.cond_len,
        norm_ind=cfg.data.norm_ind, look_ahead=m.look_ahead,
        cache_dir=os.path.join(args.datasets_path, "npy_datasets"))

    eval_step = make_eval_step(m)
    out = {}
    for part in args.partitions:
        corpus = build_corpus(ccfg, part)
        loader = ChunkLoader(corpus, cfg.train.seq_len, m.lookback,
                             m.cond_len, m.q_levels, m.ulaw)
        state_h = init_tier_state(m, loader._qdata.shape[0], device=device)
        if loader.device_bytes() <= Trainer.DEVICE_CORPUS_MAX_BYTES:
            # device-resident corpus, blocks of 16 chunks with one loss
            # fetch each; released before the next partition uploads
            nll, state_h = eval_device_corpus(m, params, state_h, loader)
        else:
            total, n = 0.0, 0
            for chunk in loader.epoch():
                loss, state_h = eval_step(
                    params, state_h,
                    torch.from_numpy(chunk.data).to(device), chunk.reset,
                    torch.from_numpy(chunk.target).to(device),
                    torch.from_numpy(chunk.cond).to(device),
                    torch.from_numpy(chunk.spk).to(device))
                b = chunk.data.shape[0]
                total += float(loss) * b
                n += b
            nll = total / max(n, 1)
        out[part] = {"nll_bits": nll, "perplexity": 2.0 ** nll,
                     "chunks": len(loader)}
        print(f"{part}: NLL {nll:.4f} bits, perplexity {2.0**nll:.2f}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
