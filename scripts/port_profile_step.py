#!/usr/bin/env python3
"""Where the time of one train step goes, in the PyTorch/CUDA port.

    python3 scripts/port_profile_step.py [--batch 128] [--steps 5]
        [--gru-impl pallas] [--dtype bf16|f32] [--eval]
        [--preset samplernn|samplernn_gan|bottleneck] [--qrnn]

Builds a preset's model (default the canonical `samplernn`) at full width
from a seeded init, takes train steps on one fixed batch (as chip_smoke.py's
train phase makes it) and reports: host wall per step and samples/s, then a
torch.profiler trace of `--steps` steps summed by device kernel name, and
the share of the traced wall the device was busy. `samplernn_gan` takes the
two-optimizer GAN step (training/gan.py) past its lambda ramp, with the
preset's 512-channel discriminator; --qrnn gives the tiers fo-pool QRNN cells.
`--dtype f32` takes the default float32 step (no mixed precision), and
`--eval` the evaluation step (`make_eval_step`, float32 as the Trainer's
validation runs it) in place of the train step. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--gru-impl", default="pallas",
                   choices=("pallas", "xla", "wavefront"))
    p.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    p.add_argument("--preset", default="samplernn",
                   choices=("samplernn", "samplernn_gan", "bottleneck"))
    p.add_argument("--qrnn", action="store_true")
    p.add_argument("--eval", action="store_true")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line, train_inputs
    from msnv_tpu_torch.config import preset
    from msnv_tpu_torch.models.discriminator import discriminator_init
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.gan import make_gan_train_step
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.step import make_eval_step, make_train_step

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    exp = preset(args.preset)
    cfg = dataclasses.replace(exp.model, gru_impl=args.gru_impl,
                              qrnn=args.qrnn)
    seq_len = exp.train.seq_len
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    optimizer = make_optimizer(exp.train)
    opt_state = optimizer.init(params)
    state = init_tier_state(cfg, args.batch, device=dev)
    data, target, cond, spk = train_inputs(cfg, args.batch, seq_len, dev)
    compute_dtype = torch.bfloat16 if args.dtype == "bf16" else None
    is_gan = cfg.variant == "gan" and not args.eval
    if args.eval and compute_dtype is not None:
        p.error("the evaluation step is float32: --eval needs --dtype f32")
    if args.eval:
        disc = disc_state = None
        eval_step = make_eval_step(cfg)
    elif is_gan:
        disc = discriminator_init(torch.Generator().manual_seed(1),
                                  cfg.spk_dim, exp.train.disc_channels,
                                  device=dev)
        disc_state = optimizer.init(disc)
        gan_step = make_gan_train_step(cfg, exp.train, optimizer, optimizer,
                                       compute_dtype=compute_dtype)
    else:
        disc = disc_state = None
        step = make_train_step(cfg, optimizer, compute_dtype=compute_dtype)

    def run(n, reset=False):
        nonlocal params, opt_state, state
        nonlocal disc, disc_state
        for _ in range(n):
            if args.eval:
                loss, state = eval_step(params, state, data, reset, target,
                                        cond, spk)
            elif is_gan:
                # past the lambda ramp: the reversal term is live
                (params, disc, opt_state, disc_state, state,
                 metrics) = gan_step(params, disc, opt_state, disc_state,
                                     state, 1e6, data, reset, target, cond,
                                     spk)
                loss = metrics["loss"]
            else:
                params, opt_state, state, loss = step(
                    params, opt_state, state, data, reset, target, cond,
                    spk)
        torch.cuda.synchronize()
        return float(loss)

    run(1, reset=True)
    run(2)                                               # warm up
    t0 = time.perf_counter()
    run(args.steps)
    wall = (time.perf_counter() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run(args.steps)
        traced = time.perf_counter() - t1
    rows = []
    for e in prof.key_averages():
        # device kernels only: an operator's row repeats the time of the
        # kernels it launched
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    n = args.steps
    what = (f"{args.preset}{' qrnn' if args.qrnn else ''}"
            f"{f' disc {exp.train.disc_channels}' if is_gan else ''}"
            f"{' eval step' if args.eval else ''}")
    print(f"{card_line()}: {what}, B={args.batch}, seq_len={seq_len}, "
          f"{args.dtype}, gru_impl={args.gru_impl}, {n} steps")
    print(f"wall per step {wall * 1e3:.3f} ms = "
          f"{args.batch * seq_len / wall:.0f} samples/s; traced wall per step "
          f"{traced / n * 1e3:.3f} ms, device busy {busy_us / 1e3 / n:.3f} ms "
          f"per step = {busy_us / 1e6 / traced:.1%} of it")
    for dev_us, key, count in rows[:24]:
        print(f"  {dev_us / 1e3 / n:9.4f} ms/step  {count // n:6d}x/step  "
              f"{key[:100]}")
    print(json.dumps({"model": what, "batch": args.batch,
                      "seq_len": seq_len,
                      "dtype": args.dtype, "gru_impl": args.gru_impl,
                      "wall_ms_per_step": wall * 1e3,
                      "samples_per_s": args.batch * seq_len / wall,
                      "device_busy_share": busy_us / 1e6 / traced,
                      "top": [{"name": k[:100], "ms_per_step": d / 1e3 / n,
                               "count_per_step": c // n}
                              for d, k, c in rows[:24]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
