#!/usr/bin/env python3
"""Where the time of one streaming push goes, in the PyTorch/CUDA port.

    python3 scripts/port_profile_push.py [--batch 1] [--pushes 8]

Builds the canonical `samplernn` at full width from a seeded init, makes
the /stream push (bf16 weights + the sample-window kernel, one frame per
push) and times `--pushes` pushes: host wall per push, then a
torch.profiler trace of the same pushes summed by device kernel name, and
the share of the wall the device was busy. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--pushes", type=int, default=8)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from msnv_tpu_torch.config import preset
    from msnv_tpu_torch.models.generate import streaming_fn
    from msnv_tpu_torch.models.samplernn import init_params

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cfg = preset("samplernn").model
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    init_state, push = streaming_fn(params, cfg,
                                    compute_dtype=torch.bfloat16,
                                    use_kernel=True)
    g = torch.Generator(device=dev).manual_seed(0)
    cond = torch.rand(args.batch, args.pushes, cfg.effective_cond_dim,
                      generator=g, device=dev)
    spk = torch.zeros(args.batch, dtype=torch.int64, device=dev)
    carry = init_state(args.batch, spk, g)
    for j in range(2):                                   # warm up
        carry, _, _ = push(carry, cond[:, j])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for j in range(args.pushes):
        carry, _, _ = push(carry, cond[:, j])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.pushes

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for j in range(args.pushes):
            carry, _, _ = push(carry, cond[:, j])
        torch.cuda.synchronize()
        traced = time.perf_counter() - t1
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        # device kernels only: an aten:: operator row repeats the time of
        # the kernels it launched
        if dev_us > 0 and not e.key.startswith("aten::"):
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    audio_s = cfg.lookback / 16000
    print(f"{torch.cuda.get_device_name(0)}: B={args.batch}, "
          f"{args.pushes} pushes of one frame ({audio_s * 1e3:.0f} ms audio)")
    print(f"wall per push {wall * 1e3:.3f} ms (realtime x"
          f"{audio_s / wall:.2f}); traced wall {traced * 1e3:.3f} ms, device "
          f"busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e6 / traced:.1%} of it")
    for dev_us, key, count in rows[:10]:
        print(f"  {dev_us / 1e3 / args.pushes:9.4f} ms/push  {count:6d}x  "
              f"{key[:90]}")
    print(json.dumps({"batch": args.batch, "pushes": args.pushes,
                      "wall_ms_per_push": wall * 1e3,
                      "device_busy_share": busy_us / 1e6 / traced,
                      "top": [{"name": k[:90], "ms_per_push":
                               d / 1e3 / args.pushes, "count": c}
                              for d, k, c in rows[:10]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
