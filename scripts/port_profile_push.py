#!/usr/bin/env python3
"""Where the time of one streaming push goes, in the PyTorch/CUDA port.

    python3 scripts/port_profile_push.py [--batch 1] [--pushes 8]
        [--artifact]

Builds the canonical `samplernn` at full width from a seeded init, makes
the /stream push (bf16 weights + the sample-window kernel, one frame per
push) and times `--pushes` pushes: host wall per push, then a
torch.profiler trace of the same pushes summed by device kernel name, the
device kernels per push and the share of the wall the device was busy.
`--artifact` profiles the same push from a serving artifact instead
(export.py: exported for this batch, saved under the git-ignored
msnv_tpu_torch/build/ and loaded back). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _artifact_push(params, cfg, batch):
    """(init_state, push) of streaming_fn's form from an exported stream
    bucket of `batch` lanes and one frame a push."""
    import tempfile

    import torch

    from msnv_tpu_torch.export import load_artifact, save_artifact
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "msnv_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        path = os.path.join(work, "push.msnvt")
        save_artifact(path, cfg, [], params=params, use_kernel=True,
                      compute_dtype=torch.bfloat16,
                      stream_buckets=[(batch, 1)])
        art = load_artifact(path)
    a_init, a_push = art.streaming(1, lanes=batch)
    # the operators the push program calls, by kind
    program = art._streams[(batch, 1)][1]
    ops = Counter(str(n.target) for n in program.graph.nodes
                  if n.op == "call_function")
    print(f"push program: {sum(ops.values())} operator calls; most "
          f"frequent: {ops.most_common(8)}")
    return (lambda b, spk, g: a_init(params, spk, g),
            lambda carry, cond: a_push(params, carry, cond))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--pushes", type=int, default=8)
    p.add_argument("--artifact", action="store_true",
                   help="the push of a serving artifact")
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
    if args.artifact:
        init_state, push = _artifact_push(params, cfg, args.batch)
    else:
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
        # device kernels only: an operator's row (aten::, and the port's
        # msnv_torch:: operators) repeats the time of the kernels it
        # launched
        if dev_us > 0 and not e.key.startswith(("aten::", "msnv_torch::")):
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[2] for r in rows) / args.pushes
    audio_s = cfg.lookback / 16000
    print(f"{torch.cuda.get_device_name(0)}: B={args.batch}, "
          f"{args.pushes} pushes of one frame ({audio_s * 1e3:.0f} ms audio)"
          f"{' from an artifact' if args.artifact else ''}")
    print(f"wall per push {wall * 1e3:.3f} ms (realtime x"
          f"{audio_s / wall:.2f}); traced wall {traced * 1e3:.3f} ms, device "
          f"busy {busy_us / 1e3:.3f} ms = "
          f"{busy_us / 1e6 / traced:.1%} of it; {launches:.1f} device "
          f"kernels per push")
    for dev_us, key, count in rows[:10]:
        print(f"  {dev_us / 1e3 / args.pushes:9.4f} ms/push  {count:6d}x  "
              f"{key[:90]}")
    print(json.dumps({"batch": args.batch, "pushes": args.pushes,
                      "artifact": args.artifact,
                      "wall_ms_per_push": wall * 1e3,
                      "device_busy_share": busy_us / 1e6 / traced,
                      "device_ms_per_push": busy_us / 1e3 / args.pushes,
                      "kernels_per_push": launches,
                      "top": [{"name": k[:90], "ms_per_push":
                               d / 1e3 / args.pushes, "count": c}
                              for d, k, c in rows[:10]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
