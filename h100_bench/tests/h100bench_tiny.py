"""A tiny benchmark tree for CPU tests: a copy of h100_bench with small
configurations, traffic and limits files and a BENCHMARK.json that names
tiny cells beside the real ones. The tiny cells run through the same
harness, drivers, readers and references as the real ones."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 77

TRAFFIC = {
    "tiny.gen": {"driver": "generate", "batch": 4, "frames": 6,
                 "compute_dtype": "bfloat16", "temperature": 1.0,
                 "warm_frames": 1, "check_lanes_per_call": 4},
    "tiny.gen.f32": {"driver": "generate", "batch": 4, "frames": 6,
                     "compute_dtype": "float32", "temperature": 1.0,
                     "warm_frames": 1, "check_lanes_per_call": 4},
    "tiny.stream": {"driver": "stream", "lanes": 8, "frames_per_push": 2,
                    "temperature": 1.0, "rate": 6.0, "median_s": 0.008,
                    "sigma": 0.5, "min_s": 0.004, "max_s": 0.02,
                    "check_streams": 4, "drain_s": 30.0, "trace_s": 0.5},
    "tiny.train.bf16": {"driver": "train", "batch": 4, "chunks": 3,
                        "compute_dtype": "bfloat16", "checked_steps": 3,
                        "traced_steps": 2},
    "tiny.train.f32": {"driver": "train", "batch": 4, "chunks": 3,
                       "compute_dtype": "float32", "checked_steps": 3,
                       "traced_steps": 2},
}

# the tiny GAN configuration's own limits: at width 32 and 8 channels its
# bf16 readings sit higher than the full-width cell's (on two seeds
# grad_diff 0.08, disc_grad_diff 0.10, disc_grad_diff_med 0.078,
# disc_update_gap 0.014; fp8 reads disc_grad_diff_med 0.41); the other
# tiny cells take their real cell's limits
TINY_LIMITS = {
    "tiny_gan.train": {"grad_gap": 0.15, "grad_diff": 0.3,
                       "update_gap": 0.12, "disc_grad_gap": 0.1,
                       "disc_grad_diff": 0.3, "disc_grad_diff_med": 0.2,
                       "disc_update_gap": 0.05, "lambda_gap": 0},
}

# cell -> (config, traffic, the real cell whose metrics it reports)
CELLS = {
    "tiny.gen": ("tiny", "tiny.gen", "samplernn.gen.b1024"),
    "tiny.gen.f32": ("tiny", "tiny.gen.f32", "samplernn.gen.b1024"),
    "tiny.stream": ("tiny", "tiny.stream", "samplernn.stream.mux128"),
    "tiny_gan.train": ("tiny_gan", "tiny.train.bf16",
                       "samplernn_gan.train.bf16.b64"),
    "tiny.train": ("tiny", "tiny.train.f32", "samplernn.train.f32.b128"),
}


def shrink(config: dict) -> dict:
    """The configuration at test size: the tiers (4, 4) at width 32."""
    config["model"].update(frame_sizes=[4, 4], dim=32, cond_dim=3,
                           cond_len=16, spk_dim=2, ind_cond_dim=6)
    config["train"].update(seq_len=64, disc_channels=8)
    return config


def build(dst: Path, limits: dict = None) -> Path:
    """The tree under dst (dst/BENCHMARK.json, dst/h100_bench/...). limits:
    cell -> {number: limit}; by default TINY_LIMITS, else the real cell's
    limits file."""
    shutil.copytree(REPO / "h100_bench", dst / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    root = dst / "h100_bench"
    for name, src in (("tiny", "samplernn"), ("tiny_gan", "samplernn_gan")):
        conf = shrink(json.loads(
            (root / "configs" / f"{src}.json").read_text()))
        (root / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"h100_bench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    for name, traffic in TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for name, (conf, traffic, real) in CELLS.items():
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
        lim = (TINY_LIMITS if limits is None else limits).get(name)
        if lim is None:
            lim = json.loads((root / "limits" / f"{real}.json").read_text())
        else:
            lim = {k: {"limit": v} for k, v in lim.items()}
        (root / "limits" / f"{name}.json").write_text(json.dumps(lim))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


def mux_on_window_path(monkeypatch):
    """On the CPU the multiplexer keeps the per-sample path; on the card it
    runs bf16 weights through the sample window. Route the CPU run through
    the window's plain version, as on the card."""
    import torch

    import msnv_tpu_torch.serving.mux as mux
    from msnv_tpu_torch.models.generate import streaming_fn

    def window_path(params, cfg, **kw):
        kw.update(use_kernel=True, compute_dtype=torch.bfloat16)
        return streaming_fn(params, cfg, **kw)

    monkeypatch.setattr(mux, "streaming_fn", window_path)
