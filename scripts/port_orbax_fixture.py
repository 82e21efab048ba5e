#!/usr/bin/env python
"""Write the orbax checkpoints that msnv_tpu_torch's tests and chip smoke
read: real orbax + tensorstore output for a reader that has neither.

JAX side; needs jax, orbax-checkpoint and tensorstore (CPU only). Run once:

  python scripts/port_orbax_fixture.py [--out tests/data/orbax]

Each fixture is written by msnv_tpu.training.checkpoint's
save_checkpoint_orbax, beside an .npz twin of the same state written by its
save_checkpoint; each msnv_meta.json holds what a reader needs to build
its template ("model", "train" or "leaves"):

  trainer.orbax   (a) a samplernn train state at dim 32 (frame sizes 4 4,
                  one GRU layer, 32 levels) with Adam and the LR scheduler,
                  from the JAX Trainer after one epoch of a seeded corpus
  sharded.orbax   (b) a (64, 32) float32 leaf and a (64, 32) bfloat16 leaf
                  over the 8-device CPU mesh P("data", "model"), an int32
                  scalar, a replicated float32 leaf
  twoproc.orbax   (c) the same kind of state saved by two processes
                  (jax.distributed on the CPU, 4 devices each, one mesh
                  over both, as scripts/multihost_sim.py runs them), so
                  each process writes its own shards into its own database

  python scripts/port_orbax_fixture.py --worker I --out DIR --port P
                  (internal: one process of (c))
"""

import argparse
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROC = 2
LOCAL_DEVICES = 4


def _jax(devices: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devices}")
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def _fresh(path):
    for p in (path, path[:-len(".orbax")] + ".npz"):
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.exists(p):
            os.remove(p)


def _mesh_state(jax, seed):
    """{w f32 (64, 32) P(data, model), wb bf16 (64, 32) P(data, model),
    lanes f32 (2, 8, 32) P(None, data), b f32 (32,) replicated, step
    int32 ()} from a numpy seed, over a (4, 2) mesh of all the devices;
    and the same values as host arrays."""
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    rng = np.random.RandomState(seed)
    host = {"w": rng.randn(64, 32).astype(np.float32),
            "wb": rng.randn(64, 32).astype(jnp.bfloat16),
            "lanes": rng.randn(2, 8, 32).astype(np.float32),
            "b": rng.randn(32).astype(np.float32),
            "step": np.asarray(seed * 1000 + 7, np.int32)}
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    specs = {"w": P("data", "model"), "wb": P("data", "model"),
             "lanes": P(None, "data"), "b": P(), "step": P()}
    state = {k: jax.make_array_from_callback(
        v.shape, NamedSharding(mesh, specs[k]), lambda i, v=v: v[i])
        for k, v in host.items()}
    return state, host


def _leaves_meta(host):
    return {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in host.items()}


def trainer_fixture(out):
    jax = _jax(8)
    import numpy as np
    from msnv_tpu.config import ExperimentConfig, ModelConfig, TrainConfig
    from msnv_tpu.data.corpus import Corpus
    from msnv_tpu.data.loader import ChunkLoader
    from msnv_tpu.models.samplernn import init_params
    from msnv_tpu.training.checkpoint import (save_checkpoint,
                                              save_checkpoint_orbax)
    from msnv_tpu.training.optim import make_optimizer
    from msnv_tpu.training.trainer import Trainer

    model = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=32, q_levels=32,
                        cond_dim=7, cond_len=16, spk_dim=2)
    train = TrainConfig(seq_len=32, batch_size=2, scheduler=True)
    rng = np.random.RandomState(0)
    chunks, lb = 3, model.lookback
    lane = chunks * train.seq_len + lb
    frames = lane // model.cond_len + 1
    corpus = Corpus(
        data=rng.uniform(-0.95, 0.95, (2, lane)),
        cond=rng.rand(2, frames, model.effective_cond_dim),
        spk=(np.arange(frames)[None] // 5 + np.arange(2)[:, None]) % 2,
        audio_id=np.zeros((2, frames), np.int64),
        min_cond=np.zeros(model.effective_cond_dim),
        max_cond=np.ones(model.effective_cond_dim),
        spk_ids=np.asarray(["71", "72"]))
    loader = ChunkLoader(corpus, train.seq_len, lb, model.cond_len,
                         model.q_levels, model.ulaw)
    exp = ExperimentConfig(exp="fixture", model=model, train=train)
    trainer = Trainer(exp, init_params(jax.random.PRNGKey(0), model),
                      make_optimizer(train, steps_per_epoch=len(loader)),
                      loader, device_corpus=False)
    trainer.train_epoch()
    state = trainer.checkpoint_state()
    meta = {"epoch": 1, "iteration": trainer.iterations, "tag": trainer.tag,
            "model": dataclasses.asdict(model),
            "train": dataclasses.asdict(train)}
    path = os.path.join(out, "trainer.orbax")
    _fresh(path)
    save_checkpoint_orbax(path, state, meta)
    save_checkpoint(os.path.join(out, "trainer.npz"), state, meta)


def sharded_fixture(out):
    jax = _jax(8)
    from msnv_tpu.training.checkpoint import (save_checkpoint,
                                              save_checkpoint_orbax)
    state, host = _mesh_state(jax, seed=1)
    meta = {"leaves": _leaves_meta(host), "devices": 8, "processes": 1}
    path = os.path.join(out, "sharded.orbax")
    _fresh(path)
    save_checkpoint_orbax(path, state, meta)
    save_checkpoint(os.path.join(out, "sharded.npz"), host, meta)


def worker(process_id, out, port):
    jax = _jax(LOCAL_DEVICES)
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=N_PROC, process_id=process_id)
    from msnv_tpu.training.checkpoint import (save_checkpoint,
                                              save_checkpoint_orbax)
    assert len(jax.devices()) == N_PROC * LOCAL_DEVICES, jax.devices()
    state, host = _mesh_state(jax, seed=2)
    meta = {"leaves": _leaves_meta(host), "devices": N_PROC * LOCAL_DEVICES,
            "processes": N_PROC}
    path = os.path.join(out, "twoproc.orbax")
    save_checkpoint_orbax(path, state, meta)   # every process, collectively
    if process_id == 0:
        save_checkpoint(os.path.join(out, "twoproc.npz"), host, meta)
    print(f"FIXTURE_OK process={process_id}", flush=True)


def twoproc_fixture(out):
    _fresh(os.path.join(out, "twoproc.orbax"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i),
         "--out", out, "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(N_PROC)]
    outputs = [p.communicate(timeout=600)[0] for p in procs]
    ok = sum("FIXTURE_OK" in o for o in outputs)
    assert ok == N_PROC, "\n".join(outputs)
    written = sorted(d for d in os.listdir(os.path.join(out, "twoproc.orbax"))
                     if d.startswith("ocdbt.process_"))
    assert written == ["ocdbt.process_0", "ocdbt.process_1"], written


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(REPO, "tests", "data",
                                                 "orbax"))
    p.add_argument("--worker", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--only", choices=["trainer", "sharded"],
                   help="(internal) write one single-process fixture")
    args = p.parse_args()
    if args.worker is not None:
        worker(args.worker, args.out, args.port)
        return
    if args.only is not None:
        {"trainer": trainer_fixture, "sharded": sharded_fixture}[args.only](
            args.out)
        return
    os.makedirs(args.out, exist_ok=True)
    # each fixture in a process of its own: JAX fixes the device count at
    # start
    for name in ("trainer", "sharded"):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--out", args.out, "--only", name], check=True)
    twoproc_fixture(args.out)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(args.out) for f in fs)
    print(f"fixtures in {args.out}: {total} bytes")
    print(json.dumps(sorted(os.listdir(args.out))))


if __name__ == "__main__":
    main()
