"""The bf16 train step data-parallel over a mesh of `ranks` processes, one a
card, as `torchrun --nproc_per_node <ranks> -m msnv_tpu_torch.cli.train
--bf16 true` runs it: `make_mesh(ranks)` (every rank on 'data'), the params
replicated from rank 0 (`broadcast_tree`), `make_train_step_indexed(mesh=,
compute_dtype=bfloat16)` with its one gradient all-reduce a step, the GRU
sweeps in the fused kernels, NCCL between cards (gloo on the CPU).

This process is rank 0; it starts ranks 1 to ranks - 1 as processes that
run this file, and they meet through a TCP store on localhost whose port
the operating system picks. Every rank makes the same corpus from --seed
(`chunks` chunks of `batch` rows, `batch` the global batch) and keeps its
lanes of it (`corpus_sharding`); the steps walk the chunks in order,
carrying the TBPTT state.

Set-up takes the first `checked_steps` steps; their time on rank 0 fixes
the window's step count (--seconds over a step), which rank 0 broadcasts
with the window's start: no host collective runs per step. The window is
that many steps on every rank, from a barrier to a barrier behind the last
step synchronized on every rank; train_samples_per_s is batch x seq_len x
steps over rank 0's wall time of it. With --trace 1, `traced_steps` more
steps follow on every rank, rank 0's under the profiler.

The check holds rank 0 to the plain reference over all `batch` lanes, in
blocks of `check_block` (reference/samplernn_blocks.py): each checked
step's global loss, rank 0's all-reduced first gradient as the optimizer
got it, and each leaf's change over the checked steps, as the train
driver compares them (drivers/train.py); and `replica_gap`, the largest
difference of any parameter between rank 0 and any other rank, after the
checked steps and again after the window's steps.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path

import torch

if __name__ == "__main__":            # a rank above 0: the repository's root
    sys.path[0] = str(Path(__file__).resolve().parents[2])

import torch.distributed as dist  # noqa: E402

from h100_bench import harness, inputs, stats, trace  # noqa: E402
from h100_bench.drivers.train import B1, _flat, _norms, compare  # noqa: E402
from h100_bench.reference import samplernn_blocks  # noqa: E402
from msnv_tpu_torch.parallel.mesh import (  # noqa: E402
    barrier, broadcast_int64, broadcast_tree, corpus_sharding, make_mesh)

RUN, FINISH = 1, 2
TIMEOUT_S = 600


def _device(ctx_device: torch.device, rank: int) -> torch.device:
    return (torch.device("cuda", rank) if ctx_device.type == "cuda"
            else ctx_device)


class Rank:
    """One rank's process group, mesh, weights, corpus and step."""

    def __init__(self, ctx: harness.Context, rank: int, store):
        from msnv_tpu_torch.config import TrainConfig
        from msnv_tpu_torch.models.samplernn import (init_params,
                                                     init_tier_state)
        from msnv_tpu_torch.training.optim import make_optimizer
        from msnv_tpu_torch.training.step import make_train_step_indexed

        self.ctx, self.rank = ctx, rank
        tr, m, t = ctx.traffic, ctx.model, ctx.train
        self.world = tr["ranks"]
        dev = self.device = _device(ctx.device, rank)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=self.world,
                                timeout=timedelta(seconds=TIMEOUT_S))
        self.mesh = make_mesh(self.world, device=dev)
        self.cfg = harness.model_config(m)
        self.batch, self.seq_len = tr["batch"], t["seq_len"]
        self.lanes = self.batch // self.world
        lookback = self.cfg.lookback
        self.cond_in_seq = self.seq_len // lookback
        self.n_chunks = tr["chunks"]
        self.params = inputs.fill_tree(
            init_params(self.cfg, device="meta"),
            inputs.generator(dev, ctx.seed, "weights"), dev)
        broadcast_tree(self.params)
        self.params0 = (inputs.clone_tree(self.params, "cpu") if rank == 0
                        else None)
        corpus = self._corpus()
        n = tr["checked_steps"]
        self.checked_chunks = ([self.chunk(corpus, k) for k in range(n)]
                               if rank == 0 else None)
        local = corpus_sharding(self.mesh)
        self.corpus = {k: local[k].local(v).clone() for k, v in
                       corpus.items()}
        del corpus
        tcfg = TrainConfig(seq_len=self.seq_len, batch_size=self.batch,
                           learning_rate=t["learning_rate"],
                           scheduler=t["scheduler"],
                           grad_clip=t["grad_clip"])
        opt = make_optimizer(tcfg, steps_per_epoch=self.n_chunks)
        self.opt_state = opt.init(self.params)
        self.step_fn = make_train_step_indexed(
            self.cfg, opt, self.seq_len, lookback, self.cond_in_seq,
            compute_dtype=torch.bfloat16, mesh=self.mesh)
        self.state = init_tier_state(self.cfg, self.lanes, device=dev)
        self.i = 0
        self.seen = self._checked_steps(n)
        self.replica_gap = self.replicas_apart()

    def _corpus(self):
        """The global batch's corpus, as drivers/train.py makes it."""
        ctx, m = self.ctx, self.ctx.model
        g = inputs.generator(self.device, ctx.seed, "corpus")
        n = self.n_chunks * self.seq_len + self.cfg.lookback
        frames = self.n_chunks * self.cond_in_seq + 2
        c = m["cond_dim"] * (2 if m["look_ahead"] else 1)
        return {"qdata": inputs.audio_levels(g, self.batch, n,
                                             m["q_levels"], self.device),
                "cond": inputs.conditioners(g, (self.batch, frames, c),
                                            self.device),
                "spk": inputs.speakers(g, self.n_chunks * self.batch,
                                       m["spk_dim"], self.device)
                .view(self.n_chunks, self.batch).to(torch.int32)}

    def chunk(self, c, k):
        """(inp, reset, target, cond, spk) of chunk k of corpus c, as the
        indexed step slices it, copied."""
        L, lb, f = self.seq_len, self.cfg.lookback, self.cond_in_seq
        s = k * L
        return (c["qdata"][:, s:s + L + lb - 1].clone(), k == 0,
                c["qdata"][:, s + lb:s + lb + L].clone(),
                c["cond"][:, k * f + 1:(k + 1) * f + 1].clone(),
                c["spk"][k].clone())

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        k = self.i % self.n_chunks
        self.params, self.opt_state, self.state, loss = self.step_fn(
            self.params, self.opt_state, self.state, self.corpus, k)
        self.i += 1
        return loss

    def steps(self, n):
        for _ in range(n):
            self.step()

    def _checked_steps(self, n):
        """The first n steps; rank 0 keeps what the check compares, and the
        time of the steps after the first (a step's time at set-up)."""
        seen = {"loss": []}
        t1 = None
        for i in range(n):
            if i == 1:
                self.sync()
                t1 = time.perf_counter()
            loss = self.step()
            if self.rank == 0:
                seen["loss"].append(float(loss))
            if i == 0 and self.rank == 0:
                seen["grad_leaves"] = [(mu / (1.0 - B1)).cpu()
                                       for mu in _flat(self.opt_state["mu"])]
                seen["grad"] = _norms(seen["grad_leaves"])
        self.sync()
        self.step_s = ((time.perf_counter() - t1) / (n - 1) if n > 1
                       else None)
        if self.rank == 0:
            dev = self.device
            seen["change"] = _norms([p - p0.to(dev) for p, p0 in zip(
                _flat(self.params), _flat(self.params0))])
        return seen

    def replicas_apart(self) -> float:
        """The largest difference of any parameter between rank 0 and this
        rank, the largest over the ranks on every rank."""
        with torch.no_grad():
            mine = torch.cat([p.reshape(-1) for p in _flat(self.params)])
            first = mine.clone()
            dist.broadcast(first, src=0)
            gap = (mine - first).abs().max().reshape(1).double()
            dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        return float(gap)

    def command(self, cmd=(0, 0, 0)):
        """Rank 0's command (op, steps, traced steps) on every rank."""
        return [broadcast_int64(v) for v in cmd]

    def run(self, steps):
        """The window's steps between two barriers -> rank 0's wall s."""
        barrier()
        t0 = time.perf_counter()
        self.steps(steps)
        self.sync()
        barrier()
        return time.perf_counter() - t0

    def follow(self):
        """A rank above 0: rank 0's commands until FINISH."""
        while True:
            op, steps, traced = self.command()
            if op == RUN:
                self.run(steps)
                self.steps(traced)
                self.sync()
            elif op == FINISH:
                self.replicas_apart()
                return

    def close(self):
        self.step_fn = self.params = self.opt_state = None
        self.state = self.corpus = None
        if dist.is_initialized():
            dist.destroy_process_group()


def _watch(procs, done: threading.Event):
    """Rank 0: end this process when another rank failed (its collectives
    would wait for it until their timeout)."""
    while not done.wait(0.5):
        for r, p in enumerate(procs, 1):
            code = p.poll()
            if code not in (None, 0):
                print(f"rank {r} exited with {code}", file=sys.stderr,
                      flush=True)
                os._exit(3)


def _child_env():
    """The environment of a rank above 0: where this process found the
    benchmark and the port, ahead of the path it had."""
    import msnv_tpu_torch
    roots = [str(Path(harness.__file__).resolve().parents[1]),
             str(Path(msnv_tpu_torch.__file__).resolve().parents[1])]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        roots + [p for p in [env.get("PYTHONPATH")] if p])
    return env


class Driver:
    def __init__(self, ctx: harness.Context):
        from msnv_tpu_torch.device import float32_convolutions
        from msnv_tpu_torch.kernels import gru_layer

        self.ctx, self.gru_layer = ctx, gru_layer
        tr = ctx.traffic
        float32_convolutions()         # as the train CLI sets it
        world = tr["ranks"]
        if ctx.device.type == "cuda" and torch.cuda.device_count() < world:
            raise harness.BenchError(
                f"{world} ranks need {world} CUDA devices, "
                f"{torch.cuda.device_count()} found")
        if ctx.device.type == "cuda":
            torch.cuda.set_device(_device(ctx.device, 0))
        store = dist.TCPStore("localhost", 0, world, is_master=True,
                              timeout=timedelta(seconds=TIMEOUT_S),
                              wait_for_workers=False)
        spec = json.dumps({"cell": ctx.cell, "config": ctx.config,
                           "traffic": tr, "seed": ctx.seed,
                           "device": ctx.device.type,
                           "seconds": ctx.seconds, "port": store.port})
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(r), spec],
            env=_child_env()) for r in range(1, world)]
        self._done = threading.Event()
        threading.Thread(target=_watch, args=(self.procs, self._done),
                         daemon=True).start()
        self.r = Rank(ctx, 0, store)
        self.store = store
        self.seen = self.r.seen
        self.replica_gap = self.r.replica_gap
        step_s = self.r.step_s or 1.0
        self.window_steps = max(1, math.ceil(ctx.seconds / step_s))
        self._truth = None

    def _counters(self):
        f, b = self.gru_layer.gru_layer_forward, \
            self.gru_layer.gru_layer_backward
        return f.launches + b.launches

    def window(self, seconds, trace_on):
        r, tr = self.r, self.ctx.traffic
        n = self.window_steps
        traced = tr["traced_steps"] if trace_on else 0
        r.command((RUN, n, traced))
        wall = r.run(n)
        samples = self.r.batch * r.seq_len * n
        raw = {"steps": n, "wall_s": wall, "batch": r.batch,
               "seq_len": r.seq_len, "dtype": "bfloat16", "gan": False,
               "ranks": r.world}
        summary = None
        if traced:
            c0 = self._counters()

            def run():
                r.steps(traced)

            _, summary = trace.traced(run, r.device)
            raw["traced_sweeps"] = self._counters() - c0
        return harness.Window(
            {"train_samples_per_s": stats.rate(samples, wall)}, n, 0, raw,
            summary)

    def finish(self):
        r = self.r
        r.command((FINISH, 0, 0))
        self.replica_gap = max(self.replica_gap, r.replicas_apart())
        self.params0, self.chunks = r.params0, r.checked_chunks
        r.close()
        codes = [p.wait(timeout=TIMEOUT_S) for p in self.procs]
        self._done.set()
        if any(codes):
            raise harness.BenchError(f"ranks above 0 exited with {codes}")

    def reference(self, prec="f32", rows=None):
        """The plain reference's readings of the checked steps over the
        global batch (its first `rows` rows), in `prec`, in blocks."""
        dev = self.ctx.device
        chunks = [tuple(x.to(dev) if torch.is_tensor(x) else x for x in c)
                  for c in self.chunks]
        if rows is not None:
            chunks = [(c[0][:rows], c[1], c[2][:rows], c[3][:rows],
                       c[4][:rows]) for c in chunks]
        return samplernn_blocks.train_steps(
            self.ctx.model, self.ctx.train,
            inputs.clone_tree(self.params0, dev), chunks,
            self.ctx.traffic["check_block"], prec)

    def check(self, control=None) -> dict:
        """The numbers compared; with `control` the reference stands in the
        program's place: "fp8" its precision, "half" its float32 steps on
        half of the global batch."""
        if self._truth is None:
            self._truth = self.reference()
        if control is None:
            seen, gap = self.seen, self.replica_gap
        elif control == "half":
            seen, gap = self.reference(rows=self.r.batch // 2), 0.0
        else:
            seen, gap = self.reference(control), 0.0
        out = compare(seen, self._truth, False)
        out["replica_gap"] = gap
        return out


def _watch_parent():
    """A rank above 0 ends when the process that started it has gone."""
    parent = os.getppid()
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(3)


def main(argv) -> int:
    rank, spec = int(argv[0]), json.loads(argv[1])
    threading.Thread(target=_watch_parent, daemon=True).start()
    device = torch.device(spec["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    ctx = harness.Context(spec["cell"], spec["config"], spec["traffic"],
                          spec["seed"], device, spec["seconds"])
    store = dist.TCPStore("localhost", spec["port"], spec["traffic"]["ranks"],
                          is_master=False,
                          timeout=timedelta(seconds=TIMEOUT_S))
    from msnv_tpu_torch.device import float32_convolutions
    float32_convolutions()
    r = Rank(ctx, rank, store)
    r.follow()
    r.close()
    found = harness.banned_modules()
    if found:
        print(f"rank {rank} loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
