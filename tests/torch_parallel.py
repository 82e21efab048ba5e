"""Rank workers of tests/test_torch_parallel.py: gloo CPU ranks of the
port's multi-device paths (msnv_tpu_torch/parallel/).

This module imports torch, numpy and the port only, never JAX or the JAX
package, so the processes that `Ranks` spawns stay light. Each rank joins
a gloo process group through a FileStore in the test's temporary directory
(no TCP port: the suite runs in several workers at once), runs one job of
this module and pickles its result beside the store. A rank that fails or
hangs fails the call: its traceback is raised in the parent, and every
join has a deadline.

Inputs cross as numpy: model configs as dicts of their fields, params
under the checkpoint keys (interop.params_from_numpy), batches as arrays.
"""

import json
import os
import pickle
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Ranks:
    """job(rank, world, *args) started on `world` gloo CPU ranks; results()
    waits for them (the parent may work meanwhile)."""

    def __init__(self, job: str, world: int, tmp_dir: str, *args,
                 timeout: float = 300):
        self.job, self.world, self.tmp_dir = job, world, tmp_dir
        ctx = mp.get_context("spawn")
        store = os.path.join(tmp_dir, f"{job}.store")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(job, rank, world, store, tmp_dir,
                                        args))
                      for rank in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def results(self):
        """The per-rank results, in rank order; a rank that failed or did
        not finish in time raises (and no rank is left running)."""
        procs, job = self.procs, self.job
        for p in procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = []
        for rank, p in enumerate(procs):
            err = os.path.join(self.tmp_dir, f"{job}-{rank}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {rank}:\n{f.read()}")
            elif p.exitcode != 0 and rank not in hung:
                errors.append(f"rank {rank}: exit code {p.exitcode}")
        if hung:
            errors.append(f"ranks {hung} did not finish in {self.timeout} s")
        if errors:
            raise RuntimeError(f"job {job} failed:\n" + "\n".join(errors))
        out = []
        for rank in range(self.world):
            with open(os.path.join(self.tmp_dir, f"{job}-{rank}.pkl"),
                      "rb") as f:
                out.append(pickle.load(f))
        return out


    def outcomes(self):
        """(exit code, error text or None) of every rank, in rank order,
        once all have ended; a rank still running at the deadline is
        killed and reported with exit code None."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        out = []
        for rank, p in enumerate(self.procs):
            code = p.exitcode
            if p.is_alive():
                p.kill()
                p.join(10)
                code = None
            err = os.path.join(self.tmp_dir, f"{self.job}-{rank}.err")
            text = None
            if os.path.exists(err):
                with open(err) as f:
                    text = f.read()
            out.append((code, text))
        return out


def _rank_main(job, rank, world, store, tmp_dir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=240))
        result = globals()[job](rank, world, *args)
        with open(os.path.join(tmp_dir, f"{job}-{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(tmp_dir, f"{job}-{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- helpers ----------------------------------------------------------------

def _cfg(fields):
    from msnv_tpu_torch.config import ModelConfig
    return ModelConfig(**fields)


def _train_cfg(fields):
    from msnv_tpu_torch.config import TrainConfig
    return TrainConfig(**fields)


def _params(flat, cfg):
    from msnv_tpu_torch.interop import params_from_numpy
    return params_from_numpy(flat, cfg, device="cpu")


def _numpy(params):
    from msnv_tpu_torch.interop import params_to_numpy
    return params_to_numpy(params)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(arrays):
    return (_t(arrays["data"]), _t(arrays["target"]), _t(arrays["cond"]),
            _t(arrays["spk"]))


# -- the steps (train, eval, GAN, exposure) over meshes --------------------

def _task_train(mesh, spec):
    """Two train steps from the same weights on the global batch: losses,
    the full params (gathered) and this rank's storage."""
    from msnv_tpu_torch.models.samplernn import init_tier_state
    from msnv_tpu_torch.parallel.mesh import (batch_sharding,
                                              gather_params, shard_params,
                                              param_sharding)
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.step import make_train_step
    cfg = _cfg(spec["model"])
    full = _params(spec["params"], cfg)
    opt = make_optimizer(_train_cfg(spec["train"]))
    specs = param_sharding(mesh, full)
    step = make_train_step(cfg, opt, mesh=mesh, specs=specs)
    params = shard_params(mesh, full, specs)
    opt_state = opt.init(params)
    lanes = batch_sharding(mesh).local
    data, target, cond, spk = (lanes(x) for x in _batch(spec["batch"]))
    state = init_tier_state(cfg, data.shape[0], device="cpu")
    losses = []
    for k in range(spec.get("steps", 2)):
        params, opt_state, state, loss = step(
            params, opt_state, state, data, k == 0, target, cond, spk)
        losses.append(float(loss))
    return {"losses": losses,
            "params": _numpy(gather_params(mesh, params, specs)),
            "storage": _numpy(params),
            "mu_shapes": [tuple(x.shape) for x in
                          _leaves(opt_state["mu"])]}


def _leaves(tree):
    from msnv_tpu_torch.tree import tree_leaves
    return tree_leaves(tree)


def _task_eval(mesh, spec):
    """Two eval chunks (state threaded) from the given weights."""
    from msnv_tpu_torch.models.samplernn import init_tier_state
    from msnv_tpu_torch.parallel.mesh import (batch_sharding,
                                              param_sharding, shard_params)
    from msnv_tpu_torch.training.step import make_eval_step
    cfg = _cfg(spec["model"])
    full = _params(spec["params"], cfg)
    specs = param_sharding(mesh, full)
    step = make_eval_step(cfg, mesh=mesh, specs=specs)
    params = shard_params(mesh, full, specs)
    lanes = batch_sharding(mesh).local
    data, target, cond, spk = (lanes(x) for x in _batch(spec["batch"]))
    state = init_tier_state(cfg, data.shape[0], device="cpu")
    losses = []
    for k in range(2):
        loss, state = step(params, state, data, k == 0, target, cond, spk)
        losses.append(float(loss))
    return {"losses": losses}


def _task_gan(mesh, spec):
    """Two GAN steps: metrics, the full vocoder params, the
    discriminator."""
    from msnv_tpu_torch.interop import (disc_params_from_numpy,
                                        disc_params_to_numpy)
    from msnv_tpu_torch.models.samplernn import init_tier_state
    from msnv_tpu_torch.parallel.mesh import (batch_sharding, gather_params,
                                              param_sharding, shard_params)
    from msnv_tpu_torch.training.gan import make_gan_train_step
    from msnv_tpu_torch.training.optim import make_optimizer
    cfg = _cfg(spec["model"])
    tc = _train_cfg(spec["train"])
    full = _params(spec["params"], cfg)
    disc = disc_params_from_numpy(spec["disc"], cfg.spk_dim,
                                  spec["channels"], device="cpu")
    main_opt, disc_opt = make_optimizer(tc), make_optimizer(tc)
    specs = param_sharding(mesh, full)
    step = make_gan_train_step(cfg, tc, main_opt, disc_opt, mesh=mesh,
                               specs=specs)
    params = shard_params(mesh, full, specs)
    mo, do = main_opt.init(params), disc_opt.init(disc)
    lanes = batch_sharding(mesh).local
    data, target, cond, spk = (lanes(x) for x in _batch(spec["batch"]))
    state = init_tier_state(cfg, data.shape[0], device="cpu")
    metrics = []
    for k in range(2):
        params, disc, mo, do, state, m = step(
            params, disc, mo, do, state, float(k), data, k == 0, target,
            cond, spk)
        metrics.append([float(m[n]) for n in ("loss", "disc_loss",
                                              "lambda")])
    return {"metrics": metrics,
            "params": _numpy(gather_params(mesh, params, specs)),
            "disc": disc_params_to_numpy(disc)}


def _task_exposure(mesh, spec):
    """The exposure-bias step sharded and, on the same rank without a
    mesh, unsharded, from one generator seed; and the input noise alone,
    whose local lanes must equal the unsharded draw's."""
    from msnv_tpu_torch.models.samplernn import init_tier_state
    from msnv_tpu_torch.parallel.mesh import batch_sharding
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.step import (_perturb, exposure_tuple,
                                              make_train_step)
    cfg = _cfg(spec["model"])
    tc = _train_cfg(spec["train"])
    exposure = exposure_tuple(tc)
    lanes = batch_sharding(mesh).local
    batch = _batch(spec["batch"])
    out = {}
    for name, m, (data, target, cond, spk) in (
            ("sharded", mesh, [lanes(x) for x in batch]),
            ("single", None, batch)):
        params = _params(spec["params"], cfg)
        opt = make_optimizer(tc)
        step = make_train_step(cfg, opt, mesh=m, exposure=exposure)
        opt_state = opt.init(params)
        state = init_tier_state(cfg, data.shape[0], device="cpu")
        losses = []
        for k in range(2):
            g = torch.Generator().manual_seed(100 + k)
            params, opt_state, state, loss = step(
                params, opt_state, state, data, k == 0, target, cond, spk, g)
            losses.append(float(loss))
        out[name] = {"losses": losses, "params": _numpy(params)}
    params = _params(spec["params"], cfg)
    data, _, cond, spk = batch
    noise = (0.0, 0.3, 5)
    st = init_tier_state(cfg, data.shape[0], device="cpu")
    whole = _perturb(params, cfg, None, noise, st, data, True, cond, spk,
                     torch.Generator().manual_seed(7))
    st = init_tier_state(cfg, data.shape[0] // mesh.shape["data"],
                         device="cpu")
    mine = _perturb(params, cfg, None, noise, st, lanes(data), True,
                    lanes(cond), lanes(spk), torch.Generator().manual_seed(7),
                    mesh)
    out["noise_equal"] = bool(torch.equal(lanes(whole), mine))
    out["noise_changed"] = float((whole != data).float().mean())
    return out


def _task_specs(mesh, spec):
    """The port's param_sharding of the full tree, by checkpoint key."""
    from msnv_tpu_torch.parallel.mesh import param_sharding
    from msnv_tpu_torch.tree import keystr, leaves_with_paths
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.step import make_train_step
    cfg = _cfg(spec["model"])
    specs = param_sharding(mesh, _params(spec["params"], cfg))
    out = {"leaf:" + keystr(("params",) + tuple(path)): dim
           for path, dim in leaves_with_paths(specs)}
    try:
        make_train_step(cfg, make_optimizer(_train_cfg(spec["train"])),
                        mesh=mesh)
    except ValueError as e:
        out["no_specs_error"] = str(e)
    return out


def _task_generate(mesh, spec):
    """Sharded generation (global result) and this rank's local run on its
    lanes with the folded generator."""
    from msnv_tpu_torch.models.generate import generate_fn
    from msnv_tpu_torch.parallel.generate import (
        shard_generator, sharded_generate_fn, sharded_generate_fn_dynamic)
    from msnv_tpu_torch.parallel.mesh import batch_sharding
    cfg = _cfg(spec["model"])
    params = _params(spec["params"], cfg)
    cond, spk = _t(spec["cond"]), _t(spec["spk"])
    temp = spec.get("temperature", 1.0)
    audio, seq = sharded_generate_fn(params, cfg, mesh, temperature=temp)(
        cond, spk, spec["seed"])
    _, seq_dynamic = sharded_generate_fn_dynamic(cfg, mesh, temperature=temp)(
        params, cond, spk, spec["seed"])
    lanes = batch_sharding(mesh).local
    _, local = generate_fn(params, cfg, temperature=temp)(
        lanes(cond), lanes(spk), shard_generator(mesh, spec["seed"]))
    out = {"audio": audio.numpy(), "seq": seq.numpy(),
           "seq_dynamic": seq_dynamic.numpy(), "local_seq": local.numpy(),
           "data_index": mesh.data_index}
    try:
        sharded_generate_fn(params, cfg, mesh)(cond[:1], spk[:1])
    except ValueError as e:
        out["odd_batch_error"] = str(e)
    return out


def _task_stream(mesh, spec):
    """Sharded streaming pushes (global samples) and this rank's local
    stream on its lanes with the folded generator."""
    from msnv_tpu_torch.models.generate import streaming_fn
    from msnv_tpu_torch.parallel.generate import (shard_generator,
                                                  sharded_streaming_fn)
    from msnv_tpu_torch.parallel.mesh import batch_sharding
    cfg = _cfg(spec["model"])
    params = _params(spec["params"], cfg)
    K = spec["frames_per_push"]
    spk = _t(spec["spk"])
    conds = [_t(c) for c in spec["conds"]]
    init_state, push = sharded_streaming_fn(params, cfg, mesh,
                                            frames_per_push=K)
    carry = init_state(spk, spec["seed"])
    got = []
    for c in conds:
        carry, audio, samples = push(carry, c)
        got.append(samples.numpy())
    lanes = batch_sharding(mesh).local
    init_l, push_l = streaming_fn(params, cfg, frames_per_push=K)
    lc = init_l(lanes(spk).shape[0], lanes(spk),
                shard_generator(mesh, spec["seed"]))
    ref = []
    for c in conds:
        lc, _, s = push_l(lc, lanes(c))
        ref.append(s.numpy())
    return {"samples": np.concatenate(got, axis=1),
            "local": np.concatenate(ref, axis=1),
            "data_index": mesh.data_index}


TASKS = {"train": _task_train, "eval": _task_eval, "gan": _task_gan,
         "exposure": _task_exposure, "specs": _task_specs,
         "generate": _task_generate, "stream": _task_stream}


def job_tasks(rank, world, tasks):
    """Each (name, task, mesh shape, spec) of `tasks` on a mesh of that
    shape -> {name: result}."""
    from msnv_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for name, task, shape, spec in tasks:
        mesh = make_mesh(*shape, device="cpu")
        out[name] = TASKS[task](mesh, spec)
        out[name]["mesh"] = dict(mesh.shape)
    return out


# -- the Trainer over a mesh ------------------------------------------------

def job_trainer(rank, world, spec):
    """Trainer(mesh=spec["shape"]) for two epochs with validation, on the
    device corpus and (with spec["host_path"]) on the host path -> losses,
    validation losses and the gathered final state; and whether that state
    survives restore() into a fresh Trainer and checkpoint_state() again
    bit for bit."""
    from msnv_tpu_torch.config import ExperimentConfig
    from msnv_tpu_torch.data.corpus import Corpus
    from msnv_tpu_torch.data.loader import ChunkLoader
    from msnv_tpu_torch.parallel.mesh import make_mesh
    from msnv_tpu_torch.training.checkpoint import flatten_state
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.plugins import Plugin, ValidationPlugin
    from msnv_tpu_torch.training.trainer import Trainer

    class Capture(Plugin):
        def __init__(self):
            self.losses, self.val = [], []

        def iteration(self, loss):
            self.losses.append(loss)

        def epoch(self, epoch_index):
            self.val.append(self.trainer.stats["validation_loss"]["last"])

    cfg = _cfg(spec["model"])
    exp = ExperimentConfig(exp="t", model=cfg, train=_train_cfg(spec["train"]))
    geo = (exp.train.seq_len, cfg.lookback, cfg.cond_len, cfg.q_levels,
           cfg.ulaw)
    loader = ChunkLoader(Corpus(**spec["corpus"]), *geo)
    val = ChunkLoader(Corpus(**spec["val_corpus"]), *geo)
    mesh = make_mesh(*spec["shape"], device="cpu")

    def trainer(device_corpus):
        return Trainer(exp, _params(spec["params"], cfg),
                       make_optimizer(exp.train, len(loader)), loader,
                       mesh=mesh, device_corpus=device_corpus)

    out = {}
    for device_corpus in (True, False)[:1 + spec["host_path"]]:
        t = trainer(device_corpus)
        t.register_plugin(ValidationPlugin(val, val))
        cap = t.register_plugin(Capture())
        t.run(2)
        state = t.checkpoint_state()
        fresh = trainer(device_corpus)
        fresh.restore(state, {"epoch": t.epochs, "iteration": t.iterations})
        again = flatten_state(fresh.checkpoint_state())
        flat = flatten_state(state)
        out[device_corpus] = {
            "losses": cap.losses, "val": cap.val, "state": flat,
            "local_lanes": int(t.state[0].shape[1]),
            "w_hh_rows": int(t.params["tiers"][0]["gru"][0]["w_hh"]
                             .shape[0]),
            "roundtrip_equal": again.keys() == flat.keys() and all(
                np.array_equal(again[k], flat[k]) for k in flat)}
    return out


# -- cli.train under ranks --------------------------------------------------

def job_cli(rank, world, argv_two, argv_three):
    """cli.train for two epochs, then resumed to three, on every rank; the
    checkpoint writes, stats.json writes, corpus builds and checkpoint
    loads of this rank are counted."""
    from msnv_tpu_torch.cli import train as cli_train
    from msnv_tpu_torch.data import corpus as corpus_mod
    from msnv_tpu_torch.training import checkpoint as ckpt_mod

    counts = {"save": [], "stats": 0, "build": [], "load": []}
    save, build, load = (ckpt_mod.save_checkpoint,
                         corpus_mod._build_corpus_local,
                         ckpt_mod.load_checkpoint)
    dump = json.dump

    def counted_save(path, *a, **kw):
        counts["save"].append(os.path.basename(path))
        return save(path, *a, **kw)

    def counted_build(cfg, partition, names):
        counts["build"].append(partition)
        return build(cfg, partition, names)

    def counted_load(path, *a, **kw):
        counts["load"].append(os.path.basename(path))
        return load(path, *a, **kw)

    def counted_dump(obj, fh, *a, **kw):
        if getattr(fh, "name", "").endswith("stats.json"):
            counts["stats"] += 1
        return dump(obj, fh, *a, **kw)

    ckpt_mod.save_checkpoint = counted_save
    ckpt_mod.load_checkpoint = counted_load
    corpus_mod._build_corpus_local = counted_build
    json.dump = counted_dump
    stdout = sys.stdout
    try:
        for argv in (argv_two, argv_three):
            try:
                cli_train.main(argv)
            finally:
                sys.stdout = stdout        # the train CLI tees stdout
    finally:
        ckpt_mod.save_checkpoint = save
        ckpt_mod.load_checkpoint = load
        corpus_mod._build_corpus_local = build
        json.dump = dump
    # a batch of 3 lanes does not divide over two data ranks
    odd = list(argv_two)
    odd[odd.index("--batch_size") + 1] = "3"
    try:
        cli_train.main(odd)
    except ValueError as e:
        counts["odd_batch_error"] = str(e)
    finally:
        sys.stdout = stdout
    # ranks that do not share their checkpoints: rank 0 sees one, rank 1
    # none
    results = argv_two[argv_two.index("--results_path") + 1]
    own = os.path.join(os.path.dirname(results), f"unshared{rank}")
    manager = ckpt_mod.CheckpointManager(own, keep_old=False)
    if rank == 0:
        open(os.path.join(own, "ep1-it4.npz"), "wb").close()
    try:
        manager.resume_point()
    except FileNotFoundError as e:
        counts["unshared_error"] = str(e)
    return counts


# -- serving over a mesh (tests/test_torch_serving_mesh.py) ----------------

def _post(addr, path, body):
    import http.client
    c = http.client.HTTPConnection(*addr, timeout=120)
    c.request("POST", path, json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, data


def _threaded_front(service):
    import threading

    from msnv_tpu_torch.serving import make_server
    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _lead_or_follow(service, lead):
    """Rank 0 runs lead(service) and closes the service (STOP); the other
    ranks follow it until then. -> lead's result on rank 0, else None."""
    from msnv_tpu_torch.parallel.serve import follow
    try:
        if not service._channel.leader:
            follow(service)
            return None
        return lead(service)
    finally:
        service.close()


def _synth_items(spec):
    return [{"cond": np.asarray(c, np.float32),
             "spk": np.asarray([s], np.int32), "seed": seed,
             "n": len(c)} for c, s, seed in spec["items"]]


def _folded(items):
    seed = items[0]["seed"]
    for it in items[1:]:
        seed = (seed * 1000003 + it["seed"]) % (1 << 63)
    return seed


def job_serving_synth(rank, world, spec):
    """VocoderService(mesh=) over (world, 1): rank 0 runs the group calls
    (8 items, then 3), greedy /synthesize bodies and one HTTP request, and
    after a heartbeat-covered idle spell one more group on a service whose
    header group times out after spec["short_timeout"] s; every rank then
    runs generate_fn on its lanes of the 8-item group with the folded
    generator (its shard's reference)."""
    from msnv_tpu_torch.models.generate import generate_fn
    from msnv_tpu_torch.parallel.generate import shard_generator
    from msnv_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from msnv_tpu_torch.serving import VocoderService
    cfg = _cfg(spec["model"])
    params = _params(spec["params"], cfg)
    mesh = make_mesh(world, 1, device="cpu")
    items = _synth_items(spec)
    frames = len(spec["items"][0][0])

    def lead(svc):
        out = {"healthz": svc.healthz()}
        gkey = (frames, 1.0, "i")
        out["group8"] = svc._run_group(gkey, items)
        out["group3"] = svc._run_group(gkey, items[:3])
        out["greedy"] = [svc.synthesize(b) for b in spec["greedy"]]
        srv = _threaded_front(svc)
        try:
            out["http"] = _post(srv.server_address, "/synthesize",
                                spec["greedy"][0])
        finally:
            srv.shutdown()
            srv.server_close()
        return out

    out = {"lead": _lead_or_follow(
        VocoderService(params, cfg, frame_bucket=1, mesh=mesh), lead)}

    def idle(svc):
        time.sleep(spec["idle_s"])
        return svc._run_group((frames, 1.0, "i"), items[:2])

    out["after_idle"] = _lead_or_follow(
        VocoderService(params, cfg, frame_bucket=1, mesh=mesh,
                       mesh_timeout_s=spec["short_timeout"]), idle)
    lanes = batch_sharding(mesh).local
    conds = torch.from_numpy(np.stack([it["cond"] for it in items]))
    spks = torch.from_numpy(np.concatenate([it["spk"] for it in items]))
    audio, _ = generate_fn(params, cfg)(
        lanes(conds), lanes(spks), shard_generator(mesh, _folded(items)))
    out["local8"] = audio.numpy()
    out["data_index"] = mesh.data_index
    return out


def job_serving_mux(rank, world, spec):
    """StreamMultiplexer(mesh=) over (world, 1): the masked push on this
    rank's carry; then a service with mux lanes over the mesh, rank 0
    serving HTTP: four concurrent /stream clients at the default
    temperature, then greedy streams on a greedy service."""
    import threading

    from msnv_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from msnv_tpu_torch.serving import StreamMultiplexer, VocoderService
    cfg = _cfg(spec["model"])
    params = _params(spec["params"], cfg)
    mesh = make_mesh(world, 1, device="cpu")
    lanes = batch_sharding(mesh).local
    out = {}
    mux = StreamMultiplexer(params, cfg, lanes=spec["lanes"],
                            frames_per_push=2, mesh=mesh)
    carry0 = mux._carry
    carry1, audio = mux._masked_push(carry0, lanes(_t(spec["cond"])),
                                     lanes(_t(spec["active"])))
    out["push"] = {"audio": audio.numpy(), "buf0": carry0[1].numpy(),
                   "buf1": carry1[1].numpy(),
                   "hs0": [h.numpy() for h in carry0[2]],
                   "hs1": [h.numpy() for h in carry1[2]],
                   "local_lanes": mux._local_lanes}

    def clients(svc, bodies):
        srv = _threaded_front(svc)
        got = {}

        def one(i):
            got[i] = _post(srv.server_address, "/stream", bodies[i])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(bodies))]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
        finally:
            srv.shutdown()
            srv.server_close()
        return ([got.get(i) for i in range(len(bodies))], svc.healthz(),
                svc._mux.ticks)

    kw = dict(frames_per_push=2, mux_lanes=spec["lanes"], mesh=mesh)
    out["streams"] = _lead_or_follow(
        VocoderService(params, cfg, **kw),
        lambda svc: clients(svc, [spec["body"]] * 4))
    greedy = VocoderService(params, cfg, temperature_default=0.0, **kw)
    out["greedy"] = _lead_or_follow(
        greedy, lambda svc: clients(svc, spec["greedy"]))
    out["ticks"] = greedy._mux.ticks     # every rank ticks
    return out


def job_serving_cli(rank, world, spec):
    """`python -m msnv_tpu_torch.serving --mesh_data` on every rank: first
    a --mesh_data that differs from the world (ValueError), then
    --mesh_data `world` until rank 0 is sent SIGINT (the parent's HTTP
    requests run meanwhile). With spec["fail_rank"] that rank's shard of
    the first /synthesize raises."""
    from msnv_tpu_torch.serving import cli
    from msnv_tpu_torch.serving import service as service_mod
    out = {}
    try:
        cli.main(spec["argv"][:-2] + ["--mesh_data", str(2 * world)])
    except ValueError as e:
        out["world_error"] = str(e)
    if rank == spec.get("fail_rank"):
        def broken(self, temperature, cond, spk, seed):
            # the request tensors arrive, then this rank's shard raises
            self._channel.share([cond, spk])

            def shard():
                raise RuntimeError(f"the shard of rank {rank} broke")

            self._channel.run(shard)

        service_mod.VocoderService._mesh_synth = broken
    cli.main(spec["argv"])
    out["returned"] = True
    return out


def job_serving_refusals(rank, world, model):
    """The mesh shapes serving refuses: a (1, world) mesh (n_model > 1)
    and mux lanes that do not divide over (world, 1)."""
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.parallel.mesh import make_mesh
    from msnv_tpu_torch.serving import StreamMultiplexer, VocoderService
    cfg = _cfg(model)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    out = {}
    try:
        VocoderService(params, cfg, mesh=make_mesh(1, world, device="cpu"))
    except ValueError as e:
        out["model_axis"] = str(e)
    try:
        StreamMultiplexer(params, cfg, lanes=world + 1,
                          mesh=make_mesh(world, 1, device="cpu"))
    except ValueError as e:
        out["odd_lanes"] = str(e)
    return out


# -- directory checkpoints (tests/test_torch_checkpoint_dcp.py) ------------

def _dcp_state(spec):
    """The port's train state from spec's numpy: params, Adam moments
    and count, tier state."""
    from msnv_tpu_torch.interop import params_from_numpy
    cfg = _cfg(spec["model"])
    return {"params": _params(spec["params"], cfg),
            "opt_state": {"count": spec["count"],
                          "mu": params_from_numpy(spec["mu"], cfg, "cpu"),
                          "nu": params_from_numpy(spec["nu"], cfg, "cpu")},
            "tier_state": [_t(s) for s in spec["tier_state"]]}


def _dcp_layout(mesh, state, zero=False):
    """`state` in a mesh's checkpoint layout (Trainer.checkpoint_state
    (sharded=True)'s): this rank's storage as DTensors; zeros with
    `zero`."""
    from msnv_tpu_torch.parallel.mesh import (as_dtensors, param_sharding,
                                              shard_params, state_sharding)
    from msnv_tpu_torch.tree import tree_map
    if zero:
        state = tree_map(lambda x: x if isinstance(x, int)
                         else torch.zeros_like(x), state)
    specs = param_sharding(mesh, state["params"])

    def part(tree):
        return as_dtensors(mesh, shard_params(mesh, tree, specs), specs)

    lanes = state_sharding(mesh).local
    return {"params": part(state["params"]),
            "opt_state": {"count": state["opt_state"]["count"],
                          "mu": part(state["opt_state"]["mu"]),
                          "nu": part(state["opt_state"]["nu"])},
            "tier_state": as_dtensors(
                mesh, [lanes(s) for s in state["tier_state"]],
                lane_axis=1)}


def job_dcp_sharded(rank, world, spec):
    """Save the state from a (1, world) mesh (each rank its 'model'
    slices), then load it on (world, 1) (each rank its lanes of the tier
    state): this rank's bytes written and whether every loaded local
    tensor equals the full state's slice of it, bit for bit."""
    from msnv_tpu_torch.parallel.mesh import local_tensors, make_mesh
    from msnv_tpu_torch.training.checkpoint import (load_checkpoint_dcp,
                                                    save_checkpoint_dcp)
    from msnv_tpu_torch.tree import leaves_with_paths
    state = _dcp_state(spec)
    save_checkpoint_dcp(spec["path"],
                        _dcp_layout(make_mesh(1, world, device="cpu"),
                                    state), {"sharded": True})
    written = os.path.getsize(os.path.join(spec["path"],
                                           f"__{rank}_0.distcp"))
    mesh = make_mesh(world, 1, device="cpu")
    loaded, meta = load_checkpoint_dcp(
        spec["path"], _dcp_layout(mesh, state, zero=True))
    want = local_tensors(_dcp_layout(mesh, state))
    got = dict(leaves_with_paths(local_tensors(loaded)))
    equal = all(torch.equal(got[p], x) if torch.is_tensor(x)
                else got[p] == x for p, x in leaves_with_paths(want))
    return {"written": written, "equal": equal, "meta": meta,
            "tier_lanes": int(got[("tier_state", 0)].shape[1])}


def job_orbax_sharded(rank, world, spec):
    """Save the state as orbax from a spec["save"] (n_data, n_model) mesh
    (each rank its slices into its own database), then load it on
    spec["load"]: this rank's bytes written and whether every loaded local
    tensor equals the full state's slice of it, bit for bit."""
    from msnv_tpu_torch.parallel.mesh import local_tensors, make_mesh
    from msnv_tpu_torch.training.checkpoint import (load_checkpoint_orbax,
                                                    save_checkpoint_orbax)
    from msnv_tpu_torch.tree import leaves_with_paths
    state = _dcp_state(spec)
    save_checkpoint_orbax(spec["path"],
                          _dcp_layout(make_mesh(*spec["save"], device="cpu"),
                                      state), {"sharded": True},
                          scheduled=spec["scheduled"])
    db = os.path.join(spec["path"], f"ocdbt.process_{rank}")
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, files in os.walk(db) for f in files)
    mesh = make_mesh(*spec["load"], device="cpu")
    loaded, meta = load_checkpoint_orbax(
        spec["path"], _dcp_layout(mesh, state, zero=True))
    want = local_tensors(_dcp_layout(mesh, state))
    got = dict(leaves_with_paths(local_tensors(loaded)))
    equal = all(torch.equal(got[p], x) if torch.is_tensor(x)
                else got[p] == x for p, x in leaves_with_paths(want))
    return {"written": written, "equal": equal, "meta": meta}


def job_cli_dcp(rank, world, argv_straight, argv_one, argv_two):
    """cli.train on every rank (its --ckpt_backend from the arguments):
    straight to two epochs, and to one epoch then resumed to two."""
    from msnv_tpu_torch.cli import train as cli_train
    stdout = sys.stdout
    try:
        for argv in (argv_straight, argv_one, argv_two):
            try:
                cli_train.main(argv)
            finally:
                sys.stdout = stdout        # the train CLI tees stdout
    finally:
        sys.stdout = stdout
    return {"rank": rank}


# -- one starting state for every replica (parallel.mesh.broadcast_tree) ----

def _snap(flat):
    """Copies of a {key: array} dict (params_to_numpy shares CPU storage,
    and the trees change in place)."""
    return {k: np.array(v, copy=True) for k, v in flat.items()}


def _bits(x):
    """A tensor's bits as numpy (bf16 as its int16 pattern)."""
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.detach().clone().numpy()


def _broadcast_case(rank):
    """broadcast_tree on a tree of float32, bf16 and int64 leaves drawn
    from this rank's seed: the bits before and after, whether each leaf
    kept its storage and dtype, and the broadcasts it sent."""
    from msnv_tpu_torch.parallel.mesh import broadcast_tree
    from msnv_tpu_torch.tree import tree_leaves
    g = torch.Generator().manual_seed(rank)
    tree = {"a": torch.randn(3, 4, generator=g),
            "b": [torch.randn(5, generator=g).to(torch.bfloat16)],
            "c": torch.randint(0, 1 << 40, (6,), generator=g),
            "d": torch.randn(2, 3, generator=g).t()}   # a strided view
    tensors = tree_leaves(tree)
    before = [_bits(x) for x in tensors]
    ptrs = [x.data_ptr() for x in tensors]
    calls, real = [], dist.broadcast

    def counted(t, *a, **kw):
        calls.append(str(t.dtype))
        return real(t, *a, **kw)

    dist.broadcast = counted
    try:
        out = broadcast_tree(tree)
    finally:
        dist.broadcast = real
    return {"before": before, "after": [_bits(x) for x in tensors],
            "in_place": out is tree and ptrs == [x.data_ptr()
                                                 for x in tensors],
            "dtypes": [str(x.dtype) for x in tensors], "calls": calls}


def _init_trainer(rank, spec, variant, shape):
    """Trainer(mesh=shape) from this rank's own draw (seed `rank`; the GAN's
    discriminator from train seed + 100 rank, + 1): the draws, the full
    params (and discriminator) at construction, after one epoch of two
    steps, and after warm_start from another draw of this rank's (seed
    10 + rank) and one more epoch."""
    import dataclasses

    from msnv_tpu_torch.config import ExperimentConfig
    from msnv_tpu_torch.data.corpus import Corpus
    from msnv_tpu_torch.data.loader import ChunkLoader
    from msnv_tpu_torch.interop import disc_params_to_numpy
    from msnv_tpu_torch.models.discriminator import discriminator_init
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.parallel.mesh import make_mesh
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.plugins import Plugin
    from msnv_tpu_torch.training.trainer import Trainer

    class Losses(Plugin):
        def __init__(self):
            self.losses = []

        def iteration(self, loss):
            self.losses.append(loss)

    case = spec[variant]
    cfg = _cfg(case["model"])
    train = _train_cfg(case["train"])
    train = dataclasses.replace(train, seed=train.seed + 100 * rank)
    exp = ExperimentConfig(exp="t", model=cfg, train=train)
    loader = ChunkLoader(Corpus(**case["corpus"]), train.seq_len,
                         cfg.lookback, cfg.cond_len, cfg.q_levels, cfg.ulaw)
    mesh = make_mesh(*shape, device="cpu")
    draw = lambda seed: init_params(                     # noqa: E731
        cfg, torch.Generator().manual_seed(seed), device="cpu")
    params = draw(rank)
    out = {"drawn": _snap(_numpy(params))}
    gan = variant == "gan"
    if gan:
        out["disc_drawn"] = _snap(disc_params_to_numpy(discriminator_init(
            torch.Generator().manual_seed(train.seed + 1), cfg.spk_dim,
            train.disc_channels, device="cpu")))
    t = Trainer(exp, params, make_optimizer(train, len(loader)), loader,
                mesh=mesh)
    disc = lambda: _snap(disc_params_to_numpy(t.disc_params))  # noqa: E731
    out["initial"] = _snap(_numpy(t.full_params()))
    if gan:
        out["disc_initial"] = disc()
    cap = t.register_plugin(Losses())
    t.run(1)
    out["losses"] = list(cap.losses)
    out["trained"] = _snap(_numpy(t.full_params()))
    if gan:
        out["disc_trained"] = disc()
    warm = draw(10 + rank)
    out["warm_drawn"] = _snap(_numpy(warm))
    t.warm_start(warm)
    out["warm_initial"] = _snap(_numpy(t.full_params()))
    t.run(2)
    out["warm_trained"] = _snap(_numpy(t.full_params()))
    return out


def _init_serving(rank, world, spec):
    """VocoderService(mesh=) with mux lanes over (world, 1) built from this
    rank's own draw (seed `rank`): the service's params, rank 0's
    /synthesize group, and this rank's local generate_fn run on its lanes
    with rank 0's draw; the service's multiplexer's push of its carry and
    a local streaming push of rank 0's draw with the mux's generator."""
    from msnv_tpu_torch.models.generate import generate_fn, streaming_fn
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.parallel.generate import shard_generator
    from msnv_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from msnv_tpu_torch.serving import VocoderService
    cfg = _cfg(spec["model"])
    mesh = make_mesh(world, 1, device="cpu")
    lanes = batch_sharding(mesh).local
    draw = lambda seed: init_params(                     # noqa: E731
        cfg, torch.Generator().manual_seed(seed), device="cpu")
    rank0 = draw(0)
    items = _synth_items(spec)
    frames = len(spec["items"][0][0])
    own = draw(rank)
    out = {"drawn": _snap(_numpy(own))}
    svc = VocoderService(own, cfg, frame_bucket=1, frames_per_push=2,
                         mux_lanes=2 * world, mesh=mesh)
    out.update({"service_params": _snap(_numpy(svc.params)),
                "rank0": _snap(_numpy(rank0)),
                "data_index": mesh.data_index})
    # the carry's push is this rank's alone (no collective): the pump,
    # idle without streams, is not involved
    cond = lanes(_t(spec["mux_cond"]))
    active = torch.ones(cond.shape[0], dtype=torch.bool)
    _, audio = svc._mux._masked_push(svc._mux._carry, cond, active)
    init_l, push_l = streaming_fn(rank0, cfg, frames_per_push=2)
    carry = init_l(cond.shape[0], torch.zeros(cond.shape[0],
                                              dtype=torch.int64),
                   shard_generator(mesh, 0))
    _, local, _ = push_l(carry, cond)
    out["mux_audio"], out["mux_local"] = audio.numpy(), local.numpy()
    out["group"] = _lead_or_follow(
        svc, lambda s: s._run_group((frames, 1.0, "i"), items))
    conds = torch.from_numpy(np.stack([it["cond"] for it in items]))
    spks = torch.from_numpy(np.concatenate([it["spk"] for it in items]))
    audio, _ = generate_fn(rank0, cfg)(
        lanes(conds), lanes(spks), shard_generator(mesh, _folded(items)))
    out["local_group"] = audio.numpy()
    return out


def job_mesh_init(rank, world, spec):
    """The broadcast on its own, the Trainer over (2, 1) and (1, 2) for
    each variant of spec["trainer"], and serving over (world, 1), every
    rank starting from its own draw."""
    return {"broadcast": _broadcast_case(rank),
            "trainer": {(variant, shape): _init_trainer(rank, spec["trainer"],
                                                        variant, shape)
                        for variant in spec["trainer"]
                        for shape in ((2, 1), (1, 2))},
            "serving": _init_serving(rank, world, spec["serving"])}
