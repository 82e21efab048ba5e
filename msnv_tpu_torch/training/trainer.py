"""Trainer: TBPTT epoch loop with plugin events and exact resume.

The port's counterpart of the JAX package's training/trainer.py (a
re-design of ref trainer/__init__.py:9-117): the train step owns the math,
the Trainer owns the loop, the loaders, plugin dispatch and the resumable
training state (epoch, iteration, TBPTT hidden, data cursor).

The step updates params and the optimizer state in place
(training/step.py), so `checkpoint_state()` hands out copies: a later step
never changes what a saver or a caller holds. The steps take the params as
arguments and keep nothing of them, so after `restore()` or a warm start
they train the loaded tensors.

The GAN variant (cfg.model.variant == "gan") trains through the
two-optimizer step of training/gan.py: the discriminator is initialized
from a generator seeded with cfg.train.seed + 1 at cfg.train.disc_channels,
its optimizer is the same clipped Adam, the iteration drives the lambda
ramp, and the checkpoint carries "disc_params" and "disc_opt_state".

Over a device mesh (`mesh=`, parallel/mesh.py; one process per GPU, every
rank running this loop) the Trainer is given the FULL params, makes them
global rank 0's (`broadcast_tree`: every replica starts from one state,
whatever each rank drew; the discriminator and a warm start's params
alike), and keeps this rank's storage of them (`shard_params`: the
slices of the 'model'-sharded leaves; the params themselves when n_model
is 1), its optimizer state in the same layout, and its lanes of the tier
state; it uploads its lanes of the device corpus and slices its lanes of
each host chunk. Every step returns the global loss, so the plugins see
the same numbers on every rank. `checkpoint_state()` and `full_params()`
gather (collectives: every rank calls them), `restore()` takes a full
state and keeps this rank's part.
Only rank 0 writes files and prints (training/plugins.py). The directory
checkpoints (`checkpoint_state(sharded=True)`, the dcp backend of
training/checkpoint.py) gather nothing: they hold this rank's storage as
DTensors over the mesh, which every rank saves, and restore() takes such a
state as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from msnv_tpu_torch.config import ExperimentConfig, make_tag
from msnv_tpu_torch.models.discriminator import discriminator_init
from msnv_tpu_torch.models.samplernn import init_tier_state
from msnv_tpu_torch.parallel.mesh import (as_dtensors, batch_sharding,
                                          broadcast_tree, check_mesh,
                                          corpus_sharding,
                                          gather_lanes, gather_params,
                                          local_tensors, param_sharding,
                                          shard_params, state_sharding)
from msnv_tpu_torch.training.gan import (METRICS, make_gan_train_block_scan,
                                         make_gan_train_step,
                                         make_gan_train_step_indexed)
from msnv_tpu_torch.training.step import (exposure_tuple, fold_generator,
                                          make_eval_block_scan,
                                          make_eval_step,
                                          make_train_block_scan,
                                          make_train_step,
                                          make_train_step_indexed)
from msnv_tpu_torch.tree import tree_leaves, tree_map


def _on(device, array):
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _copy_opt_state(opt_state):
    """A snapshot of an optimizer state (ints kept, tensors cloned)."""
    return {k: v if isinstance(v, int) else
            tree_map(lambda x: x.detach().clone(), v)
            for k, v in opt_state.items()}


def _map_moments(fn, opt_state):
    """An optimizer state with fn applied to its moment trees."""
    return {k: v if isinstance(v, int) else fn(v)
            for k, v in opt_state.items()}


class Trainer:
    #: device-corpus "auto" threshold: upload a corpus to device memory
    #: only below this footprint (big corpora keep streaming from host RAM)
    DEVICE_CORPUS_MAX_BYTES = 2 << 30

    def __init__(self, cfg: ExperimentConfig, params, optimizer, loader,
                 mesh=None, compute_dtype=None, device_corpus="auto"):
        check_mesh(mesh)
        self.cfg = cfg
        self.tag = make_tag(cfg)
        self.mesh = mesh
        self.device = params["mlp"]["embedding"].device
        self.optimizer = optimizer
        if mesh is None:
            self._specs = None
            self.params = params
        else:
            broadcast_tree(params)
            self._specs = param_sharding(mesh, params)
            self.params = shard_params(mesh, params, self._specs)
        self.opt_state = optimizer.init(self.params)
        self.loader = loader
        self.state = init_tier_state(cfg.model, self._lanes(
            loader._qdata).shape[0], device=self.device)
        self.epochs = 0        # completed epochs (resume sets this)
        self.iterations = 0
        self.chunk_index = 0   # data cursor within the current epoch
        self.start_chunk = 0   # mid-epoch resume point
        self.stats = {}
        self.plugins = []
        self.compute_dtype = compute_dtype
        self.device_corpus = device_corpus
        self.scan_block = 16          # chunks per block
        self._corpus_dev = None       # device-resident packed corpus
        self._step_indexed = None
        self._train_scan = None
        self._eval_dev = {}           # loader -> (corpus_dev, eval_scan)

        # exposure-bias mitigation (config.TrainConfig.ss_prob /
        # input_noise_prob): the train steps take a trailing generator,
        # seeded from (seed + 0x55, iteration) on the host path and from
        # (seed + 0x55, epoch, chunk) on the device-corpus paths
        self._exposure = exposure_tuple(cfg.train)
        self._exp_seed = (cfg.train.seed + 0x55) & 0x7FFFFFFF

        self.is_gan = cfg.model.variant == "gan"
        if self.is_gan and self._exposure is not None:
            raise ValueError(
                "ss_prob/input_noise_prob are not supported with the GAN "
                "variant (the adversarial step has its own two-loss "
                "forward); fine-tune the identity/bottleneck heads")
        self._gan_metrics = None      # the last GAN step's, on the device
        if self.is_gan:
            self.disc_params = discriminator_init(
                torch.Generator().manual_seed(cfg.train.seed + 1),
                cfg.model.spk_dim, cfg.train.disc_channels,
                device=self.device)
            if mesh is not None:
                broadcast_tree(self.disc_params)
            self.disc_opt = optimizer        # the same clipped-Adam recipe
            self.disc_opt_state = self.disc_opt.init(self.disc_params)
            gan = (cfg.model, cfg.train, optimizer, self.disc_opt)
            self._step = make_gan_train_step(
                *gan, mesh=mesh, compute_dtype=compute_dtype,
                specs=self._specs)
        else:
            self._step = make_train_step(
                cfg.model, optimizer, mesh=mesh, compute_dtype=compute_dtype,
                exposure=self._exposure, specs=self._specs)
        self._eval = make_eval_step(cfg.model, mesh=mesh, specs=self._specs)
        if self._want_device_corpus(loader):
            # window geometry comes from the LOADER, never from the train
            # config (they agree in the CLI; the API allows any loader)
            geo = (loader.seq_len, loader.overlap_len, loader.cond_in_seq)
            self._corpus_dev = self._upload(loader)
            sharded = dict(mesh=mesh, specs=self._specs)
            if self.is_gan:
                self._step_indexed = make_gan_train_step_indexed(
                    *gan, *geo, compute_dtype=compute_dtype, **sharded)
                self._train_scan = make_gan_train_block_scan(
                    *gan, *geo, compute_dtype=compute_dtype, **sharded)
            else:
                self._step_indexed = make_train_step_indexed(
                    cfg.model, optimizer, *geo, compute_dtype=compute_dtype,
                    exposure=self._exposure, **sharded)
                self._train_scan = make_train_block_scan(
                    cfg.model, optimizer, *geo, compute_dtype=compute_dtype,
                    exposure=self._exposure, **sharded)

    def _upload(self, loader):
        """The loader's packed corpus on the device: this rank's lanes
        over a mesh."""
        shardings = None if self.mesh is None else corpus_sharding(self.mesh)
        return loader.device_arrays(self.device, shardings=shardings)

    def _lanes(self, array):
        """This rank's lanes of a host array (all of them without a mesh;
        raises unless they divide over 'data')."""
        if self.mesh is None:
            return array
        return batch_sharding(self.mesh).local(array)

    def _want_device_corpus(self, loader) -> bool:
        if self.device_corpus in (False, "false"):
            return False
        if self.device_corpus in (True, "true"):
            return True
        return loader.device_bytes() <= self.DEVICE_CORPUS_MAX_BYTES

    # -- plugins ----------------------------------------------------------
    def register_plugin(self, plugin):
        plugin.register(self)
        self.plugins.append(plugin)
        return plugin

    def _call_plugins(self, event: str, *args):
        for p in self.plugins:
            getattr(p, event)(*args)

    # -- training ---------------------------------------------------------
    def train_chunk(self, chunk, iteration=None):
        """One optimizer step on one host TBPTT chunk; returns the loss
        (bits) as a device scalar. `iteration` is the number of steps taken
        before this one (default: the iterations flushed so far): it keys
        the exposure draws and is the GAN lambda ramp's step. The JAX
        trainer uses the flushed count, which lags one step behind under
        the pipelined flush (its first two steps share a key and a ramp
        step); here the pipelined and the synchronous loops agree."""
        it = self.iterations if iteration is None else iteration
        dev, lanes = self.device, self._lanes
        batch = (_on(dev, lanes(chunk.data)), chunk.reset,
                 _on(dev, lanes(chunk.target)), _on(dev, lanes(chunk.cond)),
                 _on(dev, lanes(chunk.spk)))
        if self.is_gan:
            (self.params, self.disc_params, self.opt_state,
             self.disc_opt_state, self.state, metrics) = self._step(
                self.params, self.disc_params, self.opt_state,
                self.disc_opt_state, self.state, float(it), *batch)
            self._gan_metrics = metrics
            return metrics["loss"]
        extra = ()
        if self._exposure is not None:
            # deterministic in (seed, iteration): resume replays the stream
            extra = (fold_generator(self.device, self._exp_seed, it),)
        self.params, self.opt_state, self.state, loss = self._step(
            self.params, self.opt_state, self.state, *batch, *extra)
        return loss

    def _pipelining_allowed(self) -> bool:
        """Loss-fetch pipelining (and blocks) run a plugin's iteration(k)
        after later steps were dispatched, so a plugin that reads trainer
        params/state per iteration would see a later state. Plugins declare
        that need with `needs_sync_state` and force the per-step loop."""
        return not any(getattr(p, "needs_sync_state", False)
                       for p in self.plugins)

    def _epoch_key(self):
        """Exposure key of the device-corpus paths: (seed, epoch); the
        chunk index is folded in per step."""
        if self._exposure is None:
            return ()
        return (self._exp_seed, self.epochs)

    def _record_gan_metrics(self, metrics):
        """disc_loss / lambda stats: the last value of a step or a block."""
        for name in ("disc_loss", "lambda"):
            self.stats.setdefault(name, {})["last"] = float(
                metrics[name].reshape(-1)[-1])

    def _run_scan_block(self, ks) -> np.ndarray:
        """One block of indexed steps; returns per-chunk losses (one fetch)."""
        if self.is_gan:
            (self.params, self.disc_params, self.opt_state,
             self.disc_opt_state, self.state, metrics) = self._train_scan(
                self.params, self.disc_params, self.opt_state,
                self.disc_opt_state, self.state, float(self.iterations),
                self._corpus_dev, ks)
            # one fetch for the block's losses and its last disc_loss, lambda
            fetched = torch.stack([metrics[name] for name in METRICS]).cpu()
            self._record_gan_metrics(dict(zip(METRICS, fetched)))
            return fetched[0].numpy()
        (self.params, self.opt_state, self.state,
         losses) = self._train_scan(
            self.params, self.opt_state, self.state, self._corpus_dev, ks,
            self._epoch_key())
        return losses.cpu().numpy()

    def _run_step_indexed(self, k):
        """One indexed device-corpus step; returns the chunk loss."""
        if self.is_gan:
            (self.params, self.disc_params, self.opt_state,
             self.disc_opt_state, self.state,
             metrics) = self._step_indexed(
                self.params, self.disc_params, self.opt_state,
                self.disc_opt_state, self.state, float(self.iterations),
                self._corpus_dev, k)
            self._gan_metrics = metrics
            return metrics["loss"]
        key = self._epoch_key()
        extra = ((fold_generator(self.device, *key, k),) if key else ())
        (self.params, self.opt_state, self.state,
         loss) = self._step_indexed(
            self.params, self.opt_state, self.state, self._corpus_dev, k,
            *extra)
        return loss

    def train_epoch(self, start_chunk: int = 0):
        """One epoch. When allowed, the loss fetch runs one step behind:
        step k+1 is launched BEFORE float(loss_k) waits, so the fetch
        overlaps the device's work instead of stalling it."""
        pipelined = self._pipelining_allowed()
        pending = None
        if self._train_scan is not None and pipelined:
            # blocks of scan_block chunks, one loss-vector fetch per block
            ks = list(range(start_chunk, len(self.loader)))
            for i in range(0, len(ks), self.scan_block):
                blk = ks[i:i + self.scan_block]
                for k, loss in zip(blk, self._run_scan_block(blk)):
                    self._flush_iteration(k, loss)
        elif self._step_indexed is not None:
            # interval savers need per-step state visibility
            for k in range(start_chunk, len(self.loader)):
                loss = self._run_step_indexed(k)
                self._flush_iteration(k, loss, self._gan_metrics)
        else:
            for chunk in self.loader.epoch(start_chunk=start_chunk):
                loss = self.train_chunk(
                    chunk, self.iterations + (pending is not None))
                if pending is not None:
                    self._flush_iteration(*pending)
                if pipelined:
                    pending = (chunk.index, loss, self._gan_metrics)
                else:
                    self._flush_iteration(chunk.index, loss,
                                          self._gan_metrics)
        if pending is not None:
            self._flush_iteration(*pending)

    def _flush_iteration(self, index: int, loss, gan_metrics=None):
        """Count a step and tell the plugins its loss; the per-step paths
        hand the GAN step's metrics in here, so that they are fetched with
        the loss (one step behind the device when pipelined)."""
        self.chunk_index = index
        self.iterations += 1
        if gan_metrics is not None:
            self._record_gan_metrics(gan_metrics)
        self._call_plugins("iteration", float(loss))

    def run(self, epoch_limit: int):
        """Run up to epoch_limit epochs, resuming from self.epochs (and,
        for a mid-epoch checkpoint, from self.start_chunk) —
        ref trainer/__init__.py:52-60 plus exact-cursor resume."""
        self.epoch_limit = epoch_limit   # plugins may key off the final epoch
        first = True
        for epoch in range(self.epochs + 1, epoch_limit + 1):
            self.train_epoch(self.start_chunk if first else 0)
            first = False
            self.start_chunk = 0
            self.epochs = epoch
            self._call_plugins("epoch", epoch)

    # -- evaluation -------------------------------------------------------
    def evaluate(self, loader) -> float:
        """Mean NLL-bits over a partition (float32 params), loss*batch_size
        weighted like the reference (ref plugins.py:51-92); every chunk
        carries the full lane batch, so that is the mean. Fresh hidden
        state; the losses are fetched once. Evaluation corpora ride the
        device-resident path too when training does; over a mesh each rank
        evaluates its lanes and every chunk's loss is the global one."""
        state = init_tier_state(self.cfg.model, self._lanes(
            loader._qdata).shape[0], device=self.device)
        losses = []
        if self._corpus_dev is not None and self._want_device_corpus(loader):
            # keyed by the loader OBJECT (a held reference); the training
            # loader reuses the already-resident corpus
            if loader not in self._eval_dev:
                corpus_dev = (self._corpus_dev if loader is self.loader
                              else self._upload(loader))
                self._eval_dev[loader] = (corpus_dev, make_eval_block_scan(
                    self.cfg.model, loader.seq_len, loader.overlap_len,
                    loader.cond_in_seq, mesh=self.mesh, specs=self._specs))
            corpus_dev, eval_scan = self._eval_dev[loader]
            ks = list(range(len(loader)))
            for i in range(0, len(ks), self.scan_block):
                blk_losses, state = eval_scan(self.params, state, corpus_dev,
                                              ks[i:i + self.scan_block])
                losses.append(blk_losses)
            return float(torch.cat(losses).mean()) if losses else 0.0
        dev, lanes = self.device, self._lanes
        for chunk in loader.epoch():
            loss, state = self._eval(
                self.params, state, _on(dev, lanes(chunk.data)), chunk.reset,
                _on(dev, lanes(chunk.target)), _on(dev, lanes(chunk.cond)),
                _on(dev, lanes(chunk.spk)))
            losses.append(loss)
        return float(torch.stack(losses).mean()) if losses else 0.0

    # -- params and checkpoint interface ------------------------------------
    def full_params(self):
        """The full param tree: the live tensors without a mesh, gathered
        over 'model' with one (a collective: every rank calls it)."""
        if self.mesh is None:
            return self.params
        return gather_params(self.mesh, self.params, self._specs)

    def warm_start(self, params):
        """Train from full `params` (weights only): a fresh optimizer
        state; the TBPTT state and the counters stay. Over a mesh every
        rank takes global rank 0's params."""
        if self.mesh is not None:
            params = shard_params(self.mesh, broadcast_tree(params),
                                  self._specs)
        self.params = params
        self.opt_state = self.optimizer.init(params)

    def checkpoint_state(self, sharded: bool = False):
        """The full resumable state (params + optimizer + TBPTT hidden), as
        copies: the steps update the live tensors in place. Over a mesh the
        'model'-sharded leaves and moments and the tier state's lanes are
        gathered (a collective: every rank calls it); with `sharded` they
        are not: every tensor is this rank's storage as a DTensor over the
        mesh (as_dtensors), the form the dcp backend saves and loads."""
        if sharded and self.mesh is not None:
            return self._sharded_state()
        copy = lambda x: x.detach().clone()             # noqa: E731
        params, opt_state, tier = self.params, self.opt_state, self.state
        if self.mesh is not None:
            full = lambda t: gather_params(                 # noqa: E731
                self.mesh, t, self._specs)
            params = full(params)
            opt_state = _map_moments(full, opt_state)
            tier = [gather_lanes(self.mesh, s, axis=1) for s in tier]
        out = {
            "params": tree_map(copy, params),
            "opt_state": _copy_opt_state(opt_state),
            "tier_state": [copy(s) for s in tier],
        }
        if self.is_gan:
            out["disc_params"] = tree_map(copy, self.disc_params)
            out["disc_opt_state"] = _copy_opt_state(self.disc_opt_state)
        return out

    def _sharded_state(self):
        mesh, specs = self.mesh, self._specs
        out = {
            "params": as_dtensors(mesh, self.params, specs),
            "opt_state": _map_moments(
                lambda t: as_dtensors(mesh, t, specs), self.opt_state),
            "tier_state": as_dtensors(mesh, list(self.state), lane_axis=1),
        }
        if self.is_gan:
            out["disc_params"] = as_dtensors(mesh, self.disc_params)
            out["disc_opt_state"] = _map_moments(
                lambda t: as_dtensors(mesh, t), self.disc_opt_state)
        return out

    def restore(self, state, meta):
        """Take a full state (checkpoint_state's layout; over a mesh this
        rank keeps its part), or checkpoint_state(sharded=True)'s, whose
        DTensors hold this rank's part; and the run's counters."""
        from torch.distributed.tensor import DTensor
        sharded = any(isinstance(x, DTensor)
                      for x in tree_leaves(state["params"]))
        if sharded:
            state = local_tensors(state)
        params, opt_state = state["params"], state["opt_state"]
        tier = list(state["tier_state"])
        if self.mesh is not None and not sharded:
            part = lambda t: shard_params(                  # noqa: E731
                self.mesh, t, self._specs)
            params = part(params)
            opt_state = _map_moments(part, opt_state)
            tier = [state_sharding(self.mesh).local(s).contiguous()
                    for s in tier]
        self.params, self.opt_state, self.state = params, opt_state, tier
        if self.is_gan and "disc_params" in state:
            self.disc_params = state["disc_params"]
            self.disc_opt_state = state["disc_opt_state"]
        self.epochs = int(meta.get("epoch", 0))
        self.iterations = int(meta.get("iteration", 0))
        # mid-epoch cursor: next chunk to train within epoch self.epochs+1
        self.start_chunk = int(meta.get("chunk", 0))
