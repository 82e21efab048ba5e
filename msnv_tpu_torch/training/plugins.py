"""The port's counterpart of the JAX package's training/plugins.py.

Trainer plugins: monitors, validation, checkpointing, stats persistence.

Functional parity with ref trainer/plugins.py:
- TrainingLossMonitor: per-iteration loss with EMA running average
  (smoothing 0.99, ref plugins.py:21-23 + torch monitor semantics)
- ValidationPlugin: val/test NLL-bits per epoch, loss*batch averaged
  (ref plugins.py:26-92)
- AbsoluteTimeMonitor: wall-clock since training start (ref plugins.py:95-110)
- SaverPlugin: last/best checkpoints per epoch (ref plugins.py:113-155),
  backed by CheckpointManager
- Logger: prints selected stat fields per iteration/epoch (torch Logger,
  ref train.py:290-297)
- StatsPlugin: persists stats.json and renders loss.svg
  (ref plugins.py:184-283; json instead of pickle, documented deviation)
- GeneratorPlugin / ObjectiveMetricsPlugin: per-epoch synthesis from fixed
  conditioners. The port's generate_fn reads the weights when it is built
  (cast, fused table, the window kernel's packed weights), and the trainer
  updates them in place, so these plugins build their generator anew on
  every epoch they score: each epoch samples from its own weights.

Under torch.distributed every rank runs every plugin, and only rank 0
writes: the printed lines, stats.json and loss.svg, the sample WAVs, the
scores and the tracker's metrics. Every rank still takes part in the
collectives a plugin's work needs (validation, the checkpoint's gather,
the full params that generation reads).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from msnv_tpu_torch.parallel.mesh import is_main_process


class Plugin:
    #: list of (interval, event) pairs; event in {"iteration", "epoch"}
    schedule = ()
    #: True when iteration() reads trainer params/state/cursor and needs
    #: them EXACTLY as of that iteration — disables the trainer's
    #: loss-fetch pipelining and block scanning for the run
    needs_sync_state = False

    def register(self, trainer):
        self.trainer = trainer

    def iteration(self, *args):
        pass

    def epoch(self, epoch_index: int):
        pass


class Monitor(Plugin):
    """Stat aggregator: last / epoch_mean / running_avg (EMA)."""

    stat_name: str = "stat"

    def __init__(self, smoothing: float = 0.7):
        self.smoothing = smoothing
        self._sum = 0.0
        self._n = 0

    def register(self, trainer):
        super().register(trainer)
        self.stats = trainer.stats.setdefault(self.stat_name, {})
        self.stats.setdefault("log_format", ":.4f")

    def update(self, value: float):
        self.stats["last"] = value
        self._sum += value
        self._n += 1
        ra = self.stats.get("running_avg")
        self.stats["running_avg"] = (
            value if ra is None
            else ra * self.smoothing + value * (1 - self.smoothing))

    def epoch(self, epoch_index: int):
        if self._n:
            self.stats["epoch_mean"] = self._sum / self._n
        self._sum, self._n = 0.0, 0


class TrainingLossMonitor(Monitor):
    stat_name = "training_loss"

    def iteration(self, loss: float):
        self.update(loss)


class ValidationPlugin(Plugin):
    """Per-epoch val/test evaluation (ref plugins.py:26-92)."""

    def __init__(self, val_loader, test_loader):
        self.val_loader = val_loader
        self.test_loader = test_loader

    def register(self, trainer):
        super().register(trainer)
        trainer.stats.setdefault("validation_loss", {"log_format": ":.4f"})
        trainer.stats.setdefault("test_loss", {"log_format": ":.4f"})

    def epoch(self, epoch_index: int):
        t = self.trainer
        t.stats["validation_loss"]["last"] = t.evaluate(self.val_loader)
        t.stats["test_loss"]["last"] = t.evaluate(self.test_loader)


class AbsoluteTimeMonitor(Plugin):
    def register(self, trainer):
        super().register(trainer)
        self.start = time.time()
        trainer.stats.setdefault("time", {"log_format": ":.1f"})

    def iteration(self, loss: float):
        self.trainer.stats["time"]["last"] = time.time() - self.start

    def epoch(self, epoch_index: int):
        self.trainer.stats["time"]["last"] = time.time() - self.start


class SaverPlugin(Plugin):
    """Write last/best checkpoints each epoch via CheckpointManager.

    `every_n_iterations` additionally checkpoints mid-epoch with the exact
    data cursor, so preemption recovery loses at most that many steps —
    a capability the reference lacks (it only saves per epoch and restarts
    Adam/cursor on resume, ref plugins.py:113-155)."""

    def __init__(self, manager, every_n_iterations: int = 0,
                 every_n_epochs: int = 1):
        self.manager = manager
        self.every_n_iterations = every_n_iterations
        # every_n_epochs > 1 thins the per-epoch "last" saves: on small
        # corpora the device->host state fetch (params + Adam moments)
        # dominates epoch wall-clock, and the reference behavior (save
        # every epoch, ref plugins.py:127-136) pays it even when nothing
        # will ever read the intermediate checkpoint. Best checkpoints
        # still land on ANY epoch that improves validation, and the
        # final epoch always saves.
        self.every_n_epochs = max(1, int(every_n_epochs))
        # mid-epoch saves snapshot trainer state per iteration
        self.needs_sync_state = bool(every_n_iterations)

    def iteration(self, loss: float):
        t = self.trainer
        if (self.every_n_iterations and
                t.iterations % self.every_n_iterations == 0):
            self.manager.save_epoch(
                self._state(), t.epochs, t.iterations,
                meta={"tag": t.tag, "chunk": t.chunk_index + 1})

    def epoch(self, epoch_index: int):
        t = self.trainer
        val = t.stats.get("validation_loss", {}).get("last")
        due = (self.every_n_epochs == 1
               or epoch_index % self.every_n_epochs == 0
               or epoch_index == getattr(t, "epoch_limit", epoch_index))
        improved = val is not None and val < self.manager.best_loss
        if not (due or improved):
            return   # skip the device->host state fetch entirely
        self.manager.save_epoch(
            self._state(), epoch_index, t.iterations,
            val_loss=val, meta={"tag": t.tag}, save_last=due)

    def _state(self):
        # the dcp and orbax backends save every rank's storage; npz the
        # gathered full state, which rank 0 writes
        return self.trainer.checkpoint_state(
            sharded=self.manager.backend in ("dcp", "orbax"))


class Logger(Plugin):
    """Print selected stats (torch Logger equivalent, ref train.py:290-297)."""

    def __init__(self, fields, log_epoch: bool = True,
                 log_interval: int = 100):
        self.fields = fields
        self.log_epoch = log_epoch
        self.log_interval = log_interval

    def _line(self):
        parts = []
        for f in self.fields:
            stat = self.trainer.stats.get(f, {})
            v = stat.get("last")
            if v is not None:
                parts.append(f"{f}: {v:.4f}")
            ra = stat.get("running_avg")
            if f == "training_loss" and ra is not None:
                parts.append(f"{f}/running_avg: {ra:.4f}")
        return "\t".join(parts)

    def iteration(self, loss: float):
        if self.trainer.iterations % self.log_interval == 0 \
                and is_main_process():
            print(f"it {self.trainer.iterations}\t{self._line()}", flush=True)

    def epoch(self, epoch_index: int):
        if self.log_epoch and is_main_process():
            print(f"epoch {epoch_index}\t{self._line()}", flush=True)


def _generate_now(trainer, cond, spk, epoch_index, compute_dtype):
    """Audio (numpy) from the trainer's CURRENT weights on rank 0, None on
    the other ranks (which take part in gathering the weights): the
    generator is built for this call (see the module docstring), the draws
    seeded with the epoch. On a CUDA device the bottom tier's windows run
    in the sample-window kernel."""
    import torch
    from msnv_tpu_torch.models.generate import generate_fn
    params = trainer.full_params()
    if not is_main_process():
        return None
    dev = trainer.device
    gen = generate_fn(params, trainer.cfg.model,
                      compute_dtype=compute_dtype,
                      use_kernel=dev.type == "cuda")
    audio, _ = gen(torch.as_tensor(np.asarray(cond), device=dev),
                   torch.as_tensor(np.asarray(spk), device=dev),
                   torch.Generator(device=dev).manual_seed(epoch_index))
    return audio.float().cpu().numpy()


class GeneratorPlugin(Plugin):
    """Per-epoch sample synthesis into results/samples.

    The reference defines this but never registers it, and its signature is
    incompatible with the conditioned Generator (ref plugins.py:158-181,
    SURVEY.md §2.7) — here it actually works: generates `n_samples`
    utterances from fixed conditioners each epoch.
    """

    def __init__(self, samples_path, cond, spk, sample_rate=16000,
                 every=1, compute_dtype=None):
        self.samples_path = samples_path
        self.cond = cond          # (n, frames, cond_dim_eff)
        self.spk = spk            # (n,) int32
        self.sample_rate = sample_rate
        self.every = every
        self.compute_dtype = compute_dtype

    def epoch(self, epoch_index: int):
        if epoch_index % self.every:
            return
        from msnv_tpu_torch.data.wavio import write_wav
        audio = _generate_now(self.trainer, self.cond, self.spk, epoch_index,
                              self.compute_dtype)
        if audio is None:
            return
        os.makedirs(self.samples_path, exist_ok=True)
        for i in range(audio.shape[0]):
            write_wav(os.path.join(
                self.samples_path,
                f"ep{epoch_index}-s{int(np.asarray(self.spk)[i])}-{i}.wav"),
                audio[i], self.sample_rate)


class ObjectiveMetricsPlugin(Plugin):
    """Per-epoch objective copy-synthesis scoring — MCD (dB), F0 RMSE (Hz),
    V/UV error rate (msnv_tpu_torch.eval.metrics).

    New capability: the reference tracks only NLL during training and
    judged quality offline by MOS panels (ref doc/paper.pdf Table 1). This
    generates from FIXED conditioners every `every` epochs and scores the
    output against the natural recordings those conditioners came from
    (see data/corpus.utterance_slices), surfacing the results as trainer
    stats so Logger / StatsPlugin / TensorBoardPlugin pick them up.
    """

    def __init__(self, cond, spk, ref_audio, every: int = 1,
                 sample_rate: int = 16000, hop: int = 80,
                 compute_dtype=None):
        self.cond = cond            # (k, frames, cond_dim_eff)
        self.spk = spk              # (k,) int32
        self.ref_audio = np.asarray(ref_audio)   # (k, frames*hop) float
        self.every = every
        self.sample_rate = sample_rate
        self.hop = hop
        self.compute_dtype = compute_dtype

    #: scored fields; burst_fraction is the thesis-§4.3 saturation-burst
    #: detector (eval/metrics.saturation_bursts) so a run that starts
    #: emitting high-energy noise bursts is visible in stats, not just
    #: audible in samples
    FIELDS = ("mcd_db", "f0_rmse_hz", "vuv_error_rate", "burst_fraction")

    def register(self, trainer):
        super().register(trainer)
        for f in self.FIELDS:
            trainer.stats.setdefault(f, {"log_format": ":.3f"})

    def epoch(self, epoch_index: int):
        t = self.trainer
        if epoch_index % self.every:
            # clear 'last' on unscored epochs so Logger/StatsPlugin record
            # None, not a stale score replayed as if freshly measured
            for f in self.FIELDS:
                t.stats[f]["last"] = None
            return
        from msnv_tpu_torch.eval.metrics import evaluate_pair
        audio = _generate_now(t, self.cond, self.spk, epoch_index,
                              self.compute_dtype)
        if audio is None:
            return
        scores = [evaluate_pair(self.ref_audio[i], audio[i],
                                sr=self.sample_rate, hop=self.hop)
                  for i in range(audio.shape[0])]
        for f in self.FIELDS:
            vals = [s[f] for s in scores if np.isfinite(s[f])]
            if vals:
                t.stats[f]["last"] = float(np.mean(vals))


class TensorBoardPlugin(Plugin):
    """Scalar logging to tensorboardX (ref train.py:263 SummaryWriter)."""

    def __init__(self, log_dir, fields=("training_loss", "validation_loss",
                                        "test_loss")):
        self.fields = fields
        self.writer = None
        if not is_main_process():
            return
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(log_dir=log_dir)
        except Exception:
            self.writer = None

    def iteration(self, loss: float):
        if self.writer is not None:
            self.writer.add_scalar("training_loss", loss,
                                   self.trainer.iterations)

    def epoch(self, epoch_index: int):
        if self.writer is None:
            return
        for f in self.fields:
            v = self.trainer.stats.get(f, {}).get("last")
            if v is not None:
                self.writer.add_scalar(f"epoch/{f}", v, epoch_index)
        self.writer.flush()


class StatsPlugin(Plugin):
    """Persist stats history to stats.json + render loss curves to loss.svg
    (ref plugins.py:184-283; json instead of pickle)."""

    def __init__(self, results_path: str,
                 iteration_fields=("training_loss",),
                 epoch_fields=("validation_loss", "test_loss", "time"),
                 plot: bool = True):
        self.results_path = results_path
        self.iteration_fields = iteration_fields
        self.epoch_fields = epoch_fields
        self.plot = plot
        self.history = {f: [] for f in
                        list(iteration_fields) + list(epoch_fields)}
        self.history["iterations"] = []
        self.history["epochs"] = []

    def iteration(self, loss: float):
        self.history["iterations"].append(self.trainer.iterations)
        for f in self.iteration_fields:
            self.history[f].append(
                self.trainer.stats.get(f, {}).get("last"))

    def epoch(self, epoch_index: int):
        self.history["epochs"].append(epoch_index)
        for f in self.epoch_fields:
            self.history[f].append(
                self.trainer.stats.get(f, {}).get("last"))
        if not is_main_process():
            return
        with open(os.path.join(self.results_path, "stats.json"), "w") as fh:
            json.dump(self.history, fh)
        if self.plot:
            self._render()

    def _render(self):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        fig, ax = plt.subplots(figsize=(8, 5))
        it = self.history["iterations"]
        tl = [v for v in self.history.get("training_loss", []) if v is not None]
        if tl:
            ax.plot(it[:len(tl)], tl, label="training_loss", alpha=0.5)
        eps = self.history["epochs"]
        if eps and it:
            per_epoch_x = np.linspace(0, max(it), len(eps) + 1)[1:]
            for f in ("validation_loss", "test_loss"):
                ys = self.history.get(f, [])
                ys = [y for y in ys if y is not None]
                if ys:
                    ax.plot(per_epoch_x[:len(ys)], ys, label=f, marker="o")
        ax.set_yscale("log")
        ax.set_xlabel("iteration")
        ax.set_ylabel("NLL (bits)")
        ax.legend()
        fig.savefig(os.path.join(self.results_path, "loss.svg"))
        plt.close(fig)


class ExperimentLoggerPlugin(Plugin):
    """Per-epoch metric push to an external experiment tracker.

    Parity with the reference's CometPlugin (ref trainer/plugins.py:286-303
    — defined upstream but never wired into train.py): `experiment` is any
    object with `log_metric(name, value)` and optionally
    `log_epoch_end(epoch_index)` — a comet_ml Experiment satisfies both, as
    does mlflow via a two-line adapter. Fields are stat names, optionally
    (name, stat) with stat in {"last", "epoch_mean", "running_avg"}.
    """

    schedule = ((1, "epoch"),)

    def __init__(self, experiment, fields):
        self.experiment = experiment
        self.fields = [f if isinstance(f, tuple) else (f, "last")
                       for f in fields]

    def epoch(self, epoch_index: int):
        if not is_main_process():
            return
        for field, stat in self.fields:
            value = self.trainer.stats.get(field, {}).get(stat)
            if value is not None:
                self.experiment.log_metric(field, value)
        end = getattr(self.experiment, "log_epoch_end", None)
        if end is not None:
            end(epoch_index)
