"""Training CLI (`msnv-train-torch`) — the ref train.py:186-325
experiment harness, in the port.

Usage:
  python -m msnv_tpu_torch.cli.train --exp samplernn --frame_sizes 20 4 \
      --datasets_path <dir> --dataset wav/ --cond_set cond/ \
      --seq_len 1040 --batch_size 128 --n_rnn 2 --look_ahead true \
      [--bf16 true] [--device cuda|cpu] [--gru_impl auto|xla|pallas] ...
  torchrun --nproc_per_node N -m msnv_tpu_torch.cli.train ...   # N GPUs

The same arguments as the JAX package's msnv-train, and --qrnn true, which
builds fo-pool QRNN frame tiers (the reference's `qrnn` option) in place of
the GRUs and writes `qrnn:T` into the tag. Builds the corpus
(cached, in the same cache files), the model and the train step, registers
the monitor/validation/saver/stats plugins, resumes from the newest
checkpoint (the JAX trainer's .npz format), and runs to --epoch_limit.
Results land in <results_path>/<experiment tag>/ with the reference's layout
(log, stats.json, loss.svg, checkpoints/, samples/). Runs on `cuda` unless
--device says otherwise; --gru_impl auto runs the tiers' GRU sweeps in the
fused GRU-layer kernels on a CUDA device and as a plain loop on the CPU (the
engine is in neither the tag nor the checkpoint). Every --variant trains:
identity, bottleneck and gan (the two-optimizer step with the speaker
discriminator, whose loss and lambda join the log and stats.json).

Many GPUs: one process per GPU (torch.distributed). Under a launcher whose
environment says WORLD_SIZE > 1 (torchrun; `--multihost true` across
hosts, which requires that environment) the CLI initializes the process
group (NCCL on CUDA, gloo with --device cpu; a group the caller already
made is used as it is), each rank on cuda:LOCAL_RANK, and trains over a
('data', 'model') mesh of world / --n_model_shards by --n_model_shards
(parallel/mesh.py); --batch_size must divide over 'data' (ValueError
otherwise). Every rank draws the params from --seed and the Trainer
makes them rank 0's, so the replicas start equal whatever a rank drew.
Only rank 0 writes the log, stats.json, samples and
checkpoints; the ranks share the results directory and resume from rank
0's newest checkpoint. --ckpt_backend dcp writes `.dcp` directories with
torch.distributed.checkpoint instead, and --ckpt_backend orbax `.orbax`
directories in the JAX package's orbax format (which its
load_checkpoint_orbax restores), every rank its own slices
(training/checkpoint.py); resume takes the newest of all three formats.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from msnv_tpu_torch.config import (DataConfig, ExperimentConfig, ModelConfig,
                                   TrainConfig, make_tag)
from msnv_tpu_torch.data.corpus import CorpusConfig, build_corpus
from msnv_tpu_torch.data.loader import ChunkLoader
from msnv_tpu_torch.utils.logging import init_random_seed, say, tee_stdout


def parse_bool(arg: str) -> bool:
    """Prefix-tolerant bool (ref train.py:334-341)."""
    arg = arg.lower()
    if "true".startswith(arg):
        return True
    if "false".startswith(arg):
        return False
    raise ValueError(arg)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--exp", required=True)
    p.add_argument("--frame_sizes", nargs="+", type=int, default=[20, 4])
    p.add_argument("--n_rnn", type=int, default=1)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--learn_h0", type=parse_bool, default=True)
    p.add_argument("--ulaw", type=parse_bool, default=True)
    p.add_argument("--q_levels", type=int, default=256)
    p.add_argument("--weight_norm", type=parse_bool, default=False)
    p.add_argument("--qrnn", type=parse_bool, default=False,
                   help="fo-pool QRNN frame tiers (ops/qrnn.py; the "
                        "fused fo-pool kernel on a CUDA device) in place "
                        "of the GRUs; written into the experiment's tag")
    p.add_argument("--seq_len", type=int, default=1040)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--look_ahead", type=parse_bool, default=False)
    p.add_argument("--cond_dim", type=int, default=43)
    p.add_argument("--cond_len", type=int, default=80)
    p.add_argument("--norm_ind", type=parse_bool, default=True)
    p.add_argument("--static_spk", type=parse_bool, default=False)
    p.add_argument("--variant", default="identity",
                   choices=["identity", "bottleneck", "gan"])
    p.add_argument("--ind_cond_dim", type=int, default=50)
    p.add_argument("--cond_source", default="ahocoder",
                   choices=["ahocoder", "mel"],
                   help="conditioner front-end: reference Ahocoder tracks "
                        "or the Ahocoder-free log-mel adapter (data/mel.py)")
    p.add_argument("--datasets_path", default="datasets")
    p.add_argument("--cond_path", default=None)
    p.add_argument("--dataset", default="wav/")
    p.add_argument("--cond_set", default="cond/")
    p.add_argument("--results_path", default="results")
    p.add_argument("--epoch_limit", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--resume", type=parse_bool, default=True)
    p.add_argument("--keep_old_checkpoints", type=parse_bool, default=False)
    p.add_argument("--ckpt_backend", default="npz",
                   choices=["npz", "dcp", "orbax"],
                   help="npz: single-file checkpoints (the JAX "
                        "trainer's format), written by rank 0; dcp: "
                        "torch.distributed.checkpoint directories; orbax: "
                        "the JAX trainer's orbax directories (OCDBT + "
                        "zarr); in both every rank writes its slices")
    p.add_argument("--loss_smoothing", type=float, default=0.99)
    p.add_argument("--seed", type=int, default=77977)
    p.add_argument("--scheduler", type=parse_bool, default=False)
    p.add_argument("--model", default=None,
                   help="warm-start checkpoint path")
    p.add_argument("--n_model_shards", type=int, default=1,
                   help="ranks over the mesh's 'model' axis: each stores a "
                        "slice of the wide weights and their Adam moments "
                        "(the world size must divide by it)")
    p.add_argument("--multihost", type=parse_bool, default=False,
                   help="multi-host training: initialize torch.distributed "
                        "from the launcher's environment (RANK, "
                        "WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--save_every_iterations", type=int, default=0,
                   help="mid-epoch checkpoint interval (0 = per epoch only)")
    p.add_argument("--ckpt_every", type=int, default=1,
                   help="save the 'last' checkpoint every N epochs "
                        "(1 = reference parity; >1 skips the per-epoch "
                        "device->host state fetch on small corpora; best-"
                        "on-validation and the final epoch always save)")
    p.add_argument("--device_corpus", default="auto",
                   choices=["auto", "true", "false"],
                   help="keep the packed corpus resident in device "
                        "memory and slice chunks by index (auto: on below "
                        "2 GB)")
    p.add_argument("--metrics_every", type=int, default=0,
                   help="score objective copy-synthesis metrics (MCD, F0 "
                        "RMSE, V/UV error) on fixed validation utterances "
                        "every N epochs (0 = off)")
    p.add_argument("--bf16", type=parse_bool, default=False,
                   help="mixed-precision training (bf16 matmuls, f32 masters)")
    p.add_argument("--show_dataset", type=parse_bool, default=False,
                   help="print chunk shapes for one epoch and exit "
                        "(ref train.py:248-255 debug flag)")
    p.add_argument("--lambda_weight", nargs=3, type=float,
                   default=[0.0, 0.01, 50000.0],
                   help="GAN lambda ramp: start target ramp_steps")
    p.add_argument("--lambda_adaptive", nargs=3, type=float, default=None,
                   metavar=("TARGET_NLL", "GAIN", "MAX_MULT"),
                   help="adaptive GAN lambda controller: scale the ramped "
                        "lambda by exp(GAIN*(TARGET_NLL - disc NLL)), "
                        "clipped to [1/MAX_MULT, MAX_MULT]; keeps the "
                        "reversal pressure alive once the discriminator "
                        "saturates (default: off, fixed ramp)")
    p.add_argument("--disc_channels", type=int, default=512,
                   help="GAN discriminator width (512 = thesis spec; "
                        "shrink for CPU smokes)")
    p.add_argument("--ss_prob", type=float, default=0.0,
                   help="scheduled sampling: replace input samples with "
                        "the model's own teacher-forced predictions with "
                        "this probability (exposure-bias mitigation; "
                        "adds one forward per step)")
    p.add_argument("--input_noise", type=float, default=0.0,
                   help="input-level noise: jitter each input sample by "
                        "up to +-input_noise_levels quantization levels "
                        "with this probability (targets stay clean)")
    p.add_argument("--input_noise_levels", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    p.add_argument("--gru_impl", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="tier GRU sweeps: auto = the fused GRU-layer "
                        "kernels (pallas) on a CUDA device, the plain loop "
                        "(xla) on the CPU")
    return p


def resolve_gru_impl(name: str, device) -> str:
    """--gru_impl auto: "pallas" on a CUDA device, "xla" elsewhere."""
    if name != "auto":
        return name
    return "pallas" if device.type == "cuda" else "xla"


def config_from_args(args, spk_dim: int,
                     gru_impl: str = "xla") -> ExperimentConfig:
    return ExperimentConfig(
        exp=args.exp,
        model=ModelConfig(
            frame_sizes=tuple(args.frame_sizes), n_rnn=args.n_rnn,
            dim=args.dim, learn_h0=args.learn_h0, q_levels=args.q_levels,
            ulaw=args.ulaw, weight_norm=args.weight_norm,
            cond_dim=args.cond_dim, cond_len=args.cond_len, spk_dim=spk_dim,
            look_ahead=args.look_ahead, variant=args.variant,
            ind_cond_dim=args.ind_cond_dim, qrnn=args.qrnn,
            gru_impl=gru_impl),
        train=TrainConfig(
            seq_len=args.seq_len, batch_size=args.batch_size,
            learning_rate=args.learning_rate, epoch_limit=args.epoch_limit,
            loss_smoothing=args.loss_smoothing, seed=args.seed,
            scheduler=args.scheduler,
            keep_old_checkpoints=args.keep_old_checkpoints,
            resume=args.resume,
            lambda_weight=tuple(args.lambda_weight),
            lambda_adaptive=(tuple(args.lambda_adaptive)
                             if args.lambda_adaptive is not None else None),
            disc_channels=args.disc_channels,
            ss_prob=args.ss_prob, input_noise_prob=args.input_noise,
            input_noise_levels=args.input_noise_levels),
        data=DataConfig(
            datasets_path=args.datasets_path,
            cond_path=args.cond_path or args.datasets_path,
            dataset=args.dataset, cond_set=args.cond_set,
            results_path=args.results_path, norm_ind=args.norm_ind,
            static_spk=args.static_spk),
    )



def main(argv=None):
    import torch

    from msnv_tpu_torch.device import float32_convolutions
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                              rank_device)
    from msnv_tpu_torch.training.checkpoint import (CheckpointManager,
                                                    is_sharded_format,
                                                    load_any)
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.plugins import (AbsoluteTimeMonitor, Logger,
                                                 SaverPlugin, StatsPlugin,
                                                 TrainingLossMonitor,
                                                 ValidationPlugin)
    from msnv_tpu_torch.training.trainer import Trainer

    args = build_parser().parse_args(argv)
    device = rank_device(args.device)
    float32_convolutions()       # float32 steps and every validation
    world = init_distributed(args.multihost, device)
    if world % args.n_model_shards:
        raise ValueError(f"--n_model_shards {args.n_model_shards} does not "
                         f"divide the {world} processes")
    n_data = world // args.n_model_shards
    # the lane<->rank assignment must be static for TBPTT state carry
    if world > 1 and args.batch_size % n_data:
        raise ValueError(f"--batch_size {args.batch_size} does not divide "
                         f"over the mesh's 'data' axis of {n_data} ranks")
    init_random_seed(args.seed)

    wav_path = os.path.join(args.datasets_path, args.dataset)
    cond_path = os.path.join(args.cond_path or args.datasets_path,
                             args.cond_set)

    ccfg = CorpusConfig(
        datasets_path=args.datasets_path, wav_path=wav_path,
        cond_path=cond_path,
        overlap_len=int(np.prod(args.frame_sizes)),
        q_levels=args.q_levels, ulaw=args.ulaw, seq_len=args.seq_len,
        batch_size=args.batch_size, cond_dim=args.cond_dim,
        cond_len=args.cond_len, norm_ind=args.norm_ind,
        static_spk=args.static_spk, look_ahead=args.look_ahead,
        cache_dir=os.path.join(args.datasets_path, "npy_datasets"),
        cond_source=args.cond_source)

    corpus = build_corpus(ccfg, "train")
    spk_dim = len(corpus.spk_ids)
    cfg = config_from_args(args, spk_dim,
                           resolve_gru_impl(args.gru_impl, device))
    tag = make_tag(cfg)

    results_path = os.path.join(args.results_path, tag)
    os.makedirs(os.path.join(results_path, "checkpoints"), exist_ok=True)
    os.makedirs(os.path.join(results_path, "samples"), exist_ok=True)
    tee_stdout(os.path.join(results_path, "log"))
    say("experiment tag:", tag)
    say("speakers:", list(corpus.spk_ids))
    say(f"device: {device}; gru_impl: {cfg.model.gru_impl}")

    loader = ChunkLoader(corpus, args.seq_len, ccfg.overlap_len,
                         args.cond_len, args.q_levels, args.ulaw)
    if args.show_dataset:
        for chunk in loader.epoch():
            say(f"chunk {chunk.index}: data {chunk.data.shape} "
                f"target {chunk.target.shape} cond {chunk.cond.shape} "
                f"spk {chunk.spk.shape} reset {chunk.reset}")
        return
    val_loader = test_loader = val_corpus = None
    for part in ("validation", "test"):
        try:
            c = build_corpus(ccfg, part)
            part_loader = ChunkLoader(c, args.seq_len, ccfg.overlap_len,
                                      args.cond_len, args.q_levels,
                                      args.ulaw)
            if part == "validation":
                val_loader, val_corpus = part_loader, c
            else:
                test_loader = part_loader
        except (FileNotFoundError, ValueError) as e:
            say(f"no {part} partition: {e}")

    params = init_params(cfg.model, torch.Generator().manual_seed(args.seed),
                         device=device)
    optimizer = make_optimizer(cfg.train, steps_per_epoch=len(loader))
    mesh = None
    if world > 1:
        mesh = make_mesh(n_data, args.n_model_shards, device=device)
        say(f"mesh: {mesh.shape} over {world} devices")
    compute_dtype = torch.bfloat16 if args.bf16 else None
    trainer = Trainer(cfg, params, optimizer, loader, mesh=mesh,
                      compute_dtype=compute_dtype,
                      device_corpus=args.device_corpus)
    del params
    if trainer._corpus_dev is not None:
        say(f"device-resident corpus: "
            f"{loader.device_bytes() / 1e6:.0f} MB on {device}")

    ckpt_dir = os.path.join(results_path, "checkpoints")
    manager = CheckpointManager(ckpt_dir, args.keep_old_checkpoints,
                                backend=args.ckpt_backend,
                                scheduled=cfg.train.scheduler)

    if args.model:  # warm start (ref train.py:224-233): WEIGHTS only —
        # optimizer moments, TBPTT hidden and counters start fresh, and the
        # checkpoint may come from a run with a different batch size
        state, _ = load_any(args.model, {"params": trainer.full_params()})
        trainer.warm_start(state["params"])
        say("warm-started (params only) from", args.model)
    elif args.resume:
        point = manager.resume_point()
        if point is not None:
            path, epoch, it = point
            state, meta = load_any(
                path, trainer.checkpoint_state(
                    sharded=is_sharded_format(path)))
            trainer.restore(state, meta)
            say(f"resumed from {path} (epoch {epoch}, iteration {it})")

    trainer.register_plugin(TrainingLossMonitor(smoothing=args.loss_smoothing))
    if val_loader is not None:
        trainer.register_plugin(
            ValidationPlugin(val_loader, test_loader or val_loader))
    trainer.register_plugin(AbsoluteTimeMonitor())
    trainer.register_plugin(SaverPlugin(
        manager, every_n_iterations=args.save_every_iterations,
        every_n_epochs=args.ckpt_every))
    log_fields = ["training_loss", "validation_loss", "test_loss", "time"]
    if args.variant == "gan":
        # adversarial diagnostics into the log and the stats.json trajectory
        log_fields += ["disc_loss", "lambda"]
    if args.metrics_every:
        if not args.ulaw:
            # linear mode packs per-utterance-quantized levels, not the
            # waveform — no aligned ground-truth audio to score against
            say("metrics_every requires ulaw=true; skipping objective "
                "metrics")
        else:
            from msnv_tpu_torch.data.corpus import utterance_slices
            from msnv_tpu_torch.training.plugins import ObjectiveMetricsPlugin
            if val_corpus is None:
                say("no validation partition: scoring objective metrics "
                    "on TRAIN utterances (in-sample; expect optimistic "
                    "values)")
            sl = utterance_slices(val_corpus if val_corpus is not None
                                  else corpus, args.cond_len)
            if sl is None:
                say("no scorable utterances; skipping objective metrics")
            else:
                ref_audio, mcond, mspk = sl
                trainer.register_plugin(ObjectiveMetricsPlugin(
                    mcond, mspk, ref_audio, every=args.metrics_every,
                    hop=args.cond_len, compute_dtype=compute_dtype))
                log_fields += ["mcd_db", "f0_rmse_hz", "vuv_error_rate"]
    trainer.register_plugin(Logger(log_fields))
    trainer.register_plugin(StatsPlugin(
        results_path,
        epoch_fields=tuple(f for f in log_fields
                           if f != "training_loss")))

    trainer.run(args.epoch_limit)


if __name__ == "__main__":
    main()
