#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (msnv_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # on a machine with an H100

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. build    — nvcc builds the sample-window kernels, the GRU-layer
                kernels and the fo-pool kernels from csrc/ (sm_90a), one
                nvcc process each, together
  2. kernel   — the sample-window kernels against the plain version at the
                canonical shape (fs0 20, q 256, dim 1024): float32 (the
                grid kernel by plan: weights in the shared memory of 32
                CTAs, replicated over the card; its counter moves, the
                resident one does not), given noise and Philox, B 1/2/32/
                128/1024: samples equal exactly (TF32 off); bf16 (the
                resident kernel by plan: weights in a cluster's shared
                memory), given noise and Philox, B 1/2/32/128/1024, the
                ragged 3/17/130 and one batch a width of a pass (the
                clusters granted times the width: every width the plan
                may pick, asserted), at the three-tier preset's shape (fs0
                4, dim 512, B 128) and at the narrow (fs0 4, dim 128): on a
                sharpened W_o mismatch <= 1 % (the tensor cores add in
                another order than the plain matmul, which can move a
                near-tie), two runs bit-equal, and at B 128 and 1024 200
                runs in each mode bit-equal to the first (a race shows as
                a rare run that differs), and the same for float32 on the
                grid kernel; a bf16 width that no kernel takes (dim 640)
                is refused on the card in both modes, with no launch
                counted; a bf16 width no cluster holds (dim 2048) takes
                the grid kernel by plan; the Philox
                draws pass a chi-square test against the softmax and are
                the same from the resident kernel, the grid kernel and the
                plain version; times as medians over runs of 10 calls:
                bf16 resident (its passes' width and count) / empty window
                (the exchanges alone, with their bytes) / plain / bound,
                one cluster through one pass at each width (8, 16, 24, 32
                lanes: the cost of a sample step by width) and its empty
                window, the test preset's window (fs0 4, dim 64, one CTA a
                cluster) at B 1, 128 and 1024 and its empty window, the
                bytes a lane's step pushes into its cluster, and float32
                at B 1, 128 and 1024 grid / the grid's empty window (its
                barriers alone) / plain / bound (split TF32, the FMA floor
                beside it); the bounds are the benchmark's
                (h100_bench/flops.py)
  3. generate — full-width `samplernn` from a seeded init: the model stack
                on the card agrees with its teacher-forced predictor and with
                greedy decoding on a small input (float32 windows: the grid
                kernel), then generate_fn with the kernel (bf16, B 128, 16
                frames, T 1), every window through the resident kernel, and
                the same in float32 (generate_fn's default), every window
                through the grid kernel — audio-seconds/second
  4. serve    — VocoderService + make_server on 127.0.0.1 from a JAX-format
                .npz written here: /healthz, two /synthesize, two /stream
                (every window through the resident kernel), bad bodies (400)
  5. gru      — the GRU-layer kernels against their plain versions at
                (T, B, H) = (13, 128, 1024), (52, 128, 1024), the same T at
                B 64 and 16 (the GAN step's and the GAN CLI's batches), the
                ragged (5, 3, 1024), (5, 70, 1024), (4, 70, 128) and
                (3, 8, 256) (partial row tiles; K-slices that arrive in 1, 2
                or 4 chunks), which all take the persistent kernels in
                both types, and (3, 300, 1024), whose grid cannot be
                resident at once and takes the per-step ones:
                forward (ys, hproj) and the reverse sweep (dxp, dhproj, dh0)
                with float32 products (split TF32 persistent kernels and
                the FMA per-step ones; tolerance 1e-4 of the largest
                reference value: another summation order over K = 1024 /
                3072, compounded over T steps) and with bfloat16 products
                on the kernels the plan names (3e-2: a sum
                that differs in its last bits can round h to the
                neighbouring bf16 value, and the next steps carry that on);
                two runs bit-equal, and 200 runs of each persistent sweep
                at (52, 128) and (52, 64) in bf16 and at (52, 128) and
                (13, 128) in float32 bit-equal to the first;
                the autograd.Function (dx_proj, dw, db,
                dh0) in float32 and bfloat16 against autograd through the
                plain forward; a shape the kernels cannot take raises;
                at B 128 in each type, persistent / plain / nn.GRU in the
                same type times, each the median over runs of 10 calls in a
                row (nn.GRU's weights in one cuDNN buffer, any warning in
                its timed calls an error; bf16: the empty sweep, and the
                module as flatten_parameters() leaves it timed beside;
                float32: TF32 off, the FMA floor); the bounds are the
                benchmark's (h100_bench/flops.py). Then the fo-pool kernels
                (QRNN tiers) against their plain versions at B 128, T 52
                and 13, H 1024, in bfloat16 and float32: h, every c_t and
                c_T forward, dg and dc0 backward with and without dc_T
                (bfloat16 outputs to one bf16 ulp, 2^-7 relative; float32
                ones and every float32 cell to 1e-5, absolute and
                relative), two runs bit-equal; times at each shape, kernel
                and plain version, each the better of two medians over
                runs of 10 calls, beside the benchmark's bound
                (h100_bench/flops_qrnn.py)
  6. train    — the train step at full width (B 128, seq_len 1040, bf16
                mixed precision, gru_impl="pallas"): one step with reset,
                six without, on one fixed batch; losses finite and falling,
                4 forward and 4 backward sweeps per step, every one
                through the persistent kernels, params changed,
                carried state detached; ms per step and samples/s; then two
                float32 steps with gru_impl="pallas" against gru_impl="xla"
                from the same weights (cudnn TF32 off: `embed_conv_direct`
                is the only conv and is not on this path); then the default
                float32 train step (no --bf16), one with reset and three
                without: ms per step and samples/s, every sweep through the
                float32 persistent kernels
  7. loop     — the training loop at full width through the port's CLIs
                (`main(argv)` in-process, in a temporary directory under
                msnv_tpu_torch/build/, removed at the end): a synthetic
                corpus of 6 speakers x 25 utterances x ~1000 frames (one
                packing unit: 86 chunks an epoch at B 128, seq_len 1040);
                cli.train (`samplernn` widths, look-ahead, norm_ind, bf16)
                run A to 3 epochs, run B to 2 and resumed to 3: losses
                finite and falling, checkpoints and stats.json written,
                "resumed from", every GRU sweep persistent (the train
                steps' in bf16, the validation's in float32), run B's
                epoch-3 losses equal to run A's (bit for bit, else within
                2e-3 bits); run Q, cli.train --qrnn true to 1 epoch,
                resumed to 2 (the tag names qrnn, losses finite, every
                pool in the fo-pool kernel: 4 launches a step each way,
                4 forward a validation chunk); cli.evaluate on A's last
                checkpoint equal to the
                trainer's last validation loss (1e-4 bits); cli.generate
                --engine auto for 2 utterances: WAV names and lengths, every
                window resident. Corpus build, epoch wall and trainer
                samples/s, checkpoint write/read and size, evaluation wall
                and generation audio-s/s
  8. mux     — the lane-batched /stream multiplexer at full width, bf16,
                from phase 4's .npz: StreamMultiplexer driven directly
                (a masked push leaves the inactive lanes' buffer and hidden
                state bit-equal; 128 streams x 200 frames, then 1024 x 48,
                K 4, mixed speakers and a mix, through per-lane sinks: every
                stream complete and not constant, every window resident,
                windows = ticks x K x 4); then VocoderService(mux_lanes=128)
                behind the asyncio and then the threaded front-end, each
                time 128 concurrent seed-less /stream requests of 200
                frames from a client process of their own (every status
                and byte count; host wall of each push), a seeded /stream
                byte-equal through the asyncio and the threaded front-ends,
                /healthz's mux_lanes and the 429 beyond the lanes. An
                exception in any thread (the pump's above all) fails the
                phase. Ticks, wall per tick, aggregate audio-s/s, per-stream
                realtime factor (min / median), time to first audio
  9. variants — the voice-conversion variants at full width (dim 1024,
                frame sizes (20, 4), n_rnn 2, look-ahead, 6 speakers),
                bf16, gru_impl="pallas": the `samplernn_gan` preset (weight
                norm, ind_cond_dim 50, a 512-channel discriminator) at its
                B 64, seq_len 1040: one step with reset and five without on
                a fixed batch, losses finite, the discriminator moved,
                lambda equal to lambda_ramp at each step index, 4 forward
                and 4 backward persistent GRU sweeps a step; the same first
                step past the ramp moves conditioner.stack[0].w otherwise;
                the discriminator's forward and forward + backward times
                alone; a float32 step (TF32 off) against the two-backward
                form (grad of L1 - lambda L2, then of L2), to 1e-4 of the
                largest gradient, and both forms' bf16 gradient times; the
                same float32 step with cuDNN's TF32 on (PyTorch's default)
                against off: the losses' and gradients' gaps over their
                largest values (the CLIs turn it off: float32_convolutions).
                The `bottleneck` preset at B 128 (two
                steps, the same sweep counts) and `samplernn` with
                qrnn=True at B 128 (two steps, falling loss, no GRU kernel
                launched, one fo-pool launch a layer of a tier each way).
                generate_fn from the GAN and the QRNN model (B
                128, 16 frames) and a B 1 stream of 8 pushes from the GAN
                model, every window resident. cli.train --variant gan (B
                16) to one epoch, resumed to two: disc_loss and lambda in
                stats.json, the discriminator and its Adam state under the
                JAX keys in the checkpoint, every train-step sweep
                persistent; cli.generate from it, every window resident
 10. export  — the serving artifact at full width, bf16, from phase 4's
                .npz: msnv-export-torch --engine pallas --bf16 with
                generation buckets (1, 16) and (128, 16) and stream buckets
                1 and 4 (export wall, file bytes), load_artifact (wall); its
                generation at B 128 equal to generate_fn with the kernel
                from an identically seeded generator, sample for sample, and
                a K=4 push then a 1-frame tail on one carry equal to the
                live pushes; host wall of a B 1 push beside the live one's
                and generation audio-s/s beside live; the push's packing of
                W_h and W_o alone; a torch.profiler trace of one push that
                names the resident kernel; VocoderService(artifact=) over
                HTTP: a seeded /stream and an off-bucket /synthesize
                byte-equal to the live service's, a bucket /synthesize to
                the live generation of the artifact's engine, a mismatched
                artifact refused at startup. Every window of the artifact's
                runs through the resident kernel. Then a float32 artifact
                (--engine pallas without --bf16, one bucket (128, 4)): its
                generation equal to the live float32 generator's for the
                same seed, every window through the grid kernel
 11. mesh    — training and generation over a device mesh
                (torch.distributed, one process per rank), full width:
                a. one process, an NCCL group of world 1: the (1, 1) mesh's
                   train step against no mesh, three bf16 steps at B 128,
                   losses and params bit-equal; sharded generation at B 128
                   x 16 frames bit-equal to generate_fn with the folded
                   generator;
                b. two ranks spawned on the one card over gloo (NCCL takes
                   one rank a GPU; gloo moves CUDA tensors through the
                   host), meshes (2, 1) and (1, 2): two float32 steps (TF32
                   off, gru_impl="pallas") whose losses and reduced
                   gradients (read where Adam reads them) rank 0 holds
                   against one process's unsharded steps on the same B 128
                   batch, to 1e-4 of the largest reference value (phase
                   5's float32 bar), and the params after the first step:
                   to 1e-4 of the largest param where the gradient exceeds
                   1e-4 of its largest (its sign, and so Adam's first
                   step, is fixed there), within 2 lr elsewhere (Adam
                   turns a last-bit difference of a near-zero gradient
                   into up to a whole step); then three bf16 steps, the
                   params (gathered) bit-equal on both ranks after each,
                   4 forward and 4 backward persistent GRU sweeps a step a
                   rank, ms a step a rank (two ranks sharing one card:
                   never a speed-up);
                c. the same ranks: sharded generation (B 128 x 16 frames)
                   and 8 sharded streaming pushes at B 2, each rank's shard
                   equal to a local run on its lanes with the folded
                   generator, every window resident;
                d. one GAN step (`samplernn_gan`, B 64, a 512-channel
                   discriminator, past the lambda ramp) over (2, 1)
                   against one process's unsharded steps, all to 1e-4 of
                   the largest reference value: the metrics against the
                   whole batch's; both reduced float32 gradient trees
                   against the mean of one process's float32 gradients
                   on the two halves of the batch (the lanes each rank
                   takes); both float64 trees (the plain GRU loop)
                   against one process's float64 step on the whole
                   batch. Reported: float32 against the whole batch's
                   float32 gradient, and the ReLU units of the sample MLP
                   that the float32 forwards of 32 and 64 lanes switch
                   differently (one such unit moves a weight gradient
                   element by a whole position's term);
                e. cli.train on both ranks (dim 128, float32, B 128, phase
                   7's corpus, built by rank 0 behind the barrier) to two
                   epochs, then resumed to three: rank 0 writes each
                   checkpoint once, rank 1 none, both resume from the same
                   file, the losses within 1e-3 of one process's on the
                   first five and 5e-2 on all.
                Each rank's K1 / K2 launches come back to the parent; a rank
                that fails or hangs (deadline MESH_TIMEOUT) fails the phase
 12. serve-mesh — serving over a mesh and directory checkpoints, full
                width, from phase 4's .npz:
                a. one process, an NCCL group of world 1, a (1, 1) mesh:
                   8 identical /synthesize requests x 160 frames through
                   the batcher in one group, their WAVs those of
                   generate_fn's 8 lanes with fold_generator(group seed,
                   0); a greedy /synthesize byte-equal to the no-mesh
                   service's (the service's /synthesize is the per-sample
                   path in float32, as without a mesh);
                b. `msnv_tpu_torch.serving --mesh_data 2 --mux_lanes 128`
                   on two gloo ranks sharing the card (spawned as phase 11
                   spawns them): /healthz mesh_shards 2; 4 pairs of
                   identical /synthesize requests (one lane a rank), each
                   pair's WAVs those of one lane with the folded generator
                   of shard 0 and 1, rerun here; 128 concurrent /stream
                   clients x 48 frames from a client process through the
                   mux (64 lanes a rank, bf16, K 4), every one complete,
                   every window of each rank resident; reported, not
                   gated: aggregate audio-s/s, per-stream realtime, first
                   audio;
                c. SIGINT to rank 0: its front stops, STOP reaches rank 1,
                   and both return and exit 0 before the deadline;
                d. the full-width train state (params, Adam moments, tier
                   state at B 128) saved as dcp from a (1, 2) mesh by two
                   gloo ranks, each writing its slices, loaded on (2, 1)
                   and in one process bit-equal to the gathered state
                   (rank 0's .npz of it); write and read seconds and bytes
                   beside the .npz's; then
                   cli.train --ckpt_backend dcp on both ranks over (1, 2)
                   (phase 11e's model at B 32, a corpus of one packing
                   unit, 86 chunks an epoch, no validation): one epoch
                   resumed to two equal to two straight, bit for bit, each
                   rank writing its part of every checkpoint
 13. orbax    — the JAX package's orbax checkpoints, read and written with
                no jax (training/ocdbt.py, training/zstd.py and the
                repository's zstd decoder, csrc/zstd_decode.cc, built with
                the host's C++ compiler):
                a. the committed fixtures that orbax and tensorstore wrote
                   (tests/data/orbax: a JAX Trainer's state, the 8-device
                   sharded layout, two processes) loaded onto the card
                   bit-equal to their .npz twins; the decoder's MB/s over
                   their chunks' zstd frames, on this host;
                b. 12d's full-width train state saved as orbax from a
                   (1, 2) mesh by two gloo ranks, each writing its slices
                   into its own database, loaded on (2, 1) and in one
                   process bit-equal to rank 0's .npz of it; write and read
                   seconds and bytes beside the .npz's and 12d's dcp;
                c. cli.train --ckpt_backend orbax on both ranks over (1, 2)
                   (12d's model and corpus): one epoch resumed to two equal
                   to two straight, bit for bit;
                d. cli.generate from 13c's .orbax and from an .npz of the
                   same weights, greedy and sampled with one seed: the
                   WAVs byte-equal
Then one JSON line of kernel numbers, the card's name and power limit, and
last the {"ok": true, "device": ...} line. The kernels' `launches` add up
the counts of every path that drives them: K1's grid kernel phase 3's
float32 generation and phase 10's float32 artifact, K1's other kernels the
serving path (phase 4),
the generate CLI (phase 7), the multiplexer (phase 8), the variants'
generation, streaming and generate CLI (phase 9) and the artifact's
generation, pushes and service (phase 10), sharded generation and
streaming (phase 11), the mux over a serving mesh on both ranks (phase
12) and the generate CLI from an orbax checkpoint (phase 13), K2 the train
steps (phase 6), the training loop (phase 7), the variants' train steps
and train CLI (phase 9), the sharded steps and cli.train of every rank
(phase 11) and cli.train with dcp (phase 12) and orbax checkpoints (phase
13) on both ranks, each count set to 0 just before its path and read just
after.

`--rehearse-cpu` runs the same phases on the CPU at dim 32 with the plain
versions (no build, no timing on the card; phase 7 at B 4 on a small
corpus; phase 8 with 4 and 8 lanes; phase 9 at B 4, seq_len 320 and an
8-channel discriminator; phase 10 at B 2; phase 11 with gloo CPU ranks at
B 4; phase 12 with gloo CPU ranks, 8 mux lanes and a B 4 state; phase 13
likewise) and ends without the ok line. `--phases=5,6`, `--phases=7`,
`--phases=8`, `--phases=9`, `--phases=10`, `--phases=11`, `--phases=12`
or `--phases=13` runs only the named phases (and then prints no result
line).
"""

from __future__ import annotations

import base64
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

from h100_bench import peaks
from h100_bench.flops import gru_sweep_bound_s, window_bound_s
from h100_bench.flops_qrnn import pool_bound_s

REPO = os.path.dirname(os.path.abspath(__file__))
FS0, Q, DIM = 20, 256, 1024
# The bounds (K1 and K2) are the benchmark's (h100_bench/flops.py): a
# float32 one at the split-TF32 rate, the fastest the card computes float32
# products at. The CUDA cores' FMA rate (H100 SXM data sheet) is printed
# beside it as a floor of the CUDA cores alone.
FMA_FLOPS = 67e12
RESULTS = {}
REPEAT_RUNS = 200           # phase 2: runs of a window on the same inputs


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=3, batch=1):
    """Median per-call device time from CUDA events around `batch` calls
    in a row. With batch 1 a call's time includes what the host takes to
    launch it on an idle card; a longer run hides that behind the calls
    before, as a train step does."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


# --------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# --------------------------------------------------------------------------

def window_fma_floor_ms(batch, fs0=FS0, q=Q, dim=DIM):
    """A float32 window's products at the CUDA cores' FMA peak."""
    return batch * fs0 * (2 * (dim * dim + dim * q) + fs0 * dim) \
        / FMA_FLOPS * 1e3


def kernel_inputs(params, batch, dtype, seed):
    import torch
    from msnv_tpu_torch.models.generate import fused_embed_conv
    from msnv_tpu_torch.ops.linear import dense_weight
    dev = params["mlp"]["embedding"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    fused = fused_embed_conv(params["mlp"])
    fs0, q, dim = fused.shape
    table = fused.reshape(fs0 * q, dim).to(dtype).contiguous()
    wh = dense_weight(params["mlp"]["hidden"]).T.to(dtype).contiguous()
    wo = dense_weight(params["mlp"]["out"]).T.to(dtype).contiguous()
    bh = 0.1 * torch.randn(dim, generator=g, device=dev)
    bo = 0.1 * torch.randn(q, generator=g, device=dev)
    slots = torch.randn(batch, fs0, dim, generator=g, device=dev).to(dtype)
    buf = torch.randint(0, q, (batch, fs0), generator=g, device=dev,
                        dtype=torch.int32)
    return table, wh, bh, wo, bo, slots, buf, g


def random_window_inputs(fs0, q, dim, batch, dtype, dev, seed):
    """Window inputs at a shape no preset has, from a seed."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa
    table = (rn(fs0 * q, dim) / math.sqrt(fs0)).to(dtype)
    wh = (rn(dim, dim) / math.sqrt(dim)).to(dtype)
    wo = (rn(dim, q) / math.sqrt(dim)).to(dtype)
    buf = torch.randint(0, q, (batch, fs0), generator=g, device=dev,
                        dtype=torch.int32)
    return (table, wh, 0.1 * rn(dim), wo, 0.1 * rn(q),
            rn(batch, fs0, dim).to(dtype), buf, g)


def sharpened(wo, bo, dtype):
    """W_o and b_o times 100: the argmax dominates the noise, so that a
    sum taken in another order moves a draw only at a near-tie."""
    return (wo.float() * 100).to(dtype), bo * 100


RAGGED = (3, 17, 130)
# a width no kernel takes (no cluster splits dim 640 in tiles of 16
# columns, no power-of-two CTA slice holds it): the card refuses it
ODD_DIM = 640


def phase_kernel(params, batches, narrow):
    import torch
    from msnv_tpu_torch.kernels import sample_window as sw
    dev = params["mlp"]["embedding"].device
    on_card = dev.type == "cuda"
    bf16 = torch.bfloat16
    max_err = 0
    counts = lambda: (sw.sample_window.launches,              # noqa: E731
                      sw.sample_window.resident, sw.sample_window.grid)
    # given noise, f32: exact equality with the plain version, on the grid
    # kernel (which the plan names for float32)
    f32_batches = tuple(batches) + ((1024,) if on_card else ())
    for batch in f32_batches:
        table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
            params, batch, torch.float32, seed=batch)
        noise = sw.gumbel_noise((batch, FS0, Q), g, dev)
        want = sw.sample_window_reference(table, wh, bh, wo, bo, slots, buf,
                                          noise)
        before = counts()
        got = sw.sample_window(table, wh, bh, wo, bo, slots, buf,
                               noise=noise)
        if on_card and counts() != (before[0] + 1, before[1],
                                    before[2] + 1):
            raise AssertionError(f"float32 B={batch} did not take the grid "
                                 f"kernel by plan: {counts()} after "
                                 f"{before}")
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(
                f"f32 grid kernel != plain at B={batch}: "
                f"{float((got != want).float().mean()):.4%} differ")
        log(f"[kernel] f32 given-noise B={batch}: the grid kernel by plan "
            f"equal to the plain version")

    # bf16 (the resident kernel by plan), given noise and Philox, sharpened
    # W_o: mismatch <= 1 %. Not exact: the tensor cores add a column's
    # products in another order than the plain version's matmul, which can
    # move a near-tie, and a lane that differs once differs from there on.
    # At the canonical shape (whole and ragged batches, and on a card one
    # whose clusters each take a pass of each width the plan may pick: the
    # clusters granted times the width), at the three-tier preset's (fs0 4,
    # dim 512, B 128) and at a narrow one.
    if on_card:
        limits = sw.device_limits(dev, FS0, Q, DIM, bf16)
        widths = sw.resident_widths(FS0, Q, DIM, sw.resident_cluster(
            FS0, Q, DIM, limits[1]), limits[1])
        per_width = tuple(limits[0] * w for w in widths)

    def bf16_cases():
        for batch in tuple(batches) + ((1024,) + RAGGED + per_width
                                       if on_card else ()):
            yield (FS0, Q, DIM, batch) + kernel_inputs(
                params, batch, bf16, seed=100 + batch)
        if on_card:
            yield (4, Q, 512, 128) + random_window_inputs(
                4, Q, 512, 128, bf16, dev, seed=140)
        fs0, q, dim = narrow
        for batch in (1, 32) + RAGGED[:2] if on_card else (3,):
            yield (fs0, q, dim, batch) + random_window_inputs(
                fs0, q, dim, batch, bf16, dev, seed=150 + batch)

    philox = {}
    worst = 0.0
    covered = set()       # widths of the passes at the canonical shape
    for fs0, q, dim, batch, table, wh, bh, wo, bo, slots, buf, g in \
            bf16_cases():
        wo, bo = sharpened(wo, bo, bf16)
        noise = sw.gumbel_noise((batch, fs0, q), g, dev)
        seed = torch.randint(0, 2 ** 62, (1,), generator=g, device=dev,
                             dtype=torch.int64)
        args = (table, wh, bh, wo, bo, slots, buf)
        before = counts()
        results = {}
        for mode, kw, given in (
                ("given noise", {"noise": noise}, noise),
                ("Philox", {"seed": seed},
                 sw.philox_gumbel_noise(seed, batch, fs0, q))):
            want = sw.sample_window_reference(*args, given)
            got = sw.sample_window(*args, **kw)
            again = sw.sample_window(*args, **kw)
            if not torch.equal(got, again):
                raise AssertionError(f"two runs differ at B={batch} {mode}")
            results[mode] = float((got != want).float().mean())
        if on_card and counts() != (before[0] + 4, before[1] + 4, before[2]):
            raise AssertionError(f"bf16 at dim {dim} did not take the "
                                 f"resident kernel")
        width = ""
        if on_card:
            plan = sw._plan_on(dev, batch, fs0, q, dim, bf16)
            width = (f" (passes of {plan.subtile} on {plan.clusters} "
                     f"clusters)")
            if (fs0, q, dim) == (FS0, Q, DIM):
                covered.add(plan.subtile)
        log(f"[kernel] bf16 sharpened (fs0 {fs0}, dim {dim}) B={batch}"
            f"{width}: mismatch vs plain, given noise "
            f"{results['given noise']:.4%}, Philox {results['Philox']:.4%}; "
            f"two runs bit-equal")
        worst = max(worst, *results.values())
        if dim == DIM:
            philox[f"bfloat16_B{batch}"] = results["Philox"]
        if max(results.values()) > 0.01:
            raise AssertionError(f"bf16 mismatch {results} > 1 %")
    if on_card and covered != set(widths):
        raise AssertionError(f"the bf16 windows ran passes of {covered}, "
                             f"the plan may pick {widths}")
    # Philox mode in float32 (the grid kernel by plan): exact
    for batch in f32_batches:
        table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
            params, batch, torch.float32, seed=300 + batch)
        seed = torch.randint(0, 2 ** 62, (1,), generator=g, device=dev,
                             dtype=torch.int64)
        want = sw.sample_window_reference(
            table, wh, bh, wo, bo, slots, buf,
            sw.philox_gumbel_noise(seed, batch, FS0, Q))
        before = counts()
        got = sw.sample_window(table, wh, bh, wo, bo, slots, buf, seed=seed)
        if on_card and counts() != (before[0] + 1, before[1],
                                    before[2] + 1):
            raise AssertionError(f"float32 Philox B={batch} did not take "
                                 f"the grid kernel by plan")
        max_err = max(max_err, int((got - want).abs().max()))
        philox[f"float32_B{batch}"] = float((got != want).float().mean())
        log(f"[kernel] Philox float32 B={batch}: mismatch vs plain "
            f"{philox[f'float32_B{batch}']:.4%}")
        if philox[f"float32_B{batch}"]:
            raise AssertionError("f32 Philox kernel != plain")
    RESULTS["grid_max_abs_err"] = max_err
    RESULTS["bf16_mismatch"] = worst
    RESULTS["philox_mismatch"] = philox
    if not on_card:
        return

    # many runs on the same inputs, bf16 (resident) and float32 (grid),
    # both modes: every one bit-equal to the first (a race shows as a rare
    # run that differs; counted on the card, no synchronize between the
    # launches)
    for dtype in (bf16, torch.float32):
        for batch in (128, 1024):
            table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
                params, batch, dtype, seed=400 + batch)
            args = (table, wh, bh, wo, bo, slots, buf)
            packed = sw.resident_weights(wh, wo, FS0)
            seed = torch.randint(0, 2 ** 62, (1,), generator=g, device=dev,
                                 dtype=torch.int64)
            before = counts()
            for mode, kw in (("given noise", {"noise": sw.gumbel_noise(
                    (batch, FS0, Q), g, dev)}), ("Philox", {"seed": seed})):
                first = sw.sample_window(*args, packed=packed, **kw)
                differ = torch.zeros((), dtype=torch.int64, device=dev)
                for _ in range(REPEAT_RUNS):
                    differ += (sw.sample_window(*args, packed=packed, **kw)
                               != first).any()
                if int(differ):
                    raise AssertionError(f"{int(differ)} of {REPEAT_RUNS} "
                                         f"runs differ at B={batch} {mode} "
                                         f"({dtype})")
            runs = 2 * (REPEAT_RUNS + 1)
            want = ((before[0] + runs, before[1] + runs, before[2])
                    if dtype == bf16
                    else (before[0] + runs, before[1], before[2] + runs))
            if counts() != want:
                raise AssertionError(f"{dtype} B={batch}: counts {counts()}"
                                     f", expected {want}")
            log(f"[kernel] {str(dtype)[6:]} B={batch}: {REPEAT_RUNS} runs "
                f"in each mode bit-equal to the first "
                f"({'resident' if dtype == bf16 else 'grid'} kernel)")

    # what the card grants, and a width that no cluster holds
    held, smem, _ = sw.device_limits(dev, FS0, Q, DIM, bf16)
    plan = sw.window_plan(128, FS0, Q, DIM, bf16, held, smem)
    f32_limits = sw.device_limits(dev, FS0, Q, DIM, torch.float32)
    f32_plan = sw.window_plan(128, FS0, Q, DIM, torch.float32, *f32_limits)
    if plan.path != "resident":
        raise AssertionError("no cluster of the resident kernel is granted")
    if f32_plan.path != "grid":
        raise AssertionError("the card grants no grid of the grid kernel")
    RESULTS["window_plan"] = {"max_clusters": held, "cluster": plan.cluster,
                              "smem_bytes": plan.smem_bytes,
                              "smem_limit": smem,
                              "grid_ctas_f32": f32_limits[2],
                              "grid_groups_f32": f32_plan.cluster,
                              "grid_replicas_f32_B128": f32_plan.clusters,
                              "grid_smem_bytes_f32": f32_plan.smem_bytes}
    log(f"[kernel] the card holds {held} clusters of {plan.cluster} CTAs of "
        f"the resident kernel at once, {plan.smem_bytes} of {smem} bytes of "
        f"shared memory each; B=128: {plan}; float32: {f32_limits[2]} CTAs "
        f"of the grid kernel, B=128: {f32_plan}")
    wide = random_window_inputs(4, Q, 2 * DIM, 5, bf16, dev, seed=9)
    wo, bo = sharpened(wide[3], wide[4], bf16)
    args = wide[:3] + (wo, bo) + wide[5:7]
    noise = sw.gumbel_noise((5, 4, Q), wide[7], dev)
    before = counts()
    got = sw.sample_window(*args, noise=noise)
    mismatch = float((got != sw.sample_window_reference(
        *args, noise)).float().mean())
    if counts() != (before[0] + 1, before[1], before[2] + 1) \
            or mismatch > 0.01:
        raise AssertionError(f"dim {2 * DIM} bf16: counts {counts()} after "
                             f"{before}, mismatch {mismatch:.4%}")
    log(f"[kernel] dim {2 * DIM} bf16 takes the grid kernel by plan "
        f"(mismatch {mismatch:.4%})")
    # a width no kernel takes is refused, in both modes, and launches
    # nothing
    odd = random_window_inputs(4, Q, ODD_DIM, 5, bf16, dev, seed=11)
    before = counts()
    for kw in ({"noise": sw.gumbel_noise((5, 4, Q), odd[7], dev)},
               {"seed": torch.tensor([13], dtype=torch.int64, device=dev)}):
        try:
            sw.sample_window(*odd[:7], **kw)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError(f"dim {ODD_DIM} bf16 was not refused")
    if counts() != before:
        raise AssertionError(f"dim {ODD_DIM} bf16: counts {counts()} after "
                             f"{before}")
    log(f"[kernel] dim {ODD_DIM} bf16, both modes: {refused}")

    # Philox: chi-square of ~1e5 draws from a fixed logits row, resident
    g = torch.Generator(device=dev).manual_seed(7)
    lanes = 1024
    logits = 0.8 * torch.randn(Q, generator=g, device=dev)
    zeros = dict(table=torch.zeros(FS0 * Q, DIM, device=dev, dtype=bf16),
                 wh=torch.zeros(DIM, DIM, device=dev, dtype=bf16),
                 bh=torch.zeros(DIM, device=dev),
                 wo=torch.zeros(DIM, Q, device=dev, dtype=bf16), bo=logits,
                 slots=torch.zeros(lanes, FS0, DIM, device=dev, dtype=bf16),
                 buf=torch.zeros(lanes, FS0, dtype=torch.int32, device=dev))
    counts_q = torch.zeros(Q, dtype=torch.float64, device=dev)
    for s in range(5):
        seed = torch.tensor([1000 + s], dtype=torch.int64, device=dev)
        draws = sw.sample_window(*zeros.values(), seed=seed)
        counts_q += torch.bincount(draws.flatten().long(), minlength=Q)
    n = float(counts_q.sum())
    expected = n * torch.softmax(logits.double(), 0)
    chi2 = float(((counts_q - expected) ** 2 / expected).sum())
    dof = Q - 1
    # Wilson-Hilferty: chi2/dof ~ N(1 - 2/(9 dof), 2/(9 dof)); 6 sigma
    limit = dof * (1 - 2 / (9 * dof) + 6 * math.sqrt(2 / (9 * dof))) ** 3
    log(f"[kernel] Philox chi-square over {int(n)} draws: {chi2:.1f} "
        f"(dof {dof}, limit {limit:.1f})")
    if chi2 > limit:
        raise AssertionError(f"Philox draws fail chi-square: {chi2:.1f}")
    # the same draws whatever the kernel: the resident kernel (bf16), the
    # grid kernel (float32) and the plain version (zero weights: the
    # logits are b_o in both types)
    seed = torch.tensor([99], dtype=torch.int64, device=dev)
    zeros32 = {k: (v.float() if v.dtype == bf16 else v)
               for k, v in zeros.items()}
    before = counts()
    draws = [sw.sample_window(*zeros.values(), seed=seed),
             sw.sample_window(*zeros32.values(), seed=seed)]
    if counts() != (before[0] + 2, before[1] + 1, before[2] + 1):
        raise AssertionError(f"the zero-weight windows took {counts()} "
                             f"after {before}")
    plain = sw.sample_window_reference(
        *zeros32.values(), sw.philox_gumbel_noise(seed, lanes, FS0, Q))
    if any(not torch.equal(d, plain) for d in draws):
        raise AssertionError("Philox draws depend on the kernel")
    log(f"[kernel] Philox draws identical from the resident kernel ({held} "
        f"clusters granted), the grid kernel and the plain version")

    # times: bf16, Philox mode (what generation and /stream run) and given
    # noise; medians over runs of 10 calls, the better of two
    run = {"iters": 5, "batch": 10}
    shapes = []
    for batch in sorted(set(batches) | {1024}):
        table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
            params, batch, bf16, seed=200 + batch)
        args = (table, wh, bh, wo, bo, slots, buf)
        packed = sw.resident_weights(wh, wo, FS0)
        seed = torch.tensor([5], dtype=torch.int64, device=dev)
        noise = sw.gumbel_noise((batch, FS0, Q), g, dev)
        resident = lambda **kw: sw.sample_window(        # noqa: E731
            *args, packed=packed, **kw)
        ms = min(cuda_ms(lambda: resident(seed=seed), **run)
                 for _ in range(2))
        alone = cuda_ms(lambda: resident(seed=seed), 20)
        empty = cuda_ms(lambda: sw.empty_window(batch, FS0, Q, DIM, dev),
                        **run)
        plain = cuda_ms(lambda: sw.sample_window_reference(*args, noise), 5)
        bound = window_bound_s(batch, FS0, Q, DIM, "bfloat16") * 1e3
        # the given-noise mode (the TPU's v1 kernel): noise read from memory
        noise_ms = cuda_ms(lambda: resident(noise=noise), **run)
        plan = sw.window_plan(batch, FS0, Q, DIM, bf16, held, smem)
        row = {"batch": batch, "dtype": "bfloat16", "mode": "philox",
               "path": plan.path, "cluster": plan.cluster,
               "clusters": plan.clusters,
               "lanes_per_cluster": plan.lanes_per_cluster,
               "width": plan.subtile, "passes": sw.plan_passes(plan),
               "push_kib_per_lane_step": sw.resident_push_bytes(
                   Q, DIM, plan.cluster) / 1024,
               "ms": ms,
               "alone_ms": alone, "empty_window_ms": empty,
               "plain_ms": plain, "bound_ms": bound,
               "given_noise_ms": noise_ms}
        shapes.append(row)
        log(f"[kernel] B={batch} bf16: resident {ms:.4f} ms/window "
            f"({plan.clusters} clusters of {plan.cluster}, passes of "
            f"{plan.subtile} lanes, {sw.plan_passes(plan)} a cluster; "
            f"{ms / FS0 * 1e3:.1f} us/sample; one call alone {alone:.4f}), "
            f"empty window {empty:.4f}, plain {plain:.4f}, bound "
            f"{bound:.5f}; given noise {noise_ms:.4f}")
    RESULTS["shapes"] = shapes
    RESULTS["tiny_shapes"] = tiny_window_times(dev, run)
    RESULTS["widths"] = width_times(params, held, smem, run)
    RESULTS["f32_shapes"] = f32_window_times(params, run)


# the test preset's window (tiny_unconditional: fs0 4, q 256, dim 64): one
# CTA a cluster, whose partial logits (4 q bytes a lane) outweigh its x
TINY = (4, 256, 64)


def tiny_window_times(dev, run):
    """Phase 2's rows at the test preset's shape, bf16, Philox mode: the
    resident kernel (weights packed once), the better of two runs, and its
    empty window, at B 1, 128 and 1024."""
    import torch
    from msnv_tpu_torch.kernels import sample_window as sw
    fs0, q, dim = TINY
    rows = []
    for batch in (1, 128, 1024):
        table, wh, bh, wo, bo, slots, buf, g = random_window_inputs(
            fs0, q, dim, batch, torch.bfloat16, dev, seed=600 + batch)
        packed = sw.resident_weights(wh, wo, fs0)
        seed = torch.tensor([5], dtype=torch.int64, device=dev)
        resident = lambda: sw.sample_window(                  # noqa: E731
            table, wh, bh, wo, bo, slots, buf, seed=seed,     # noqa: B023
            packed=packed)                                     # noqa: B023
        ms = min(cuda_ms(resident, **run) for _ in range(2))
        empty = cuda_ms(lambda: sw.empty_window(              # noqa: B023
            batch, fs0, q, dim, dev), **run)
        plan = sw._plan_on(dev, batch, fs0, q, dim, torch.bfloat16)
        rows.append({"batch": batch, "fs0": fs0, "q": q, "dim": dim,
                     "cluster": plan.cluster, "clusters": plan.clusters,
                     "width": plan.subtile, "passes": sw.plan_passes(plan),
                     "push_kib_per_lane_step": sw.resident_push_bytes(
                         q, dim, plan.cluster) / 1024,
                     "ms": ms, "empty_window_ms": empty})
        log(f"[kernel] dim {dim} (fs0 {fs0}) B={batch} bf16: resident "
            f"{ms:.4f} ms/window ({plan.clusters} clusters of "
            f"{plan.cluster}, passes of {plan.subtile}), empty window "
            f"{empty:.4f}")
    return rows


def width_times(params, held, smem, run):
    """One cluster through a window of as many lanes as a pass holds, at
    each width: the resident kernel (launched with that width, past the
    plan) and its empty window (the exchanges alone, with their bytes),
    per window and per sample step."""
    import torch
    from msnv_tpu_torch.kernels import sample_window as sw
    dev = params["mlp"]["embedding"].device
    lib = sw.build()
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa
    cluster = sw.resident_cluster(FS0, Q, DIM, smem)
    rows = []
    for width in sw.resident_widths(FS0, Q, DIM, cluster, smem):
        table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
            params, width, torch.bfloat16, seed=700 + width)
        packed = sw.resident_weights(wh, wo, FS0)
        seed = torch.tensor([5], dtype=torch.int64, device=dev)
        out = torch.empty((width, FS0), dtype=torch.int32, device=dev)

        def resident():
            err = lib.sample_window_resident_launch(
                table.data_ptr(), packed.data_ptr(), bh.data_ptr(),
                bo.data_ptr(), slots.data_ptr(), buf.data_ptr(), None,
                seed.data_ptr(), out.data_ptr(), width, FS0, Q, DIM,
                buf.stride(0), slots.stride(0), slots.stride(1), cluster, 1,
                width, stream())
            sw._raise_on(lib, err, f"width {width} launch")

        def empty():
            err = lib.sample_window_empty_launch(width, FS0, Q, DIM, cluster,
                                                 1, width, stream())
            sw._raise_on(lib, err, f"width {width} empty window")
        ms = min(cuda_ms(resident, **run) for _ in range(2))
        empty_ms = cuda_ms(empty, **run)
        rows.append({"width": width, "lanes": width, "clusters": 1,
                     "ms": ms, "step_us": ms / FS0 * 1e3,
                     "empty_window_ms": empty_ms,
                     "empty_step_us": empty_ms / FS0 * 1e3,
                     "smem_bytes": sw.resident_smem_bytes(FS0, Q, DIM,
                                                          cluster, width)})
        log(f"[kernel] one cluster of {cluster}, {width} lanes in one pass "
            f"of {width}: {ms:.4f} ms/window, {ms / FS0 * 1e3:.2f} us a "
            f"sample step; empty window {empty_ms:.4f} ms "
            f"({empty_ms / FS0 * 1e3:.2f} us a step)")
    return rows


def f32_window_times(params, run):
    """Phase 2's float32 rows, Philox mode: the grid kernel (by plan,
    weights packed once), the better of two runs; its empty window (the
    grid barriers alone), the plain version, the bound (split TF32; the
    FMA rate's in the log line)."""
    import torch
    from msnv_tpu_torch.kernels import sample_window as sw
    dev = params["mlp"]["embedding"].device
    rows = []
    for batch in (1, 128, 1024):
        table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
            params, batch, torch.float32, seed=500 + batch)
        args = (table, wh, bh, wo, bo, slots, buf)
        packed = sw.resident_weights(wh, wo, FS0)
        seed = torch.tensor([5], dtype=torch.int64, device=dev)
        noise = sw.philox_gumbel_noise(seed, batch, FS0, Q)
        grid = lambda: sw.sample_window(                      # noqa: E731
            *args, seed=seed, packed=packed)
        ms = min(cuda_ms(grid, **run) for _ in range(2))
        alone = cuda_ms(grid, 20)
        empty = cuda_ms(lambda: sw.empty_window(              # noqa: B023
            batch, FS0, Q, DIM, dev, torch.float32), **run)
        plain = cuda_ms(lambda: sw.sample_window_reference(   # noqa: B023
            *args, noise), 5)
        bound = window_bound_s(batch, FS0, Q, DIM, "float32") * 1e3
        fma = window_fma_floor_ms(batch)
        limits = sw.device_limits(dev, FS0, Q, DIM, torch.float32)
        plan = sw.window_plan(batch, FS0, Q, DIM, torch.float32, *limits)
        row = {"batch": batch, "dtype": "float32", "mode": "philox",
               "path": plan.path, "groups": plan.cluster,
               "replicas": plan.clusters, "tile": plan.subtile, "ms": ms,
               "alone_ms": alone, "empty_window_ms": empty,
               "plain_ms": plain, "bound_ms": bound,
               "fma_floor_ms": fma}
        rows.append(row)
        log(f"[kernel] B={batch} float32: grid {ms:.4f} ms/window "
            f"({plan.clusters} replicas of {plan.cluster} CTAs, tile "
            f"{plan.subtile}; {ms / FS0 * 1e3:.1f} us/sample; one call "
            f"alone {alone:.4f}), empty window {empty:.4f}; plain "
            f"{plain:.4f}, bound {bound:.5f} (split TF32; the FMA floor "
            f"{fma:.5f})")
    return rows


# --------------------------------------------------------------------------
# phase 3: full-width generation
# --------------------------------------------------------------------------

def phase_generate(params, cfg, batch, frames):
    import torch
    from msnv_tpu_torch.kernels.sample_window import sample_window
    from msnv_tpu_torch.models.generate import (generate_fn,
                                                teacher_forced_log_probs)
    from msnv_tpu_torch.models.samplernn import (init_tier_state,
                                                 predictor_apply)
    dev = params["mlp"]["embedding"].device
    g = torch.Generator(device=dev).manual_seed(3)
    C = cfg.effective_cond_dim
    # the model stack on this device against its own predictor: the
    # teacher-forced generation machinery equals predictor_apply
    cond = torch.rand(2, 2, C, generator=g, device=dev)
    spk = torch.tensor([0, 5], device=dev)
    forced = torch.randint(0, cfg.q_levels, (2, 2 * cfg.lookback),
                           generator=g, device=dev)
    lp_tf = teacher_forced_log_probs(params, cfg)(cond, spk, forced)
    seed_buf = torch.full((2, cfg.lookback), cfg.q_levels // 2,
                          dtype=forced.dtype, device=dev)
    full = torch.cat([seed_buf, forced], 1)[:, :-1]
    with torch.no_grad():
        lp_pred, _, _ = predictor_apply(
            params, cfg, full, True, cond, spk,
            init_tier_state(cfg, 2, device=dev))
    err = float((lp_tf - lp_pred).abs().max())
    log(f"[generate] teacher-forced vs predictor log-probs: max |diff| "
        f"{err:.2e}")
    if not err < 5e-4:
        raise AssertionError(f"teacher forcing differs by {err}")
    # the kernel path on a sharpened output layer reproduces greedy
    sharp = dict(params, mlp=dict(params["mlp"], out={
        "w": params["mlp"]["out"]["w"] * 1e4,
        "b": params["mlp"]["out"]["b"] * 1e4}))
    _, seq_g = generate_fn(sharp, cfg, temperature=0.0)(cond, spk)
    _reset_window_counts()                  # the float32 kernel path
    _, seq_k = generate_fn(sharp, cfg, use_kernel=True)(
        cond, spk, torch.Generator(device=dev).manual_seed(1))
    sharp_launches = sample_window.launches
    windows = 2 * cfg.frame_sizes[-1]
    if dev.type == "cuda" and (sharp_launches, sample_window.grid) != (
            windows, windows):
        raise AssertionError("the float32 kernel path's windows did not all "
                             "take the grid kernel")
    mismatch = float((seq_k != seq_g).float().mean())
    log(f"[generate] kernel path (float32, grid kernel) vs greedy on "
        f"sharpened logits: mismatch {mismatch:.4%}")
    if not mismatch < 0.02:
        raise AssertionError(f"kernel path mismatch {mismatch:.4%}")

    gen = generate_fn(params, cfg, compute_dtype=torch.bfloat16,
                      use_kernel=True, temperature=1.0)
    cond = torch.rand(batch, frames, C, generator=g, device=dev)
    spk = torch.randint(0, cfg.spk_dim, (batch,), generator=g, device=dev)
    gen(cond[:, :1], spk, torch.Generator(device=dev).manual_seed(0))  # warm
    before = (sample_window.launches, sample_window.resident)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, seq = gen(cond, spk, torch.Generator(device=dev).manual_seed(0))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sample_window.launches - before[0]
    resident = sample_window.resident - before[1]
    n = batch * frames * cfg.lookback
    if tuple(audio.shape) != (batch, frames * cfg.lookback):
        raise AssertionError(f"audio shape {tuple(audio.shape)}")
    if not (torch.isfinite(audio).all() and audio.abs().max() <= 1.0
            and seq.min() >= 0 and seq.max() < cfg.q_levels):
        raise AssertionError("generated audio out of range")
    if dev.type == "cuda" and not (
            launches == resident == frames * cfg.frame_sizes[-1]):
        raise AssertionError(f"{launches} kernel launches, {resident} of "
                             f"them resident, expected "
                             f"{frames * cfg.frame_sizes[-1]}")
    rate = n / 16000 / wall
    RESULTS["generate"] = {"batch": batch, "frames": frames,
                           "seconds": wall, "audio_s_per_s": rate,
                           "launches": launches, "resident": resident}
    log(f"[generate] B={batch} x {frames} frames bf16 kernel path: "
        f"{wall:.3f} s for {n / 16000:.2f} audio-s = {rate:.2f} "
        f"audio-s/s; {launches} kernel launches, {resident} resident")

    # float32 (generate_fn's default type, as the metrics plugin and a
    # float32 artifact run it): every window through the grid kernel. A
    # run is tens of ms of host time: one whole run to warm up, then the
    # median of several
    gen32 = generate_fn(params, cfg, use_kernel=True, temperature=1.0)
    gen32(cond, spk, torch.Generator(device=dev).manual_seed(0))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    runs = 5 if dev.type == "cuda" else 1
    walls = []
    _reset_window_counts()                  # the float32 generation
    for _ in range(runs):
        t0 = time.perf_counter()
        audio, seq = gen32(cond, spk,
                           torch.Generator(device=dev).manual_seed(0))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    launches, grid = sample_window.launches, sample_window.grid
    if not (torch.isfinite(audio).all() and tuple(audio.shape) == (
            batch, frames * cfg.lookback) and seq.min() >= 0
            and seq.max() < cfg.q_levels):
        raise AssertionError("float32 generated audio out of range")
    if dev.type == "cuda" and not (
            launches == grid == runs * frames * cfg.frame_sizes[-1]):
        raise AssertionError(f"float32: {launches} kernel launches, {grid} "
                             f"of them grid, in {runs} runs")
    out = {"batch": batch, "frames": frames, "runs": runs, "seconds": wall,
           "seconds_each": walls, "audio_s_per_s": n / 16000 / wall,
           "launches": launches, "grid": grid,
           "sharpened_launches": sharp_launches}
    RESULTS["generate_f32"] = out
    log(f"[generate] B={batch} x {frames} frames float32 kernel path: "
        f"median of {runs} runs {wall:.3f} s (each "
        + ", ".join(f"{w:.4f}" for w in walls)
        + f") = {out['audio_s_per_s']:.2f} audio-s/s; {launches} "
        f"kernel launches, {grid} grid")


# --------------------------------------------------------------------------
# phase 4: serving over HTTP
# --------------------------------------------------------------------------

def _post(addr, path, body, raw=None):
    import http.client
    c = http.client.HTTPConnection(*addr, timeout=600)
    c.request("POST", path, raw if raw is not None else json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r, data


def smoke_checkpoint(params, exp_cfg):
    """The params as a JAX-format checkpoint ("leaf:" + keystr paths and a
    JSON meta) under the git-ignored build directory -> (path, tag)."""
    from msnv_tpu_torch.config import make_tag
    from msnv_tpu_torch.interop import params_to_numpy
    tag = make_tag(exp_cfg)
    ckpt_dir = os.path.join(REPO, "msnv_tpu_torch", "build", "smoke", tag,
                            "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "ep1-it1.npz")
    arrays = params_to_numpy(params)
    arrays["__meta__"] = np.frombuffer(b"{}", dtype=np.uint8)
    np.savez(path, **arrays)
    return path, tag


def phase_serve(params, ckpt, cfg, frames_syn, frames_stream):
    import http.client
    import torch
    from msnv_tpu_torch.interop import load_npz_params
    from msnv_tpu_torch.kernels.sample_window import sample_window
    from msnv_tpu_torch.serving import VocoderService, make_server
    dev = params["mlp"]["embedding"].device
    path, tag = ckpt
    loaded = load_npz_params(path, cfg, device=dev)
    if not torch.equal(loaded["mlp"]["conv_in"], params["mlp"]["conv_in"]):
        raise AssertionError("npz round trip changed the weights")
    service = VocoderService(loaded, cfg, frame_bucket=4, name=tag)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address
    rng = np.random.RandomState(0)
    C = cfg.effective_cond_dim
    try:
        sample_window.launches = 0          # the main path starts here
        sample_window.resident = sample_window.grid = 0
        c = http.client.HTTPConnection(*addr, timeout=60)
        c.request("GET", "/healthz")
        r = c.getresponse()
        health = json.loads(r.read())
        c.close()
        if r.status != 200 or health["status"] != "ok":
            raise AssertionError(f"/healthz {r.status} {health}")
        cond = rng.rand(frames_syn, C).astype(np.float32)
        for body in ({"cond": cond.tolist(), "spk": 2, "seed": 1},
                     {"cond": base64.b64encode(cond.tobytes()).decode(),
                      "spk": 3, "temperature": 0.0}):
            t0 = time.perf_counter()
            r, wav = _post(addr, "/synthesize", body)
            wall = time.perf_counter() - t0
            want = 44 + 2 * frames_syn * cfg.lookback
            if r.status != 200 or len(wav) != want:
                raise AssertionError(f"/synthesize {r.status}, {len(wav)} "
                                     f"bytes, expected {want}")
            log(f"[serve] /synthesize {frames_syn} frames: {wall:.3f} s")
        streams = []
        for i in range(2):
            before = sample_window.resident
            cond = rng.rand(frames_stream, C).astype(np.float32)
            t0 = time.perf_counter()
            r, pcm = _post(addr, "/stream",
                           {"cond": cond.tolist(), "spk": i, "seed": i})
            wall = time.perf_counter() - t0
            want = 2 * frames_stream * cfg.lookback
            rose = sample_window.resident - before
            audio = np.frombuffer(pcm, "<i2")
            if r.status != 200 or len(pcm) != want:
                raise AssertionError(f"/stream {r.status}, {len(pcm)} bytes,"
                                     f" expected {want}")
            windows = frames_stream * cfg.frame_sizes[-1]
            if dev.type == "cuda" and rose != windows:
                raise AssertionError(f"/stream launched the resident kernel "
                                     f"{rose} times, expected {windows}")
            if np.all(audio == audio[0]):
                raise AssertionError("/stream returned constant audio")
            rtf = frames_stream * cfg.lookback / 16000 / wall
            streams.append({"frames": frames_stream, "seconds": wall,
                            "realtime_factor": rtf, "launches": rose})
            log(f"[serve] /stream {frames_stream} frames: {wall:.3f} s "
                f"(realtime x{rtf:.2f}), {rose} launches of the resident "
                f"kernel")
        r, _ = _post(addr, "/synthesize", None, raw="{not json")
        if r.status != 400:
            raise AssertionError(f"bad body answered {r.status}")
        r, _ = _post(addr, "/stream", {"cond": [[0.0, 1.0]], "spk": 0})
        if r.status != 400:
            raise AssertionError(f"bad cond answered {r.status}")
        log("[serve] bad bodies answered 400")
        RESULTS["launches"] = sample_window.launches   # main path count
        RESULTS["resident_launches"] = sample_window.resident
        # /synthesize runs the per-sample path: the streams' windows alone
        windows = 2 * frames_stream * cfg.frame_sizes[-1]
        if dev.type == "cuda" and (sample_window.grid, sample_window.resident,
                                   sample_window.launches) != (0, windows,
                                                               windows):
            raise AssertionError(
                f"the serving path launched {sample_window.launches} windows"
                f" ({sample_window.resident} resident, {sample_window.grid} "
                f"grid), expected {windows}, all resident")
        RESULTS["streams"] = streams
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)



# --------------------------------------------------------------------------
# phase 5: the GRU-layer kernels against their plain versions
# --------------------------------------------------------------------------

GRU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def gru_fma_floor_ms(T, B, H):
    """A sweep's float32 products at the CUDA cores' FMA peak."""
    return 2 * T * B * H * 3 * H / FMA_FLOPS * 1e3


def gru_inputs(T, B, H, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa
    return {"x_proj": rn(T, B, 3 * H), "w_hh_t": rn(H, 3 * H) / math.sqrt(H),
            "b_hh": 0.1 * rn(3 * H), "h0": 0.5 * rn(B, H),
            "dy": rn(T, B, H), "dhT": rn(B, H)}


def _rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def flat_bf16_gru(H, dev):
    """One torch.nn.GRU(H, H) layer in bf16 with its weights in ONE cuDNN
    buffer. flatten_parameters() leaves bf16 weights where they are
    (torch.backends.cudnn.is_acceptable admits half, float and double
    only), and cuDNN then compacts them into a new buffer on every call;
    this makes the call that flatten_parameters makes for those types."""
    import torch
    from torch.backends.cudnn import rnn as cudnn_rnn
    gru = torch.nn.GRU(H, H).to(dev, torch.bfloat16)
    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(
            gru._flat_weights, 4, H, cudnn_rnn.get_cudnn_mode(gru.mode), H,
            0, 1, False, False)
    return gru


def phase_gru(dev, shapes):
    import torch
    from msnv_tpu_torch.kernels import gru_layer as gl
    on_card = dev.type == "cuda"
    worst = {"fwd": 0.0, "bwd": 0.0, "fwd_bf16": 0.0, "bwd_bf16": 0.0}
    paths = {}
    for T, B, H in shapes:
        x = gru_inputs(T, B, H, dev, seed=T * 1000 + B)
        w_hh = x["w_hh_t"].t().contiguous()
        # float32 products (split TF32 persistent, or FMA per step), then
        # bfloat16 ones, on the kernels the shape's plan names
        for mxu in (torch.float32, torch.bfloat16):
            name = str(mxu).replace("torch.", "")
            if on_card:
                paths[(T, B, H, mxu)] = gl.sweep_plan(
                    T, B, H, mxu, *gl.device_limits(dev, H, mxu)).path
            ys, hproj = gl.gru_layer_forward(
                x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu)
            ys_p, hproj_p = gl.gru_layer_reference(
                x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu)
            ys_eval, none = gl.gru_layer_forward(
                x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu,
                with_residual=False)
            if none is not None or not torch.equal(ys_eval, ys):
                raise AssertionError("forward without residual differs")
            # the reverse sweep on the same saved tensors
            h_prev = torch.cat([x["h0"][None], ys[:-1]], dim=0)
            got = gl.gru_layer_backward(x["x_proj"], hproj, x["h0"], ys,
                                        x["dy"], w_hh, mxu)
            want = gl.gru_layer_backward_reference(
                x["x_proj"], hproj, h_prev, x["dy"], w_hh, mxu)
            # two runs on the same inputs give the same bits, also with the
            # final state's cotangent handed over beside dy
            again = gl.gru_layer_backward(x["x_proj"], hproj, x["h0"], ys,
                                          x["dy"], w_hh, mxu)
            folded = x["dy"].clone()
            folded[-1] += x["dhT"]
            with_dhT = gl.gru_layer_backward(
                x["x_proj"], hproj, x["h0"], ys, x["dy"], w_hh, mxu,
                dhT=x["dhT"])
            want_dhT = gl.gru_layer_backward_reference(
                x["x_proj"], hproj, h_prev, folded, w_hh, mxu)
            if on_card:
                torch.cuda.synchronize()
            if not (torch.equal(ys_eval, ys)
                    and all(torch.equal(a, b) for a, b in zip(got, again))):
                raise AssertionError(f"two runs differ at T={T} B={B} {name}")
            e_f = max(_rel_err(ys, ys_p), _rel_err(hproj, hproj_p))
            e_b = max(_rel_err(a, b) for a, b in
                      list(zip(got, want)) + list(zip(with_dhT, want_dhT)))
            which = paths[(T, B, H, mxu)] if on_card else "plain"
            log(f"[gru] T={T} B={B} H={H} {name} {which}: forward err "
                f"{e_f:.2e}, backward err {e_b:.2e} (tolerance "
                f"{GRU_TOL[name]:.0e}); two runs bit-equal")
            if not (e_f <= GRU_TOL[name] and e_b <= GRU_TOL[name]):
                raise AssertionError(f"GRU kernel disagrees at T={T} B={B} "
                                     f"{name} {which}: {e_f} / {e_b}")
            suffix = "" if mxu == torch.float32 else "_bf16"
            worst["fwd" + suffix] = max(worst["fwd" + suffix], e_f)
            worst["bwd" + suffix] = max(worst["bwd" + suffix], e_b)
        # the autograd.Function against autograd through the plain forward,
        # with float32 products and with bfloat16 ones (the train step's)
        for mxu in (torch.float32, torch.bfloat16):
            name = str(mxu).replace("torch.", "")
            leaves = [x[k].clone().requires_grad_(True)
                      for k in ("x_proj", "w_hh_t", "b_hh", "h0")]
            ys, hT = gl.gru_layer(*leaves, mxu)
            got = torch.autograd.grad(
                (ys * x["dy"]).sum() + (hT * x["dhT"]).sum(), leaves)
            ys_p, _ = gl.gru_layer_reference(*leaves, mxu)
            want = torch.autograd.grad(
                (ys_p * x["dy"]).sum() + (ys_p[-1] * x["dhT"]).sum(), leaves)
            e_g = max(_rel_err(a, b) for a, b in zip(got, want))
            log(f"[gru] T={T} B={B} H={H} {name}: Function (dx_proj, dw, "
                f"db, dh0) vs autograd of the plain forward, err {e_g:.2e}")
            if not e_g <= GRU_TOL[name]:
                raise AssertionError(f"GRU Function gradients differ: {e_g}")
            suffix = "" if mxu == torch.float32 else "_bf16"
            worst["bwd" + suffix] = max(worst["bwd" + suffix], e_g)
    RESULTS["gru_err"] = worst
    if not on_card:
        return
    for H in sorted({shape[2] for shape in shapes}):
        for mxu in (torch.float32, torch.bfloat16):
            held, smem = gl.device_limits(dev, H, mxu)
            log(f"[gru] H={H} {str(mxu).replace('torch.', '')}: CTAs of the "
                f"persistent kernels that the card holds at once: {held}, "
                f"with {gl.persistent_smem_bytes(H, mxu)} of {smem} bytes of "
                f"shared memory each")
    for (T, B, H, mxu), path in paths.items():
        want = "persistent" if B <= 128 else "per_step"
        if path != want:
            raise AssertionError(f"({T}, {B}, {H}) in {mxu} took the {path} "
                                 f"kernels, not {want}")
    # many runs of the persistent sweeps on the same inputs, each bit-equal
    # to the first (counted on the card, as in phase 2)
    for T, B, H, mxu in ((52, 128, shapes[0][2], torch.bfloat16),
                         (52, 64, shapes[0][2], torch.bfloat16),
                         (52, 128, shapes[0][2], torch.float32),
                         (13, 128, shapes[0][2], torch.float32)):
        x = gru_inputs(T, B, H, dev, seed=7 * T + B)
        w_hh = x["w_hh_t"].t().contiguous()
        fwd = lambda: gl.gru_layer_forward(                   # noqa: E731
            x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu)
        ys, hproj = fwd()
        bwd = lambda: gl.gru_layer_backward(                  # noqa: E731
            x["x_proj"], hproj, x["h0"], ys, x["dy"], w_hh, mxu)
        for name, run in (("forward", fwd), ("backward", bwd)):
            first = run()
            differ = torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(REPEAT_RUNS):
                for a, b in zip(run(), first):
                    differ += (a != b).any()
            if int(differ):
                raise AssertionError(f"{int(differ)} of {REPEAT_RUNS} runs "
                                     f"of the {name} sweep differ at T={T} "
                                     f"B={B}")
        log(f"[gru] T={T} B={B} {str(mxu).replace('torch.', '')}: "
            f"{REPEAT_RUNS} runs of each sweep bit-equal to the first")
    for width, mxu in ((40, torch.float32), (96, torch.bfloat16)):
        bad = gru_inputs(2, 2, width, dev, seed=1)
        try:
            gl.gru_layer_forward(bad["x_proj"], bad["w_hh_t"], bad["b_hh"],
                                 bad["h0"], mxu)
        except ValueError as e:
            log(f"[gru] H={width} raises: {e}")
        else:
            raise AssertionError(f"H={width} did not raise")

    # times at the train step's shapes, in each products' type: the
    # persistent kernels and the per-step kernels in turns (bf16: the empty
    # sweep beside them, the barriers of a sweep and nothing else), the
    # weight handed over as the train step hands it over (the transposed
    # view of a stored (3H, H) parameter)
    rows = []
    for T, B, H in shapes:
        if B != 128:
            continue
        for mxu in (torch.bfloat16, torch.float32):
            rows.append(_gru_times(gl, dev, T, B, H, mxu))
    RESULTS["gru_shapes"] = rows


def _gru_times(gl, dev, T, B, H, mxu):
    """One row of phase 5's times for (T, B, H) with products in `mxu`:
    the persistent kernels, plain version, bound and nn.GRU in the same
    type (float32: TF32 off, as main() sets it)."""
    import torch
    name = str(mxu).replace("torch.", "")
    x = gru_inputs(T, B, H, dev, seed=T)
    w_hh = x["w_hh_t"].t().contiguous().to(mxu)
    w_hh_t = w_hh.t()
    ys, hproj = gl.gru_layer_forward(x["x_proj"], w_hh_t, x["b_hh"],
                                     x["h0"], mxu)
    h_prev = torch.cat([x["h0"][None], ys[:-1]], dim=0)

    def fwd_run():
        return gl.gru_layer_forward(x["x_proj"], w_hh_t, x["b_hh"], x["h0"],
                                    mxu)

    def bwd_run():
        return gl.gru_layer_backward(x["x_proj"], hproj, x["h0"], ys,
                                     x["dy"], w_hh, mxu)

    # runs of 10 calls, the better of two
    run = {"iters": 5, "batch": 10}
    fwd = min(cuda_ms(fwd_run, **run) for _ in range(2))
    bwd = min(cuda_ms(bwd_run, **run) for _ in range(2))
    # one call at a time: with the launch on an idle card
    fwd_alone = cuda_ms(fwd_run, 20)
    bwd_alone = cuda_ms(bwd_run, 20)
    fwd_plain = cuda_ms(lambda: gl.gru_layer_reference(
        x["x_proj"], w_hh_t, x["b_hh"], x["h0"], mxu), 5)
    bwd_plain = cuda_ms(lambda: gl.gru_layer_backward_reference(
        x["x_proj"], hproj, h_prev, x["dy"], w_hh, mxu), 5)
    # the library's yardstick: one nn.GRU layer in the same type, which also
    # does the input projection that gru_layer leaves outside, its weights
    # in one cuDNN buffer; any warning in its timed calls is an error (the
    # one to catch: cuDNN compacting scattered weights on every call)
    inp = torch.randn(T, B, H, device=dev, dtype=mxu, requires_grad=True)
    h0 = x["h0"][None].to(mxu)
    dy = x["dy"].to(mxu)

    def lib_times(rnn, guard):
        def both():
            out, _ = rnn(inp, h0)
            out.backward(dy)
        with warnings.catch_warnings():
            if guard:
                warnings.simplefilter("error")
            with torch.no_grad():
                fwd_ms = cuda_ms(lambda: rnn(inp, h0), **run)
            return fwd_ms, cuda_ms(both, **run)

    b_f = gru_sweep_bound_s(T, B, H, name, backward=False) * 1e3
    b_b = gru_sweep_bound_s(T, B, H, name, backward=True) * 1e3
    row = {"T": T, "B": B, "H": H, "dtype": name,
           "fwd_ms": fwd, "bwd_ms": bwd,
           "fwd_alone_ms": fwd_alone, "bwd_alone_ms": bwd_alone,
           "fwd_plain_ms": fwd_plain, "bwd_plain_ms": bwd_plain,
           "fwd_bound_ms": b_f, "bwd_bound_ms": b_b}
    if mxu == torch.bfloat16:
        row["empty_sweep_ms"] = cuda_ms(
            lambda: gl.empty_sweep(T, B, H, dev), **run)
        # the yardstick as first timed: flatten_parameters() after the bf16
        # conversion, which leaves bf16 weights scattered
        scattered = torch.nn.GRU(H, H).to(dev, torch.bfloat16)
        scattered.flatten_parameters()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                with torch.no_grad():
                    scattered(inp, h0)
        except UserWarning as e:
            log(f"[gru] nn.GRU bf16 after flatten_parameters(): {e}")
        else:
            log("[gru] nn.GRU bf16 after flatten_parameters(): no warning")
        row["nn_gru_scattered_fwd_ms"], row["nn_gru_scattered_fwd_bwd_ms"] = \
            lib_times(scattered, guard=False)
        lib = flat_bf16_gru(H, dev)
    else:
        lib = torch.nn.GRU(H, H).to(dev)
        lib.flatten_parameters()          # float32: one cuDNN buffer
    row["nn_gru_fwd_ms"], row["nn_gru_fwd_bwd_ms"] = lib_times(lib,
                                                               guard=True)
    extra = (f"empty sweep of {T} barriers {row['empty_sweep_ms']:.4f} ms"
             if mxu == torch.bfloat16 else
             f"FMA floor {gru_fma_floor_ms(T, B, H):.4f} ms")
    log(f"[gru] T={T} B={B} {name}: forward {fwd:.4f} ms "
        f"({fwd / T * 1e3:.1f} us/step; one call alone {fwd_alone:.4f}), "
        f"plain {fwd_plain:.4f}, bound {b_f:.4f}; backward {bwd:.4f} ms "
        f"({bwd / (T + 1) * 1e3:.1f} us/step; one call alone "
        f"{bwd_alone:.4f}), plain {bwd_plain:.4f}, bound {b_b:.4f}; "
        f"{extra}; nn.GRU {name} (with the input projection) forward "
        f"{row['nn_gru_fwd_ms']:.4f}, forward+backward "
        f"{row['nn_gru_fwd_bwd_ms']:.4f}")
    return row


POOL_F32 = {"rtol": 1e-5, "atol": 1e-5}
POOL_TOL = {"float32": POOL_F32, "bfloat16": {"rtol": 2 ** -7, "atol": 1e-5}}


def phase_pool(dev, shapes):
    """The fo-pool kernels (phase 5, after the GRU layers) against their
    plain versions, both ways, in both types; on the card, their times."""
    import torch
    from msnv_tpu_torch.kernels import fo_pool as fp
    on_card = dev.type == "cuda"
    worst, rows = {"fwd": 0.0, "bwd": 0.0, "fwd_bf16": 0.0,
                   "bwd_bf16": 0.0}, []
    for T, B, H in shapes:
        g = torch.Generator(device=dev).manual_seed(T * 1000 + B)
        rn = lambda *shape: torch.randn(*shape, generator=g,  # noqa: E731
                                        device=dev)
        x, c0, dy, dcT = rn(B, T, 3 * H), rn(B, H), rn(B, T, H), rn(B, H)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            tol = POOL_TOL[name]
            gx, dh = x.to(dtype), dy.to(dtype)
            h, cs, cT = fp.fo_pool_forward(gx, c0)
            rh, rcs, rcT = fp.fo_pool_reference(gx, c0)
            torch.testing.assert_close(h, rh, **tol)
            torch.testing.assert_close(cs, rcs, **POOL_F32)
            torch.testing.assert_close(cT, rcT, **POOL_F32)
            e_f = max(_rel_err(h.float(), rh.float()), _rel_err(cs, rcs),
                      _rel_err(cT, rcT))
            e_b, again = 0.0, fp.fo_pool_forward(gx, c0)
            for d in (None, dcT):
                dg, dc0 = fp.fo_pool_backward(gx, c0, cs, dh, d)
                rdg, rdc0 = fp.fo_pool_backward_reference(gx, c0, rcs, dh, d)
                torch.testing.assert_close(dg, rdg, **tol)
                torch.testing.assert_close(dc0, rdc0, **POOL_F32)
                e_b = max(e_b, _rel_err(dg.float(), rdg.float()),
                          _rel_err(dc0, rdc0))
                if not all(torch.equal(a, b) for a, b in zip(
                        fp.fo_pool_backward(gx, c0, cs, dh, d), (dg, dc0))):
                    raise AssertionError(f"two backward sweeps differ at "
                                         f"T={T} B={B} {name}")
            if not all(torch.equal(a, b) for a, b in zip(again, (h, cs, cT))):
                raise AssertionError(f"two forward sweeps differ at T={T} "
                                     f"B={B} {name}")
            suffix = "_bf16" if dtype == torch.bfloat16 else ""
            worst["fwd" + suffix] = max(worst["fwd" + suffix], e_f)
            worst["bwd" + suffix] = max(worst["bwd" + suffix], e_b)
            log(f"[pool] T={T} B={B} H={H} {name}: forward err {e_f:.2e}, "
                f"backward err {e_b:.2e} (rtol {tol['rtol']:.1e}); two runs "
                f"bit-equal")
            if not on_card:
                continue
            run = {"iters": 5, "batch": 10}
            row = {"T": T, "B": B, "H": H, "dtype": name}
            for d, kernel, plain, backward in (
                    ("fwd", lambda: fp.fo_pool_forward(gx, c0),
                     lambda: fp.fo_pool_reference(gx, c0), False),
                    ("bwd", lambda: fp.fo_pool_backward(gx, c0, cs, dh),
                     lambda: fp.fo_pool_backward_reference(gx, c0, rcs, dh),
                     True)):
                row[f"{d}_ms"] = min(cuda_ms(kernel, **run) for _ in range(2))
                row[f"{d}_plain_ms"] = cuda_ms(plain, 5)
                row[f"{d}_bound_ms"] = 1e3 * pool_bound_s(T, B, H, name,
                                                          backward)
            log(f"[pool] T={T} B={B} {name}: forward {row['fwd_ms']:.4f} ms, "
                f"plain {row['fwd_plain_ms']:.4f}, bound "
                f"{row['fwd_bound_ms']:.4f}; backward {row['bwd_ms']:.4f} "
                f"ms, plain {row['bwd_plain_ms']:.4f}, bound "
                f"{row['bwd_bound_ms']:.4f}")
            rows.append(row)
    RESULTS["pool_err"] = worst
    RESULTS["pool_shapes"] = rows


# --------------------------------------------------------------------------
# phase 6: the train step at full width
# --------------------------------------------------------------------------

def _gru_counts():
    from msnv_tpu_torch.kernels.gru_layer import (gru_layer_backward,
                                                  gru_layer_forward)
    return (gru_layer_forward.launches, gru_layer_forward.persistent,
            gru_layer_backward.launches, gru_layer_backward.persistent)


def _gru_f32_counts():
    """(forward, backward) sweeps through the float32 persistent kernels."""
    from msnv_tpu_torch.kernels.gru_layer import (gru_layer_backward,
                                                  gru_layer_forward)
    return gru_layer_forward.persistent_f32, gru_layer_backward.persistent_f32


def _gru_types():
    """Sweeps by their products' type: "gru_<fwd|bwd>_<bf16|f32>" through
    either path's kernels, "..._persistent" through the persistent one."""
    from msnv_tpu_torch.kernels.gru_layer import (gru_layer_backward,
                                                  gru_layer_forward)
    out = {}
    for d, w in (("fwd", gru_layer_forward), ("bwd", gru_layer_backward)):
        for t in ("bf16", "f32"):
            out[f"gru_{d}_{t}_persistent"] = getattr(w, f"persistent_{t}")
            out[f"gru_{d}_{t}"] = (getattr(w, f"persistent_{t}")
                                   + getattr(w, f"per_step_{t}"))
    return out


def _launch_keys(*types):
    """The per-type counts of `types` (from _gru_types) summed, under the
    kernels line's keys: {"gru_fwd_bf16_launches", ...}."""
    return {f"{k}_launches": sum(t[k] for t in types) for k in types[0]}


def _reset_gru_counts():
    from msnv_tpu_torch.kernels.gru_layer import (COUNTERS,
                                                  gru_layer_backward,
                                                  gru_layer_forward)
    for wrapper in (gru_layer_forward, gru_layer_backward):
        for name in COUNTERS:
            setattr(wrapper, name, 0)


def train_inputs(cfg, batch, seq_len, dev, seed=0):
    """One fixed batch from a numpy seed: uniform sample levels, targets,
    conditioner frames and speaker ids."""
    import torch
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 256, (batch, seq_len + cfg.lookback - 1))
    target = rng.randint(0, 256, (batch, seq_len))
    cond = rng.rand(batch, seq_len // cfg.lookback,
                    cfg.effective_cond_dim).astype(np.float32)
    spk = rng.randint(0, cfg.spk_dim, (batch,))
    return (torch.from_numpy(data.astype(np.int32)).to(dev),
            torch.from_numpy(target.astype(np.int32)).to(dev),
            torch.from_numpy(cond).to(dev),
            torch.from_numpy(spk.astype(np.int64)).to(dev))


def phase_train(exp, dev, batch, seq_len, steps, f32_steps):
    import dataclasses

    import torch
    from msnv_tpu_torch.kernels.gru_layer import (gru_layer_backward,
                                                  gru_layer_forward)
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.tree import tree_leaves, tree_map
    from msnv_tpu_torch.training.step import loss_and_grads, make_train_step
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = dataclasses.replace(exp.model, gru_impl="pallas")
    data, target, cond, spk = train_inputs(cfg, batch, seq_len, dev)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    before = [p.clone() for p in tree_leaves(params)]
    optimizer = make_optimizer(exp.train)
    opt_state = optimizer.init(params)
    state = init_tier_state(cfg, batch, device=dev)
    step = make_train_step(cfg, optimizer, compute_dtype=torch.bfloat16)
    _reset_gru_counts()                     # the main path starts here
    losses, walls = [], []
    for i in range(1 + steps):
        sync()
        t0 = time.perf_counter()
        params, opt_state, state, loss = step(
            params, opt_state, state, data, i == 0, target, cond, spk)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = (gru_layer_forward.launches, gru_layer_backward.launches)
    persistent = (gru_layer_forward.persistent, gru_layer_backward.persistent)
    types = _gru_types()
    log(f"[train] bf16 losses (bits): {[round(x, 4) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on the fixed batch")
    per_step = cfg.n_tiers * cfg.n_rnn
    if on_card and launches != (per_step * (1 + steps),) * 2:
        raise AssertionError(f"GRU kernel launches {launches}, expected "
                             f"{per_step} per step each")
    if on_card and persistent != launches:
        raise AssertionError(f"only {persistent} of {launches} GRU sweeps "
                             f"went through the persistent kernels")
    if not any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params))):
        raise AssertionError("params did not change")
    if any(s.grad_fn is not None or s.requires_grad for s in state):
        raise AssertionError("the carried state is attached to a graph")
    ms = statistics.median(walls[2:]) * 1e3
    rate = batch * seq_len / (ms / 1e3)
    RESULTS["train"] = {"batch": batch, "seq_len": seq_len, "dtype": "bf16",
                        "steps": 1 + steps, "ms_per_step": ms,
                        "samples_per_s": rate, "first_step_ms": walls[0] * 1e3,
                        "losses": losses, "gru_fwd_launches": launches[0],
                        "gru_bwd_launches": launches[1],
                        "gru_fwd_persistent": persistent[0],
                        "gru_bwd_persistent": persistent[1]}
    log(f"[train] B={batch} seq_len={seq_len} bf16 gru_impl=pallas: "
        f"{ms:.3f} ms/step = {rate:.0f} samples/s (median of the last "
        f"{len(walls) - 2} steps; first step {walls[0] * 1e3:.1f} ms); GRU "
        f"sweeps fwd {launches[0]}, bwd {launches[1]}, of which through the "
        f"persistent kernels {persistent[0]}, {persistent[1]}")

    # float32: the kernel path against the loop path from the same weights,
    # both held against the loop path in float64. Tolerances: losses 1e-4
    # bits; a gradient leaf's error (max |g - g64| over max |g64|) on the
    # kernel path at most 3 times the loop path's worst leaf. A fixed
    # tolerance does not fit: a leaf's gradient is a sum over B * seq_len
    # positions that largely cancel, so float32 sums taken in another order
    # move it by far more than one rounding relative to its own size.
    params0 = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    fresh_state = lambda: init_tier_state(cfg, batch, device=dev)  # noqa
    _, _, g64 = loss_and_grads(
        tree_map(torch.clone, params0),
        dataclasses.replace(cfg, gru_impl="xla"), fresh_state(), data, True,
        target, cond, spk, compute_dtype=torch.float64)
    ref = tree_leaves(g64)
    losses32, errs = {}, {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, gru_impl=impl)
        p = tree_map(torch.clone, params0)
        st = fresh_state()
        _, _, grads = loss_and_grads(p, c, st, data, True, target, cond, spk)
        errs[impl] = max(
            float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for g, r in zip(tree_leaves(grads), ref))
        opt = make_optimizer(exp.train)
        o = opt.init(p)
        f32_step = make_train_step(c, opt)
        losses32[impl] = []
        for i in range(2):
            p, o, st, loss = f32_step(p, o, st, data, i == 0, target, cond,
                                      spk)
            losses32[impl].append(float(loss))
    sync()
    d_loss = max(abs(a - b)
                 for a, b in zip(losses32["pallas"], losses32["xla"]))
    log(f"[train] f32 pallas vs xla: losses {losses32['pallas']} vs "
        f"{losses32['xla']} (max diff {d_loss:.2e}); worst gradient leaf "
        f"against float64: pallas {errs['pallas']:.2e}, xla "
        f"{errs['xla']:.2e}")
    if not d_loss <= 1e-4:
        raise AssertionError(f"f32 losses differ by {d_loss}")
    if not errs["pallas"] <= 3 * errs["xla"] + 1e-7:
        raise AssertionError(f"f32 gradients on the kernel path are off: "
                             f"{errs}")
    RESULTS["train"]["f32_loss_diff"] = d_loss
    RESULTS["train"]["f32_grad_err_vs_f64"] = errs

    # the default train step (float32, no compute_dtype), as msnv-train-torch
    # runs it without --bf16: ms per step, samples/s, and all 4 forward and
    # 4 backward GRU sweeps of every step through the float32 persistent
    # kernels
    p = tree_map(torch.clone, params0)
    opt = make_optimizer(exp.train)
    o, st = opt.init(p), fresh_state()
    f32_step = make_train_step(cfg, opt)
    _reset_gru_counts()                     # the float32 path starts here
    walls32 = []
    for i in range(1 + f32_steps):
        sync()
        t0 = time.perf_counter()
        p, o, st, loss = f32_step(p, o, st, data, i == 0, target, cond, spk)
        sync()
        walls32.append(time.perf_counter() - t0)
    counts, f32, types32 = _gru_counts(), _gru_f32_counts(), _gru_types()
    want = per_step * (1 + f32_steps)
    if on_card and not (counts == (want,) * 4 and f32 == (want, want)):
        raise AssertionError(f"float32 steps: GRU (fwd, persistent, bwd, "
                             f"persistent) {counts}, float32 persistent "
                             f"{f32}; expected {want} each")
    if not math.isfinite(float(loss)):
        raise AssertionError("non-finite float32 loss")
    ms32 = statistics.median(walls32[1:]) * 1e3
    # the phase's sweeps: the bf16 steps' and these
    RESULTS["train"].update(
        f32_ms_per_step=ms32, f32_samples_per_s=batch * seq_len / ms32 * 1e3,
        f32_steps=1 + f32_steps, f32_first_step_ms=walls32[0] * 1e3,
        gru_fwd_launches=launches[0] + counts[0],
        gru_bwd_launches=launches[1] + counts[2],
        **_launch_keys(types, types32))
    log(f"[train] B={batch} seq_len={seq_len} float32 gru_impl=pallas: "
        f"{ms32:.3f} ms/step = {batch * seq_len / ms32 * 1e3:.0f} samples/s "
        f"(median of the last {f32_steps} steps; first step "
        f"{walls32[0] * 1e3:.1f} ms); GRU sweeps fwd {counts[0]}, bwd "
        f"{counts[2]}, through the float32 persistent kernels {f32[0]}, "
        f"{f32[1]}")

# --------------------------------------------------------------------------
# phase 7: the training loop through the CLIs
# --------------------------------------------------------------------------

class Clock:
    """Wall times of the calls to patched functions, each call between two
    synchronizes; `restore` puts the originals back."""

    def __init__(self, sync):
        self.sync = sync
        self.times = {}
        self._undo = []

    def wrap(self, owner, name):
        fn = getattr(owner, name)
        times = self.times.setdefault(name, [])

        def timed(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            times.append(time.perf_counter() - t0)
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)


def run_cli(main, argv):
    """A CLI's main(argv) with its standard output captured (and shown);
    sys.stdout is restored (the train CLI tees it into its log)."""
    import contextlib
    import io
    out = io.StringIO()
    stdout = sys.stdout
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
    finally:
        sys.stdout = stdout
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("epoch ", "resumed", "warm", "device",
                            "validation", "generation", "wrote")):
            log(f"[loop]   {line.strip()}")
    return text


def _stats(results):
    (tag,) = os.listdir(results)
    with open(os.path.join(results, tag, "stats.json")) as f:
        return json.load(f), os.path.join(results, tag)


def _pool_counts():
    """(forward, backward) launches of the fo-pool kernel."""
    from msnv_tpu_torch.kernels.fo_pool import (fo_pool_backward,
                                                fo_pool_forward)
    return fo_pool_forward.launches, fo_pool_backward.launches


def _qrnn_cli(cli_train, args, work, chunks, sync, on_card, out):
    """cli.train --qrnn true (run Q) on the loop's corpus and widths to 1
    epoch, resumed to 2: the tag names qrnn, the losses are finite, it
    resumes, and on a card every train step pools in the fo-pool kernel,
    one launch a layer of a tier each way, as does every validation step
    forward."""
    from msnv_tpu_torch.training.trainer import Trainer
    results = os.path.join(work, "results_q")
    argv = args + ["--qrnn", "true", "--results_path", results]
    clock = Clock(sync)
    clock.wrap(Trainer, "evaluate")
    before = _pool_counts()
    t0 = time.perf_counter()
    try:
        run_cli(cli_train.main, argv + ["--epoch_limit", "1"])
        resumed = run_cli(cli_train.main, argv + ["--epoch_limit", "2"])
    finally:
        clock.restore()
    sync()
    wall = time.perf_counter() - t0
    fwd, bwd = (a - b for a, b in zip(_pool_counts(), before))
    stats, exp_dir = _stats(results)
    losses, evals = stats["training_loss"], len(clock.times["evaluate"])
    pools = 4                                 # 2 tiers x n_rnn 2
    log(f"[loop] run Q (--qrnn true): 1 + 1 epochs (resumed) in {wall:.1f}"
        f" s, last epoch's losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"fo-pool launches forward {fwd}, backward {bwd} for {2 * chunks} "
        f"train steps and {evals} evaluations of {chunks} chunks")
    if "~qrnn:T" not in os.path.basename(exp_dir):
        raise AssertionError(f"run Q's tag {os.path.basename(exp_dir)}")
    if "resumed from" not in resumed:
        raise AssertionError("run Q did not resume")
    if len(losses) != chunks or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"run Q's losses {losses}")
    if on_card and not (bwd == pools * 2 * chunks
                        and fwd == pools * (2 + evals) * chunks):
        raise AssertionError(f"run Q pooled outside the fo-pool kernel: "
                             f"{fwd}, {bwd}")
    out.update(qrnn_cli_s=wall, qrnn_pool_fwd_launches=fwd,
               qrnn_pool_bwd_launches=bwd)


def phase_loop(dev, dim, batch, seq_len, utts, frames):
    import shutil
    import tempfile

    import torch
    from msnv_tpu_torch.cli import evaluate as cli_evaluate
    from msnv_tpu_torch.cli import generate as cli_generate
    from msnv_tpu_torch.cli import train as cli_train
    from msnv_tpu_torch.data.corpus import (CorpusConfig, build_corpus,
                                            load_cond_tracks)
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    from msnv_tpu_torch.data.wavio import read_wav
    from msnv_tpu_torch.kernels.gru_layer import (gru_layer_backward,
                                                  gru_layer_forward)
    from msnv_tpu_torch.kernels.sample_window import sample_window
    from msnv_tpu_torch.training import checkpoint as ckpt
    from msnv_tpu_torch.training.trainer import Trainer
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    build = os.path.join(REPO, "msnv_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="loop-", dir=build)
    out = {}
    try:
        data = os.path.join(work, "datasets")
        t0 = time.perf_counter()
        _, _, names = make_synthetic_corpus(
            data, n_speakers=6, utts_per_speaker=utts,
            frames_per_utt=frames, cond_len=80,
            partitions=("train", "validation"), interleave=True)
        out["corpus_write_s"] = time.perf_counter() - t0
        # the cache the CLIs then load: the corpus build the train CLI runs
        ccfg = CorpusConfig(
            datasets_path=data, wav_path=os.path.join(data, "wav/"),
            cond_path=os.path.join(data, "cond/"), overlap_len=80,
            seq_len=seq_len, batch_size=batch, look_ahead=True,
            cache_dir=os.path.join(data, "npy_datasets"))
        t0 = time.perf_counter()
        for part in ("train", "validation"):
            corpus = build_corpus(ccfg, part)
        out["corpus_build_s"] = time.perf_counter() - t0
        out["corpus_samples"] = int(corpus.data.size)
        log(f"[loop] corpus: {len(names)} utterances written in "
            f"{out['corpus_write_s']:.1f} s, train + validation built in "
            f"{out['corpus_build_s']:.1f} s ({out['corpus_samples']} samples "
            f"a partition, {corpus.data.shape[1]} a lane)")

        args = ["--exp", "samplernn", "--frame_sizes", "20", "4",
                "--n_rnn", "2", "--dim", str(dim), "--look_ahead", "true",
                "--seq_len", str(seq_len), "--batch_size", str(batch),
                "--learning_rate", "1e-4", "--bf16", "true",
                "--datasets_path", data, "--device", dev.type]
        clock = Clock(sync)
        for owner, name in ((Trainer, "train_epoch"), (Trainer, "evaluate"),
                            (ckpt, "save_checkpoint"),
                            (ckpt, "load_checkpoint")):
            clock.wrap(owner, name)
        _reset_gru_counts()                 # the loop's path starts here
        try:
            run_a, run_b = (os.path.join(work, "results_a"),
                            os.path.join(work, "results_b"))
            run_cli(cli_train.main,
                    args + ["--results_path", run_a, "--epoch_limit", "3"])
            run_cli(cli_train.main,
                    args + ["--results_path", run_b, "--epoch_limit", "2"])
            resumed = run_cli(cli_train.main, args + [
                "--results_path", run_b, "--epoch_limit", "3"])
        finally:
            clock.restore()
        fwd = (gru_layer_forward.launches, gru_layer_forward.persistent,
               gru_layer_forward.per_step)
        bwd = (gru_layer_backward.launches, gru_layer_backward.persistent)
        f32, types = _gru_f32_counts(), _gru_types()
        stats_a, dir_a = _stats(run_a)
        stats_b, dir_b = _stats(run_b)
        chunks = len(stats_a["training_loss"]) // 3
        losses = stats_a["training_loss"]
        log(f"[loop] run A: {chunks} chunks an epoch, losses (bits) "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, validation "
            f"{stats_a['validation_loss']}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError("non-finite training loss")
        head, tail = (statistics.mean(losses[:max(chunks // 4, 1)]),
                      statistics.mean(losses[-max(chunks // 4, 1):]))
        if not tail < head:
            raise AssertionError(f"the smoothed training loss did not fall: "
                                 f"{head} -> {tail}")
        ckpts = os.listdir(os.path.join(dir_a, "checkpoints"))
        if not (any(c.startswith("ep3-it") for c in ckpts)
                and any(c.startswith("best-") for c in ckpts)
                and os.path.isfile(os.path.join(dir_a, "stats.json"))):
            raise AssertionError(f"run A wrote {ckpts}")
        if "resumed from" not in resumed:
            raise AssertionError("run B did not resume")
        # resume: run B's epoch 3 against run A's
        got, want = stats_b["training_loss"], losses[-chunks:]
        if len(got) != chunks:
            raise AssertionError(f"the resumed run took {len(got)} steps")
        diff = max(abs(a - b) for a, b in zip(got, want))
        out["resume_max_diff_bits"] = diff
        log(f"[loop] resumed epoch 3 vs uninterrupted: "
            f"{'bit-equal' if diff == 0 else f'max |diff| {diff:.3e} bits'}")
        if diff > 2e-3:
            raise AssertionError(f"resume differs by {diff} bits")
        # every GRU sweep through the persistent kernels: the bf16 ones of
        # the train steps, and the float32 ones of the validation
        steps = 3 * chunks + 2 * chunks + chunks
        evals = len(clock.times["evaluate"])
        sweeps = 4                            # 2 tiers x n_rnn 2
        log(f"[loop] GRU sweeps: forward {fwd[0]} ({fwd[1]} persistent, "
            f"{f32[0]} of them float32; {fwd[2]} per-step), backward "
            f"{bwd[0]} ({bwd[1]} persistent) for {steps} train steps and "
            f"{evals} evaluations of {chunks} chunks")
        if on_card and not (bwd == (sweeps * steps,) * 2 and f32[1] == 0
                            and fwd[0] == fwd[1] == sweeps * (
                                steps + evals * chunks)
                            and f32[0] == sweeps * evals * chunks):
            raise AssertionError("a GRU sweep of the loop did not take the "
                                 "persistent kernels")
        out.update(gru_fwd_launches=fwd[0], gru_fwd_persistent=fwd[1],
                   gru_fwd_per_step=fwd[2], gru_bwd_launches=bwd[0],
                   gru_bwd_persistent=bwd[1], **_launch_keys(types),
                   train_steps=steps,
                   chunks_per_epoch=chunks, evaluations=evals)
        epoch_s = clock.times["train_epoch"]
        rate = [chunks * batch * seq_len / s for s in epoch_s]
        writes = clock.times["save_checkpoint"]
        size = os.path.getsize(os.path.join(dir_a, "checkpoints", sorted(
            c for c in ckpts if c.startswith("ep"))[-1]))
        out.update(epoch_train_s=epoch_s, trainer_samples_per_s=rate,
                   evaluate_s=clock.times["evaluate"], ckpt_write_s=writes,
                   ckpt_read_s=clock.times["load_checkpoint"],
                   ckpt_bytes=size, epoch_wall_s=stats_a["time"])
        bare = RESULTS.get("train", {}).get("samples_per_s")
        log(f"[loop] epoch: train {statistics.median(epoch_s):.3f} s "
            f"(median of {len(epoch_s)}) = "
            f"{statistics.median(rate):.0f} samples/s (bare train step, "
            f"phase 6: {bare if bare is None else round(bare)}); with "
            f"validation and checkpoints, run A's epochs ended at "
            f"{[round(t, 1) for t in stats_a['time']]} s")
        log(f"[loop] checkpoint {size} bytes: write "
            f"{statistics.median(writes):.3f} s (median of {len(writes)}), "
            f"read {statistics.median(clock.times['load_checkpoint']):.3f} s")
        log(f"[loop] evaluation in the trainer (float32, {chunks} chunks, "
            f"every sweep persistent): "
            f"{statistics.median(clock.times['evaluate']):.3f} s (median of "
            f"{evals})")

        _qrnn_cli(cli_train, args, work, chunks, sync, on_card, out)

        # evaluate: the last checkpoint of run A against its trainer
        last = os.path.join(dir_a, "checkpoints", sorted(
            c for c in ckpts if c.startswith("ep"))[-1])
        t0 = time.perf_counter()
        text = run_cli(cli_evaluate.main, [
            "--model", last, "--datasets_path", data,
            "--partitions", "validation", "--device", dev.type])
        sync()
        out["evaluate_cli_s"] = time.perf_counter() - t0
        nll = json.loads(text.strip().splitlines()[-1])[
            "validation"]["nll_bits"]
        trainer_nll = stats_a["validation_loss"][-1]
        out.update(evaluate_nll=nll, trainer_validation_nll=trainer_nll)
        log(f"[loop] cli.evaluate: {nll:.6f} bits in "
            f"{out['evaluate_cli_s']:.2f} s; the trainer's last validation "
            f"loss {trainer_nll:.6f}")
        if not abs(nll - trainer_nll) <= 1e-4:
            raise AssertionError("cli.evaluate disagrees with the trainer")

        # generate: 2 utterances of the corpus, every window resident
        utt = names[:2]
        lists = os.path.join(work, "gen_cond.list"), os.path.join(
            work, "gen_spk.list")
        with open(lists[0], "w") as f:
            f.write("\n".join(utt))
        with open(lists[1], "w") as f:
            f.write("0\n1\n")
        lens = [load_cond_tracks(os.path.join(data, "cond"), n)[0].shape[0]
                for n in utt]
        gen_dir = os.path.join(work, "gen")
        _reset_window_counts()              # the generate path starts here
        t0 = time.perf_counter()
        run_cli(cli_generate.main, [
            "--model", last, "--cond_path", os.path.join(data, "cond"),
            "--cond_list", lists[0], "--spk_list", lists[1],
            "--min_max", os.path.join(data, "npy_datasets",
                                      "min_max_ind.npy"),
            "--out_dir", gen_dir, "--device", dev.type, "--engine", "auto"])
        sync()
        wall = time.perf_counter() - t0
        windows = (sample_window.launches, sample_window.resident)
        stem = os.path.basename(last)[:-len(".npz")]
        for name, spk, n in zip(utt, ("0", "1"), lens):
            audio, sr = read_wav(os.path.join(
                gen_dir, f"{stem}_file-{name}_spk-{spk}.wav"))
            if sr != 16000 or audio.shape != (n * 80,) or \
                    not np.isfinite(audio).all():
                raise AssertionError(f"generated {name}: {audio.shape}")
        seconds = sum(lens) * 80 / 16000
        out.update(generate_cli_s=wall, generate_audio_s=seconds,
                   generate_audio_s_per_s=seconds / wall,
                   window_launches=windows[0], window_resident=windows[1])
        log(f"[loop] cli.generate --engine auto: 2 utterances, "
            f"{seconds:.2f} audio-s in {wall:.2f} s = {seconds / wall:.2f} "
            f"audio-s/s (the CLI's wall, loading included); "
            f"{windows[0]} windows, {windows[1]} resident")
        if on_card and windows != (max(lens) * 4,) * 2:
            raise AssertionError(f"windows {windows}, expected "
                                 f"{max(lens) * 4}, all resident")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    RESULTS["loop"] = out

# --------------------------------------------------------------------------
# phase 8: the lane-batched /stream multiplexer
# --------------------------------------------------------------------------

def _reset_window_counts():
    from msnv_tpu_torch.kernels.sample_window import sample_window
    sample_window.launches = 0
    sample_window.resident = sample_window.grid = 0


def _window_counts():
    from msnv_tpu_torch.kernels.sample_window import sample_window
    return (sample_window.launches, sample_window.resident,
            sample_window.grid)


def _check_windows(dev, counts, want, what):
    """Every window of a mux path through the resident kernel."""
    if dev.type == "cuda" and counts != (want, want, 0):
        raise AssertionError(f"{what}: (launches, resident, grid) = "
                             f"{counts}, expected ({want}, {want}, 0)")


class ThreadFailures:
    """Exceptions raised in any thread (the mux pump, the front-ends)
    while installed: a dead pump must fail the phase, not hang it."""

    def __init__(self):
        self.errors = []
        self._old = threading.excepthook

    def __enter__(self):
        def hook(args):
            self.errors.append(args)
            self._old(args)
        threading.excepthook = hook
        return self

    def __exit__(self, *exc):
        threading.excepthook = self._old
        return False

    def check(self, mux):
        if self.errors or not mux._thread.is_alive():
            err = self.errors[0].exc_value if self.errors else None
            raise AssertionError(f"the mux pump died: {err!r}")


def _spk_spec(i, spk_dim):
    """Mixed speakers: stream 0 an equal mix, the others ids in turn."""
    return [1.0 / spk_dim] * spk_dim if i == 0 else i % spk_dim


def _stream_stats(starts, firsts, ends, frames, lookback):
    seconds = frames * lookback / 16000
    rtf = sorted(seconds / (e - s) for s, e in zip(starts, ends))
    ttfa = sorted(f - s for s, f in zip(starts, firsts))
    wall = max(ends) - min(starts)
    return {"streams": len(starts), "frames": frames,
            "audio_s_per_stream": seconds, "wall_s": wall,
            "audio_s_per_s": len(starts) * seconds / wall,
            "rtf_min": rtf[0], "rtf_median": statistics.median(rtf),
            "first_audio_ms_median": statistics.median(ttfa) * 1e3,
            "first_audio_ms_max": ttfa[-1] * 1e3}


def push_host_times(mux):
    """Record the host wall of each masked push the pump dispatches (no
    synchronize: the inputs' copies and the launches, on a card one graph
    replay, and what the host waits for between them)."""
    times = []
    push = mux._tick

    def timed(*args):
        t0 = time.perf_counter()
        out = push(*args)
        times.append(time.perf_counter() - t0)
        return out

    mux._tick = timed
    return times


def mux_engine(loaded, cfg, lanes, frames, K, failures):
    """The multiplexer driven directly: a hand-made masked push leaves
    the inactive lanes bit-equal; then `lanes` streams attach, are fed and
    drain through per-lane sinks."""
    import torch
    from msnv_tpu_torch.serving import StreamMultiplexer
    dev = loaded["mlp"]["embedding"].device
    C = cfg.effective_cond_dim
    mux = StreamMultiplexer(loaded, cfg, lanes=lanes, frames_per_push=K)
    try:
        g = torch.Generator(device=dev).manual_seed(lanes)
        carry0 = mux._carry
        active = torch.arange(lanes, device=dev) % 3 != 0
        carry1, _ = mux._masked_push(
            carry0, torch.rand(lanes, K, C, generator=g, device=dev), active)
        idle = ~active
        frozen = torch.equal(carry1[1][idle], carry0[1][idle]) and all(
            torch.equal(h1[:, idle], h0[:, idle])
            for h1, h0 in zip(carry1[2], carry0[2]))
        if not frozen or torch.equal(carry1[1][active], carry0[1][active]):
            raise AssertionError("the masked push did not freeze exactly "
                                 "the inactive lanes")
        rng = np.random.RandomState(lanes)
        conds = rng.rand(lanes, frames, C).astype(np.float32)
        n_blocks = frames // K
        firsts, ends, pcm = {}, {}, {}
        done = threading.Event()

        def sink(i, data):                  # on the pump thread
            now = time.perf_counter()
            firsts.setdefault(i, now)
            pcm.setdefault(i, []).append(data)
            if len(pcm[i]) == n_blocks:
                ends[i] = now
                if len(ends) == lanes:
                    done.set()

        _reset_window_counts()              # the mux path starts here
        host = push_host_times(mux)
        mux.start()
        t0 = time.perf_counter()
        for i in range(lanes):
            lane = mux.acquire(np.asarray(_spk_spec(i, cfg.spk_dim)))
            mux.set_sink(lane, lambda data, i=i: sink(i, data))
            mux.feed(lane, [conds[i, b * K:(b + 1) * K]
                            for b in range(n_blocks)])
        while not done.wait(timeout=1.0):
            failures.check(mux)
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"mux engine: {len(ends)} of {lanes} "
                                     f"streams done after 600 s")
        counts = _window_counts()
        failures.check(mux)
        ticks = mux.ticks
    finally:
        mux.stop()
    windows = ticks * K * cfg.frame_sizes[-1]
    _check_windows(dev, counts, windows, f"mux engine at {lanes} lanes")
    for i in range(lanes):
        audio = np.frombuffer(b"".join(pcm[i]), "<i2")
        constant = bool(np.all(audio == audio[0]))
        if len(audio) != frames * cfg.lookback or constant:
            raise AssertionError(f"mux engine stream {i}: {len(audio)} "
                                 f"samples, constant {constant}")
    out = _stream_stats([t0] * lanes, [firsts[i] for i in range(lanes)],
                        [ends[i] for i in range(lanes)], frames,
                        cfg.lookback)
    out.update(lanes=lanes, frames_per_push=K, ticks=ticks,
               tick_ms=out["wall_s"] / ticks * 1e3,
               push_host_ms_median=statistics.median(host) * 1e3,
               launches=counts[0], resident=counts[1],
               frozen_lanes_bit_equal=True)
    log(f"[mux] engine, {lanes} lanes x {frames} frames, K {K}: {ticks} "
        f"ticks in {out['wall_s']:.3f} s ({out['tick_ms']:.2f} ms a tick, "
        f"push dispatch {out['push_host_ms_median']:.2f} ms median) "
        f"= {out['audio_s_per_s']:.2f} audio-s/s; per-stream realtime "
        f"x{out['rtf_min']:.3f} (min) / x{out['rtf_median']:.3f} (median); "
        f"first audio {out['first_audio_ms_median']:.1f} / "
        f"{out['first_audio_ms_max']:.1f} ms (median / max); "
        f"{counts[0]} windows, {counts[1]} resident; frozen lanes "
        f"bit-equal")
    return out


def mux_clients(spec):
    """Client side of the HTTP part, in a process of its own (so that its
    sockets do not share the server's interpreter lock): `n` concurrent
    seed-less /stream requests, released together; prints one JSON list
    of per-stream results. Standard library and numpy only."""
    import http.client
    host, port, n, frames, C, spk_dim = (spec[k] for k in (
        "host", "port", "n", "frames", "C", "spk_dim"))
    rng = np.random.RandomState(spec["seed"])
    bodies = [json.dumps({
        "cond": base64.b64encode(rng.rand(frames, C).astype(
            np.float32).tobytes()).decode(),
        "spk": _spk_spec(i, spk_dim)}) for i in range(n)]
    barrier = threading.Barrier(n)
    results = [None] * n

    def one(i):
        c = http.client.HTTPConnection(host, port, timeout=300)
        c.connect()
        barrier.wait()
        t0 = time.perf_counter()
        c.request("POST", "/stream", bodies[i],
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        first, data = None, []
        while True:
            piece = r.read1(1 << 16)
            if not piece:
                break
            if first is None:
                first = time.perf_counter()
            data.append(piece)
        end = time.perf_counter()
        c.close()
        pcm = np.frombuffer(b"".join(data), "<i2")
        results[i] = {"status": r.status, "bytes": int(pcm.nbytes),
                      "start": t0, "first": first, "end": end,
                      "constant": bool(pcm.size and np.all(pcm == pcm[0]))}

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    print(json.dumps(results), flush=True)
    return 0


def _wait_lanes_free(mux):
    """The handlers release their lanes just after the last chunk: wait
    for every lane before the next run needs them all."""
    t0 = time.perf_counter()
    while len(mux._free) < mux.lanes:
        if time.perf_counter() - t0 > 30:
            raise AssertionError(f"{mux.lanes - len(mux._free)} lanes still "
                                 f"held 30 s after their streams")
        time.sleep(0.05)


def mux_http(loaded, ckpt, cfg, lanes, frames, K, seeded_frames, failures):
    """VocoderService(mux_lanes=lanes) behind the asyncio front-end and
    then the threaded one, the clients in another process; then a seeded
    stream through both front-ends, /healthz and the 429 beyond the
    lanes."""
    import http.client
    from msnv_tpu_torch.serving import (VocoderService, make_async_server,
                                        make_server)
    dev = loaded["mlp"]["embedding"].device
    C = cfg.effective_cond_dim
    service = VocoderService(loaded, cfg, frames_per_push=K, mux_lanes=lanes,
                             name=ckpt[1])
    mux = service._mux
    aio = make_async_server(service, "127.0.0.1", 0, timeout_s=120)
    threaded = make_server(service, "127.0.0.1", 0)
    th = threading.Thread(target=threaded.serve_forever, daemon=True)
    proc = None
    try:
        aio.start()
        th.start()
        _reset_window_counts()              # the mux path starts here
        ticks0 = mux.ticks
        host = push_host_times(mux)
        runs = {}
        for frontend, addr in (("aio", aio.server_address),
                               ("threaded", threaded.server_address)):
            spec = {"host": addr[0], "port": addr[1], "n": lanes,
                    "frames": frames, "C": C, "spk_dim": cfg.spk_dim,
                    "seed": 8}
            _wait_lanes_free(mux)
            del host[:]
            tick_before = mux.ticks
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mux-clients",
                 json.dumps(spec)], stdout=subprocess.PIPE, text=True)
            t0 = time.perf_counter()
            while proc.poll() is None:
                failures.check(mux)
                if time.perf_counter() - t0 > 600:
                    raise AssertionError(f"mux HTTP clients ({frontend}) "
                                         f"still running after 600 s")
                time.sleep(0.5)
            out_text = proc.stdout.read()
            if proc.returncode != 0:
                raise AssertionError(f"mux HTTP clients ({frontend}) exited "
                                     f"{proc.returncode}")
            failures.check(mux)
            results = json.loads(out_text.strip().splitlines()[-1])
            want = 2 * frames * cfg.lookback
            bad = [(i, r["status"], r["bytes"])
                   for i, r in enumerate(results)
                   if r["status"] != 200 or r["bytes"] != want
                   or r["constant"]]
            if bad:
                raise AssertionError(f"mux HTTP streams ({frontend}) wrong "
                                     f"(index, status, bytes; {want} "
                                     f"expected): {bad[:8]}")
            run = _stream_stats([r["start"] for r in results],
                                [r["first"] for r in results],
                                [r["end"] for r in results], frames,
                                cfg.lookback)
            run.update(ticks=mux.ticks - tick_before,
                       push_host_ms_median=statistics.median(host) * 1e3)
            run["tick_ms"] = run["wall_s"] / run["ticks"] * 1e3
            runs[frontend] = run
            log(f"[mux] HTTP, {frontend} front-end (clients in another "
                f"process), {lanes} concurrent /stream x {frames} frames: "
                f"all 200 and complete; {run['audio_s_per_s']:.2f} "
                f"audio-s/s over {run['wall_s']:.3f} s ({run['ticks']} "
                f"ticks, {run['tick_ms']:.2f} ms a tick, push dispatch "
                f"{run['push_host_ms_median']:.2f} ms median); per-stream "
                f"realtime x{run['rtf_min']:.3f} (min) / "
                f"x{run['rtf_median']:.3f} (median); first audio "
                f"{run['first_audio_ms_median']:.1f} / "
                f"{run['first_audio_ms_max']:.1f} ms (median / max)")
        ticks = mux.ticks - ticks0
        windows = ticks * K * cfg.frame_sizes[-1]
        counts = _window_counts()
        _check_windows(dev, counts, windows, f"mux over HTTP, {lanes} lanes")
        out = dict(runs["aio"], lanes=lanes, frames_per_push=K,
                   threaded=runs["threaded"])
        log(f"[mux] HTTP: {ticks} ticks, {counts[0]} windows, {counts[1]} "
            f"resident")

        # the per-connection path is bit-equal run to run: a seeded stream
        # through either front-end gives the same bytes
        cond = np.random.RandomState(9).rand(seeded_frames, C).astype(
            np.float32)
        body = {"cond": base64.b64encode(cond.tobytes()).decode(), "spk": 1,
                "seed": 3}
        pcms = []
        for addr in (aio.server_address, threaded.server_address):
            r, pcm = _post(addr, "/stream", body)
            if r.status != 200 or len(pcm) != 2 * seeded_frames * \
                    cfg.lookback:
                raise AssertionError(f"seeded /stream {r.status}, "
                                     f"{len(pcm)} bytes")
            pcms.append(pcm)
        if pcms[0] != pcms[1]:
            raise AssertionError("the seeded stream differs between the "
                                 "asyncio and the threaded front-ends")
        counts = _window_counts()
        seeded_windows = 2 * seeded_frames * cfg.frame_sizes[-1]
        _check_windows(dev, counts, windows + seeded_windows,
                       "mux HTTP + seeded streams")
        c = http.client.HTTPConnection(*aio.server_address, timeout=60)
        c.request("GET", "/healthz")
        health = json.loads(c.getresponse().read())
        c.close()
        if health.get("mux_lanes") != lanes:
            raise AssertionError(f"/healthz {health}")
        _wait_lanes_free(mux)
        held = [mux.acquire(np.asarray(0)) for _ in range(lanes)]
        try:
            r, _ = _post(aio.server_address, "/stream",
                         {"cond": cond[:2].tolist(), "spk": 0})
        finally:
            for lane in held:
                mux.release(lane)
        if r.status != 429:
            raise AssertionError(f"stream {lanes + 1} answered {r.status}")
        failures.check(mux)
        log(f"[mux] seeded /stream ({seeded_frames} frames) byte-equal "
            f"through the asyncio and the threaded front-ends; /healthz "
            f"mux_lanes {lanes}; stream {lanes + 1} answered 429")
        out.update(launches=counts[0], resident=counts[1],
                   seeded_windows=seeded_windows, seeded_equal=True,
                   overload_status=r.status, ticks_both_front_ends=ticks)
        return out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        aio.shutdown()
        threaded.shutdown()
        threaded.server_close()
        service.close()


def phase_mux(ckpt, cfg, dev, runs, http_run, seeded_frames):
    from msnv_tpu_torch.interop import load_npz_params
    loaded = load_npz_params(ckpt[0], cfg, device=dev)
    with ThreadFailures() as failures:
        engine = [mux_engine(loaded, cfg, lanes, frames, 4, failures)
                  for lanes, frames in runs]
        over_http = mux_http(loaded, ckpt, cfg, *http_run, 4, seeded_frames,
                             failures)
    RESULTS["mux"] = {"engine": engine, "http": over_http,
                      "launches": sum(r["launches"] for r in engine)
                      + over_http["launches"]}


# --------------------------------------------------------------------------
# phase 9: the variants (GAN, bottleneck, QRNN) at full width
# --------------------------------------------------------------------------

def _timed_steps(step, n, sync):
    """Wall of each of n calls of step(i), each between synchronizes."""
    walls, outs = [], []
    for i in range(n):
        sync()
        t0 = time.perf_counter()
        outs.append(step(i))
        sync()
        walls.append(time.perf_counter() - t0)
    return walls, outs


def _check_sweeps(dev, cfg, steps, what):
    """4 persistent forward and 4 persistent backward sweeps a step (2
    tiers x n_rnn 2); returns the counts."""
    counts = _gru_counts()
    want = cfg.n_tiers * cfg.n_rnn * steps
    if dev.type == "cuda" and counts != (want,) * 4:
        raise AssertionError(f"{what}: GRU (fwd, persistent, bwd, "
                             f"persistent) = {counts}, expected {want} each")
    return counts


def disc_flops(batch, frames, width, channels):
    """Forward multiply-adds x 2 of the discriminator's eight 5x5 convs on
    a (batch, frames, width) latent."""
    per_pos = 25 * (1 * channels + 7 * channels * channels)
    return 2.0 * batch * frames * width * per_pos


def _variant_cfg(base, **kw):
    import dataclasses
    return dataclasses.replace(base, gru_impl="pallas", **kw)


def _gan_phase(exp, dev, batch, seq_len, channels, out):
    """The samplernn_gan preset's train step: six bf16 steps, the lambda
    ramp, the reversal, the float32 shared-dgrad check, the discriminator's
    own times."""
    import dataclasses

    import torch
    from msnv_tpu_torch.models.discriminator import (discriminator_apply,
                                                     discriminator_init,
                                                     discriminator_nll)
    from msnv_tpu_torch.models.generate import cast_float_tree
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training import gan
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.tree import tree_leaves, tree_map
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = _variant_cfg(exp.model)
    train = dataclasses.replace(exp.train, disc_channels=channels)
    data, target, cond, spk = train_inputs(cfg, batch, seq_len, dev, seed=9)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    disc = discriminator_init(torch.Generator().manual_seed(1), cfg.spk_dim,
                              channels, device=dev)
    params0, disc0 = (tree_map(torch.clone, params),
                      tree_map(torch.clone, disc))
    n_disc = sum(x.numel() for x in tree_leaves(disc))
    opt = make_optimizer(train)
    mo, do = opt.init(params), opt.init(disc)
    state = init_tier_state(cfg, batch, device=dev)
    step = gan.make_gan_train_step(cfg, train, opt, opt,
                                   compute_dtype=torch.bfloat16)
    carry = [params, disc, mo, do, state]
    w_after_first = []

    def one(i):
        res = step(*carry, float(i), data, i == 0, target, cond, spk)
        carry[:], metrics = res[:5], res[5]
        if i == 0:
            w_after_first.append(
                carry[0]["tiers"][-1]["conditioner"]["stack"][0]["w"]
                .clone())
        return metrics

    _reset_gru_counts()                     # the GAN step's path starts here
    walls, metrics = _timed_steps(one, 6, sync)
    counts, types = _check_sweeps(dev, cfg, 6, "GAN step"), _gru_types()
    losses = [float(m["loss"]) for m in metrics]
    disc_losses = [float(m["disc_loss"]) for m in metrics]
    lams = [m["lambda"] for m in metrics]
    log(f"[variants] gan B={batch} seq_len={seq_len} bf16 disc {channels} "
        f"channels ({n_disc} params): losses {[round(x, 4) for x in losses]}"
        f", disc losses {[round(x, 4) for x in disc_losses]}")
    if not all(math.isfinite(x) for x in losses + disc_losses):
        raise AssertionError("non-finite GAN losses")
    for i, lam in enumerate(lams):
        if not torch.equal(lam, gan.lambda_ramp(train, float(i), dev)):
            raise AssertionError(f"lambda at step {i}: {float(lam)}")
    if not any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(disc0), tree_leaves(carry[1]))):
        raise AssertionError("the discriminator did not move")
    # the reversal: the same first step past the ramp (lambda > 0) moves
    # the conditioner stack's first layer otherwise
    p, d = tree_map(torch.clone, params0), tree_map(torch.clone, disc0)
    p, *_, m = step(p, d, opt.init(p), opt.init(d),
                    init_tier_state(cfg, batch, device=dev), 1e6, data, True,
                    target, cond, spk)
    w_rev = p["tiers"][-1]["conditioner"]["stack"][0]["w"]
    if not (float(m["lambda"]) > 0
            and not torch.equal(w_rev, w_after_first[0])):
        raise AssertionError("the reversal did not reach the conditioner")
    del p, d
    ms = statistics.median(walls[2:]) * 1e3
    out.update(gan_batch=batch, gan_ms_per_step=ms,
               gan_samples_per_s=batch * seq_len / (ms / 1e3),
               gan_first_step_ms=walls[0] * 1e3, gan_losses=losses,
               gan_disc_losses=disc_losses,
               gan_lambdas=[float(x) for x in lams],
               gan_disc_channels=channels, gan_disc_params=n_disc,
               gan_gru_counts=counts, gan_gru_types=types)
    log(f"[variants] gan step: {ms:.3f} ms = "
        f"{out['gan_samples_per_s']:.0f} samples/s (median of the last "
        f"{len(walls) - 2} of 6; first {walls[0] * 1e3:.1f} ms); GRU sweeps "
        f"(fwd, persistent, bwd, persistent) {counts}")

    # the discriminator alone, bf16, on this batch's latent shape
    frames, width = seq_len // cfg.lookback, cfg.ind_cond_dim
    lat = torch.randn(batch, frames, width, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    d16 = cast_float_tree(disc0, torch.bfloat16)
    lat16 = lat.to(torch.bfloat16)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(d16)]

    def fwd():
        with torch.no_grad():
            discriminator_apply(d16, lat16)

    def fwd_bwd():
        it = iter(leaves)
        tree = tree_map(lambda _: next(it), d16)
        x = lat16.detach().requires_grad_(True)
        torch.autograd.grad(discriminator_nll(tree, x, spk), leaves + [x])

    flops = disc_flops(batch, frames, width, channels)
    if on_card:
        out["disc_fwd_ms"] = cuda_ms(fwd, 10)
        out["disc_fwd_bwd_ms"] = cuda_ms(fwd_bwd, 10)
        out["disc_fwd_tflops"] = flops / out["disc_fwd_ms"] / 1e9
        out["disc_fwd_bwd_tflops"] = 3 * flops / out["disc_fwd_bwd_ms"] / 1e9
        out["disc_fwd_bound_ms"] = flops / peaks.BF16_FLOPS * 1e3
        log(f"[variants] discriminator bf16 ({batch}, {frames}, {width}): "
            f"forward {out['disc_fwd_ms']:.3f} ms ({flops / 1e12:.2f} TFLOP,"
            f" {out['disc_fwd_tflops']:.0f} TFLOP/s), forward + both "
            f"backward products {out['disc_fwd_bwd_ms']:.3f} ms "
            f"({out['disc_fwd_bwd_tflops']:.0f} TFLOP/s); bound at peak "
            f"bf16 {out['disc_fwd_bound_ms']:.3f} ms forward")
    out["disc_fwd_tflop"] = flops / 1e12

    # float32, TF32 off: the shared discriminator backward against the
    # two-backward form, to 1e-4 of the largest gradient
    class Recorder:
        def init(self, tree):
            return {}

        def update(self, grads, opt_state, tree):
            self.grads = grads
            return tree, opt_state

    main_rec, disc_rec = Recorder(), Recorder()
    f32_step = gan.make_gan_train_step(cfg, train, main_rec, disc_rec)
    args = (init_tier_state(cfg, batch, device=dev), 1e6, data, True,
            target, cond, spk)
    f32_step(params0, disc0, {}, {}, *args)
    grads, d_grads, lam = gan.naive_gan_grads(cfg, train, params0, disc0,
                                              *args)
    errs = {}
    for name, got, want in (("vocoder", main_rec.grads, grads),
                            ("disc", disc_rec.grads, d_grads)):
        scale = max(float(g.abs().max()) for g in tree_leaves(want))
        errs[name] = max(float((a - b).abs().max()) for a, b in
                         zip(tree_leaves(got), tree_leaves(want))) / scale
    log(f"[variants] f32 shared dgrad vs two backwards (lambda "
        f"{float(lam):.4g}): largest |diff| over the largest gradient: "
        f"vocoder {errs['vocoder']:.2e}, discriminator {errs['disc']:.2e}")
    if not max(errs.values()) <= 1e-4:
        raise AssertionError(f"shared dgrad differs: {errs}")
    out["gan_f32_shared_vs_naive"] = errs
    if on_card:
        out["gan_f32_cudnn_tf32_gap"] = _cudnn_tf32_gap(
            gan, Recorder, cfg, train, params0, disc0, args)
    if on_card:
        # what the shared backward saves: the step's gradients (recorded,
        # nothing updated) against the two-backward form, bf16, same inputs
        rec_step = gan.make_gan_train_step(cfg, train, Recorder(),
                                           Recorder(),
                                           compute_dtype=torch.bfloat16)
        out["gan_grads_shared_ms"] = cuda_ms(
            lambda: rec_step(params0, disc0, {}, {}, *args), 5)
        out["gan_grads_two_backward_ms"] = cuda_ms(
            lambda: gan.naive_gan_grads(cfg, train, params0, disc0, *args,
                                        compute_dtype=torch.bfloat16), 5)
        log(f"[variants] bf16 gradients of a GAN step: shared "
            f"discriminator backward {out['gan_grads_shared_ms']:.3f} ms, "
            f"two backwards {out['gan_grads_two_backward_ms']:.3f} ms")
    sync()
    return carry[0]


def _cudnn_tf32_gap(gan, Recorder, cfg, train, params, disc, args):
    """One float32 GAN step (gradients recorded, nothing updated) with
    cuDNN's TF32 on, as PyTorch's default leaves it, and one with it off,
    on the same inputs: the gaps of the losses and of the gradients, each
    over the largest value of the TF32-off step. Leaves TF32 off."""
    import torch
    from msnv_tpu_torch.tree import tree_leaves
    runs = {}
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            main_rec, disc_rec = Recorder(), Recorder()
            *_, metrics = gan.make_gan_train_step(cfg, train, main_rec,
                                                  disc_rec)(
                params, disc, {}, {}, *args)
            runs[tf32] = (metrics, main_rec.grads, disc_rec.grads)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    (m_on, g_on, d_on), (m_off, g_off, d_off) = runs[True], runs[False]

    def tree_gap(a, b):
        scale = max(float(x.abs().max()) for x in tree_leaves(b))
        return max(float((x - y).abs().max()) for x, y in
                   zip(tree_leaves(a), tree_leaves(b))) / scale

    gap = {k: abs(float(m_on[k]) - float(m_off[k])) / abs(float(m_off[k]))
           for k in ("loss", "disc_loss")}
    gap.update(disc_grad=tree_gap(d_on, d_off),
               vocoder_grad=tree_gap(g_on, g_off))
    log(f"[variants] f32 GAN step, cuDNN TF32 on (PyTorch's default) "
        f"against off: loss {gap['loss']:.2e}, disc loss "
        f"{gap['disc_loss']:.2e}, discriminator gradient "
        f"{gap['disc_grad']:.2e}, vocoder gradient {gap['vocoder_grad']:.2e}"
        f" of the largest value (phase 11d's float32 bar: 1e-4)")
    return gap


def _plain_steps(exp_model, train, dev, batch, seq_len, n, what, out, key,
                 **model_kw):
    """n bf16 train steps of a variant with reset on a fixed batch (the
    loss must fall); returns (params, cfg, ms per step, GRU counts)."""
    import torch
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.step import make_train_step
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = _variant_cfg(exp_model, **model_kw)
    data, target, cond, spk = train_inputs(cfg, batch, seq_len, dev, seed=5)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    opt = make_optimizer(train)
    carry = [params, opt.init(params),
             init_tier_state(cfg, batch, device=dev)]
    step = make_train_step(cfg, opt, compute_dtype=torch.bfloat16)

    def one(i):
        res = step(*carry, data, True, target, cond, spk)
        carry[:], loss = res[:3], res[3]
        return float(loss)

    _reset_gru_counts()                     # this variant's path starts here
    walls, losses = _timed_steps(one, n, sync)
    counts, types = _gru_counts(), _gru_types()
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: losses {losses}")
    ms = statistics.median(walls[1:]) * 1e3
    out.update({f"{key}_ms_per_step": ms, f"{key}_batch": batch,
                f"{key}_losses": losses, f"{key}_first_step_ms":
                walls[0] * 1e3, f"{key}_gru_counts": counts,
                f"{key}_gru_types": types})
    log(f"[variants] {what} B={batch} bf16: {ms:.3f} ms/step "
        f"(steps after the first; first {walls[0] * 1e3:.1f} ms), losses "
        f"{[round(x, 4) for x in losses]}, GRU sweeps (fwd, persistent, bwd,"
        f" persistent) {counts}")
    return carry[0], cfg, counts


def _generate_check(params, cfg, dev, batch, frames, what, stream_frames=0):
    """bf16 generation through the kernel, every window resident; with
    stream_frames, a B 1 stream of that many one-frame pushes too.
    Returns (audio-s/s, windows)."""
    import torch
    from msnv_tpu_torch.models.generate import generate_fn, streaming_fn
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    g = torch.Generator(device=dev).manual_seed(6)
    cond = torch.rand(batch, frames, cfg.effective_cond_dim, generator=g,
                      device=dev)
    spk = torch.randint(0, cfg.spk_dim, (batch,), generator=g, device=dev)
    gen = generate_fn(params, cfg, compute_dtype=torch.bfloat16,
                      use_kernel=True)
    gen(cond[:, :1], spk, torch.Generator(device=dev).manual_seed(0))  # warm
    _reset_window_counts()                  # this generation starts here
    sync()
    t0 = time.perf_counter()
    audio, _ = gen(cond, spk, torch.Generator(device=dev).manual_seed(0))
    sync()
    wall = time.perf_counter() - t0
    counts = _window_counts()
    want = frames * cfg.frame_sizes[-1]
    _check_windows(dev, counts, want, f"{what} generation")
    if tuple(audio.shape) != (batch, frames * cfg.lookback) or not (
            torch.isfinite(audio).all() and audio.abs().max() <= 1.0):
        raise AssertionError(f"{what}: generated audio {audio.shape}")
    rate = batch * frames * cfg.lookback / 16000 / wall
    windows = counts[0]
    log(f"[variants] {what} generate_fn B={batch} x {frames} frames: "
        f"{rate:.2f} audio-s/s, windows (launches, resident, grid) "
        f"{counts}")
    if stream_frames:
        init_state, push = streaming_fn(params, cfg,
                                        compute_dtype=torch.bfloat16,
                                        use_kernel=True)
        carry = init_state(1, spk[:1],
                           torch.Generator(device=dev).manual_seed(1))
        _reset_window_counts()              # the stream starts here
        for f in range(stream_frames):
            carry, audio, _ = push(carry, cond[:1, f % frames])
        sync()
        counts = _window_counts()
        _check_windows(dev, counts, stream_frames * cfg.frame_sizes[-1],
                       f"{what} stream")
        if not torch.isfinite(audio).all():
            raise AssertionError(f"{what}: streamed audio not finite")
        windows += counts[0]
        log(f"[variants] {what} streaming_fn B=1 x {stream_frames} pushes: "
            f"windows {counts}")
    return rate, windows


def _gan_cli(dev, dim, batch, seq_len, utts, frames, channels, out):
    """cli.train --variant gan to 1 epoch, resumed to 2, on a corpus of one
    packing unit (batch x (seq_len + 80) x 80 samples: 86 chunks an epoch
    at seq_len 1040); its checkpoint and stats; cli.generate from it on two
    short utterances of a corpus of their own, every window resident."""
    import shutil
    import tempfile

    import torch
    from msnv_tpu_torch.cli import generate as cli_generate
    from msnv_tpu_torch.cli import train as cli_train
    from msnv_tpu_torch.data.corpus import load_cond_tracks
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    build = os.path.join(REPO, "msnv_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="gan-", dir=build)
    try:
        data = os.path.join(work, "datasets")
        make_synthetic_corpus(
            data, n_speakers=6, utts_per_speaker=utts, frames_per_utt=frames,
            cond_len=80, partitions=("train", "validation"), interleave=True)
        short = os.path.join(work, "short")
        _, _, names = make_synthetic_corpus(short, n_speakers=2,
                                            utts_per_speaker=1,
                                            frames_per_utt=100, cond_len=80)
        results = os.path.join(work, "results")
        args = ["--exp", "samplernn-gan", "--frame_sizes", "20", "4",
                "--n_rnn", "2", "--dim", str(dim), "--look_ahead", "true",
                "--weight_norm", "true", "--variant", "gan",
                "--ind_cond_dim", "50", "--disc_channels", str(channels),
                "--seq_len", str(seq_len), "--batch_size", str(batch),
                "--learning_rate", "1e-4", "--bf16", "true",
                "--datasets_path", data, "--results_path", results,
                "--device", dev.type]
        _reset_gru_counts()                 # the CLI's train path starts here
        t0 = time.perf_counter()
        run_cli(cli_train.main, args + ["--epoch_limit", "1"])
        resumed = run_cli(cli_train.main, args + ["--epoch_limit", "2"])
        sync()
        out["cli_train_s"] = time.perf_counter() - t0
        fwd, fwd_p, bwd, bwd_p = _gru_counts()
        f32, types = _gru_f32_counts(), _gru_types()
        if "resumed from" not in resumed:
            raise AssertionError("cli.train --variant gan did not resume")
        stats, exp_dir = _stats(results)
        if not (stats.get("epochs") == [2] and len(stats["disc_loss"]) == 1
                and len(stats["lambda"]) == 1
                and all(math.isfinite(x) for x in stats["training_loss"])):
            raise AssertionError(f"stats.json: {sorted(stats)}")
        ckpts = os.path.join(exp_dir, "checkpoints")
        last = os.path.join(ckpts, sorted(
            c for c in os.listdir(ckpts) if c.startswith("ep2"))[-1])
        with np.load(last) as z:
            keys = set(z.files)
        for key in ("leaf:['disc_params']['blocks'][3]['conv2']['w']",
                    "leaf:['disc_opt_state'][1][0].count",
                    "leaf:['disc_opt_state'][1][0].mu['classifier']['w']"):
            if key not in keys:
                raise AssertionError(f"the checkpoint lacks {key}")
        chunks = len(stats["training_loss"])
        out.update(cli_chunks_per_epoch=chunks, cli_gru_fwd=fwd,
                   cli_gru_fwd_persistent=fwd_p, cli_gru_bwd=bwd,
                   cli_gru_bwd_persistent=bwd_p, cli_gru_types=types,
                   cli_disc_loss=stats["disc_loss"],
                   cli_lambda=stats["lambda"])
        # the train steps' bf16 sweeps and the validation's float32 ones,
        # all persistent
        if dev.type == "cuda" and not (bwd == bwd_p == 4 * 2 * chunks
                                       and fwd == fwd_p
                                       and fwd_p - f32[0] == 4 * 2 * chunks
                                       and f32[1] == 0):
            raise AssertionError(f"cli.train GRU sweeps "
                                 f"{(fwd, fwd_p, bwd, bwd_p)}, float32 "
                                 f"{f32}, for {2 * chunks} steps")
        log(f"[variants] cli.train --variant gan: {chunks} chunks an epoch, "
            f"1 + 1 epochs (resumed) in {out['cli_train_s']:.1f} s; "
            f"disc_loss {stats['disc_loss']}, lambda {stats['lambda']}; "
            f"GRU sweeps fwd {fwd} ({fwd_p} persistent, {f32[0]} of them "
            f"float32), bwd {bwd}")
        utt = names[:2]
        lists = os.path.join(work, "c.list"), os.path.join(work, "s.list")
        with open(lists[0], "w") as f:
            f.write("\n".join(utt))
        with open(lists[1], "w") as f:
            f.write("0\n1\n")
        lens = [load_cond_tracks(os.path.join(short, "cond"), n)[0].shape[0]
                for n in utt]
        _reset_window_counts()              # the generate CLI starts here
        run_cli(cli_generate.main, [
            "--model", last, "--cond_path", os.path.join(short, "cond"),
            "--cond_list", lists[0], "--spk_list", lists[1],
            "--min_max", os.path.join(data, "npy_datasets",
                                      "min_max_ind.npy"),
            "--out_dir", os.path.join(work, "gen"), "--device", dev.type])
        counts = _window_counts()
        _check_windows(dev, counts, max(lens) * 4, "cli.generate (gan)")
        if len(os.listdir(os.path.join(work, "gen"))) != 2:
            raise AssertionError("cli.generate wrote no WAVs")
        log(f"[variants] cli.generate on the GAN checkpoint: windows "
            f"{counts}")
        return counts[0]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_variants(dev, dim, gan_batch, batch, seq_len, channels, gen_batch,
                   cli):
    import dataclasses

    from msnv_tpu_torch.config import preset
    out = {"dim": dim, "seq_len": seq_len}

    def narrow(name):
        exp = preset(name)
        return dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, dim=dim))

    gan_exp, neck, base = (narrow("samplernn_gan"), narrow("bottleneck"),
                           narrow("samplernn"))
    gan_params = _gan_phase(gan_exp, dev, gan_batch, seq_len, channels, out)
    gan_cfg = _variant_cfg(gan_exp.model)
    gru = [out["gan_gru_counts"]]
    _, _, counts = _plain_steps(neck.model, neck.train, dev, batch, seq_len,
                                2, "bottleneck", out, "bottleneck")
    gru.append(counts)
    _check_sweeps(dev, neck.model, 2, "bottleneck step")
    pools = _pool_counts()
    qrnn_params, qrnn_cfg, counts = _plain_steps(
        base.model, base.train, dev, batch, seq_len, 2, "samplernn qrnn",
        out, "qrnn", qrnn=True)
    if counts != (0, 0, 0, 0):
        raise AssertionError(f"a QRNN step launched GRU kernels: {counts}")
    pools = tuple(a - b for a, b in zip(_pool_counts(), pools))
    log(f"[variants] samplernn qrnn: fo-pool launches (fwd, bwd) {pools} "
        f"in 2 steps")
    if dev.type == "cuda" and pools != (8, 8):
        raise AssertionError(f"a QRNN step pooled outside the fo-pool "
                             f"kernel: {pools} launches in 2 steps")
    out["qrnn_pool_launches"] = pools

    rate, windows = _generate_check(gan_params, gan_cfg, dev, gen_batch, 16,
                                    "gan", stream_frames=8)
    out.update(gan_generate_audio_s_per_s=rate, gan_windows=windows)
    rate, w = _generate_check(qrnn_params, qrnn_cfg, dev, gen_batch, 16,
                              "qrnn")
    out.update(qrnn_generate_audio_s_per_s=rate, qrnn_windows=w)
    windows += w
    windows += _gan_cli(dev, dim, *cli, channels, out)
    out["window_launches"] = windows
    out["gru_fwd_launches"] = sum(c[0] for c in gru) + out["cli_gru_fwd"]
    out["gru_bwd_launches"] = sum(c[2] for c in gru) + out["cli_gru_bwd"]
    out.update(_launch_keys(*(out[f"{k}_gru_types"] for k in (
        "gan", "bottleneck", "qrnn", "cli"))))
    RESULTS["variants"] = out


# --------------------------------------------------------------------------
# phase 10: the serving artifact (export, load, serve)
# --------------------------------------------------------------------------

class _ArtifactWindows:
    """The sample-window counts of the artifact's own runs, each set to 0
    just before the run and added up just after (the live runs beside them
    are not counted)."""

    def __init__(self, dev):
        self.dev = dev
        self.total = 0

    def run(self, want, what, fn, *args):
        _reset_window_counts()
        out = fn(*args)
        counts = _window_counts()
        _check_windows(self.dev, counts, want, what)
        self.total += counts[0]
        return out


def _synced_wall(dev, fn):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _push_walls(dev, init_state, push, conds):
    """Host wall of one push per block of `conds` (K, C) from a fresh
    carry, the push's device work included: -> the median in seconds (the
    first push is the warmup)."""
    import torch
    carry = init_state(torch.Generator(device=dev).manual_seed(5))
    walls = []
    for block in conds:
        (carry, _, _), wall = _synced_wall(
            dev, lambda: push(carry, block[None]))
        walls.append(wall)
    return float(np.median(walls[1:]))


def _export_http(art, loaded, cfg, dev, K, seed, windows):
    """VocoderService with the artifact over HTTP: a seeded /stream and a
    bucket /synthesize equal the live path's bytes, an off-bucket request
    is answered live, a mismatched artifact is refused at startup."""
    import dataclasses

    import torch
    from msnv_tpu_torch.data.wavio import pcm16_bytes, wav_bytes
    from msnv_tpu_torch.models.generate import generate_fn, streaming_fn
    from msnv_tpu_torch.serving import VocoderService, make_server
    rng = np.random.RandomState(seed)
    C = cfg.effective_cond_dim
    stream_body = {"cond": rng.rand(2 * K + 1, C).tolist(), "spk": 1,
                   "seed": seed}
    syn_cond = rng.rand(16, C).astype(np.float32)
    syn_body = {"cond": syn_cond.tolist(), "spk": 2, "seed": seed}
    off_body = {"cond": rng.rand(17, C).tolist(), "spk": 3, "seed": seed}

    def serve(service, bodies):
        server = make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            got = []
            for path, body in bodies:
                r, data = _post(server.server_address, path, body)
                if r.status != 200:
                    raise AssertionError(f"{path} answered {r.status}")
                got.append(data)
            return got
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)

    svc = VocoderService(loaded, cfg, frame_bucket=16, frames_per_push=K,
                         artifact=art, name="artifact")
    health = svc.healthz()
    if health["artifact_streams"] != art.stream_buckets:
        raise AssertionError(f"/healthz {health}")
    pcm_art, wav_art = windows.run(
        (2 * K + 1 + 16) * cfg.frame_sizes[-1],
        "the artifact service's /stream and /synthesize", serve, svc,
        [("/stream", stream_body), ("/synthesize", syn_body)])
    if svc._stream_cache or svc._gen_cache:
        raise AssertionError("the artifact service built live callables")
    # an off-bucket request (17 frames: padded to 32) takes the live path
    (off_art,) = serve(svc, [("/synthesize", off_body)])
    live = VocoderService(loaded, cfg, frame_bucket=16, frames_per_push=K,
                          name="live")
    pcm_live, off_live = serve(live, [("/stream", stream_body),
                                      ("/synthesize", off_body)])
    # the live service's /stream on the CPU runs the per-sample path: there
    # the artifact's is held against the live pushes of its own engine
    # (which is what the live service runs on a card)
    l_init, l_push = streaming_fn(loaded, cfg, compute_dtype=torch.bfloat16,
                                  use_kernel=True, frames_per_push=K)
    _, l_push1 = streaming_fn(loaded, cfg, compute_dtype=torch.bfloat16,
                              use_kernel=True, frames_per_push=1)
    scond = torch.tensor(stream_body["cond"], device=dev)[None]
    carry = l_init(1, torch.tensor([1], dtype=torch.int32, device=dev),
                   torch.Generator(device=dev).manual_seed(seed))
    pieces = []
    for start in range(0, 2 * K, K):
        carry, a, _ = l_push(carry, scond[:, start:start + K])
        pieces.append(a)
    carry, a, _ = l_push1(carry, scond[:, 2 * K])
    pieces.append(a)
    if pcm_art != pcm16_bytes(torch.cat(pieces, 1)[0].cpu().numpy()):
        raise AssertionError("the artifact's /stream differs from the live "
                             "pushes")
    if dev.type == "cuda" and pcm_art != pcm_live:
        raise AssertionError("the artifact's /stream differs from the live "
                             "service's")
    if off_art != off_live:
        raise AssertionError("an off-bucket /synthesize differs from the "
                             "live service's")
    # the live service's /synthesize runs the per-sample float32 path: the
    # artifact's is held against the live generation of its own engine
    audio, _ = generate_fn(loaded, cfg, compute_dtype=torch.bfloat16,
                           use_kernel=True)(
        torch.from_numpy(syn_cond)[None].to(dev),
        torch.tensor([2], dtype=torch.int32, device=dev),
        torch.Generator(device=dev).manual_seed(seed))
    if wav_art != wav_bytes(audio[0].cpu().numpy(), 16000):
        raise AssertionError("the artifact's /synthesize differs from the "
                             "live generation")
    bad = dataclasses.replace(cfg, ulaw=not cfg.ulaw)
    try:
        VocoderService(loaded, bad, artifact=art)
    except ValueError as e:
        if "mismatch on ['ulaw']" not in str(e):
            raise
    else:
        raise AssertionError("a mismatched artifact was accepted")
    log(f"[export] HTTP: a seeded /stream ({2 * K + 1} frames) byte-equal "
        f"to the live pushes{' and service' if dev.type == 'cuda' else ''}, "
        f"an off-bucket /synthesize to the live service's, a bucket "
        f"/synthesize to the live generation; a mismatched artifact refused "
        f"at startup")
    return {"stream_bytes": len(pcm_art), "synthesize_bytes": len(wav_art),
            "off_bucket_bytes": len(off_art)}


def _export_f32(export_main, load_artifact, generate_fn, ckpt, loaded, cfg,
                dev, work, cond, spk, seeded):
    """A float32 artifact (msnv-export-torch --engine pallas, no --bf16),
    one generation bucket: its generation equal to the live float32
    generator's for the same seed, every window of its run through the
    grid kernel (the counts set to 0 just before it, read just after)."""
    import torch
    from msnv_tpu_torch.kernels.sample_window import sample_window
    lanes, frames = cond.shape[:2]
    path = os.path.join(work, "f32.msnvt")
    t0 = time.perf_counter()
    run_cli(export_main, [
        "--model", ckpt[0], "--out", path, "--lanes", str(lanes),
        "--frames", str(frames), "--frame_bucket", "1", "--engine", "pallas",
        "--device", dev.type])
    export_s = time.perf_counter() - t0
    art = load_artifact(path)
    want = frames * cfg.frame_sizes[-1]
    _reset_window_counts()                  # the float32 artifact's run
    got = art.call(loaded, cond, spk, seeded())
    counts = (sample_window.launches, sample_window.grid)
    if dev.type == "cuda" and counts != (want, want):
        raise AssertionError(f"float32 artifact: (launches, grid) = "
                             f"{counts}, expected ({want}, {want})")
    live = generate_fn(loaded, cfg, use_kernel=True)(cond, spk, seeded())
    if not (torch.equal(got[1], live[1]) and torch.equal(got[0], live[0])):
        raise AssertionError("the float32 artifact's generation differs "
                             "from the live float32 generator's")
    log(f"[export] float32 artifact (pallas, bucket ({lanes}, {frames})): "
        f"exported in {export_s:.2f} s; its generation equal to the live "
        f"float32 generator's sample for sample; {counts[0]} window "
        f"launches, {counts[1]} grid")
    return {"lanes": lanes, "frames": frames, "export_s": export_s,
            "launches": counts[0], "grid": counts[1]}


def phase_export(ckpt, cfg, dev, lanes, frames, K, pushes):
    """The artifact path at full width: msnv-export-torch from phase 4's
    .npz, load, generation and stream pushes against the live path
    (exact), a trace around one push, the service over HTTP."""
    import glob
    import shutil
    import tempfile

    import torch
    from msnv_tpu_torch.cli.export import main as export_main
    from msnv_tpu_torch.export import load_artifact
    from msnv_tpu_torch.interop import load_npz_params
    from msnv_tpu_torch.kernels.sample_window import (
        pack_window_weights_op, resident_weights)
    from msnv_tpu_torch.models.generate import generate_fn, streaming_fn
    from msnv_tpu_torch.utils.profiling import trace
    bf16 = torch.bfloat16
    card = card_line() if dev.type == "cuda" else "cpu"
    windows_per_frame = cfg.frame_sizes[-1]
    loaded = load_npz_params(ckpt[0], cfg, device=dev)
    work = tempfile.mkdtemp(prefix="export-",
                            dir=os.path.join(REPO, "msnv_tpu_torch", "build"))
    out = {"lanes": lanes, "frames": frames, "frames_per_push": K}
    windows = _ArtifactWindows(dev)
    try:
        path = os.path.join(work, "smoke.msnvt")
        t0 = time.perf_counter()
        printed = run_cli(export_main, [
            "--model", ckpt[0], "--out", path, "--lanes", f"1,{lanes}",
            "--frames", str(frames), "--engine", "pallas", "--bf16",
            "--stream", f"1,{K}", "--device", dev.type])
        out["export_s"] = time.perf_counter() - t0
        out["bytes"] = os.path.getsize(path)
        manifest = json.loads(printed.strip().splitlines()[-1])
        if manifest["bytes"] != out["bytes"] or \
                manifest["platforms"] != [dev.type]:
            raise AssertionError(f"msnv-export-torch printed {manifest}")
        t0 = time.perf_counter()
        art = load_artifact(path)
        out["load_s"] = time.perf_counter() - t0
        if art.buckets != [(1, frames), (lanes, frames)] or \
                art.stream_buckets != [(1, 1), (1, K)]:
            raise AssertionError(f"buckets {art.buckets}, streams "
                                 f"{art.stream_buckets}")
        log(f"[export] msnv-export-torch (pallas, bf16; buckets (1, "
            f"{frames}) and ({lanes}, {frames}); streams 1 and {K}): "
            f"{out['export_s']:.2f} s, {out['bytes']} bytes; load "
            f"{out['load_s']:.2f} s ({card})")

        # generation at B lanes: the artifact against generate_fn (exact)
        g = torch.Generator(device=dev).manual_seed(11)
        C = cfg.effective_cond_dim
        cond = torch.rand(lanes, frames, C, generator=g, device=dev)
        spk = torch.randint(0, cfg.spk_dim, (lanes,), generator=g,
                            device=dev, dtype=torch.int32)
        live_gen = generate_fn(loaded, cfg, compute_dtype=bf16,
                               use_kernel=True)

        def seeded():
            return torch.Generator(device=dev).manual_seed(7)

        want = frames * windows_per_frame
        art_seq = windows.run(want, "artifact generation", art.call, loaded,
                              cond, spk, seeded())
        live_seq = live_gen(cond, spk, seeded())
        if not (torch.equal(art_seq[1], live_seq[1])
                and torch.equal(art_seq[0], live_seq[0])):
            raise AssertionError("the artifact's generation differs from "
                                 "generate_fn's")
        audio_s = lanes * frames * cfg.lookback / 16000
        _, wall_art = windows.run(
            want, "artifact generation", _synced_wall, dev,
            lambda: art.call(loaded, cond, spk, seeded()))
        _, wall_live = _synced_wall(dev, lambda: live_gen(cond, spk,
                                                          seeded()))
        out.update(generate_audio_s_per_s=audio_s / wall_art,
                   live_generate_audio_s_per_s=audio_s / wall_live)
        log(f"[export] generation B={lanes} x {frames} frames equal to "
            f"generate_fn's sample for sample; artifact "
            f"{out['generate_audio_s_per_s']:.2f} audio-s/s, live "
            f"{out['live_generate_audio_s_per_s']:.2f} ({card})")

        # streaming: a K push then a 1-frame tail on one carry, exact
        a_init, a_push = art.streaming(K)
        _, a_push1 = art.streaming(1)
        l_init, l_push = streaming_fn(loaded, cfg, compute_dtype=bf16,
                                      use_kernel=True, frames_per_push=K)
        _, l_push1 = streaming_fn(loaded, cfg, compute_dtype=bf16,
                                  use_kernel=True, frames_per_push=1)
        scond = torch.rand(1, K + 1, C, generator=g, device=dev)
        sspk = torch.tensor([4], dtype=torch.int32, device=dev)

        def art_stream():
            carry = a_init(loaded, sspk, seeded())
            carry, _, s1 = a_push(loaded, carry, scond[:, :K])
            carry, _, s2 = a_push1(loaded, carry, scond[:, K])
            return torch.cat([s1, s2], 1)

        got = windows.run((K + 1) * windows_per_frame, "artifact stream",
                          art_stream)
        carry = l_init(1, sspk, seeded())
        carry, _, s1 = l_push(carry, scond[:, :K])
        carry, _, s2 = l_push1(carry, scond[:, K])
        if not torch.equal(got, torch.cat([s1, s2], 1)):
            raise AssertionError("the artifact's pushes differ from the "
                                 "live pushes")
        pconds = torch.rand(pushes + 1, K, C, generator=g, device=dev)
        walls = windows.run(
            (pushes + 1) * K * windows_per_frame, "artifact pushes",
            _push_walls, dev, lambda gen: a_init(loaded, sspk, gen),
            lambda c, x: a_push(loaded, c, x), pconds)
        live_walls = _push_walls(dev, lambda gen: l_init(1, sspk, gen),
                                 l_push, pconds)
        out.update(push_ms=walls * 1e3, live_push_ms=live_walls * 1e3)
        log(f"[export] B=1 K={K} push then a 1-frame tail equal to the live "
            f"pushes; host wall, median of {pushes}: artifact "
            f"{out['push_ms']:.3f} ms, live {out['live_push_ms']:.3f} ms "
            f"({card})")
        if dev.type == "cuda":
            wh = loaded["mlp"]["hidden"]["w"].T.to(bf16).contiguous()
            wo = loaded["mlp"]["out"]["w"].T.to(bf16).contiguous()
            if resident_weights(wh, wo, cfg.frame_sizes[0]) is None:
                raise AssertionError("the canonical window is not resident")
            out["pack_us"] = 1e3 * cuda_ms(
                lambda: pack_window_weights_op(wh, wo, cfg.frame_sizes[0]),
                20)
            log(f"[export] the push's packing of W_h and W_o: "
                f"{out['pack_us']:.1f} us ({card})")

        # a trace around one push names the window kernel
        tdir = os.path.join(work, "trace")
        carry = a_init(loaded, sspk, seeded())

        def traced_push():
            with trace(tdir):
                a_push(loaded, carry, scond[:, :K])

        windows.run(K * windows_per_frame, "traced push", traced_push)
        (tfile,) = glob.glob(os.path.join(tdir, "*.json"))
        with open(tfile) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        kernel = ("window_resident" if dev.type == "cuda"
                  else "msnv_torch::sample_window")
        if not any(kernel in n for n in names):
            raise AssertionError(f"the trace of a push names no {kernel}")
        log(f"[export] torch.profiler trace of one push names {kernel}")

        out["http"] = _export_http(art, loaded, cfg, dev, K, 3, windows)
        out["f32"] = _export_f32(export_main, load_artifact, generate_fn,
                                 ckpt, loaded, cfg, dev, work,
                                 cond[:, :4], spk, seeded)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if dev.type == "cuda" and windows.total == 0:
        raise AssertionError("the artifact path launched no window kernel")
    out["launches"] = windows.total
    RESULTS["export"] = out
    log(f"[export] {out['launches']} window launches from the artifact, "
        f"all resident")


# --------------------------------------------------------------------------
# phase 11: training and generation over a device mesh (torch.distributed)
# --------------------------------------------------------------------------

MESH_TIMEOUT = 900          # s: a rank that has not finished fails the phase
MESH_REL_TOL = 1e-4         # of the largest reference value (phase 5's bar)


class GradTap:
    """An optimizer that records (a clone of) the gradient tree each update
    receives, then makes the update: the sharded step's reduced gradient,
    read where Adam reads it."""

    def __init__(self, inner):
        self.inner = inner
        self.grads = []

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, opt_state, params):
        from msnv_tpu_torch.tree import tree_map
        self.grads.append(tree_map(lambda g: g.detach().clone(), grads))
        return self.inner.update(grads, opt_state, params)


def _tree_rel_err(got, want):
    """(max |got - want| over every leaf over max |want| over every leaf,
    the three leaves of the largest |got - want|: (key, max |got - want|,
    max |want| of the leaf))."""
    from msnv_tpu_torch.tree import keystr, leaves_with_paths, tree_leaves
    rows = sorted(((keystr(path),
                    float((g.double() - w.double()).abs().max()),
                    float(w.abs().max()))
                   for (path, g), w in zip(leaves_with_paths(got),
                                           tree_leaves(want))),
                  key=lambda r: -r[1])
    top = max(r[2] for r in rows)
    return rows[0][1] / max(top, 1e-30), rows[:3]


def _losses_rel_err(got, want):
    return max(abs(a - b) for a, b in zip(got, want)) / max(
        max(abs(b) for b in want), 1e-30)


def _params_digest(params) -> bytes:
    """sha256 over every leaf's bytes, in tree order."""
    import hashlib

    from msnv_tpu_torch.tree import tree_leaves
    h = hashlib.sha256()
    for x in tree_leaves(params):
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.digest()


def _same_on_every_rank(digest: bytes) -> bool:
    """All ranks' digests equal (an all_gather over the world)."""
    import torch
    import torch.distributed as dist
    mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return all(torch.equal(every[0], d) for d in every)


def _broadcast_to_rank0(tree, dev):
    """broadcast_tree(tree), the mesh's starting state: -> {"drawn_apart":
    the ranks' trees differed before it (each rank draws from its own
    seed), "equal": every rank's tree equals rank 0's after it (rank 0's
    own is left as drawn), "ms": its wall, synchronised, "bytes": the
    tree's, "threads": this rank's CPU thread count}. Raises unless the ranks drew apart and now agree."""
    import torch
    from msnv_tpu_torch.parallel.mesh import broadcast_tree
    from msnv_tpu_torch.tree import tree_leaves
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    apart = not _same_on_every_rank(_params_digest(tree))
    sync()
    t0 = time.perf_counter()
    broadcast_tree(tree)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    out = {"drawn_apart": apart,
           "equal": _same_on_every_rank(_params_digest(tree)), "ms": ms,
           "bytes": sum(x.numel() * x.element_size()
                        for x in tree_leaves(tree)),
           "threads": torch.get_num_threads()}
    if not (out["drawn_apart"] and out["equal"]):
        raise AssertionError(f"the replicas' starting state: {out}")
    return out


def _mesh_world1(exp, dev, batch, seq_len, frames, work):
    """11a: one process, a process group of world 1 (NCCL on the card),
    the (1, 1) mesh against no mesh: three bf16 train steps bit-equal, and
    sharded generation bit-equal to generate_fn with the folded
    generator."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from msnv_tpu_torch.models.generate import generate_fn
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.parallel.generate import sharded_generate_fn
    from msnv_tpu_torch.parallel.mesh import make_mesh
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.step import fold_generator, make_train_step
    from msnv_tpu_torch.tree import tree_leaves
    on_card = dev.type == "cuda"
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(work, "world1.store"), 1),
        rank=0, world_size=1)
    out = {"backend": backend}
    try:
        mesh = make_mesh(1, 1, device=dev)
        cfg = dataclasses.replace(exp.model, gru_impl="pallas")
        data, target, cond, spk = train_inputs(cfg, batch, seq_len, dev)
        runs = {}
        for name in ("none", "mesh"):
            params = init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
            opt = make_optimizer(exp.train)
            opt_state = opt.init(params)
            state = init_tier_state(cfg, batch, device=dev)
            step = make_train_step(cfg, opt, compute_dtype=torch.bfloat16,
                                   mesh=mesh if name == "mesh" else None)
            if name == "mesh":
                _reset_gru_counts()         # the mesh path starts here
            losses = []
            for i in range(3):
                params, opt_state, state, loss = step(
                    params, opt_state, state, data, i == 0, target, cond,
                    spk)
                losses.append(float(loss))
            runs[name] = (losses, params)
        counts = _check_sweeps(dev, cfg, 3, "world-1 mesh step")
        types = _gru_types()
        equal = runs["none"][0] == runs["mesh"][0] and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(runs["none"][1]),
                                              tree_leaves(runs["mesh"][1])))
        log(f"[mesh] 11a world 1 ({backend}), (1, 1) mesh against no mesh, "
            f"3 bf16 steps at B {batch}: losses {runs['mesh'][0]}; losses "
            f"and params bit-equal: {equal}")
        if not equal:
            raise AssertionError("the (1, 1) mesh differs from no mesh")
        out.update(losses=runs["mesh"][0], gru_fwd=counts[0],
                   gru_bwd=counts[2], gru_types=types)

        params = runs["mesh"][1]
        g = torch.Generator(device=dev).manual_seed(4)
        gcond = torch.rand(batch, frames, cfg.effective_cond_dim,
                           generator=g, device=dev)
        gspk = torch.randint(0, cfg.spk_dim, (batch,), generator=g,
                             device=dev)
        _reset_window_counts()
        _, seq = sharded_generate_fn(
            params, cfg, mesh, compute_dtype=torch.bfloat16,
            use_kernel=on_card)(gcond, gspk, 5)
        windows = _window_counts()
        _check_windows(dev, windows, frames * cfg.frame_sizes[-1],
                       "world-1 sharded generation")
        _, local = generate_fn(params, cfg, compute_dtype=torch.bfloat16,
                               use_kernel=on_card)(
            gcond, gspk, fold_generator(dev, 5, 0))
        if not torch.equal(seq, local):
            raise AssertionError("world-1 sharded generation differs from "
                                 "generate_fn with the folded generator")
        log(f"[mesh] 11a sharded generation B {batch} x {frames} frames "
            f"equal to generate_fn with the folded generator; windows "
            f"{windows[0]}, resident {windows[1]}")
        out["windows"] = windows[0]
    finally:
        dist.destroy_process_group()
    return out


def _adam_step_err(got, want, grads, lr):
    """One Adam step's params against the reference's, element by element.
    Where the reference gradient exceeds MESH_REL_TOL of its tree's largest
    value, the gradient check fixes its sign and so the first step
    lr * g / (|g| + eps): there the params must agree within MESH_REL_TOL
    of the largest param. Elsewhere a gradient's last bits may flip its
    sign, and one step moves a param at most lr either way: within 2 lr.
    -> (largest |difference| where fixed over the largest param, largest
    |difference| elsewhere, the elements elsewhere, the largest param)."""
    from msnv_tpu_torch.tree import tree_leaves
    g_top = max(float(g.abs().max()) for g in tree_leaves(grads))
    p_top = max(float(p.abs().max()) for p in tree_leaves(want))
    fixed_err = free_err = 0.0
    free_n = 0
    for a, b, g in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(grads)):
        diff = (a.float() - b.float()).abs()
        fixed = g.abs() > MESH_REL_TOL * g_top
        if fixed.any():
            fixed_err = max(fixed_err, float(diff[fixed].max()))
        if (~fixed).any():
            free_err = max(free_err, float(diff[~fixed].max()))
            free_n += int((~fixed).sum())
    return fixed_err / p_top, free_err, free_n, p_top


def _rank_steps(rank, cfg, train, dev, batch, seq_len, bf16_steps):
    """11b on this rank: for meshes (2, 1) and (1, 2), two float32 steps
    whose losses, reduced gradients and first updated params rank 0 holds
    against one process's unsharded steps; then bf16 steps with the
    replicas' params bit-equal after each, the GRU sweeps counted and
    timed. Each rank draws its params from its own seed (rank 0: 0, the
    reference's), and every sharded run starts from broadcast_tree's
    copy of rank 0's."""
    import torch
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.parallel.mesh import (batch_sharding, gather_params,
                                              make_mesh, param_sharding,
                                              shard_params)
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.training.step import make_train_step
    from msnv_tpu_torch.tree import tree_map
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    batch_in = train_inputs(cfg, batch, seq_len, dev)
    init = init_params(cfg, torch.Generator().manual_seed(rank), device=dev)
    fresh = lambda: tree_map(torch.clone, init)             # noqa: E731
    ref = None
    if rank == 0:
        # one process's unsharded float32 steps (rank 1 waits at the first
        # collective of the sharded ones)
        tap = GradTap(make_optimizer(train))
        params = fresh()
        opt_state = tap.init(params)
        state = init_tier_state(cfg, batch, device=dev)
        step = make_train_step(cfg, tap)
        losses = []
        for i in range(2):
            params, opt_state, state, loss = step(
                params, opt_state, state, batch_in[0], i == 0, *batch_in[1:])
            losses.append(float(loss))
            if i == 0:
                first = tree_map(torch.clone, params)
        ref = (losses, tap.grads, first)
        del params, opt_state, first
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = make_mesh(*shape, device=dev)
        lanes = batch_sharding(mesh).local
        data, target, cond, spk = (lanes(x) for x in batch_in)
        full = fresh()
        start = {"f32": _broadcast_to_rank0(full, dev)}
        specs = param_sharding(mesh, full)
        tap = GradTap(make_optimizer(train))
        step = make_train_step(cfg, tap, mesh=mesh, specs=specs)
        params = shard_params(mesh, full, specs)
        del full
        opt_state = tap.init(params)
        state = init_tier_state(cfg, data.shape[0], device=dev)
        losses = []
        for i in range(2):
            params, opt_state, state, loss = step(
                params, opt_state, state, data, i == 0, target, cond, spk)
            losses.append(float(loss))
            if i == 0:
                first = tree_map(torch.clone,
                                 gather_params(mesh, params, specs))
        grads = [gather_params(mesh, g, specs) for g in tap.grads]
        key = f"{shape[0]}x{shape[1]}"
        row = {"f32_losses": losses}
        if rank == 0:
            row["f32_loss_rel_err"] = _losses_rel_err(losses, ref[0])
            errs = [_tree_rel_err(g, r) for g, r in zip(grads, ref[1])]
            row["f32_grad_rel_err"] = [e[0] for e in errs]
            row["f32_grad_worst_leaves"] = [e[1] for e in errs]
            row["f32_step1_params"] = _adam_step_err(
                first, ref[2], ref[1][0], train.learning_rate)
            row["lr"] = train.learning_rate
        del grads, tap, params, opt_state, first
        row["w_hh_shard_dim"] = specs["tiers"][0]["gru"][0]["w_hh"]

        # bf16: the replicas' params after each step, the sweeps, the time
        full = fresh()
        start["bf16"] = _broadcast_to_rank0(full, dev)
        specs = param_sharding(mesh, full)
        opt = make_optimizer(train)
        step = make_train_step(cfg, opt, mesh=mesh, specs=specs,
                               compute_dtype=torch.bfloat16)
        params = shard_params(mesh, full, specs)
        del full
        opt_state = opt.init(params)
        state = init_tier_state(cfg, data.shape[0], device=dev)
        _reset_gru_counts()
        walls, same, bf16_losses = [], [], []
        for i in range(bf16_steps):
            sync()
            t0 = time.perf_counter()
            params, opt_state, state, loss = step(
                params, opt_state, state, data, i == 0, target, cond, spk)
            bf16_losses.append(float(loss))
            sync()
            walls.append(time.perf_counter() - t0)
            same.append(_same_on_every_rank(_params_digest(
                gather_params(mesh, params, specs))))
        counts = _check_sweeps(dev, cfg, bf16_steps, f"mesh {key} bf16 step")
        types = _gru_types()
        row.update(start=start, bf16_losses=bf16_losses,
                   replicas_bit_equal=same,
                   ms_per_step=[w * 1e3 for w in walls],
                   gru_fwd=counts[0], gru_bwd=counts[2], gru_types=types,
                   gru_fwd_persistent=counts[1],
                   gru_bwd_persistent=counts[3])
        out[key] = row
        del params, opt_state, step
    return out


def _rank_generation(rank, cfg, dev, batch, frames, stream_batch, pushes):
    """11c on this rank: sharded generation and streaming over (2, 1) from
    rank 0's params (this rank's own draw, broadcast), each rank's shard
    against a local run on its lanes with the folded generator, every
    window counted."""
    import torch
    from msnv_tpu_torch.models.generate import generate_fn, streaming_fn
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.parallel.generate import (shard_generator,
                                                  sharded_generate_fn,
                                                  sharded_streaming_fn)
    from msnv_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    on_card = dev.type == "cuda"
    mesh = make_mesh(2, 1, device=dev)
    lanes = batch_sharding(mesh).local
    params = init_params(cfg, torch.Generator().manual_seed(rank),
                         device=dev)
    start = _broadcast_to_rank0(params, dev)
    kw = dict(compute_dtype=torch.bfloat16, use_kernel=on_card)
    g = torch.Generator(device=dev).manual_seed(6)   # the same on both ranks
    C = cfg.effective_cond_dim
    cond = torch.rand(batch, frames, C, generator=g, device=dev)
    spk = torch.randint(0, cfg.spk_dim, (batch,), generator=g, device=dev)
    _reset_window_counts()
    _, seq = sharded_generate_fn(params, cfg, mesh, **kw)(cond, spk, 21)
    gen_windows = _window_counts()
    _check_windows(dev, gen_windows, frames * cfg.frame_sizes[-1],
                   "sharded generation")
    _, local = generate_fn(params, cfg, **kw)(
        lanes(cond), lanes(spk), shard_generator(mesh, 21))
    gen_equal = bool(torch.equal(lanes(seq), local))
    sspk = torch.arange(stream_batch, device=dev) % cfg.spk_dim
    sconds = torch.rand(pushes, stream_batch, C, generator=g, device=dev)
    init_state, push = sharded_streaming_fn(params, cfg, mesh, **kw)
    _reset_window_counts()
    carry = init_state(sspk, 22)
    got = []
    for c in sconds:
        carry, _, samples = push(carry, c)
        got.append(samples)
    stream_windows = _window_counts()
    _check_windows(dev, stream_windows, pushes * cfg.frame_sizes[-1],
                   "sharded streaming")
    init_l, push_l = streaming_fn(params, cfg, **kw)
    lc = init_l(stream_batch // 2, lanes(sspk), shard_generator(mesh, 22))
    ref = []
    for c in sconds:
        lc, _, s = push_l(lc, lanes(c))
        ref.append(s)
    stream_equal = bool(torch.equal(lanes(torch.cat(got, 1)),
                                    torch.cat(ref, 1)))
    return {"start": start,
            "generate_equal": gen_equal, "generate_windows": gen_windows,
            "stream_equal": stream_equal, "stream_windows": stream_windows,
            "seq_shape": list(seq.shape)}


class MlpCapture:
    """While entered, records for every forward of the sample MLP which
    units of its two ReLUs are on (pre-activation > 0), computed at the
    call's own shapes and types, as the forward computes them."""

    def __init__(self):
        self.masks = []

    def __enter__(self):
        import torch
        from msnv_tpu_torch.models import samplernn
        from msnv_tpu_torch.ops.embed_conv import embed_conv
        from msnv_tpu_torch.ops.linear import dense_apply
        self.inner = samplernn.sample_mlp_logits

        def capture(mlp_params, cfg, samples, upper_cond):
            with torch.no_grad():
                pre1 = embed_conv(mlp_params["embedding"],
                                  samplernn.mlp_conv_weight(mlp_params),
                                  samples) + upper_cond
                pre2 = dense_apply(mlp_params["hidden"], torch.relu(pre1))
                self.masks.append((pre1 > 0, pre2 > 0))
            return self.inner(mlp_params, cfg, samples, upper_cond)

        samplernn.sample_mlp_logits = capture
        return self

    def __exit__(self, *exc):
        from msnv_tpu_torch.models import samplernn
        samplernn.sample_mlp_logits = self.inner


def _relu_flips(a, b, diff):
    """ReLU units that two forwards of the same lanes switch differently:
    `a` and `b` are MlpCapture masks (layer 1, layer 2); `diff` the
    difference of the two runs' vocoder gradients. -> {"layer1", "layer2":
    units switched differently; "conv_in_unit", "hidden_row": of them, those
    on the hidden unit of the largest |diff| of mlp.conv_in (its axis 2)
    and on the row of the largest |diff| of mlp.hidden.w}."""
    flips = [x != y for x, y in zip(a, b)]
    conv = diff["mlp"]["conv_in"].abs()
    unit = int(conv.argmax()) % conv.shape[2]
    hid = diff["mlp"]["hidden"]["w"].abs()
    row = int(hid.argmax()) // hid.shape[1]
    return {"layer1": int(flips[0].sum()), "layer2": int(flips[1].sum()),
            "conv_in_unit": int(flips[0][..., unit].sum()),
            "hidden_row": int(flips[1][..., row].sum())}


def _rank_gan(rank, exp, dev, batch, seq_len, channels):
    """11d on this rank: one GAN step over (2, 1) (past the lambda ramp),
    in float32 (the GRU kernels) and in float64 (the plain GRU loop),
    each from rank 0's params and discriminator (this rank's own draws,
    broadcast).
    Rank 0 also runs one process's unsharded steps: float32 on the whole
    batch and on each half of it (the lanes each rank takes), float64 on
    the whole batch; the ReLU units of the sample MLP that the whole batch
    and the halves switch differently are counted."""
    import dataclasses

    import torch
    from msnv_tpu_torch.models.discriminator import discriminator_init
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from msnv_tpu_torch.training.gan import make_gan_train_step
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.tree import tree_map
    cfg = _variant_cfg(exp.model)
    cfg64 = dataclasses.replace(cfg, gru_impl="xla")
    train = dataclasses.replace(exp.train, disc_channels=channels)
    step_idx = float(train.lambda_weight[2])
    batch_in = train_inputs(cfg, batch, seq_len, dev, seed=9)
    params0 = init_params(cfg, torch.Generator().manual_seed(rank),
                          device=dev)
    starts = []

    def run(mesh, lanes=slice(None), cfg=cfg, dtype=None):
        params = tree_map(torch.clone, params0)
        disc = discriminator_init(torch.Generator().manual_seed(1 + 2 * rank),
                                  cfg.spk_dim, channels, device=dev)
        if mesh is not None:
            starts.append({"vocoder": _broadcast_to_rank0(params, dev),
                           "disc": _broadcast_to_rank0(disc, dev)})
        taps = GradTap(make_optimizer(train)), GradTap(make_optimizer(train))
        step = make_gan_train_step(cfg, train, *taps, mesh=mesh,
                                   compute_dtype=dtype)
        data, target, cond, spk = (x[lanes] for x in batch_in)
        if mesh is not None:
            local = batch_sharding(mesh).local
            data, target, cond, spk = (local(x) for x in batch_in)
        state = init_tier_state(cfg, data.shape[0], device=dev)
        with MlpCapture() as cap:
            res = step(params, disc, taps[0].init(params), taps[1].init(disc),
                       state, step_idx, data, True, target, cond, spk)
        metrics = [float(res[5][n]) for n in ("loss", "disc_loss",
                                              "lambda")]
        return metrics, taps[0].grads[0], taps[1].grads[0], cap.masks[0]

    mesh = make_mesh(2, 1, device=dev)
    _reset_gru_counts()
    got = run(mesh)
    counts, types = _gru_counts(), _gru_types()   # float32 products
    want = cfg.n_tiers * cfg.n_rnn
    if dev.type == "cuda" and (counts[0], counts[2]) != (want, want):
        raise AssertionError(f"sharded GAN step: GRU sweeps {counts}")
    got64 = run(mesh, cfg=cfg64, dtype=torch.float64)
    out = {"metrics": got[0], "gru_fwd": counts[0], "gru_bwd": counts[2],
           "gru_types": types, "start": starts}
    if rank != 0:
        return out
    one = run(None)
    half = batch // 2
    a, b = run(None, slice(0, half)), run(None, slice(half, batch))
    halves = [None, tree_map(lambda x, y: (x + y) / 2, a[1], b[1]),
              tree_map(lambda x, y: (x + y) / 2, a[2], b[2])]
    one64 = run(None, cfg=cfg64, dtype=torch.float64)
    out.update(ref_metrics=one[0],
               metrics_rel_err=_losses_rel_err(got[0], one[0]))
    for i, tree in ((1, "vocoder"), (2, "disc")):
        out[f"{tree}_vs_halves"] = _tree_rel_err(got[i], halves[i])
        out[f"{tree}_f64_vs_one"] = _tree_rel_err(got64[i], one64[i])
        out[f"{tree}_vs_one"] = _tree_rel_err(got[i], one[i])
        out[f"{tree}_halves_vs_one"] = _tree_rel_err(halves[i], one[i])
        out[f"{tree}_one_vs_f64"] = _tree_rel_err(one[i], one64[i])
        out[f"{tree}_halves_vs_f64"] = _tree_rel_err(halves[i], one64[i])
    masks = tuple(torch.cat([x, y]) for x, y in zip(a[3], b[3]))
    sub = lambda x, y: x.double() - y.double()          # noqa: E731
    for key, (p, q) in (("halves_vs_one", ((halves[1], masks),
                                          (one[1], one[3]))),
                        ("one_vs_f64", ((one[1], one[3]),
                                        (one64[1], one64[3]))),
                        ("halves_vs_f64", ((halves[1], masks),
                                           (one64[1], one64[3])))):
        out[f"flips_{key}"] = _relu_flips(p[1], q[1],
                                          tree_map(sub, p[0], q[0]))
    out["preact_units"] = int(one[3][1].numel())
    return out


def _mesh_cli_args(data, dim, batch, seq_len, results, epochs, dev):
    return ["--exp", "samplernn", "--frame_sizes", "20", "4",
            "--n_rnn", "2", "--dim", str(dim), "--look_ahead", "true",
            "--seq_len", str(seq_len), "--batch_size", str(batch),
            "--learning_rate", "1e-4", "--datasets_path", data,
            "--device", dev.type, "--results_path", results,
            "--epoch_limit", str(epochs)]


def _rank_cli(rank, dev, data, args_two, args_three):
    """11e on this rank: cli.train for two epochs, then resumed to three;
    this rank's checkpoint writes and loads, its stats.json after the
    first run and the GRU sweeps of both runs."""
    from msnv_tpu_torch.cli import train as cli_train
    from msnv_tpu_torch.training import checkpoint as ckpt
    saves, loads = [], []
    save, load = ckpt.save_checkpoint, ckpt.load_checkpoint

    def counted_save(path, *a, **kw):
        saves.append(os.path.basename(path))
        return save(path, *a, **kw)

    def counted_load(path, *a, **kw):
        loads.append(os.path.basename(path))
        return load(path, *a, **kw)

    ckpt.save_checkpoint, ckpt.load_checkpoint = counted_save, counted_load
    _reset_gru_counts()
    try:
        run_cli(cli_train.main, args_two)
        first, _ = _stats(args_two[args_two.index("--results_path") + 1]) \
            if rank == 0 else (None, None)
        text = run_cli(cli_train.main, args_three)
    finally:
        ckpt.save_checkpoint, ckpt.load_checkpoint = save, load
    counts = _gru_counts()
    return {"saves": saves, "loads": loads, "first_stats": first,
            "resumed_line": "resumed from" in text,
            "gru_fwd": counts[0], "gru_bwd": counts[2],
            "gru_types": _gru_types()}


def _mesh_rank(rank, world, store, work, spec):
    """One rank of 11b-e: a gloo process group over the card (or the CPU
    in the rehearsal); its results pickled into `work`."""
    import pickle
    import traceback
    from datetime import timedelta
    try:
        import torch
        import torch.distributed as dist
        # the ranks run at different CPU thread counts and draw from
        # different seeds: only the broadcast makes their replicas equal
        torch.set_num_threads(2 + rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if spec["cuda"]:
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
        else:
            dev = torch.device("cpu")
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=MESH_TIMEOUT))
        from msnv_tpu_torch.config import preset
        exp = preset("samplernn")
        gan_exp = preset("samplernn_gan")
        if spec["dim"] != 1024:
            exp = _narrow(exp, spec["dim"])
            gan_exp = _narrow(gan_exp, spec["dim"])
        cfg = _variant_cfg(exp.model)
        out = {"steps": _rank_steps(rank, cfg, exp.train, dev, spec["batch"],
                                    spec["seq_len"], 3),
               "generation": _rank_generation(rank, cfg, dev, spec["batch"],
                                              16, 2, 8),
               "gan": _rank_gan(rank, gan_exp, dev, *spec["gan"]),
               "cli": _rank_cli(rank, dev, spec["data"], *spec["cli"])}
        dist.destroy_process_group()
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _narrow(exp, dim):
    import dataclasses
    return dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                              dim=dim))


def _start_ranks(target, world, work, spec):
    """target(rank, world, store, work, spec) in `world` spawned
    processes; _join_ranks waits for them."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = os.path.join(work, "ranks.store")
    procs = [ctx.Process(target=target, args=(rank, world, store, work,
                                              spec))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def _join_ranks(procs, work, deadline_s):
    """Wait for every rank (a rank that fails fails the phase at once);
    kill what outlives the deadline. -> the ranks' pickled results."""
    import pickle
    deadline = time.monotonic() + deadline_s
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after "
                                     f"{deadline_s} s")
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    errors = []
    for rank, p in enumerate(procs):
        err = os.path.join(work, f"rank{rank}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {rank}: exit code {p.exitcode}")
    if errors:
        raise AssertionError("a rank failed:\n" + "\n".join(errors))
    out = []
    for rank in range(len(procs)):
        with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _starts_line(what, starts):
    """Logs one broadcast of the replicas' starting state as every rank saw
    it (starts: each rank's _broadcast_to_rank0 result); raises unless the
    ranks drew apart and every rank then held rank 0's tree."""
    ok = all(s["drawn_apart"] and s["equal"] for s in starts)
    log(f"[mesh] {what}: the ranks drew apart (a seed each, CPU threads "
        f"{[s['threads'] for s in starts]}): "
        f"{all(s['drawn_apart'] for s in starts)}; after "
        f"broadcast_tree every rank's equal to rank 0's draw, bit for bit: "
        f"{all(s['equal'] for s in starts)}; "
        f"{starts[0]['bytes'] / 1e6:.3f} MB, broadcast wall ms per rank "
        f"{[round(s['ms'], 3) for s in starts]}")
    if not ok:
        raise AssertionError(f"{what}: the replicas' starting state {starts}")


def _check_ranks(dev, ranks, spec):
    """The parent's checks of 11b-d on the ranks' results."""
    r0 = ranks[0]
    for key, row in r0["steps"].items():
        for kind in ("f32", "bf16"):
            _starts_line(f"11b mesh {key} {kind} steps",
                         [r["steps"][key]["start"][kind] for r in ranks])
        log(f"[mesh] 11b mesh {key}: f32 losses {row['f32_losses']}, "
            f"against one process: loss {row['f32_loss_rel_err']:.2e}, "
            f"reduced gradients {[f'{e:.2e}' for e in row['f32_grad_rel_err']]}"
            f" of the largest reference value; worst leaves "
            f"{row['f32_grad_worst_leaves']}")
        fixed, free, free_n, p_top = row["f32_step1_params"]
        lr = row["lr"]
        log(f"[mesh] 11b mesh {key}: params after the first step against "
            f"one process's: {fixed:.2e} of the largest param where the "
            f"gradient exceeds {MESH_REL_TOL} of its largest; elsewhere "
            f"({free_n} elements) {free:.2e} (bound 2 lr = {2 * lr:.0e})")
        if not (row["f32_loss_rel_err"] <= MESH_REL_TOL
                and max(row["f32_grad_rel_err"]) <= MESH_REL_TOL
                and fixed <= MESH_REL_TOL
                and free <= 2 * lr + 1e-6 * p_top):
            raise AssertionError(f"mesh {key}: float32 steps off the "
                                 f"unsharded ones: {row}")
        want_dim = 0 if key == "1x2" else None
        if row["w_hh_shard_dim"] != want_dim:
            raise AssertionError(f"mesh {key}: w_hh shard dim "
                                 f"{row['w_hh_shard_dim']}")
        for r in ranks:
            rr = r["steps"][key]
            if not all(rr["replicas_bit_equal"]):
                raise AssertionError(f"mesh {key}: replicas differ after "
                                     f"the bf16 steps "
                                     f"{rr['replicas_bit_equal']}")
            if rr["bf16_losses"] != row["bf16_losses"]:
                raise AssertionError(f"mesh {key}: ranks report different "
                                     f"losses")
        ms = [statistics.median(r["steps"][key]["ms_per_step"][1:])
              for r in ranks]
        log(f"[mesh] 11b mesh {key} bf16, B {spec['batch']}: losses "
            f"{row['bf16_losses']}, replicas bit-equal after every step; "
            f"ms per step per rank {[round(m, 1) for m in ms]} (two ranks "
            f"sharing one card, gloo through the host: not a speed-up); GRU "
            f"sweeps per rank fwd {row['gru_fwd']} (persistent "
            f"{row['gru_fwd_persistent']}), bwd {row['gru_bwd']} "
            f"(persistent {row['gru_bwd_persistent']})")
        row["ms_per_step_median_by_rank"] = ms
    for r in ranks:
        g = r["generation"]
        if not (g["generate_equal"] and g["stream_equal"]):
            raise AssertionError(f"a shard differs from its local run: {g}")
    _starts_line("11c generation", [r["generation"]["start"] for r in ranks])
    for i, what in enumerate(("float32", "float64")):
        for tree in ("vocoder", "disc"):
            _starts_line(f"11d GAN {what} step, {tree}",
                         [r["gan"]["start"][i][tree] for r in ranks])
    g = r0["generation"]
    log(f"[mesh] 11c sharded generation {g['seq_shape']} and 8 streaming "
        f"pushes at B 2 equal per shard to local runs with the folded "
        f"generator; windows per rank (launches, resident, grid): "
        f"generation {g['generate_windows']}, streaming "
        f"{g['stream_windows']}")
    _check_gan_mesh(r0["gan"], spec)


def _check_gan_mesh(gan, spec):
    """11d: the sharded GAN step against one process's unsharded steps.
    Gated: the metrics against the whole batch's; the float32 gradient
    trees against the mean of the two halves' (what the ranks compute, in
    float32, on their lanes); the float64 trees against the whole batch's
    in float64. Reported: float32 against the whole batch in float32,
    where a ReLU of the sample MLP that the float32 forward of 32 lanes
    and of 64 switches differently moves a weight gradient element by a
    whole position's term."""
    fmt = lambda e: f"{e[0]:.2e} {e[1][0]}"            # noqa: E731
    log(f"[mesh] 11d GAN step (2, 1), B {spec['gan'][0]}: metrics "
        f"{gan['metrics']} against one process's {gan['ref_metrics']} "
        f"({gan['metrics_rel_err']:.2e})")
    for tree in ("vocoder", "disc"):
        log(f"[mesh] 11d {tree}, of the largest reference value (worst "
            f"leaf, its max |diff|, its max |ref|): f32 sharded vs the "
            f"halves in one process {fmt(gan[f'{tree}_vs_halves'])}; f64 "
            f"sharded vs one process {fmt(gan[f'{tree}_f64_vs_one'])}; "
            f"reported: f32 sharded vs whole batch "
            f"{fmt(gan[f'{tree}_vs_one'])}, halves vs whole "
            f"{fmt(gan[f'{tree}_halves_vs_one'])}, whole vs f64 "
            f"{fmt(gan[f'{tree}_one_vs_f64'])}, halves vs f64 "
            f"{fmt(gan[f'{tree}_halves_vs_f64'])}")
    for key, what in (("flips_halves_vs_one", "halves vs whole batch, f32"),
                      ("flips_one_vs_f64", "whole batch, f32 vs f64"),
                      ("flips_halves_vs_f64", "halves f32 vs whole f64")):
        f = gan[key]
        log(f"[mesh] 11d sample-MLP ReLU units switched differently, "
            f"{what}: layer 1 {f['layer1']}, layer 2 {f['layer2']} of "
            f"{gan['preact_units']} each; on the hidden unit of the worst "
            f"mlp.conv_in element {f['conv_in_unit']}, on the row of the "
            f"worst mlp.hidden.w element {f['hidden_row']}")
    if not (gan["metrics_rel_err"] <= MESH_REL_TOL and all(
            gan[f"{t}_{k}"][0] <= MESH_REL_TOL
            for t in ("vocoder", "disc")
            for k in ("vs_halves", "f64_vs_one"))):
        raise AssertionError(f"sharded GAN step off the unsharded one: {gan}")


def _check_cli(ranks, one_stats, resumed_stats):
    """11e: rank 0 wrote each checkpoint once, rank 1 none; both ranks
    resumed from the same file; the losses match the one-process run."""
    c0, c1 = ranks[0]["cli"], ranks[1]["cli"]
    if not (c0["saves"] and len(set(c0["saves"])) == len(c0["saves"])
            and c1["saves"] == []):
        raise AssertionError(f"checkpoint writes: rank 0 {c0['saves']}, "
                             f"rank 1 {c1['saves']}")
    if not (c0["loads"] == c1["loads"] and len(c0["loads"]) == 1
            and c0["loads"][0].startswith("ep2-")):
        raise AssertionError(f"resumed from: rank 0 {c0['loads']}, rank 1 "
                             f"{c1['loads']}")
    if not c0["resumed_line"]:
        raise AssertionError("no 'resumed from' in the resumed run")
    two = c0["first_stats"]["training_loss"] + resumed_stats["training_loss"]
    one = one_stats["training_loss"]
    if len(two) != len(one):
        raise AssertionError(f"{len(two)} losses against {len(one)}")
    first5 = max(abs(a - b) for a, b in zip(two[:5], one[:5]))
    every = max(abs(a - b) for a, b in zip(two, one))
    log(f"[mesh] 11e cli.train, two ranks, 2 epochs + 1 resumed against one "
        f"process: {len(two)} losses, max |diff| first five {first5:.2e}, "
        f"all {every:.2e}; rank 0 wrote {c0['saves']}, rank 1 none; both "
        f"resumed from {c0['loads'][0]}")
    if not (first5 <= 1e-3 and every <= 5e-2):
        raise AssertionError("two-rank cli.train losses off the "
                             "one-process run")
    return {"saves": c0["saves"], "resumed_from": c0["loads"][0],
            "loss_diff_first5": first5, "loss_diff_all": every,
            "steps": len(two)}


def phase_mesh(exp, dev, dim, batch, seq_len, frames, gan, cli):
    import shutil
    import tempfile

    import torch
    from msnv_tpu_torch.cli import train as cli_train
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    build = os.path.join(REPO, "msnv_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh-", dir=build)
    out = {}
    try:
        out["world1"] = _mesh_world1(exp, dev, batch, seq_len, frames, work)
        data = os.path.join(work, "datasets")
        cli_dim, cli_batch, utts, utt_frames = cli
        make_synthetic_corpus(data, n_speakers=6, utts_per_speaker=utts,
                              frames_per_utt=utt_frames, cond_len=80,
                              partitions=("train", "validation"),
                              interleave=True)
        args = lambda results, epochs: _mesh_cli_args(  # noqa: E731
            data, cli_dim, cli_batch, seq_len, os.path.join(work, results),
            epochs, dev)
        spec = {"cuda": dev.type == "cuda", "dim": dim, "batch": batch,
                "seq_len": seq_len, "gan": gan, "data": data,
                "cli": (args("ranks", 2), args("ranks", 3))}
        if dev.type == "cuda":
            torch.cuda.empty_cache()   # the ranks share the card
        t0 = time.perf_counter()
        ranks = _join_ranks(_start_ranks(_mesh_rank, 2, work, spec), work,
                            MESH_TIMEOUT)
        out["ranks_wall_s"] = time.perf_counter() - t0
        _check_ranks(dev, ranks, spec)
        resumed, _ = _stats(os.path.join(work, "ranks"))
        run_cli(cli_train.main, args("one", 3))
        one, _ = _stats(os.path.join(work, "one"))
        out["cli"] = _check_cli(ranks, one, resumed)
        out["steps"] = ranks[0]["steps"]
        out["generation"] = ranks[0]["generation"]
        out["gan"] = ranks[0]["gan"]
        # K1 / K2 launches of the mesh paths, both ranks (the local runs
        # they were held against are not counted)
        out["window_launches"] = out["world1"]["windows"] + sum(
            r["generation"]["generate_windows"][0]
            + r["generation"]["stream_windows"][0] for r in ranks)
        for d in ("fwd", "bwd"):
            out[f"gru_{d}_launches"] = out["world1"][f"gru_{d}"] + sum(
                sum(row[f"gru_{d}"] for row in r["steps"].values())
                + r["gan"][f"gru_{d}"] + r["cli"][f"gru_{d}"] for r in ranks)
        out.update(_launch_keys(out["world1"]["gru_types"], *(
            part["gru_types"] for r in ranks
            for part in [*r["steps"].values(), r["gan"], r["cli"]])))
        out["card"] = card_line() if dev.type == "cuda" else "cpu"
    finally:
        shutil.rmtree(work, ignore_errors=True)
    RESULTS["mesh"] = out
    log(f"[mesh] launches on the mesh paths: windows "
        f"{out['window_launches']}, GRU fwd {out['gru_fwd_launches']}, bwd "
        f"{out['gru_bwd_launches']}; ranks' wall {out['ranks_wall_s']:.1f} s")


# --------------------------------------------------------------------------
# phase 12: serving over a mesh, and directory checkpoints
# --------------------------------------------------------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _concurrent_posts(addr, bodies):
    """POST every body to /synthesize at once -> [(status, bytes)]."""
    out = [None] * len(bodies)

    def one(i):
        r, data = _post(addr, "/synthesize", bodies[i])
        out[i] = (r.status, data)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads):
        raise AssertionError("a /synthesize request never returned")
    return out


def _group_seed(seed, n):
    """The service's group seed for n requests that all carry `seed`."""
    folded = seed
    for _ in range(n - 1):
        folded = (folded * 1000003 + seed) % (1 << 63)
    return folded


def _serve_mesh_world1(loaded, ckpt, cfg, dev, work, batch, frames,
                       greedy_frames):
    """12a: one process, a world-1 group (NCCL on the card), a (1, 1)
    mesh: `batch` identical /synthesize requests through the batcher into
    one group, whose WAVs are generate_fn's lanes with
    fold_generator(group seed, 0) (one shard holds every lane); a greedy
    /synthesize byte-equal to the no-mesh service's."""
    import torch
    import torch.distributed as dist
    from msnv_tpu_torch.data.wavio import wav_bytes
    from msnv_tpu_torch.models.generate import generate_fn
    from msnv_tpu_torch.parallel.mesh import make_mesh
    from msnv_tpu_torch.serving import VocoderService, make_server
    from msnv_tpu_torch.training.step import fold_generator
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(work, "serve1.store"), 1),
        rank=0, world_size=1)
    C = cfg.effective_cond_dim
    rng = np.random.RandomState(12)
    cond = rng.rand(frames, C).astype(np.float32)
    spk, seed = 2, 7
    body = {"cond": base64.b64encode(cond.tobytes()).decode(), "spk": spk,
            "seed": seed}
    greedy = {"cond": rng.rand(greedy_frames, C).tolist(),
              "spk": [1.0 / cfg.spk_dim] * cfg.spk_dim, "temperature": 0.0}
    svc = plain = server = None
    try:
        svc = VocoderService(loaded, cfg, frame_bucket=16, max_batch=batch,
                             linger_ms=5000, mesh=make_mesh(1, 1, device=dev),
                             name=ckpt[1])
        plain = VocoderService(loaded, cfg, frame_bucket=16, name=ckpt[1])
        if svc.healthz()["mesh_shards"] != 1:
            raise AssertionError(f"/healthz {svc.healthz()}")
        server = make_server(svc, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        t0 = time.perf_counter()
        got = _concurrent_posts(server.server_address, [body] * batch)
        wall = time.perf_counter() - t0
        if [s for s, _ in got] != [200] * batch or \
                svc._batcher.batch_sizes != [batch]:
            raise AssertionError(f"mesh /synthesize: statuses "
                                 f"{[s for s, _ in got]}, groups "
                                 f"{svc._batcher.batch_sizes}")
        audio, _ = generate_fn(loaded, cfg)(
            torch.from_numpy(np.stack([cond] * batch)).to(dev),
            torch.full((batch,), spk, dtype=torch.int32, device=dev),
            fold_generator(dev, _group_seed(seed, batch), 0))
        audio = audio.cpu().numpy()
        want = [wav_bytes(a[:frames * cfg.lookback], 16000) for a in audio]
        if len(set(want)) != batch or \
                sorted(w for _, w in got) != sorted(want):
            raise AssertionError("the (1, 1) mesh service's /synthesize "
                                 "differs from generate_fn with the folded "
                                 "generator")
        r, mesh_wav = _post(server.server_address, "/synthesize", greedy)
        if r.status != 200 or mesh_wav != plain.synthesize(dict(greedy)):
            raise AssertionError("greedy /synthesize over the (1, 1) mesh "
                                 "differs from the no-mesh service's")
        audio_s = batch * frames * cfg.lookback / 16000
        log(f"[serve-mesh] 12a world 1 ({backend}), (1, 1) mesh: {batch} "
            f"/synthesize x {frames} frames through the batcher in one "
            f"group, bit-equal to generate_fn's lanes with the folded "
            f"generator; {wall:.3f} s ({audio_s / wall:.2f} audio-s/s, the "
            f"per-sample path in float32); greedy /synthesize byte-equal "
            f"to the no-mesh service's")
        return {"backend": backend, "batch": batch, "frames": frames,
                "wall_s": wall, "audio_s_per_s": audio_s / wall}
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        for s in (svc, plain):
            if s is not None:
                s.close()
        dist.destroy_process_group()


def _serving_rank(rank, world, store, work, spec):
    """12b-c on one rank: a gloo group over the card, as torchrun would
    start it, then `python -m msnv_tpu_torch.serving --mesh_data 2`'s
    main (rank 0 serves until SIGINT); this rank's window counts."""
    import pickle
    import traceback
    from datetime import timedelta
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if spec["cuda"]:
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=MESH_TIMEOUT))
        from msnv_tpu_torch.serving import cli
        _reset_window_counts()
        cli.main(spec["argv"])
        out = {"windows": _window_counts(), "returned": time.time()}
        dist.destroy_process_group()
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _healthz(addr, procs, deadline_s=300):
    import http.client
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        try:
            c = http.client.HTTPConnection(*addr, timeout=60)
            c.request("GET", "/healthz")
            r = c.getresponse()
            health = json.loads(r.read())
            c.close()
            return health
        except OSError:
            time.sleep(0.5)
    raise AssertionError("the serving ranks never answered /healthz")


def _serve_mesh_ranks(loaded, ckpt, cfg, dev, work, lanes, frames,
                      synth_frames, K):
    """12b-c: `msnv_tpu_torch.serving --mesh_data 2 --mux_lanes lanes` on
    two gloo ranks sharing the card: /healthz; 4 pairs of identical
    /synthesize requests (lanes 2: one per rank), each pair's WAVs those of
    generate_fn on one lane with fold_generator(group seed, 0) and (.., 1)
    as this process reruns them; `lanes` concurrent /stream clients x
    `frames` frames from a client process, every one complete; SIGINT to
    rank 0, and both ranks return and exit 0 before the deadline. Every
    window of each rank resident."""
    import signal

    import torch
    from msnv_tpu_torch.data.wavio import wav_bytes
    from msnv_tpu_torch.models.generate import generate_fn
    from msnv_tpu_torch.training.step import fold_generator
    port = _free_port()
    addr = ("127.0.0.1", port)
    argv = ["--model", ckpt[0], "--device", dev.type, "--port", str(port),
            "--mesh_data", "2", "--mux_lanes", str(lanes),
            "--frames_per_push", str(K), "--max_batch", "2",
            "--linger_ms", "5000", "--frame_bucket", "16"]
    spec = {"cuda": dev.type == "cuda", "argv": argv}
    C = cfg.effective_cond_dim
    t_start = time.perf_counter()
    procs = _start_ranks(_serving_rank, 2, work, spec)
    proc = None
    try:
        health = _healthz(addr, procs)
        startup = time.perf_counter() - t_start
        if health.get("mesh_shards") != 2 or health.get("mux_lanes") != lanes:
            raise AssertionError(f"/healthz {health}")
        gen = generate_fn(loaded, cfg)
        rng = np.random.RandomState(21)
        t0 = time.perf_counter()
        for pair in range(4):
            cond = rng.rand(synth_frames, C).astype(np.float32)
            spk, seed = pair % cfg.spk_dim, 30 + pair
            body = {"cond": base64.b64encode(cond.tobytes()).decode(),
                    "spk": spk, "seed": seed}
            got = _concurrent_posts(addr, [body, body])
            if [s for s, _ in got] != [200, 200]:
                raise AssertionError(f"/synthesize over 2 ranks: {got}")
            want = []
            for shard in range(2):
                audio, _ = gen(
                    torch.from_numpy(cond[None]).to(dev),
                    torch.tensor([spk], dtype=torch.int32, device=dev),
                    fold_generator(dev, _group_seed(seed, 2), shard))
                want.append(wav_bytes(audio[0].cpu().numpy(), 16000))
            if want[0] == want[1] or sorted(w for _, w in got) != \
                    sorted(want):
                raise AssertionError(f"pair {pair}: a shard differs from "
                                     f"its local run with the folded "
                                     f"generator")
        synth_wall = time.perf_counter() - t0
        log(f"[serve-mesh] 12b /healthz mesh_shards 2, mux_lanes {lanes}; "
            f"8 /synthesize x {synth_frames} frames (4 pairs, one lane a "
            f"rank), every shard equal to its local run with the folded "
            f"generator; {synth_wall:.3f} s with the reruns; ranks up in "
            f"{startup:.1f} s")
        cspec = {"host": addr[0], "port": port, "n": lanes,
                 "frames": frames, "C": C, "spk_dim": cfg.spk_dim,
                 "seed": 13}
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mux-clients",
             json.dumps(cspec)], stdout=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        while proc.poll() is None:
            if any(p.exitcode not in (None, 0) for p in procs):
                raise AssertionError("a serving rank died under the "
                                     "streams")
            if time.perf_counter() - t0 > 600:
                raise AssertionError("mesh /stream clients still running "
                                     "after 600 s")
            time.sleep(0.2)
        if proc.returncode != 0:
            raise AssertionError(f"mesh /stream clients exited "
                                 f"{proc.returncode}")
        results = json.loads(proc.stdout.read().strip().splitlines()[-1])
        want = 2 * frames * cfg.lookback
        bad = [(i, r["status"], r["bytes"]) for i, r in enumerate(results)
               if r["status"] != 200 or r["bytes"] != want or r["constant"]]
        if bad:
            raise AssertionError(f"mesh /stream wrong (index, status, "
                                 f"bytes; {want} expected): {bad[:8]}")
        streams = _stream_stats([r["start"] for r in results],
                                [r["first"] for r in results],
                                [r["end"] for r in results], frames,
                                cfg.lookback)
        t_stop = time.time()
        os.kill(procs[0].pid, signal.SIGINT)
        ranks = _join_ranks(procs, work, 120)
        stop_s = max(r["returned"] for r in ranks) - t_stop
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    windows = [r["windows"] for r in ranks]
    per_tick = K * cfg.frame_sizes[-1]
    launches = windows[0][0]
    if dev.type == "cuda" and (
            any(w != (launches, launches, 0) for w in windows)
            or launches % per_tick
            or launches < -(-frames // K) * per_tick):
        raise AssertionError(f"mesh mux windows per rank (launches, "
                             f"resident, grid): {windows}")
    log(f"[serve-mesh] 12b {lanes} concurrent /stream x {frames} frames "
        f"through the mux over 2 ranks ({lanes // 2} lanes a rank): all 200 "
        f"and complete; {streams['audio_s_per_s']:.2f} audio-s/s over "
        f"{streams['wall_s']:.3f} s; per-stream realtime "
        f"x{streams['rtf_min']:.3f} (min) / x{streams['rtf_median']:.3f} "
        f"(median); first audio {streams['first_audio_ms_median']:.1f} / "
        f"{streams['first_audio_ms_max']:.1f} ms (median / max); windows "
        f"per rank (launches, resident, grid) {windows} (two ranks on one "
        f"card measure no scaling)")
    log(f"[serve-mesh] 12c SIGINT to rank 0: both ranks returned "
        f"{stop_s:.3f} s later and exited 0")
    return {"startup_s": startup, "synth_wall_s": synth_wall,
            "streams": streams, "windows_by_rank": windows,
            "stop_s": stop_s}


def _dcp_state(cfg, train, dev, batch):
    """The full-width train state from seeds: init params, Adam moments
    drawn from a seeded generator, count 7, a random tier state."""
    import torch
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.tree import tree_map
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    opt = make_optimizer(train).init(params)
    g = torch.Generator(device=dev).manual_seed(3)

    def rand(x):
        return torch.rand(x.shape, generator=g, device=dev, dtype=x.dtype)

    return {"params": params,
            "opt_state": {"count": 7, "mu": tree_map(rand, opt["mu"]),
                          "nu": tree_map(rand, opt["nu"])},
            "tier_state": [rand(s) for s in init_tier_state(cfg, batch,
                                                            device=dev)]}


def _dcp_state_shapes(cfg, train, batch):
    """The train state's structure with meta tensors (no draws)."""
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.optim import make_optimizer
    params = init_params(cfg, device="meta")
    opt = make_optimizer(train).init(params)
    return {"params": params, "opt_state": opt,
            "tier_state": init_tier_state(cfg, batch, device="meta")}


def _dcp_layout(mesh, state, zero=False):
    """`state` as this rank stores it over `mesh`, as DTensors
    (Trainer.checkpoint_state(sharded=True)'s form); zeros with zero."""
    import torch
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


def _dir_format(backend):
    """(save, load, the bytes one rank wrote into a checkpoint directory)
    of a directory checkpoint backend, "dcp" or "orbax"."""
    from msnv_tpu_torch.training import checkpoint as ck
    if backend == "dcp":
        return (ck.save_checkpoint_dcp, ck.load_checkpoint_dcp,
                lambda path, rank: os.path.getsize(
                    os.path.join(path, f"__{rank}_0.distcp")))
    return (ck.save_checkpoint_orbax, ck.load_checkpoint_orbax,
            lambda path, rank: _dir_bytes(
                os.path.join(path, f"ocdbt.process_{rank}")))


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _dir_ckpt_rank(rank, world, store, work, spec):
    """12d and 13b-c on one rank (gloo over the card): the full-width state
    saved as spec["backend"] (dcp or orbax) from a (1, 2) mesh, loaded on
    (2, 1), and by rank 0 as `.npz` (the gathered state, for the parent to
    hold the one-process load against); then cli.train with that backend
    over (1, 2): straight to two epochs, and to one then resumed to two."""
    import pickle
    import traceback
    from datetime import timedelta
    try:
        import dataclasses

        import torch
        import torch.distributed as dist
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if spec["cuda"]:
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
        else:
            dev = torch.device("cpu")
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=MESH_TIMEOUT))
        from msnv_tpu_torch.cli import train as cli_train
        from msnv_tpu_torch.config import preset
        from msnv_tpu_torch.parallel.mesh import (barrier, local_tensors,
                                                  make_mesh)
        from msnv_tpu_torch.training.checkpoint import save_checkpoint
        from msnv_tpu_torch.tree import leaves_with_paths
        save_dir, load_dir, rank_bytes = _dir_format(spec["backend"])
        exp = preset("samplernn")
        cfg = dataclasses.replace(exp.model, dim=spec["dim"])
        state = _dcp_state(cfg, exp.train, dev, spec["batch"])
        path = spec["path"]

        def synced(fn):
            barrier()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            barrier()
            return out, time.perf_counter() - t0

        layout = _dcp_layout(make_mesh(1, 2, device=dev), state)
        _, save_s = synced(lambda: save_dir(path, layout, {"epoch": 1}))
        written = rank_bytes(path, rank)
        del layout
        mesh = make_mesh(2, 1, device=dev)
        template = _dcp_layout(mesh, state, zero=True)
        (loaded, meta), load_s = synced(lambda: load_dir(path, template))
        want = local_tensors(_dcp_layout(mesh, state))
        got = dict(leaves_with_paths(local_tensors(loaded)))
        equal = meta == {"epoch": 1} and all(
            torch.equal(got[p], x) if torch.is_tensor(x) else got[p] == x
            for p, x in leaves_with_paths(want))
        npz_save_s = None
        if rank == 0:
            _, npz_save_s = synced(lambda: save_checkpoint(
                spec["npz"], state, {"epoch": 1}))
        else:
            barrier()
            barrier()
        del loaded, template, want, got, state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _reset_gru_counts()                 # the train CLI starts here
        for argv in spec["cli"]:
            run_cli(cli_train.main, argv)
        counts = _gru_counts()
        out = {"save_s": save_s, "load_s": load_s, "written": written,
               "equal": equal, "npz_save_s": npz_save_s,
               "gru_fwd": counts[0], "gru_bwd": counts[2],
               "gru_types": _gru_types()}
        dist.destroy_process_group()
        with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _dir_ckpt_run(exp, dev, work, dim, batch, cli, backend):
    """12d and 13b-c: the ranks (_dir_ckpt_rank) on a corpus of one packing
    unit (no validation partition: the float32 validation sweeps would
    take most of the phase, and the resume is held on the training
    losses); then the state read in this process, bit-equal to rank 0's
    `.npz` of it, and the resumed cli.train's losses equal to the straight
    run's. -> (the ranks' results, the measures, the resumed run's
    checkpoints directory, the corpus)."""
    import dataclasses

    import torch
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    from msnv_tpu_torch.training.checkpoint import load_any
    from msnv_tpu_torch.tree import leaves_with_paths
    cli_dim, cli_batch, seq_len, utts, utt_frames = cli
    data = os.path.join(work, "datasets")
    make_synthetic_corpus(data, n_speakers=6, utts_per_speaker=utts,
                          frames_per_utt=utt_frames, cond_len=80,
                          partitions=("train",), interleave=True)

    def args(results, epochs):
        return _mesh_cli_args(data, cli_dim, cli_batch, seq_len,
                              os.path.join(work, results), epochs, dev) + [
            "--ckpt_backend", backend, "--n_model_shards", "2"]

    path = os.path.join(work, "state", f"ep1-it1.{backend}")
    npz = os.path.join(work, "state", "ep1-it1.npz")
    os.makedirs(os.path.dirname(path))
    spec = {"cuda": dev.type == "cuda", "dim": dim, "batch": batch,
            "path": path, "npz": npz, "backend": backend,
            "cli": [args("straight", 2), args("resumed", 1),
                    args("resumed", 2)]}
    if dev.type == "cuda":
        torch.cuda.empty_cache()      # the ranks share the card
    t0 = time.perf_counter()
    ranks = _join_ranks(_start_ranks(_dir_ckpt_rank, 2, work, spec), work,
                        MESH_TIMEOUT)
    ranks_wall = time.perf_counter() - t0
    if not all(r["equal"] for r in ranks):
        raise AssertionError(f"the {backend} state loaded on (2, 1) differs "
                             f"from the saved one")
    template = _dcp_state_shapes(dataclasses.replace(exp.model, dim=dim),
                                 exp.train, batch)

    def synced(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (full, _), npz_load_s = synced(lambda: load_any(npz, template,
                                                    device=dev))
    (loaded, _), one_load_s = synced(lambda: load_any(path, template,
                                                      device=dev))
    pairs = list(zip(leaves_with_paths(loaded), leaves_with_paths(full)))
    if not all(pa == pb and (torch.equal(a, b) if torch.is_tensor(b)
                             else a == b) for (pa, a), (pb, b) in pairs):
        raise AssertionError(f"the {backend} state loaded in one process "
                             f"differs from the gathered state (rank 0's "
                             f".npz)")
    nbytes = sum(x.numel() * x.element_size()
                 for _, x in leaves_with_paths(full) if torch.is_tensor(x))
    del loaded, full
    out = {"state_bytes": nbytes,
           f"{backend}_bytes_by_rank": [r["written"] for r in ranks],
           f"{backend}_save_s": max(r["save_s"] for r in ranks),
           f"{backend}_load_2x1_s": max(r["load_s"] for r in ranks),
           f"{backend}_load_one_process_s": one_load_s,
           "npz_bytes": os.path.getsize(npz),
           "npz_save_s": ranks[0]["npz_save_s"], "npz_load_s": npz_load_s,
           "ranks_wall_s": ranks_wall,
           "gru_fwd": sum(r["gru_fwd"] for r in ranks),
           "gru_bwd": sum(r["gru_bwd"] for r in ranks),
           **_launch_keys(*(r["gru_types"] for r in ranks))}
    (s_stats, _), (r_stats, r_dir) = (_stats(os.path.join(work, n))
                                      for n in ("straight", "resumed"))
    n = len(r_stats["training_loss"])
    if not (r_stats["epochs"] == [2] and n
            and r_stats["training_loss"] == s_stats["training_loss"][-n:]):
        raise AssertionError(f"cli.train --ckpt_backend {backend} resumed "
                             f"off the straight run")
    out["cli_losses"] = n
    return ranks, out, os.path.join(r_dir, "checkpoints"), data


def _dcp_phase(exp, dev, work, dim, batch, cli):
    """12d: the full-width state (params, Adam moments, tier state) saved
    as dcp from (1, 2) by two gloo ranks, each writing its slices, loaded
    on (2, 1) and in this process bit-equal to the gathered state (rank
    0's `.npz` of it); write and read seconds and bytes beside the
    `.npz`'s; then cli.train --ckpt_backend dcp on both ranks over (1, 2):
    one epoch resumed to two equal to two straight, each rank writing its
    part."""
    ranks, out, ckpts, _ = _dir_ckpt_run(exp, dev, work, dim, batch, cli,
                                         "dcp")
    nbytes, written = out["state_bytes"], out["dcp_bytes_by_rank"]
    if not (nbytes < sum(written) < 1.2 * nbytes
            and min(written) > 0.2 * nbytes):
        raise AssertionError(f"dcp bytes per rank {written} for a state of "
                             f"{nbytes} bytes")
    log(f"[serve-mesh] 12d full-width state {nbytes / 1e9:.3f} GB: dcp from "
        f"(1, 2) written {out['dcp_save_s']:.2f} s, each rank its slices "
        f"({written} bytes); read on (2, 1) {out['dcp_load_2x1_s']:.2f} s "
        f"and in one process {out['dcp_load_one_process_s']:.2f} s, "
        f"bit-equal to the gathered state; rank 0's .npz of it "
        f"{out['npz_bytes'] / 1e9:.3f} GB, written "
        f"{out['npz_save_s']:.2f} s, read {out['npz_load_s']:.2f} s")
    (last,) = [c for c in os.listdir(ckpts) if c.startswith("ep2-")]
    parts = [os.path.getsize(os.path.join(ckpts, last, f"__{r}_0.distcp"))
             for r in (0, 1)]
    if min(parts) < 0.2 * sum(parts):
        raise AssertionError(f"dcp checkpoint parts {parts}")
    log(f"[serve-mesh] 12d cli.train --ckpt_backend dcp, 2 ranks over "
        f"(1, 2), dim {cli[0]}: 1 epoch resumed to 2 equal to 2 straight "
        f"({out['cli_losses']} losses, bit for bit); {last} written in parts "
        f"{parts}; GRU sweeps fwd {out['gru_fwd']}, bwd {out['gru_bwd']}")
    out.update(cli_parts=parts)
    return out


def phase_serve_mesh(ckpt, cfg, exp, dev, world1, ranks, dcp):
    import shutil
    import tempfile
    from msnv_tpu_torch.models.samplernn import init_params
    from msnv_tpu_torch.training.checkpoint import load_any
    build = os.path.join(REPO, "msnv_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="serve-mesh-", dir=build)
    out = {}
    try:
        loaded, _ = load_any(ckpt[0], {"params": init_params(cfg,
                                                             device="meta")},
                             device=dev)
        loaded = loaded["params"]
        out["world1"] = _serve_mesh_world1(loaded, ckpt, cfg, dev, work,
                                           *world1)
        os.makedirs(os.path.join(work, "serve"))
        out["ranks"] = _serve_mesh_ranks(loaded, ckpt, cfg, dev,
                                         os.path.join(work, "serve"), *ranks)
        os.makedirs(os.path.join(work, "dcp"))
        out["dcp"] = _dcp_phase(exp, dev, os.path.join(work, "dcp"), *dcp)
        out["window_launches"] = sum(
            w[0] for w in out["ranks"]["windows_by_rank"])
        for d in ("fwd", "bwd"):
            out[f"gru_{d}_launches"] = out["dcp"][f"gru_{d}"]
            for t in ("bf16", "f32", "bf16_persistent", "f32_persistent"):
                key = f"gru_{d}_{t}_launches"
                out[key] = out["dcp"][key]
        out["card"] = card_line() if dev.type == "cuda" else "cpu"
    finally:
        shutil.rmtree(work, ignore_errors=True)
    RESULTS["serve_mesh"] = out
    log(f"[serve-mesh] launches: windows {out['window_launches']} (the "
        f"mux on both ranks), GRU fwd {out['gru_fwd_launches']}, bwd "
        f"{out['gru_bwd_launches']} (12d's cli.train on both ranks)")


# --------------------------------------------------------------------------
# phase 13: orbax checkpoints, the JAX package's format without jax
# --------------------------------------------------------------------------

ORBAX_FIXTURES = os.path.join(REPO, "tests", "data", "orbax")


def _fixture_template(name):
    """The port template (CPU tensors) of a committed orbax fixture, from
    its msnv_meta.json."""
    import torch
    with open(os.path.join(ORBAX_FIXTURES, f"{name}.orbax",
                           "msnv_meta.json")) as f:
        meta = json.load(f)
    if name != "trainer":
        return {k: torch.zeros(v["shape"], dtype=getattr(torch, v["dtype"]))
                for k, v in meta["leaves"].items()}
    from msnv_tpu_torch.config import ModelConfig, TrainConfig
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.optim import make_optimizer

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    cfg = ModelConfig(**fields(meta["model"]))
    train = TrainConfig(**fields(meta["train"]))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return {"params": params, "opt_state": make_optimizer(train).init(params),
            "tier_state": init_tier_state(cfg, train.batch_size,
                                          device="cpu")}


def _equal_trees(a, b, dev):
    """Same paths, dtypes and bits, every tensor on `dev`'s type."""
    import torch
    from msnv_tpu_torch.tree import leaves_with_paths
    pa, pb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    return len(pa) == len(pb) and all(
        p == q and (x == y if not torch.is_tensor(y) else
                    x.device.type == dev.type and x.dtype == y.dtype
                    and torch.equal(x, y))
        for (p, x), (q, y) in zip(pa, pb))


def _orbax_fixtures(dev, work):
    """13a: fixtures (a)-(c), written by orbax and tensorstore, loaded onto
    `dev` bit-equal to their .npz twins, and written again by the port
    (bytes beside orbax's: the port stores raw zstd blocks); the decoder's
    rate over their chunks' zstd frames on this host."""
    from msnv_tpu_torch.training import ocdbt, zstd
    from msnv_tpu_torch.training.checkpoint import (load_any,
                                                    save_checkpoint_orbax)
    import torch.distributed.tensor  # noqa: F401  (imported by the
    # loader; its first import takes about a second, not a load's time)
    t0 = time.perf_counter()
    lib = zstd.build()
    out = {"decoder_build_s": time.perf_counter() - t0}
    log(f"[orbax] 13a zstd decoder {lib.name}: compiled from "
        f"{os.path.relpath(zstd.SOURCE, REPO)} and loaded in "
        f"{out['decoder_build_s']:.2f} s (no compile when this checkout "
        f"had built it)")
    for name in ("trainer", "sharded", "twoproc"):
        template = _fixture_template(name)
        path = os.path.join(ORBAX_FIXTURES, f"{name}.orbax")
        t0 = time.perf_counter()
        got, meta = load_any(path, template, device=dev)
        load_s = time.perf_counter() - t0
        twin, twin_meta = load_any(path[:-len(".orbax")] + ".npz", template,
                                   device=dev)
        if meta != twin_meta or not _equal_trees(got, twin, dev):
            raise AssertionError(f"fixture {name}.orbax differs from its "
                                 f".npz twin")
        again = os.path.join(work, f"{name}.orbax")
        save_checkpoint_orbax(again, got, meta, scheduled=name == "trainer")
        back, _ = load_any(again, template, device=dev)
        if not _equal_trees(back, got, dev):
            raise AssertionError(f"the port's rewrite of {name}.orbax "
                                 f"differs")
        out[name] = {"load_s": load_s, "orbax_bytes": _dir_bytes(path),
                     "port_bytes": _dir_bytes(again),
                     "processes": len([d for d in os.listdir(path)
                                       if d.startswith("ocdbt.process_")])}
    frames = []
    for name in ("trainer", "sharded", "twoproc"):
        items = ocdbt.Database(os.path.join(ORBAX_FIXTURES,
                                            f"{name}.orbax")).items()
        frames += [ocdbt.value_array(v) for k, v in items.items()
                   if not k.endswith(b"/.zarray")]
    sizes = [zstd.decompress(f).size for f in frames]
    runs, t0 = 0, time.perf_counter()
    while runs < 3 or time.perf_counter() - t0 < 1.0:
        for f, n in zip(frames, sizes):
            zstd.decompress(f, n)
        runs += 1
    wall = time.perf_counter() - t0
    # the largest frame alone (a 32 KiB Huffman-coded float chunk or so)
    big = max(range(len(frames)), key=lambda i: sizes[i])
    reps, t1 = 0, time.perf_counter()
    while reps < 20 or time.perf_counter() - t1 < 0.5:
        zstd.decompress(frames[big], sizes[big])
        reps += 1
    big_wall = time.perf_counter() - t1
    out["decoder"] = {
        "frames": len(frames), "compressed_bytes": sum(f.size for f in frames),
        "decoded_bytes": sum(sizes),
        "mb_per_s": runs * sum(sizes) / wall / 1e6,
        "largest_frame": {"compressed_bytes": int(frames[big].size),
                          "decoded_bytes": sizes[big],
                          "mb_per_s": reps * sizes[big] / big_wall / 1e6}}
    loads = ", ".join(
        f"{n} {out[n]['load_s']:.3f} s, {out[n]['orbax_bytes']} bytes, "
        f"{out[n]['port_bytes']} as the port writes it"
        for n in ("trainer", "sharded", "twoproc"))
    log(f"[orbax] 13a fixtures written by orbax (trainer, 8-device sharded, "
        f"two processes) loaded on {dev.type} bit-equal to their .npz twins "
        f"({loads}); decoder: {len(frames)} frames, {sum(sizes)} bytes, "
        f"{out['decoder']['mb_per_s']:.1f} MB/s; largest frame "
        f"{sizes[big]} bytes at "
        f"{out['decoder']['largest_frame']['mb_per_s']:.1f} MB/s")
    return out


def _orbax_state(exp, dev, work, dim, batch, cli):
    """13b-c: 12d's run with orbax: the full-width state saved from (1, 2)
    by two gloo ranks, each writing its slices into its own database,
    loaded on (2, 1) and in this process bit-equal to rank 0's `.npz`;
    then cli.train --ckpt_backend orbax on both ranks over (1, 2), one
    epoch resumed to two equal to two straight."""
    ranks, out, ckpts, data = _dir_ckpt_run(exp, dev, work, dim, batch,
                                            cli, "orbax")
    nbytes, written = out["state_bytes"], out["orbax_bytes_by_rank"]
    path = os.path.join(work, "state", "ep1-it1.orbax")
    out["orbax_bytes"] = _dir_bytes(path)
    # each rank its 'model' slices, rank 0 the replicated leaves and the
    # tier state: no leaf twice, rank 1 more than a third of the bytes
    if not (nbytes < sum(written) < 1.05 * nbytes
            and written[1] > 0.3 * nbytes):
        raise AssertionError(f"orbax bytes per rank {written} for a state "
                             f"of {nbytes} bytes")
    dcp = RESULTS.get("serve_mesh", {}).get("dcp")
    beside = "" if dcp is None else (
        f"; dcp in this run (12d) written {dcp['dcp_save_s']:.2f} s, read "
        f"{dcp['dcp_load_2x1_s']:.2f} / {dcp['dcp_load_one_process_s']:.2f}"
        f" s")
    log(f"[orbax] 13b full-width state {nbytes / 1e9:.3f} GB: orbax from "
        f"(1, 2) written {out['orbax_save_s']:.2f} s, each rank its slices "
        f"({written} bytes, {out['orbax_bytes']} in all); read on (2, 1) "
        f"{out['orbax_load_2x1_s']:.2f} s and in one process "
        f"{out['orbax_load_one_process_s']:.2f} s, bit-equal to the "
        f"gathered state; rank 0's .npz {out['npz_bytes'] / 1e9:.3f} GB, "
        f"written {out['npz_save_s']:.2f} s, read "
        f"{out['npz_load_s']:.2f} s{beside}")
    (last,) = [c for c in os.listdir(ckpts) if c.startswith("ep2-")]
    parts = [_dir_bytes(os.path.join(ckpts, last, f"ocdbt.process_{r}"))
             for r in (0, 1)]
    if not last.endswith(".orbax") or min(parts) < 0.2 * sum(parts):
        raise AssertionError(f"orbax checkpoint {last}: parts {parts}")
    log(f"[orbax] 13c cli.train --ckpt_backend orbax, 2 ranks over (1, 2), "
        f"dim {cli[0]}: 1 epoch resumed to 2 equal to 2 straight "
        f"({out['cli_losses']} losses, bit for bit); {last} written in "
        f"parts {parts}; GRU sweeps fwd {out['gru_fwd']}, bwd "
        f"{out['gru_bwd']}")
    out.update(cli_parts=parts, cli_checkpoint=os.path.join(ckpts, last),
               cli_data=data)
    return out


def _orbax_generate(dev, work, ckpt, data):
    """13d: cli.generate from 13c's `.orbax` and from an `.npz` of the same
    state: greedy (the per-sample path) and sampled with one seed (the
    sample-window kernel on a card), each pair of WAVs byte-equal; one
    short utterance a speaker of two."""
    import filecmp

    from msnv_tpu_torch.cli import generate as cli_generate
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    from msnv_tpu_torch.training.checkpoint import load_any, save_checkpoint
    cond_root = os.path.join(work, "gen_cond")
    _, cond_dir, names = make_synthetic_corpus(
        cond_root, n_speakers=2, utts_per_speaker=1, frames_per_utt=12,
        cond_len=80, uneven_lengths=False)
    lists = os.path.join(work, "gen_cond.list"), os.path.join(
        work, "gen_spk.list")
    with open(lists[0], "w") as f:
        f.write("\n".join(names))
    with open(lists[1], "w") as f:
        f.write("0\n1\n")
    from msnv_tpu_torch.config import parse_tag, tag_from_checkpoint_path
    from msnv_tpu_torch.models.samplernn import init_params
    cfg = parse_tag(tag_from_checkpoint_path(ckpt)).model
    state, meta = load_any(ckpt, {"params": init_params(cfg,
                                                        device="meta")},
                           device="cpu")
    npz = ckpt[:-len(".orbax")] + ".npz"
    save_checkpoint(npz, state, meta)
    out = {"utterances": len(names)}
    _reset_window_counts()                  # the generate CLI starts here
    for mode, extra in (("greedy", ["--temperature", "0"]),
                        ("sampled", ["--seed", "5"])):
        dirs = []
        for fmt, model in (("orbax", ckpt), ("npz", npz)):
            d = os.path.join(work, f"gen_{mode}_{fmt}")
            t0 = time.perf_counter()
            run_cli(cli_generate.main, [
                "--model", model, "--cond_path", cond_dir,
                "--cond_list", lists[0], "--spk_list", lists[1],
                "--min_max", os.path.join(data, "npy_datasets",
                                          "min_max_ind.npy"),
                "--out_dir", d, "--device", dev.type] + extra)
            out[f"{mode}_{fmt}_s"] = time.perf_counter() - t0
            dirs.append(d)
        wavs = sorted(os.listdir(dirs[0]))
        if len(wavs) != len(names) or wavs != sorted(os.listdir(dirs[1])) \
                or not all(filecmp.cmp(os.path.join(dirs[0], w),
                                       os.path.join(dirs[1], w),
                                       shallow=False) for w in wavs):
            raise AssertionError(f"cli.generate ({mode}) from the .orbax "
                                 f"differs from the .npz's")
    windows = _window_counts()
    out.update(window_launches=windows[0], window_resident=windows[1])
    if dev.type == "cuda" and windows[0] == 0:
        raise AssertionError("sampled cli.generate launched no window")
    log(f"[orbax] 13d cli.generate from the .orbax and the .npz, greedy and "
        f"sampled (seed 5): {len(names)} WAVs each, byte-equal; "
        f"{windows[0]} windows ({windows[1]} resident)")
    return out


def phase_orbax(exp, dev, dim, batch, cli):
    import shutil
    import tempfile
    build = os.path.join(REPO, "msnv_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="orbax-", dir=build)
    out = {}
    try:
        os.makedirs(os.path.join(work, "fixtures"))
        out["fixtures"] = _orbax_fixtures(dev, os.path.join(work,
                                                            "fixtures"))
        os.makedirs(os.path.join(work, "ranks"))
        out["state"] = _orbax_state(exp, dev, os.path.join(work, "ranks"),
                                    dim, batch, cli)
        out["generate"] = _orbax_generate(
            dev, work, out["state"].pop("cli_checkpoint"),
            out["state"].pop("cli_data"))
        out["window_launches"] = out["generate"]["window_launches"]
        out["window_resident"] = out["generate"]["window_resident"]
        for d in ("fwd", "bwd"):
            out[f"gru_{d}_launches"] = out["state"][f"gru_{d}"]
            for t in ("bf16", "f32", "bf16_persistent", "f32_persistent"):
                key = f"gru_{d}_{t}_launches"
                out[key] = out["state"][key]
        out["card"] = card_line() if dev.type == "cuda" else "cpu"
    finally:
        shutil.rmtree(work, ignore_errors=True)
    RESULTS["orbax"] = out
    log(f"[orbax] launches: windows {out['window_launches']} (13d's "
        f"sampled cli.generate), GRU fwd {out['gru_fwd_launches']}, bwd "
        f"{out['gru_bwd_launches']} (13c's cli.train on both ranks)")


# --------------------------------------------------------------------------

def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def build_kernels():
    """Phase 1: one nvcc process per source, all started together."""
    from msnv_tpu_torch.kernels import fo_pool, gru_layer, sample_window
    t0 = time.perf_counter()
    errors = []

    def run(mod):
        try:
            mod.build()
        except Exception as e:              # re-raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(m,))
               for m in (sample_window, gru_layer, fo_pool)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    RESULTS["build_s"] = time.perf_counter() - t0
    log(f"[build] sample_window.cu, gru_layer.cu and fo_pool.cu in "
        f"{RESULTS['build_s']:.1f} s")
    for mod in (sample_window, gru_layer, fo_pool):
        kernel = ""
        for line in mod.build_log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif ("registers" in line or "spill" in line
                  or "warning" in line.lower()):
                log(f"[build] {mod.SOURCE.name} {kernel}: {line.strip()}")


def kernel_entries():
    main_shape = next(r for r in RESULTS["shapes"] if r["batch"] == 1)
    window = {
        "name": "sample_window",
        "route": "cuda",
        "source": "msnv_tpu_torch/csrc/sample_window.cu",
        "replaces": "msnv_tpu/pallas/sample_kernel.py:157",
        "also_replaces": ["msnv_tpu/pallas/sample_kernel.py:44",
                          "msnv_tpu/pallas/sample_kernel.py:183"],
        # the serving path (phase 4), the generate CLI (phase 7), the
        # multiplexer (phase 8; every one of its windows resident), the
        # variants (phase 9), the serving artifact (phase 10), sharded
        # generation and streaming on every rank (phase 11), the mux
        # over a serving mesh on every rank (phase 12) and the generate
        # CLI from an orbax checkpoint (phase 13)
        "launches": RESULTS["launches"] + RESULTS["loop"]["window_launches"]
        + RESULTS["mux"]["launches"] + RESULTS["variants"]["window_launches"]
        + RESULTS["export"]["launches"] + RESULTS["mesh"]["window_launches"]
        + RESULTS["serve_mesh"]["window_launches"]
        + RESULTS["orbax"]["window_launches"],
        # phase 9's to 12's windows are all resident (checked there);
        # phase 13's as counted
        "resident_launches": RESULTS["resident_launches"]
        + RESULTS["loop"]["window_resident"] + RESULTS["mux"]["launches"]
        + RESULTS["variants"]["window_launches"]
        + RESULTS["export"]["launches"] + RESULTS["mesh"]["window_launches"]
        + RESULTS["serve_mesh"]["window_launches"]
        + RESULTS["orbax"]["window_resident"],
        "launches_by_path": {"serve": RESULTS["launches"],
                             "generate_cli": RESULTS["loop"][
                                 "window_launches"],
                             "mux": RESULTS["mux"]["launches"],
                             "variants": RESULTS["variants"][
                                 "window_launches"],
                             "export": RESULTS["export"]["launches"],
                             "mesh": RESULTS["mesh"]["window_launches"],
                             "serve_mesh": RESULTS["serve_mesh"][
                                 "window_launches"],
                             "orbax": RESULTS["orbax"]["window_launches"]},
        # bf16 (resident kernel): share of samples that differ from the
        # plain version's on sharpened logits, tolerance 1 %
        "bf16_mismatch": RESULTS["bf16_mismatch"],
        "philox_mismatch": RESULTS["philox_mismatch"],
        "window_plan": RESULTS["window_plan"],
        "ms": main_shape["ms"],
        "empty_window_ms": main_shape["empty_window_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "library_ms": None,
        "main_shape": {"batch": 1, "fs0": FS0, "q": Q, "dim": DIM,
                       "dtype": "bfloat16", "mode": "philox"},
        "shapes": RESULTS["shapes"],
        "tiny_shapes": RESULTS["tiny_shapes"],
    }
    # the GRU kernels at the bottom tier's sweep (T 52), where a train step
    # spends most of its GRU time; one "launch" is one layer sweep, counted
    # on the train steps (phase 6), the training loop (phase 7: train steps
    # and validation), the variants' train steps and train CLI (phase 9),
    # the sharded steps and cli.train on every rank (phase 11) and
    # cli.train with dcp (phase 12) and orbax checkpoints (phase 13) on
    # every rank. Each entry counts the sweeps whose products are of its
    # type, by the wrappers' per-type counters, and those of them that took
    # the persistent kernel.
    paths = ("train", "loop", "variants", "mesh", "serve_mesh", "orbax")
    names = {"train": "train_step", "loop": "train_loop"}

    def by_path(key):
        return {names.get(p, p): RESULTS[p][key] for p in paths}

    def entry(d, line, mxu, kind, lib, note):
        row = next(r for r in RESULTS["gru_shapes"]
                   if r["T"] == 52 and r["dtype"] == mxu)
        suffix = "_bf16" if mxu == "bfloat16" else ""
        out = {
            "name": f"gru_layer_{d}" + ("" if mxu == "bfloat16" else "_f32"),
            "route": "cuda",
            "source": "msnv_tpu_torch/csrc/gru_layer.cu",
            "replaces": f"msnv_tpu/pallas/gru_kernel.py:{line}",
            "launches": sum(by_path(f"gru_{d}_{kind}_launches").values()),
            "launches_by_path": by_path(f"gru_{d}_{kind}_launches"),
            "persistent_launches": sum(by_path(
                f"gru_{d}_{kind}_persistent_launches").values()),
            # against the plain version in the same products' type; largest
            # |kernel - plain| over max(1, |plain|)
            "max_abs_err": RESULTS["gru_err"][d + suffix],
            "ms": row[f"{d}_ms"],
            "plain_ms": row[f"{d}_plain_ms"],
            "bound_ms": row[f"{d}_bound_ms"],
            "library_ms": lib(row),
            "library_note": note,
            "main_shape": {k: row[k] for k in ("T", "B", "H", "dtype")},
            "shapes": [r for r in RESULTS["gru_shapes"]
                       if r["dtype"] == mxu],
        }
        if mxu == "bfloat16":
            out["empty_sweep_ms"] = row["empty_sweep_ms"]
        return out

    gru = []
    for d, line in (("fwd", 111), ("bwd", 167)):
        lib = {"fwd": lambda r: r["nn_gru_fwd_ms"],
               "bwd": lambda r: r["nn_gru_fwd_bwd_ms"] - r["nn_gru_fwd_ms"]}[d]
        for mxu in ("bfloat16", "float32"):
            what = ("forward" if d == "fwd" else
                    "forward+backward minus forward")
            note = (f"torch.nn.GRU(1024, 1024) {what} in {mxu}"
                    + (", TF32 off" if mxu == "float32" else "")
                    + "; it also does the input projection"
                    + ("'s and the weights' gradients" if d == "bwd"
                       else ""))
            kind = "f32" if mxu == "float32" else "bf16"
            gru.append(entry(d, line, mxu, kind, lib, note))
    # the grid kernel: float32 windows, at B 128 (phase 3's batch); its
    # launches are phase 3's float32 generation (the sharpened greedy check
    # and B 128 x 16 frames) and phase 10's float32 artifact
    f32 = next(r for r in RESULTS["f32_shapes"] if r["batch"] == 128)
    by_path = {"generate_f32": RESULTS["generate_f32"]["launches"]
               + RESULTS["generate_f32"]["sharpened_launches"],
               "export_f32": RESULTS["export"]["f32"]["launches"]}
    grid = {
        "name": "sample_window_grid",
        "route": "cuda",
        "source": "msnv_tpu_torch/csrc/sample_window.cu",
        "replaces": "msnv_tpu/pallas/sample_kernel.py:44",
        "also_replaces": ["msnv_tpu/pallas/sample_kernel.py:157",
                          "msnv_tpu/pallas/sample_kernel.py:183"],
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        # float32, given noise and Philox: samples equal to the plain
        # version's (TF32 off)
        "exact": RESULTS["grid_max_abs_err"] == 0,
        "max_abs_err": RESULTS["grid_max_abs_err"],
        "ms": f32["ms"],
        "empty_window_ms": f32["empty_window_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "library_ms": None,
        "main_shape": {"batch": 128, "fs0": FS0, "q": Q, "dim": DIM,
                       "dtype": "float32", "mode": "philox"},
        "shapes": RESULTS["f32_shapes"],
    }
    # the fo-pool kernels (QRNN tiers) at the bottom tier's sweep (T 52,
    # bf16, the QRNN train cell's); one launch is one layer's sweep, counted
    # on the training loop's run Q (phase 7: train steps, and validation
    # forward) and the variants' QRNN train steps (phase 9)
    pools = []
    for i, d in enumerate(("fwd", "bwd")):
        row = next(r for r in RESULTS["pool_shapes"]
                   if r["T"] == 52 and r["dtype"] == "bfloat16")
        by_path = {"train_loop": RESULTS["loop"][f"qrnn_pool_{d}_launches"],
                   "variants": RESULTS["variants"]["qrnn_pool_launches"][i]}
        pools.append({
            "name": f"fo_pool_{d}",
            "route": "cuda",
            "source": "msnv_tpu_torch/csrc/fo_pool.cu",
            "replaces": None,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            # against the plain version in the same type, both types;
            # largest |kernel - plain| over max(1, |plain|)
            "max_abs_err": max(RESULTS["pool_err"][d],
                               RESULTS["pool_err"][d + "_bf16"]),
            "ms": row[f"{d}_ms"],
            "plain_ms": row[f"{d}_plain_ms"],
            "bound_ms": row[f"{d}_bound_ms"],
            "library_ms": None,
            "main_shape": {k: row[k] for k in ("T", "B", "H", "dtype")},
            "shapes": RESULTS["pool_shapes"],
        })
    return [window, grid] + gru + pools


def main(argv):
    import torch
    if argv[:1] == ["--mux-clients"]:
        return mux_clients(json.loads(argv[1]))
    rehearse = "--rehearse-cpu" in argv
    phases = set(range(1, 14))
    for a in argv:
        if a.startswith("--phases="):
            phases = {int(x) for x in a.split("=", 1)[1].split(",")} | {1}
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses

    from msnv_tpu_torch.config import preset
    from msnv_tpu_torch.models.samplernn import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = preset("samplernn")
    if rehearse:
        global DIM
        exp = dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, dim=32))
        DIM = 32
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda")
        log(f"[device] {torch.cuda.get_device_name(0)}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}; "
            f"{card_line()}")
        build_kernels()
    cfg = exp.model
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)

    def timed(number, name, fn, *args):
        if number not in phases:
            return
        t0 = time.perf_counter()
        fn(*args)
        log(f"[phase] {name} {time.perf_counter() - t0:.1f} s")

    timed(2, "kernel", phase_kernel, params,
          (1, 2, 32, 128) if not rehearse else (1, 2, 4),
          (4, Q, 128) if not rehearse else (4, Q, 16))
    timed(3, "generate", phase_generate, params, cfg,
          128 if not rehearse else 2, 16 if not rehearse else 2)
    ckpt = smoke_checkpoint(params, exp) if phases & {4, 8, 10, 12} \
        else None
    timed(4, "serve", phase_serve, params, ckpt, cfg, 4,
          8 if not rehearse else 2)
    del params
    timed(5, "gru", phase_gru, dev,
          ((13, 128, DIM), (52, 128, DIM), (13, 64, DIM), (52, 64, DIM),
           (13, 16, DIM), (52, 16, DIM), (5, 3, DIM), (4, 70, 128),
           (5, 70, DIM), (3, 8, 256), (3, 300, DIM))
          if not rehearse else ((3, 4, DIM), (5, 8, DIM), (5, 3, DIM)))
    timed(5, "fo-pool", phase_pool, dev,
          ((52, 128, DIM), (13, 128, DIM)) if not rehearse
          else ((13, 4, DIM), (4, 3, DIM)))
    timed(6, "train", phase_train, exp, dev, 128 if not rehearse else 4,
          exp.train.seq_len if not rehearse else 2 * cfg.lookback, 6, 3)
    timed(7, "loop", phase_loop, dev, DIM, 128 if not rehearse else 2,
          exp.train.seq_len if not rehearse else 2 * cfg.lookback,
          25 if not rehearse else 2, 1000 if not rehearse else 50)
    timed(8, "mux", phase_mux, ckpt, cfg, dev,
          ((128, 200), (1024, 48)) if not rehearse else ((4, 8), (8, 4)),
          (128, 200) if not rehearse else (4, 8), 8 if not rehearse else 2)
    timed(9, "variants", phase_variants, dev, DIM,
          64 if not rehearse else 4, 128 if not rehearse else 4,
          exp.train.seq_len if not rehearse else 4 * cfg.lookback,
          512 if not rehearse else 8, 128 if not rehearse else 2,
          (16, exp.train.seq_len, 2, 1600) if not rehearse
          else (4, 4 * cfg.lookback, 2, 150))
    timed(10, "export", phase_export, ckpt, cfg, dev,
          128 if not rehearse else 2, 16, 4, 20 if not rehearse else 3)
    timed(11, "mesh", phase_mesh, exp, dev, DIM, 128 if not rehearse else 4,
          exp.train.seq_len if not rehearse else 2 * cfg.lookback,
          16 if not rehearse else 2,
          (64, exp.train.seq_len, 512) if not rehearse
          else (4, 4 * cfg.lookback, 8),
          (128, 128, 25, 1000) if not rehearse else (DIM, 2, 2, 50))
    timed(12, "serve-mesh", phase_serve_mesh, ckpt, cfg, exp, dev,
          (8, 160, 32) if not rehearse else (4, 16, 4),
          (128, 48, 16, 4) if not rehearse else (8, 8, 16, 4),
          (DIM, 128, (128, 32, exp.train.seq_len, 6, 1000))
          if not rehearse else
          (DIM, 4, (DIM, 2, 2 * cfg.lookback, 2, 50)))
    timed(13, "orbax", phase_orbax, exp, dev, DIM,
          128 if not rehearse else 4,
          (128, 32, exp.train.seq_len, 6, 1000) if not rehearse
          else (DIM, 2, 2 * cfg.lookback, 2, 50))
    if rehearse:
        log("rehearsal on the CPU passed (no card: no result line)")
        return 1
    if phases != set(range(1, 14)):
        log(f"phases {sorted(phases)} passed (not all: no result line)")
        return 1

    print(json.dumps({"kernels": kernel_entries(),
                      "generate": RESULTS["generate"],
                      "streams": RESULTS["streams"],
                      "train": RESULTS["train"],
                      "loop": RESULTS["loop"],
                      "mux": RESULTS["mux"],
                      "variants": RESULTS["variants"],
                      "export": RESULTS["export"],
                      "mesh": RESULTS["mesh"],
                      "serve_mesh": RESULTS["serve_mesh"],
                      "orbax": RESULTS["orbax"],
                      "build_s": RESULTS["build_s"]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
