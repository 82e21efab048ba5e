"""msnv_tpu_torch — the multi-speaker SampleRNN vocoder in PyTorch + CUDA.

A port of the JAX package to PyTorch for an NVIDIA H100. The
layout mirrors the JAX package so each counterpart is easy to find:

  config.py    — ModelConfig / presets / experiment tags (own copy)
  tree.py      — parameter-tree helpers
  ops/         — quantizers, dense layers, upsampling, GRU (three
                 schedules), the fo-pool QRNN, embed+conv and NLL-bits
                 with hand-written backwards
  models/      — conditioner heads (identity, bottleneck, gan), the
                 speaker discriminator, SampleRNN predictor
                 (differentiable), generation
  kernels/     — Python wrappers of the hand-written CUDA kernels: the
                 sample window (serving) and the fused GRU layer, forward
                 and backward (training); each beside its plain version
  csrc/        — the CUDA sources (built with nvcc at first use) and the
                 host C++ zstd decoder (built with the C++ compiler)
  training/    — clipped Adam, the TBPTT train / eval steps and their
                 device-corpus blocks, the GAN variant's two-optimizer
                 step, the Trainer loop and its plugins, checkpoints in
                 the JAX trainer's .npz and orbax formats (orbax's OCDBT
                 store and a zstd decoder of the repository's own, no
                 jax or tensorstore) and as torch.distributed.checkpoint
                 (dcp) directories; each over a device mesh too (mesh=)
  parallel/    — the ('data', 'model') mesh over torch.distributed (one
                 process per GPU), sharding rules and collectives, one
                 starting state for every replica (broadcast_tree);
                 sharded generation and streaming; serving over a mesh
                 (parallel/serve.py: rank 0 leads, the others follow)
  data/        — WAV I/O, the corpus build (the same npy cache), the
                 TBPTT chunk loader, synthetic corpora, log-mel features,
                 the native data library
  eval/        — objective copy-synthesis metrics
  cli/         — train, evaluate, generate, export and the host tools
                 augment, metrics, plotlog, interpolate, interop
                 (msnv-*-torch)
  interop.py   — parameters and optimizer state to and from the JAX
                 trainer's checkpoint keys (.npz); the original
                 repository's PyTorch checkpoints both ways
  export.py    — serving artifacts: generation and /stream programs
                 saved with torch.export
  serving/     — the HTTP vocoder service: the lane-batched /stream
                 multiplexer, the asyncio and the threaded front-ends,
                 the artifact lanes
  utils/       — logging; profiling (torch.profiler traces and the
                 program's spans: the multiplexer's tick, the train
                 steps' discriminator and optimizer)

Ported so far: serving (forward, generation, streaming, the stream
multiplexer, the asyncio and threaded HTTP front-ends), the train step,
the training loop with its corpus, loader, checkpoints and the
train / evaluate / generate CLIs, the variants (the bottleneck and
GAN heads, the speaker discriminator and the GAN trainer, QRNN tiers), the
serving artifact (export and its service lanes), profiling and the host
CLIs, training and generation over a device mesh (torch.distributed:
`torchrun --nproc_per_node N -m msnv_tpu_torch.cli.train ...`) and serving
over a mesh (`-m msnv_tpu_torch.serving --mesh_data N`), and every
checkpoint format of the JAX package: .npz, and orbax's directories (an
OCDBT database of zarr arrays, read and written in training/ocdbt.py with
the zstd decoder of csrc/zstd_decode.cc), both ways, besides the port's
dcp directories. The port does all that the JAX package does.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA device and no explicit CPU request they raise.
"""

from msnv_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
