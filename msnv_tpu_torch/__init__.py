"""msnv_tpu_torch — the multi-speaker SampleRNN vocoder in PyTorch + CUDA.

A port of the JAX package to PyTorch for an NVIDIA H100. The
layout mirrors the JAX package so each counterpart is easy to find:

  config.py    — ModelConfig / presets / experiment tags (own copy)
  tree.py      — parameter-tree helpers
  ops/         — quantizers, dense layers, upsampling, GRU (three
                 schedules), embed+conv and NLL-bits with hand-written
                 backwards
  models/      — conditioner head, SampleRNN predictor (differentiable),
                 generation
  kernels/     — Python wrappers of the hand-written CUDA kernels: the
                 sample window (serving) and the fused GRU layer, forward
                 and backward (training); each beside its plain version
  csrc/        — the CUDA sources (built with nvcc at first use)
  training/    — clipped Adam, the TBPTT train / eval steps
  data/        — WAV bytes
  interop.py   — parameters and optimizer state to and from the JAX
                 trainer's checkpoint keys (.npz)
  serving/     — the HTTP vocoder service

Ported so far: serving (forward, generation, streaming, HTTP) and the train
step. Not yet: the trainer loop, loader, checkpoint writer, CLIs other than
serve, the GAN / bottleneck / QRNN variants, the stream multiplexer, export
and multi-device.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA device and no explicit CPU request they raise.
"""

from msnv_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
