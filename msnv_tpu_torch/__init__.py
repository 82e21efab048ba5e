"""msnv_tpu_torch — the multi-speaker SampleRNN vocoder in PyTorch + CUDA.

A port of the JAX package to PyTorch for an NVIDIA H100. The
layout mirrors the JAX package so each counterpart is easy to find:

  config.py    — ModelConfig / presets / experiment tags (own copy)
  ops/         — quantizers, dense layers, upsampling, GRU
  models/      — conditioner head, SampleRNN predictor, generation
  kernels/     — Python wrappers of the hand-written CUDA kernels
  csrc/        — the CUDA sources (built with nvcc at first use)
  data/        — WAV bytes
  interop.py   — load parameters written by the JAX trainer (.npz)
  serving/     — the HTTP vocoder service

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA device and no explicit CPU request they raise.
"""

from msnv_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
