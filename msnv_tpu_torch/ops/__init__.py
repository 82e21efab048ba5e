"""Tensor ops of the port: quantizers, dense layers, upsampling, GRU."""
