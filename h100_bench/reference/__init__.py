"""Plain PyTorch references that decide `correct`. They import nothing of
the port (msnv_tpu_torch), of the JAX package or of jax, and take only what
the benchmark made: the weights, the inputs and the port's outputs, which
they judge."""
