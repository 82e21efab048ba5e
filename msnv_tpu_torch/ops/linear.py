"""Dense (1x1-conv-equivalent) layers, initializers, and weight norm.

Port of the JAX package's ops/linear.py. Layout is the JAX package's: a dense
weight is (out_dim, in_dim) like torch's Linear, the bias (out_dim,), and
weight norm keeps per-output-row norms in "g".

Initializers draw from an explicit CPU `torch.Generator` and then move to
the target device, so the same seed gives the same weights on any device.
On the "meta" device they only allocate (shape/dtype templates).
"""

from __future__ import annotations

import math

import torch


def _draw(shape, fill, device):
    """A float32 CPU tensor filled in place by `fill`, moved to `device`;
    on the "meta" device only the empty template."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    w = torch.empty(shape)
    fill(w)
    return w.to(device)


def _uniform(shape, bound, generator, device):
    return _draw(shape, lambda w: w.uniform_(-bound, bound,
                                             generator=generator), device)


def kaiming_uniform(generator, shape, fan_in=None, *, device="cpu"):
    """uniform(+-sqrt(6/fan_in)); fan_in defaults to prod of trailing dims."""
    if fan_in is None:
        fan_in = math.prod(shape[1:])
    return _uniform(shape, math.sqrt(6.0 / fan_in), generator, device)


def lecun_uniform(generator, shape, fan_in=None, *, device="cpu"):
    """uniform(+-sqrt(3/fan_in)) (ref nn.py:46-48)."""
    if fan_in is None:
        fan_in = math.prod(shape[1:])
    return _uniform(shape, math.sqrt(3.0 / fan_in), generator, device)


def orthogonal(generator, shape, *, device="cpu"):
    """Orthogonal matrix (ref model.py:163)."""
    return _draw(shape, lambda w: torch.nn.init.orthogonal_(
        w, generator=generator), device)


def normal(generator, shape, *, device="cpu"):
    """N(0, 1) — torch.nn.Embedding default init."""
    return _draw(shape, lambda w: w.normal_(generator=generator), device)


# --------------------------------------------------------------------------
# Dense layer (Conv1d kernel-size-1 equivalent) with optional weight norm
# --------------------------------------------------------------------------

def dense_init(generator, in_dim, out_dim, *, init=kaiming_uniform,
               bias=True, weight_norm=False, device="cpu"):
    """Params for a dense layer; weight shape (out_dim, in_dim)."""
    w = init(generator, (out_dim, in_dim), device=device)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((out_dim,), device=device)
    if weight_norm:
        # torch weight_norm(dim=0): effective weight = g * v / ||v||_row
        p["g"] = torch.linalg.vector_norm(w, dim=1)
    return p


def dense_weight(p):
    """Materialize the effective weight (applies weight norm if present)."""
    w = p["w"]
    if "g" in p:
        norm = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        w = p["g"][:, None] * w / norm
    return w


def dense_apply(p, x):
    """x: (..., in_dim) -> (..., out_dim), in x's dtype."""
    y = torch.matmul(x, dense_weight(p).T)
    if "b" in p:
        y = y + p["b"]
    return y
