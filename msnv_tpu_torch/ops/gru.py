"""Multi-layer GRU with torch gate semantics, as plain tensor code.

Port of the JAX package's ops/gru.py. Gate order is [r, z, n]:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Layout: w_ih (3H, in), w_hh (3H, H), biases (3H,). The sequence form is a
Python loop of matmuls — the JAX side is a `lax.scan`, not a kernel, so
nothing here is owed a kernel. The fused GRU kernel ("pallas") and the
wavefront schedule belong to the training slice.
"""

from __future__ import annotations

import torch

from msnv_tpu_torch.ops.linear import lecun_uniform, orthogonal


def gru_init(generator, n_layers: int, in_dim: int, hidden: int, *,
             device="cpu"):
    """Initialize an `n_layers` GRU; layer 0 consumes `in_dim`. Per-gate
    chunks as in ref nn.py:51-63: w_ih all lecun_uniform, w_hh
    [lecun, lecun, orthogonal], zero biases."""
    kw = {"device": device}
    layers = []
    for layer in range(n_layers):
        d_in = in_dim if layer == 0 else hidden
        w_ih = torch.cat([lecun_uniform(generator, (hidden, d_in), **kw)
                          for _ in range(3)], dim=0)
        w_hh = torch.cat([
            lecun_uniform(generator, (hidden, hidden), **kw),
            lecun_uniform(generator, (hidden, hidden), **kw),
            orthogonal(generator, (hidden, hidden), **kw),
        ], dim=0)
        layers.append({
            "w_ih": w_ih,
            "w_hh": w_hh,
            "b_ih": torch.zeros((3 * hidden,), **kw),
            "b_hh": torch.zeros((3 * hidden,), **kw),
        })
    return layers


def _gru_gates(xp, hp, h):
    """Gate math: xp/hp are the (..., 3H) input/hidden projections."""
    xr, xz, xn = torch.chunk(xp, 3, dim=-1)
    hr, hz, hn = torch.chunk(hp, 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _layer_apply(p, x, h0):
    """One GRU layer. x: (B, T, d_in), h0: (B, H) -> (y (B, T, H), hT)."""
    x_proj = torch.matmul(x, p["w_ih"].T) + p["b_ih"]   # all timesteps
    w_hh_t = p["w_hh"].T
    h = h0
    ys = []
    for t in range(x.shape[1]):
        hp = torch.matmul(h, w_hh_t) + p["b_hh"]
        h = _gru_gates(x_proj[:, t], hp, h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def gru_apply(params, x, h0, impl: str = "xla"):
    """Multi-layer GRU over a sequence.

    params: list of per-layer dicts; x: (B, T, d_in); h0: (n_layers, B, H).
    impl: "xla" is the layer-by-layer loop (the name is the config's).
    Returns (y (B, T, H) last-layer outputs, h (n_layers, B, H)).
    """
    if impl != "xla":
        raise NotImplementedError(
            f"gru_impl={impl!r} is not ported yet (training slice)")
    h_out = []
    y = x
    for layer, p in enumerate(params):
        y, hT = _layer_apply(p, y, h0[layer])
        h_out.append(hT)
    return y, torch.stack(h_out)


def gru_cell(params, x, h):
    """Single-step multi-layer GRU for generation.

    x: (B, d_in); h: (n_layers, B, H) -> (y (B, H), h' (n_layers, B, H)).
    """
    h_out = []
    y = x
    for layer, p in enumerate(params):
        xp = torch.matmul(y, p["w_ih"].T) + p["b_ih"]
        hp = torch.matmul(h[layer], p["w_hh"].T) + p["b_hh"]
        y = _gru_gates(xp, hp, h[layer])
        h_out.append(y)
    return y, torch.stack(h_out)
