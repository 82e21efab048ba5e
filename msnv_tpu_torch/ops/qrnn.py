"""Quasi-recurrent tier cell: fo-pooled QRNN (Bradbury et al. 2016).

Port of the JAX package's ops/qrnn.py. The reference's `qrnn` flag builds a
GRU in both branches (ref model.py:133-153); here, as in the JAX package,
it selects a real alternative recurrence:

    z = tanh   (W_z x + b_z)        # update candidate
    f = sigmoid(W_f x + b_f)        # forget gate
    o = sigmoid(W_o x + b_o)        # output gate
    c_t = f_t * c_{t-1} + (1 - f_t) * z_t          (fo-pooling)
    h_t = o_t * c_t

Every gate depends on the input alone, so a sequence's matmul work is one
(B*T, d_in) x (d_in, 3H) product ahead of the loop over T, whose body is
elementwise. Layout: a layer's w is (3H, d_in) with the gates in the order
[z, f, o], b (3H,). Signatures mirror ops/gru.py (state (n_layers, B, H);
the carried state is the cell c), so the tier plumbing, the TBPTT state,
the learned-h0 reset and checkpoints are those of the GRU path.
"""

from __future__ import annotations

import torch

from msnv_tpu_torch.ops.linear import lecun_uniform


def qrnn_init(generator, n_layers: int, in_dim: int, hidden: int, *,
              device="cpu"):
    """Initialize an `n_layers` fo-pool QRNN; layer 0 consumes `in_dim`.
    Per-gate lecun_uniform chunks [z, f, o], zero biases."""
    layers = []
    for layer in range(n_layers):
        d_in = in_dim if layer == 0 else hidden
        w = torch.cat([lecun_uniform(generator, (hidden, d_in), device=device)
                       for _ in range(3)], dim=0)
        layers.append({"w": w,
                       "b": torch.zeros((3 * hidden,), device=device)})
    return layers


def _gates(p, x):
    """x (..., d_in) -> (z, f, o), each (..., H)."""
    g = torch.matmul(x, p["w"].T) + p["b"]
    z, f, o = torch.chunk(g, 3, dim=-1)
    return torch.tanh(z), torch.sigmoid(f), torch.sigmoid(o)


def _layer_apply(p, x, c0):
    """One QRNN layer. x (B, T, d_in), c0 (B, H) -> (y (B, T, H), cT)."""
    z, f, o = _gates(p, x)                      # one matmul for all T
    c = c0
    cs = []
    for t in range(x.shape[1]):
        c = f[:, t] * c + (1.0 - f[:, t]) * z[:, t]
        cs.append(c)
    return o * torch.stack(cs, dim=1), c


def qrnn_apply(params, x, c0):
    """Multi-layer fo-pool QRNN over a sequence; mirrors gru_apply.

    params: list of per-layer dicts; x (B, T, d_in); c0 (n_layers, B, H).
    Returns (y (B, T, H) last-layer outputs, c (n_layers, B, H)).
    """
    c_out = []
    y = x
    for layer, p in enumerate(params):
        y, cT = _layer_apply(p, y, c0[layer])
        c_out.append(cT)
    return y, torch.stack(c_out)


def qrnn_cell(params, x, c):
    """Single-step multi-layer QRNN for generation; mirrors gru_cell.

    x (B, d_in); c (n_layers, B, H) -> (y (B, H), c' (n_layers, B, H)).
    """
    c_out = []
    y = x
    for layer, p in enumerate(params):
        z, f, o = _gates(p, y)
        c_new = f * c[layer] + (1.0 - f) * z
        y = o * c_new
        c_out.append(c_new)
    return y, torch.stack(c_out)
