"""Multi-layer GRU with torch gate semantics, as plain tensor code.

Port of the JAX package's ops/gru.py. Gate order is [r, z, n]:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Layout: w_ih (3H, in), w_hh (3H, H), biases (3H,). Three schedules of the
sequence form, chosen by `impl` (the names are the config's, shared with
the JAX package so that configs and checkpoints stay interchangeable):

  "xla"        layer by layer, a Python loop of matmuls per timestep
  "pallas"     layer by layer, each layer's recurrent sweep in the fused
               kernel (msnv_tpu_torch/kernels/gru_layer.py: CUDA on a GPU
               tensor, its plain version on a CPU tensor); the input
               projection stays one large matmul outside
  "wavefront"  all layers advance along the (time, layer) anti-diagonal:
               sequential depth T + L - 1 with one batched matmul per step
"""

from __future__ import annotations

import torch

from msnv_tpu_torch.kernels.gru_layer import gru_layer
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


def _layer_apply(p, x, h0, impl: str = "xla"):
    """One GRU layer. x: (B, T, d_in), h0: (B, H) -> (y (B, T, H), hT).

    impl="pallas" runs the sweep in the fused kernel, with float32 state
    and the products' operands in x's type when that is bfloat16, else in
    full float32. On a CUDA tensor it launches the kernel or raises for a
    shape the kernel cannot take: there is no fallback to the loop."""
    x_proj = torch.matmul(x, p["w_ih"].T) + p["b_ih"]   # all timesteps
    if impl == "pallas":
        mxu = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        # the weight goes in as the transposed view of what is stored, in
        # the products' type when it already has it: the kernel's wrapper
        # then reads it where it lies
        w_hh_t = p["w_hh"].T
        if w_hh_t.dtype != mxu:
            w_hh_t = w_hh_t.float()
        ys, hT = gru_layer(
            x_proj.transpose(0, 1).float().contiguous(), w_hh_t,
            p["b_hh"].float(), h0.float().contiguous(), mxu)
        return ys.transpose(0, 1).to(x.dtype), hT.to(x.dtype)
    w_hh_t = p["w_hh"].T
    h = h0
    ys = []
    for t in range(x.shape[1]):
        hp = torch.matmul(h, w_hh_t) + p["b_hh"]
        h = _gru_gates(x_proj[:, t], hp, h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def _wavefront_apply(params, x, h0):
    """All layers in one loop over wavefront steps s: layer l computes its
    timestep t = s - l. The recurrent products of all layers are one batched
    (L, B, H) x (L, H, 3H) matmul per step. Same products in the same order
    within each (layer, timestep) cell as the layer-by-layer path; cells
    with s - l outside [0, T) compute on stale carries and are masked out,
    which also latches each layer's final hidden state."""
    L = len(params)
    B, T, _ = x.shape
    p0 = params[0]
    x0 = (torch.matmul(x, p0["w_ih"].T) + p0["b_ih"]).transpose(0, 1)
    w_hh = torch.stack([p["w_hh"].T for p in params])
    b_hh = torch.stack([p["b_hh"] for p in params])[:, None, :]
    w_ih_up = torch.stack([p["w_ih"].T for p in params[1:]])
    b_ih_up = torch.stack([p["b_ih"] for p in params[1:]])[:, None, :]
    x0_pad = torch.cat([x0, x0.new_zeros((L - 1,) + x0.shape[1:])], dim=0)
    lidx = torch.arange(L, device=x.device)

    h = h0.to(x0.dtype)
    y = torch.zeros_like(h)
    ys = []
    for s in range(T + L - 1):
        hp = torch.matmul(h, w_hh) + b_hh
        xp_up = torch.matmul(y[:-1], w_ih_up) + b_ih_up
        xp = torch.cat([x0_pad[s][None], xp_up], dim=0)      # (L, B, 3H)
        h_new = _gru_gates(xp, hp, h)
        t = s - lidx
        active = ((t >= 0) & (t < T))[:, None, None]
        h = torch.where(active, h_new, h)
        y = torch.where(active, h_new, y)
        ys.append(y[-1])
    return torch.stack(ys[L - 1:], dim=1), h


GRU_IMPLS = ("xla", "pallas", "wavefront")


def gru_apply(params, x, h0, impl: str = "xla"):
    """Multi-layer GRU over a sequence.

    params: list of per-layer dicts; x: (B, T, d_in); h0: (n_layers, B, H).
    impl: "xla", "pallas" (the fused kernel) or "wavefront": see the module
    docstring. Returns (y (B, T, H) last-layer outputs, h (n_layers, B, H)).
    """
    if impl not in GRU_IMPLS:
        raise ValueError(f"gru_impl must be one of {GRU_IMPLS}, got {impl!r}")
    if impl == "wavefront" and len(params) > 1:
        return _wavefront_apply(params, x, h0)
    h_out = []
    y = x
    for layer, p in enumerate(params):
        y, hT = _layer_apply(p, y, h0[layer], impl=impl)
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
