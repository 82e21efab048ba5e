"""Model FLOPs and kernel bounds, counted from shapes.

A model FLOP is the work the model needs, counted once, whatever computes
it: a multiply-add is two, the sample MLP's input convolution over one-hot
samples is the gather-sum of fs0 fused-table rows (fs0 * dim adds) forward
and their scatter-add backward, not a dense convolution. Element-wise work
(gates, activations, the softmax) is left out. `m` is the "model" object of
a configuration file (configs/<config>.json).
"""

from __future__ import annotations

from h100_bench import peaks


def _ns_frame_samples(m):
    out, acc = [], 1
    for fs in m["frame_sizes"]:
        acc *= fs
        out.append(acc)
    return out


def cond_dim(m) -> int:
    return m["cond_dim"] * (2 if m["look_ahead"] else 1)


def _gru_step(d_in, h, layers):
    """One timestep of a multi-layer GRU: input and hidden projections."""
    total = 0
    for layer in range(layers):
        total += 2 * 3 * h * (d_in if layer == 0 else h) + 2 * 3 * h * h
    return total


def _conditioner(m):
    """The top tier's conditioner head on one frame: (FLOPs, FLOPs of its
    first layer, whose input gradient no backward needs)."""
    c, dim = cond_dim(m), m["dim"]
    if m["variant"] == "identity":
        return 2 * c * dim, 2 * c * dim
    if m["variant"] == "gan":
        dims = [c, c, c, m["ind_cond_dim"]]
    else:
        dims = [c, 40, 30, 20, m["ind_cond_dim"]]
    stack = sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return stack + 2 * m["ind_cond_dim"] * dim, 2 * dims[0] * dims[1]


def tier_frame(m, t):
    """Forward FLOPs of one frame of tier t: (all, input layers') where the
    input layers (input_expand, the conditioner's first layer) take data,
    so their input gradient is not needed."""
    dim, fs = m["dim"], m["frame_sizes"][t]
    nfs = _ns_frame_samples(m)[t]
    expand = 2 * nfs * dim
    total = expand + _gru_step(dim, dim, m["n_rnn"]) + 2 * dim * fs * dim
    inputs = expand
    if t == len(m["frame_sizes"]) - 1:
        cond, first = _conditioner(m)
        total += cond
        inputs += first
    return total, inputs


def mlp_sample(m):
    """Forward FLOPs of the sample MLP for one sample: the gather-sum of
    fs0 table rows, the hidden and the output layer."""
    fs0, dim, q = m["frame_sizes"][0], m["dim"], m["q_levels"]
    return fs0 * dim + 2 * dim * dim + 2 * dim * q


def forward_per_sample(m) -> float:
    """Forward model FLOPs per audio sample: the MLP, and each tier's frame
    shared by the samples it covers."""
    total = mlp_sample(m)
    for t, nfs in enumerate(_ns_frame_samples(m)):
        total += tier_frame(m, t)[0] / nfs
    return total


def table_flops(m):
    """The fused embed+conv table (fs0, q, dim) = embedding @ conv_in."""
    fs0, dim, q = m["frame_sizes"][0], m["dim"], m["q_levels"]
    return 2 * fs0 * q * q * dim


def disc_flops(batch, frames, width, channels):
    """Forward multiply-adds x 2 of the discriminator's eight 5x5 convs on
    a (batch, frames, width) latent."""
    per_pos = 25 * (1 * channels + 7 * channels * channels)
    return 2.0 * batch * frames * width * per_pos


def train_step(m, batch, seq_len, disc_channels=None) -> float:
    """Model FLOPs of one TBPTT train step over (batch, seq_len): forward,
    and a backward that takes the weight and the input gradient of every
    layer (twice the forward) but the input gradient of the layers that
    read data; the MLP's gather-sum backward is its scatter-add; the fused
    table once forward and its two gradients back. With `disc_channels`,
    the GAN discriminator's forward and backward on the latent (its first
    conv needs no input gradient)."""
    fs0, dim = m["frame_sizes"][0], m["dim"]
    n = batch * seq_len
    mlp_dense = mlp_sample(m) - fs0 * dim
    total = n * (3 * mlp_dense + 2 * fs0 * dim) + 3 * table_flops(m)
    for t, nfs in enumerate(_ns_frame_samples(m)):
        every, inputs = tier_frame(m, t)
        total += (n // nfs) * (3 * every - inputs)
    if disc_channels:
        frames = seq_len // _ns_frame_samples(m)[-1]
        fwd = disc_flops(batch, frames, m["ind_cond_dim"], disc_channels)
        first = 2.0 * batch * frames * m["ind_cond_dim"] * 25 * disc_channels
        total += 3 * fwd - first
    return total


def window_bound_s(batch, fs0, q, dim, dtype_name):
    """Least time of one sample-window launch at `batch` lanes: the larger
    of its multiply-adds over the peak for the weights' type and the bytes
    it must move over HBM bandwidth (W_h, W_o and the biases, the slots,
    the window in and the samples out, each once; the table rows it gathers
    are left out, which only lowers the bound: at the benchmark's batches
    the operations bound it)."""
    wsize = 2 if dtype_name == "bfloat16" else 4
    ops = batch * fs0 * (2 * (dim * dim + dim * q) + fs0 * dim)
    nbytes = ((dim * dim + dim * q) * wsize + 4 * (dim + q)
              + batch * fs0 * dim * wsize + 4 * batch * fs0 * 2)
    return max(ops / peaks.peak_flops(dtype_name),
               nbytes / peaks.HBM_BYTES_PER_S)


def gru_sweep_bound_s(T, B, H, dtype_name, backward):
    """Least time of one GRU layer sweep: the larger of the bytes it must
    move (each input read once, each output written once) over HBM
    bandwidth and its recurrent multiply-adds over the peak for the
    products' type."""
    wbytes = 3 * H * H * (2 if dtype_name == "bfloat16" else 4)
    bh = 4 * B * H
    if backward:   # in x_proj, hproj, ys (h_prev), dy, h0; out dxp, dhproj
        nbytes = T * bh * (3 + 3 + 1 + 1) + bh + wbytes \
            + T * bh * (3 + 3) + bh
    else:          # in x_proj, h0, b_hh; out ys, hproj
        nbytes = T * bh * 3 + bh + 12 * H + wbytes + T * bh * (1 + 3)
    ops = 2 * T * B * H * 3 * H
    return max(ops / peaks.peak_flops(dtype_name),
               nbytes / peaks.HBM_BYTES_PER_S)


def train_sweeps(m, batch, seq_len, dtype_name):
    """The GRU sweeps of one train step: [(T, bound_s)] for every layer of
    every tier, forward and backward."""
    out = []
    for nfs in _ns_frame_samples(m):
        T = seq_len // nfs
        for backward in (False, True):
            b = gru_sweep_bound_s(T, batch, m["dim"], dtype_name, backward)
            out += [(T, b)] * m["n_rnn"]
    return out
