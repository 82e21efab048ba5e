"""Plain float32 SampleRNN with fo-pool QRNN frame tiers, and its train step.

The reference of configs/samplernn_qrnn.json: reference/samplernn.py's
model (Barbany et al., Multi-Speaker Neural Vocoder, IberSpeech 2018) with
each tier's multi-layer GRU replaced by a multi-layer QRNN with fo-pooling
(Bradbury et al., Quasi-Recurrent Neural Networks, ICLR 2017), window 1
and an output gate, as Salesforce's pytorch-qrnn builds it:

    z = tanh(W_z x + b_z)   f = sigmoid(W_f x + b_f)   o = sigmoid(W_o x + b_o)
    c_t = f_t c_{t-1} + (1 - f_t) z_t        h_t = o_t c_t

with the carried state the cell c (the learned h0 stands for c0 at a reset,
as for the GRU). Departure: pytorch-qrnn's ForgetMult computes
c_t = f_t z_t + (1 - f_t) c_{t-1}, f and 1 - f swapped. Since
sigmoid(-a) = 1 - sigmoid(a), that is the same family of models under the
opposite sign of W_f and b_f; this file keeps the paper's form, as the port
does (ops/qrnn.py). The upstream SampleRNN's `qrnn` option names this block
but builds a GRU in both branches.

Layout: a tier's "gru" entry holds the QRNN's layers, {w (3H, d_in), b
(3H,)} each, gates [z, f, o], in the port's parameter layout. Products go
through reference/samplernn.py's `Precision` (float32 with TF32 off, TF32,
fp8 e4m3), and the layers, loss and optimizer are that file's; nothing is
fused: the pool walks T one step at a time.
"""

from __future__ import annotations

import torch

from h100_bench.reference import samplernn as ref


def qrnn(P, layers, x, c0):
    """Multi-layer fo-pool QRNN; x (B, T, d), c0 (layers, B, H) ->
    (y (B, T, H), c_T (layers, B, H))."""
    cs = []
    y = x
    for i, p in enumerate(layers):
        g = P.mm(y, p["w"].t()) + p["b"]
        gz, gf, go = g.chunk(3, dim=-1)
        z, f, o = torch.tanh(gz), torch.sigmoid(gf), torch.sigmoid(go)
        c = c0[i]
        out = []
        for t in range(y.shape[1]):
            c = f[:, t] * c + (1.0 - f[:, t]) * z[:, t]
            out.append(o[:, t] * c)
        y = torch.stack(out, dim=1)
        cs.append(c)
    return y, torch.stack(cs)


def forward(P, m, params, inp, reset, cond, spk, state):
    """Logits (B, L, q) of one chunk, as reference/samplernn.py's `forward`
    with QRNN tiers. -> (logits, new_state)."""
    nfs_all = ref.ns_frame_samples(m)
    lookback = nfs_all[-1]
    batch, total = inp.shape
    seq_len = total - lookback + 1
    n_tiers = len(nfs_all)
    upper, new_state = None, [None] * n_tiers
    for t in range(n_tiers - 1, -1, -1):
        tier = params["tiers"][t]
        nfs = nfs_all[t]
        frames = inp[:, lookback - nfs:total - nfs + 1]
        prev = 2.0 * ref.dequantize(m, frames).reshape(batch, seq_len // nfs,
                                                       nfs)
        x = ref.dense(P, tier["input_expand"], prev)
        if upper is None:
            c, _ = ref.conditioner(P, m, tier["conditioner"], cond)
            emb = tier["spk_embedding"][spk]
            x = x + c + ref.dense(P, tier["spk_expand"], emb)[:, None, :]
        else:
            x = x + upper
        h0 = tier["h0"][:, None, :].expand(m["n_rnn"], batch, m["dim"])
        y, new_state[t] = qrnn(P, tier["gru"], x, h0 if reset else state[t])
        upper = ref.upsample(P, tier["upsample"], y)
    mlp = params["mlp"]
    fs0 = m["frame_sizes"][0]
    emb = mlp["embedding"][inp[:, lookback - fs0:].long()]
    x = upper
    for k in range(fs0):
        x = x + P.mm(emb[:, k:k + seq_len], mlp["conv_in"][k])
    x = torch.relu(x)
    x = torch.relu(ref.dense(P, mlp["hidden"], x))
    return ref.dense(P, mlp["out"], x), new_state


def train_steps(m, train, params0, chunks, prec="f32"):
    """reference/samplernn.py's `train_steps` without a discriminator, on
    QRNN tiers: the steps on `chunks` [(inp, reset, target, cond, spk)]
    from params0 -> {"loss", "grad_leaves", "grad", "change"} as that
    function gives them. params0 is not changed."""
    if m["weight_norm"] or m["variant"] == "gan":
        raise ValueError("the QRNN reference has no weight norm and no "
                         "discriminator")
    P = ref.Precision(prec)
    leaves = [t.detach().clone() for t in ref._leaves(params0)]
    opt = ref.Adam(leaves, train["learning_rate"], train["grad_clip"])
    out = {"loss": []}
    state = None
    with P.flags():
        for i, (inp, reset, target, cond, spk) in enumerate(chunks):
            for leaf in leaves:
                leaf.requires_grad_(True)
            params = ref._rebuild(params0, iter(leaves))
            with torch.enable_grad():
                logits, new_state = forward(P, m, params, inp, reset, cond,
                                            spk, state)
                loss = ref.nll_bits(logits, target)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
            out["loss"].append(float(loss.detach()))
            if i == 0:
                out["grad_leaves"] = opt.clipped(grads)
                out["grad"] = ref._norms(out["grad_leaves"])
            for leaf in leaves:
                leaf.requires_grad_(False)
            opt.update(leaves, grads)
            state = [s.detach() for s in new_state]
    out["change"] = ref._norms([p - p0 for p, p0 in
                                zip(leaves, ref._leaves(params0))])
    return out
