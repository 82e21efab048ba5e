"""Embed + valid conv with a reassociated backward: the train step's
sample-MLP input stage.

Port of the JAX package's ops/embed_conv.py (plain tensor code there too:
not a kernel). The stage is ``conv1d(embedding[samples], w)``, a k = fs0
valid conv over q-dim embeddings of the quantized sample stream. Because the
conv input is an embedding lookup, the stage is linear in the one-hot sample
stream through the composite table ``T[j] = E @ w[j]``:

    y[b, t] = sum_j T[j][samples[b, t + j]]

so the gradients reassociate exactly:

    dT[j, q, h] = sum_{b,t} onehot(samples)[b, t + j, q] * dy[b, t, h]
    dE = sum_j dT[j] @ w[j].T
    dw[j] = E.T @ dT[j]

Plain autograd would instead build d(embedded) by a transposed conv and
scatter it into the embedding table. Here the forward is one bag-of-rows
gather from T (k rows per output position) and `dT` is k matmuls of the
one-hot stream against dy: the stream is flattened to (B*S, q) and dy
zero-padded to (B*S, h), so that a shift by j along the flat axis is the
window offset j (the rows a shift carries across a batch boundary meet the
zero padding). No scatter, no atomics: the result is deterministic.

Layouts are the JAX package's: embedding (q, e), w (k, e, h), samples
(B, S) int, result (B, S - k + 1, h). dE and dw are formed in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _table_rows(embedding, w, samples):
    """sum_j T[j][samples[:, t + j]] -> (B, S - k + 1, h)."""
    k, _, h = w.shape
    q = embedding.shape[0]
    table = torch.einsum("qe,keh->kqh", embedding, w).reshape(k * q, h)
    offsets = torch.arange(k, device=samples.device) * q
    idx = samples.long().unfold(1, k, 1) + offsets          # (B, L, k)
    batch, length = idx.shape[:2]
    out = F.embedding_bag(idx.reshape(batch * length, k), table, mode="sum")
    return out.reshape(batch, length, h)


class _EmbedConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, embedding, w, samples):
        ctx.save_for_backward(embedding, w, samples)
        return _table_rows(embedding, w, samples)

    @staticmethod
    def backward(ctx, dy):
        embedding, w, samples = ctx.saved_tensors
        k, _, h = w.shape
        q = embedding.shape[0]
        batch, s_len = samples.shape
        n = batch * s_len
        onehot = torch.zeros((n, q), dtype=dy.dtype, device=dy.device)
        onehot.scatter_(1, samples.reshape(n, 1).long(), 1.0)
        dy_pad = F.pad(dy, (0, 0, 0, k - 1)).reshape(n, h)
        d_table = torch.stack([
            torch.matmul(onehot[j:].t(), dy_pad[:n - j]) for j in range(k)
        ]).float()                                           # (k, q, h)
        d_embedding = torch.einsum("kqh,keh->qe", d_table, w.float())
        dw = torch.einsum("qe,kqh->keh", embedding.float(), d_table)
        return d_embedding.to(embedding.dtype), dw.to(w.dtype), None


def embed_conv(embedding, w, samples):
    """conv1d(embedding[samples], w) with the reassociated backward.

    embedding: (q, e) table; w: (k, e, h) conv weight; samples: (B, S) int.
    Returns (B, S - k + 1, h).
    """
    return _EmbedConv.apply(embedding, w, samples)


def embed_conv_direct(embedding, w, samples):
    """The plain-autograd formulation: embed, then a valid conv
    (ModelConfig.mlp_grad_impl="direct"), the baseline `embed_conv` is held
    against. On a GPU the float32 conv runs in TF32 unless
    torch.backends.cudnn.allow_tf32 is False."""
    emb = embedding[samples.long()].transpose(1, 2)          # (B, e, S)
    return F.conv1d(emb, w.permute(2, 1, 0)).transpose(1, 2)
