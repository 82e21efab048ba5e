"""NLL in bits straight from logits, with a hand-written backward.

Port of the JAX package's ops/xent.py (plain tensor code there too: not a
kernel). The train and eval steps compute

    loss = mean(logsumexp(logits) - logits[target]) * log2(e)

without materializing the (B, L, q) log-prob array, and the backward builds

    dlogits = (softmax(logits) - onehot(target)) * g * log2(e) / N

in one pass, with a compare against the class index standing in for the
one-hot (no scatter). The log-prob-returning API (`sample_mlp_forward` +
`sequence_nll_loss_bits`) stays for parity tests and generation.
"""

from __future__ import annotations

import math

import torch

_LOG2E = 1.0 / math.log(2.0)


class _NllBits(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets):
        targets = targets.long()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, targets[..., None])[..., 0]
        ctx.save_for_backward(logits, targets, lse)
        return torch.mean(lse - picked) * _LOG2E

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        q = logits.shape[-1]
        n = logits.numel() // q
        dlogits = torch.exp(logits - lse[..., None])
        classes = torch.arange(q, device=logits.device)
        dlogits -= (classes == targets[..., None]).to(logits.dtype)
        dlogits *= g * (_LOG2E / n)
        return dlogits, None


def nll_bits_from_logits(logits, targets):
    """Mean NLL in bits over all positions; logits (..., q), targets int."""
    return _NllBits.apply(logits, targets)
