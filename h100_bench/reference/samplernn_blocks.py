"""The plain reference's train steps (reference/samplernn.py) over a batch
too large for one pass: each step's loss and gradient are the means over
blocks of rows, as they are over the rows of one pass (the loss is a mean
over equal shares), and one clip and Adam update follows each step. Every
block carries its own TBPTT state from step to step. Products, precision
and the optimizer are reference/samplernn.py's.
"""

from __future__ import annotations

import torch

from h100_bench.reference import samplernn as ref


def train_steps(m, train, params0, chunks, block: int, prec="f32"):
    """ref.train_steps without a discriminator, over chunks
    [(inp, reset, target, cond, spk)] of a batch that `block` divides,
    `block` rows a pass -> {"loss", "grad_leaves", "grad", "change"} as
    ref.train_steps gives them. params0 is not changed."""
    P = ref.Precision(prec)
    leaves = [t.detach().clone() for t in ref._leaves(params0)]
    opt = ref.Adam(leaves, train["learning_rate"], train["grad_clip"])
    out = {"loss": []}
    states = None
    with P.flags():
        for i, (inp, reset, target, cond, spk) in enumerate(chunks):
            rows = inp.shape[0]
            if rows % block:
                raise ValueError(f"{rows} rows do not divide into blocks "
                                 f"of {block}")
            n = rows // block
            for leaf in leaves:
                leaf.requires_grad_(True)
            params = ref._rebuild(params0, iter(leaves))
            total = [torch.zeros_like(p) for p in leaves]
            loss, new_states = 0.0, []
            for b in range(n):
                s = slice(b * block, (b + 1) * block)
                with torch.enable_grad():
                    logits, state, _ = ref.forward(
                        P, m, params, inp[s], reset, cond[s], spk[s],
                        None if states is None else states[b])
                    nll = ref.nll_bits(logits, target[s])
                grads = torch.autograd.grad(nll, leaves, allow_unused=True)
                for acc, g in zip(total, grads):
                    if g is not None:
                        acc.add_(g)
                loss += float(nll.detach())
                new_states.append([x.detach() for x in state])
            for leaf in leaves:
                leaf.requires_grad_(False)
            grads = [g / n for g in total]
            out["loss"].append(loss / n)
            if i == 0:
                out["grad_leaves"] = opt.clipped(grads)
                out["grad"] = ref._norms(out["grad_leaves"])
            opt.update(leaves, grads)
            states = new_states
    out["change"] = ref._norms([p - p0 for p, p0 in
                                zip(leaves, ref._leaves(params0))])
    return out
