"""Model FLOPs and the fo-pool kernel's bounds of a configuration with QRNN
frame tiers, counted from shapes as flops.py counts the GRU ones.

A QRNN layer's frame step is its input projection alone, 2 x d_in x 3H
(a GRU's is that and its hidden projection, 2 x H x 3H more): the pool that
follows is element-wise work, left out of model FLOPs as the gates are.
The pool's bound is bytes: every input read once and every output written
once, and one saved cell a block of steps, over HBM bandwidth.
"""

from __future__ import annotations

from h100_bench import flops, peaks

# steps of the backward's recomputation blocks: one saved cell a block
CHECKPOINT_STEPS = 8


def train_step(m, batch, seq_len) -> float:
    """flops.train_step (no discriminator) with QRNN tiers: the GRU count
    less every tier step's hidden projections (2 x H x 3H a layer), which
    a GRU step takes three times (forward, and the weight and the input
    gradient back) and a QRNN step does not have."""
    hidden = m["n_rnn"] * 2 * 3 * m["dim"] * m["dim"]
    frames = sum(batch * seq_len // nfs
                 for nfs in flops._ns_frame_samples(m))
    return flops.train_step(m, batch, seq_len) - 3 * hidden * frames


def pool_bytes(T, B, H, dtype_name, backward):
    """Bytes one fo-pool sweep needs to move: what the function reads and
    writes, each once, and of the cells c_t that the backward needs, one a
    CHECKPOINT_STEPS block (the rest it can recompute from its block's
    gates, which it reads anyway). Forward: in g (B, T, 3H) and c0, out h
    (B, T, H), c_T and the blocks' cells. Backward: in g, dh, c0 and the
    blocks' cells, out dg (B, T, 3H) and dc0 (no dc_T: the train step's
    carried state takes no gradient). The kernel saves every c_t (4 B an
    element each way more), so it cannot reach this bound as it is."""
    s = 2 if dtype_name == "bfloat16" else 4
    n, bh = T * B * H, 4 * B * H
    saved = bh * (-(-T // CHECKPOINT_STEPS) - 1)
    if backward:
        return n * (3 * s + s + 3 * s) + 2 * bh + saved
    return n * (3 * s + s) + 2 * bh + saved


def pool_bound_s(T, B, H, dtype_name, backward):
    """Least time of one fo-pool sweep: its bytes over HBM bandwidth (a few
    flops an element: far below the card's rate)."""
    return pool_bytes(T, B, H, dtype_name, backward) / peaks.HBM_BYTES_PER_S


def train_pools(m, batch, seq_len, dtype_name):
    """The fo-pool sweeps of one train step: [(T, bound_s)] for every layer
    of every tier, forward and backward."""
    out = []
    for nfs in flops._ns_frame_samples(m):
        T = seq_len // nfs
        for backward in (False, True):
            b = pool_bound_s(T, batch, m["dim"], dtype_name, backward)
            out += [(T, b)] * m["n_rnn"]
    return out
