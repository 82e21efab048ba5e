"""The Gumbel noise of the port's sample-window kernel, Philox mode.

The draw the port documents for its Philox mode: Philox-4x32-10 keyed on
the window's 64-bit seed, counter (class // 4, step in the window, lane, 0),
u = ((bits >> 8) + 0.5) / 2^24, g = -log(-log(u)); the sample is
argmax(logits + g). A window's seed is one `torch.randint(0, 2**62, (1,),
int64)` from the caller's generator, one per window in the order the
windows run.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, b):
    p_lo = m * (b & 0xFFFF)
    p_hi = m * (b >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def window_seeds(generator, n: int, device):
    """(n,) int64: the seeds of n windows drawn from `generator` as the
    port draws them."""
    return torch.cat([torch.randint(0, 2 ** 62, (1,), generator=generator,
                                    device=device, dtype=torch.int64)
                      for _ in range(n)])


def gumbel(seeds, lanes, fs0: int, q: int):
    """(len(lanes), len(seeds), fs0, q) float32 noise of windows keyed on
    `seeds` (W,) int64 for the batch rows `lanes` (L,) int64."""
    dev = seeds.device
    i64 = {"device": dev, "dtype": torch.int64}
    groups = -(-q // 4)
    W, L = seeds.shape[0], lanes.shape[0]
    shape = (L, W, fs0, groups)
    k0 = (seeds & _MASK32).view(1, W, 1, 1)
    k1 = ((seeds >> 32) & _MASK32).view(1, W, 1, 1)
    c0 = torch.arange(groups, **i64).view(1, 1, 1, groups).expand(shape)
    c1 = torch.arange(fs0, **i64).view(1, 1, fs0, 1).expand(shape)
    c2 = lanes.to(**i64).view(L, 1, 1, 1).expand(shape)
    bits = torch.stack(philox4x32(c0, c1, c2, torch.zeros(shape, **i64),
                                  k0, k1), -1)
    u = ((bits.reshape(L, W, fs0, 4 * groups)[..., :q] >> 8).float()
         + 0.5) * (1.0 / 16777216.0)
    return -torch.log(-torch.log(u))
