"""Inputs made from --seed: seeds, weights, conditioners, audio.

Everything is drawn on the run's device from torch.Generators seeded from
--seed, in a few large calls. The weights fill the port's parameter tree
(its layout is the interface the port takes); their distributions follow
the port's initializers by the leaf's role (uniform +-sqrt(k / fan_in),
N(0, 1) embeddings, zero biases and h0, weight-norm gains equal to their
weights' norms), except that every recurrent matrix is uniform where the
port draws one gate orthogonal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from --seed and a chain of tags (splitmix64 per
    element)."""
    h = 0x9E3779B97F4A7C15
    for v in (seed,) + tags:
        if isinstance(v, str):
            v = int.from_bytes(v.encode(), "little")
        h = (h ^ (int(v) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 29
    return h >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def flatten(tree, path=()):
    """[(path, leaf)] of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += flatten(v, path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, path + (i,))
        return out
    return [(path, tree)]


def unflatten_like(tree, leaves):
    """A tree shaped like `tree` whose leaves come from the iterator
    `leaves`."""
    if isinstance(tree, dict):
        return {k: unflatten_like(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unflatten_like(v, leaves) for v in tree]
    return next(leaves)


def _role(path, shape):
    """("zero" | "normal" | "gain" | "uniform", bound) of a leaf."""
    name = path[-1]
    if name in ("h0", "b", "bias", "b_ih", "b_hh"):
        return "zero", 0.0
    if name in ("g", "conv_in_g"):
        return "gain", 0.0
    if name in ("embedding", "spk_embedding"):
        return "normal", 0.0
    if name == "conv_in":                         # (fs0, q, dim)
        fan, k = shape[0] * shape[1], 6.0
    elif name in ("w_ih", "w_hh"):                # (3H, in)
        fan, k = shape[1], 3.0
    elif len(shape) == 4:                         # HWIO conv
        fan, k = shape[0] * shape[1] * shape[2], 6.0
    elif len(shape) == 3:                         # upsample (in, r, out)
        fan, k = shape[0], 6.0
    else:                                         # dense (out, in)
        fan, k = shape[1], 3.0 if "out" in path else 6.0
    return "uniform", math.sqrt(k / fan)


def fill_tree(template, gen, device):
    """Real float32 leaves for a "meta" template, drawn from `gen` on
    `device` in two calls (one uniform, one normal buffer)."""
    leaves = flatten(template)
    roles = [_role(p, tuple(t.shape)) for p, t in leaves]
    n_uni = sum(t.numel() for (_, t), (r, _) in zip(leaves, roles)
                if r == "uniform")
    n_nrm = sum(t.numel() for (_, t), (r, _) in zip(leaves, roles)
                if r == "normal")
    f32 = {"device": device, "dtype": torch.float32}
    uni = torch.empty(n_uni, **f32).uniform_(-1.0, 1.0, generator=gen)
    nrm = torch.empty(n_nrm, **f32).normal_(generator=gen)
    out, iu, inn = {}, 0, 0
    for (path, t), (role, bound) in zip(leaves, roles):
        n = t.numel()
        if role == "uniform":
            out[path] = (uni[iu:iu + n] * bound).view(t.shape)
            iu += n
        elif role == "normal":
            out[path] = nrm[inn:inn + n].clone().view(t.shape)
            inn += n
        else:
            out[path] = torch.zeros(t.shape, **f32)
    for path, t in leaves:
        if path[-1] == "g":
            w = out[path[:-1] + ("w",)]
            out[path] = torch.sqrt(torch.sum(
                w * w, dim=tuple(range(1, w.dim()))))
        elif path[-1] == "conv_in_g":
            w = out[path[:-1] + ("conv_in",)]
            out[path] = torch.sqrt(torch.sum(w * w, dim=(0, 1)))
    return unflatten_like(template, iter(out[p] for p, _ in leaves))


def clone_tree(tree, device):
    return unflatten_like(tree, iter(
        t.detach().to(device, copy=True) for _, t in flatten(tree)))


# ---------------------------------------------------------------------------
# audio and conditioners
# ---------------------------------------------------------------------------

MU = 255.0


def mulaw_levels(x, q: int):
    """mu-law companding then midrise quantization of x in [-1, 1)."""
    y = torch.sign(x) * torch.log1p(MU * torch.abs(x)) / math.log1p(MU)
    return torch.floor(0.5 * (y + 1.0) * (q - 1e-6)).to(torch.int32)


def audio_levels(gen, rows: int, length: int, q: int, device):
    """(rows, length) int32 mu-law levels of a speech-like signal: four
    sinusoids a row (80-2000 Hz, random phases and amplitudes) and a little
    noise, at 16 kHz."""
    f32 = {"device": device, "dtype": torch.float32}
    freq = 80.0 + 1920.0 * torch.rand((rows, 4, 1), generator=gen, **f32)
    amp = 0.05 + 0.2 * torch.rand((rows, 4, 1), generator=gen, **f32)
    phase = 2 * math.pi * torch.rand((rows, 4, 1), generator=gen, **f32)
    t = torch.arange(length, **f32) / 16000.0
    x = torch.sum(amp * torch.sin(2 * math.pi * freq * t + phase), dim=1)
    x = x + 0.02 * torch.randn((rows, length), generator=gen, **f32)
    return mulaw_levels(torch.clamp(x, -0.999, 0.999), q)


def conditioners(gen, shape, device):
    """Conditioner frames in [0, 1), min-max normalized as the corpus
    stores them."""
    return torch.rand(shape, generator=gen, device=device)


def speakers(gen, n: int, spk_dim: int, device):
    return torch.randint(0, spk_dim, (n,), generator=gen, device=device,
                         dtype=torch.int64)


def stratified(rng: np.random.Generator, n: int, quantile):
    """n values at the quantiles (i + 0.5) / n of a distribution, in an
    order drawn from `rng`: every seed gets the same values."""
    u = (np.arange(n) + 0.5) / n
    return rng.permutation(quantile(u))
