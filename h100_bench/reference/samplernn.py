"""Plain float32 SampleRNN, its speaker discriminator and its train step.

The reference of both configurations (configs/samplernn.json,
configs/samplernn_gan.json), from the model's description (Barbany et al.,
Multi-Speaker Neural Vocoder, IberSpeech 2018; the upstream SampleRNN
model.py): two frame tiers of GRUs, each tier's output upsampled by a
transposed convolution of kernel = stride into the slots of the tier below,
the top tier conditioned on the acoustic frames (through the variant's
conditioner head) and a speaker embedding, and a sample MLP over the last
fs0 embedded samples. The loss is the NLL in bits, the optimizer Adam on
gradients clipped element-wise to [-1, 1]. The GAN variant's discriminator
reads the conditioner's latent as a one-channel image: four blocks of
reflection pad, 5x5 conv, LeakyReLU 0.2, pad, 5x5 conv, InstanceNorm,
with a skip where the channels match, then a mean-pooled classifier.

It reads the weights in the port's parameter layout (the benchmark makes
them and hands the same to both). Every product goes through `Precision`:
float32 with TF32 off (the reference), TF32, or fp8 e4m3 operands with a
scale per tensor (the controls). Nothing here is fused or cached: the
embedding is gathered and convolved, the GRUs run step by step.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0


class Precision:
    """How the reference multiplies: "f32" (TF32 off), "tf32", "fp8"."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    @contextlib.contextmanager
    def flags(self):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        tf32 = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def q(self, x):
        if self.mode != "fp8":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        y = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # rounding is not differentiated: the gradient passes straight
        return x + (y - x).detach()

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv2d(self, x, w, b=None):
        return F.conv2d(self.q(x), self.q(w), b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _norm_rows(w, g):
    """Weight norm: each slice along dim 0 scaled to the norm g."""
    dims = tuple(range(1, w.dim()))
    return g.view((-1,) + (1,) * len(dims)) * w / torch.sqrt(
        torch.sum(w * w, dim=dims, keepdim=True))


def dense(P, p, x):
    w = p["w"] if "g" not in p else _norm_rows(p["w"], p["g"])
    y = P.mm(x, w.t())
    return y + p["b"] if "b" in p else y


def upsample(P, p, x):
    """(B, T, d) -> (B, T * r, o); weight (d, r, o), bias (r, o)."""
    w = p["w"] if "g" not in p else _norm_rows(p["w"], p["g"])
    d, r, o = w.shape
    b, t, _ = x.shape
    y = P.mm(x, w.reshape(d, r * o)).reshape(b, t, r, o) + p["bias"]
    return y.reshape(b, t * r, o)


def gru(P, layers, x, h0):
    """Multi-layer GRU, gates [r, z, n]; x (B, T, d), h0 (layers, B, H)."""
    hs = []
    y = x
    for i, p in enumerate(layers):
        xp = P.mm(y, p["w_ih"].t()) + p["b_ih"]
        h = h0[i]
        out = []
        for t in range(y.shape[1]):
            hp = P.mm(h, p["w_hh"].t()) + p["b_hh"]
            xr, xz, xn = xp[:, t].chunk(3, dim=-1)
            hr, hz, hn = hp.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            out.append(h)
        y = torch.stack(out, dim=1)
        hs.append(h)
    return y, torch.stack(hs)


def conditioner(P, m, p, cond):
    """-> (expanded (B, T, dim), latent or None)."""
    if m["variant"] == "identity":
        return dense(P, p["expand"], cond), None
    x = cond
    for i, layer in enumerate(p["stack"]):
        x = dense(P, layer, x)
        if i < len(p["stack"]) - 1:
            x = torch.relu(x)
    return dense(P, p["expand"], x), x


def dequantize(m, x):
    """Levels to [-1, 1]: midrise inverse, then mu-law expansion."""
    q = m["q_levels"]
    c = x.to(torch.float32) * 2.0 / q - 1.0
    if not m["ulaw"]:
        return c
    return torch.sign(c) * torch.expm1(torch.abs(c) * math.log1p(255.0)) \
        / 255.0


def ns_frame_samples(m):
    out, acc = [], 1
    for fs in m["frame_sizes"]:
        acc *= fs
        out.append(acc)
    return out


def forward(P, m, params, inp, reset, cond, spk, state):
    """Logits (B, L, q) of one chunk. inp (B, L + lookback - 1) levels;
    reset: start every tier from its learned h0; cond (B, L // lookback,
    C); spk (B,) ids; state [(n_rnn, B, dim)] per tier.
    -> (logits, new_state, latent)."""
    nfs_all = ns_frame_samples(m)
    lookback = nfs_all[-1]
    batch, total = inp.shape
    seq_len = total - lookback + 1
    n_tiers = len(nfs_all)
    upper, latent, new_state = None, None, [None] * n_tiers
    for t in range(n_tiers - 1, -1, -1):
        tier = params["tiers"][t]
        nfs = nfs_all[t]
        frames = inp[:, lookback - nfs:total - nfs + 1]
        prev = 2.0 * dequantize(m, frames).reshape(batch, seq_len // nfs, nfs)
        x = dense(P, tier["input_expand"], prev)
        if upper is None:
            c, latent = conditioner(P, m, tier["conditioner"], cond)
            emb = tier["spk_embedding"][spk]
            x = x + c + dense(P, tier["spk_expand"], emb)[:, None, :]
        else:
            x = x + upper
        h0 = tier["h0"][:, None, :].expand(m["n_rnn"], batch, m["dim"])
        hidden = h0 if reset else state[t]
        y, new_state[t] = gru(P, tier["gru"], x, hidden)
        upper = upsample(P, tier["upsample"], y)
    mlp = params["mlp"]
    fs0 = m["frame_sizes"][0]
    samples = inp[:, lookback - fs0:]
    emb = mlp["embedding"][samples.long()]             # (B, L + fs0 - 1, q)
    w = mlp["conv_in"]
    if "conv_in_g" in mlp:
        w = mlp["conv_in_g"] * w / torch.sqrt(
            torch.sum(w * w, dim=(0, 1), keepdim=True))
    x = upper
    for k in range(fs0):
        x = x + P.mm(emb[:, k:k + seq_len], w[k])
    x = torch.relu(x)
    x = torch.relu(dense(P, mlp["hidden"], x))
    return dense(P, mlp["out"], x), new_state, latent


def nll_bits(logits, target):
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, target[..., None].long())[..., 0]
    return torch.mean(lse - picked) / math.log(2.0)


def _reflect(x):
    return F.pad(x, (2, 2, 2, 2), mode="reflect")


def discriminator_nll(P, disc, latent, spk):
    """Speaker NLL (nats) of the latent (B, T, C_lat)."""
    x = latent[:, None]
    for block in disc["blocks"]:
        w1 = block["conv1"]["w"].permute(3, 2, 0, 1)
        y = P.conv2d(_reflect(x), w1, block["conv1"]["b"])
        y = F.leaky_relu(y, 0.2)
        w2 = block["conv2"]["w"].permute(3, 2, 0, 1)
        y = P.conv2d(_reflect(y), w2)
        mean = y.mean(dim=(2, 3), keepdim=True)
        c = y - mean
        y = c * torch.rsqrt((c * c).mean(dim=(2, 3), keepdim=True) + 1e-5)
        x = y + x if x.shape[1] == y.shape[1] else y
    pooled = F.leaky_relu(x, 0.2).mean(dim=(2, 3))
    logp = torch.log_softmax(dense(P, disc["classifier"], pooled), dim=-1)
    return -torch.mean(torch.gather(logp, -1, spk[:, None].long()))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def lambda_ramp(train, step: int, device):
    """start + (target - start) * clip(step / ramp, 0, 1), in float32."""
    start, target, ramp = train["lambda_weight"]
    f = lambda v: torch.full((), v, dtype=torch.float32, device=device)  # noqa
    frac = torch.clamp(f(float(step)) / f(max(ramp, 1.0)), 0.0, 1.0)
    return f(start) + f(target - start) * frac


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


class Adam:
    """Adam after an element-wise clip to [-clip, clip]."""

    def __init__(self, leaves, lr: float, clip: float):
        self.lr, self.clip, self.count = lr, clip, 0
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]

    def clipped(self, grads):
        return [g.clamp(-self.clip, self.clip) for g in grads]

    @torch.no_grad()
    def update(self, leaves, grads):
        self.count += 1
        bc1 = 1.0 - B1 ** self.count
        bc2 = 1.0 - B2 ** self.count
        for p, g, mu, nu in zip(leaves, self.clipped(grads), self.mu,
                                self.nu):
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            p.sub_(self.lr / bc1 * mu / (torch.sqrt(nu / bc2) + EPS))


def train_steps(m, train, params0, disc0, chunks, prec="f32"):
    """Run the train step on `chunks` [(inp, reset, target, cond, spk)]
    from params0 (and the GAN's discriminator disc0, or None).

    -> {"loss": [per step], "grad_leaves": [the first step's clipped
    gradient], "grad": [its norm per leaf], "change": [norm per leaf of
    params - params0 after the last step]}, and for the GAN "disc_loss",
    "lambda", "disc_grad_leaves", "disc_grad", "disc_change" alike. The params are cloned; the inputs are not
    changed."""
    P = Precision(prec)
    gan = disc0 is not None
    p_leaves = [t.detach().clone() for t in _leaves(params0)]
    d_leaves = [t.detach().clone() for t in _leaves(disc0)] if gan else []
    opt = Adam(p_leaves, train["learning_rate"], train["grad_clip"])
    d_opt = Adam(d_leaves, train["learning_rate"], train["grad_clip"])
    out = {"loss": [], "disc_loss": [], "lambda": []}
    state = None
    with P.flags():
        for i, (inp, reset, target, cond, spk) in enumerate(chunks):
            for leaf in p_leaves + d_leaves:
                leaf.requires_grad_(True)
            params = _rebuild(params0, iter(p_leaves))
            with torch.enable_grad():
                logits, new_state, latent = forward(
                    P, m, params, inp, reset, cond, spk, state)
                l1 = nll_bits(logits, target)
                loss = l1
                if gan:
                    lam = lambda_ramp(train, i, inp.device)
                    disc = _rebuild(disc0, iter(d_leaves))
                    frozen = _rebuild(disc0, iter(
                        [d.detach() for d in d_leaves]))
                    loss = l1 - lam * discriminator_nll(P, frozen, latent,
                                                        spk)
                    l2 = discriminator_nll(P, disc, latent.detach(), spk)
            grads = torch.autograd.grad(loss, p_leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(p_leaves, grads)]
            out["loss"].append(float(l1.detach()))
            if i == 0:
                out["grad_leaves"] = opt.clipped(grads)
                out["grad"] = _norms(out["grad_leaves"])
            if gan:
                d_grads = torch.autograd.grad(l2, d_leaves)
                out["disc_loss"].append(float(l2.detach()))
                out["lambda"].append(float(lam))
                if i == 0:
                    out["disc_grad_leaves"] = d_opt.clipped(d_grads)
                    out["disc_grad"] = _norms(out["disc_grad_leaves"])
            for leaf in p_leaves + d_leaves:
                leaf.requires_grad_(False)
            opt.update(p_leaves, grads)
            if gan:
                d_opt.update(d_leaves, d_grads)
            state = [s.detach() for s in new_state]
    out["change"] = _norms([p - p0 for p, p0 in
                            zip(p_leaves, _leaves(params0))])
    if gan:
        out["disc_change"] = _norms([p - p0 for p, p0 in
                                     zip(d_leaves, _leaves(disc0))])
    return out


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def generation_logits(m, params, seq, cond, spk, prec="f32"):
    """Logits (B, N, q) of every sample of generated sequences seq (B, N)
    given the samples before it: a fresh stream (learned h0, lookback
    samples of silence), conditioner frames cond (B, N // lookback, C) and
    speaker ids spk (B,)."""
    P = Precision(prec)
    lookback = ns_frame_samples(m)[-1]
    zero = torch.full((seq.shape[0], lookback), m["q_levels"] // 2,
                      dtype=seq.dtype, device=seq.device)
    inp = torch.cat([zero, seq], dim=1)[:, :-1]
    with P.flags(), torch.no_grad():
        logits, _, _ = forward(P, m, params, inp, True, cond, spk, None)
    return logits
