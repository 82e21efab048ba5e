"""Autoregressive generation: tier clocks as nested Python loops.

Port of the JAX package's models/generate.py. Semantics parity with the JAX
package (and through it with the reference `Generator.__call__`, ref
model.py:439-520):
- output length == num_cond_frames * lookback (ref model.py:455 quirk)
- the sequence is seeded with `lookback` samples of q_zero (ref model.py:459)
- hidden state starts at the learned h0
- tier t fires every ns_frame_samples[t] samples; the top tier consumes
  cond frame j and the speaker vector (an int id, or float mix weights
  over the speaker embeddings); lower tiers consume the parent's
  upsampled slot
- the sample MLP sees the last fs0 samples (as fs0 rows of the fused
  embed+conv table) + tier-0's slot and draws from the q-way softmax
- tier inputs are 2 * dequantize(prev), like training

Randomness comes from an explicit `torch.Generator` on the params' device
(JAX threads a key). A draw is Gumbel-max: argmax(logits / T + gumbel).
Temperature 0 is greedy argmax and draws nothing.

The machinery takes its draws from a source: the caller's generator (the
live path), or a tensor holding them in the order the live path makes
them (`program_fns`, the form `torch.export` traces: a generator cannot
cross it). `draw_tensor` makes that tensor from a generator with the live
path's calls, so both forms give the same samples.

With `use_kernel=True` the bottom tier's fs0 samples per slot window run in
the CUDA sample-window kernel (msnv_tpu_torch/kernels/sample_window.py:
bf16 weights resident in a cluster's shared memory, float32 across the
shared memory of the grid kernel's CTAs) with its Philox draw keyed on a
seed drawn from the generator. On CPU tensors the same call runs the
kernel's plain version on the same Philox noise (the counterpart of the
JAX interpret mode).

The JAX package also has `generate_fn_dynamic` / `streaming_fn_dynamic`,
which exist only because jit folds closed-over weights into the
executable. Here the functions below are plain Python over tensors: the
params are always a live argument, so one form serves both uses.
"""

from __future__ import annotations

import math

import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.kernels.sample_window import (gumbel_noise,
                                                  pack_window_weights_op,
                                                  resident_weights,
                                                  sample_window,
                                                  sample_window_op)
from msnv_tpu_torch.models.conditioner import conditioner_apply
from msnv_tpu_torch.models.samplernn import (dequantize, fused_embed_conv,
                                             rnn_cell)
from msnv_tpu_torch.ops.linear import dense_apply, dense_weight
from msnv_tpu_torch.ops.quantize import q_zero
from msnv_tpu_torch.ops.upsample import upsample_step
from msnv_tpu_torch.tree import tree_map

__all__ = ["cast_float_tree", "draw_tensor", "fused_embed_conv",
           "generate_fn", "program_fns", "streaming_fn",
           "teacher_forced_log_probs"]


def cast_float_tree(tree, dtype):
    """Cast floating leaves to `dtype` (differentiably: the mixed-precision
    train step takes gradients through it); ints kept."""
    def cast(x):
        if torch.is_tensor(x) and x.is_floating_point():
            return x.to(dtype)
        return x
    return tree_map(cast, tree)


def _device(params) -> torch.device:
    return params["mlp"]["embedding"].device


class _GeneratorDraws:
    """The live path's randomness: drawn from a torch.Generator as it is
    needed."""

    def __init__(self, generator):
        self.generator = generator

    def seed(self, device):
        """A window's Philox seed, (1,) int64; it stays on the device: no
        host sync per window."""
        return torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                             device=device, dtype=torch.int64)

    def gumbel(self, shape, device):
        """One sample's Gumbel noise."""
        return gumbel_noise(shape, self.generator, device)


class _GivenDraws:
    """Randomness given as a tensor: row i is the i-th draw the live path
    would make (a (1,) seed or a (B, q) noise)."""

    def __init__(self, draws):
        self.draws = draws
        self.i = 0

    def _next(self):
        if self.draws is None or self.i >= self.draws.shape[0]:
            raise ValueError("the given draws are used up")
        self.i += 1
        return self.draws[self.i - 1]

    def seed(self, device):
        return self._next().reshape(1)

    def gumbel(self, shape, device):
        return self._next()


def _mlp_logits(params, fused_table, buf, slot):
    """Pre-softmax f32 logits for the next sample.

    buf (B, >= fs0) int ring buffer; slot (B, dim) tier-0 conditioning.
    The gather and the hidden layer run in the weight dtype; the output
    layer accumulates in f32.
    """
    fs0, q, dim = fused_table.shape
    offsets = torch.arange(fs0, device=buf.device, dtype=torch.int64) * q
    rows = fused_table.reshape(fs0 * q, dim)[buf[:, -fs0:].long() + offsets]
    x = slot
    for p in range(fs0):
        x = x + rows[:, p]
    x = torch.relu(x)
    x = torch.relu(dense_apply(params["mlp"]["hidden"], x))
    out = params["mlp"]["out"]
    logits = torch.matmul(x.float(), dense_weight(out).float().T)
    return logits + out["b"].float()


def _check_temperature(temperature):
    """A negative/NaN temperature would silently sample the least likely
    levels (logits flip sign); fail loudly instead."""
    if not (isinstance(temperature, (int, float))
            and math.isfinite(temperature) and temperature >= 0.0):
        raise ValueError(
            f"temperature must be a finite float >= 0, got {temperature!r}")


def _mlp_sample(params, fused_table, buf, slot, draws, temperature=1.0):
    """One sample per lane -> (B,) int32. 1.0 keeps the reference's
    multinomial-from-softmax semantics; 0.0 is greedy argmax."""
    logits = _mlp_logits(params, fused_table, buf, slot)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if temperature != 1.0:
        logits = logits / temperature
    noise = draws.gumbel(logits.shape, logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def _kernel_window_sampler(params, cfg: ModelConfig, fused_table,
                           temperature=1.0, traced=False):
    """(buf, draws, slots (B, fs0, dim)) -> (buf, samples (B, fs0))
    through the sample-window kernel.

    Temperature needs no kernel change: argmax(logits/T + g) is what the
    kernel computes when fed W_o/T and b_o/T. Greedy (T == 0) stays on the
    per-sample path. traced: call the kernel as the custom op
    `msnv_torch::sample_window` (what torch.export can trace), with the
    weights packed once per call of the traced program by
    `msnv_torch::pack_window_weights` on a CUDA device.
    """
    if temperature <= 0.0:
        raise ValueError("the kernel sampler needs temperature > 0 "
                         "(greedy decoding runs the per-sample path)")
    fs0, q, dim = fused_table.shape
    table = fused_table.reshape(fs0 * q, dim).contiguous()
    wh = dense_weight(params["mlp"]["hidden"]).T.to(table.dtype).contiguous()
    bh = params["mlp"]["hidden"]["b"].float().contiguous()
    wo = dense_weight(params["mlp"]["out"]).T
    bo = params["mlp"]["out"]["b"].float()
    if temperature != 1.0:
        wo = wo * (1.0 / temperature)
        bo = bo * (1.0 / temperature)
    wo = wo.to(table.dtype).contiguous()
    bo = bo.contiguous()
    # once per sampler: the weights in the order the resident or grid
    # kernel keeps them in shared memory (None on the CPU)
    if not traced:
        packed = resident_weights(wh, wo, fs0)
    elif table.device.type == "cuda":
        packed = pack_window_weights_op(wh, wo, fs0)
    else:
        packed = None

    def run(buf, draws, slots):
        seed = draws.seed(table.device)
        if slots.dtype != table.dtype:
            slots = slots.to(table.dtype)
        # the window is read in place: the last fs0 columns of buf
        if traced:
            samples = sample_window_op(table, wh, bh, wo, bo, slots,
                                       buf[:, -fs0:], seed, packed)
        else:
            samples = sample_window(table, wh, bh, wo, bo, slots,
                                    buf[:, -fs0:], seed=seed, packed=packed)
        return torch.cat([buf[:, fs0:], samples], dim=1), samples

    return run


def _shift(buf, s):
    return torch.cat([buf[:, 1:], s[:, None]], dim=1)


def _make_level(params, cfg: ModelConfig, t: int, fused_table,
                use_kernel=False, temperature=1.0, traced=False):
    """Step fn for tier t: (buf, hs, draws, upper_slot) ->
    (buf, hs, samples (B, nfs[t])).

    buf (B, lookback) int32; hs list of (n_rnn, B, dim) per tier;
    upper_slot (B, dim) is the parent's upsampled conditioning vector.
    """
    tier = params["tiers"][t]
    nfs = cfg.ns_frame_samples[t]
    window = None
    inner = None
    if t == 0:
        if use_kernel:
            window = _kernel_window_sampler(params, cfg, fused_table,
                                            temperature, traced)
    else:
        inner = _make_level(params, cfg, t - 1, fused_table, use_kernel,
                            temperature, traced)
    wdtype = tier["input_expand"]["w"].dtype

    def level_step(buf, hs, draws, upper_slot):
        prev = (2.0 * dequantize(cfg, buf[:, -nfs:])).to(wdtype)
        x = dense_apply(tier["input_expand"], prev) + upper_slot
        y, h_new = rnn_cell(cfg, tier["gru"], x, hs[t])
        hs = hs[:t] + [h_new] + hs[t + 1:]
        slots = upsample_step(tier["upsample"], y)        # (B, fs, dim)
        if window is not None:
            buf, samples = window(buf, draws, slots)
            return buf, hs, samples
        outs = []
        for j in range(slots.shape[1]):
            if inner is None:
                s = _mlp_sample(params, fused_table, buf, slots[:, j],
                                draws, temperature)
                buf = _shift(buf, s)
                outs.append(s[:, None])
            else:
                buf, hs, s = inner(buf, hs, draws, slots[:, j])
                outs.append(s)
        return buf, hs, torch.cat(outs, dim=1)

    return level_step


class _TopTier:
    """The top tier's clock shared by generate_fn and streaming_fn: the
    speaker vector and fresh carry, and one conditioner frame step."""

    def __init__(self, params, cfg: ModelConfig, use_kernel, temperature,
                 traced=False):
        self.params = params
        self.cfg = cfg
        self.temperature = temperature
        self.top = cfg.n_tiers - 1
        self.tier = params["tiers"][self.top]
        self.nfs = cfg.ns_frame_samples[self.top]
        self.fused = fused_embed_conv(params["mlp"])
        self.below = (_make_level(params, cfg, self.top - 1, self.fused,
                                  use_kernel, temperature, traced)
                      if self.top > 0 else None)
        self.wdtype = self.tier["input_expand"]["w"].dtype

    def speaker_vector(self, spk):
        table = self.tier["spk_embedding"]
        spk = torch.as_tensor(spk, device=table.device)
        if spk.is_floating_point():
            # eigen-voice mix (thesis §3.3): float (B, spk_dim) weights
            emb = torch.matmul(spk.to(table.dtype), table)
        else:
            emb = table[spk.long()]
        return dense_apply(self.tier["spk_expand"], emb)

    def fresh(self, batch):
        """(buf of q_zero, hs at the learned h0) for `batch` lanes."""
        cfg = self.cfg
        device = self.tier["h0"].device
        buf = torch.full((batch, cfg.lookback), q_zero(cfg.q_levels),
                         dtype=torch.int32, device=device)
        hs = [p_t["h0"][:, None, :].expand(cfg.n_rnn, batch, cfg.dim)
              for p_t in self.params["tiers"]]
        return buf, hs

    def frame_step(self, spk_vec, buf, hs, draws, cond_j):
        cfg, tier, top = self.cfg, self.tier, self.top
        prev = (2.0 * dequantize(cfg, buf[:, -self.nfs:])).to(self.wdtype)
        x = dense_apply(tier["input_expand"], prev)
        c, _ = conditioner_apply(tier["conditioner"], cfg,
                                 cond_j[:, None, :].to(self.wdtype))
        x = x + c[:, 0, :] + spk_vec
        y, h_new = rnn_cell(cfg, tier["gru"], x, hs[top])
        hs = hs[:top] + [h_new] + hs[top + 1:]
        slots = upsample_step(tier["upsample"], y)    # (B, fs_top, dim)
        outs = []
        for j in range(slots.shape[1]):
            if self.below is not None:
                buf, hs, s = self.below(buf, hs, draws, slots[:, j])
                outs.append(s)
            else:
                s = _mlp_sample(self.params, self.fused, buf, slots[:, j],
                                draws, self.temperature)
                buf = _shift(buf, s)
                outs.append(s[:, None])
        return buf, hs, torch.cat(outs, dim=1)


def _prepare(params, cfg, compute_dtype, use_kernel, temperature,
             traced=False):
    _check_temperature(temperature)
    if compute_dtype is not None:
        params = cast_float_tree(params, compute_dtype)
    if use_kernel and cfg.n_tiers < 2:
        raise ValueError("the kernel path needs a frame tier above the MLP")
    return _TopTier(params, cfg, use_kernel, temperature, traced)


def _default_generator(device, generator):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def generate_fn(params, cfg: ModelConfig, compute_dtype=None,
                use_kernel=False, temperature=1.0):
    """Build generate(cond, spk, generator=None) -> (audio, sequences).

    cond: (B, num_frames, effective_cond_dim) conditioners on the params'
      device. spk: (B,) int speaker ids, or (B, spk_dim) float mix weights.
    generator: torch.Generator on that device (default: seeded with 0).
    compute_dtype: cast float params once (e.g. torch.bfloat16); the
      output logits and the draw stay f32.
    use_kernel: run the bottom tier's sample windows in the sample-window
      kernel (needs n_tiers >= 2 and temperature > 0).
    temperature: 1.0 = reference multinomial; 0.0 = greedy argmax.
    Returns (float32 audio (B, num_frames*lookback), int32 sample levels).
    """
    machine = _prepare(params, cfg, compute_dtype, use_kernel, temperature)

    @torch.no_grad()
    def generate(cond, spk, generator=None):
        device = _device(machine.params)
        draws = _GeneratorDraws(_default_generator(device, generator))
        batch = cond.shape[0]
        spk_vec = machine.speaker_vector(spk)
        buf, hs = machine.fresh(batch)
        frames = []
        for j in range(cond.shape[1]):
            buf, hs, s = machine.frame_step(spk_vec, buf, hs, draws,
                                            cond[:, j])
            frames.append(s)
        seq = torch.cat(frames, dim=1)
        return dequantize(cfg, seq), seq

    return generate


def streaming_fn(params, cfg: ModelConfig, compute_dtype=None,
                 use_kernel=False, frames_per_push=1, temperature=1.0):
    """Streaming generation: push conditioner frames, pull samples, O(1)
    carried state.

    Returns (init_state, push):
      init_state(batch, spk, generator=None) -> carry
      push(carry, cond (B, C) when frames_per_push == 1, else
        (B, frames_per_push, C)) -> (carry, audio (B, K*lookback) float32,
        samples (same) int32)

    The per-frame math is generate_fn's, so pushes reproduce a batch
    generate() with an identically seeded generator exactly, and a K-frame
    push equals K 1-frame pushes. The carry holds the generator, which
    each push advances.
    """
    machine = _prepare(params, cfg, compute_dtype, use_kernel, temperature)

    @torch.no_grad()
    def init_state(batch, spk, generator=None):
        generator = _default_generator(_device(machine.params), generator)
        buf, hs = machine.fresh(batch)
        return (machine.speaker_vector(spk), buf, hs, generator)

    @torch.no_grad()
    def push(carry, cond):
        spk_vec, buf, hs, generator = carry
        frames = cond[:, None] if frames_per_push == 1 else cond
        draws = _GeneratorDraws(generator)
        outs = []
        for j in range(frames.shape[1]):
            buf, hs, s = machine.frame_step(spk_vec, buf, hs, draws,
                                            frames[:, j])
            outs.append(s)
        samples = torch.cat(outs, dim=1)
        return (spk_vec, buf, hs, generator), dequantize(cfg, samples), \
            samples

    return init_state, push


# --------------------------------------------------------------------------
# The traceable form: randomness given as a tensor
# --------------------------------------------------------------------------

def draw_count(cfg: ModelConfig, frames: int, use_kernel=False,
               temperature=1.0) -> int:
    """How many draws `frames` frames make: one seed per sample window on
    the kernel path, one noise per sample on the per-sample path, none
    when greedy."""
    if temperature == 0.0:
        return 0
    samples = frames * cfg.lookback
    return samples // cfg.frame_sizes[0] if use_kernel else samples


def draw_tensor(generator, cfg: ModelConfig, frames: int, batch: int,
                use_kernel=False, temperature=1.0):
    """The draws of `frames` frames at `batch` lanes, made from `generator`
    with the live path's calls in its order: (n,) int64 window seeds on
    the kernel path, (n, batch, q) float32 Gumbel noise on the per-sample
    path, None when greedy. Advances the generator as the live path
    does."""
    n = draw_count(cfg, frames, use_kernel, temperature)
    if n == 0:
        return None
    device = generator.device
    draws = _GeneratorDraws(generator)
    if use_kernel:
        return torch.cat([draws.seed(device) for _ in range(n)])
    return torch.stack([draws.gumbel((batch, cfg.q_levels), device)
                        for _ in range(n)])


def program_fns(cfg: ModelConfig, frames: int, compute_dtype=None,
                use_kernel=False, temperature=1.0):
    """(init, push): streaming_fn's carry and `frames`-frame push as plain
    functions of tensors, the form torch.export traces.

      init(params, spk) -> (spk_vec, buf, hs)
      push(params, spk_vec, buf, hs, cond (B, frames, C), draws)
        -> (buf, hs, audio, samples)

    The params are an argument (cast to compute_dtype inside, and on a
    CUDA device the window weights packed inside, on every call); draws is
    `draw_tensor`'s for these frames (None when greedy). With the carry's
    generator turned into draws by `draw_tensor`, a push gives the samples
    of streaming_fn's push exactly, and the carry it returns continues
    under either form.
    """
    _check_temperature(temperature)

    def machine(params):
        return _prepare(params, cfg, compute_dtype, use_kernel, temperature,
                        traced=True)

    def init(params, spk):
        m = machine(params)
        buf, hs = m.fresh(spk.shape[0])
        return m.speaker_vector(spk), buf, hs

    def push(params, spk_vec, buf, hs, cond, draws=None):
        m = machine(params)
        given = _GivenDraws(draws)
        outs = []
        for j in range(frames):
            buf, hs, s = m.frame_step(spk_vec, buf, hs, given, cond[:, j])
            outs.append(s)
        samples = torch.cat(outs, dim=1)
        return buf, hs, dequantize(cfg, samples), samples

    return init, push


# --------------------------------------------------------------------------
# Teacher forcing: the generation machinery driven by a given sequence
# --------------------------------------------------------------------------

def _mlp_log_probs(params, fused_table, buf, slot):
    return torch.log_softmax(_mlp_logits(params, fused_table, buf, slot),
                             dim=-1)


def _make_level_forced(params, cfg: ModelConfig, t: int, fused_table):
    """Teacher-forced twin of _make_level: (buf, hs, upper_slot, forced
    (B, nfs[t])) -> (buf, hs, log-probs (B, nfs[t], q))."""
    tier = params["tiers"][t]
    nfs = cfg.ns_frame_samples[t]
    fs = cfg.frame_sizes[t]
    inner = (_make_level_forced(params, cfg, t - 1, fused_table)
             if t > 0 else None)

    def level_step(buf, hs, upper_slot, forced):
        prev = 2.0 * dequantize(cfg, buf[:, -nfs:])
        x = dense_apply(tier["input_expand"], prev) + upper_slot
        y, h_new = rnn_cell(cfg, tier["gru"], x, hs[t])
        hs = hs[:t] + [h_new] + hs[t + 1:]
        slots = upsample_step(tier["upsample"], y)
        return _forced_slots(params, fused_table, inner, buf, hs, slots,
                             forced.reshape(forced.shape[0], fs, nfs // fs))

    return level_step


def _forced_slots(params, fused_table, inner, buf, hs, slots, forced):
    """Walk the slots of one tier step under forced samples
    (B, fs, samples per slot); returns (buf, hs, (B, fs*per_slot, q))."""
    lps = []
    for j in range(slots.shape[1]):
        if inner is None:
            lps.append(_mlp_log_probs(params, fused_table, buf,
                                      slots[:, j])[:, None])
            buf = _shift(buf, forced[:, j, 0].to(buf.dtype))
        else:
            buf, hs, lp = inner(buf, hs, slots[:, j], forced[:, j])
            lps.append(lp)
    return buf, hs, torch.cat(lps, dim=1)


def teacher_forced_log_probs(params, cfg: ModelConfig):
    """f(cond, spk, forced_seq) -> (B, T, q) log-probs, where the
    generation machinery is driven by `forced_seq` instead of sampling.
    Equivalence gate: equals predictor_apply on [q_zero*lookback ‖ forced]
    with reset=True."""
    machine = _TopTier(params, cfg, False, 1.0)
    top = machine.top
    below = (_make_level_forced(params, cfg, top - 1, machine.fused)
             if top > 0 else None)
    fs = cfg.frame_sizes[top]
    nfs = machine.nfs

    @torch.no_grad()
    def run(cond, spk, forced_seq):
        batch = cond.shape[0]
        spk_vec = machine.speaker_vector(spk)
        buf, hs = machine.fresh(batch)
        tier = machine.tier
        out = []
        for j in range(cond.shape[1]):
            forced = forced_seq[:, j * nfs:(j + 1) * nfs]
            prev = 2.0 * dequantize(cfg, buf[:, -nfs:])
            x = dense_apply(tier["input_expand"], prev)
            c, _ = conditioner_apply(tier["conditioner"], cfg,
                                     cond[:, j][:, None, :])
            x = x + c[:, 0, :] + spk_vec
            y, h_new = rnn_cell(cfg, tier["gru"], x, hs[top])
            hs = hs[:top] + [h_new] + hs[top + 1:]
            slots = upsample_step(tier["upsample"], y)
            buf, hs, lp = _forced_slots(
                params, machine.fused, below, buf, hs, slots,
                forced.reshape(batch, fs, nfs // fs))
            out.append(lp)
        return torch.cat(out, dim=1)

    return run
