"""The TBPTT train step over a device-resident corpus, as `msnv-train-torch`
runs it: the indexed step (`make_train_step_indexed`), or for a GAN
configuration the two-optimizer step (`make_gan_train_step_indexed`) with
its discriminator, the lambda ramp from step 0; products in the traffic's
compute type (bfloat16: mixed precision, float32: TF32 off), the GRU sweeps
in the fused kernels.

The corpus (`chunks` chunks of `batch` rows of mu-law audio, conditioners,
speakers) is made on the device from --seed, and the steps walk it in
order, carrying the TBPTT state. Set-up takes the first `checked_steps`
steps through the same call: the check holds them to the plain reference
(reference/samplernn.py, float32) from the same weights and chunks: each
step's loss, the norm of every leaf of the first step's gradient as the
optimizer got it (its first moment over 1 - beta1), and of every leaf's
change over the checked steps, each as the gap between the two norms over
the larger of the reference's norm of the leaf and of the median leaf.
The window then steps on until `seconds` have passed; train_samples_per_s
is batch x seq_len x steps over the window's wall time, the last step
synchronized.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from h100_bench import harness, inputs, stats, trace
from h100_bench.reference import samplernn as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}
B1 = 0.9
FAR = 1e30


def _norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def _flat(tree):
    return [t for _, t in inputs.flatten(tree)]


class Driver:
    def __init__(self, ctx: harness.Context):
        from msnv_tpu_torch.config import TrainConfig
        from msnv_tpu_torch.device import float32_convolutions
        from msnv_tpu_torch.models.samplernn import (init_params,
                                                     init_tier_state)
        from msnv_tpu_torch.training.optim import make_optimizer
        from msnv_tpu_torch.training.step import make_train_step_indexed
        from msnv_tpu_torch.kernels import gru_layer

        self.ctx, self.gru_layer = ctx, gru_layer
        m, t, tr, dev = ctx.model, ctx.train, ctx.traffic, ctx.device
        float32_convolutions()         # as the train CLI sets it
        self.cfg = harness.model_config(m)
        self.gan = m["variant"] == "gan"
        self.batch, self.seq_len = tr["batch"], t["seq_len"]
        lookback = self.cfg.lookback
        self.cond_in_seq = self.seq_len // lookback
        self.n_chunks = tr["chunks"]
        self.compute = tr["compute_dtype"]
        wgen = inputs.generator(dev, ctx.seed, "weights")
        self.params = inputs.fill_tree(init_params(self.cfg, device="meta"),
                                       wgen, dev)
        self.disc = None
        if self.gan:
            from msnv_tpu_torch.models.discriminator import \
                discriminator_init
            self.disc = inputs.fill_tree(discriminator_init(
                torch.Generator(), m["spk_dim"], t["disc_channels"],
                device="meta"), wgen, dev)
        # the reference's copy of the starting weights, on the host
        self.params0 = inputs.clone_tree(self.params, "cpu")
        self.disc0 = (inputs.clone_tree(self.disc, "cpu") if self.gan
                      else None)
        self.corpus = self._corpus()
        tcfg = TrainConfig(
            seq_len=self.seq_len, batch_size=self.batch,
            learning_rate=t["learning_rate"], scheduler=t["scheduler"],
            grad_clip=t["grad_clip"],
            lambda_weight=tuple(t["lambda_weight"]),
            disc_channels=t["disc_channels"])
        opt = make_optimizer(tcfg, steps_per_epoch=self.n_chunks)
        self.opt_state = opt.init(self.params)
        geo = (self.seq_len, lookback, self.cond_in_seq)
        cd = DTYPES[self.compute]
        if self.gan:
            from msnv_tpu_torch.training.gan import \
                make_gan_train_step_indexed
            self.disc_state = opt.init(self.disc)
            self.step_fn = make_gan_train_step_indexed(
                self.cfg, tcfg, opt, opt, *geo, compute_dtype=cd)
        else:
            self.step_fn = make_train_step_indexed(self.cfg, opt, *geo,
                                                   compute_dtype=cd)
        self.state = init_tier_state(self.cfg, self.batch, device=dev)
        self.i = 0
        self._truth = None
        self.seen = self._checked_steps(tr["checked_steps"])

    def _corpus(self):
        ctx, m = self.ctx, self.ctx.model
        g = inputs.generator(ctx.device, ctx.seed, "corpus")
        n = self.n_chunks * self.seq_len + self.cfg.lookback
        frames = self.n_chunks * self.cond_in_seq + 2
        c = m["cond_dim"] * (2 if m["look_ahead"] else 1)
        return {"qdata": inputs.audio_levels(g, self.batch, n,
                                             m["q_levels"], ctx.device),
                "cond": inputs.conditioners(g, (self.batch, frames, c),
                                            ctx.device),
                "spk": inputs.speakers(g, self.n_chunks * self.batch,
                                       m["spk_dim"], ctx.device)
                .view(self.n_chunks, self.batch).to(torch.int32)}

    def chunk(self, k):
        """(inp, reset, target, cond, spk) of chunk k, as the indexed step
        slices it (the loader's one-frame conditioner offset)."""
        c, L, lb = self.corpus, self.seq_len, self.cfg.lookback
        s = k * L
        return (c["qdata"][:, s:s + L + lb - 1], k == 0,
                c["qdata"][:, s + lb:s + lb + L],
                c["cond"][:, k * self.cond_in_seq + 1:
                          (k + 1) * self.cond_in_seq + 1],
                c["spk"][k])

    def _step(self):
        k = self.i % self.n_chunks
        if self.gan:
            (self.params, self.disc, self.opt_state, self.disc_state,
             self.state, metrics) = self.step_fn(
                self.params, self.disc, self.opt_state, self.disc_state,
                self.state, self.i, self.corpus, k)
        else:
            self.params, self.opt_state, self.state, loss = self.step_fn(
                self.params, self.opt_state, self.state, self.corpus, k)
            metrics = {"loss": loss}
        self.i += 1
        return metrics

    def _checked_steps(self, n):
        """The first n steps, through the window's own call; what the
        check compares is read from them."""
        seen = {"loss": [], "disc_loss": [], "lambda": []}
        for i in range(n):
            metrics = self._step()
            for key in seen:
                if key in metrics:
                    seen[key].append(float(metrics[key]))
            if i == 0:
                # the first gradient as the optimizer got it, on the host
                seen["grad_leaves"] = [
                    (mu / (1.0 - B1)).cpu()
                    for mu in _flat(self.opt_state["mu"])]
                seen["grad"] = _norms(seen["grad_leaves"])
                if self.gan:
                    seen["disc_grad_leaves"] = [
                        (mu / (1.0 - B1)).cpu()
                        for mu in _flat(self.disc_state["mu"])]
                    seen["disc_grad"] = _norms(seen["disc_grad_leaves"])
        dev = self.ctx.device
        seen["change"] = _norms([p - p0.to(dev) for p, p0 in zip(
            _flat(self.params), _flat(self.params0))])
        if self.gan:
            seen["disc_change"] = _norms([p - p0.to(dev) for p, p0 in zip(
                _flat(self.disc), _flat(self.disc0))])
        self._sync()
        return seen

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _counters(self):
        f, b = self.gru_layer.gru_layer_forward, \
            self.gru_layer.gru_layer_backward
        return f.launches + b.launches

    def window(self, seconds, trace_on):
        self._sync()
        t0 = time.perf_counter()
        t_end = t0 + seconds
        steps = 0
        while time.perf_counter() < t_end:
            self._step()
            steps += 1
        self._sync()
        wall = time.perf_counter() - t0
        samples = self.batch * self.seq_len * steps
        raw = {"steps": steps, "wall_s": wall, "batch": self.batch,
               "seq_len": self.seq_len, "dtype": self.compute,
               "gan": self.gan}
        summary = None
        if trace_on:
            n = self.ctx.traffic["traced_steps"]
            c0 = self._counters()

            def run():
                for _ in range(n):
                    self._step()

            _, summary = trace.traced(run, self.ctx.device)
            raw["traced_sweeps"] = self._counters() - c0
        return harness.Window(
            {"train_samples_per_s": stats.rate(samples, wall)}, steps, 0,
            raw, summary)

    def finish(self):
        self.step_fn = self.params = self.disc = None
        self.opt_state = self.state = None
        if self.gan:
            self.disc_state = None

    def reference(self, prec="f32", rows=None):
        """The plain reference's readings of the checked steps, in `prec`,
        on the first `rows` rows of each chunk (default all)."""
        dev = self.ctx.device
        n = len(self.seen["loss"])
        params0 = inputs.clone_tree(self.params0, dev)
        disc0 = inputs.clone_tree(self.disc0, dev) if self.gan else None
        chunks = [self.chunk(k) for k in range(n)]
        if rows is not None:
            chunks = [(c[0][:rows], c[1], c[2][:rows], c[3][:rows],
                       c[4][:rows]) for c in chunks]
        return ref.train_steps(self.ctx.model, self.ctx.train, params0,
                               disc0, chunks, prec)

    def check(self, control=None) -> dict:
        """The numbers compared; with `control` the reference stands in the
        program's place: "fp8" or "tf32" its precision, "half" its float32
        steps on half of each batch."""
        if self._truth is None:
            self._truth = self.reference()
        truth = self._truth
        if control is None:
            seen = self.seen
        elif control == "half":
            seen = self.reference(rows=self.batch // 2)
        else:
            seen = self.reference(control)
        return compare(seen, truth, self.gan)


def rel_gap(prog, ref_vals):
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref_vals))


def leaf_gap(prog, ref_vals, keep=None):
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of the leaf and of the median leaf."""
    idx = range(len(ref_vals)) if keep is None else keep
    med = statistics.median(ref_vals[i] for i in idx)
    return max(abs(prog[i] - ref_vals[i]) / max(ref_vals[i], med)
               for i in idx)


def moved(grads):
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's."""
    med = statistics.median(grads)
    return [i for i, g in enumerate(grads) if g >= 1e-3 * med]


def diff_gaps(prog, ref_leaves):
    """The norm of the difference of two gradients, leaf by leaf, over the
    larger of the reference's norm of the leaf and of the median leaf ->
    (the worst leaf's, the median leaf's): a first-order reading of each
    element's error, where a gap of norms reads random errors only to
    second order."""
    ref_norms = _norms(ref_leaves)
    med = statistics.median(ref_norms)
    gaps = [_norms([p.to(r.device) - r])[0] / max(n, med)
            for p, r, n in zip(prog, ref_leaves, ref_norms)]
    return max(gaps), statistics.median(gaps)


def compare(seen, r, gan) -> dict:
    worst, med = diff_gaps(seen["grad_leaves"], r["grad_leaves"])
    out = {"loss_gap": rel_gap(seen["loss"], r["loss"]),
           "grad_gap": leaf_gap(seen["grad"], r["grad"]),
           "grad_diff": worst, "grad_diff_med": med,
           "update_gap": leaf_gap(seen["change"], r["change"],
                                  moved(r["grad"]))}
    if gan:
        out["disc_loss_gap"] = rel_gap(seen["disc_loss"], r["disc_loss"])
        out["disc_grad_gap"] = leaf_gap(seen["disc_grad"], r["disc_grad"])
        out["disc_grad_diff"], out["disc_grad_diff_med"] = diff_gaps(
            seen["disc_grad_leaves"], r["disc_grad_leaves"])
        out["disc_update_gap"] = leaf_gap(seen["disc_change"],
                                          r["disc_change"],
                                          moved(r["disc_grad"]))
        out["lambda_gap"] = max(abs(a - b) for a, b in
                                zip(seen["lambda"], r["lambda"]))
    # a NaN compares false with every limit: read it as the worst gap
    return {k: (FAR if math.isnan(v) else v) for k, v in out.items()}
