"""Batched synthesis: `generate_fn` as `msnv-generate-torch` runs it.

Each call generates `batch` utterances of `frames` conditioner frames from a
fresh state: speakers uniform over the configuration's, conditioners and the
call's generator seed drawn from --seed. The window runs whole calls until
`seconds` have passed; audio_s_per_s is the audio of every call over the
wall time of those calls. The check compares, for lanes of every call drawn
from the seed, every generated sample with the plain reference: the
reference's logits along the generated sequence plus the kernel's Gumbel
noise (reference/philox.py, replayed from the call's seed) must put the
generated sample first, up to the widest gap `gap` (and the audio must be
the samples' mu-law values: `bad_audio` counts those that are not).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench import flops, harness, inputs, stats, trace
from h100_bench.reference import philox
from h100_bench.reference import samplernn as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _port_template(cfg):
    from msnv_tpu_torch.models.samplernn import init_params
    return init_params(cfg, device="meta")


class Driver:
    def __init__(self, ctx: harness.Context):
        from msnv_tpu_torch.models.generate import generate_fn
        from msnv_tpu_torch.kernels import sample_window as sw

        self.ctx, self.sw = ctx, sw
        tr, m = ctx.traffic, ctx.model
        self.cfg = harness.model_config(m)
        self.batch, self.frames = tr["batch"], tr["frames"]
        self.samples = self.frames * self.cfg.lookback
        dev = ctx.device
        self.params = inputs.fill_tree(
            _port_template(self.cfg),
            inputs.generator(dev, ctx.seed, "weights"), dev)
        self.gen = generate_fn(self.params, self.cfg,
                               compute_dtype=DTYPES[tr["compute_dtype"]],
                               use_kernel=True,
                               temperature=tr["temperature"])
        self._inputs = inputs.generator(dev, ctx.seed, "calls")
        rng = np.random.default_rng(inputs.derive(ctx.seed, "check"))
        self.check_lanes = torch.as_tensor(np.sort(rng.choice(
            self.batch, tr["check_lanes_per_call"], replace=False)),
            device=dev)
        self.kept = []
        # every shape of the window, once: a short call at the full batch
        self._call(tr["warm_frames"], keep=False)
        self._sync()

    def _sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _call(self, frames, keep=True):
        """One call (inputs made before its clock starts) -> wall s."""
        m, dev = self.ctx.model, self.ctx.device
        cond = inputs.conditioners(
            self._inputs, (self.batch, frames, flops.cond_dim(m)), dev)
        spk = inputs.speakers(self._inputs, self.batch, m["spk_dim"], dev)
        call_seed = int(torch.randint(0, 2 ** 62, (1,),
                                      generator=self._inputs,
                                      device=dev).item())
        g = torch.Generator(device=dev).manual_seed(call_seed)
        self._sync()
        t0 = time.perf_counter()
        audio, seq = self.gen(cond, spk, generator=g)
        self._sync()
        wall = time.perf_counter() - t0
        if keep:
            lanes = self.check_lanes
            self.kept.append({
                "seed": call_seed, "seq": seq[lanes].clone(),
                "audio": audio[lanes].clone(), "cond": cond[lanes].clone(),
                "spk": spk[lanes].clone()})
        return wall

    def window(self, seconds, trace_on):
        walls = []
        t_end = time.perf_counter() + seconds
        launches0 = self.sw.sample_window.launches
        while time.perf_counter() < t_end:
            walls.append(self._call(self.frames))
        n = len(walls)
        wall = sum(walls)
        audio_s = n * self.batch * self.samples / 16000.0
        raw = {"samples": n * self.batch * self.samples, "wall_s": wall,
               "launches": self.sw.sample_window.launches - launches0,
               "window_batch": self.batch,
               "window_dtype": self.ctx.traffic["compute_dtype"]}
        summary = None
        if trace_on:
            l0 = self.sw.sample_window.launches
            _, summary = trace.traced(
                lambda: self._call(self.frames, keep=False), self.ctx.device)
            raw["traced_launches"] = self.sw.sample_window.launches - l0
        return harness.Window({"audio_s_per_s": stats.rate(audio_s, wall)},
                              n, 0, raw, summary)

    def finish(self):
        self.gen = None

    def check(self, control=None) -> dict:
        """The numbers compared; with `control` ("fp8", "tf32") the
        reference in that precision stands in the program's place: at every
        position the sample it puts first is judged."""
        m, dev = self.ctx.model, self.ctx.device
        fs0, q = m["frame_sizes"][0], m["q_levels"]
        gap, bad = 0.0, 0
        for call in self.kept:
            seq = call["seq"]
            ok = (seq >= 0) & (seq < q)
            bad += int((~ok).sum())
            seq = seq.clamp(0, q - 1)
            bad += int((torch.abs(call["audio"] - ref.dequantize(m, seq))
                        > 1e-6).sum())
            logits = ref.generation_logits(m, self.params, seq, call["cond"],
                                           call["spk"])
            pick = None
            if control is not None:
                pick = ref.generation_logits(m, self.params, seq,
                                             call["cond"], call["spk"],
                                             control)
            gap = max(gap, window_gap(logits, seq, call["seed"],
                                      self.check_lanes, fs0, dev, pick))
        return {"gap": gap, "bad_audio": 0 if control else bad}


def window_gap(logits, seq, call_seed, lanes, fs0, device, control=None):
    """The widest gap by which a generated sample's perturbed logit lies
    below the best perturbed logit of its position, for rows `lanes` of a
    call whose window seeds come from a generator seeded with call_seed.
    With `control` (logits of the same positions in a lower precision),
    the gap of the samples those put first instead."""
    B, N, q = logits.shape
    g = torch.Generator(device=device).manual_seed(call_seed)
    seeds = philox.window_seeds(g, N // fs0, device)
    noise = philox.gumbel(seeds, lanes, fs0, q).reshape(B, N, q)
    z = logits + noise
    got = seq if control is None else (control + noise).argmax(dim=-1)
    best = z.max(dim=-1).values
    chosen = torch.gather(z, -1, got[..., None].long())[..., 0]
    return widest(best, chosen)


def widest(best, chosen) -> float:
    """The largest gap between the best perturbed logits and the chosen
    ones. A draw of u = 1 makes a class's noise +inf (the kernel's float32
    rounding of ((bits >> 8) + 0.5) / 2^24), which then must be chosen: an
    equal pair has no gap. A NaN anywhere reads as the largest gap."""
    gaps = torch.where(chosen == best, torch.zeros_like(best), best - chosen)
    if torch.isnan(gaps).any():
        return float("inf")
    return float(gaps.max())
