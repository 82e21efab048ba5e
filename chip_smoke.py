#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (msnv_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # on a machine with an H100

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. build    — nvcc builds the sample-window kernel and the GRU-layer
                kernels from csrc/ (sm_90a), one nvcc process each, together
  2. kernel   — at the canonical shape (fs0 20, q 256, dim 1024, B 1/32/128):
                given-noise f32 samples equal the plain version exactly
                (TF32 off), bf16 with a sharpened W_o mismatches <= 1 %;
                the Philox mode equals the plain version on the same Philox
                noise (f32 exact, bf16 <= 1 %), passes a chi-square test
                against the softmax and does not depend on the tile;
                kernel / plain times and the bound
  3. generate — full-width `samplernn` from a seeded init: the model stack
                on the card agrees with its teacher-forced predictor and with
                greedy decoding on a small input, then generate_fn with the
                kernel (bf16, B 128, 16 frames, T 1) — audio-seconds/second
  4. serve    — VocoderService + make_server on 127.0.0.1 from a JAX-format
                .npz written here: /healthz, two /synthesize, two /stream
                (the kernel's launch count must rise), one bad body (400)
  5. gru      — the GRU-layer kernels against their plain versions at
                (T, B, H) = (13, 128, 1024), (52, 128, 1024), a ragged
                (5, 3, 1024) and (4, 70, 128), which has a partial second row
                tile and fewer chunks than ring stages: forward (ys, hproj) and the reverse sweep (dxp,
                dhproj, dh0) with float32 products (tolerance 1e-4 of the
                largest reference value: another summation order over
                K = 1024 / 3072, compounded over T steps) and with bfloat16
                products (3e-2: a sum that differs in its last bits can
                round h to the neighbouring bf16 value, and the next steps
                carry that on); the autograd.Function (dx_proj, dw, db, dh0)
                against autograd through the plain forward; a shape the
                kernels cannot take raises; kernel / plain / nn.GRU times
  6. train    — the train step at full width (B 128, seq_len 1040, bf16
                mixed precision, gru_impl="pallas"): one step with reset,
                six without, on one fixed batch; losses finite and falling,
                both GRU kernels launched 4 times per step, params changed,
                carried state detached; ms per step and samples/s; then two
                float32 steps with gru_impl="pallas" against gru_impl="xla"
                from the same weights (cudnn TF32 off: `embed_conv_direct`
                is the only conv and is not on this path)
Then one JSON line of kernel numbers, the card's name and power limit, and
last the {"ok": true, "device": ...} line.

`--rehearse-cpu` runs the same phases on the CPU at dim 32 with the plain
versions (no build, no timing on the card) and ends without the ok line.
`--phases=5,6` runs only the named phases (and then prints no result line).
"""

from __future__ import annotations

import base64
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FS0, Q, DIM = 20, 256, 1024
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
RESULTS = {}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Median per-call device time from CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# --------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# --------------------------------------------------------------------------

def window_bound_ms(table, wh, bh, wo, bo, slots, buf, out, noise=None):
    """Least time for one window call: the larger of (bytes it must move,
    each input read once — only the table rows this run's windows touch —
    over HBM bandwidth) and (its multiply-adds over the peak rate for the
    weight type)."""
    import torch
    batch, fs0 = buf.shape
    q = wo.shape[1]
    dim = table.shape[1]
    seq = torch.cat([buf, out], dim=1).long()
    pos = torch.arange(fs0, device=buf.device)
    rows = torch.stack([pos * q + seq[:, k:k + fs0] for k in range(fs0)])
    distinct = int(torch.unique(rows).numel())
    nbytes = (distinct * dim * table.element_size()
              + wh.numel() * wh.element_size() + wo.numel() * wo.element_size()
              + 4 * (bh.numel() + bo.numel())
              + slots.numel() * slots.element_size() + 4 * buf.numel()
              + 4 * out.numel()
              + (0 if noise is None else 4 * noise.numel()))
    ops = batch * fs0 * (2 * (dim * dim + dim * q) + fs0 * dim)
    peak = PEAK_OPS[str(table.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_inputs(params, batch, dtype, seed):
    import torch
    from msnv_tpu_torch.models.generate import fused_embed_conv
    from msnv_tpu_torch.ops.linear import dense_weight
    dev = params["mlp"]["embedding"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    fused = fused_embed_conv(params["mlp"])
    fs0, q, dim = fused.shape
    table = fused.reshape(fs0 * q, dim).to(dtype).contiguous()
    wh = dense_weight(params["mlp"]["hidden"]).T.to(dtype).contiguous()
    wo = dense_weight(params["mlp"]["out"]).T.to(dtype).contiguous()
    bh = 0.1 * torch.randn(dim, generator=g, device=dev)
    bo = 0.1 * torch.randn(q, generator=g, device=dev)
    slots = torch.randn(batch, fs0, dim, generator=g, device=dev).to(dtype)
    buf = torch.randint(0, q, (batch, fs0), generator=g, device=dev,
                        dtype=torch.int32)
    return table, wh, bh, wo, bo, slots, buf, g


def phase_kernel(params, batches):
    import torch
    from msnv_tpu_torch.kernels import sample_window as sw
    dev = params["mlp"]["embedding"].device
    on_card = dev.type == "cuda"
    max_err = 0
    # given noise, f32: exact equality with the plain version, every tile
    for batch in batches:
        table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
            params, batch, torch.float32, seed=batch)
        noise = sw.gumbel_noise((batch, FS0, Q), g, dev)
        want = sw.sample_window_reference(table, wh, bh, wo, bo, slots, buf,
                                          noise)
        for tile in (sw.TILES if on_card else (None,)):
            got = sw.sample_window(table, wh, bh, wo, bo, slots, buf,
                                   noise=noise, tile=tile)
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(
                    f"f32 kernel != plain at B={batch} tile={tile}: "
                    f"{float((got != want).float().mean()):.4%} differ")
        log(f"[kernel] f32 given-noise B={batch}: equal to the plain "
            f"version at tiles {list(sw.TILES) if on_card else 'cpu'}")
    # bf16, sharpened W_o: mismatch <= 1 %
    for batch in batches:
        table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
            params, batch, torch.bfloat16, seed=100 + batch)
        wo = (wo.float() * 100).to(torch.bfloat16)
        noise = sw.gumbel_noise((batch, FS0, Q), g, dev)
        want = sw.sample_window_reference(table, wh, bh, wo, bo * 100,
                                          slots, buf, noise)
        got = sw.sample_window(table, wh, bh, wo, bo * 100, slots, buf,
                               noise=noise)
        mismatch = float((got != want).float().mean())
        log(f"[kernel] bf16 sharpened B={batch}: mismatch {mismatch:.4%}")
        if mismatch > 0.01:
            raise AssertionError(f"bf16 mismatch {mismatch:.4%} > 1 %")
    # Philox mode (what generation and /stream run) against the plain
    # version on the same Philox noise: f32 exact, bf16 mismatch <= 1 %
    philox = {}
    for dtype in (torch.float32, torch.bfloat16):
        for batch in batches:
            table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
                params, batch, dtype, seed=300 + batch)
            seed = torch.randint(0, 2 ** 62, (1,), generator=g, device=dev,
                                 dtype=torch.int64)
            want = sw.sample_window_reference(
                table, wh, bh, wo, bo, slots, buf,
                sw.philox_gumbel_noise(seed, batch, FS0, Q))
            got = sw.sample_window(table, wh, bh, wo, bo, slots, buf,
                                   seed=seed)
            mismatch = float((got != want).float().mean())
            name = str(dtype).replace("torch.", "")
            philox[f"{name}_B{batch}"] = mismatch
            log(f"[kernel] Philox {name} B={batch}: mismatch vs plain "
                f"{mismatch:.4%}")
            if dtype == torch.float32:
                max_err = max(max_err, int((got - want).abs().max()))
                if mismatch:
                    raise AssertionError("f32 Philox kernel != plain")
            elif mismatch > 0.01:
                raise AssertionError(f"bf16 Philox mismatch {mismatch:.4%}")
    RESULTS["max_abs_err"] = max_err
    RESULTS["philox_mismatch"] = philox
    if not on_card:
        return
    # Philox: chi-square of ~1e5 draws from a fixed logits row
    g = torch.Generator(device=dev).manual_seed(7)
    lanes = 1024
    logits = 0.8 * torch.randn(Q, generator=g, device=dev)
    zeros = dict(table=torch.zeros(FS0 * Q, DIM, device=dev),
                 wh=torch.zeros(DIM, DIM, device=dev),
                 bh=torch.zeros(DIM, device=dev),
                 wo=torch.zeros(DIM, Q, device=dev), bo=logits,
                 slots=torch.zeros(lanes, FS0, DIM, device=dev),
                 buf=torch.zeros(lanes, FS0, dtype=torch.int32, device=dev))
    counts = torch.zeros(Q, dtype=torch.float64, device=dev)
    for s in range(5):
        seed = torch.tensor([1000 + s], dtype=torch.int64, device=dev)
        draws = sw.sample_window(*zeros.values(), seed=seed)
        counts += torch.bincount(draws.flatten().long(), minlength=Q)
    n = float(counts.sum())
    expected = n * torch.softmax(logits.double(), 0)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    dof = Q - 1
    # Wilson-Hilferty: chi2/dof ~ N(1 - 2/(9 dof), 2/(9 dof)); 6 sigma
    limit = dof * (1 - 2 / (9 * dof) + 6 * math.sqrt(2 / (9 * dof))) ** 3
    log(f"[kernel] Philox chi-square over {int(n)} draws: {chi2:.1f} "
        f"(dof {dof}, limit {limit:.1f})")
    if chi2 > limit:
        raise AssertionError(f"Philox draws fail chi-square: {chi2:.1f}")
    seed = torch.tensor([99], dtype=torch.int64, device=dev)
    by_tile = [sw.sample_window(*zeros.values(), seed=seed, tile=tile)
               for tile in sw.TILES]
    if any(not torch.equal(d, by_tile[0]) for d in by_tile[1:]):
        raise AssertionError("Philox draws depend on the tile")
    log("[kernel] Philox draws identical across tiles")

    # times: bf16 Philox mode (what generation and /stream run)
    shapes = []
    for batch in sorted(set(batches) | {1024}):
        table, wh, bh, wo, bo, slots, buf, g = kernel_inputs(
            params, batch, torch.bfloat16, seed=200 + batch)
        seed = torch.tensor([5], dtype=torch.int64, device=dev)
        noise = sw.gumbel_noise((batch, FS0, Q), g, dev)
        out = sw.sample_window(table, wh, bh, wo, bo, slots, buf, seed=seed)
        tiles = {t: cuda_ms(lambda t=t: sw.sample_window(
            table, wh, bh, wo, bo, slots, buf, seed=seed, tile=t), 10)
            for t in sw.TILES}
        ms = cuda_ms(lambda: sw.sample_window(table, wh, bh, wo, bo, slots,
                                              buf, seed=seed), 20)
        plain = cuda_ms(lambda: sw.sample_window_reference(
            table, wh, bh, wo, bo, slots, buf, noise), 5)
        bound, by = window_bound_ms(table, wh, bh, wo, bo, slots, buf, out)
        # the given-noise mode (the TPU's v1 kernel): noise read from memory
        noise_out = sw.sample_window(table, wh, bh, wo, bo, slots, buf,
                                     noise=noise)
        noise_ms = cuda_ms(lambda: sw.sample_window(
            table, wh, bh, wo, bo, slots, buf, noise=noise), 20)
        noise_bound, noise_by = window_bound_ms(table, wh, bh, wo, bo, slots,
                                                buf, noise_out, noise)
        row = {"batch": batch, "dtype": "bfloat16", "mode": "philox",
               "tile": sw.default_tile(batch, dev), "ms": ms,
               "plain_ms": plain, "bound_ms": bound, "bound_by": by,
               "ms_by_tile": tiles, "given_noise_ms": noise_ms,
               "given_noise_bound_ms": noise_bound,
               "given_noise_bound_by": noise_by}
        shapes.append(row)
        log(f"[kernel] B={batch} bf16: kernel {ms:.4f} ms/window "
            f"(tile {row['tile']}; by tile {tiles}), plain {plain:.4f} ms, "
            f"bound {bound:.5f} ms ({by}); given noise {noise_ms:.4f} ms, "
            f"bound {noise_bound:.5f} ms ({noise_by})")
    RESULTS["shapes"] = shapes


# --------------------------------------------------------------------------
# phase 3: full-width generation
# --------------------------------------------------------------------------

def phase_generate(params, cfg, batch, frames):
    import torch
    from msnv_tpu_torch.kernels.sample_window import sample_window
    from msnv_tpu_torch.models.generate import (generate_fn,
                                                teacher_forced_log_probs)
    from msnv_tpu_torch.models.samplernn import (init_tier_state,
                                                 predictor_apply)
    dev = params["mlp"]["embedding"].device
    g = torch.Generator(device=dev).manual_seed(3)
    C = cfg.effective_cond_dim
    # the model stack on this device against its own predictor: the
    # teacher-forced generation machinery equals predictor_apply
    cond = torch.rand(2, 2, C, generator=g, device=dev)
    spk = torch.tensor([0, 5], device=dev)
    forced = torch.randint(0, cfg.q_levels, (2, 2 * cfg.lookback),
                           generator=g, device=dev)
    lp_tf = teacher_forced_log_probs(params, cfg)(cond, spk, forced)
    seed_buf = torch.full((2, cfg.lookback), cfg.q_levels // 2,
                          dtype=forced.dtype, device=dev)
    full = torch.cat([seed_buf, forced], 1)[:, :-1]
    with torch.no_grad():
        lp_pred, _, _ = predictor_apply(
            params, cfg, full, True, cond, spk,
            init_tier_state(cfg, 2, device=dev))
    err = float((lp_tf - lp_pred).abs().max())
    log(f"[generate] teacher-forced vs predictor log-probs: max |diff| "
        f"{err:.2e}")
    if not err < 5e-4:
        raise AssertionError(f"teacher forcing differs by {err}")
    # the kernel path on a sharpened output layer reproduces greedy
    sharp = dict(params, mlp=dict(params["mlp"], out={
        "w": params["mlp"]["out"]["w"] * 1e4,
        "b": params["mlp"]["out"]["b"] * 1e4}))
    _, seq_g = generate_fn(sharp, cfg, temperature=0.0)(cond, spk)
    _, seq_k = generate_fn(sharp, cfg, use_kernel=True)(
        cond, spk, torch.Generator(device=dev).manual_seed(1))
    mismatch = float((seq_k != seq_g).float().mean())
    log(f"[generate] kernel path vs greedy on sharpened logits: mismatch "
        f"{mismatch:.4%}")
    if not mismatch < 0.02:
        raise AssertionError(f"kernel path mismatch {mismatch:.4%}")

    gen = generate_fn(params, cfg, compute_dtype=torch.bfloat16,
                      use_kernel=True, temperature=1.0)
    cond = torch.rand(batch, frames, C, generator=g, device=dev)
    spk = torch.randint(0, cfg.spk_dim, (batch,), generator=g, device=dev)
    gen(cond[:, :1], spk, torch.Generator(device=dev).manual_seed(0))  # warm
    before = sample_window.launches
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio, seq = gen(cond, spk, torch.Generator(device=dev).manual_seed(0))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sample_window.launches - before
    n = batch * frames * cfg.lookback
    if tuple(audio.shape) != (batch, frames * cfg.lookback):
        raise AssertionError(f"audio shape {tuple(audio.shape)}")
    if not (torch.isfinite(audio).all() and audio.abs().max() <= 1.0
            and seq.min() >= 0 and seq.max() < cfg.q_levels):
        raise AssertionError("generated audio out of range")
    if dev.type == "cuda" and launches != frames * cfg.frame_sizes[-1]:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{frames * cfg.frame_sizes[-1]}")
    rate = n / 16000 / wall
    RESULTS["generate"] = {"batch": batch, "frames": frames,
                           "seconds": wall, "audio_s_per_s": rate,
                           "launches": launches}
    log(f"[generate] B={batch} x {frames} frames bf16 kernel path: "
        f"{wall:.3f} s for {n / 16000:.2f} audio-s = {rate:.2f} "
        f"audio-s/s; {launches} kernel launches")


# --------------------------------------------------------------------------
# phase 4: serving over HTTP
# --------------------------------------------------------------------------

def _post(addr, path, body, raw=None):
    import http.client
    c = http.client.HTTPConnection(*addr, timeout=600)
    c.request("POST", path, raw if raw is not None else json.dumps(body),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r, data


def phase_serve(params, exp_cfg, frames_syn, frames_stream):
    import http.client
    import torch
    from msnv_tpu_torch.config import make_tag
    from msnv_tpu_torch.interop import load_npz_params, params_to_numpy
    from msnv_tpu_torch.kernels.sample_window import sample_window
    from msnv_tpu_torch.serving import VocoderService, make_server
    cfg = exp_cfg.model
    dev = params["mlp"]["embedding"].device
    # a JAX-format checkpoint: "leaf:" + keystr paths and a JSON meta
    tag = make_tag(exp_cfg)
    ckpt_dir = os.path.join(REPO, "msnv_tpu_torch", "build", "smoke", tag,
                            "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "ep1-it1.npz")
    arrays = params_to_numpy(params)
    arrays["__meta__"] = np.frombuffer(b"{}", dtype=np.uint8)
    np.savez(path, **arrays)
    loaded = load_npz_params(path, cfg, device=dev)
    if not torch.equal(loaded["mlp"]["conv_in"], params["mlp"]["conv_in"]):
        raise AssertionError("npz round trip changed the weights")
    service = VocoderService(loaded, cfg, frame_bucket=4, name=tag)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address
    rng = np.random.RandomState(0)
    C = cfg.effective_cond_dim
    try:
        sample_window.launches = 0          # the main path starts here
        c = http.client.HTTPConnection(*addr, timeout=60)
        c.request("GET", "/healthz")
        r = c.getresponse()
        health = json.loads(r.read())
        c.close()
        if r.status != 200 or health["status"] != "ok":
            raise AssertionError(f"/healthz {r.status} {health}")
        cond = rng.rand(frames_syn, C).astype(np.float32)
        for body in ({"cond": cond.tolist(), "spk": 2, "seed": 1},
                     {"cond": base64.b64encode(cond.tobytes()).decode(),
                      "spk": 3, "temperature": 0.0}):
            t0 = time.perf_counter()
            r, wav = _post(addr, "/synthesize", body)
            wall = time.perf_counter() - t0
            want = 44 + 2 * frames_syn * cfg.lookback
            if r.status != 200 or len(wav) != want:
                raise AssertionError(f"/synthesize {r.status}, {len(wav)} "
                                     f"bytes, expected {want}")
            log(f"[serve] /synthesize {frames_syn} frames: {wall:.3f} s")
        streams = []
        for i in range(2):
            before = sample_window.launches
            cond = rng.rand(frames_stream, C).astype(np.float32)
            t0 = time.perf_counter()
            r, pcm = _post(addr, "/stream",
                           {"cond": cond.tolist(), "spk": i, "seed": i})
            wall = time.perf_counter() - t0
            want = 2 * frames_stream * cfg.lookback
            rose = sample_window.launches - before
            audio = np.frombuffer(pcm, "<i2")
            if r.status != 200 or len(pcm) != want:
                raise AssertionError(f"/stream {r.status}, {len(pcm)} bytes,"
                                     f" expected {want}")
            if dev.type == "cuda" and rose < 1:
                raise AssertionError("/stream did not launch the kernel")
            if np.all(audio == audio[0]):
                raise AssertionError("/stream returned constant audio")
            rtf = frames_stream * cfg.lookback / 16000 / wall
            streams.append({"frames": frames_stream, "seconds": wall,
                            "realtime_factor": rtf, "launches": rose})
            log(f"[serve] /stream {frames_stream} frames: {wall:.3f} s "
                f"(realtime x{rtf:.2f}), {rose} kernel launches")
        r, _ = _post(addr, "/synthesize", None, raw="{not json")
        if r.status != 400:
            raise AssertionError(f"bad body answered {r.status}")
        r, _ = _post(addr, "/stream", {"cond": [[0.0, 1.0]], "spk": 0})
        if r.status != 400:
            raise AssertionError(f"bad cond answered {r.status}")
        log("[serve] bad bodies answered 400")
        RESULTS["launches"] = sample_window.launches   # main path count
        RESULTS["streams"] = streams
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)



# --------------------------------------------------------------------------
# phase 5: the GRU-layer kernels against their plain versions
# --------------------------------------------------------------------------

GRU_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def gru_bound_ms(T, B, H, mxu_dtype, backward):
    """Least time for one layer sweep: the larger of the bytes it must move
    (each input read once, each output written once) over HBM bandwidth and
    its multiply-adds over the peak rate for the products' type."""
    import torch
    wbytes = 3 * H * H * (2 if mxu_dtype == torch.bfloat16 else 4)
    bh = 4 * B * H
    if backward:   # in x_proj, hproj, ys (h_prev), dy, h0; out dxp, dhproj
        nbytes = T * bh * (3 + 3 + 1 + 1) + bh + wbytes \
            + T * bh * (3 + 3) + bh
    else:          # in x_proj, h0, b_hh; out ys, hproj
        nbytes = T * bh * 3 + bh + 12 * H + wbytes + T * bh * (1 + 3)
    ops = 2 * T * B * H * 3 * H
    peak = PEAK_OPS[str(mxu_dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gru_inputs(T, B, H, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)  # noqa
    return {"x_proj": rn(T, B, 3 * H), "w_hh_t": rn(H, 3 * H) / math.sqrt(H),
            "b_hh": 0.1 * rn(3 * H), "h0": 0.5 * rn(B, H),
            "dy": rn(T, B, H), "dhT": rn(B, H)}


def _rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def phase_gru(dev, shapes):
    import torch
    from msnv_tpu_torch.kernels import gru_layer as gl
    on_card = dev.type == "cuda"
    worst = {"fwd": 0.0, "bwd": 0.0}
    for T, B, H in shapes:
        x = gru_inputs(T, B, H, dev, seed=T * 1000 + B)
        w_hh = x["w_hh_t"].t().contiguous()
        # float32 products (FMA), then bfloat16 ones (tensor cores)
        for mxu in (torch.float32, torch.bfloat16):
            name = str(mxu).replace("torch.", "")
            ys, hproj = gl.gru_layer_forward(
                x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu)
            ys_p, hproj_p = gl.gru_layer_reference(
                x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu)
            ys_eval, none = gl.gru_layer_forward(
                x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu,
                with_residual=False)
            if none is not None or not torch.equal(ys_eval, ys):
                raise AssertionError("forward without residual differs")
            # the reverse sweep on the same saved tensors
            h_prev = torch.cat([x["h0"][None], ys[:-1]], dim=0)
            got = gl.gru_layer_backward(x["x_proj"], hproj, x["h0"], ys,
                                        x["dy"], w_hh, mxu)
            want = gl.gru_layer_backward_reference(
                x["x_proj"], hproj, h_prev, x["dy"], w_hh, mxu)
            if on_card:
                torch.cuda.synchronize()
            e_f = max(_rel_err(ys, ys_p), _rel_err(hproj, hproj_p))
            e_b = max(_rel_err(a, b) for a, b in zip(got, want))
            log(f"[gru] T={T} B={B} H={H} {name}: forward err {e_f:.2e}, "
                f"backward err {e_b:.2e} (tolerance {GRU_TOL[name]:.0e})")
            if not (e_f <= GRU_TOL[name] and e_b <= GRU_TOL[name]):
                raise AssertionError(f"GRU kernel disagrees at T={T} B={B} "
                                     f"{name}: {e_f} / {e_b}")
            if mxu == torch.float32:
                worst["fwd"] = max(worst["fwd"], e_f)
                worst["bwd"] = max(worst["bwd"], e_b)
            else:
                worst["fwd_bf16"] = max(worst.get("fwd_bf16", 0.0), e_f)
                worst["bwd_bf16"] = max(worst.get("bwd_bf16", 0.0), e_b)
        # the autograd.Function against autograd through the plain forward
        leaves = [x[k].clone().requires_grad_(True)
                  for k in ("x_proj", "w_hh_t", "b_hh", "h0")]
        ys, hT = gl.gru_layer(*leaves, torch.float32)
        got = torch.autograd.grad((ys * x["dy"]).sum() + (hT * x["dhT"]).sum(),
                                  leaves)
        ys_p, _ = gl.gru_layer_reference(*leaves, torch.float32)
        want = torch.autograd.grad(
            (ys_p * x["dy"]).sum() + (ys_p[-1] * x["dhT"]).sum(), leaves)
        e_g = max(_rel_err(a, b) for a, b in zip(got, want))
        log(f"[gru] T={T} B={B} H={H}: Function (dx_proj, dw, db, dh0) vs "
            f"autograd of the plain forward, err {e_g:.2e}")
        if not e_g <= GRU_TOL["float32"]:
            raise AssertionError(f"GRU Function gradients differ: {e_g}")
        worst["bwd"] = max(worst["bwd"], e_g)
    RESULTS["gru_err"] = worst
    if not on_card:
        return
    for width, mxu in ((40, torch.float32), (96, torch.bfloat16)):
        bad = gru_inputs(2, 2, width, dev, seed=1)
        try:
            gl.gru_layer_forward(bad["x_proj"], bad["w_hh_t"], bad["b_hh"],
                                 bad["h0"], mxu)
        except ValueError as e:
            log(f"[gru] H={width} raises: {e}")
        else:
            raise AssertionError(f"H={width} did not raise")

    # times at the train step's shapes, bf16 products
    rows = []
    mxu = torch.bfloat16
    for T, B, H in shapes:
        if B != 128:
            continue
        x = gru_inputs(T, B, H, dev, seed=T)
        w_hh = x["w_hh_t"].t().contiguous()
        ys, hproj = gl.gru_layer_forward(x["x_proj"], x["w_hh_t"], x["b_hh"],
                                         x["h0"], mxu)
        h_prev = torch.cat([x["h0"][None], ys[:-1]], dim=0)
        fwd = cuda_ms(lambda: gl.gru_layer_forward(
            x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu), 20)
        bwd = cuda_ms(lambda: gl.gru_layer_backward(
            x["x_proj"], hproj, x["h0"], ys, x["dy"], w_hh, mxu), 20)
        fwd32 = cuda_ms(lambda: gl.gru_layer_forward(
            x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], torch.float32), 10)
        bwd32 = cuda_ms(lambda: gl.gru_layer_backward(
            x["x_proj"], hproj, x["h0"], ys, x["dy"], w_hh, torch.float32),
            10)
        fwd_plain = cuda_ms(lambda: gl.gru_layer_reference(
            x["x_proj"], x["w_hh_t"], x["b_hh"], x["h0"], mxu), 5)
        bwd_plain = cuda_ms(lambda: gl.gru_layer_backward_reference(
            x["x_proj"], hproj, h_prev, x["dy"], w_hh, mxu), 5)
        # the library's yardstick: one nn.GRU layer in bf16, which also does
        # the input projection that gru_layer leaves outside
        rnn = torch.nn.GRU(H, H).to(dev, torch.bfloat16)
        rnn.flatten_parameters()
        inp = torch.randn(T, B, H, device=dev, dtype=torch.bfloat16,
                          requires_grad=True)
        h0 = x["h0"][None].to(torch.bfloat16)
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: rnn(inp, h0), 20)

        def lib_both():
            out, _ = rnn(inp, h0)
            out.backward(x["dy"].to(torch.bfloat16))
        lib_fb = cuda_ms(lib_both, 20)
        b_f, by_f = gru_bound_ms(T, B, H, mxu, backward=False)
        b_b, by_b = gru_bound_ms(T, B, H, mxu, backward=True)
        rows.append({"T": T, "B": B, "H": H, "dtype": "bfloat16",
                     "fwd_ms": fwd, "bwd_ms": bwd, "fwd_f32_ms": fwd32,
                     "bwd_f32_ms": bwd32, "fwd_plain_ms": fwd_plain,
                     "bwd_plain_ms": bwd_plain, "fwd_bound_ms": b_f,
                     "fwd_bound_by": by_f, "bwd_bound_ms": b_b,
                     "bwd_bound_by": by_b, "nn_gru_fwd_ms": lib_fwd,
                     "nn_gru_fwd_bwd_ms": lib_fb})
        log(f"[gru] T={T} B={B} bf16: forward {fwd:.4f} ms ({fwd / T * 1e3:.1f}"
            f" us/step; f32 {fwd32:.4f}), plain "
            f"{fwd_plain:.4f}, bound {b_f:.4f} ({by_f}); backward {bwd:.4f} "
            f"ms (f32 {bwd32:.4f}), "
            f"plain {bwd_plain:.4f}, bound {b_b:.4f} ({by_b}); nn.GRU bf16 "
            f"(with the input projection) forward {lib_fwd:.4f}, forward+"
            f"backward {lib_fb:.4f}")
    RESULTS["gru_shapes"] = rows


# --------------------------------------------------------------------------
# phase 6: the train step at full width
# --------------------------------------------------------------------------

def train_inputs(cfg, batch, seq_len, dev, seed=0):
    """One fixed batch from a numpy seed: uniform sample levels, targets,
    conditioner frames and speaker ids."""
    import torch
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 256, (batch, seq_len + cfg.lookback - 1))
    target = rng.randint(0, 256, (batch, seq_len))
    cond = rng.rand(batch, seq_len // cfg.lookback,
                    cfg.effective_cond_dim).astype(np.float32)
    spk = rng.randint(0, cfg.spk_dim, (batch,))
    return (torch.from_numpy(data.astype(np.int32)).to(dev),
            torch.from_numpy(target.astype(np.int32)).to(dev),
            torch.from_numpy(cond).to(dev),
            torch.from_numpy(spk.astype(np.int64)).to(dev))


def phase_train(exp, dev, batch, seq_len, steps):
    import dataclasses

    import torch
    from msnv_tpu_torch.kernels.gru_layer import (gru_layer_backward,
                                                  gru_layer_forward)
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.optim import make_optimizer
    from msnv_tpu_torch.tree import tree_leaves, tree_map
    from msnv_tpu_torch.training.step import loss_and_grads, make_train_step
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = dataclasses.replace(exp.model, gru_impl="pallas")
    data, target, cond, spk = train_inputs(cfg, batch, seq_len, dev)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    before = [p.clone() for p in tree_leaves(params)]
    optimizer = make_optimizer(exp.train)
    opt_state = optimizer.init(params)
    state = init_tier_state(cfg, batch, device=dev)
    step = make_train_step(cfg, optimizer, compute_dtype=torch.bfloat16)
    gru_layer_forward.launches = 0          # the main path starts here
    gru_layer_backward.launches = 0
    losses, walls = [], []
    for i in range(1 + steps):
        sync()
        t0 = time.perf_counter()
        params, opt_state, state, loss = step(
            params, opt_state, state, data, i == 0, target, cond, spk)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = (gru_layer_forward.launches, gru_layer_backward.launches)
    log(f"[train] bf16 losses (bits): {[round(x, 4) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on the fixed batch")
    per_step = cfg.n_tiers * cfg.n_rnn
    if on_card and launches != (per_step * (1 + steps),) * 2:
        raise AssertionError(f"GRU kernel launches {launches}, expected "
                             f"{per_step} per step each")
    if not any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(params))):
        raise AssertionError("params did not change")
    if any(s.grad_fn is not None or s.requires_grad for s in state):
        raise AssertionError("the carried state is attached to a graph")
    ms = statistics.median(walls[2:]) * 1e3
    rate = batch * seq_len / (ms / 1e3)
    RESULTS["train"] = {"batch": batch, "seq_len": seq_len, "dtype": "bf16",
                        "steps": 1 + steps, "ms_per_step": ms,
                        "samples_per_s": rate, "first_step_ms": walls[0] * 1e3,
                        "losses": losses, "gru_fwd_launches": launches[0],
                        "gru_bwd_launches": launches[1]}
    log(f"[train] B={batch} seq_len={seq_len} bf16 gru_impl=pallas: "
        f"{ms:.3f} ms/step = {rate:.0f} samples/s (median of the last "
        f"{len(walls) - 2} steps; first step {walls[0] * 1e3:.1f} ms); GRU "
        f"kernel launches fwd {launches[0]}, bwd {launches[1]}")

    # float32: the kernel path against the loop path from the same weights,
    # both held against the loop path in float64. Tolerances: losses 1e-4
    # bits; a gradient leaf's error (max |g - g64| over max |g64|) on the
    # kernel path at most 3 times the loop path's worst leaf. A fixed
    # tolerance does not fit: a leaf's gradient is a sum over B * seq_len
    # positions that largely cancel, so float32 sums taken in another order
    # move it by far more than one rounding relative to its own size.
    params0 = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    fresh_state = lambda: init_tier_state(cfg, batch, device=dev)  # noqa
    _, _, g64 = loss_and_grads(
        tree_map(torch.clone, params0),
        dataclasses.replace(cfg, gru_impl="xla"), fresh_state(), data, True,
        target, cond, spk, compute_dtype=torch.float64)
    ref = tree_leaves(g64)
    losses32, errs = {}, {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, gru_impl=impl)
        p = tree_map(torch.clone, params0)
        st = fresh_state()
        _, _, grads = loss_and_grads(p, c, st, data, True, target, cond, spk)
        errs[impl] = max(
            float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for g, r in zip(tree_leaves(grads), ref))
        opt = make_optimizer(exp.train)
        o = opt.init(p)
        f32_step = make_train_step(c, opt)
        losses32[impl] = []
        for i in range(2):
            p, o, st, loss = f32_step(p, o, st, data, i == 0, target, cond,
                                      spk)
            losses32[impl].append(float(loss))
    sync()
    d_loss = max(abs(a - b)
                 for a, b in zip(losses32["pallas"], losses32["xla"]))
    log(f"[train] f32 pallas vs xla: losses {losses32['pallas']} vs "
        f"{losses32['xla']} (max diff {d_loss:.2e}); worst gradient leaf "
        f"against float64: pallas {errs['pallas']:.2e}, xla "
        f"{errs['xla']:.2e}")
    if not d_loss <= 1e-4:
        raise AssertionError(f"f32 losses differ by {d_loss}")
    if not errs["pallas"] <= 3 * errs["xla"] + 1e-7:
        raise AssertionError(f"f32 gradients on the kernel path are off: "
                             f"{errs}")
    RESULTS["train"]["f32_loss_diff"] = d_loss
    RESULTS["train"]["f32_grad_err_vs_f64"] = errs

# --------------------------------------------------------------------------

def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def build_kernels():
    """Phase 1: one nvcc process per source, all started together."""
    from msnv_tpu_torch.kernels import gru_layer, sample_window
    t0 = time.perf_counter()
    errors = []

    def run(mod):
        try:
            mod.build()
        except Exception as e:              # re-raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(m,))
               for m in (sample_window, gru_layer)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    RESULTS["build_s"] = time.perf_counter() - t0
    log(f"[build] sample_window.cu and gru_layer.cu in "
        f"{RESULTS['build_s']:.1f} s")
    for mod in (sample_window, gru_layer):
        for line in mod.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {mod.SOURCE.name}: {line.strip()}")


def kernel_entries():
    main_shape = next(r for r in RESULTS["shapes"] if r["batch"] == 1)
    window = {
        "name": "sample_window",
        "route": "cuda",
        "source": "msnv_tpu_torch/csrc/sample_window.cu",
        "replaces": "msnv_tpu/pallas/sample_kernel.py:157",
        "also_replaces": ["msnv_tpu/pallas/sample_kernel.py:44",
                          "msnv_tpu/pallas/sample_kernel.py:183"],
        "launches": RESULTS["launches"],
        "exact": RESULTS["max_abs_err"] == 0,
        "max_abs_err": RESULTS["max_abs_err"],
        "philox_mismatch": RESULTS["philox_mismatch"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "main_shape": {"batch": 1, "fs0": FS0, "q": Q, "dim": DIM,
                       "dtype": "bfloat16", "mode": "philox"},
        "shapes": RESULTS["shapes"],
    }
    # the GRU kernels at the bottom tier's sweep (T 52), where a train step
    # spends most of its GRU time; one "launch" is one layer sweep
    row = next(r for r in RESULTS["gru_shapes"] if r["T"] == 52)
    shape = {k: row[k] for k in ("T", "B", "H", "dtype")}
    gru = [{
        "name": f"gru_layer_{d}",
        "route": "cuda",
        "source": "msnv_tpu_torch/csrc/gru_layer.cu",
        "replaces": f"msnv_tpu/pallas/gru_kernel.py:{line}",
        "launches": RESULTS["train"][f"gru_{d}_launches"],
        # against the plain version, in the working type of the main path
        # (bf16 products); largest |kernel - plain| over max(1, |plain|)
        "max_abs_err": RESULTS["gru_err"][f"{d}_bf16"],
        "max_abs_err_f32": RESULTS["gru_err"][d],
        "ms": row[f"{d}_ms"],
        "plain_ms": row[f"{d}_plain_ms"],
        "bound_ms": row[f"{d}_bound_ms"],
        "bound_by": row[f"{d}_bound_by"],
        "library_ms": lib,
        "library_note": note,
        "main_shape": shape,
        "shapes": RESULTS["gru_shapes"],
    } for d, line, lib, note in (
        ("fwd", 111, row["nn_gru_fwd_ms"],
         "torch.nn.GRU(1024, 1024) forward in bf16; it also does the input "
         "projection"),
        ("bwd", 167, row["nn_gru_fwd_bwd_ms"] - row["nn_gru_fwd_ms"],
         "torch.nn.GRU forward+backward minus forward, bf16; it also "
         "computes the input projection's and the weights' gradients"))]
    return [window] + gru


def main(argv):
    import torch
    rehearse = "--rehearse-cpu" in argv
    phases = set(range(1, 7))
    for a in argv:
        if a.startswith("--phases="):
            phases = {int(x) for x in a.split("=", 1)[1].split(",")} | {1}
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses

    from msnv_tpu_torch.config import preset
    from msnv_tpu_torch.models.samplernn import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = preset("samplernn")
    if rehearse:
        global DIM
        exp = dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, dim=32))
        DIM = 32
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda")
        log(f"[device] {torch.cuda.get_device_name(0)}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
        build_kernels()
    cfg = exp.model
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)

    def timed(number, name, fn, *args):
        if number not in phases:
            return
        t0 = time.perf_counter()
        fn(*args)
        log(f"[phase] {name} {time.perf_counter() - t0:.1f} s")

    timed(2, "kernel", phase_kernel, params,
          (1, 32, 128) if not rehearse else (1, 4))
    timed(3, "generate", phase_generate, params, cfg,
          128 if not rehearse else 2, 16 if not rehearse else 2)
    timed(4, "serve", phase_serve, params, exp, 4, 8 if not rehearse else 2)
    del params
    timed(5, "gru", phase_gru, dev,
          ((13, 128, DIM), (52, 128, DIM), (5, 3, DIM), (4, 70, 128))
          if not rehearse else ((3, 4, DIM), (5, 8, DIM), (5, 3, DIM)))
    timed(6, "train", phase_train, exp, dev, 128 if not rehearse else 4,
          exp.train.seq_len if not rehearse else 2 * cfg.lookback, 6)
    if rehearse:
        log("rehearsal on the CPU passed (no card: no result line)")
        return 1
    if phases != set(range(1, 7)):
        log(f"phases {sorted(phases)} passed (not all: no result line)")
        return 1

    print(json.dumps({"kernels": kernel_entries(),
                      "generate": RESULTS["generate"],
                      "streams": RESULTS["streams"],
                      "train": RESULTS["train"],
                      "build_s": RESULTS["build_s"]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
