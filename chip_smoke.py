#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (msnv_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # on a machine with an H100

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. build    — nvcc builds the sample-window kernel from csrc/ (sm_90a)
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
Then one JSON line of kernel numbers, the card's name and power limit, and
last the {"ok": true, "device": ...} line.

`--rehearse-cpu` runs the same phases on the CPU at dim 32 with the plain
versions (no build, no timing on the card) and ends without the ok line.
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

def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv):
    import torch
    rehearse = "--rehearse-cpu" in argv
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses

    from msnv_tpu_torch.config import preset
    from msnv_tpu_torch.kernels import sample_window as sw
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
        t0 = time.perf_counter()
        sw.build()
        RESULTS["build_s"] = time.perf_counter() - t0
        log(f"[build] sample_window.cu in {RESULTS['build_s']:.1f} s")
        for line in sw.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    cfg = exp.model
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    t0 = time.perf_counter()
    phase_kernel(params, (1, 32, 128) if not rehearse else (1, 4))
    log(f"[phase] kernel {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_generate(params, cfg, 128 if not rehearse else 2,
                   16 if not rehearse else 2)
    log(f"[phase] generate {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_serve(params, exp, 4, 8 if not rehearse else 2)
    log(f"[phase] serve {time.perf_counter() - t0:.1f} s")
    if rehearse:
        log("rehearsal on the CPU passed (no card: no result line)")
        return 1

    main_shape = next(r for r in RESULTS["shapes"] if r["batch"] == 1)
    kernels = [{
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
    }]
    print(json.dumps({"kernels": kernels,
                      "generate": RESULTS["generate"],
                      "streams": RESULTS["streams"],
                      "build_s": RESULTS["build_s"]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
