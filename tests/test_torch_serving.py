"""The port's HTTP service over a real socket: greedy /synthesize WAV bytes
identical to the JAX service's, /stream lengths and exactness, and the
error paths (400/404/413/429), HTTP/1.1 and the CLI (CPU). With a serving
artifact (the cases of the JAX package's tests/test_serving.py), /synthesize
and /stream are byte-identical to the live service's, off-bucket requests
are answered live, and a mismatched artifact is refused at startup."""

import base64
import http.client
import json
import os
import re
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from msnv_tpu.config import ModelConfig
from msnv_tpu.serving import VocoderService as JaxService
from msnv_tpu.serving import make_server as jax_make_server
from msnv_tpu_torch.serving import Overloaded, VocoderService, make_server
from torch_parity import both_params, torch_cfg

CFG = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=24, cond_dim=5,
                  spk_dim=3)
TCFG = torch_cfg(CFG)


@pytest.fixture(scope="module")
def params():
    return both_params(CFG, seed=0)


def _serve(service, **kw):
    srv = make_server(service, port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def server(params):
    srv = _serve(VocoderService(params[1], TCFG, frame_bucket=4,
                                name="test"))
    yield srv.server_address
    srv.shutdown()


def _conn(addr):
    return http.client.HTTPConnection(*addr, timeout=300)


def _post(addr, path, body):
    c = _conn(addr)
    c.request("POST", path, json.dumps(body),
              {"Content-Type": "application/json"})
    return c.getresponse()


def _cond(frames, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(frames, CFG.effective_cond_dim).tolist()


@pytest.mark.parametrize("frames,spk", [(6, 1), (4, [0.2, 0.5, 0.3])])
def test_greedy_synthesize_bytes_equal_jax_service(params, frames, spk):
    body = {"cond": _cond(frames, seed=2), "spk": spk, "temperature": 0.0}
    wavs = []
    for srv in (jax_make_server(JaxService(params[0], CFG, frame_bucket=4),
                                port=0),
                make_server(VocoderService(params[1], TCFG, frame_bucket=4),
                            port=0)):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            r = _post(srv.server_address, "/synthesize", body)
            assert r.status == 200
            assert r.getheader("Content-Type") == "audio/wav"
            wavs.append(r.read())
        finally:
            srv.shutdown()
    assert len(wavs[1]) == 44 + frames * CFG.lookback * 2
    assert wavs[0] == wavs[1]


def test_healthz_and_http11(server):
    c = _conn(server)
    c.request("GET", "/healthz")
    r = c.getresponse()
    assert r.status == 200 and r.version == 11
    h = json.loads(r.read())
    assert h["status"] == "ok" and h["spk_dim"] == 3
    assert h["samples_per_frame"] == CFG.lookback
    assert h["frames_per_push"] == 1 and h["max_batch"] == 1
    assert h["device"] == "cpu"


def test_stream_chunked_matches_frame_count(server):
    frames = 5
    r = _post(server, "/stream", {"cond": _cond(frames), "spk": 0})
    assert r.status == 200
    assert r.getheader("Content-Type").startswith("audio/L16")
    pcm = r.read()
    assert len(pcm) == frames * CFG.lookback * 2
    audio = np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0
    assert np.isfinite(audio).all()


def test_stream_deterministic_same_seed(server):
    body = {"cond": _cond(3), "spk": 2, "seed": 9}
    assert _post(server, "/stream", body).read() == \
        _post(server, "/stream", body).read()


def test_greedy_stream_equals_greedy_synthesize(params):
    """/stream and /synthesize share the generation math: at T = 0 the
    streamed PCM equals the WAV payload."""
    svc = VocoderService(params[1], TCFG, frame_bucket=1)
    body = {"cond": _cond(3, seed=6), "spk": 1, "temperature": 0.0}
    pcm = b"".join(svc.stream(dict(body)))
    assert svc.synthesize(dict(body))[44:] == pcm


def test_error_paths(server):
    r = _post(server, "/synthesize", {"cond": [[0.0] * 3], "spk": 0})
    assert r.status == 400
    assert "cond" in json.loads(r.read())["error"]
    r = _post(server, "/synthesize", {"cond": _cond(2), "spk": 99})
    assert r.status == 400
    c = _conn(server)
    c.request("POST", "/synthesize", "{not json",
              {"Content-Type": "application/json"})
    assert c.getresponse().status == 400
    c = _conn(server)
    c.request("GET", "/nope")
    assert c.getresponse().status == 404
    r = _post(server, "/stream", {"cond": [[0.0, 0.0]], "spk": 0})
    assert r.status == 400


def test_body_size_cap_413(params):
    srv = _serve(VocoderService(params[1], TCFG), max_body=1024)
    try:
        c = _conn(srv.server_address)
        c.putrequest("POST", "/synthesize")
        c.putheader("Content-Type", "application/json")
        c.putheader("Content-Length", str(10 << 20))
        c.endheaders()
        c.send(b"{")
        r = c.getresponse()
        assert r.status == 413
        assert "exceeds cap" in json.loads(r.read())["error"]
        assert r.getheader("Connection") == "close"
    finally:
        srv.shutdown()


def test_stream_cap_429_and_slot_release(params):
    svc = VocoderService(params[1], TCFG, max_streams=1, name="caps")
    body = {"cond": _cond(3), "spk": 0}
    g1 = svc.stream(body)
    next(g1)
    with pytest.raises(Overloaded):
        svc.stream(body)
    with pytest.raises(ValueError):
        svc.stream({"cond": [[0.0]], "spk": 0})
    g1.close()
    g2 = svc.stream(body)
    assert next(g2)
    g2.close()
    srv = _serve(VocoderService(params[1], TCFG, max_streams=0))
    try:
        r = _post(srv.server_address, "/stream", body)
        assert r.status == 429
        assert "concurrent streams" in json.loads(r.read())["error"]
    finally:
        srv.shutdown()


def test_stream_tail_completes_with_multiframe_push(params):
    body = {"cond": _cond(5, seed=4), "spk": 1, "seed": 6}
    pcm_k2 = b"".join(VocoderService(params[1], TCFG,
                                     frames_per_push=2).stream(dict(body)))
    pcm_k1 = b"".join(VocoderService(params[1], TCFG,
                                     frames_per_push=1).stream(dict(body)))
    assert len(pcm_k2) == 5 * CFG.lookback * 2
    assert pcm_k2 == pcm_k1


def test_b64_cond_payload_matches_json(params, server):
    cond = np.random.RandomState(5).rand(
        7, CFG.effective_cond_dim).astype(np.float32)
    b64 = base64.b64encode(cond.tobytes()).decode()
    svc = VocoderService(params[1], TCFG)
    cj = svc._parse({"cond": cond.tolist(), "spk": 1})[0]
    cb = svc._parse({"cond": b64, "spk": 1})[0]
    np.testing.assert_array_equal(cj, cb)
    with pytest.raises(ValueError, match="base64"):
        svc._parse({"cond": "!!!not-base64!!!", "spk": 0})
    with pytest.raises(ValueError, match="whole number"):
        svc._parse({"cond": base64.b64encode(b"\x00" * 6).decode(),
                    "spk": 0})
    outs = [_post(server, "/synthesize",
                  {"cond": field, "spk": 1, "seed": 3}).read()
            for field in (cond.tolist(), b64)]
    assert outs[0] == outs[1]


def test_batcher_coalesces_and_cache_is_bounded(params):
    svc = VocoderService(params[1], TCFG, frame_bucket=4, max_batch=4,
                         linger_ms=150)
    svc.warm(frames=4)
    results = {}

    def call(i):
        results[i] = svc.synthesize({"cond": _cond(4, seed=i),
                                     "spk": i % 3, "seed": i})
    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert len(results) == 6 and all(len(w) > 44 for w in results.values())
    assert sum(svc._batcher.batch_sizes) == 6
    assert max(svc._batcher.batch_sizes) > 1
    for i in range(svc.MAX_CACHED_CALLABLES + 2):
        svc.synthesize({"cond": _cond(4), "spk": 0,
                        "temperature": 0.5 + 0.01 * i})
    assert len(svc._gen_cache) <= svc.MAX_CACHED_CALLABLES


@pytest.mark.parametrize("kw", [{"mux_lanes": 2, "mesh": object()},
                                {"artifact": object()},  # not an artifact
                                {"mesh": object()}, {"frame_bucket": 0},
                                {"frames_per_push": 0}])
def test_service_rejects_unported_and_degenerate_options(params, kw):
    """A mesh that make_mesh did not make is a TypeError (meshes that
    serve: tests/test_torch_serving_mesh.py); the rest ValueError."""
    with pytest.raises(TypeError if "mesh" in kw else ValueError):
        VocoderService(params[1], TCFG, **kw)


def _jax_checkpoint(params, tmp_path):
    """A checkpoint written by the JAX trainer under its results-dir tag."""
    from msnv_tpu.config import ExperimentConfig, make_tag
    from msnv_tpu.training.checkpoint import save_checkpoint
    tag = make_tag(ExperimentConfig(exp="t", model=CFG))
    ckpt_dir = tmp_path / tag / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    path = str(ckpt_dir / "ep1-it1.npz")
    save_checkpoint(path, {"params": params[0]})
    return tag, path


def _cli_healthz(path, *args):
    """Run the serving CLI on the CPU; -> (banner line, /healthz JSON)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "msnv_tpu_torch.serving", "--model", path,
         "--device", "cpu", "--port", "0", *args],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"})
    lines = []
    reader = threading.Thread(
        target=lambda: lines.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout=120)
    try:
        line = lines[0] if lines else ""
        assert line.startswith("serving "), f"no banner, got {line!r}"
        port = int(re.search(r"http://[^:]+:(\d+)", line).group(1))
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", "/healthz")
        return line, json.loads(c.getresponse().read())
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_cli_serves_a_jax_checkpoint(params, tmp_path):
    """`python -m msnv_tpu_torch.serving --device cpu` loads a checkpoint
    written by the JAX trainer (config from the results-dir tag) and
    answers /healthz."""
    tag, path = _jax_checkpoint(params, tmp_path)
    _, h = _cli_healthz(path)
    assert h["model"] == tag and h["spk_dim"] == CFG.spk_dim


@pytest.mark.parametrize("args,frontend", [([], "aio"),
                                           (["--frontend", "threaded"],
                                            "threaded")])
def test_cli_frontends_and_mux_lanes(params, tmp_path, args, frontend):
    """`--frontend` defaults to the asyncio front-end, as in the JAX CLI;
    `--mux_lanes 2` starts the multiplexer behind either front-end."""
    _, path = _jax_checkpoint(params, tmp_path)
    line, h = _cli_healthz(path, "--mux_lanes", "2", *args)
    assert f"{frontend} front-end" in line
    assert h["mux_lanes"] == 2 and h["mesh_shards"] == 1


@pytest.mark.parametrize("args,item", [(["--mesh_data", "2"],
                                        "the world has 1")])
def test_cli_rejects_unported_options(args, item, monkeypatch):
    """--mesh_data 2 in one process (no launcher, no process group): the
    world must equal N (two ranks serve in tests/test_torch_serving_mesh.
    py)."""
    from msnv_tpu_torch.serving.cli import main
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=item):
        main(["--model", "results/t/checkpoints/ep1-it1.npz",
              "--device", "cpu", *args])


def test_service_default_device_is_the_params_device(params):
    svc = VocoderService(params[1], TCFG)
    assert svc.device == torch.device("cpu")
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("dtype", ["pcm16", "float32"])
def test_wav_bytes_match_jax(dtype):
    from msnv_tpu.data import wavio as jwav
    from msnv_tpu_torch.data import wavio as twav
    x = np.sin(np.linspace(0, 20, 400)).astype(np.float32) * 1.2
    assert twav.wav_bytes(x, 16000, dtype) == jwav.wav_bytes(x, 16000, dtype)
    assert twav.pcm16_bytes(x) == jwav.pcm16_bytes(x)


# --------------------------------------------------------------------------
# serving artifacts (msnv_tpu_torch/export.py)
# --------------------------------------------------------------------------

# 4 samples a frame keeps the traced per-sample programs small
ACFG = ModelConfig(frame_sizes=(2, 2), n_rnn=1, dim=16, cond_dim=5,
                   spk_dim=3)
TACFG = torch_cfg(ACFG)


def _acond(frames, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(frames, ACFG.effective_cond_dim).tolist()


@pytest.fixture(scope="module")
def aparams():
    return both_params(ACFG, seed=0)[1]


def test_artifact_backed_synthesize(aparams, tmp_path_factory):
    """A service holding an artifact serves /synthesize from its programs,
    byte-identical WAV to the live service for a bucket-matching request,
    and answers off-bucket shapes live."""
    from msnv_tpu_torch.export import load_artifact, save_artifact
    frames = 4                       # = 2 buckets of frame_bucket=2
    path = str(tmp_path_factory.mktemp("art") / "t.msnvt")
    save_artifact(path, TACFG, [(1, frames)], params=aparams)
    artifact = load_artifact(path)

    def run(service):
        srv = _serve(service)
        try:
            body = {"cond": _acond(frames, seed=5), "spk": 2, "seed": 9}
            r = _post(srv.server_address, "/synthesize", body)
            assert r.status == 200
            wav = r.read()
            # off-bucket (frames=2): the artifact service still answers
            r2 = _post(srv.server_address, "/synthesize",
                       {"cond": _acond(2, seed=5), "spk": 2, "seed": 9})
            assert r2.status == 200
            return wav, r2.read()
        finally:
            srv.shutdown()

    svc_art = VocoderService(aparams, TACFG, frame_bucket=2,
                             artifact=artifact, name="art")
    with_art = run(svc_art)
    assert list(svc_art._gen_cache) == [1.0]     # the off-bucket request
    live = run(VocoderService(aparams, TACFG, frame_bucket=2, name="live"))
    assert with_art == live
    h = svc_art.healthz()
    assert h["artifact_buckets"] == [(1, frames)]
    assert h["artifact_streams"] == []


def test_artifact_mismatch_rejected_at_startup(aparams, tmp_path_factory):
    """An artifact exported from another architecture, or for another
    device type, fails at service construction, not per request."""
    import dataclasses
    from msnv_tpu_torch.export import load_artifact, save_artifact
    path = str(tmp_path_factory.mktemp("art2") / "m.msnvt")
    save_artifact(path, TACFG, [(1, 1)], params=aparams, use_kernel=True)
    art = load_artifact(path)

    other = dataclasses.replace(TACFG, ulaw=not TACFG.ulaw)
    with pytest.raises(ValueError, match="mismatch on \\['ulaw'\\]"):
        VocoderService(aparams, other, artifact=art)

    art.manifest["platforms"] = ["cuda"]
    with pytest.raises(ValueError, match="platforms"):
        VocoderService(aparams, TACFG, artifact=art)

    # engine-choice config fields are numerics-equivalent and not part of
    # the programs: they must not fail validation
    art.manifest["platforms"] = ["cpu"]
    art.manifest["model"]["gru_impl"] = "pallas"
    art.manifest["model"]["mlp_grad_impl"] = "direct"
    VocoderService(aparams, TACFG, artifact=art)   # no raise


def test_artifact_backed_stream(aparams, tmp_path_factory):
    """A service holding stream buckets serves /stream from the programs,
    byte-identical PCM to the live service, and never builds a live
    streaming callable."""
    from msnv_tpu_torch.export import load_artifact, save_artifact
    path = str(tmp_path_factory.mktemp("sart") / "s.msnvt")
    # both the server's frames_per_push (2) and the 1-frame tail bucket
    save_artifact(path, TACFG, [], params=aparams,
                  stream_buckets=[(1, 1), (1, 2)])
    artifact = load_artifact(path)

    def run(service):
        srv = _serve(service)
        try:
            # 5 frames = two 2-pushes + a 1-frame tail
            r = _post(srv.server_address, "/stream",
                      {"cond": _acond(5, seed=8), "spk": 1, "seed": 4})
            assert r.status == 200
            return r.read()
        finally:
            srv.shutdown()

    svc_art = VocoderService(aparams, TACFG, frames_per_push=2,
                             artifact=artifact, name="art")
    pcm_art = run(svc_art)
    assert svc_art._stream_cache == {}, (
        "an artifact-backed /stream must not build live callables")
    svc_live = VocoderService(aparams, TACFG, frames_per_push=2, name="live")
    pcm_live = run(svc_live)
    assert svc_live._stream_cache != {}
    assert pcm_art == pcm_live
    assert len(pcm_art) == 5 * ACFG.lookback * 2   # PCM16


def test_cli_serves_an_artifact_and_refuses_a_mismatched_one(params,
                                                             tmp_path):
    """`--artifact` loads an msnv-export-torch artifact behind the CLI
    (/healthz lists its buckets); one of another model fails at startup."""
    from msnv_tpu_torch.export import save_artifact
    from msnv_tpu_torch.serving.cli import main
    _, path = _jax_checkpoint(params, tmp_path)
    art = str(tmp_path / "a.msnvt")
    save_artifact(art, TCFG, [(1, 2)], params=params[1], use_kernel=True)
    _, h = _cli_healthz(path, "--artifact", art)
    assert h["artifact_buckets"] == [[1, 2]]
    assert h["artifact_streams"] == []
    other = str(tmp_path / "other.msnvt")
    save_artifact(other, TACFG, [(1, 1)], params=both_params(ACFG)[1],
                  use_kernel=True)
    with pytest.raises(ValueError, match="mismatch"):
        main(["--model", path, "--device", "cpu", "--artifact", other])
