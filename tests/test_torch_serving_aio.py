"""The port's asyncio HTTP front-end (msnv_tpu_torch.serving.aio) on the
CPU at the tiny shapes of tests/test_serving_aio.py, whose every case is
ported here: one event-loop thread serves every /stream connection, fed by
the mux pump's sinks; the per-connection (seeded) path is byte-identical
across the two front-ends. Plus one case held against the JAX package:
a greedy seed-less stream over the port's asyncio front-end is byte-equal
to the same request over the JAX one.
"""

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from msnv_tpu.config import ModelConfig
from msnv_tpu.serving import VocoderService as JaxService
from msnv_tpu.serving import make_async_server as jax_make_async_server
from msnv_tpu_torch.serving import (AsyncVocoderServer, VocoderService,
                                    make_async_server, make_server)
from torch_parity import both_params, torch_cfg

CFG = ModelConfig(frame_sizes=(2, 2), n_rnn=1, dim=16, cond_dim=3,
                  cond_len=4, spk_dim=3)
TCFG = torch_cfg(CFG)
C = CFG.effective_cond_dim


@pytest.fixture(scope="module")
def params():
    return both_params(CFG, seed=0)


def _post(addr, path, obj, timeout=120):
    c = http.client.HTTPConnection(*addr, timeout=timeout)
    c.request("POST", path, json.dumps(obj),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    body = r.read()
    c.close()
    return r.status, body


@pytest.fixture(scope="module")
def aio_stack(params):
    service = VocoderService(params[1], TCFG, frames_per_push=2,
                             mux_lanes=4, max_streams=2, name="aio-test")
    srv = make_async_server(service, port=0)
    srv.start()
    yield service, srv
    srv.shutdown()
    service.close()


def test_healthz_and_404(aio_stack):
    _service, srv = aio_stack
    assert isinstance(srv, AsyncVocoderServer)
    c = http.client.HTTPConnection(*srv.server_address, timeout=30)
    c.request("GET", "/healthz")
    r = c.getresponse()
    h = json.loads(r.read())
    assert r.status == 200 and h["mux_lanes"] == 4
    assert h["model"] == "aio-test" and h["device"] == "cpu"
    # keep-alive: the same connection serves a second request
    c.request("GET", "/nope")
    assert c.getresponse().status == 404
    c.close()


def test_concurrent_streams_through_mux(aio_stack):
    """N concurrent /stream clients ride the mux through the async
    front-end; each gets its full PCM16 audio (an odd frame count
    exercises the K-pad + trim)."""
    _service, srv = aio_stack
    frames = 5
    rng = np.random.RandomState(1)
    conds = [rng.rand(frames, C).tolist() for _ in range(4)]
    out = {}

    def one(i):
        out[i] = _post(srv.server_address, "/stream",
                       {"cond": conds[i], "spk": i % CFG.spk_dim})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    expected = frames * CFG.lookback * 2
    assert len(out) == 4 and {v[0] for v in out.values()} == {200}, out
    assert all(len(v[1]) == expected for v in out.values()), {
        k: len(v[1]) for k, v in out.items()}


def test_bad_requests(aio_stack):
    _service, srv = aio_stack
    status, body = _post(srv.server_address, "/stream",
                         {"cond": [[0.0, 1.0]], "spk": 0})  # wrong dim
    assert status == 400 and b"cond" in body
    status, _ = _post(srv.server_address, "/stream",
                      {"cond": [[0.0] * C], "spk": 99})
    assert status == 400
    # oversized body -> 413 without reading it
    c = http.client.HTTPConnection(*srv.server_address, timeout=30)
    c.putrequest("POST", "/stream")
    c.putheader("Content-Length", str(100 << 20))
    c.endheaders()
    r = c.getresponse()
    assert r.status == 413
    c.close()
    # malformed Content-Length -> 400, not a silent connection drop
    s = socket.create_connection(srv.server_address, timeout=30)
    s.sendall(b"POST /stream HTTP/1.1\r\nHost: t\r\n"
              b"Content-Length: abc\r\n\r\n")
    resp = s.recv(4096)
    assert b"400" in resp.split(b"\r\n", 1)[0], resp
    s.close()


def test_zero_frame_stream_is_empty_200(aio_stack):
    """A zero-frame request takes no mux lane and answers an immediate
    empty 200, like the threaded path."""
    service, srv = aio_stack
    free_before = len(service._mux._free)
    status, body = _post(srv.server_address, "/stream",
                         {"cond": "", "spk": 0})   # empty base64 = 0 frames
    assert status == 200 and body == b""
    assert len(service._mux._free) == free_before


def test_mux_overload_returns_429(params):
    service = VocoderService(params[1], TCFG, frames_per_push=1,
                             mux_lanes=1, max_streams=0)
    lane = service._mux.acquire(np.asarray([0], np.int32))
    srv = make_async_server(service, port=0)
    srv.start()
    try:
        status, _ = _post(srv.server_address, "/stream",
                          {"cond": [[0.0] * C], "spk": 0}, timeout=30)
        assert status == 429
    finally:
        service._mux.release(lane)
        srv.shutdown()
        service.close()


def _serve_and_fetch(service, make, body):
    srv = make(service, port=0)
    if hasattr(srv, "start"):
        srv.start()
    else:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        return _post(srv.server_address, "/stream", body)
    finally:
        srv.shutdown()
        service.close()


def test_seeded_stream_byte_identical_across_frontends(params):
    """The per-connection path (explicit seed) is deterministic, so the
    async and threaded front-ends give byte-identical chunked audio for the
    same request."""
    rng = np.random.RandomState(3)
    body = {"cond": rng.rand(3, C).tolist(), "spk": 1, "seed": 42}

    def service():
        return VocoderService(params[1], TCFG, frames_per_push=2,
                              mux_lanes=2, max_streams=1)

    s_a, audio_a = _serve_and_fetch(service(), make_async_server, body)
    s_t, audio_t = _serve_and_fetch(service(), make_server, body)
    assert s_a == s_t == 200
    assert audio_a == audio_t and len(audio_a) == 3 * CFG.lookback * 2


def test_synthesize_matches_direct_service_call(aio_stack):
    service, srv = aio_stack
    rng = np.random.RandomState(5)
    body = {"cond": rng.rand(4, C).tolist(), "spk": 2, "seed": 9}
    status, wav_http = _post(srv.server_address, "/synthesize", body)
    assert status == 200
    assert wav_http == service.synthesize(body)


def test_disconnect_mid_stream_releases_lane(params):
    """A client that drops its socket mid-stream must not pin the lane:
    the handler's poll notices the closed transport and releases it."""
    service = VocoderService(params[1], TCFG, frames_per_push=1,
                             mux_lanes=1)
    srv = make_async_server(service, port=0)
    srv.start()
    try:
        # a long request, so the stream is still in flight when we bail
        cond = np.zeros((64, C)).tolist()
        payload = json.dumps({"cond": cond, "spk": 0}).encode()
        s = socket.create_connection(srv.server_address, timeout=30)
        s.sendall(b"POST /stream HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(payload) + payload)
        s.recv(64)          # some response bytes arrived
        s.close()           # drop mid-stream
        # the lane must come free (poll interval 2 s + slack)
        deadline = time.time() + 20
        while time.time() < deadline:
            if len(service._mux._free) == 1:
                break
            time.sleep(0.25)
        assert len(service._mux._free) == 1, "lane leaked on disconnect"
        # and the front-end still serves new streams afterwards
        status, audio = _post(srv.server_address, "/stream",
                              {"cond": [[0.0] * C], "spk": 0})
        assert status == 200 and len(audio) == CFG.lookback * 2
    finally:
        srv.shutdown()
        service.close()


def test_greedy_mux_stream_bytes_equal_jax_frontend(params):
    """Greedy (T = 0) seed-less streams ride each package's multiplexer
    through its asyncio front-end; the chunked PCM is byte-equal."""
    rng = np.random.RandomState(7)
    body = {"cond": rng.rand(5, C).tolist(), "spk": [0.5, 0.25, 0.25]}
    kw = dict(frames_per_push=2, mux_lanes=2, temperature_default=0.0)
    s_j, pcm_j = _serve_and_fetch(JaxService(params[0], CFG, **kw),
                                  jax_make_async_server, body)
    s_t, pcm_t = _serve_and_fetch(VocoderService(params[1], TCFG, **kw),
                                  make_async_server, body)
    assert s_j == s_t == 200
    assert len(pcm_t) == 5 * CFG.lookback * 2 and pcm_t == pcm_j
