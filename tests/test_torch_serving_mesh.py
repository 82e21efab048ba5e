"""Serving over a device mesh in the port (VocoderService(mesh=),
StreamMultiplexer(mesh=), `--mesh_data` and the leader/follower channel of
msnv_tpu_torch/parallel/serve.py) on gloo CPU ranks of world 2, 3 and 4,
against the JAX package's sharded service and multiplexer on the virtual
8-device mesh (tests/conftest.py), at the tiny shapes of
tests/test_parallel.py and tests/test_serving_mux.py, inputs made by numpy
from a seed.

The ranks run in processes that tests/torch_parallel.py spawns; JAX runs
here. Tolerances: none. A shard equals a local generate_fn run on its
lanes with its folded generator exactly (the same kernels on the same
tensors), and greedy audio is byte-equal to the JAX service's (greedy
draws nothing; tests/test_torch_serving.py holds the single-device
service to the same bar).
"""

import dataclasses
import http.client
import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from msnv_tpu.config import ExperimentConfig, ModelConfig, make_tag
from msnv_tpu.parallel.mesh import make_mesh as jax_make_mesh
from msnv_tpu.serving import VocoderService as JaxService
from msnv_tpu.training.checkpoint import save_checkpoint as jax_save

import torch_parallel
from torch_parity import both_params, flat_numpy

CFG = ModelConfig(frame_sizes=(2, 2), n_rnn=1, dim=16, cond_dim=3,
                  cond_len=4, spk_dim=3)
C = CFG.effective_cond_dim
FRAMES = 2
IDLE_S, SHORT_TIMEOUT_S = 3.0, 1.0


@pytest.fixture(scope="module")
def params():
    return both_params(CFG, seed=0)


def _spec(params):
    return {"model": dataclasses.asdict(CFG),
            "params": flat_numpy(params[0])}


def _greedy_bodies():
    rng = np.random.RandomState(11)
    return [{"cond": rng.rand(frames, C).tolist(), "spk": spk,
             "temperature": 0.0}
            for frames, spk in ((3, 0), (4, [0.2, 0.5, 0.3]), (6, 2))]


def _stream_bodies():
    rng = np.random.RandomState(12)
    return [{"cond": rng.rand(frames, C).tolist(), "spk": spk}
            for frames, spk in ((3, 0), (4, [0.2, 0.5, 0.3]), (6, 2))]


def _concurrent(fn, bodies):
    out = {}

    def one(i):
        out[i] = fn(dict(bodies[i]))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    return [out[i] for i in range(len(bodies))]


@pytest.fixture(scope="module")
def mesh_runs(params, tmp_path_factory):
    """/synthesize and the multiplexer over a (4, 1) mesh of gloo ranks,
    while the JAX service and multiplexer on a 4-shard virtual mesh serve
    the same greedy requests here."""
    rng = np.random.RandomState(3)
    items = [(rng.rand(FRAMES, C).astype(np.float32), i % CFG.spk_dim,
              i + 1) for i in range(8)]
    spec = dict(_spec(params), items=items, greedy=_greedy_bodies(),
                idle_s=IDLE_S, short_timeout=SHORT_TIMEOUT_S)
    mux_spec = dict(
        _spec(params), lanes=8,
        cond=np.random.RandomState(0).rand(8, 2, C).astype(np.float32),
        active=np.asarray([True, False] * 4),
        body={"cond": np.random.RandomState(1).rand(4, C).tolist(),
              "spk": 1},
        greedy=_stream_bodies())
    synth = torch_parallel.Ranks(
        "job_serving_synth", 4, str(tmp_path_factory.mktemp("synth")),
        spec, timeout=240)
    mux = torch_parallel.Ranks(
        "job_serving_mux", 4, str(tmp_path_factory.mktemp("mux")),
        mux_spec, timeout=240)
    try:
        mesh = jax_make_mesh(n_data=4, n_model=1)
        jsvc = JaxService(params[0], CFG, frame_bucket=1, mesh=mesh)
        jax_wavs = [jsvc.synthesize(dict(b)) for b in _greedy_bodies()]
        jmux = JaxService(params[0], CFG, frames_per_push=2, mux_lanes=8,
                          temperature_default=0.0, mesh=mesh)
        try:
            jax_pcm = _concurrent(lambda b: b"".join(jmux.stream(b)),
                                  _stream_bodies())
        finally:
            jmux.close()
    finally:
        got = synth.results(), mux.results()
    return {"items": items, "jax_wavs": jax_wavs, "jax_pcm": jax_pcm,
            "synth": got[0], "mux": got[1]}


def _folded_seed(items):
    seed = items[0][2]
    for it in items[1:]:
        seed = (seed * 1000003 + it[2]) % (1 << 63)
    return seed


def test_mesh_synthesize_shards_equal_local_runs(mesh_runs):
    """8 items over 4 shards of 2 lanes: each shard's audio equals
    generate_fn on its lanes with fold_generator(seed, data index), exactly
    (the contract of tests/test_parallel.py::test_sharded_serving_
    synthesize). 3 items round up to 4 lanes; /healthz reports 4 shards;
    one request over HTTP."""
    lead = mesh_runs["synth"][0]["lead"]
    assert lead["healthz"]["mesh_shards"] == 4
    group = np.stack(lead["group8"])
    assert group.shape == (8, FRAMES * CFG.lookback)
    for r in mesh_runs["synth"]:
        i = r["data_index"]
        np.testing.assert_array_equal(group[2 * i:2 * i + 2], r["local8"])
    assert len({r["data_index"] for r in mesh_runs["synth"]}) == 4
    assert [o.shape for o in lead["group3"]] == \
        [(FRAMES * CFG.lookback,)] * 3
    status, wav = lead["http"]
    assert status == 200 and len(wav) == 44 + 2 * 3 * CFG.lookback
    # distinct per-request seeds fold into one group seed
    assert _folded_seed(mesh_runs["items"]) != mesh_runs["items"][0][2]


def test_mesh_greedy_synthesize_equals_jax_sharded_service(mesh_runs):
    """Greedy /synthesize through the port's (4, 1) mesh service is
    byte-equal to the JAX service's on a 4-shard virtual mesh."""
    lead = mesh_runs["synth"][0]["lead"]
    assert lead["greedy"] == mesh_runs["jax_wavs"]
    assert lead["http"][1] == mesh_runs["jax_wavs"][0]


def test_idle_spell_longer_than_the_header_timeout(mesh_runs):
    """A service whose header group times out after 1 s idles 3 s, then
    serves a group: the heartbeat kept the followers' header wait alive."""
    after = mesh_runs["synth"][0]["after_idle"]
    assert [o.shape for o in after] == [(FRAMES * CFG.lookback,)] * 2
    assert IDLE_S > 2 * SHORT_TIMEOUT_S


def test_mux_over_mesh_masked_push_freezes_inactive_lanes(mesh_runs):
    """Each rank's carry holds 8 / 4 lanes; a masked push leaves the
    inactive lanes' buffer and hidden state bit-equal and moves the
    active ones (tests/test_serving_mux.py::test_mux_over_mesh_http_
    streams)."""
    for r in mesh_runs["mux"]:
        p = r["push"]
        assert p["local_lanes"] == 2
        assert p["audio"].shape == (2, 2 * CFG.lookback)
        # global lanes 2i (active) and 2i + 1 (inactive) of each rank
        np.testing.assert_array_equal(p["buf1"][1], p["buf0"][1])
        for h0, h1 in zip(p["hs0"], p["hs1"]):
            np.testing.assert_array_equal(h1[:, 1], h0[:, 1])
        assert not np.array_equal(p["buf1"][0], p["buf0"][0])


def test_mux_over_mesh_http_streams(mesh_runs):
    """Four concurrent /stream clients through the mesh-backed pump each
    get their full PCM16; every rank ran each tick."""
    got, health, ticks = mesh_runs["mux"][0]["streams"]
    assert health["mesh_shards"] == 4 and health["mux_lanes"] == 8
    for status, pcm in got:
        assert status == 200 and len(pcm) == 4 * CFG.lookback * 2
    assert ticks >= 2


def test_mux_over_mesh_greedy_streams_equal_jax(mesh_runs):
    """Three concurrent greedy streams (an id and a mix, 3, 4 and 6
    frames) through the port's mux over a (4, 1) mesh are byte-equal to
    the JAX multiplexer's over a 4-shard virtual mesh; every rank ran the
    same ticks."""
    got, _, ticks = mesh_runs["mux"][0]["greedy"]
    assert [s for s, _ in got] == [200] * 3
    assert [pcm for _, pcm in got] == mesh_runs["jax_pcm"]
    assert {r["ticks"] for r in mesh_runs["mux"]} == {ticks}


# --------------------------------------------------------------------------
# the CLI under ranks
# --------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    if body is None:
        c.request("GET", path)
    else:
        c.request("POST", path, json.dumps(body),
                  {"Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, data


def _wait_healthz(port, ranks, deadline_s=180):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if not all(p.is_alive() for p in ranks.procs):
            break
        try:
            return _request(port, "/healthz")
        except OSError:
            time.sleep(0.2)
    raise AssertionError("the serving ranks never answered /healthz")


def _cli_ranks(params, tmp_path_factory, world, fail_rank=None):
    root = tmp_path_factory.mktemp("cli")
    tag = make_tag(ExperimentConfig(exp="t", model=CFG))
    ckpt_dir = root / tag / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    path = str(ckpt_dir / "ep1-it1.npz")
    jax_save(path, {"params": params[0]})
    port = _free_port()
    argv = ["--model", path, "--device", "cpu", "--port", str(port),
            "--frame_bucket", "1", "--mesh_data", str(world)]
    ranks = torch_parallel.Ranks(
        "job_serving_cli", world, str(root),
        {"argv": argv, "fail_rank": fail_rank}, timeout=240)
    return ranks, port


@pytest.fixture(scope="module")
def cli_runs(params, tmp_path_factory):
    """`--mesh_data 2` on two ranks: /healthz and one /synthesize, then
    SIGINT to rank 0."""
    ranks, port = _cli_ranks(params, tmp_path_factory, 2)
    try:
        health = _wait_healthz(port, ranks)
        body = _greedy_bodies()[0]
        synth = _request(port, "/synthesize", body)
    finally:
        os.kill(ranks.procs[0].pid, signal.SIGINT)
        t0 = time.monotonic()
        results = ranks.results()
        wall = time.monotonic() - t0
    want = JaxService(params[0], CFG, frame_bucket=1,
                      mesh=jax_make_mesh(n_data=2, n_model=1)).synthesize(
        dict(body))
    return health, synth, want, results, wall, ranks


def test_cli_mesh_data_serves_on_two_ranks(cli_runs):
    """rank 0 serves HTTP over a (2, 1) mesh: /healthz reports 2 shards,
    a greedy /synthesize is byte-equal to the JAX service's on a 2-shard
    mesh; after SIGINT both ranks return (exit 0) within 30 s."""
    health, synth, want, results, wall, ranks = cli_runs
    assert health[0] == 200 and json.loads(health[1])["mesh_shards"] == 2
    assert synth == (200, want)
    assert all(r["returned"] for r in results)
    assert [p.exitcode for p in ranks.procs] == [0, 0]
    assert wall < 30


def test_cli_mesh_data_must_equal_the_world(cli_runs):
    """--mesh_data 4 on a world of 2: ValueError naming both, on every
    rank, before anything is built."""
    for r in cli_runs[3]:
        assert r["world_error"] == ("--mesh_data 4 serves over 4 "
                                    "processes, but the world has 2")


def test_follower_failure_fails_every_rank(params, tmp_path_factory):
    """Three ranks; rank 1's shard of the first /synthesize raises: the
    request answers 500, and every rank exits non-zero within the
    deadline: rank 1 with its own error, rank 2 (a bystander) and rank 0
    with the mesh's failure. Nothing hangs."""
    ranks, port = _cli_ranks(params, tmp_path_factory, 3, fail_rank=1)
    try:
        _wait_healthz(port, ranks)
        status, data = _request(port, "/synthesize", _greedy_bodies()[0])
    finally:
        t0 = time.monotonic()
        outcomes = ranks.outcomes()
        wall = time.monotonic() - t0
    assert status == 500
    assert "a rank of the serving mesh failed" in json.loads(data)["error"]
    codes = [code for code, _ in outcomes]
    assert codes == [1, 1, 1], outcomes
    errors = [err.strip().splitlines()[-1] for _, err in outcomes]
    assert errors[0] == "RuntimeError: the serving mesh failed"
    assert errors[1] == "RuntimeError: the shard of rank 1 broke"
    assert errors[2].endswith("MeshFailed: a rank of the serving mesh "
                              "failed this operation (its log has the "
                              "traceback)")
    assert wall < 60


def test_service_refuses_a_model_sharded_mesh(tmp_path):
    """Serving shards lanes over 'data' only: a (1, 2) mesh on two ranks
    is refused before anything starts, as are mux lanes that do not divide
    over a (2, 1) one."""
    results = torch_parallel.Ranks(
        "job_serving_refusals", 2, str(tmp_path), dataclasses.asdict(CFG),
        timeout=120).results()
    for r in results:
        assert "serving shards lanes over 'data' only" in r["model_axis"]
        assert r["odd_lanes"] == ("mux lanes 3 must divide by the mesh "
                                  "'data' axis size 2")
