"""One starting state for every replica of the port's mesh
(msnv_tpu_torch.parallel.mesh.broadcast_tree in Trainer(mesh=),
Trainer.warm_start and VocoderService(mesh=), its multiplexer included),
and a seeded init that does not depend on the CPU thread count.

Two gloo CPU ranks (tests/torch_parallel.py's `job_mesh_init`) each draw
their params, and the GAN's discriminator, from a DIFFERENT seed (rank r:
seed r), so only the broadcast can make the replicas equal. The JAX
Trainer runs here from rank 0's draw, carried across under the checkpoint
keys. Tolerances, each with its reason:
  every rank's state against rank 0's draw   bit-equal  one broadcast of
  and the replicas after every step                     rank 0's bits; the
                                                        steps reduce to the
                                                        same bits everywhere
  losses against the JAX Trainer             1e-3       the bound of
                                                        test_torch_parallel
                                                        .py's Trainer test
  params after two steps against the JAX     8e-2       the same test's
  Trainer's                                             bound (a gradient
                                                        near 0 may flip its
                                                        sign, and Adam then
                                                        moves the element
                                                        about lr the other
                                                        way)
  served shards against local runs of        exact      the same kernels
  rank 0's draw                                         on the same tensors
  one seed's orthogonal draw at 1 and 4      bit-equal
  threads
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import ExperimentConfig, ModelConfig, TrainConfig
from msnv_tpu.data.corpus import Corpus
from msnv_tpu.data.loader import ChunkLoader
from msnv_tpu.models.discriminator import discriminator_init as jax_disc_init
from msnv_tpu.models.samplernn import init_params as jax_init_params
from msnv_tpu.training.optim import make_optimizer as jax_make_optimizer
from msnv_tpu.training.trainer import Trainer as JaxTrainer
from msnv_tpu_torch.parallel.mesh import broadcast_tree

import torch_parallel
from torch_parity import corpus_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL, PARAM_ATOL = 1e-3, 8e-2
SHAPES = [(2, 1), (1, 2)]
VARIANTS = {
    "samplernn": (
        ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=32, cond_dim=7,
                    cond_len=16, spk_dim=3),
        TrainConfig(seq_len=64, batch_size=8, learning_rate=2e-3)),
    "gan": (
        ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=24, cond_dim=7,
                    cond_len=16, spk_dim=3, variant="gan", ind_cond_dim=6),
        TrainConfig(seq_len=64, batch_size=8, learning_rate=1e-3,
                    lambda_weight=(0.0, 0.01, 10.0), disc_channels=8)),
}
SERVE_MODEL = ModelConfig(frame_sizes=(2, 2), n_rnn=1, dim=16, cond_dim=3,
                          cond_len=4, spk_dim=3)


def _corpus(variant):
    return corpus_arrays(VARIANTS[variant][0], 8, 64, 2,
                         seed=list(VARIANTS).index(variant))


def _spec():
    trainer = {v: {"model": dataclasses.asdict(m),
                   "train": dataclasses.asdict(t), "corpus": _corpus(v)}
               for v, (m, t) in VARIANTS.items()}
    rng = np.random.RandomState(5)
    c = SERVE_MODEL.effective_cond_dim
    serving = {"model": dataclasses.asdict(SERVE_MODEL),
               "items": [(rng.rand(2, c).astype(np.float32), i % 3, i + 1)
                         for i in range(4)],
               "mux_cond": rng.rand(4, 2, c).astype(np.float32)}
    return {"trainer": trainer, "serving": serving}


def _jax_tree(flat, template, root):
    """A JAX tree shaped like `template` from {checkpoint key: array}
    under `root` ("params" or "disc_params")."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path({root: template})
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat["leaf:" + jax.tree_util.keystr(p)])
        for p, _ in leaves])[root]


def _flat(tree, root):
    leaves, _ = jax.tree_util.tree_flatten_with_path({root: tree})
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x)
            for p, x in leaves}


def _jax_trainer_run(variant, r0):
    """The JAX Trainer (one device) for one epoch of two steps from rank
    0's draw -> (losses, params, discriminator or None)."""
    m, t = VARIANTS[variant]
    loader = ChunkLoader(Corpus(**_corpus(variant)), t.seq_len, m.lookback,
                         m.cond_len, m.q_levels, m.ulaw)
    params = _jax_tree(r0["drawn"],
                       jax_init_params(jax.random.PRNGKey(0), m), "params")
    jt = JaxTrainer(ExperimentConfig(exp="t", model=m, train=t), params,
                    jax_make_optimizer(t, len(loader)), loader)
    if variant == "gan":
        jt.disc_params = _jax_tree(
            r0["disc_drawn"],
            jax_disc_init(jax.random.PRNGKey(0), m.spk_dim,
                          channels=t.disc_channels), "disc_params")
        jt.disc_opt_state = jt.disc_opt.init(jt.disc_params)
    losses = []

    class Capture:
        def register(self, trainer):
            pass

        def iteration(self, loss):
            losses.append(loss)

        def epoch(self, epoch_index):
            pass

    jt.register_plugin(Capture())
    jt.run(1)
    disc = (_flat(jt.disc_params, "disc_params") if variant == "gan"
            else None)
    return losses, _flat(jt.params, "params"), disc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results while the JAX Trainer runs here from rank
    0's draw (which both sides draw from the port's seed 0)."""
    ranks = torch_parallel.Ranks(
        "job_mesh_init", 2, str(tmp_path_factory.mktemp("mesh_init")),
        _spec(), timeout=240)
    got = ranks.results()
    jax_runs = {v: _jax_trainer_run(v, got[0]["trainer"][(v, SHAPES[0])])
                for v in VARIANTS}
    return got, jax_runs


def _equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")


def _differs(a, b):
    return any(not np.array_equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------
# broadcast_tree
# --------------------------------------------------------------------------

def test_broadcast_tree_sends_rank0_bits_in_place_one_buffer_per_dtype(
        runs):
    """Every rank's float32, bf16 and int64 leaves take rank 0's bits in
    their own storage and dtype, a strided view included; one broadcast
    per dtype (two float32 leaves share one)."""
    got, _ = runs
    r0 = got[0]["broadcast"]
    assert any(not np.array_equal(a, b) for a, b in
               zip(r0["before"], got[1]["broadcast"]["before"]))
    for r in got:
        b = r["broadcast"]
        for after, want in zip(b["after"], r0["before"]):
            np.testing.assert_array_equal(after, want)
        assert b["in_place"]
        assert b["dtypes"] == ["torch.float32", "torch.bfloat16",
                               "torch.int64", "torch.float32"]
        assert b["calls"] == ["torch.float32", "torch.bfloat16",
                              "torch.int64"]


def test_broadcast_tree_without_a_process_group_is_untouched():
    tree = {"w": torch.arange(6.0).view(2, 3), "n": [torch.ones(2)]}
    before = tree["w"].clone()
    assert broadcast_tree(tree) is tree
    assert torch.equal(tree["w"], before)


# --------------------------------------------------------------------------
# the Trainer over a mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_trainer_replicas_start_from_rank0_draw(variant, shape, runs):
    """The ranks drew different params (and discriminators); after
    Trainer(mesh=) every rank's full params and discriminator are rank
    0's draw bit for bit."""
    got = [r["trainer"][(variant, shape)] for r in runs[0]]
    assert _differs(got[0]["drawn"], got[1]["drawn"])
    for r in got:
        _equal(r["initial"], got[0]["drawn"], "params")
    if variant == "gan":
        assert _differs(got[0]["disc_drawn"], got[1]["disc_drawn"])
        for r in got:
            _equal(r["disc_initial"], got[0]["disc_drawn"], "discriminator")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_trainer_replicas_after_two_steps_match_jax_trainer(variant, shape,
                                                           runs):
    """Two steps later the replicas are bit-equal and match the JAX
    Trainer run from rank 0's draw."""
    got = [r["trainer"][(variant, shape)] for r in runs[0]]
    losses, params, disc = runs[1][variant]
    assert len(got[0]["losses"]) == len(losses) == 2
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=0,
                               atol=LOSS_ATOL)
    for k, v in params.items():
        np.testing.assert_allclose(got[0]["trained"][k], v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    if disc is not None:
        for k, v in disc.items():
            np.testing.assert_allclose(got[0]["disc_trained"][k], v, rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        _equal(r["trained"], got[0]["trained"], "replica")
        if disc is not None:
            _equal(r["disc_trained"], got[0]["disc_trained"], "replica disc")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_warm_start_takes_rank0_params(variant, shape, runs):
    """warm_start from a different draw on each rank: every rank then holds
    rank 0's, and the replicas stay bit-equal through an epoch."""
    got = [r["trainer"][(variant, shape)] for r in runs[0]]
    assert _differs(got[0]["warm_drawn"], got[1]["warm_drawn"])
    for r in got:
        _equal(r["warm_initial"], got[0]["warm_drawn"], "warm start")
        _equal(r["warm_trained"], got[0]["warm_trained"], "replica")
    assert _differs(got[0]["warm_trained"], got[0]["warm_drawn"])


# --------------------------------------------------------------------------
# serving over a mesh
# --------------------------------------------------------------------------

def test_service_over_two_ranks_serves_rank0_params(runs):
    """VocoderService(mesh=) built from a different draw on each rank holds
    rank 0's params; each shard of a /synthesize group equals a local
    generate_fn run of rank 0's draw on its lanes."""
    got, _ = runs
    assert _differs(got[0]["serving"]["drawn"], got[1]["serving"]["drawn"])
    group = np.stack(got[0]["serving"]["group"])
    assert group.shape == (4, 2 * SERVE_MODEL.lookback)
    for r in got:
        s = r["serving"]
        _equal(s["service_params"], got[0]["serving"]["rank0"], "service")
        i = s["data_index"]
        np.testing.assert_array_equal(group[2 * i:2 * i + 2],
                                      s["local_group"])
    assert {r["serving"]["data_index"] for r in got} == {0, 1}


def test_mux_over_two_ranks_pushes_rank0_params(runs):
    """The multiplexer of that service (mux lanes over the mesh): its push
    of a rank's carry equals a local streaming push of rank 0's draw with
    the mux's generator."""
    for r in runs[0]:
        s = r["serving"]
        assert s["mux_audio"].shape == (2, 2 * SERVE_MODEL.lookback)
        np.testing.assert_array_equal(s["mux_audio"], s["mux_local"])


# --------------------------------------------------------------------------
# a seeded init that does not depend on the CPU thread count
# --------------------------------------------------------------------------

_DRAW = """
import hashlib, sys
import torch
torch.set_num_threads({threads})
from msnv_tpu_torch.ops.linear import orthogonal
w = orthogonal(torch.Generator().manual_seed(0), (1024, 1024))
print(hashlib.sha256(w.numpy().tobytes()).hexdigest(),
      torch.get_num_threads())
"""


def test_orthogonal_draw_ignores_the_cpu_thread_count():
    """One seed's (1024, 1024) orthogonal draw in processes at 1 and at 4
    threads is bit-equal, and the caller's thread count is kept."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = {}
    for threads in (1, 4):
        res = subprocess.run(
            [sys.executable, "-c", _DRAW.format(threads=threads)], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        digest, kept = res.stdout.split()
        assert int(kept) == threads
        out[threads] = digest
    assert out[1] == out[4]
