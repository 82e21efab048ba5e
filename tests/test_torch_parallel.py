"""The port's multi-device paths (msnv_tpu_torch/parallel/, `mesh=` in the
steps, the GAN step, the Trainer, the loader, the corpus, the checkpoints
and cli.train) on gloo CPU ranks of world 2 and 4, against the JAX
package's SINGLE-device functions (mesh=None; tests/test_parallel.py shows
that the JAX mesh equals one device) at the tiny shapes of
tests/test_parallel.py, inputs made by numpy from a seed.

The ranks run in processes that tests/torch_parallel.py spawns (torch and
the port only); JAX runs here. Tolerances, each with its reason:
  train / eval / GAN steps, params,     1e-4   the bar of test_parallel.py:
  discriminator and metrics                    float32 sums in another
                                               order (the shard means,
                                               then their mean)
  replicas (every rank's params)        bit-equal   one all-reduce gives
                                                    every rank its bits
  sharded generation and streaming      exact  per shard, against a local
                                               run on its lanes with the
                                               folded generator
  greedy sharded generation             exact  against JAX's greedy
                                               generate_fn
  exposure step, sharded / unsharded    1e-4   the same draws; sums as above
  Trainer and cli.train, two epochs     1e-3 on the first five losses,
                                        5e-2 on all (test_parallel.py's
                                        device-corpus bounds)
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msnv_tpu.config import ModelConfig, TrainConfig
from msnv_tpu.models.discriminator import discriminator_init as jax_disc_init
from msnv_tpu.models.generate import generate_fn as jax_generate_fn
from msnv_tpu.models.samplernn import init_params as jax_init_params
from msnv_tpu.models.samplernn import init_tier_state as jax_init_state
from msnv_tpu.parallel.mesh import make_mesh as jax_make_mesh
from msnv_tpu.parallel.mesh import param_sharding as jax_param_sharding
from msnv_tpu.training.gan import make_gan_train_step as jax_gan_step
from msnv_tpu.training.optim import make_optimizer as jax_make_optimizer
from msnv_tpu.training.step import make_eval_step as jax_eval_step
from msnv_tpu.training.step import make_train_step as jax_train_step

import torch_parallel
from torch_parity import corpus_arrays, flat_numpy

ATOL = 1e-4
STEP_MODEL = ModelConfig(frame_sizes=(4, 4), n_rnn=2, dim=64, cond_dim=7,
                         cond_len=4, spk_dim=3)
STEP_TRAIN = TrainConfig(seq_len=64, batch_size=8, learning_rate=1e-3)
GAN_MODEL = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=24, cond_dim=7,
                        cond_len=4, spk_dim=3, variant="gan", ind_cond_dim=6)
GAN_TRAIN = TrainConfig(seq_len=64, batch_size=8, learning_rate=1e-3,
                        lambda_weight=(0.0, 0.01, 10.0))
GEN_MODEL = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=16, cond_dim=5,
                        spk_dim=2)
EXPO_TRAIN = dataclasses.replace(STEP_TRAIN, ss_prob=0.3,
                                 input_noise_prob=0.2, input_noise_levels=3)
TRAINER_MODEL = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=32, cond_dim=7,
                            cond_len=16, spk_dim=3)
TRAINER_TRAIN = TrainConfig(seq_len=64, batch_size=8, learning_rate=2e-3)
WORLD_2 = {"train": (2, 1), "gan": (2, 1)}
WORLD_4 = {"train": [(4, 1), (2, 2)], "gan": (2, 2)}


def fields(cfg):
    return dataclasses.asdict(cfg)


def batch(cfg, b=8, seq_len=64, seed=0):
    """test_parallel.py's tiny batch from a numpy seed."""
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, 256, (b, seq_len + cfg.lookback - 1)
                                ).astype(np.int32),
            "target": rng.randint(0, 256, (b, seq_len)).astype(np.int32),
            "cond": rng.rand(b, seq_len // cfg.lookback,
                             cfg.cond_dim).astype(np.float32),
            "spk": rng.randint(0, cfg.spk_dim, (b,)).astype(np.int32)}


def jbatch(arrays):
    return tuple(jnp.asarray(arrays[k])
                 for k in ("data", "target", "cond", "spk"))


def disc_flat(disc):
    flat, _ = jax.tree_util.tree_flatten_with_path({"disc_params": disc})
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x)
            for p, x in flat}


def assert_trees_close(got, want, atol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


def assert_replicas_equal(results, key):
    """Every rank's copy of `key` bit-equal to rank 0's."""
    for r in results[1:]:
        for k, v in results[0][key].items():
            np.testing.assert_array_equal(r[key][k], v, err_msg=k)


# --------------------------------------------------------------------------
# JAX single-device references
# --------------------------------------------------------------------------

def jax_train(steps=2):
    params = jax_init_params(jax.random.PRNGKey(0), STEP_MODEL)
    opt = jax_make_optimizer(STEP_TRAIN)
    opt_state = opt.init(params)
    state = jax_init_state(STEP_MODEL, 8)
    data, target, cond, spk = jbatch(batch(STEP_MODEL))
    step = jax_train_step(STEP_MODEL, opt, mesh=None, donate=False)
    p, losses = params, []
    for k in range(steps):
        p, opt_state, state, loss = step(p, opt_state, state, data,
                                         jnp.asarray(k == 0), target, cond,
                                         spk)
        losses.append(float(loss))
    return flat_numpy(params), losses, flat_numpy(p)


def jax_eval(params):
    state = jax_init_state(STEP_MODEL, 8)
    data, target, cond, spk = jbatch(batch(STEP_MODEL))
    step = jax_eval_step(STEP_MODEL)
    losses = []
    for k in range(2):
        loss, state = step(params, state, data, jnp.asarray(k == 0), target,
                           cond, spk)
        losses.append(float(loss))
    return losses


def jax_gan():
    params = jax_init_params(jax.random.PRNGKey(0), GAN_MODEL)
    disc = jax_disc_init(jax.random.PRNGKey(1), GAN_MODEL.spk_dim, channels=8)
    main_opt, disc_opt = (jax_make_optimizer(GAN_TRAIN),
                          jax_make_optimizer(GAN_TRAIN))
    mo, do = main_opt.init(params), disc_opt.init(disc)
    state = jax_init_state(GAN_MODEL, 8)
    data, target, cond, spk = jbatch(batch(GAN_MODEL))
    step = jax_gan_step(GAN_MODEL, GAN_TRAIN, main_opt, disc_opt)
    p, d, metrics = params, disc, []
    for k in range(2):
        p, d, mo, do, state, m = step(p, d, mo, do, state,
                                      jnp.asarray(float(k)), data,
                                      jnp.asarray(k == 0), target, cond, spk)
        metrics.append([float(m[n]) for n in ("loss", "disc_loss",
                                              "lambda")])
    return (flat_numpy(params), disc_flat(disc), metrics, flat_numpy(p),
            disc_flat(d))


def inputs():
    """The ranks' inputs: the JAX package's initial weights as numpy, the
    batches, generation inputs."""
    step0 = flat_numpy(jax_init_params(jax.random.PRNGKey(0), STEP_MODEL))
    gen0 = flat_numpy(jax_init_params(jax.random.PRNGKey(0), GEN_MODEL))
    gan0 = flat_numpy(jax_init_params(jax.random.PRNGKey(0), GAN_MODEL))
    disc0 = disc_flat(jax_disc_init(jax.random.PRNGKey(1), GAN_MODEL.spk_dim,
                                    channels=8))
    rng = np.random.RandomState(0)
    cond = rng.rand(8, 2, GEN_MODEL.cond_dim).astype(np.float32)
    spk = rng.randint(0, GEN_MODEL.spk_dim, (8,)).astype(np.int32)
    rng = np.random.RandomState(3)
    conds = [rng.rand(8, 2, GEN_MODEL.cond_dim).astype(np.float32)
             for _ in range(3)]
    step = {"model": fields(STEP_MODEL), "params": step0,
            "batch": batch(STEP_MODEL)}
    gen = {"model": fields(GEN_MODEL), "params": gen0, "cond": cond,
           "spk": spk, "seed": 7}
    return {
        "train": dict(step, train=fields(STEP_TRAIN)),
        "eval": step,
        "gan": {"model": fields(GAN_MODEL), "train": fields(GAN_TRAIN),
                "params": gan0, "disc": disc0, "channels": 8,
                "batch": batch(GAN_MODEL)},
        "exposure": dict(step, train=fields(EXPO_TRAIN)),
        "specs": dict(step, train=fields(STEP_TRAIN)),
        "generate": gen,
        "greedy": dict(gen, temperature=0.0),
        "stream": {"model": fields(GEN_MODEL), "params": gen0, "spk": spk,
                   "conds": conds, "frames_per_push": 2, "seed": 11},
    }


def jax_specs(params):
    """JAX's param_sharding at n_model 2: the shard dim per key."""
    shardings = jax_param_sharding(jax_make_mesh(n_data=4, n_model=2),
                                   params)
    flat, _ = jax.tree_util.tree_flatten_with_path({"params": shardings})
    out = {}
    for p, s in flat:
        spec = tuple(s.spec)
        out["leaf:" + jax.tree_util.keystr(p)] = (
            spec.index("model") if "model" in spec else None)
    return out


def jax_wants(spec):
    """The JAX package's single-device results on the same inputs."""
    params = jax_init_params(jax.random.PRNGKey(0), STEP_MODEL)
    _, greedy = jax_generate_fn(
        jax_init_params(jax.random.PRNGKey(0), GEN_MODEL), GEN_MODEL,
        temperature=0.0)(jnp.asarray(spec["greedy"]["cond"]),
                         jnp.asarray(spec["greedy"]["spk"]),
                         jax.random.PRNGKey(3))
    _, losses, trained = jax_train()
    return {"train": (losses, trained), "eval": jax_eval(params),
            "gan": jax_gan()[2:], "greedy": np.asarray(greedy),
            "specs": jax_specs(params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of world 2 and 4 run their tasks while JAX computes the
    single-device references here -> (wants, world 2's results, world
    4's)."""
    spec = inputs()
    world2 = torch_parallel.Ranks(
        "job_tasks", 2, str(tmp_path_factory.mktemp("world2")),
        [(f"train{WORLD_2['train']}", "train", WORLD_2["train"],
          spec["train"]),
         ("eval", "eval", (2, 1), spec["eval"]),
         (f"gan{WORLD_2['gan']}", "gan", WORLD_2["gan"], spec["gan"]),
         ("exposure", "exposure", (2, 1), spec["exposure"]),
         ("generate", "generate", (2, 1), spec["generate"]),
         ("greedy", "generate", (2, 1), spec["greedy"]),
         ("stream", "stream", (2, 1), spec["stream"])])
    world4 = torch_parallel.Ranks(
        "job_tasks", 4, str(tmp_path_factory.mktemp("world4")),
        [(f"train{shape}", "train", shape, spec["train"])
         for shape in WORLD_4["train"]]
        + [("eval(2, 2)", "eval", (2, 2), spec["eval"]),
           (f"gan{WORLD_4['gan']}", "gan", WORLD_4["gan"], spec["gan"]),
           ("specs", "specs", (2, 2), spec["specs"]),
           ("generate(2, 2)", "generate", (2, 2), spec["generate"])])
    try:
        wants = jax_wants(spec)
    finally:
        got = world2.results(), world4.results()
    return (wants, *got)


def results(runs, name):
    for res in runs[1:]:
        if name in res[0]:
            return [r[name] for r in res]
    raise KeyError(name)


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
def test_sharded_train_step_matches_jax_single_device(shape, runs):
    losses, trained = runs[0]["train"]
    got = results(runs, f"train{shape}")
    assert got[0]["mesh"] == {"data": shape[0], "model": shape[1]}
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=ATOL)
        assert_trees_close(r["params"], trained, ATOL, f"mesh {shape}")
    assert_replicas_equal(got, "params")
    if shape[1] > 1:
        # storage sharding: a rank stores its slice of the GRU rows (and
        # its Adam moments alike); the model ranks hold different slices
        key = "leaf:['params']['tiers'][0]['gru'][0]['w_hh']"
        assert got[0]["storage"][key].shape[0] == trained[key].shape[0] // 2
        assert not np.array_equal(got[0]["storage"][key],
                                  got[1]["storage"][key])
        assert (3 * 64 // 2, 64) in got[0]["mu_shapes"]


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_sharded_eval_step_matches_jax_single_device(shape, runs):
    name = "eval" if shape == (2, 1) else "eval(2, 2)"
    for r in results(runs, name):
        np.testing.assert_allclose(r["losses"], runs[0]["eval"], rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_sharded_gan_step_matches_jax_single_device(shape, runs):
    metrics, params, disc = runs[0]["gan"]
    got = results(runs, f"gan{shape}")
    for r in got:
        np.testing.assert_allclose(r["metrics"], metrics, rtol=0, atol=ATOL)
        assert_trees_close(r["params"], params, ATOL, "vocoder")
        assert_trees_close(r["disc"], disc, ATOL, "discriminator")
    assert_replicas_equal(got, "params")
    assert_replicas_equal(got, "disc")


def test_sharded_exposure_step_equals_unsharded(runs):
    for r in results(runs, "exposure"):
        np.testing.assert_allclose(r["sharded"]["losses"],
                                   r["single"]["losses"], rtol=0, atol=ATOL)
        assert_trees_close(r["sharded"]["params"], r["single"]["params"],
                           ATOL, "exposure")
        # the input noise draws at the global batch's shape: a rank's
        # lanes are exactly the unsharded draw's
        assert r["noise_equal"] and 0.1 < r["noise_changed"] < 0.3
    assert_replicas_equal([r["sharded"] for r in results(runs, "exposure")],
                          "params")


def test_param_sharding_specs_match_jax(runs):
    want = runs[0]["specs"]
    for r in results(runs, "specs"):
        got = {k: v for k, v in r.items() if k.startswith("leaf:")}
        assert got == want
        assert r["mesh"] == {"data": 2, "model": 2}
    assert 0 in want.values() and 2 in want.values()
    assert want["leaf:['params']['tiers'][0]['h0']"] is None


def test_model_axis_needs_specs(runs):
    """A step over a mesh with a 'model' axis is refused without the
    param_sharding specs that say which leaves the axis shards."""
    for r in results(runs, "specs"):
        assert "needs specs=param_sharding(mesh, params)" in \
            r["no_specs_error"]


# --------------------------------------------------------------------------
# sharded generation and streaming
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["generate", "generate(2, 2)"])
def test_sharded_generation_equals_local_runs_per_shard(name, runs):
    got = results(runs, name)
    n_data = got[0]["mesh"]["data"]
    seq = got[0]["seq"]
    assert seq.shape == (8, 2 * GEN_MODEL.lookback)
    assert got[0]["audio"].shape == seq.shape
    assert seq.min() >= 0 and seq.max() < 256
    per = 8 // n_data
    for r in got:
        np.testing.assert_array_equal(r["seq"], seq)   # every rank: (B, ..)
        np.testing.assert_array_equal(r["seq_dynamic"], seq)
        i = r["data_index"]
        np.testing.assert_array_equal(r["local_seq"],
                                      seq[i * per:(i + 1) * per])
    # independent generators: the shards do not repeat each other
    assert not np.array_equal(seq[:per], seq[per:2 * per])
    assert "must divide by the mesh 'data' axis size" in \
        got[0]["odd_batch_error"]


def test_sharded_greedy_generation_equals_jax(runs):
    for r in results(runs, "greedy"):
        np.testing.assert_array_equal(r["seq"], runs[0]["greedy"])


def test_sharded_streaming_equals_local_streams_per_shard(runs):
    got = results(runs, "stream")
    samples = got[0]["samples"]
    assert samples.shape == (8, 3 * 2 * GEN_MODEL.lookback)
    for r in got:
        np.testing.assert_array_equal(r["samples"], samples)
        i = r["data_index"]
        np.testing.assert_array_equal(r["local"], samples[i * 4:(i + 1) * 4])


# --------------------------------------------------------------------------
# the Trainer over a mesh, against the JAX Trainer on one device
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """Trainer(mesh=) over (2, 1) and (2, 2) on gloo ranks, while the JAX
    Trainer (mesh=None) runs the same two epochs here."""
    from msnv_tpu.config import ExperimentConfig
    from msnv_tpu.data.corpus import Corpus
    from msnv_tpu.data.loader import ChunkLoader
    from msnv_tpu.training.plugins import ValidationPlugin
    from msnv_tpu.training.trainer import Trainer
    m = TRAINER_MODEL
    arrays = corpus_arrays(m, 8, 64, 6, seed=0)
    val_arrays = corpus_arrays(m, 8, 64, 3, seed=9)
    params = jax_init_params(jax.random.PRNGKey(0), m)
    spec = {"model": fields(m), "train": fields(TRAINER_TRAIN),
            "params": flat_numpy(params), "corpus": arrays,
            "val_corpus": val_arrays}
    ranks = {shape: torch_parallel.Ranks(
        "job_trainer", shape[0] * shape[1],
        str(tmp_path_factory.mktemp("trainer")),
        dict(spec, shape=shape, host_path=host_path))
        for shape, host_path in (((2, 1), True), ((2, 2), False))}
    try:
        geo = (64, m.lookback, m.cond_len, m.q_levels, m.ulaw)
        loader = ChunkLoader(Corpus(**arrays), *geo)
        val = ChunkLoader(Corpus(**val_arrays), *geo)
        exp = ExperimentConfig(exp="t", model=m, train=TRAINER_TRAIN)
        jt = Trainer(exp, params,
                     jax_make_optimizer(TRAINER_TRAIN, len(loader)), loader)
        jt.register_plugin(ValidationPlugin(val, val))
        losses, vals = [], []

        class Capture:
            def register(self, trainer):
                pass

            def iteration(self, loss):
                losses.append(loss)

            def epoch(self, epoch_index):
                vals.append(jt.stats["validation_loss"]["last"])

        jt.register_plugin(Capture())
        jt.run(2)
        flat, _ = jax.tree_util.tree_flatten_with_path(jt.checkpoint_state())
        jflat = {"leaf:" + jax.tree_util.keystr(p): np.asarray(x)
                 for p, x in flat}
    finally:
        runs = {shape: r.results() for shape, r in ranks.items()}
    return (losses, vals, jflat), runs


@pytest.mark.parametrize("shape,device_corpus", [((2, 1), True),
                                                 ((2, 1), False),
                                                 ((2, 2), True)])
def test_trainer_over_mesh_matches_jax_trainer(shape, device_corpus,
                                               trainer_runs):
    (losses, vals, jflat), runs = trainer_runs
    got = [r[device_corpus] for r in runs[shape]]
    for r in got:
        assert len(r["losses"]) == len(losses) == 12
        np.testing.assert_allclose(r["losses"][:5], losses[:5], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=5e-2)
        np.testing.assert_allclose(r["val"], vals, rtol=0, atol=2e-2)
        assert r["local_lanes"] == 8 // shape[0]
        # storage sharding over 'model': a rank holds its rows of w_hh
        assert r["w_hh_rows"] == 3 * TRAINER_MODEL.dim // shape[1]
        # checkpoint_state gathers: the full tier state and params, in the
        # JAX trainer's keys and shapes; restore() keeps this rank's part
        assert r["state"].keys() == jflat.keys()
        for k, v in jflat.items():
            assert r["state"][k].shape == v.shape, k
        np.testing.assert_allclose(
            r["state"]["leaf:['params']['mlp']['out']['w']"],
            jflat["leaf:['params']['mlp']['out']['w']"], rtol=0, atol=8e-2)
        assert r["roundtrip_equal"]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        for k, v in got[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v)


# --------------------------------------------------------------------------
# cli.train under two ranks; the corpus build
# --------------------------------------------------------------------------

def _cli_args(data_dir, results_dir, epochs):
    return ["--exp", "meshcli", "--frame_sizes", "4", "4", "--n_rnn", "1",
            "--dim", "32", "--seq_len", "64", "--batch_size", "4",
            "--cond_len", "16", "--norm_ind", "false",
            "--datasets_path", data_dir, "--results_path", results_dir,
            "--epoch_limit", str(epochs), "--learning_rate", "2e-3",
            "--device", "cpu"]


def _exp_dir(results_dir):
    (tag,) = os.listdir(results_dir)
    return os.path.join(results_dir, tag)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """cli.train at world 2 (two epochs, then resumed to three) on a cold
    corpus cache, and the same three epochs in this process."""
    from msnv_tpu_torch.cli.train import main as port_train
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    root = str(tmp_path_factory.mktemp("cli"))
    data_dir = os.path.join(root, "datasets")
    make_synthetic_corpus(data_dir, n_speakers=2, utts_per_speaker=2,
                          frames_per_utt=150, cond_len=16,
                          partitions=("train", "validation", "test"))
    ranks_dir = os.path.join(root, "ranks")
    counts = torch_parallel.Ranks(
        "job_cli", 2, root, _cli_args(data_dir, ranks_dir, 2),
        _cli_args(data_dir, ranks_dir, 3)).results()
    one_dir = os.path.join(root, "one")
    stdout = sys.stdout
    try:
        port_train(_cli_args(data_dir, one_dir, 3))
    finally:
        sys.stdout = stdout
    return data_dir, _exp_dir(ranks_dir), _exp_dir(one_dir), counts


def _stats(exp_dir):
    with open(os.path.join(exp_dir, "stats.json")) as f:
        return json.load(f)


def test_cli_train_two_ranks_writes_once_and_resumes(cli_runs):
    _, ranks, one, (c0, c1) = cli_runs
    # rank 0 writes every checkpoint once and every stats.json; rank 1
    # writes nothing
    assert c0["save"] and len(c0["save"]) == len(set(c0["save"]))
    assert c1["save"] == [] and c1["stats"] == 0
    assert c0["stats"] == 3          # one per epoch, resume included
    assert any(n.startswith("ep3-it") for n in c0["save"])
    ckpts = sorted(os.listdir(os.path.join(ranks, "checkpoints")))
    assert [c for c in ckpts if not c.startswith("best-")] == \
        [n for n in c0["save"] if n.startswith("ep3-")]
    # both ranks resumed from the same file: the epoch-2 checkpoint
    assert c0["load"] == c1["load"] and len(c0["load"]) == 1
    assert c0["load"][0].startswith("ep2-it")
    with open(os.path.join(ranks, "log")) as f:
        log = f.read()
    assert log.count("mesh: {'data': 2, 'model': 1} over 2 devices") == 2
    assert log.count("resumed from") == 1
    # the resumed run's stats.json holds its own epoch: the third of the
    # one-process run's three
    got, want = _stats(ranks), _stats(one)
    assert got["epochs"] == [3] and want["epochs"] == [1, 2, 3]
    n = len(got["training_loss"])
    assert 3 * n == len(want["training_loss"])
    np.testing.assert_allclose(got["training_loss"][:5],
                               want["training_loss"][-n:][:5], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["training_loss"],
                               want["training_loss"][-n:], rtol=0, atol=5e-2)
    for field in ("validation_loss", "test_loss"):
        np.testing.assert_allclose(got[field], want[field][-1:], rtol=0,
                                   atol=5e-2, err_msg=field)


def test_cli_train_two_ranks_checkpoint_loads_in_the_jax_trainer(cli_runs):
    """The last checkpoint of the two-rank run restores into the JAX
    trainer's state layout, every leaf as written."""
    from msnv_tpu.cli.train import build_parser, config_from_args
    from msnv_tpu.training.checkpoint import load_checkpoint
    data_dir, ranks, _, _ = cli_runs
    args = build_parser().parse_args(_cli_args(data_dir, "unused", 3)[:-2])
    cfg = config_from_args(args, spk_dim=2)
    assert cfg.model.dim == 32
    params = jax_init_params(jax.random.PRNGKey(0), cfg.model)
    template = {"params": params,
                "opt_state": jax_make_optimizer(cfg.train).init(params),
                "tier_state": jax_init_state(cfg.model, 4)}
    (last,) = [c for c in os.listdir(os.path.join(ranks, "checkpoints"))
               if c.startswith("ep3-")]
    path = os.path.join(ranks, "checkpoints", last)
    state, meta = load_checkpoint(path, template)
    assert meta["epoch"] == 3
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    with np.load(path) as z:
        for p, x in flat:
            np.testing.assert_array_equal(
                np.asarray(x), z["leaf:" + jax.tree_util.keystr(p)])


def test_cli_train_two_ranks_refuses_a_batch_that_does_not_divide(
        cli_runs):
    """--batch_size 3 over two data ranks: ValueError on both ranks, not
    two ranks each training the whole batch."""
    for c in cli_runs[3]:
        assert "--batch_size 3 does not divide over the mesh's 'data' " \
            "axis of 2 ranks" in c["odd_batch_error"]


def test_resume_point_refuses_ranks_that_see_different_checkpoints(
        cli_runs):
    """Rank 0 sees a checkpoint that rank 1 does not: both ranks raise
    (neither resumes alone, neither waits at a collective)."""
    for c in cli_runs[3]:
        assert "the ranks see different newest checkpoints" in \
            c["unshared_error"]
        assert "rank 0: epoch 1, iteration 4" in c["unshared_error"]


def test_corpus_built_once_under_two_ranks(cli_runs):
    """With a cold cache rank 0 builds each partition once and rank 1
    loads what it wrote; the resumed run builds nothing."""
    _, _, _, (c0, c1) = cli_runs
    assert c0["build"] == ["train", "validation", "test"]
    assert c1["build"] == []
