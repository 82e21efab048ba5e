"""The port's directory checkpoints (`backend="dcp"`: torch.distributed.
checkpoint, training/checkpoint.py), the counterpart of the JAX package's
orbax backend: every case of tests/test_orbax_checkpoint.py (round trip,
load_any's dispatch, the manager's retention and best, mixed formats, a
sharded round trip, a partial template, a trailing slash), a dcp
checkpoint carried through `.npz` into the JAX trainer's state, and
cli.train --ckpt_backend dcp resumed on two ranks.

Sharded cases run on gloo CPU ranks that tests/torch_parallel.py spawns.
Tolerance: none; a checkpoint stores bits.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import ModelConfig, TrainConfig
from msnv_tpu.models.samplernn import init_params as jax_init_params
from msnv_tpu.models.samplernn import init_tier_state as jax_init_state
from msnv_tpu.training import checkpoint as jckpt
from msnv_tpu.training.optim import make_optimizer as jax_make_optimizer
from msnv_tpu_torch.training import checkpoint as tckpt
from msnv_tpu_torch.tree import leaves_with_paths, tree_map

import torch_parallel
from torch_parity import flat_numpy, torch_cfg


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.rand((4, 3), generator=g),
                       "b": torch.rand((3,), generator=g)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _zeros_like(tree):
    return tree_map(lambda x: 0 if isinstance(x, int) else
                    torch.zeros_like(x), tree)


def _assert_equal(got, want):
    got, want = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if torch.is_tensor(v):
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_dcp_round_trip(tmp_path):
    state = _state(1)
    path = str(tmp_path / "ck.dcp")
    tckpt.save_checkpoint_dcp(path, state, {"epoch": 3, "val_loss": 1.5})
    assert not os.path.exists(path + ".tmp")
    out, meta = tckpt.load_checkpoint_dcp(path, _zeros_like(state))
    assert meta == {"epoch": 3, "val_loss": 1.5}
    _assert_equal(out, state)


def test_load_any_dispatches(tmp_path):
    state = _state(2)
    npz, dcp = str(tmp_path / "a.npz"), str(tmp_path / "b.dcp")
    tckpt.save_checkpoint(npz, state, {"k": 1})
    tckpt.save_checkpoint_dcp(dcp, state, {"k": 2})
    _, m1 = tckpt.load_any(npz, _zeros_like(state))
    _, m2 = tckpt.load_any(dcp, _zeros_like(state))
    assert (m1["k"], m2["k"]) == (1, 2)
    assert os.path.isfile(npz) and os.path.isdir(dcp)


def test_manager_dcp_retention_and_best(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), backend="dcp")
    mgr.save_epoch(_state(1), 1, 10, val_loss=2.0)
    mgr.save_epoch(_state(2), 2, 20, val_loss=1.0)
    mgr.save_epoch(_state(3), 3, 30, val_loss=1.5)   # worse: best stays ep2
    path, e, i = mgr.latest()
    assert (e, i) == (3, 30) and path.endswith("ep3-it30.dcp")
    _, be, bi = mgr.best()
    assert (be, bi) == (2, 20)
    # retention: only the newest "last" directory remains
    assert [d for d in os.listdir(str(tmp_path)) if d.startswith("ep")] \
        == ["ep3-it30.dcp"]
    out, meta = tckpt.load_any(path, _zeros_like(_state()))
    assert meta["epoch"] == 3 and int(out["step"]) == 3
    # a fresh manager recovers the best loss from the dcp meta
    assert tckpt.CheckpointManager(str(tmp_path),
                                   backend="dcp").best_loss == 1.0


def test_manager_discovers_mixed_formats(tmp_path):
    npz_mgr = tckpt.CheckpointManager(str(tmp_path), backend="npz",
                                      keep_old=True)
    npz_mgr.save_epoch(_state(1), 1, 10)
    dcp_mgr = tckpt.CheckpointManager(str(tmp_path), backend="dcp",
                                      keep_old=True)
    dcp_mgr.save_epoch(_state(2), 2, 20)
    path, e, _ = dcp_mgr.latest()
    assert e == 2 and path.endswith(".dcp")
    # the npz manager sees the dcp checkpoint as newest too
    path2, e2, _ = npz_mgr.latest()
    assert e2 == 2 and path2.endswith(".dcp")
    assert npz_mgr.resume_point()[1:] == (2, 20)


def test_dcp_partial_template_restore(tmp_path):
    """The generate / evaluate / warm-start path: only {"params": ...} out
    of a full train state, on a device; a missing path raises."""
    full = {"params": _state(3)["params"],
            "opt_state": {"count": 9, "mu": torch.zeros(4, 3),
                          "nu": torch.ones(4, 3)},
            "tier_state": [torch.zeros(2, 3), torch.ones(2, 3)]}
    path = str(tmp_path / "full.dcp")
    tckpt.save_checkpoint_dcp(path, full, {"epoch": 7})
    template = {"params": tree_map(lambda x: torch.empty(x.shape,
                                                         device="meta"),
                                   full["params"])}
    out, meta = tckpt.load_checkpoint_dcp(path, template, device="cpu")
    assert meta["epoch"] == 7 and set(out) == {"params"}
    _assert_equal(out["params"], full["params"])
    with pytest.raises(KeyError, match=r"no entry leaf:\['nope'\]"):
        tckpt.load_checkpoint_dcp(path, {"nope": torch.zeros(())})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_checkpoint_dcp(path, {"params": {"w": torch.zeros(3)}})


def test_dcp_trailing_slash_dispatch(tmp_path):
    """Tab-completed 'dir.dcp/' paths dispatch to the dcp loader."""
    state = _state(4)
    path = str(tmp_path / "ck.dcp")
    tckpt.save_checkpoint_dcp(path, state, {"k": 9})
    out, meta = tckpt.load_any(path + "/", _zeros_like(state))
    assert meta["k"] == 9 and int(out["step"]) == 4


# --------------------------------------------------------------------------
# sharded state; the JAX trainer; cli.train
# --------------------------------------------------------------------------

MODEL = ModelConfig(frame_sizes=(4, 4), n_rnn=2, dim=32, cond_dim=7,
                    cond_len=4, spk_dim=3)
TRAIN = TrainConfig(seq_len=64, batch_size=4)


def _jax_state(seed=0):
    """A JAX train state (params, Adam state, tier state) with random
    moments, counts and hidden state from a numpy seed."""
    rng = np.random.RandomState(seed)
    params = jax_init_params(jax.random.PRNGKey(seed), MODEL)
    state = {"params": params,
             "opt_state": jax_make_optimizer(TRAIN).init(params),
             "tier_state": jax_init_state(MODEL, 4)}
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(x.dtype))
        if x.dtype == jnp.float32 else
        jnp.asarray(np.full(x.shape, 5, x.dtype)), state)


def _spec_from_jax(state):
    flat = flat_numpy(state["params"])
    adam = state["opt_state"][1][0]
    return {"model": dataclasses.asdict(MODEL), "params": flat,
            "mu": flat_numpy(adam.mu), "nu": flat_numpy(adam.nu),
            "count": int(adam.count),
            "tier_state": [np.asarray(s) for s in state["tier_state"]]}


def _jax_flat(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x)
            for p, x in flat}


def _port_template():
    from msnv_tpu_torch.config import TrainConfig as TorchTrainConfig
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.optim import make_optimizer
    cfg = torch_cfg(MODEL)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    return {"params": params,
            "opt_state": make_optimizer(TorchTrainConfig(
                **dataclasses.asdict(TRAIN))).init(params),
            "tier_state": init_tier_state(cfg, 4, device="cpu")}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The state saved from a (1, 2) mesh of gloo ranks and loaded on
    (2, 1) there; -> (JAX state, path, the ranks' results)."""
    state = _jax_state(seed=1)
    path = str(tmp_path_factory.mktemp("sharded") / "ep1-it1.dcp")
    results = torch_parallel.Ranks(
        "job_dcp_sharded", 2, os.path.dirname(path),
        dict(_spec_from_jax(state), path=path), timeout=180).results()
    return state, path, results


def test_dcp_sharded_round_trip(sharded):
    """Saved from (1, 2), each rank writing its 'model' slices (about half
    of the bytes each, no leaf twice); loaded on (2, 1), each rank its
    lanes of the tier state, bit-equal; and in one process, bit-equal to
    the full state."""
    state, path, results = sharded
    for r in results:
        assert r["equal"] and r["meta"] == {"sharded": True}
        assert r["tier_lanes"] == 2
    total = sum(r["written"] for r in results)
    nbytes = sum(x.nbytes for x in _jax_flat(state).values())
    assert nbytes < total < 1.2 * nbytes
    assert all(r["written"] > 0.3 * nbytes for r in results)
    loaded, meta = tckpt.load_any(path, _port_template())
    assert meta == {"sharded": True}
    got = tckpt.flatten_state(loaded)
    want = _jax_flat(state)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_dcp_reaches_the_jax_trainer_through_npz(sharded, tmp_path):
    """A dcp checkpoint, loaded and written as `.npz` by the port, loads in
    msnv_tpu.training.checkpoint.load_checkpoint equal to the JAX state
    it came from, every leaf exactly."""
    state, path, _ = sharded
    loaded, meta = tckpt.load_any(path, _port_template())
    npz = str(tmp_path / "ep1-it1.npz")
    tckpt.save_checkpoint(npz, loaded, meta)
    template = jax.tree_util.tree_map(jnp.zeros_like, state)
    back, back_meta = jckpt.load_checkpoint(npz, template)
    assert back_meta == meta
    got, want = _jax_flat(back), _jax_flat(state)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _cli_args(data_dir, results_dir, epochs):
    return ["--exp", "dcpcli", "--frame_sizes", "4", "4", "--n_rnn", "1",
            "--dim", "32", "--seq_len", "64", "--batch_size", "4",
            "--cond_len", "16", "--norm_ind", "false",
            "--datasets_path", data_dir, "--results_path", results_dir,
            "--epoch_limit", str(epochs), "--learning_rate", "2e-3",
            "--device", "cpu", "--ckpt_backend", "dcp",
            "--n_model_shards", "2"]


def test_cli_train_dcp_resume_equals_a_straight_run(tmp_path):
    """cli.train --ckpt_backend dcp on two ranks over a (1, 2) mesh: one
    epoch, then resumed to two, gives the straight two-epoch run's losses
    and final state bit for bit; each rank wrote its part of every
    checkpoint."""
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    data_dir = str(tmp_path / "datasets")
    make_synthetic_corpus(data_dir, n_speakers=2, utts_per_speaker=2,
                          frames_per_utt=150, cond_len=16,
                          partitions=("train", "validation"))
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    torch_parallel.Ranks(
        "job_cli_dcp", 2, str(tmp_path), _cli_args(data_dir, straight, 2),
        _cli_args(data_dir, resumed, 1), _cli_args(data_dir, resumed, 2),
        timeout=400).results()

    def run(results):
        (tag,) = os.listdir(results)
        exp = os.path.join(results, tag)
        with open(os.path.join(exp, "stats.json")) as f:
            stats = json.load(f)
        ckpts = os.path.join(exp, "checkpoints")
        (last,) = [c for c in os.listdir(ckpts) if c.startswith("ep2-")]
        return stats, os.path.join(ckpts, last)

    (s_stats, s_last), (r_stats, r_last) = run(straight), run(resumed)
    assert r_stats["epochs"] == [2] and s_stats["epochs"] == [1, 2]
    n = len(r_stats["training_loss"])
    assert 2 * n == len(s_stats["training_loss"])
    assert r_stats["training_loss"] == s_stats["training_loss"][-n:]
    assert r_stats["validation_loss"] == s_stats["validation_loss"][-1:]
    assert sorted(os.listdir(r_last)) == [".metadata", "__0_0.distcp",
                                          "__1_0.distcp", "msnv_meta.json"]
    with open(os.path.join(r_last, "msnv_meta.json")) as f:
        assert json.load(f)["epoch"] == 2
    # no leaf written twice: the two files hold about one copy of the
    # state, and each rank wrote its 'model' slices
    template = _cli_template()
    nbytes = sum(x.numel() * x.element_size()
                 for _, x in leaves_with_paths(template)
                 if torch.is_tensor(x))
    sizes = [os.path.getsize(os.path.join(r_last, f"__{r}_0.distcp"))
             for r in (0, 1)]
    assert nbytes < sum(sizes) < 1.2 * nbytes
    assert min(sizes) > 0.2 * nbytes
    a, _ = tckpt.load_any(s_last, template)
    b, _ = tckpt.load_any(r_last, template)
    _assert_equal(b, a)


def _cli_template():
    """The train state of _cli_args's model in one process (2 speakers,
    4 lanes)."""
    from msnv_tpu_torch.cli.train import build_parser, config_from_args
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    from msnv_tpu_torch.training.optim import make_optimizer
    args = build_parser().parse_args(_cli_args("d", "r", 1))
    cfg = config_from_args(args, spk_dim=2)
    params = init_params(cfg.model, torch.Generator().manual_seed(0),
                         device="cpu")
    return {"params": params,
            "opt_state": make_optimizer(cfg.train).init(params),
            "tier_state": init_tier_state(cfg.model, 4, device="cpu")}
