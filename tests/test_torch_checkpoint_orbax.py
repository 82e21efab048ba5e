"""The port's orbax checkpoints (training/checkpoint.py, backend="orbax",
over training/ocdbt.py and training/zstd.py) against the JAX package's
orbax backend, on the CPU.

- Every case of tests/test_orbax_checkpoint.py in the port: round trip,
  load_any's dispatch, the manager's retention and best, mixed formats, a
  partial template, a trailing slash, a sharded round trip (gloo ranks).
- The fixtures that orbax and tensorstore wrote (tests/data/orbax: a JAX
  Trainer's state, the 8-device sharded layout, two processes) load
  bit-equal to their .npz twins and to msnv_tpu's load_checkpoint_orbax;
  a partial template reads its subtree.
- msnv_tpu's load_checkpoint_orbax restores the port's writes bit-equal,
  and the port reads the JAX package's, for every preset the port supports
  (with and without the LR scheduler's state); from one process and from
  two gloo ranks over (2, 1) and (1, 2); msnv_tpu's CheckpointManager
  finds the port's checkpoints as latest and best.
- Greedy audio from an .orbax equals that from the .npz; cli.train
  --ckpt_backend orbax on two ranks, resumed, equals a straight run; the
  evaluate, generate, export and interop CLIs load an .orbax path.
- The new modules import and work with jax, orbax, tensorstore, zstandard
  and msnv_tpu blocked.

Tolerance: none; a checkpoint stores bits.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import preset
from msnv_tpu.models.generate import generate_fn as jax_generate_fn
from msnv_tpu.models.samplernn import init_params as jax_init_params
from msnv_tpu.models.samplernn import init_tier_state as jax_init_state
from msnv_tpu.training import checkpoint as jckpt
from msnv_tpu.training.optim import make_optimizer as jax_make_optimizer
from msnv_tpu.training.trainer import Trainer as JaxTrainer
from msnv_tpu_torch.models.generate import generate_fn
from msnv_tpu_torch.training import checkpoint as tckpt
from msnv_tpu_torch.training.optim import make_optimizer
from msnv_tpu_torch.training.trainer import Trainer
from msnv_tpu_torch.tree import leaves_with_paths, tree_map

import torch_parallel
from test_torch_checkpoint import META, PORTED_PRESETS, _exp, _port_exp
from test_torch_checkpoint_dcp import (_assert_equal, _cli_template,
                                       _jax_flat, _jax_state,
                                       _port_template, _spec_from_jax,
                                       _state, _zeros_like)
from torch_parity import both_loaders, both_params, torch_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "orbax")
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}


def test_orbax_round_trip(tmp_path):
    state = _state(1)
    path = str(tmp_path / "ck.orbax")
    tckpt.save_checkpoint_orbax(path, state, {"epoch": 3, "val_loss": 1.5})
    assert not os.path.exists(path + ".tmp")
    assert sorted(os.listdir(path)) == [
        "_CHECKPOINT_METADATA", "_METADATA", "_sharding", "array_metadatas",
        "d", "manifest.ocdbt", "msnv_meta.json", "ocdbt.process_0"]
    out, meta = tckpt.load_checkpoint_orbax(path, _zeros_like(state))
    assert meta == {"epoch": 3, "val_loss": 1.5}
    _assert_equal(out, state)


def test_load_any_dispatches(tmp_path):
    state = _state(2)
    paths = {k: str(tmp_path / f"a.{k}") for k in ("npz", "dcp", "orbax")}
    tckpt.save_checkpoint(paths["npz"], state, {"k": 1})
    tckpt.save_checkpoint_dcp(paths["dcp"], state, {"k": 2})
    tckpt.save_checkpoint_orbax(paths["orbax"], state, {"k": 3})
    got = [tckpt.load_any(paths[k], _zeros_like(state))[1]["k"]
           for k in ("npz", "dcp", "orbax")]
    assert got == [1, 2, 3]
    assert os.path.isfile(os.path.join(paths["orbax"], "manifest.ocdbt"))


def test_manager_orbax_retention_and_best(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), backend="orbax")
    mgr.save_epoch(_state(1), 1, 10, val_loss=2.0)
    mgr.save_epoch(_state(2), 2, 20, val_loss=1.0)
    mgr.save_epoch(_state(3), 3, 30, val_loss=1.5)   # worse: best stays ep2
    path, e, i = mgr.latest()
    assert (e, i) == (3, 30) and path.endswith("ep3-it30.orbax")
    _, be, bi = mgr.best()
    assert (be, bi) == (2, 20)
    assert [d for d in os.listdir(str(tmp_path)) if d.startswith("ep")] \
        == ["ep3-it30.orbax"]
    out, meta = tckpt.load_any(path, _zeros_like(_state()))
    assert meta["epoch"] == 3 and int(out["step"]) == 3
    assert tckpt.CheckpointManager(str(tmp_path),
                                   backend="orbax").best_loss == 1.0
    # the JAX package's manager finds them: latest, best, its best loss
    jm = jckpt.CheckpointManager(str(tmp_path), backend="orbax")
    assert jm.latest()[1:] == (3, 30) and jm.best()[1:] == (2, 20)
    assert jm._best_loss == 1.0
    back, jmeta = jckpt.load_any(jm.best()[0], jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, jnp.float32 if x.dtype ==
                            torch.float32 else jnp.int32), _state()))
    assert jmeta["val_loss"] == 1.0
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  _state(2)["params"]["w"].numpy())


def test_manager_discovers_mixed_formats(tmp_path):
    mgrs = {b: tckpt.CheckpointManager(str(tmp_path), backend=b,
                                       keep_old=True)
            for b in tckpt.BACKENDS}
    mgrs["npz"].save_epoch(_state(1), 1, 10)
    mgrs["orbax"].save_epoch(_state(2), 2, 20)
    for m in mgrs.values():
        path, e, _ = m.latest()
        assert e == 2 and path.endswith(".orbax")
    mgrs["dcp"].save_epoch(_state(3), 3, 30)
    assert mgrs["orbax"].resume_point()[1:] == (3, 30)
    # the JAX manager writes orbax the port then resumes from
    jckpt.CheckpointManager(str(tmp_path), backend="orbax",
                            keep_old=True).save_epoch(
        {"params": {"w": jnp.ones((4, 3)), "b": jnp.ones(3)},
         "step": jnp.asarray(4, jnp.int32)}, 4, 40)
    path, e, _ = mgrs["npz"].latest()
    assert e == 4 and path.endswith("ep4-it40.orbax")
    out, _ = tckpt.load_any(path, _zeros_like(_state()))
    assert int(out["step"]) == 4 and bool((out["params"]["w"] == 1).all())


def test_orbax_partial_template_restore(tmp_path):
    """The generate / evaluate / warm-start path: only {"params": ...} out
    of a full train state, on a device; a missing path raises KeyError
    and a shape that differs ValueError, as the npz loader's."""
    full = {"params": _state(3)["params"],
            "opt_state": {"count": 9, "mu": torch.zeros(4, 3),
                          "nu": torch.ones(4, 3)},
            "tier_state": [torch.zeros(2, 3), torch.ones(2, 3)]}
    path = str(tmp_path / "full.orbax")
    tckpt.save_checkpoint_orbax(path, full, {"epoch": 7})
    template = {"params": tree_map(
        lambda x: torch.empty(x.shape, device="meta"), full["params"])}
    out, meta = tckpt.load_checkpoint_orbax(path, template, device="cpu")
    assert meta["epoch"] == 7 and set(out) == {"params"}
    _assert_equal(out["params"], full["params"])
    count, _ = tckpt.load_checkpoint_orbax(path, {"opt_state": {"count": 0}})
    assert count["opt_state"]["count"] == 9
    with pytest.raises(KeyError, match=r"no entry leaf:\['nope'\]"):
        tckpt.load_checkpoint_orbax(path, {"nope": torch.zeros(())})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_checkpoint_orbax(path, {"params": {"w": torch.zeros(3)}})


def test_orbax_trailing_slash_dispatch(tmp_path):
    state = _state(4)
    path = str(tmp_path / "ck.orbax")
    tckpt.save_checkpoint_orbax(path, state, {"k": 9})
    out, meta = tckpt.load_any(path + "/", _zeros_like(state))
    assert meta["k"] == 9 and int(out["step"]) == 4


def _saved_values(tmp_path):
    """A one-leaf (4, 3) checkpoint's path and its process database's
    {key: bytes}."""
    from msnv_tpu_torch.training import ocdbt
    state = {"w": torch.arange(12.0).reshape(4, 3)}
    path = str(tmp_path / "ck.orbax")
    tckpt.save_checkpoint_orbax(path, state)
    items = ocdbt.Database(os.path.join(path, "ocdbt.process_0")).items()
    return state, path, {k: ocdbt.value_array(v).tobytes()
                         for k, v in items.items()}


def _rewrite(path, values, **metadata):
    """`path`'s databases rewritten to hold `values`, its _METADATA
    updated with `metadata`."""
    from msnv_tpu_torch.training import ocdbt
    for d in ("ocdbt.process_0", "d"):
        shutil.rmtree(os.path.join(path, d))
    os.remove(os.path.join(path, "manifest.ocdbt"))
    ocdbt.write_database(os.path.join(path, "ocdbt.process_0"), values)
    ocdbt.merge_databases(path, ["ocdbt.process_0"])
    with open(os.path.join(path, "_METADATA")) as f:
        md = json.load(f)
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(dict(md, **metadata), f)


def test_missing_chunk_reads_the_fill_value(tmp_path):
    """Where _METADATA says chunks equal to the fill value were not
    stored, a chunk the store lacks is the zarr array's fill value (null:
    0)."""
    state, path, values = _saved_values(tmp_path)
    del values[b"w/0.0"]
    zarray = json.loads(values[b"w/.zarray"])
    for fill, want in ((None, 0.0), (2.5, 2.5), ("NaN", float("nan"))):
        values[b"w/.zarray"] = json.dumps(dict(zarray, fill_value=fill))\
            .encode()
        _rewrite(path, values, store_array_data_equal_to_fill_value=False)
        out, _ = tckpt.load_checkpoint_orbax(path, state)
        torch.testing.assert_close(out["w"], torch.full((4, 3), want),
                                   rtol=0, atol=0, equal_nan=True)


def test_missing_chunk_raises_where_every_chunk_is_stored(tmp_path):
    """orbax (and the port) write every chunk and say so in _METADATA:
    then a chunk the store lacks is damage and raises."""
    state, path, values = _saved_values(tmp_path)
    with open(os.path.join(path, "_METADATA")) as f:
        assert json.load(f)["store_array_data_equal_to_fill_value"] is True
    del values[b"w/0.0"]
    _rewrite(path, values)
    with pytest.raises(KeyError, match="no chunk w/0.0"):
        tckpt.load_checkpoint_orbax(path, state)


def test_dimension_separator_other_than_dot_raises(tmp_path):
    """A zarr array whose chunk keys use '/' is refused, not read as
    missing chunks."""
    state, path, values = _saved_values(tmp_path)
    zarray = json.loads(values[b"w/.zarray"])
    values[b"w/.zarray"] = json.dumps(
        dict(zarray, dimension_separator="/")).encode()
    values[b"w/0/0"] = values.pop(b"w/0.0")
    _rewrite(path, values, store_array_data_equal_to_fill_value=False)
    with pytest.raises(ValueError, match="dimension separator '/'"):
        tckpt.load_checkpoint_orbax(path, state)


# --------------------------------------------------------------------------
# the committed fixtures: orbax's own writes
# --------------------------------------------------------------------------

def _fixture_meta(name):
    with open(os.path.join(FIXTURES, f"{name}.orbax", "msnv_meta.json")) as f:
        return json.load(f)


def _trainer_configs():
    from msnv_tpu.config import ModelConfig, TrainConfig
    meta = _fixture_meta("trainer")
    model = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in meta["model"].items()})
    train = TrainConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in meta["train"].items()})
    return model, train


def _fixture_templates(name):
    """(port template, JAX template) of a fixture's state."""
    if name != "trainer":
        leaves = _fixture_meta(name)["leaves"]
        return ({k: torch.zeros(v["shape"], dtype=TORCH_DTYPES[v["dtype"]])
                 for k, v in leaves.items()},
                {k: jnp.zeros(v["shape"], getattr(jnp, v["dtype"]))
                 for k, v in leaves.items()})
    from msnv_tpu_torch.config import TrainConfig as TorchTrainConfig
    from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
    model, train = _trainer_configs()
    cfg = torch_cfg(model)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    port = {"params": params,
            "opt_state": make_optimizer(TorchTrainConfig(
                **dataclasses.asdict(train))).init(params),
            "tier_state": init_tier_state(cfg, train.batch_size,
                                          device="cpu")}
    jp = jax_init_params(jax.random.PRNGKey(0), model)
    jt = {"params": jp,
          "opt_state": jax_make_optimizer(train, steps_per_epoch=3).init(jp),
          "tier_state": jax_init_state(model, train.batch_size)}
    return port, jt


def _bits(x):
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if torch.is_tensor(x):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 and \
        x.dtype.kind == "V" or str(x.dtype) == "bfloat16" else x


_TWO_PROCESS_LOAD = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
jax.distributed.initialize(coordinator_address="localhost:{port}",
                           num_processes=2, process_id=pid)
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils
from msnv_tpu.training.checkpoint import load_checkpoint_orbax
with open({template!r}, "rb") as f:
    template = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
state, _ = load_checkpoint_orbax({path!r}, template)
flat, _ = jax.tree_util.tree_flatten_with_path(state)
full = {{"leaf:" + jax.tree_util.keystr(p):
        np.asarray(multihost_utils.process_allgather(v, tiled=True))
        for p, v in flat}}
if pid == 0:
    np.savez({out!r}, **{{k: v.view(np.int16)
                         if v.dtype.itemsize == 2 and v.dtype.kind != "i"
                         else v for k, v in full.items()}})
"""


def _jax_two_process_load(path, template, tmp_path):
    """msnv_tpu's load_checkpoint_orbax of `path` into the JAX `template`
    in two jax.distributed CPU processes of 4 devices each, every leaf
    gathered: {"leaf:" + keystr: array} (bfloat16 as its bits)."""
    import pickle
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tpl = str(tmp_path / "jax_template.pkl")
    with open(tpl, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, template), f)
    out = str(tmp_path / "jax_two_process.npz")
    code = _TWO_PROCESS_LOAD.format(repo=REPO, port=port, path=path,
                                    template=tpl, out=out)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", ["trainer", "sharded", "twoproc"])
def test_fixture_loads_bit_equal_to_npz_and_jax(name, tmp_path):
    port_tpl, jax_tpl = _fixture_templates(name)
    path = os.path.join(FIXTURES, f"{name}.orbax")
    got, meta = tckpt.load_any(path, port_tpl)
    twin, twin_meta = tckpt.load_any(path[:-len(".orbax")] + ".npz",
                                     port_tpl)
    assert meta == twin_meta
    _assert_equal(got, twin)
    if name == "trainer":
        flat = tckpt.flatten_state(got, scheduled=True)
    else:
        flat = {f"leaf:['{k}']": v for k, v in got.items()}
    if name == "twoproc":
        # the JAX package restores it in two processes only: its shards
        # name the devices of both
        want = _jax_two_process_load(path, jax_tpl, tmp_path)
    else:
        jax_state, jax_meta = jckpt.load_checkpoint_orbax(path, jax_tpl)
        assert jax_meta == meta
        want = _jax_flat(jax_state)
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(_bits(flat[k]), _bits(want[k]),
                                      err_msg=k)
    if name == "trainer":
        assert got["opt_state"]["count"] == 3 and meta["iteration"] == 3


@pytest.mark.parametrize("name", ["trainer", "twoproc"])
def test_fixture_partial_template(name):
    port_tpl, _ = _fixture_templates(name)
    path = os.path.join(FIXTURES, f"{name}.orbax")
    full, _ = tckpt.load_any(path, port_tpl)
    part = {"params": port_tpl["params"]} if name == "trainer" else \
        {"w": torch.empty(64, 32, device="meta")}
    got, _ = tckpt.load_any(path, part, device="cpu")
    assert set(got) == set(part)
    _assert_equal(got, {k: full[k] for k in part})


# --------------------------------------------------------------------------
# the port's writes in the JAX package, and the JAX package's in the port
# --------------------------------------------------------------------------

def _trainers(name, scheduler):
    """(port Trainer, JAX Trainer) from the same weights on one corpus."""
    exp = _exp(name)
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, scheduler=scheduler))
    m = exp.model
    tl, jl = both_loaders(m, 2, 2 * m.lookback, 2)
    jp, tp = both_params(m, 0)
    jt = JaxTrainer(exp, jp, jax_make_optimizer(exp.train), jl,
                    device_corpus=False)
    pexp = _port_exp(exp)
    tt = Trainer(pexp, tp, make_optimizer(pexp.train), tl,
                 device_corpus=False)
    return tt, jt


@pytest.mark.parametrize("scheduler", [False, True])
@pytest.mark.parametrize("name", PORTED_PRESETS)
def test_port_orbax_restores_in_jax(name, scheduler, tmp_path):
    tt, jt = _trainers(name, scheduler)
    g = torch.Generator().manual_seed(1)
    state = tree_map(lambda x: 4321 if isinstance(x, int) else
                     torch.randn(x.shape, generator=g),
                     tt.checkpoint_state())
    path = str(tmp_path / "port.orbax")
    tckpt.save_checkpoint_orbax(path, state, META, scheduled=scheduler)
    loaded, meta = jckpt.load_checkpoint_orbax(path, jt.checkpoint_state())
    assert meta == META
    got = _jax_flat(loaded)
    want = tckpt.flatten_state(state, scheduled=scheduler)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(loaded["opt_state"][1][0].count) == 4321
    # the JAX trainer resumes from it
    jt.restore(loaded, meta)
    assert jt.epochs == 7


@pytest.mark.parametrize("scheduler", [False, True])
@pytest.mark.parametrize("name", PORTED_PRESETS)
def test_jax_orbax_loads_in_port(name, scheduler, tmp_path):
    tt, jt = _trainers(name, scheduler)
    rng = np.random.RandomState(2)
    state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(x.dtype)
                              if x.dtype == jnp.float32 else
                              np.asarray(77, x.dtype).reshape(x.shape)),
        jt.checkpoint_state())
    path = str(tmp_path / "jax.orbax")
    jckpt.save_checkpoint_orbax(path, state, META)
    loaded, meta = tckpt.load_any(path, tt.checkpoint_state())
    assert meta == META and loaded["opt_state"]["count"] == 77
    got, want = tckpt.flatten_state(loaded, scheduler), _jax_flat(state)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tt.restore(loaded, meta)
    assert tt.epochs == 7 and tt.iterations == 123 and tt.start_chunk == 5


# --------------------------------------------------------------------------
# two gloo ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[((1, 2), (2, 1)), ((2, 1), (1, 2))],
                ids=["save_1x2_load_2x1", "save_2x1_load_1x2"])
def sharded(request, tmp_path_factory):
    """The state saved as orbax by two gloo ranks over one mesh and loaded
    on the other there; -> (JAX state, path, the ranks' results, meshes)."""
    save, load = request.param
    state = _jax_state(seed=3)
    path = str(tmp_path_factory.mktemp("orbax_sharded") / "ep1-it1.orbax")
    results = torch_parallel.Ranks(
        "job_orbax_sharded", 2, os.path.dirname(path),
        dict(_spec_from_jax(state), path=path, save=save, load=load,
             scheduled=False), timeout=180).results()
    return state, path, results, save


def test_orbax_sharded_round_trip(sharded):
    """Each rank wrote the chunks it stores into its own database and no
    leaf was written twice: over (1, 2) rank 1 its half of every
    'model'-sharded param and moment, over (2, 1) its lanes of the tier
    state (rank 0 the rest). Loaded on the other mesh, bit-equal on every
    rank; in one process, bit-equal to the full state."""
    import types
    from msnv_tpu_torch.parallel.mesh import param_sharding
    state, path, results, save = sharded
    for r in results:
        assert r["equal"] and r["meta"] == {"sharded": True}
    want = _jax_flat(state)
    nbytes = sum(x.nbytes for x in want.values())
    total = sum(r["written"] for r in results)
    assert nbytes < total < 1.05 * nbytes
    if save == (1, 2):
        params = _port_template()["params"]
        specs = dict(leaves_with_paths(param_sharding(
            types.SimpleNamespace(shape={"model": 2}), params)))
        mine = 3 * sum(x.numel() * x.element_size() // 2
                       for p, x in leaves_with_paths(params)
                       if specs[p] is not None)   # params, mu, nu
    else:
        mine = sum(np.asarray(s).nbytes // 2 for s in state["tier_state"])
    assert mine < results[1]["written"] < mine + 0.05 * nbytes
    loaded, meta = tckpt.load_any(path, _port_template())
    assert meta == {"sharded": True}
    got = tckpt.flatten_state(loaded)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_orbax_sharded_restores_in_jax(sharded):
    """The two ranks' checkpoint in msnv_tpu's load_checkpoint_orbax,
    every leaf bit-equal to the state it came from."""
    state, path, _, _ = sharded
    template = jax.tree_util.tree_map(jnp.zeros_like, state)
    back, meta = jckpt.load_checkpoint_orbax(path, template)
    assert meta == {"sharded": True}
    got, want = _jax_flat(back), _jax_flat(state)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_orbax_sharded_restores_in_two_jax_processes(sharded, tmp_path):
    """The two ranks' checkpoint in msnv_tpu's load_checkpoint_orbax run
    by two jax.distributed processes (as scripts/multihost_sim.py resumes),
    every leaf bit-equal to the state it came from."""
    state, path, _, _ = sharded
    template = jax.tree_util.tree_map(jnp.zeros_like, state)
    got = _jax_two_process_load(path, template, tmp_path)
    want = _jax_flat(state)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------
# generation and the CLIs
# --------------------------------------------------------------------------

def test_greedy_audio_equal_from_orbax_and_npz(tmp_path):
    """Weights the JAX package wrote as .orbax and as .npz, loaded by the
    port, give the same greedy sequences, equal to the JAX package's."""
    m = preset("tiny_unconditional").model
    jp, tp = both_params(m, seed=4)
    orb, npz = str(tmp_path / "j.orbax"), str(tmp_path / "j.npz")
    jckpt.save_checkpoint_orbax(orb, {"params": jp})
    jckpt.save_checkpoint(npz, {"params": jp})
    from_orbax, _ = tckpt.load_any(orb, {"params": tp})
    from_npz, _ = tckpt.load_any(npz, {"params": tp})
    rng = np.random.RandomState(5)
    cond = rng.rand(2, 4, m.effective_cond_dim).astype(np.float32)
    spk = np.zeros(2, np.int32)
    seqs = [generate_fn(p["params"], torch_cfg(m), temperature=0.0)(
        torch.from_numpy(cond), torch.from_numpy(spk))[1].numpy()
        for p in (from_orbax, from_npz)]
    _, seq_j = jax_generate_fn(jp, m, temperature=0.0)(
        jnp.asarray(cond), jnp.asarray(spk), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(seqs[0], seqs[1])
    np.testing.assert_array_equal(seqs[0], np.asarray(seq_j))


def _cli_args(data_dir, results_dir, epochs, *extra):
    return ["--exp", "orbaxcli", "--frame_sizes", "4", "4", "--n_rnn", "1",
            "--dim", "32", "--seq_len", "64", "--batch_size", "4",
            "--cond_len", "16", "--norm_ind", "false",
            "--datasets_path", data_dir, "--results_path", results_dir,
            "--epoch_limit", str(epochs), "--learning_rate", "2e-3",
            "--device", "cpu", "--ckpt_backend", "orbax", *extra]


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    data_dir = str(tmp_path_factory.mktemp("orbax_cli") / "datasets")
    make_synthetic_corpus(data_dir, n_speakers=2, utts_per_speaker=2,
                          frames_per_utt=150, cond_len=16,
                          partitions=("train", "validation", "test"))
    return data_dir


def _run(results):
    (tag,) = os.listdir(results)
    exp = os.path.join(results, tag)
    with open(os.path.join(exp, "stats.json")) as f:
        stats = json.load(f)
    ckpts = os.path.join(exp, "checkpoints")
    (last,) = [c for c in os.listdir(ckpts) if c.startswith("ep2-")]
    return stats, os.path.join(ckpts, last)


def test_cli_train_orbax_resume_equals_a_straight_run(corpus_dir, tmp_path):
    """cli.train --ckpt_backend orbax on two ranks over a (1, 2) mesh: one
    epoch, then resumed to two, gives the straight two-epoch run's losses
    and final state bit for bit; each rank wrote its own database of every
    checkpoint."""
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    shards = ("--n_model_shards", "2")
    torch_parallel.Ranks(
        "job_cli_dcp", 2, str(tmp_path),
        _cli_args(corpus_dir, straight, 2, *shards),
        _cli_args(corpus_dir, resumed, 1, *shards),
        _cli_args(corpus_dir, resumed, 2, *shards), timeout=400).results()
    (s_stats, s_last), (r_stats, r_last) = _run(straight), _run(resumed)
    assert r_stats["epochs"] == [2] and s_stats["epochs"] == [1, 2]
    n = len(r_stats["training_loss"])
    assert 2 * n == len(s_stats["training_loss"])
    assert r_stats["training_loss"] == s_stats["training_loss"][-n:]
    assert r_stats["validation_loss"] == s_stats["validation_loss"][-1:]
    assert r_last.endswith(".orbax")
    assert {"ocdbt.process_0", "ocdbt.process_1"} <= set(os.listdir(r_last))
    template = _cli_template()
    a, _ = tckpt.load_any(s_last, template)
    b, meta = tckpt.load_any(r_last, template)
    assert meta["epoch"] == 2
    _assert_equal(b, a)


def test_clis_load_orbax(corpus_dir, tmp_path, capsys):
    """One process: cli.train --ckpt_backend orbax writes .orbax
    checkpoints; cli.evaluate, cli.generate (greedy WAVs byte-equal to
    those from the same state as .npz), cli.export and cli.interop load
    them."""
    import filecmp
    from msnv_tpu_torch.cli import evaluate, export, generate, interop
    from msnv_tpu_torch.cli import train as cli_train
    results = str(tmp_path / "results")
    stdout = sys.stdout
    try:
        cli_train.main(_cli_args(corpus_dir, results, 1))
    finally:
        sys.stdout = stdout
    (tag,) = os.listdir(results)
    ckpts = os.path.join(results, tag, "checkpoints")
    (orb,) = [c for c in os.listdir(ckpts) if c.startswith("ep1-")]
    orb = os.path.join(ckpts, orb)
    state, meta = tckpt.load_any(orb, _cli_template())
    npz = orb[:-len(".orbax")] + ".npz"
    tckpt.save_checkpoint(npz, state, meta)
    capsys.readouterr()
    evaluate.main(["--model", orb + "/", "--datasets_path", corpus_dir,
                   "--device", "cpu"])
    orb_eval = capsys.readouterr().out
    evaluate.main(["--model", npz, "--datasets_path", corpus_dir,
                   "--device", "cpu"])
    assert orb_eval == capsys.readouterr().out and orb_eval
    cond = os.path.join(corpus_dir, "cond")
    name = sorted(os.path.splitext(f)[0] for f in
                  os.listdir(os.path.join(corpus_dir, "wav")))[0]
    lists = tmp_path / "lists"
    lists.mkdir()
    (lists / "cond.txt").write_text(name + "\n")
    (lists / "spk.txt").write_text("0\n")
    outs = []
    for model in (orb, npz):
        out = str(tmp_path / f"wav_{os.path.basename(model)}")
        generate.main(["--model", model, "--cond_path", cond,
                       "--cond_list", str(lists / "cond.txt"),
                       "--spk_list", str(lists / "spk.txt"),
                       "--min_max", os.path.join(
                           corpus_dir, "npy_datasets",
                           "min_max_joint.npy"),
                       "--temperature", "0", "--out_dir", out,
                       "--device", "cpu"])
        outs.append(out)
    wavs = sorted(os.listdir(outs[0]))
    assert wavs and wavs == sorted(os.listdir(outs[1]))
    assert wavs[0].startswith(os.path.basename(orb)[:-len(".orbax")])
    for w in wavs:
        assert filecmp.cmp(os.path.join(outs[0], w),
                           os.path.join(outs[1], w), shallow=False)
    art = str(tmp_path / "a.msnvt")
    export.main(["--model", orb, "--out", art, "--lanes", "1", "--frames",
                 "1", "--frame_bucket", "1", "--engine", "pallas",
                 "--device", "cpu"])
    assert os.path.getsize(art) > 0
    ref = str(tmp_path / "ref.pt")
    interop.main(["export", "--model", orb, "--out", ref, "--device", "cpu"])
    assert os.path.getsize(ref) > 0


def test_modules_work_with_jax_blocked(tmp_path):
    """The port's checkpoint modules import, read the fixtures and write
    orbax with jax, jaxlib, orbax, tensorstore, zstandard and msnv_tpu
    blocked in sys.modules (an import of any raises)."""
    code = f"""
import sys
BLOCKED = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard",
           "msnv_tpu")
for name in BLOCKED + ("orbax.checkpoint",):
    sys.modules[name] = None
sys.path.insert(0, {REPO!r})
import json, torch
from msnv_tpu_torch.training import checkpoint, ocdbt, zstd
from msnv_tpu_torch.cli import train, evaluate, generate, export, interop
from msnv_tpu_torch.serving import cli
meta = json.load(open({os.path.join(FIXTURES, "sharded.orbax",
                                    "msnv_meta.json")!r}))
tpl = {{k: torch.zeros(v["shape"], dtype=getattr(torch, v["dtype"]))
        for k, v in meta["leaves"].items()}}
a, _ = checkpoint.load_any({os.path.join(FIXTURES, "sharded.orbax")!r}, tpl)
b, _ = checkpoint.load_any({os.path.join(FIXTURES, "sharded.npz")!r}, tpl)
assert all(torch.equal(a[k], b[k]) for k in tpl)
checkpoint.save_checkpoint_orbax({str(tmp_path / "x.orbax")!r}, a)
c, _ = checkpoint.load_any({str(tmp_path / "x.orbax")!r}, tpl)
assert all(torch.equal(a[k], c[k]) for k in tpl)
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("BLOCKED_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0 and "BLOCKED_OK" in out.stdout, out.stderr
