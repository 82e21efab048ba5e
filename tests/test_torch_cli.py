"""The port's train / evaluate / generate CLIs against the JAX package's, on
the CPU (`--device cpu`), on one synthetic corpus; and the host CLIs
(augment, metrics, plotlog, interpolate, interop) against the JAX
package's on the same inputs: augment's WAVs bit-equal, metrics' JSON
within 1e-6, plotlog's series equal, interpolate's files equal, the port's
interop import of the JAX package's export equal to the port's params.

Both train CLIs warm-start (`--model`) from one JAX-initialized checkpoint,
so they train the same weights: their stats.json losses and checkpoints
agree to 1e-4 (the train step's tolerance of test_torch_train_step.py:
float32 sums in another order). The evaluate CLIs print JSON lines that
agree to 1e-4 bits, and greedy
(`--temperature 0`) generation writes the same WAV files, eigen-voice mix
included. Resume from the port's own checkpoint and from the JAX CLI's is
held to an uninterrupted run.
"""

import dataclasses
import filecmp
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from msnv_tpu.config import ModelConfig
from msnv_tpu.models.samplernn import init_params as jax_init_params
from msnv_tpu.training.checkpoint import save_checkpoint as jax_save
from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
from msnv_tpu_torch.data.wavio import read_wav

MODEL = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=32, cond_dim=43,
                    cond_len=16, spk_dim=2)
ATOL = 1e-4


def _train_args(data_dir, results, epochs, *extra):
    return ["--exp", "clitest", "--frame_sizes", "4", "4", "--n_rnn", "1",
            "--dim", "32", "--seq_len", "64", "--batch_size", "4",
            "--cond_len", "16", "--norm_ind", "false",
            "--datasets_path", data_dir, "--results_path", results,
            "--epoch_limit", str(epochs), "--learning_rate", "2e-3",
            *extra]


def _call(main, argv):
    """Run a CLI main; restore sys.stdout (the train CLIs tee it)."""
    stdout = sys.stdout
    try:
        main(argv)
    finally:
        sys.stdout = stdout


def _exp_dir(results):
    (tag,) = os.listdir(results)
    return os.path.join(results, tag)


def _stats(results):
    with open(os.path.join(_exp_dir(results), "stats.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX and the port train CLI, two epochs each from one warm-start
    checkpoint."""
    from msnv_tpu.cli.train import main as jax_train
    from msnv_tpu_torch.cli.train import main as port_train
    root = str(tmp_path_factory.mktemp("torch_cli"))
    data_dir = os.path.join(root, "datasets")
    make_synthetic_corpus(data_dir, n_speakers=2, utts_per_speaker=2,
                          frames_per_utt=150, cond_len=16,
                          partitions=("train", "validation", "test"))
    warm = os.path.join(root, "warm.npz")
    jax_save(warm, {"params": jax_init_params(jax.random.PRNGKey(1), MODEL)})
    runs = {"jax": os.path.join(root, "results_jax"),
            "port": os.path.join(root, "results_port")}
    _call(jax_train, _train_args(data_dir, runs["jax"], 2, "--model", warm))
    _call(port_train, _train_args(data_dir, runs["port"], 2, "--model", warm,
                                  "--device", "cpu"))
    return root, data_dir, runs, warm


def test_train_cli_outputs_match_jax(trained):
    _, _, runs, _ = trained
    port, jaxr = _exp_dir(runs["port"]), _exp_dir(runs["jax"])
    assert os.path.basename(port) == os.path.basename(jaxr)   # same tag
    for name in ("log", "stats.json", "loss.svg", "checkpoints", "samples"):
        assert os.path.exists(os.path.join(port, name)), name
    assert (sorted(os.listdir(os.path.join(port, "checkpoints")))
            == sorted(os.listdir(os.path.join(jaxr, "checkpoints"))))
    sp, sj = _stats(runs["port"]), _stats(runs["jax"])
    assert sp.keys() == sj.keys() and sp["epochs"] == sj["epochs"] == [1, 2]
    assert sp["iterations"] == sj["iterations"]
    for field in ("training_loss", "validation_loss", "test_loss"):
        np.testing.assert_allclose(sp[field], sj[field], rtol=0, atol=ATOL,
                                   err_msg=field)
    assert sp["training_loss"][-1] < sp["training_loss"][0]
    ck = sorted(os.listdir(os.path.join(port, "checkpoints")))[-1]
    with np.load(os.path.join(port, "checkpoints", ck)) as a, \
            np.load(os.path.join(jaxr, "checkpoints", ck)) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k == "__meta__":
                assert json.loads(a[k].tobytes()) == json.loads(
                    b[k].tobytes())
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ATOL,
                                           err_msg=k)


def test_train_cli_resume(trained, capsys):
    """`--epoch_limit 3` on the port's results resumes from its epoch-2
    checkpoint ("resumed from"); on the JAX CLI's results it resumes from
    the JAX checkpoint. Both give the losses of an uninterrupted three-epoch
    port run from the same warm start, the first bit for bit."""
    from msnv_tpu_torch.cli.train import main as port_train
    root, data_dir, runs, warm = trained
    straight = os.path.join(root, "results_straight")
    _call(port_train, _train_args(data_dir, straight, 3, "--model", warm,
                                  "--device", "cpu"))
    want = _stats(straight)["training_loss"]
    n = len(want) // 3
    for which in ("port", "jax"):
        resumed = os.path.join(root, f"resumed_{which}")
        shutil.copytree(runs[which], resumed)
        capsys.readouterr()
        _call(port_train, _train_args(data_dir, resumed, 3, "--device",
                                      "cpu"))
        assert "resumed from" in capsys.readouterr().out
        ckpts = os.listdir(os.path.join(_exp_dir(resumed), "checkpoints"))
        assert any(c.startswith("ep3-it") for c in ckpts)
        got = _stats(resumed)["training_loss"][-n:]
        if which == "port":
            assert got == want[-n:]
        else:
            np.testing.assert_allclose(got, want[-n:], rtol=0, atol=ATOL)


def _best(results):
    d = os.path.join(_exp_dir(results), "checkpoints")
    (name,) = [c for c in os.listdir(d) if c.startswith("best-")]
    return os.path.join(d, name)


def test_evaluate_cli_json_matches_jax(trained, capsys):
    from msnv_tpu.cli.evaluate import main as jax_eval
    from msnv_tpu_torch.cli.evaluate import main as port_eval
    _, data_dir, runs, _ = trained
    out = {}
    for name, main, model, extra in (
            ("jax", jax_eval, _best(runs["jax"]), []),
            ("port_on_jax", port_eval, _best(runs["jax"]),
             ["--device", "cpu"]),
            ("port", port_eval, _best(runs["port"]), ["--device", "cpu"])):
        capsys.readouterr()
        main(["--model", model, "--datasets_path", data_dir, *extra])
        out[name] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert out["port"].keys() == out["jax"].keys() == {"validation", "test"}
    for name in ("port", "port_on_jax"):
        for part, row in out[name].items():
            want = out["jax"][part]
            assert row.keys() == want.keys() and row["chunks"] == \
                want["chunks"]
            assert abs(row["nll_bits"] - want["nll_bits"]) <= ATOL
    # the trainer's last validation loss is what the evaluate CLI reads
    assert abs(out["port"]["validation"]["nll_bits"]
               - _stats(runs["port"])["validation_loss"][-1]) <= ATOL


def _lists(root, data_dir, spk_lines):
    names = sorted(os.path.splitext(f)[0] for f in
                   os.listdir(os.path.join(data_dir, "wav")))[:2]
    cond, spk = os.path.join(root, "gc.list"), os.path.join(root, "gs.list")
    with open(cond, "w") as f:
        f.write("\n".join(names))
    with open(spk, "w") as f:
        f.write(spk_lines)
    return cond, spk, names


@pytest.mark.parametrize("spk_lines", ["0\n1\n", "0.3,0.7\n1\n"])
def test_greedy_generate_cli_wavs_equal_jax(trained, spk_lines, tmp_path):
    """On the JAX CLI's checkpoint, `--temperature 0` writes byte-equal
    WAVs under the same names, a mixed voice included."""
    from msnv_tpu.cli.generate import main as jax_gen
    from msnv_tpu_torch.cli.generate import main as port_gen
    root, data_dir, runs, _ = trained
    cond, spk, names = _lists(str(tmp_path), data_dir, spk_lines)
    common = ["--model", _best(runs["jax"]),
              "--cond_path", os.path.join(data_dir, "cond"),
              "--cond_list", cond, "--spk_list", spk,
              "--min_max", os.path.join(data_dir, "npy_datasets",
                                        "min_max_joint.npy"),
              "--temperature", "0"]
    jax_gen(common + ["--out_dir", str(tmp_path / "j")])
    port_gen(common + ["--out_dir", str(tmp_path / "t"), "--device", "cpu",
                       "--engine", "pallas"])
    wavs = sorted(os.listdir(tmp_path / "j"))
    assert wavs == sorted(os.listdir(tmp_path / "t")) and len(wavs) == 2
    if "," in spk_lines:
        assert any("spk-mix0.3-0.7" in w for w in wavs)
    for w in wavs:
        assert filecmp.cmp(tmp_path / "j" / w, tmp_path / "t" / w,
                           shallow=False), w


@pytest.mark.parametrize("engine", ["auto", "pallas"])
def test_sampling_generate_cli_lengths(trained, engine, tmp_path, capsys):
    """Sampling at temperature 1 (auto = the per-sample path on the CPU;
    pallas = the kernel path, its plain version here) writes one WAV per
    utterance at the JAX CLI's names and lengths."""
    from msnv_tpu_torch.cli.generate import main as port_gen
    from msnv_tpu_torch.data.corpus import load_cond_tracks
    root, data_dir, runs, _ = trained
    cond, spk, names = _lists(str(tmp_path), data_dir, "1\n0\n")
    port_gen(["--model", _best(runs["port"]),
              "--cond_path", os.path.join(data_dir, "cond"),
              "--cond_list", cond, "--spk_list", spk,
              "--min_max", os.path.join(data_dir, "npy_datasets",
                                        "min_max_joint.npy"),
              "--out_dir", str(tmp_path / "o"), "--device", "cpu",
              "--engine", engine])
    want_engine = "xla" if engine == "auto" else "pallas"
    assert f"generation engine: {want_engine}" in capsys.readouterr().out
    ckpt = os.path.basename(_best(runs["port"]))[:-len(".npz")]
    for name, s in zip(names, ("1", "0")):
        audio, sr = read_wav(str(tmp_path / "o" /
                                 f"{ckpt}_file-{name}_spk-{s}.wav"))
        c = load_cond_tracks(os.path.join(data_dir, "cond"), name)[0]
        assert sr == 16000 and audio.shape == (c.shape[0] * 16,)
        assert np.isfinite(audio).all() and np.abs(audio).max() > 0


@pytest.mark.parametrize("flag", [["--multihost", "true"],
                                  ["--n_model_shards", "2"]])
def test_unported_train_flags_raise(flag, tmp_path, monkeypatch):
    """--multihost and --n_model_shards are ported
    (tests/test_torch_parallel.py), and refuse before anything runs what
    they cannot do: --multihost without the launcher's environment, model
    shards that do not divide the processes (one here)."""
    from msnv_tpu_torch.cli.train import main as port_train
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    error, match = {
        "--multihost": (ValueError, "launcher's environment"),
        "--n_model_shards": (ValueError, "does not divide the 1 processes"),
    }[flag[0]]
    with pytest.raises(error, match=match):
        port_train(_train_args(str(tmp_path), str(tmp_path), 1, "--device",
                               "cpu", *flag))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("cli", ["train", "evaluate", "generate", "export",
                                 "interop"])
def test_entry_points_default_to_cuda(cli, monkeypatch, tmp_path):
    """Without --device every CLI runs on `cuda`, and raises without a
    card; nothing falls back to the CPU."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"msnv_tpu_torch.cli.{cli}").main
    argv = {"train": _train_args(str(tmp_path), str(tmp_path), 1),
            "evaluate": ["--model", "m.npz", "--datasets_path", "d"],
            "generate": ["--model", "m.npz", "--cond_path", "c",
                         "--cond_list", "l", "--spk_list", "s"],
            "export": ["--model", "m.npz", "--out", "a", "--frames", "1"],
            "interop": ["export", "--model", "m.npz"]}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_console_scripts():
    import tomllib
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    for name in ("train", "evaluate", "generate", "export", "augment",
                 "metrics", "plotlog", "interpolate", "interop"):
        assert scripts[f"msnv-{name}-torch"] == \
            f"msnv_tpu_torch.cli.{name}:main"


# --------------------------------------------------------------------------
# the host CLIs: augment, metrics, plotlog, interpolate, interop
# --------------------------------------------------------------------------

def _tone(freq, seconds=0.2, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _wav_corpus(root, names):
    from msnv_tpu_torch.data.wavio import write_wav
    os.makedirs(os.path.join(root, "wav"))
    for i, n in enumerate(names):
        write_wav(os.path.join(root, "wav", n + ".wav"),
                  _tone(200 + 100 * i, 0.1), 16000)
    with open(os.path.join(root, "wav_train.list"), "w") as f:
        f.write("\n".join(names) + "\n")


@pytest.mark.parametrize("flags", [["--speeds", "0.9,1.1", "--gains", "0.79"],
                                   ["--speeds", "0.95", "--gains", ""]])
def test_augment_cli_wavs_equal_jax(tmp_path, capsys, flags):
    from msnv_tpu.cli.augment import main as jax_augment
    from msnv_tpu_torch.cli.augment import main as port_augment
    names = ["72u000", "73u000", "72u001"]
    roots = {}
    for pkg, main in (("jax", jax_augment), ("port", port_augment)):
        roots[pkg] = str(tmp_path / pkg)
        _wav_corpus(roots[pkg], names)
        main(["--datasets_path", roots[pkg], *flags])
    jout, pout = capsys.readouterr().out.strip().splitlines()
    assert jout.replace(roots["jax"], "") == pout.replace(roots["port"], "")
    cmp = filecmp.dircmp(os.path.join(roots["jax"], "wav"),
                         os.path.join(roots["port"], "wav"))
    assert len(cmp.common_files) > len(names)
    assert not (cmp.left_only or cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(
        cmp.left, cmp.right, cmp.common_files, shallow=False)
    assert not mismatch and not errors
    assert filecmp.cmp(os.path.join(roots["jax"], "wav_train.list"),
                       os.path.join(roots["port"], "wav_train.list"),
                       shallow=False)


@pytest.mark.parametrize("factor", [0.9, 1.1, 0.97])
def test_augment_functions_bit_equal_jax(factor):
    import warnings
    from msnv_tpu.data import augment as ja
    from msnv_tpu_torch.data import augment as ta
    x = _tone(330, 0.05) + np.float32(0.01) * np.random.RandomState(
        0).randn(800).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # 0.97 snaps to 19/20
        want, got = ja.speed_perturb(x, factor), ta.speed_perturb(x, factor)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ta.gain_perturb(x, factor * 2),
                                  ja.gain_perturb(x, factor * 2))


def _metrics_inputs(tmp_path):
    from msnv_tpu_torch.data.wavio import write_wav
    ref_dir = tmp_path / "wav" / "72"
    gen_dir = tmp_path / "samples"
    lf0_dir = tmp_path / "cond" / "72"
    for d in (ref_dir, gen_dir, lf0_dir):
        d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i, f0 in enumerate((130.0, 210.0)):
        x = _tone(f0, 0.3)
        write_wav(str(ref_dir / f"72utt{i}.wav"), x, 16000)
        write_wav(str(gen_dir / f"ckpt_file-72utt{i}_spk-72.wav"),
                  x + np.float32(0.02) * rng.randn(len(x)).astype(
                      np.float32), 16000)
        np.savetxt(str(lf0_dir / f"72utt{i}.lf0"),
                   np.full(len(x) // 80, np.log(f0)))
    return ["--gen", str(gen_dir), "--ref", str(tmp_path / "wav"),
            "--lf0", str(tmp_path / "cond")]


def test_metrics_cli_json_matches_jax(tmp_path, capsys):
    from msnv_tpu.cli.metrics import main as jax_metrics
    from msnv_tpu_torch.cli.metrics import main as port_metrics
    from msnv_tpu_torch.cli.metrics import utt_id
    assert utt_id("best-ep3-it9_file-72abc_spk-72.wav") == "72abc"
    argv = _metrics_inputs(tmp_path)
    lines = {}
    for pkg, main in (("jax", jax_metrics), ("port", port_metrics)):
        assert main(argv) == 0
        lines[pkg] = [json.loads(x) for x in
                      capsys.readouterr().out.strip().splitlines()]
    assert len(lines["port"]) == len(lines["jax"]) == 3
    for got, want in zip(lines["port"], lines["jax"]):
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6,
                                           err_msg=k)
            else:
                assert got[k] == v, k
    empty = tmp_path / "empty"
    empty.mkdir()
    assert port_metrics(["--gen", str(empty), "--ref", argv[3]]) == 1


PLOT_LOG = """starting run
it 100\ttraining_loss: 7.9123\ttraining_loss/running_avg: 8.0011
it 200\ttraining_loss: 7.1054\ttraining_loss/running_avg: 7.8120
epoch 1\ttraining_loss: 7.1054\ttraining_loss/running_avg: 7.8120\tvalidation_loss: 7.3001\ttest_loss: 7.4102
it 300\ttraining_loss: 6.8020
epoch 2\ttraining_loss: 6.8020\tvalidation_loss: 6.9050\ttest_loss: 7.0103
"""


@pytest.mark.parametrize("extra", [[], ["--perplexity"]])
def test_plotlog_cli_matches_jax(tmp_path, capsys, extra):
    from msnv_tpu.cli.plotlog import main as jax_plotlog
    from msnv_tpu.cli.plotlog import parse_log as jax_parse
    from msnv_tpu_torch.cli.plotlog import main as port_plotlog
    from msnv_tpu_torch.cli.plotlog import parse_log as port_parse
    res = tmp_path / "results"
    res.mkdir()
    (res / "log").write_text(PLOT_LOG)
    assert port_parse(str(res / "log")) == jax_parse(str(res / "log"))
    outs = []
    for pkg, main in (("jax", jax_plotlog), ("port", port_plotlog)):
        out = str(tmp_path / f"{pkg}.png")
        main([str(res), "--out", out, *extra])
        outs.append(out)
    assert capsys.readouterr().out.split() == \
        ["wrote", outs[0], "wrote", outs[1]]
    for out in outs:
        with open(out, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("flag,sentinel", [("--f0_file", -1e10),
                                           ("--vf_file", 1e3)])
def test_interpolate_cli_files_equal_jax(tmp_path, capsys, flag, sentinel):
    from msnv_tpu.cli.interpolate import main as jax_interp
    from msnv_tpu_torch.cli.interpolate import main as port_interp
    rng = np.random.RandomState(3)
    track = rng.rand(60) * 2 + 4
    unvoiced = rng.rand(60) < 0.4
    track[unvoiced] = sentinel if sentinel < 0 else 2 * sentinel
    track[:3] = sentinel if sentinel < 0 else 2 * sentinel
    for pkg, main in (("jax", jax_interp), ("port", port_interp)):
        d = tmp_path / pkg
        d.mkdir()
        np.savetxt(str(d / "x.lf0"), track)
        with open(d / "guia.txt", "w") as f:
            f.write(str(d / "x.lf0") + "\n")
        main([flag, str(d / "x.lf0")])
        main([flag.replace("_file", "_guia"), str(d / "guia.txt"),
              "--no-uv"])
    printed = capsys.readouterr().out
    assert printed.count("Writing interpolation") == 4
    for name in ("x.i.lf0", "x.uv"):
        assert filecmp.cmp(str(tmp_path / "jax" / name),
                           str(tmp_path / "port" / name), shallow=False)


def _interop_checkpoint(tmp_path):
    """A JAX-package export of the original repository's layout, saved with
    torch.save under results/<tag>/checkpoints/."""
    from msnv_tpu.config import ExperimentConfig, make_tag
    from msnv_tpu.interop import reference_state_dict_from_params
    cfg = ModelConfig(frame_sizes=(4, 4), n_rnn=2, dim=16, cond_dim=5,
                      spk_dim=3)
    params = jax_init_params(jax.random.PRNGKey(2), cfg)
    ckpt_dir = (tmp_path / "results" / make_tag(ExperimentConfig(
        exp="samplernn", model=cfg)) / "checkpoints")
    ckpt_dir.mkdir(parents=True)
    sd = reference_state_dict_from_params(params, cfg)
    path = str(ckpt_dir / "best-ep3-it99")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, path)
    return cfg, params, sd, path


def test_interop_cli_imports_the_jax_export(tmp_path):
    """The JAX package's reference_state_dict_from_params, imported by the
    port's CLI, gives the port's params of the same weights; the port's
    export CLI writes the JAX package's state_dict back."""
    from msnv_tpu_torch.cli.interop import main as port_interop
    from msnv_tpu_torch.interop import load_npz_params
    from torch_parity import to_torch, torch_cfg
    cfg, params, sd, path = _interop_checkpoint(tmp_path)
    assert port_interop(["import", "--torch_ckpt", path, "--device",
                         "cpu"]) == 0
    got = load_npz_params(path + ".npz", torch_cfg(cfg), device="cpu")
    want = to_torch(params, cfg)
    from msnv_tpu_torch.tree import leaves_with_paths
    for (pg, g), (pw, w) in zip(leaves_with_paths(got),
                                leaves_with_paths(want)):
        assert pg == pw
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    out = str(tmp_path / "back.pt")
    assert port_interop(["export", "--model", path + ".npz", "--out", out,
                         "--device", "cpu"]) == 0
    back = torch.load(out, map_location="cpu", weights_only=True)
    assert list(back) == list(sd)
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_interop_functions_match_jax(tmp_path):
    from msnv_tpu.interop import (
        params_from_reference_state_dict as jax_import)
    from msnv_tpu_torch.interop import (params_from_reference_state_dict,
                                        reference_state_dict_from_params)
    from torch_parity import flat_numpy, to_torch, torch_cfg
    from msnv_tpu_torch.interop import params_to_numpy
    cfg, params, sd, _ = _interop_checkpoint(tmp_path)
    tcfg = torch_cfg(cfg)
    port_sd = reference_state_dict_from_params(to_torch(params, cfg), tcfg)
    assert list(port_sd) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(port_sd[k], sd[k], err_msg=k)
    # torch tensors in (as torch.load gives them), params on the CPU out
    port = params_from_reference_state_dict(
        {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, tcfg,
        device="cpu")
    want = flat_numpy(jax_import(sd, cfg))
    got = params_to_numpy(port)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(KeyError):
        params_from_reference_state_dict(sd, dataclasses.replace(
            tcfg, frame_sizes=(4, 4, 4)), device="cpu")
    with pytest.raises(ValueError):
        params_from_reference_state_dict(sd, dataclasses.replace(
            tcfg, weight_norm=True), device="cpu")
