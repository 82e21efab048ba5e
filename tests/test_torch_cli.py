"""The port's train / evaluate / generate CLIs against the JAX package's, on
the CPU (`--device cpu`), on one synthetic corpus.

Both train CLIs warm-start (`--model`) from one JAX-initialized checkpoint,
so they train the same weights: their stats.json losses and checkpoints
agree to 1e-4 (the train step's tolerance of test_torch_train_step.py:
float32 sums in another order). The evaluate CLIs print JSON lines that
agree to 1e-4 bits, and greedy
(`--temperature 0`) generation writes the same WAV files, eigen-voice mix
included. Resume from the port's own checkpoint and from the JAX CLI's is
held to an uninterrupted run.
"""

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
                                  ["--n_model_shards", "2"],
                                  ["--ckpt_backend", "orbax"]])
def test_unported_train_flags_raise(flag, tmp_path):
    from msnv_tpu_torch.cli.train import main as port_train
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1.7"):
        port_train(_train_args(str(tmp_path), str(tmp_path), 1, "--device",
                               "cpu", *flag))


@pytest.mark.parametrize("cli", ["train", "evaluate", "generate"])
def test_entry_points_default_to_cuda(cli, monkeypatch, tmp_path):
    """Without --device every CLI runs on `cuda`, and raises without a
    card; nothing falls back to the CPU."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"msnv_tpu_torch.cli.{cli}").main
    argv = {"train": _train_args(str(tmp_path), str(tmp_path), 1),
            "evaluate": ["--model", "m.npz", "--datasets_path", "d"],
            "generate": ["--model", "m.npz", "--cond_path", "c",
                         "--cond_list", "l", "--spk_list", "s"]}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_console_scripts():
    import tomllib
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    for name in ("train", "evaluate", "generate"):
        assert scripts[f"msnv-{name}-torch"] == \
            f"msnv_tpu_torch.cli.{name}:main"
