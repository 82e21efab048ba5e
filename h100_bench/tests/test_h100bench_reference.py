"""The plain reference agrees with the port at a tiny size on the CPU, where
both compute in float32 (the port's kernels run their plain versions): the
same samples drawn along the sequences the port generated, and the same
train steps. And the controls, the reference in a lower precision put in
the program's place, come out far from it."""

import pytest
import torch

import h100bench_tiny as tiny
from h100_bench import harness


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("bench"))


def _driver(root, cell, seed=tiny.SEED):
    bench = harness.load_json(root / "BENCHMARK.json")
    w, conf = harness.find_cell(bench, cell)
    config = harness.load_json(root / conf["file"])
    traffic = harness.load_json(
        root / "h100_bench/traffic" / f"{w['traffic']}.json")
    mod = harness.load_driver(root / "h100_bench", traffic["driver"])
    ctx = harness.Context(cell, config, traffic, seed, torch.device("cpu"),
                          0.5)
    d = mod.Driver(ctx)
    d.window(0.5, False)
    d.finish()
    return d


def test_generation_matches_in_float32(root):
    got = _driver(root, "tiny.gen.f32").check()
    assert got["bad_audio"] == 0
    assert got["gap"] < 1e-4


def test_float32_train_steps_match(root):
    got = _driver(root, "tiny.train").check()
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-5
    assert got["update_gap"] < 1e-3


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_fp8_control_is_far_from_bf16_generation(root, seed):
    d = _driver(root, "tiny.gen", seed)
    program, control = d.check()["gap"], d.check("fp8")["gap"]
    assert control > 3 * program


def test_fp8_control_is_far_from_bf16_streams(root, monkeypatch):
    tiny.mux_on_window_path(monkeypatch)
    d = _driver(root, "tiny.stream")
    program, control = d.check()["gap"], d.check("fp8")["gap"]
    assert control > 3 * program


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_fp8_control_is_far_from_the_bf16_gan_step(root, seed):
    d = _driver(root, "tiny_gan.train", seed)
    program, control = d.check(), d.check("fp8")
    assert max(control[k] / program[k] for k in program
               if program[k] > 0) > 3


@pytest.mark.tpu
def test_tf32_control_is_far_from_the_float32_step(root):
    """TF32 exists on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need a CUDA device")
    bench = harness.load_json(root / "BENCHMARK.json")
    w, conf = harness.find_cell(bench, "tiny.train")
    config = harness.load_json(root / conf["file"])
    traffic = harness.load_json(
        root / "h100_bench/traffic" / f"{w['traffic']}.json")
    mod = harness.load_driver(root / "h100_bench", traffic["driver"])
    ctx = harness.Context("tiny.train", config, traffic, tiny.SEED,
                          torch.device("cuda"), 0.5)
    d = mod.Driver(ctx)
    d.window(0.5, False)
    d.finish()
    program, control = d.check(), d.check("tf32")
    assert max(control[k] / max(program[k], 1e-12) for k in program) > 3
