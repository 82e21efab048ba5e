"""The port at three frame tiers (frame sizes (4, 5, 4), the hierarchy of
`preset("single_speaker_cond")`) on the CPU at small widths, and the
benchmark's data-parallel train driver as gloo ranks.

- The predictor against the benchmark's plain reference
  (h100_bench/reference/samplernn.py), in float32 from the same weights.
- The multiplexer: greedy streams with an attach mid-run give
  `generate_fn`'s samples for the same conditioners and speaker; the
  in-place carry gives the rebinding form's audio at temperature 1 and 0;
  a tick issues the frame-tier steps that the benchmark's tier_step_us
  reader counts from the frame sizes.
- h100_bench/drivers/train_mesh.py as 4 gloo CPU ranks: rank 0's
  all-reduced step within limits of the blocked reference where the fp8
  control is not, the replicas equal; a rank 0 that keeps its own
  gradient instead of the all-reduced one leaves them apart.

Torch, the port and the benchmark only: no JAX.
"""

import numpy as np
import pytest
import torch

import torch_mux_graph
from h100_bench import harness, inputs
from h100_bench.reference import samplernn as ref
from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.models.generate import generate_fn
from msnv_tpu_torch.models.samplernn import init_params, predictor_apply
from msnv_tpu_torch.serving import StreamMultiplexer

THREE = (4, 5, 4)
CFG = ModelConfig(frame_sizes=THREE, n_rnn=1, dim=16, cond_dim=3,
                  cond_len=80, spk_dim=3)
C = CFG.effective_cond_dim


def _model(frame_sizes, dim=32):
    """The reference's "model" object and the port's config alike."""
    m = {"frame_sizes": list(frame_sizes), "n_rnn": 1, "dim": dim,
         "learn_h0": True, "q_levels": 256, "ulaw": True,
         "weight_norm": False, "cond_dim": 5, "cond_len": 80, "spk_dim": 1,
         "look_ahead": False, "qrnn": False, "variant": "identity",
         "ind_cond_dim": 50}
    return m, harness.model_config(m)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("reset", [True, False])
@pytest.mark.parametrize("frame_sizes", [(4, 4), THREE])
def test_predictor_matches_plain_reference(frame_sizes, reset):
    """Logits and the new TBPTT state of one chunk, from seeded weights
    (the benchmark's) and a carried state. Tolerance 1e-4 on logits of
    magnitude ~5: both are float32 sums of the same products, the port's
    sample-MLP input as rows of the fused embed-conv table and the
    reference's as a gather and a convolution, so they differ by the
    rounding of sums of a few dozen terms (read: under 1e-6); a tier fed
    by the wrong parent or the wrong frame reads above 0.1."""
    m, cfg = _model(frame_sizes)
    dev = torch.device("cpu")
    p = inputs.fill_tree(init_params(cfg, device="meta"),
                         inputs.generator(dev, 7, "weights"), dev)
    g = inputs.generator(dev, 7, "inputs")
    batch, seq_len, lb = 3, 2 * cfg.lookback, cfg.lookback
    inp = inputs.audio_levels(g, batch, seq_len + lb - 1, 256, dev)
    cond = inputs.conditioners(g, (batch, seq_len // lb, 5), dev)
    spk = torch.zeros(batch, dtype=torch.int64)
    state = [0.1 * torch.randn((1, batch, 32), generator=g)
             for _ in frame_sizes]
    logits, new_state, _ = predictor_apply(p, cfg, inp, reset, cond, spk,
                                           state, output="logits")
    want, want_state, _ = ref.forward(ref.Precision("f32"), m, p, inp,
                                      reset, cond, spk, state)
    assert logits.shape == (batch, seq_len, 256)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=0)
    for s, w in zip(new_state, want_state):
        torch.testing.assert_close(s, w, atol=1e-5, rtol=0)


def test_greedy_mux_streams_equal_generate_fn(params):
    """Two greedy streams through one multiplexer at three tiers, the
    second attached while the first runs (after its first chunk): each
    stream's PCM is `generate_fn`'s greedy audio of its conditioners and
    speaker alone, sample for sample."""
    mux = StreamMultiplexer(params, CFG, lanes=3, frames_per_push=2,
                            temperature=0.0)
    rng = np.random.RandomState(0)
    conds = [rng.rand(n, C).astype(np.float32) for n in (6, 4)]
    spks = (2, 0)

    def feed(lane, cond):
        mux.feed(lane, [cond[i:i + 2] for i in range(0, len(cond), 2)])

    a = mux.acquire(np.asarray([spks[0]], np.int32))
    feed(a, conds[0])
    mux.start()
    try:
        first = mux.out_queue(a).get(timeout=120)
        b = mux.acquire(np.asarray([spks[1]], np.int32))
        feed(b, conds[1])
        got = [np.concatenate([first] + [mux.out_queue(a).get(timeout=120)
                                         for _ in range(2)]),
               np.concatenate([mux.out_queue(b).get(timeout=120)
                               for _ in range(2)])]
    finally:
        mux.stop()
    gen = generate_fn(params, CFG, temperature=0.0)
    for pcm, cond, spk in zip(got, conds, spks):
        audio, _ = gen(torch.from_numpy(cond)[None], torch.tensor([spk]))
        want = (np.clip(audio[0].numpy(), -1.0, 1.0 - 1.0 / 32768)
                * 32768.0).astype("<i2")
        assert pcm.shape == (len(cond) * CFG.lookback,)
        np.testing.assert_array_equal(pcm, want)


@pytest.mark.parametrize("temperature", [1.0, 0.0])
def test_in_place_carry_matches_rebinding(params, temperature):
    """The pump's splices and pushes at three tiers, over acquires, an
    attach while other lanes run, a release and the lane taken again, give
    the audio and state of the same steps applied by rebinding a carry,
    exactly (tests/torch_mux_graph.py)."""
    run = torch_mux_graph.sequence(params, CFG, temperature=temperature)
    torch_mux_graph.same_as_rebinding(run)
    assert run["ticks"] == torch_mux_graph.TICKS


def test_tick_issues_the_tier_steps_the_reader_counts(params, monkeypatch):
    """A tick of K frames issues, at frame sizes (4, 5, 4), K steps of the
    top tier, 4 K of the middle one and 20 K of the bottom one, each one
    upsampling of its output for all lanes: what tier_step_us.cond3
    divides the device time by."""
    from msnv_tpu_torch.models import generate
    steps = []
    real = generate.upsample_step

    def counted(*args, **kw):
        steps.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(generate, "upsample_step", counted)
    mux = StreamMultiplexer(params, CFG, lanes=2, frames_per_push=2,
                            temperature=0.0)
    active = np.ones((2,), bool)
    cond = np.zeros((2, 2, C), np.float32)
    with mux._carry_lock, mux._device_lock:
        for _ in range(3):
            mux._tick(cond, active)
    reader = harness.load_reader(harness.ROOT, "tier_step_us.cond3")
    assert mux.ticks == 3
    assert len(steps) == 3 * reader.steps_per_tick(THREE, 2) == \
        3 * 2 * (1 + 4 + 20)


# -- the data-parallel train driver as gloo ranks ---------------------------

TINY_MESH = {"batch": 8, "chunks": 3, "check_block": 2, "traced_steps": 2}
# the tiny step's own limits: at width 32 and 2 lanes a rank its bf16
# readings sit above the full-width cell's (seeds 2**31 + 77, 5, 6:
# grad_gap up to 0.014, grad_diff 0.074, update_gap 0.019; the fp8 control
# 0.076, 0.23 and 0.020; half the batch 0.37, 0.95 and 0.12); the cell's
# limits file holds replica_gap
TINY_LIMITS = {"grad_gap": 0.05, "grad_diff": 0.15, "update_gap": 0.06}


def _mesh_run(seed=2 ** 31 + 77):
    """One run of the mesh cell's driver at a tiny size on 4 gloo CPU
    ranks -> (the driver, the window)."""
    root = harness.ROOT
    config = harness.load_json(root / "configs" / "samplernn.json")
    config["model"].update(frame_sizes=[4, 4], dim=32, cond_dim=3,
                           cond_len=16, spk_dim=2)
    config["train"].update(seq_len=64)
    traffic = dict(harness.load_json(
        root / "traffic" / "train.bf16.mesh4.json"), **TINY_MESH)
    mod = harness.load_driver(root, traffic["driver"])
    ctx = harness.Context("samplernn.train.bf16.mesh4", config, traffic,
                          seed, torch.device("cpu"), 0.3)
    d = mod.Driver(ctx)
    win = d.window(0.3, False)
    d.finish()
    return d, win


def _limits():
    limits = {k: v["limit"] for k, v in harness.load_json(
        harness.REPO / "h100_bench/limits/samplernn.train.bf16.mesh4.json")
        .items()}
    assert set(limits) == set(TINY_LIMITS) | {"replica_gap"}
    return dict(limits, **TINY_LIMITS)


def _correct(numbers):
    return all(numbers[k] <= lim for k, lim in _limits().items())


def test_train_mesh_ranks_agree_with_the_reference():
    """Correct, the replicas bit-equal; the fp8 control in the program's
    place is not."""
    d, win = _mesh_run()
    numbers = d.check()
    assert numbers["replica_gap"] == 0.0
    assert _correct(numbers), numbers
    assert not _correct(d.check("fp8"))
    assert win.raw["ranks"] == 4 and win.raw["batch"] == 8
    assert win.attempted == win.raw["steps"] >= 1
    assert win.metrics["train_samples_per_s"] > 0


def test_train_mesh_rank_without_allreduce_is_caught(monkeypatch):
    """Rank 0 joins the all-reduce but steps on its own lanes' gradient:
    its replica leaves the others', and replica_gap reads above 0."""
    import msnv_tpu_torch.training.step as step
    real = step.reduce_gradients

    def own_gradient(mesh, grads, specs, *scalars):
        reduced = real(mesh, grads, specs, *scalars)
        return (grads, *reduced[1:])

    monkeypatch.setattr(step, "reduce_gradients", own_gradient)
    d, _ = _mesh_run()
    assert d.check()["replica_gap"] > _limits()["replica_gap"]
