"""A run whose timed path is broken underneath comes out not correct, and a
sound run of the same tiny cell comes out correct: the harness's look for a
chip skipped (the tiny cells run on the CPU through the same drivers and
references as the real ones), each fault planted in the port where the
cell's path produces it."""

import pytest
import torch

import h100bench_tiny as tiny
from h100_bench import harness


def _token_altered(monkeypatch):
    """One sample of every window, every lane, one level off."""
    import msnv_tpu_torch.models.generate as gen
    orig = gen.sample_window

    def altered(table, wh, bh, wo, bo, slots, buf, **kw):
        out = orig(table, wh, bh, wo, bo, slots, buf, **kw)
        out[:, -1] = (out[:, -1] + 1) % wo.shape[1]
        return out

    monkeypatch.setattr(gen, "sample_window", altered)


def _half_the_lanes(monkeypatch):
    """The window drawn for half of the lanes; the others get silence."""
    import msnv_tpu_torch.models.generate as gen
    orig = gen.sample_window

    def half(table, wh, bh, wo, bo, slots, buf, **kw):
        out = orig(table, wh, bh, wo, bo, slots, buf, **kw)
        out[out.shape[0] // 2:] = wo.shape[1] // 2
        return out

    monkeypatch.setattr(gen, "sample_window", half)


def _state_unchanged_gen(monkeypatch):
    """A tier's recurrent step that returns its state unchanged."""
    import msnv_tpu_torch.models.generate as gen
    orig = gen.rnn_cell

    def frozen(cfg, params, x, h):
        y, _ = orig(cfg, params, x, h)
        return y, h

    monkeypatch.setattr(gen, "rnn_cell", frozen)


def _update_skipped(monkeypatch):
    """A train step that returns its state (params, moments) unchanged."""
    from msnv_tpu_torch.training.optim import ClippedAdam
    monkeypatch.setattr(ClippedAdam, "update",
                        lambda self, grads, state, params: (params, state))


def _gradient_dropped(monkeypatch):
    """One gradient leaf (a GRU's recurrent weight) lost where the
    backward produces it."""
    from msnv_tpu_torch.training.optim import ClippedAdam
    orig = ClippedAdam.update

    def dropped(self, grads, state, params):
        if "tiers" in grads:
            w = grads["tiers"][0]["gru"][0]["w_hh"]
            grads["tiers"][0]["gru"][0]["w_hh"] = torch.zeros_like(w)
        return orig(self, grads, state, params)

    monkeypatch.setattr(ClippedAdam, "update", dropped)


def _half_the_batch(monkeypatch):
    """The loss's mean taken over half of the batch."""
    import msnv_tpu_torch.training.gan as gan
    import msnv_tpu_torch.training.step as step
    orig = step.nll_bits_from_logits

    def half(logits, target):
        n = logits.shape[0] // 2
        return orig(logits[:n], target[:n])

    monkeypatch.setattr(step, "nll_bits_from_logits", half)
    monkeypatch.setattr(gan, "nll_bits_from_logits", half)


GEN_FAULTS = {"token_altered": _token_altered,
              "half_the_lanes": _half_the_lanes,
              "state_unchanged": _state_unchanged_gen}
TRAIN_FAULTS = {"update_skipped": _update_skipped,
                "gradient_dropped": _gradient_dropped,
                "half_the_batch": _half_the_batch}
CASES = ([("tiny.gen", f) for f in GEN_FAULTS]
         + [("tiny.stream", f) for f in GEN_FAULTS]
         + [("tiny.train", f) for f in TRAIN_FAULTS]
         + [("tiny_gan.train", f) for f in TRAIN_FAULTS])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("bench"))


def _run(root, cell, monkeypatch):
    if cell == "tiny.stream":
        tiny.mux_on_window_path(monkeypatch)
    torch.manual_seed(0)
    return harness.run_cell(cell, tiny.SEED, 1.0, False, "cpu", root)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(root, cell, monkeypatch):
    out = _run(root, cell, monkeypatch)
    assert out["correct"], out["checks"]
    if cell != "tiny.stream":
        # streams the multiplexer refuses under the CPU's load are failed
        # requests, not faults: `failed` counts them, `correct` does not
        assert out["failed"] == 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    (GEN_FAULTS | TRAIN_FAULTS)[fault](monkeypatch)
    out = _run(root, cell, monkeypatch)
    assert not out["correct"], out["checks"]
