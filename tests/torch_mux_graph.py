"""The multiplexer's carry at fixed addresses, and on a card its graphed
push, held against the pure form: the same splices and masked pushes
applied by rebinding a carry (`_attach_many`, `_masked_push`, which leave
their input as it is), from a generator seeded alike.

Torch and the port only (no JAX), so that the card's checks run where JAX
is absent: tests/test_torch_serving_mux.py calls these on the CPU and,
where a card is present, on it; on the card `PYTHONPATH=. python3
tests/torch_mux_graph.py [preset ...]` runs the card's checks alone, at
the widths of each preset named (default: samplernn).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from msnv_tpu_torch.config import preset
from msnv_tpu_torch.kernels.sample_window import sample_window
from msnv_tpu_torch.models.samplernn import init_params
from msnv_tpu_torch.serving import StreamMultiplexer
from msnv_tpu_torch.serving.mux import _PushGraph, _tensors, _window_counts

# the ticks where streams arrive (acquire; a speaker id, modulo the
# model's speakers, or "mix": a row of mix weights) or leave (release): two
# attach at tick 0, a third while they run, one leaves and its lane is
# taken again by the next arrival
ARRIVE = {0: [0, "mix"], 3: [2], 7: ["mix"]}
LEAVE = {6: 1}            # tick -> index of the stream (in arrival order)
TICKS = 12


def card_model(name="samplernn"):
    """A benchmark configuration's widths (`preset(name)`), its weights
    drawn on the CPU and moved to the card."""
    cfg = preset(name).model
    return init_params(cfg, torch.Generator().manual_seed(0),
                       device="cuda"), cfg


def _snapshot(carry):
    return ([t.clone() for t in _tensors(carry)],
            carry[3].get_state().clone())


def sequence(params, cfg, lanes=4, K=2, temperature=1.0, seed=3):
    """Drive a multiplexer through the pump's steps (`_flush_attaches`,
    `_tick`) over TICKS ticks of ARRIVE / LEAVE, every occupied lane
    active except one frozen lane every third tick; beside it, the same
    splices and pushes applied by rebinding a carry of its own. Returns a
    dict: per tick the audio of both and the data_ptr of every carry
    tensor, the final carries and generator states, ticks, replays and
    the windows counted."""
    mux = StreamMultiplexer(params, cfg, lanes=lanes, frames_per_push=K,
                            temperature=temperature, seed=seed)
    dev = mux.device
    C = cfg.effective_cond_dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    ref = mux._init_state(lanes, torch.zeros((lanes,), dtype=torch.int64,
                                             device=dev), gen)
    rng = np.random.RandomState(seed)
    held = []                          # lanes in arrival order (or None)
    out = {"audio": [], "ref_audio": [], "windows": [],
           "ptrs": [[t.data_ptr() for t in _tensors(mux._carry)]]}
    for tick in range(TICKS):
        if tick in LEAVE:
            mux.release(held[LEAVE[tick]])
            held[LEAVE[tick]] = None
        for spk in ARRIVE.get(tick, []):
            mix = rng.dirichlet(np.ones(cfg.spk_dim))[None].astype(np.float32)
            held.append(mux.acquire(
                mix if spk == "mix"
                else np.asarray([spk % cfg.spk_dim], np.int32)))
        with mux._cv:
            attach, mux._pending_attach = mux._pending_attach, set()
        active = np.zeros((lanes,), bool)
        live = [lane for lane in held if lane is not None]
        active[live] = True
        if tick % 3 == 2:
            active[live[0]] = False
        cond = rng.rand(lanes, K, C).astype(np.float32)
        with mux._carry_lock, mux._device_lock:
            mux._flush_attaches(attach)
            out["ptrs"].append([t.data_ptr() for t in _tensors(mux._carry)])
            launches = sample_window.launches
            audio = mux._tick(cond, active)
            out["windows"].append(sample_window.launches - launches)
        out["audio"].append(audio.cpu().numpy())
        out["ptrs"].append([t.data_ptr() for t in _tensors(mux._carry)])
        if attach:
            mask = np.zeros((lanes,), bool)
            mask[list(attach)] = True
            ref = mux._attach_many(ref, torch.from_numpy(mask).to(dev),
                                   torch.from_numpy(
                                       mux._spk_rows.copy()).to(dev))
        ref, ref_audio = mux._masked_push(
            ref, torch.from_numpy(cond).to(dev),
            torch.from_numpy(active).to(dev))
        out["ref_audio"].append(ref_audio.cpu().numpy())
    out.update(carry=_snapshot(mux._carry), ref_carry=_snapshot(ref),
               ticks=mux.ticks, replays=mux.replays, mux=mux)
    return out


def same_as_rebinding(run):
    """The fixed carry gave the rebinding form's audio and state exactly,
    and kept its tensors' addresses at every tick."""
    for tick, (a, b) in enumerate(zip(run["audio"], run["ref_audio"])):
        np.testing.assert_array_equal(a, b, err_msg=f"tick {tick}")
    (tensors, state), (ref_tensors, ref_state) = (run["carry"],
                                                   run["ref_carry"])
    for t, r in zip(tensors, ref_tensors):
        assert torch.equal(t, r)
    assert torch.equal(state, ref_state)
    assert all(p == run["ptrs"][0] for p in run["ptrs"])


def capture_leaves_state(params, cfg, lanes=8, K=4):
    """Making the graph draws nothing from the carry's generator, leaves
    the carry and the window counters as they were; one replay then adds
    the windows of one push (K x lookback / fs0), and to every counter
    (resident launches, their lanes and passes) what one eager push adds,
    and advances the generator as one eager push does."""
    mux = StreamMultiplexer(params, cfg, lanes=lanes, frames_per_push=K,
                            seed=5)
    lane = mux.acquire(np.asarray([1 % cfg.spk_dim], np.int32))
    with mux._carry_lock, mux._device_lock:
        mux._flush_attaches({lane})
    tensors, state = _snapshot(mux._carry)
    counts = _window_counts()
    launches = sample_window.launches
    graph = _PushGraph(mux)
    torch.cuda.synchronize()
    after, after_state = _snapshot(mux._carry)
    assert all(torch.equal(a, b) for a, b in zip(after, tensors))
    assert torch.equal(after_state, state)
    assert _window_counts() == counts
    eager = torch.Generator(device=mux.device)
    eager.set_state(state)
    mux._masked_push(mux._carry[:3] + (eager,), graph.cond, graph.active)
    windows = K * cfg.lookback // cfg.frame_sizes[0]
    assert sample_window.launches == launches + windows
    pushed = {k: n - counts[k] for k, n in _window_counts().items()}
    assert pushed["resident"] == windows and pushed["grid"] == 0
    assert pushed["lanes"] == windows * lanes and pushed["passes"] > 0
    cond = np.zeros((lanes, K, cfg.effective_cond_dim), np.float32)
    active = np.zeros((lanes,), bool)
    active[lane] = True
    graph.replay(cond, active)
    torch.cuda.synchronize()
    assert sample_window.launches == launches + 2 * windows
    assert _window_counts() == {k: n + 2 * pushed[k]
                                for k, n in counts.items()}
    assert torch.equal(mux._generator.get_state(), eager.get_state())


def graphed_same_as_eager(params, cfg, temperature):
    """On the card: the graphed multiplexer against eager pushes, over the
    sequence, at the benchmark's K."""
    run = sequence(params, cfg, lanes=8, K=4, temperature=temperature)
    same_as_rebinding(run)
    assert run["ticks"] == run["replays"] == TICKS
    windows = 4 * cfg.lookback // cfg.frame_sizes[0] if temperature else 0
    assert run["windows"] == [windows] * TICKS


def main(names):
    for name in names or ["samplernn"]:
        params, cfg = card_model(name)
        for temperature in (1.0, 0.0):
            graphed_same_as_eager(params, cfg, temperature)
            print(f"{name}: graphed mux == eager pushes at T {temperature}",
                  flush=True)
        capture_leaves_state(params, cfg)
        print(f"{name}: capture leaves the generator, the carry and the "
              f"counters", flush=True)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
