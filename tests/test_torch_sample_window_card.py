"""Sample windows on a CUDA card. At widths that neither the resident nor
the grid kernel holds, the wrapper refuses the window with an error that
names its widths, in both noise modes, and counts no launch; packing the
weights for a sampler is refused the same way. The resident kernel, at
every width of a pass its plan takes, draws the plain version's samples
bit for bit on inputs whose sums are exact in float32 (so that no order of
adding them can change a bit), in both noise modes, also where a logit's
parts come in rounds (q 512 and 1024); one launch adds its
lanes and passes to the counters as the plan says.

Torch and the port only (no JAX), so that it runs where JAX is absent; on
the card: `python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_sample_window_card.py` (the suite's conftest imports
JAX). Without a card every case skips.
"""

import pytest
import torch

from msnv_tpu_torch.kernels import sample_window as sw

pytestmark = pytest.mark.cuda
COUNTERS = ("launches", "resident", "grid", "lanes", "passes")
# (weights' type, dim, q): no cluster splits dim in tiles of 16 columns
# and no power-of-two CTA slice holds it, or q is no power of two
ODD = [(torch.bfloat16, 640, 256), (torch.float32, 768, 256),
       (torch.float32, 1024, 200)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (there: python3 -m pytest "
                    "--noconftest tests/test_torch_sample_window_card.py)")
    return torch.device("cuda")


def _inputs(dtype, dim, q, device, fs0=4, batch=5):
    g = torch.Generator().manual_seed(dim + q)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)
    return (rn(fs0 * q, dim, scale=0.5).to(dtype),
            rn(dim, dim, scale=dim ** -0.5).to(dtype), rn(dim, scale=0.1),
            rn(dim, q, scale=dim ** -0.5).to(dtype), rn(q, scale=0.1),
            rn(batch, fs0, dim).to(dtype),
            torch.randint(0, q, (batch, fs0), generator=g,
                          dtype=torch.int32).to(device))


@pytest.mark.parametrize("dtype,dim,q", ODD)
def test_a_width_no_kernel_takes_is_refused(card, dtype, dim, q):
    args = _inputs(dtype, dim, q, card)
    batch, fs0 = args[-1].shape
    want = f"no kernel takes a window of {dtype} weights at dim {dim}, q {q}"
    before = [getattr(sw.sample_window, k) for k in COUNTERS]
    with pytest.raises(ValueError, match=want):
        sw.resident_weights(args[1], args[3], fs0)
    with pytest.raises(ValueError, match=want):
        sw.sample_window(*args, noise=sw.gumbel_noise((batch, fs0, q),
                                                      device=card))
    with pytest.raises(ValueError, match=want):
        sw.sample_window(*args, seed=torch.tensor([3], dtype=torch.int64,
                                                  device=card))
    torch.cuda.synchronize()
    assert [getattr(sw.sample_window, k) for k in COUNTERS] == before


# (fs0, dim, B, q): the canonical shape at batches the plan walks through in
# passes of every width (on an H100 granting 7 clusters of 16: 8 up to 56
# lanes, 16 at 100, 24 at 128 and 147, 32 at 1024), and the three-tier
# model's windows; then q other than 256: at q 128 a logit has two parts
# from each CTA (its depth split over two warps), and at q 512 and 1024 the
# parts come in rounds (2, 2 to 4, 2 to 8 by width)
EXACT = [(20, 1024, b, 256) for b in (1, 8, 19, 24, 32, 33, 100, 147, 1024)] \
    + [(4, 512, 128, 256)] \
    + [(4, 512, b, 128) for b in (1, 128)] \
    + [(20, 1024, b, 512) for b in (1, 100, 300)] \
    + [(4, 768, b, 1024) for b in (8, 140)] \
    + [(20, 512, b, 1024) for b in (8, 256)]
Q = 256


def _exact_id(case):
    fs0, dim, batch, q = case
    return f"{fs0}-{dim}-{batch}" + ("" if q == Q else f"-q{q}")


def _exact_inputs(fs0, dim, batch, device, q=Q):
    """Window inputs on a grid of powers of two so that every sum the
    kernel and the plain version take is exact in float32: table and slot
    rows in {-1, 0, 1} / 8, W_h and W_o in {-1, 0, 1} / 32 (three in four
    zero), biases on the grid of their sums. Asserts the bound that makes
    every partial sum exact, in any order."""
    g = torch.Generator().manual_seed(fs0 * dim + batch)

    def grid(*shape, scale, zeros=0.0):
        v = torch.randint(-1, 2, shape, generator=g).float()
        if zeros:
            v = v * (torch.rand(shape, generator=g) >= zeros)
        return v * scale
    table = grid(fs0 * q, dim, scale=1 / 8)
    slots = grid(batch, fs0, dim, scale=1 / 8)
    wh = grid(dim, dim, scale=1 / 32, zeros=0.75)
    wo = grid(dim, q, scale=1 / 32, zeros=0.75)
    bh = grid(dim, scale=1 / 256)
    bo = grid(q, scale=1 / 8192)
    # x: multiples of 1/8 up to fs0 + 1 eighths, exact in bf16; h: sums
    # of x * W_h on a grid of 1/256, then rounded to bf16 (still on it);
    # the logits on a grid of 1/8192. A partial sum is exact while its
    # magnitude stays below 2^24 grid steps.
    x_max = (fs0 + 1) / 8
    h_max = float(x_max * wh.abs().sum(0).max() + bh.abs().max())
    logit_max = float(h_max * wo.abs().sum(0).max() + bo.abs().max())
    assert x_max * 8 < 256 and h_max * 256 < 2 ** 24
    assert logit_max * 8192 < 2 ** 24
    buf = torch.randint(0, q, (batch, fs0), generator=g, dtype=torch.int32)
    bf16 = torch.bfloat16
    return tuple(t.to(device) for t in (
        table.to(bf16), wh.to(bf16), bh, wo.to(bf16), bo, slots.to(bf16),
        buf))


@pytest.mark.parametrize("mode", ["noise", "seed"])
@pytest.mark.parametrize("fs0,dim,batch,q", EXACT,
                         ids=[_exact_id(c) for c in EXACT])
def test_resident_equals_the_plain_version_bit_for_bit(card, fs0, dim,
                                                       batch, q, mode):
    args = _exact_inputs(fs0, dim, batch, card, q)
    noise = sw.gumbel_noise((batch, fs0, q),
                            torch.Generator(device=card).manual_seed(batch),
                            card)
    seed = torch.tensor([batch + 11], dtype=torch.int64, device=card)
    plan = sw._plan_on(card, batch, fs0, q, dim, torch.bfloat16)
    assert plan.path == "resident"
    rounds = sw.resident_rounds(fs0, q, dim, plan.cluster, plan.subtile)
    assert (rounds > 1) == (q >= 512), rounds
    before = sw.sample_window.resident
    if mode == "noise":
        got = sw.sample_window(*args, noise=noise)
    else:
        got = sw.sample_window(*args, seed=seed)
        noise = sw.philox_gumbel_noise(seed, batch, fs0, q)
    want = sw.sample_window_reference(*args, noise)
    torch.cuda.synchronize()
    assert sw.sample_window.resident == before + 1
    assert torch.equal(got, want), (
        f"passes of {plan.subtile}: "
        f"{float((got != want).float().mean()):.4%} of the samples differ")
    # the draws are not all alike
    assert int(torch.unique(got).numel()) > min(q // 4, batch * fs0 // 4)


@pytest.mark.parametrize("fs0,dim,batch", [(20, 1024, 1), (20, 1024, 128),
                                           (20, 1024, 1024), (4, 512, 128)])
def test_a_launch_counts_its_lanes_and_passes(card, fs0, dim, batch):
    args = _exact_inputs(fs0, dim, batch, card)
    plan = sw._plan_on(card, batch, fs0, Q, dim, torch.bfloat16)
    before = {k: getattr(sw.sample_window, k) for k in COUNTERS}
    sw.sample_window(*args, seed=torch.tensor([3], dtype=torch.int64,
                                              device=card))
    torch.cuda.synchronize()
    passes = -(-plan.lanes_per_cluster // plan.subtile)
    assert passes == sw.plan_passes(plan)
    want = {"launches": 1, "resident": 1, "grid": 0, "lanes": batch,
            "passes": plan.clusters * passes}
    assert {k: getattr(sw.sample_window, k) - before[k]
            for k in COUNTERS} == want
