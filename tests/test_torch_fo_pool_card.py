"""The fo-pool kernel (csrc/fo_pool.cu) on a CUDA card against its plain
version (kernels/fo_pool.py, run on the same card's tensors), at the
benchmark's shapes: B 128, T 52 and 13 (the two tiers of frame sizes
(20, 4) over 1040 samples), H 1024, forward and backward, in bfloat16 and
float32; and the launch counters.

Tolerances, each with its reason: float32 outputs 1e-5 absolute and
relative (the kernel's tanhf / expf and fused multiply-adds against
PyTorch's own kernels, a few ulp a step, carried through a sum that
forgets: |f| < 1); bfloat16 outputs one bfloat16 ulp (2^-7 relative, the
float32 values equal to that tolerance may round to neighbours), their
float32 cells as float32's.

Torch and the port only (no JAX), so that it runs where JAX is absent; on
the card: `python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_fo_pool_card.py` (the suite's conftest imports JAX).
Without a card every case skips.
"""

import pytest
import torch

from msnv_tpu_torch.kernels import fo_pool as fp

pytestmark = pytest.mark.cuda
F32 = {"rtol": 1e-5, "atol": 1e-5}
TOL = {torch.float32: F32, torch.bfloat16: {"rtol": 2 ** -7, "atol": 1e-5}}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (there: python3 -m pytest "
                    "--noconftest tests/test_torch_fo_pool_card.py)")
    return torch.device("cuda")


def _inputs(T, dtype, device, B=128, H=1024):
    g = torch.Generator().manual_seed(T)
    return (torch.randn(B, T, 3 * H, generator=g).to(device, dtype),
            torch.randn(B, H, generator=g).to(device),
            torch.randn(B, T, H, generator=g).to(device, dtype),
            torch.randn(B, H, generator=g).to(device))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [52, 13])
def test_kernel_matches_the_plain_version(card, T, dtype):
    g, c0, dh, dcT = _inputs(T, dtype, card)
    h, cs, cT = fp.fo_pool_forward(g, c0)
    rh, rcs, rcT = fp.fo_pool_reference(g, c0)
    torch.testing.assert_close(h, rh, **TOL[dtype])
    torch.testing.assert_close(cs, rcs, **F32)
    torch.testing.assert_close(cT, rcT, **F32)
    for d in (None, dcT):
        dg, dc0 = fp.fo_pool_backward(g, c0, cs, dh, d)
        rdg, rdc0 = fp.fo_pool_backward_reference(g, c0, rcs, dh, d)
        torch.testing.assert_close(dg, rdg, **TOL[dtype])
        torch.testing.assert_close(dc0, rdc0, **F32)
    torch.cuda.synchronize(card)


def test_autograd_launches_one_kernel_each_way(card):
    g, c0, dh, _ = _inputs(13, torch.bfloat16, card)
    g.requires_grad_(True)
    counts = [(w.launches, w.elements)
              for w in (fp.fo_pool_forward, fp.fo_pool_backward)]
    h, cT = fp.fo_pool(g, c0)
    (h.float() * dh.float()).sum().backward()
    torch.cuda.synchronize(card)
    n = 128 * 13 * 1024
    assert [(w.launches, w.elements)
            for w in (fp.fo_pool_forward, fp.fo_pool_backward)] == \
        [(a + 1, e + n) for a, e in counts]
    rdg, _ = fp.fo_pool_backward_reference(
        g.detach(), c0, fp.fo_pool_reference(g.detach(), c0)[1], dh)
    torch.testing.assert_close(g.grad, rdg, **TOL[torch.bfloat16])


def test_inputs_are_checked(card):
    g, c0, dh, _ = _inputs(13, torch.bfloat16, card, B=2, H=128)
    with pytest.raises(TypeError, match="float32"):
        fp.fo_pool_forward(g, c0.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        fp.fo_pool_forward(g.transpose(0, 1).contiguous().transpose(0, 1),
                           c0)
    with pytest.raises(TypeError, match="g's type"):
        fp.fo_pool_backward(g, c0, fp.fo_pool_forward(g, c0)[1],
                            dh.float())
