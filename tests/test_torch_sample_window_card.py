"""Sample windows that no kernel takes, on a CUDA card: at widths that
neither the resident nor the grid kernel holds, the wrapper refuses the
window with an error that names its widths, in both noise modes, and
counts no launch; packing the weights for a sampler is refused the same
way.

Torch and the port only (no JAX), so that it runs where JAX is absent; on
the card: `python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_sample_window_card.py` (the suite's conftest imports
JAX). Without a card every case skips.
"""

import pytest
import torch

from msnv_tpu_torch.kernels import sample_window as sw

pytestmark = pytest.mark.cuda
COUNTERS = ("launches", "resident", "grid")
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
