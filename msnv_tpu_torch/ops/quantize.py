"""Audio quantizers: mu-law companding and linear, on torch tensors.

Port of the JAX package's ops/quantize.py (same constants and formulas, ref
utils.py:9-63). Inputs may be tensors or anything `torch.as_tensor` takes.

Reference-parity quirks, deliberately preserved:
- input exactly +1.0 overflows uquantize to level q (ref utils.py:48-51).
- quantize(dequantize(level)) is not idempotent: the midrise `q - 1e-6`
  epsilon drops exact bin-edge values one level.
"""

from __future__ import annotations

import torch

MU = 255.0
LOG_MU1 = 5.5451774444795623  # log(1 + MU), ref utils.py:30-31
_EPS_LINEAR = 1e-2            # ref utils.py:6
_EPS_MIDRISE = 1e-6           # ref utils.py:45


def _float(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def ulaw(x, max_value: float = 1.0):
    """Mu-law compand x in [-max_value, max_value] to y in [-1, 1]."""
    x = _float(x)
    v = MU / max_value
    return torch.sign(x) * torch.log1p(v * torch.abs(x)) / LOG_MU1


def iulaw(c, max_value: float = 1.0):
    """Inverse mu-law expand (ref utils.py:39-42)."""
    c = _float(c)
    x = torch.expm1(torch.abs(c) * LOG_MU1)
    return torch.sign(c) * x / MU


def midrise(x, q_levels: int = 256):
    """Map x in [-1, 1] to integer levels {0, ..., q_levels-1}
    (0.5*(x+1) * (q_levels - 1e-6), floored)."""
    x = _float(x)
    y = 0.5 * (x + 1.0) * (q_levels - _EPS_MIDRISE)
    return torch.floor(y).to(torch.int32)


def imidrise(xq, q_levels: int = 256):
    """Integer levels back to [-1, 1) (ref utils.py:54-55)."""
    return torch.as_tensor(xq).to(torch.float32) * 2.0 / q_levels - 1.0


def uquantize(samples, q_levels: int = 256):
    """Default audio quantizer: mu-law then midrise (ref utils.py:58-59)."""
    return midrise(ulaw(samples), q_levels)


def udequantize(samples, q_levels: int = 256):
    """Inverse of uquantize (ref utils.py:62-63)."""
    return iulaw(imidrise(samples, q_levels))


def q_zero(q_levels: int = 256) -> int:
    """The quantization level representing silence (ref utils.py:22-23)."""
    return q_levels // 2


def linear_quantize(samples, q_levels: int = 256):
    """Per-sequence min/max linear quantizer (ref utils.py:9-15)."""
    samples = torch.as_tensor(samples).to(torch.float32)
    mn = torch.amin(samples, dim=-1, keepdim=True)
    mx = torch.amax(samples - mn, dim=-1, keepdim=True)
    y = (samples - mn) / mx
    y = y * (q_levels - _EPS_LINEAR) + _EPS_LINEAR / 2
    return torch.floor(y).to(torch.int32)


def linear_dequantize(samples, q_levels: int = 256):
    """Levels to [-1, 1) (ref utils.py:18-19)."""
    return torch.as_tensor(samples).to(torch.float32) / (q_levels / 2) - 1.0
