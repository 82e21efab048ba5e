"""Fused fo-pool of a QRNN layer (training path): wrapper, plain versions
and build.

The kernels (msnv_tpu_torch/csrc/fo_pool.cu) replace no TPU kernel: the JAX
package runs the recurrence of ops/qrnn.py as a scan of elementwise steps.
They do one layer's sweep over T in one launch each way: the forward takes
the gate pre-activations g (B, T, 3H), gate order [z, f, o], and the
carried cell c0 (B, H), applies the gates' activations, pools

    c_t = f_t c_{t-1} + (1 - f_t) z_t,    h_t = o_t c_t,

and writes h (B, T, H) in g's type, every c_t (float32, for the backward)
and c_T; the backward walks t in reverse from dh (and dc_T) to dg and dc0.
c is carried in float32. What bounds them is bytes (12 B an element
forward, 18 B backward, in bfloat16); see the source's header.

On CPU tensors `fo_pool` runs the plain versions (`fo_pool_reference`,
`fo_pool_backward_reference`), in float32 or wider; on CUDA tensors it
launches the kernels or raises. `fo_pool_forward.launches` /
`fo_pool_backward.launches` count the kernels launched (one a layer's sweep
each way), `.elements` the B x T x H elements they walked. While a
torch.profiler records, each call of `fo_pool` is the span `qrnn.pool`
(utils/profiling.py).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from msnv_tpu_torch.kernels.build import CSRC, build_library
from msnv_tpu_torch.utils import profiling

SOURCE = CSRC / "fo_pool.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COUNTERS = ("launches", "elements")

_lib = None
_lib_lock = threading.Lock()
build_log = ""      # nvcc's -Xptxas -v report of the last build


def build() -> ctypes.CDLL:
    """Compile the kernels for sm_90a (once per source content) and load
    them; a plain C interface, bound with ctypes."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = build_library(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fo_pool_fwd_launch.argtypes = [ci] + [vp] * 5 + [ci] * 3 + [vp]
        lib.fo_pool_fwd_launch.restype = ci
        lib.fo_pool_bwd_launch.argtypes = [ci] + [vp] * 7 + [ci] * 3 + [vp]
        lib.fo_pool_bwd_launch.restype = ci
        lib.fo_pool_error_string.argtypes = [ci]
        lib.fo_pool_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _gates(g, H):
    """Activations of g's [z, f, o] in float32 (or g's type, if wider)."""
    a = g.to(torch.promote_types(g.dtype, torch.float32))
    return (torch.tanh(a[..., :H]), torch.sigmoid(a[..., H:2 * H]),
            torch.sigmoid(a[..., 2 * H:]))


def fo_pool_reference(g, c0):
    """The forward's plain version -> (h (B, T, H) in g's type, cs (B, T, H)
    every c_t, cT (B, H)), c in float32 or wider."""
    H = c0.shape[-1]
    z, f, o = _gates(g, H)
    c = c0.to(z.dtype)
    cs = []
    for t in range(g.shape[1]):
        c = f[:, t] * c + (1.0 - f[:, t]) * z[:, t]
        cs.append(c)
    cs = torch.stack(cs, dim=1)
    return (o * cs).to(g.dtype), cs, c


def fo_pool_backward_reference(g, c0, cs, dh, dcT=None):
    """The backward's plain version -> (dg (B, T, 3H) in g's type, dc0),
    from the forward's cs and the cotangents dh (B, T, H) and dc_T (B, H)
    or None."""
    H = c0.shape[-1]
    z, f, o = _gates(g, H)
    dh = dh.to(z.dtype)
    c_prev = torch.cat([c0.to(z.dtype)[:, None], cs[:, :-1]], dim=1)
    dc = torch.zeros_like(c0, dtype=z.dtype) if dcT is None \
        else dcT.to(z.dtype)
    dcs = [None] * g.shape[1]
    for t in range(g.shape[1] - 1, -1, -1):
        dc = dc + dh[:, t] * o[:, t]
        dcs[t] = dc
        dc = dc * f[:, t]
    dc_t = torch.stack(dcs, dim=1)      # the cotangent of each c_t
    dz = dc_t * (1.0 - f) * (1.0 - z * z)
    df = dc_t * (c_prev - z) * f * (1.0 - f)
    do = dh * cs * o * (1.0 - o)
    return torch.cat([dz, df, do], dim=-1).to(g.dtype), dc


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check(g, c0):
    if g.dim() != 3 or c0.dim() != 2:
        raise ValueError("g must be (B, T, 3H) and c0 (B, H)")
    B, T, H3 = g.shape
    H = c0.shape[1]
    if H3 != 3 * H or c0.shape[0] != B:
        raise ValueError(f"g {tuple(g.shape)} does not match c0 "
                         f"{tuple(c0.shape)}")
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"empty sweep: B={B}, T={T}, H={H}")
    return B, T, H


def _check_cuda(g, floats, same_type=()):
    if g.dtype not in _DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    for t in (g,) + tuple(floats) + tuple(same_type):
        if t.device != g.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"c0, cs and dc_T must be float32, got {t.dtype}")
    for t in same_type:
        if t.dtype != g.dtype:
            raise TypeError(f"dh must be in g's type {g.dtype}, got "
                            f"{t.dtype}")


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.fo_pool_error_string(err).decode())


def _count(wrapper, B, T, H):
    wrapper.launches += 1
    wrapper.elements += B * T * H


def fo_pool_forward(g, c0, with_cs=True):
    """The forward sweep -> (h (B, T, H) in g's type, cs (B, T, H) float32
    or None, cT (B, H) float32). CPU tensors take the plain version; CUDA
    tensors launch the kernel (g float32 or bfloat16, c0 float32, both
    contiguous)."""
    B, T, H = _check(g, c0)
    if g.device.type == "cpu":
        h, cs, cT = fo_pool_reference(g, c0)
        return h, (cs if with_cs else None), cT
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    _check_cuda(g, (c0,))
    lib = build()
    h = torch.empty((B, T, H), dtype=g.dtype, device=g.device)
    cs = (torch.empty((B, T, H), dtype=torch.float32, device=g.device)
          if with_cs else None)
    cT = torch.empty((B, H), dtype=torch.float32, device=g.device)
    err = lib.fo_pool_fwd_launch(
        _DTYPES[g.dtype], g.data_ptr(), c0.data_ptr(), h.data_ptr(),
        None if cs is None else cs.data_ptr(), cT.data_ptr(), B, T, H,
        torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(lib, err, "fo_pool forward")
    _count(fo_pool_forward, B, T, H)
    return h, cs, cT


def fo_pool_backward(g, c0, cs, dh, dcT=None):
    """The reverse sweep -> (dg (B, T, 3H) in g's type, dc0 (B, H)
    float32). CPU tensors take the plain version; CUDA tensors launch the
    kernel (dh in g's type; c0, cs and dcT float32; all contiguous)."""
    B, T, H = _check(g, c0)
    if g.device.type == "cpu":
        return fo_pool_backward_reference(g, c0, cs, dh, dcT)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    _check_cuda(g, (c0, cs) + (() if dcT is None else (dcT,)), (dh,))
    lib = build()
    dg = torch.empty_like(g)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=g.device)
    err = lib.fo_pool_bwd_launch(
        _DTYPES[g.dtype], g.data_ptr(), c0.data_ptr(), cs.data_ptr(),
        dh.data_ptr(), None if dcT is None else dcT.data_ptr(),
        dg.data_ptr(), dc0.data_ptr(), B, T, H,
        torch.cuda.current_stream(g.device).cuda_stream)
    _raise_on(lib, err, "fo_pool backward")
    _count(fo_pool_backward, B, T, H)
    return dg, dc0


for _wrapper in (fo_pool_forward, fo_pool_backward):
    for _name in COUNTERS:
        setattr(_wrapper, _name, 0)


class _FoPool(torch.autograd.Function):
    """h, cT = fo-pool of g from c0; the backward is the reverse sweep."""

    @staticmethod
    def forward(ctx, g, c0):
        # an output no loss reads (c_T, where it only feeds the detached
        # carried state) reaches backward as None, not as zeros to read
        ctx.set_materialize_grads(False)
        train = any(ctx.needs_input_grad)
        h, cs, cT = fo_pool_forward(g, c0, with_cs=train)
        if train:
            ctx.save_for_backward(g, c0, cs)
        return h, cT

    @staticmethod
    def backward(ctx, dh, dcT):
        g, c0, cs = ctx.saved_tensors
        dh = (torch.zeros(g.shape[:2] + c0.shape[1:], dtype=g.dtype,
                          device=g.device) if dh is None
              else dh.to(g.dtype).contiguous())
        if dcT is not None:
            dcT = dcT.to(cs.dtype).contiguous()
        dg, dc0 = fo_pool_backward(g, c0, cs, dh, dcT)
        return dg, dc0.to(c0.dtype)


def fo_pool(g, c0):
    """Fused fo-pool -> (h (B, T, H) in g's type, cT (B, H) float32, or
    c0's type if wider), differentiable in g and c0. g (B, T, 3H): the gate
    pre-activations [z, f, o]; c0 (B, H): the carried cell, taken in
    float32 (or wider)."""
    c0 = c0.to(torch.promote_types(c0.dtype, torch.float32)).contiguous()
    with profiling.span("qrnn.pool"):
        return _FoPool.apply(g.contiguous(), c0)
