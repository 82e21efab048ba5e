"""Fused GRU layer (training path): wrapper, plain versions and build.

The kernels (msnv_tpu_torch/csrc/gru_layer.cu) replace the TPU kernels of
the JAX package's pallas/gru_kernel.py: `_fwd_kernel` (reached through
`_fwd_impl`) and `_bwd_kernel` (reached through `_gru_layer_bwd`). They run
the recurrent sweep of ONE GRU layer over all T timesteps: the forward
computes, per step, `hproj = h @ W_hh^T + b_hh` and the gate math and emits
`ys` (and `hproj` for training); the backward sweeps in reverse, recomputes
the gates from the saved `x_proj`, `hproj` and `h_prev`, and emits `dxp`,
`dhproj` and `dh0`. As in the JAX package the input projection happens
outside (one large matmul), and so do the time-parallel reductions of the
backward: `dw = einsum("tbh,tbg->hg", h_prev, dhproj)` and
`db = dhproj.sum((0, 1))`.

What bounds them on the H100, and what the design does about it: per step
the product is small (0.8 GFLOP at B 128, H 1024, with the 6 MB bf16 weight
L2-resident), so the dependence between steps and the launch per step bound
a layer, not bytes or operations. The design is one launch per timestep,
all enqueued by one C call, with the product inside a launch on the tensor
cores for bfloat16 operands (warp-level mma over a ring of cp.async stages)
and as an exact FMA loop for float32 ones (see the source's header).

Layouts (the JAX kernel's): x_proj (T, B, 3H) f32 incl. b_ih, gate order
[r, z, n]; w_hh_t (H, 3H); b_hh (3H,); h0 (B, H). Returns (ys (T, B, H),
hT (B, H)), float32. `mxu_dtype` is the type both operands of the
recurrent products are rounded to (sums are float32): torch.bfloat16 on the
mixed-precision train path, torch.float32 for exactness. On a GPU H must be
a multiple of 128 for bfloat16 products and of 32 for float32 ones.

On CPU tensors `gru_layer` runs the plain versions (`gru_layer_reference`,
`gru_layer_backward_reference`); on CUDA tensors it launches the kernels or
raises. `gru_layer_forward.launches` / `gru_layer_backward.launches` count
the wrapper calls that launched (one per layer sweep, T resp. T + 1 kernel
launches each).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from msnv_tpu_torch.kernels.build import CSRC, build_library

SOURCE = CSRC / "gru_layer.cu"
# H must be a multiple of the kernels' chunk depth: 32 for float32 products
# (FMA), 128 for bfloat16 products (tensor cores)
H_MULTIPLE = {torch.float32: 32, torch.bfloat16: 128}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()
build_log = ""      # nvcc's -Xptxas -v report of the last build


def build() -> ctypes.CDLL:
    """Compile the kernels for sm_90a (once per source content) and load
    them. The shared library has a plain C interface, bound with ctypes."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = build_library(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gru_layer_fwd_launch.argtypes = [ci] + [vp] * 7 + [ci] * 3 + [vp]
        lib.gru_layer_fwd_launch.restype = ci
        lib.gru_layer_bwd_launch.argtypes = [ci] + [vp] * 11 + [ci] * 3 + [vp]
        lib.gru_layer_bwd_launch.restype = ci
        lib.gru_layer_error_string.argtypes = [ci]
        lib.gru_layer_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _gates(xp, hproj, H):
    r = torch.sigmoid(xp[:, :H] + hproj[:, :H])
    z = torch.sigmoid(xp[:, H:2 * H] + hproj[:, H:2 * H])
    hn = hproj[:, 2 * H:]
    n = torch.tanh(xp[:, 2 * H:] + r * hn)
    return r, z, n, hn


def _product(a, w, mxu_dtype):
    """a @ w with both operands rounded to `mxu_dtype`, summed in f32."""
    return torch.matmul(a.to(mxu_dtype).float(), w.to(mxu_dtype).float())


def gru_layer_reference(x_proj, w_hh_t, b_hh, h0, mxu_dtype=torch.float32):
    """The forward kernel's arithmetic as a Python loop of tensor ops.

    Returns (ys (T, B, H), hproj (T, B, 3H)), float32."""
    H = h0.shape[1]
    h = h0
    ys, hprojs = [], []
    for t in range(x_proj.shape[0]):
        hproj = _product(h, w_hh_t, mxu_dtype) + b_hh
        _r, z, n, _hn = _gates(x_proj[t], hproj, H)
        h = (1.0 - z) * n + z * h
        ys.append(h)
        hprojs.append(hproj)
    return torch.stack(ys), torch.stack(hprojs)


def gru_layer_backward_reference(x_proj, hproj, h_prev, dy, w_hh,
                                 mxu_dtype=torch.float32):
    """The backward kernel's reverse sweep in tensor ops (not autograd of
    the forward). h_prev (T, B, H) = concat(h0, ys[:-1]); dy (T, B, H) with
    the final state's cotangent folded into dy[-1]; w_hh (3H, H).

    Returns (dxp (T, B, 3H), dhproj (T, B, 3H), dh0 (B, H))."""
    T, _, H3 = x_proj.shape
    H = H3 // 3
    dh = torch.zeros_like(dy[0])
    dxp = [None] * T
    dhproj = [None] * T
    for t in range(T - 1, -1, -1):
        r, z, n, hn = _gates(x_proj[t], hproj[t], H)
        dh_total = dy[t] + dh
        dn_pre = dh_total * (1.0 - z) * (1.0 - n * n)
        dz_pre = dh_total * (h_prev[t] - n) * z * (1.0 - z)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dxp[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dhproj[t] = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dh = dh_total * z + _product(dhproj[t], w_hh, mxu_dtype)
    return torch.stack(dxp), torch.stack(dhproj), dh


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _check(x_proj, w, b_hh, h0, mxu_dtype, w_shape_of):
    if x_proj.dim() != 3 or h0.dim() != 2:
        raise ValueError("x_proj must be (T, B, 3H) and h0 (B, H)")
    T, B, H3 = x_proj.shape
    H = h0.shape[1]
    if H3 != 3 * H or h0.shape[0] != B:
        raise ValueError(f"x_proj {tuple(x_proj.shape)} does not match h0 "
                         f"{tuple(h0.shape)}")
    if tuple(w.shape) != w_shape_of(H):
        raise ValueError(f"recurrent weight has shape {tuple(w.shape)}, "
                         f"expected {w_shape_of(H)}")
    if b_hh is not None and tuple(b_hh.shape) != (3 * H,):
        raise ValueError(f"b_hh has shape {tuple(b_hh.shape)}, expected "
                         f"{(3 * H,)}")
    if mxu_dtype not in _DTYPES:
        raise TypeError(f"mxu_dtype must be float32 or bfloat16, got "
                        f"{mxu_dtype}")
    if T < 1 or B < 1:
        raise ValueError(f"empty sweep: T={T}, B={B}")
    return T, B, H


def _check_cuda(H, mxu_dtype, *tensors):
    if H % H_MULTIPLE[mxu_dtype]:
        raise ValueError(
            f"the GRU kernels need H to be a multiple of "
            f"{H_MULTIPLE[mxu_dtype]} for {mxu_dtype} products, got {H}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"inputs must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("inputs must be 16-byte aligned")


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.gru_layer_error_string(err).decode())


def gru_layer_forward(x_proj, w_hh_t, b_hh, h0, mxu_dtype=torch.bfloat16,
                      with_residual=True):
    """The forward sweep -> (ys (T, B, H), hproj (T, B, 3H) or None).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    T, B, H = _check(x_proj, w_hh_t, b_hh, h0, mxu_dtype,
                     lambda H: (H, 3 * H))
    if x_proj.device.type == "cpu":
        ys, hproj = gru_layer_reference(x_proj, w_hh_t, b_hh, h0, mxu_dtype)
        return ys, (hproj if with_residual else None)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    _check_cuda(H, mxu_dtype, x_proj, b_hh, h0)
    w = w_hh_t.to(mxu_dtype).contiguous()
    lib = build()
    dev = x_proj.device
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    hproj = (torch.empty((T, B, 3 * H), dtype=torch.float32, device=dev)
             if with_residual else None)
    scratch = None
    if mxu_dtype == torch.bfloat16:   # bf16 copies of h, used in turn
        scratch = torch.empty((2, B, H), dtype=torch.bfloat16, device=dev)
        scratch[0].copy_(h0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gru_layer_fwd_launch(
        _DTYPES[mxu_dtype], x_proj.data_ptr(), w.data_ptr(),
        b_hh.data_ptr(), h0.data_ptr(), ys.data_ptr(),
        None if hproj is None else hproj.data_ptr(),
        None if scratch is None else scratch.data_ptr(), T, B, H, stream)
    _raise_on(lib, err, "gru_layer forward")
    gru_layer_forward.launches += 1
    return ys, hproj


gru_layer_forward.launches = 0


def gru_layer_backward(x_proj, hproj, h0, ys, dy, w_hh,
                       mxu_dtype=torch.bfloat16):
    """The reverse sweep -> (dxp, dhproj (T, B, 3H), dh0 (B, H)).

    h_prev[t] is h0 for t = 0 and ys[t-1] after; dy (T, B, H) holds the
    output cotangents with the final state's folded into dy[-1]; w_hh is
    (3H, H). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    T, B, H = _check(x_proj, w_hh, None, h0, mxu_dtype, lambda H: (3 * H, H))
    if x_proj.device.type == "cpu":
        h_prev = torch.cat([h0[None], ys[:-1]], dim=0)
        return gru_layer_backward_reference(x_proj, hproj, h_prev, dy, w_hh,
                                            mxu_dtype)
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    _check_cuda(H, mxu_dtype, x_proj, hproj, h0, ys, dy)
    w = w_hh.to(mxu_dtype).contiguous()
    lib = build()
    dev = x_proj.device
    scratch = (torch.empty((2, B, 3 * H), dtype=torch.bfloat16, device=dev)
               if mxu_dtype == torch.bfloat16 else None)   # of dhproj[t]
    dxp = torch.empty_like(x_proj)
    dhproj = torch.empty_like(x_proj)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dhz = torch.empty((B, H), dtype=torch.float32, device=dev)   # scratch
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gru_layer_bwd_launch(
        _DTYPES[mxu_dtype], x_proj.data_ptr(), hproj.data_ptr(),
        h0.data_ptr(), ys.data_ptr(), dy.data_ptr(), w.data_ptr(),
        dxp.data_ptr(), dhproj.data_ptr(), dh0.data_ptr(), dhz.data_ptr(),
        None if scratch is None else scratch.data_ptr(), T, B, H, stream)
    _raise_on(lib, err, "gru_layer backward")
    gru_layer_backward.launches += 1
    return dxp, dhproj, dh0


gru_layer_backward.launches = 0


class _GruLayer(torch.autograd.Function):
    """ys, hT = GRU sweep; the backward is the reverse-sweep kernel plus
    the time-parallel weight/bias reductions outside it."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, b_hh, h0, mxu_dtype):
        train = any(ctx.needs_input_grad[:4])
        ys, hproj = gru_layer_forward(x_proj, w_hh_t, b_hh, h0, mxu_dtype,
                                      with_residual=train)
        ctx.mxu_dtype = mxu_dtype
        if train:
            ctx.save_for_backward(x_proj, w_hh_t, h0, ys, hproj)
        return ys, ys[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT):
        x_proj, w_hh_t, h0, ys, hproj = ctx.saved_tensors
        mxu_dtype = ctx.mxu_dtype
        T, B, H3 = x_proj.shape
        # fold the final state's cotangent into the last step's output's
        dy = (torch.zeros_like(ys) if dys is None else
              dys.to(torch.float32).clone(
                  memory_format=torch.contiguous_format))
        if dhT is not None:
            dy[-1] += dhT
        dxp, dhproj, dh0 = gru_layer_backward(
            x_proj, hproj, h0, ys, dy, w_hh_t.t(), mxu_dtype)
        # weight/bias gradients: one time-parallel contraction outside the
        # kernel, in the products' type (f32 sums)
        h_prev = torch.cat([h0[None], ys[:-1]], dim=0)
        dw = torch.matmul(
            h_prev.reshape(T * B, -1).to(mxu_dtype).t(),
            dhproj.reshape(T * B, H3).to(mxu_dtype)).to(w_hh_t.dtype)
        db = dhproj.sum(dim=(0, 1))
        return dxp, dw, db, dh0, None


def gru_layer(x_proj, w_hh_t, b_hh, h0, mxu_dtype=torch.bfloat16):
    """Fused GRU layer sweep -> (ys (T, B, H), hT (B, H)), differentiable
    in x_proj, w_hh_t, b_hh and h0 (layouts in the module docstring)."""
    return _GruLayer.apply(x_proj, w_hh_t, b_hh, h0, mxu_dtype)
