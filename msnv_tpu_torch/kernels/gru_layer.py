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
the product is small (0.8 GFLOP at B 128, H 1024, against a 6 MB bf16
weight), so neither bytes nor operations bound a layer: the chain of T
steps does, each of which needs all of the previous step's h on every SM.
For bfloat16 products (the train step) a sweep is therefore ONE persistent
kernel, launched cooperatively. Clusters of CTAs split the depth of one
product between them and keep their slices of W_hh in shared memory for the
whole sweep (read from the weight as stored, (3H, H)); the steps are
separated by a grid barrier instead of a launch; the bf16 copy of h (resp.
dhproj) crosses the barrier in the tiled order of the readers' shared
memory, so that one TMA bulk copy per chunk brings it in; the product runs
on wgmma, the partial sums meet through distributed shared memory, and only
what the next step needs is written before the barrier (see the source's
header). Float32 products take persistent kernels of their own: the
products run on the tensor cores in split TF32 (each operand cut into a
TF32 high part and a TF32 rest, three TF32 products summed in float32:
float32's accuracy), the weight's two parts, 24 MiB at H 1024, held once
across the clusters' shared memory (`tf32_split` cuts the weight once per
call to `gru_layer`; the backward reuses the forward's parts). Shapes whose
grid cannot be resident at once take the per-step kernels: one launch per
timestep, all enqueued by one C call (float32 products on CUDA cores, exact
FMA sums). `sweep_plan` chooses by shape, type and what the card grants,
before anything is launched.

Layouts (the JAX kernel's): x_proj (T, B, 3H) f32 incl. b_ih, gate order
[r, z, n]; w_hh_t (H, 3H), float32 or bfloat16, also as the transposed view
of a stored (3H, H) weight, which the persistent kernels read without a
copy; b_hh (3H,); h0 (B, H). Returns (ys (T, B, H), hT (B, H)), float32.
`mxu_dtype` is the type both operands of the recurrent products are rounded
to (sums are float32): torch.bfloat16 on the mixed-precision train path,
torch.float32 for exactness. On a GPU H must be a multiple of 128 for
bfloat16 products and of 32 for float32 ones (of 128 for their persistent
kernels).

On CPU tensors `gru_layer` runs the plain versions (`gru_layer_reference`,
`gru_layer_backward_reference`); on CUDA tensors it launches the kernels or
raises. `gru_layer_forward.launches` / `gru_layer_backward.launches` count
the wrapper calls that launched (one per layer sweep); `.persistent` and
`.per_step` count them by path (one kernel launch per sweep, resp. T or
T + 1), and `.persistent_bf16`, `.per_step_bf16`, `.persistent_f32`,
`.per_step_f32` by path and products' type (`COUNTERS` names them all).
Every call brings its own barrier counter and scratch, so sweeps on two
streams do not disturb each other; a cooperative launch waits until its
whole grid fits, so they run one after the other.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from msnv_tpu_torch.kernels.build import CSRC, build_library

SOURCE = CSRC / "gru_layer.cu"
# H must be a multiple of the kernels' chunk depth: 32 for float32 products
# (FMA), 128 for bfloat16 products (tensor cores)
H_MULTIPLE = {torch.float32: 32, torch.bfloat16: 128}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# a CTA's tile of the (B, H) state: batch rows (per-step kernels; the
# persistent forward and backward kernels, by the products' type) x
# columns, and how many CTAs form a cluster of a persistent kernel and split
# the depth of one product between them. A bf16 cluster's CTAs are
# neighbouring column slices; a float32 cluster's two CTAs share one slice
# of TILE_COLS columns and a 128-row tile, and each takes 64 of its rows.
TILE_ROWS = {"per_step": 64, "forward": 64, "backward": 128}
TILE_COLS = 16
CLUSTER = {"forward": 2, "backward": 8}
F32_ROWS, F32_CLUSTER = 128, 2
DIRECTIONS = ("forward", "backward")

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
        lib.gru_layer_fwd_persistent_launch.argtypes = (
            [vp] * 9 + [ci] * 3 + [vp])
        lib.gru_layer_fwd_persistent_launch.restype = ci
        lib.gru_layer_bwd_persistent_launch.argtypes = (
            [vp] * 13 + [ci] * 3 + [vp])
        lib.gru_layer_bwd_persistent_launch.restype = ci
        lib.gru_layer_fwd_persistent_f32_launch.argtypes = (
            [vp] * 8 + [ci] * 3 + [vp])
        lib.gru_layer_fwd_persistent_f32_launch.restype = ci
        lib.gru_layer_bwd_persistent_f32_launch.argtypes = (
            [vp] * 12 + [ci] * 3 + [vp])
        lib.gru_layer_bwd_persistent_f32_launch.restype = ci
        lib.gru_layer_empty_sweep_launch.argtypes = [vp, ci, ci, ci, vp]
        lib.gru_layer_empty_sweep_launch.restype = ci
        lib.gru_layer_persistent_smem.argtypes = [ci, ci, ci]
        lib.gru_layer_persistent_smem.restype = ci
        lib.gru_layer_smem_limit.argtypes = [ctypes.POINTER(ci)]
        lib.gru_layer_smem_limit.restype = ci
        lib.gru_layer_persistent_capacity.argtypes = [ci, ci, ci]
        lib.gru_layer_persistent_capacity.restype = ci
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


def tf32_split(w):
    """(2, *w.shape) float32: w rounded to TF32 (to nearest, ties away from
    zero, as the kernels' cvt.rna.tf32.f32 rounds) and the rest w - hi
    rounded the same way; hi + lo is w within 2^-22 of it. The float32
    persistent kernels' weight operand, cut once per call."""
    def rna(x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(w)
    return torch.stack([hi, rna(w - hi)])


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
# which kernels a sweep takes
# --------------------------------------------------------------------------

class SweepPlan(NamedTuple):
    path: str            # "persistent" or "per_step"
    grids: dict          # direction -> CTAs (column slices of H, row tiles)
    smem_bytes: dict     # direction -> shared memory of a persistent CTA


def _grids(B, H, rows_of):
    return {d: (H // TILE_COLS, -(-B // rows_of(d))) for d in DIRECTIONS}


def persistent_grids(B, H, dtype) -> dict:
    """direction -> CTAs of that persistent sweep (along the columns, row
    tiles) for products in `dtype`."""
    if dtype == torch.float32:
        return dict.fromkeys(DIRECTIONS, (F32_CLUSTER * H // TILE_COLS,
                                          -(-B // F32_ROWS)))
    return _grids(B, H, TILE_ROWS.get)


def persistent_smem_bytes(H: int, dtype) -> dict:
    """direction -> shared memory a CTA of that persistent sweep needs.

    bfloat16 products: its slice of W_hh (96 H bytes) and one region for
    its K-slice of a step's left operand (forward 64 rows x H / 2, backward
    128 rows x 3H / 8, bf16) and, after the products, the cluster's partial
    sums (a block of rows x (3 * 16 resp. 16 columns + 4) floats for each
    CTA of the cluster). float32 products: its half of the depth of the
    cluster's columns of W_hh, hi and lo parts (2 x (3 * 16 resp. 16) x K /
    2 x 4 bytes, K = H resp. 3H: 192 H bytes both ways) and the partial
    sums of all 128 rows (128 x (3 * 16 resp. 16 + 4) floats)."""
    cols = {"forward": 3 * TILE_COLS, "backward": TILE_COLS}
    if dtype == torch.float32:
        return {d: 192 * H + F32_ROWS * (cols[d] + 4) * 4 for d in DIRECTIONS}
    depth = {"forward": H, "backward": 3 * H}
    return {d: 3 * TILE_COLS * H * 2 + max(
        TILE_ROWS[d] * (depth[d] // CLUSTER[d]) * 2,
        CLUSTER[d] * TILE_ROWS[d] * (cols[d] + 4) * 4) for d in DIRECTIONS}


def sweep_plan(T, B, H, dtype, resident_ctas, smem_bytes) -> SweepPlan:
    """Choose the kernels for a (T, B, H) sweep with products in `dtype`
    on a device whose CTAs may use `smem_bytes` of shared memory and which
    holds `resident_ctas[direction]` CTAs of that dtype's persistent kernel
    at once at this width (on a card: from the occupancy API, in whole
    clusters). The persistent kernels need H a multiple of 128, their
    operands inside one CTA's shared memory, and the whole grid resident at
    once, because its CTAs wait for each other; if either direction's does
    not fit, both take the per-step kernels. Raises for a shape no kernel
    takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"mxu_dtype must be float32 or bfloat16, got {dtype}")
    if T < 1 or B < 1:
        raise ValueError(f"empty sweep: T={T}, B={B}")
    if H < H_MULTIPLE[dtype] or H % H_MULTIPLE[dtype]:
        raise ValueError(
            f"the GRU kernels need H to be a multiple of "
            f"{H_MULTIPLE[dtype]} for {dtype} products, got {H}")
    grids = persistent_grids(B, H, dtype)
    need = persistent_smem_bytes(H, dtype)
    if H % 128 == 0 and all(
            need[d] <= smem_bytes
            and grids[d][0] * grids[d][1] <= resident_ctas[d]
            for d in DIRECTIONS):
        return SweepPlan("persistent", grids, need)
    return SweepPlan("per_step", _grids(B, H, lambda d: TILE_ROWS["per_step"]),
                     dict.fromkeys(DIRECTIONS, 0))


_limits = {}   # (device index, H, dtype) -> (resident CTAs, shared memory)


def device_limits(device, H, dtype):
    """(direction -> CTAs of that persistent sweep with products in `dtype`
    which a CUDA device holds at once at width H, most dynamic shared memory
    of a CTA): sweep_plan's last two arguments. 0 CTAs where H is no width
    of the persistent kernels."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (index, H, dtype)
    if key not in _limits:
        lib = build()
        smem = ctypes.c_int()
        held = dict.fromkeys(DIRECTIONS, 0)
        with torch.cuda.device(index):
            _raise_on(lib, lib.gru_layer_smem_limit(ctypes.byref(smem)),
                      "device query")
            need = persistent_smem_bytes(H, dtype)
            if H >= 128 and H % 128 == 0 and max(need.values()) <= smem.value:
                for back, d in enumerate(DIRECTIONS):
                    if lib.gru_layer_persistent_smem(
                            H, back, _DTYPES[dtype]) != need[d]:
                        raise RuntimeError("the kernels' shared-memory plan "
                                           "differs from persistent_smem_bytes")
                    held[d] = lib.gru_layer_persistent_capacity(
                        H, back, _DTYPES[dtype])
                    _raise_on(lib, max(-held[d], 0), "occupancy query")
        _limits[key] = (held, smem.value)
    return _limits[key]


def _plan_on(device, T, B, H, mxu_dtype, path):
    plan = sweep_plan(T, B, H, mxu_dtype,
                      *device_limits(device, H, mxu_dtype))
    if path is None or path == plan.path:
        return plan
    if path == "per_step":
        return sweep_plan(T, B, H, mxu_dtype, dict.fromkeys(DIRECTIONS, 0), 0)
    raise ValueError(f"a ({T}, {B}, {H}) sweep in {mxu_dtype} cannot take "
                     f"the {path!r} kernels")


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


def _check_cuda(*tensors):
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


def _tiled_scratch(steps, plan, direction, K, device):
    """Room for a persistent kernel's own tiled bf16 copy of its (steps, B,
    K) left operand: whole row tiles."""
    return torch.empty((steps, plan.grids[direction][1], TILE_ROWS[direction],
                        K), dtype=torch.bfloat16, device=device)


def _slabs(plan, K, device):
    """The float32 persistent kernels' two steps of their (B, K) left
    operand, in their own order: whole 128-row tiles."""
    return torch.empty((2, plan.grids["forward"][1], F32_ROWS, K),
                       dtype=torch.float32, device=device)


COUNTERS = ("launches", "persistent", "per_step", "persistent_bf16",
            "per_step_bf16", "persistent_f32", "per_step_f32")


def _count(wrapper, plan, mxu_dtype):
    kind = "_f32" if mxu_dtype == torch.float32 else "_bf16"
    for name in ("launches", plan.path, plan.path + kind):
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def _forward(x_proj, w_hh_t, b_hh, h0, mxu_dtype, with_residual, path=None):
    """gru_layer_forward, and what the persistent kernels leave for the
    backward: -> (ys, hproj or None, kept), kept = (w_hh (3H, H) bf16,
    hb (T + 1, B, H) bf16 holding h0 and ys) with bfloat16 products,
    (tf32_split of w_hh,) with float32 ones, or None."""
    T, B, H = _check(x_proj, w_hh_t, b_hh, h0, mxu_dtype,
                     lambda H: (H, 3 * H))
    if x_proj.device.type == "cpu":
        ys, hproj = gru_layer_reference(x_proj, w_hh_t, b_hh, h0, mxu_dtype)
        return ys, (hproj if with_residual else None), None
    if x_proj.device.type != "cuda":
        raise ValueError(f"unsupported device {x_proj.device}")
    _check_cuda(x_proj, b_hh, h0)
    dev = x_proj.device
    plan = _plan_on(dev, T, B, H, mxu_dtype, path)
    lib = build()
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    hproj = (torch.empty((T, B, 3 * H), dtype=torch.float32, device=dev)
             if with_residual else None)
    hproj_ptr = None if hproj is None else hproj.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kept = None
    if plan.path == "persistent" and mxu_dtype == torch.float32:
        w = tf32_split(w_hh_t.t())
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        err = lib.gru_layer_fwd_persistent_f32_launch(
            x_proj.data_ptr(), w.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
            ys.data_ptr(), hproj_ptr, _slabs(plan, H, dev).data_ptr(),
            counter.data_ptr(), T, B, H, stream)
        kept = (w,)
    elif plan.path == "persistent":
        # the weight as stored: no copy when w_hh_t is the transposed view
        # of a bf16 (3H, H) parameter
        w = w_hh_t.t().to(torch.bfloat16).contiguous()
        hb = torch.empty((T + 1, B, H), dtype=torch.bfloat16, device=dev)
        tiled = _tiled_scratch(T + 1, plan, "forward", H, dev)
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        err = lib.gru_layer_fwd_persistent_launch(
            x_proj.data_ptr(), w.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
            ys.data_ptr(), hproj_ptr, hb.data_ptr(), tiled.data_ptr(),
            counter.data_ptr(), T, B, H, stream)
        kept = (w, hb)
    else:
        w = w_hh_t.to(mxu_dtype).contiguous()
        scratch = None
        if mxu_dtype == torch.bfloat16:   # bf16 copies of h, used in turn
            scratch = torch.empty((2, B, H), dtype=torch.bfloat16, device=dev)
            scratch[0].copy_(h0)
        err = lib.gru_layer_fwd_launch(
            _DTYPES[mxu_dtype], x_proj.data_ptr(), w.data_ptr(),
            b_hh.data_ptr(), h0.data_ptr(), ys.data_ptr(), hproj_ptr,
            None if scratch is None else scratch.data_ptr(), T, B, H, stream)
    _raise_on(lib, err, "gru_layer forward")
    _count(gru_layer_forward, plan, mxu_dtype)
    return ys, hproj, kept


def gru_layer_forward(x_proj, w_hh_t, b_hh, h0, mxu_dtype=torch.bfloat16,
                      with_residual=True, path=None):
    """The forward sweep -> (ys (T, B, H), hproj (T, B, 3H) or None).

    CPU tensors take the plain version; CUDA tensors launch the kernels
    that `sweep_plan` names. `path="per_step"` asks for the per-step kernels
    where the persistent one would run (to time them side by side)."""
    ys, hproj, _ = _forward(x_proj, w_hh_t, b_hh, h0, mxu_dtype,
                            with_residual, path)
    return ys, hproj




def _backward(x_proj, hproj, h0, ys, dy, w_hh, mxu_dtype, dhT=None,
              path=None, w_kept=None):
    """gru_layer_backward -> (dxp, dhproj, dh0, dhb), dhb (T, B, 3H) bf16 =
    dhproj rounded, from the bf16 persistent kernel, else None. `w_kept` is
    the weight as the forward's persistent kernel took it, if it kept it:
    the bf16 (3H, H) copy, or the (2, 3H, H) tf32_split."""
    T, B, H = _check(x_proj, w_hh, None, h0, mxu_dtype, lambda H: (3 * H, H))
    on_cpu = x_proj.device.type == "cpu"
    if not on_cpu:
        if x_proj.device.type != "cuda":
            raise ValueError(f"unsupported device {x_proj.device}")
        _check_cuda(x_proj, hproj, h0, ys, dy, *(() if dhT is None
                                                 else (dhT,)))
        dev = x_proj.device
        plan = _plan_on(dev, T, B, H, mxu_dtype, path)
    if (on_cpu or plan.path != "persistent") and dhT is not None:
        # fold the final state's cotangent into the last step's output's
        dy = dy.clone()
        dy[-1] += dhT
    if on_cpu:
        h_prev = torch.cat([h0[None], ys[:-1]], dim=0)
        return gru_layer_backward_reference(x_proj, hproj, h_prev, dy, w_hh,
                                            mxu_dtype) + (None,)
    lib = build()
    dxp = torch.empty_like(x_proj)
    dhproj = torch.empty_like(x_proj)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dhb = None
    if plan.path == "persistent" and mxu_dtype == torch.float32:
        w = tf32_split(w_hh) if w_kept is None else w_kept
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        err = lib.gru_layer_bwd_persistent_f32_launch(
            x_proj.data_ptr(), hproj.data_ptr(), h0.data_ptr(), ys.data_ptr(),
            dy.data_ptr(), None if dhT is None else dhT.data_ptr(),
            w.data_ptr(), dxp.data_ptr(), dhproj.data_ptr(),
            _slabs(plan, 3 * H, dev).data_ptr(), dh0.data_ptr(),
            counter.data_ptr(), T, B, H, stream)
    elif plan.path == "persistent":
        w = (w_hh.to(torch.bfloat16).contiguous() if w_kept is None
             else w_kept)
        dhb = torch.empty((T, B, 3 * H), dtype=torch.bfloat16, device=dev)
        tiled = _tiled_scratch(T, plan, "backward", 3 * H, dev)
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        err = lib.gru_layer_bwd_persistent_launch(
            x_proj.data_ptr(), hproj.data_ptr(), h0.data_ptr(), ys.data_ptr(),
            dy.data_ptr(), None if dhT is None else dhT.data_ptr(),
            w.data_ptr(), dxp.data_ptr(), dhproj.data_ptr(), dhb.data_ptr(),
            tiled.data_ptr(), dh0.data_ptr(), counter.data_ptr(), T, B, H,
            stream)
    else:
        w = w_hh.to(mxu_dtype).contiguous()
        scratch = (torch.empty((2, B, 3 * H), dtype=torch.bfloat16,
                               device=dev)
                   if mxu_dtype == torch.bfloat16 else None)   # of dhproj[t]
        dhz = torch.empty((B, H), dtype=torch.float32, device=dev)  # scratch
        err = lib.gru_layer_bwd_launch(
            _DTYPES[mxu_dtype], x_proj.data_ptr(), hproj.data_ptr(),
            h0.data_ptr(), ys.data_ptr(), dy.data_ptr(), w.data_ptr(),
            dxp.data_ptr(), dhproj.data_ptr(), dh0.data_ptr(),
            dhz.data_ptr(),
            None if scratch is None else scratch.data_ptr(), T, B, H, stream)
    _raise_on(lib, err, "gru_layer backward")
    _count(gru_layer_backward, plan, mxu_dtype)
    return dxp, dhproj, dh0, dhb


def gru_layer_backward(x_proj, hproj, h0, ys, dy, w_hh,
                       mxu_dtype=torch.bfloat16, dhT=None, path=None):
    """The reverse sweep -> (dxp, dhproj (T, B, 3H), dh0 (B, H)).

    h_prev[t] is h0 for t = 0 and ys[t-1] after; dy (T, B, H) holds the
    output cotangents and dhT (B, H), if given, the final state's, which
    counts as added to dy[-1]; w_hh is (3H, H). CPU tensors take the plain
    version; CUDA tensors launch the kernels that `sweep_plan` names (or
    the per-step ones with `path="per_step"`)."""
    return _backward(x_proj, hproj, h0, ys, dy, w_hh, mxu_dtype, dhT,
                     path)[:3]


for _wrapper in (gru_layer_forward, gru_layer_backward):
    for _name in COUNTERS:
        setattr(_wrapper, _name, 0)


def empty_sweep(steps, B, H, device):
    """Launch the persistent sweeps' grid for (B, H) through `steps` grid
    barriers and no other work: the cost of a sweep's step-to-step
    dependence alone, for timing beside the real sweeps."""
    plan = _plan_on(device, steps, B, H, torch.bfloat16, "persistent")
    lib = build()
    counter = torch.empty((1,), dtype=torch.int32, device=device)
    err = lib.gru_layer_empty_sweep_launch(
        counter.data_ptr(), steps, B, H,
        torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, "empty sweep")
    return plan


class _GruLayer(torch.autograd.Function):
    """ys, hT = GRU sweep; the backward is the reverse-sweep kernel plus
    the time-parallel weight/bias reductions outside it."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, b_hh, h0, mxu_dtype):
        train = any(ctx.needs_input_grad[:4])
        ys, hproj, kept = _forward(x_proj, w_hh_t, b_hh, h0, mxu_dtype,
                                   with_residual=train)
        ctx.mxu_dtype = mxu_dtype
        if train:
            ctx.save_for_backward(x_proj, w_hh_t, h0, ys, hproj,
                                  *(kept or ()))
        return ys, ys[-1].clone()

    @staticmethod
    def backward(ctx, dys, dhT):
        x_proj, w_hh_t, h0, ys, hproj, *kept = ctx.saved_tensors
        mxu_dtype = ctx.mxu_dtype
        T, B, H3 = x_proj.shape
        dy = (torch.zeros_like(ys) if dys is None
              else dys.to(torch.float32).contiguous())
        if dhT is not None:
            dhT = dhT.to(torch.float32).contiguous()
        dxp, dhproj, dh0, dhb = _backward(
            x_proj, hproj, h0, ys, dy, w_hh_t.t(), mxu_dtype, dhT,
            w_kept=kept[0] if kept else None)
        # weight/bias gradients: one time-parallel contraction outside the
        # kernel, in the products' type (f32 sums). The bf16 persistent
        # kernels have left both operands in that type already.
        if dhb is not None and kept:
            h_prev, dhp = kept[1][:-1], dhb
        else:
            h_prev = torch.cat([h0[None], ys[:-1]], dim=0).to(mxu_dtype)
            dhp = dhproj.to(mxu_dtype)
        dw = torch.matmul(h_prev.reshape(T * B, -1).t(),
                          dhp.reshape(T * B, H3)).to(w_hh_t.dtype)
        db = dhproj.sum(dim=(0, 1))
        return dxp, dw, db, dh0, None


def gru_layer(x_proj, w_hh_t, b_hh, h0, mxu_dtype=torch.bfloat16):
    """Fused GRU layer sweep -> (ys (T, B, H), hT (B, H)), differentiable
    in x_proj, w_hh_t, b_hh and h0 (layouts in the module docstring)."""
    return _GruLayer.apply(x_proj, w_hh_t, b_hh, h0, mxu_dtype)
