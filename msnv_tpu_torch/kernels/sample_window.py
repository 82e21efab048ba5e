"""Sample-window kernel wrapper, plain version and build.

The kernel (msnv_tpu_torch/csrc/sample_window.cu) replaces the TPU kernels
`_window_kernel`, `_window_kernel_v2` and `_window_kernel_v3` of the JAX
package's pallas/sample_kernel.py: for each lane it makes the bottom
tier's fs0 samples one after another (fused-table gather + slot row ->
ReLU -> W_h -> ReLU -> W_o -> argmax(logits + Gumbel) -> shift the window)
in one launch. Its two noise modes cover the three TPU variants: Gumbel noise given
as input (v1) or drawn in the kernel from Philox (v2/v3).

What bounds it on the H100, and what the design does about it: each
sample needs the whole W_h and W_o (2.5 MB in bf16 at the canonical width)
for every lane, so at small batch it is a matrix-vector product limited by
how fast one SM streams the L2-resident weights, and at large batch by
arithmetic. The first version keeps the window and the activations of a
tile of lanes in shared memory for all fs0 steps, reuses each weight load
across the tile, and spreads tiles over the SMs (see the source's header).

Layouts (the port's choice, lane-major so one CTA reads contiguous rows):
  table (fs0*q, dim)   fused embed+conv, position-major (fused_embed_conv)
  wh (dim, dim), wo (dim, q)   x @ W layout, same dtype as table
  bh (dim,), bo (q,)   float32
  slots (B, fs0, dim)  bottom-tier slot rows, table dtype
  buf (B, fs0) int32   the last fs0 samples
  noise (B, fs0, q) float32 Gumbel noise, or seed (1,) int64 for Philox
Returns (B, fs0) int32: the fs0 new samples.

On a CPU tensor `sample_window` runs `sample_window_reference` (in the
Philox mode on the noise `philox_gumbel_noise` computes: the numbers the
kernel draws); on a CUDA tensor it launches the kernel or raises. The
library is built with nvcc at first use into msnv_tpu_torch/build/.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from msnv_tpu_torch.kernels.build import CSRC, build_library

SOURCE = CSRC / "sample_window.cu"
TILES = (1, 2, 4, 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()
build_log = ""      # nvcc's -Xptxas -v report of the last build


def build() -> ctypes.CDLL:
    """Compile the kernel for sm_90a (once per source content) and load
    it. The shared library has a plain C interface, bound with ctypes."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, build_log = build_library(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sample_window_launch.argtypes = [ci, ci] + [vp] * 10 + [ci] * 4 \
            + [vp]
        lib.sample_window_launch.restype = ci
        lib.sample_window_smem_bytes.argtypes = [ci] * 4
        lib.sample_window_smem_bytes.restype = ctypes.c_longlong
        lib.sample_window_error_string.argtypes = [ci]
        lib.sample_window_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def gumbel_noise(shape, generator=None, device="cpu"):
    """Gumbel(0, 1) noise: argmax(logits + noise) is a categorical draw."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=1e-20)))


_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, b):
    """(hi, lo) 32-bit halves of m * b for m, b < 2^32, in int64 tensors
    (split in 16-bit halves so no product overflows)."""
    p_lo = m * (b & 0xFFFF)
    p_hi = m * (b >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 on int64 tensors holding uint32 values — the
    kernel's generator, as plain tensor code."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def philox_gumbel_noise(seed, batch: int, fs0: int, q: int):
    """The Gumbel noise the kernel draws in its Philox mode, (B, fs0, q)
    float32: key = the 64-bit seed, counter = (class // 4, step, lane, 0),
    u = ((bits >> 8) + 0.5) / 2^24. With it the plain version reproduces
    the kernel's Philox mode."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    k0, k1 = s & _MASK32, (s >> 32) & _MASK32
    groups = -(-q // 4)
    i64 = {"device": dev, "dtype": torch.int64}
    c0 = torch.arange(groups, **i64).view(1, 1, groups)
    c1 = torch.arange(fs0, **i64).view(1, fs0, 1)
    c2 = torch.arange(batch, **i64).view(batch, 1, 1)
    shape = (batch, fs0, groups)
    bits = torch.stack(philox4x32(c0.expand(shape), c1.expand(shape),
                                  c2.expand(shape),
                                  torch.zeros(shape, **i64), k0, k1), -1)
    u = ((bits.reshape(batch, fs0, 4 * groups)[..., :q] >> 8).float()
         + 0.5) * (1.0 / 16777216.0)
    return -torch.log(-torch.log(u))


def sample_window_reference(table, wh, bh, wo, bo, slots, buf, noise):
    """The plain PyTorch version of the kernel (noise given as input).

    Same arithmetic as the kernel: table rows summed in f32 in position
    order, the slot row added, activations cast to the weight dtype before
    each product, products accumulated in f32, first index on ties.
    """
    fs0 = buf.shape[1]
    q = wo.shape[1]
    wdtype = table.dtype
    offsets = torch.arange(fs0, device=buf.device, dtype=torch.int64) * q
    wh32, wo32 = wh.float(), wo.float()
    win = buf
    for k in range(fs0):
        rows = table[win.long() + offsets].float()          # (B, fs0, dim)
        acc = rows[:, 0]
        for p in range(1, fs0):
            acc = acc + rows[:, p]
        x = torch.relu(acc + slots[:, k].float()).to(wdtype).float()
        h = torch.relu(torch.matmul(x, wh32) + bh).to(wdtype).float()
        logits = torch.matmul(h, wo32) + bo
        s = torch.argmax(logits + noise[:, k], dim=-1).to(torch.int32)
        win = torch.cat([win[:, 1:], s[:, None]], dim=1)
    return win


def default_tile(batch: int, device) -> int:
    """Smallest tile that keeps the CTA count within four per SM.

    A CTA is bound by how many weight loads it keeps in flight, not by its
    arithmetic, so more CTAs beat wider tiles until the SMs are several
    deep: on an H100 at dim 1024 one lane per CTA is fastest up to B = 128
    and two lanes per CTA at B = 1024 (chip_smoke.py's tile sweep)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for tile in TILES:
        if -(-batch // tile) <= 4 * sms:
            return tile
    return TILES[-1]


def _check(table, wh, bh, wo, bo, slots, buf, noise, seed):
    if (noise is None) == (seed is None):
        raise ValueError("pass exactly one of noise= or seed=")
    if table.dim() != 2 or buf.dim() != 2 or slots.dim() != 3:
        raise ValueError("table must be 2-D, slots 3-D, buf 2-D")
    batch, fs0 = buf.shape
    dim = table.shape[1]
    q = table.shape[0] // fs0
    want = {"table": (table, (fs0 * q, dim)), "wh": (wh, (dim, dim)),
            "bh": (bh, (dim,)), "wo": (wo, (dim, q)), "bo": (bo, (q,)),
            "slots": (slots, (batch, fs0, dim))}
    if noise is not None:
        want["noise"] = (noise, (batch, fs0, q))
    else:
        want["seed"] = (seed, (1,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    for name, t in (("wh", wh), ("wo", wo), ("slots", slots)):
        if t.dtype != table.dtype:
            raise TypeError(f"{name} is {t.dtype}, table is {table.dtype}")
    for name, t, dt in (("bh", bh, torch.float32), ("bo", bo, torch.float32),
                        ("buf", buf, torch.int32),
                        ("noise", noise, torch.float32),
                        ("seed", seed, torch.int64)):
        if t is not None and t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    tensors = [t for t in (table, wh, bh, wo, bo, slots, buf, noise, seed)
               if t is not None]
    if any(t.device != table.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    return tensors, batch, fs0, q, dim


def sample_window(table, wh, bh, wo, bo, slots, buf, *, noise=None,
                  seed=None, tile=None):
    """fs0 samples per lane -> (B, fs0) int32 (layouts in the module
    docstring), with Gumbel `noise` given or drawn from Philox keyed on
    `seed`. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    tensors, batch, fs0, q, dim = _check(table, wh, bh, wo, bo, slots, buf,
                                         noise, seed)
    if table.device.type == "cpu":
        if noise is None:
            noise = philox_gumbel_noise(seed, batch, fs0, q)
        return sample_window_reference(table, wh, bh, wo, bo, slots, buf,
                                       noise)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"weights must be float32 or bfloat16, got "
                        f"{table.dtype}")
    if dim % 8 or q % 8:
        raise ValueError(f"dim ({dim}) and q ({q}) must be multiples of 8")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    for t in (table, wh, wo):
        if t.data_ptr() % 16:
            raise ValueError("weights must be 16-byte aligned")
    lib = build()
    tile = default_tile(batch, table.device) if tile is None else tile
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    smem = lib.sample_window_smem_bytes(tile, fs0, q, dim)
    # 227 KB on Hopper where the property is missing from older builds
    limit = getattr(torch.cuda.get_device_properties(table.device),
                    "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise ValueError(f"tile {tile} at dim {dim} needs {smem} B of shared "
                         f"memory; the card allows {limit}")
    out = torch.empty((batch, fs0), dtype=torch.int32, device=table.device)
    if batch == 0:
        return out
    stream = torch.cuda.current_stream(table.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.sample_window_launch(
        _DTYPES[table.dtype], tile, ptr(table), ptr(wh), ptr(bh), ptr(wo),
        ptr(bo), ptr(slots), ptr(buf), ptr(noise), ptr(seed), ptr(out),
        batch, fs0, q, dim, stream)
    if err != 0:
        raise RuntimeError("sample_window launch failed: "
                           + lib.sample_window_error_string(err).decode())
    sample_window.launches += 1
    return out


sample_window.launches = 0
