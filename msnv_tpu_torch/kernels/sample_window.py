"""Sample-window kernels: wrapper, plain version, launch plan and build.

The kernels (msnv_tpu_torch/csrc/sample_window.cu) replace the TPU kernels
`_window_kernel`, `_window_kernel_v2` and `_window_kernel_v3` of the JAX
package's pallas/sample_kernel.py: for each lane they make the bottom
tier's fs0 samples one after another (fused-table gather + slot row ->
ReLU -> W_h -> ReLU -> W_o -> argmax(logits + Gumbel) -> shift the window)
in one launch. Two noise modes cover the three TPU variants: Gumbel noise
given as input (v1) or drawn in the kernel from Philox (v2/v3).

What bounds a window on the H100, and what the design does about it: each
sample needs the whole W_h and W_o (2.5 MB in bf16 at the canonical width)
and depends on the sample before, so a window is a chain of fs0 steps whose
products are tiny; what a step costs besides them decides. Two kernels:

- "resident" (bf16): a thread-block cluster keeps W_h and W_o for the
  whole window (16 CTAs x 160 KB at dim 1024), each CTA owning a slice of
  the output columns of W_h and the same rows of W_o, brought in once from
  weights packed once per sampler (`pack_window_weights`): W_o and what is
  left of W_h in shared memory, the rest of W_h in the threads' registers.
  So a CTA's columns of h stay where they are made: it multiplies them by
  its rows of W_o and sends each CTA the partial sums of the logit columns
  that CTA owns, which adds the cluster's parts in a fixed order. A
  cluster walks through its share of the lanes in passes of 8, 16, 24 or
  32 (one to four n-tiles of the tensor cores' m16n8k16 that share the
  weights' operand): a step's chain of exchanges and barriers is paid once
  for all of its lanes, so the plan takes the fewest passes that shared
  memory allows. x, the partial logits and each CTA's best class are
  pushed into the CTAs' shared memory by asynchronous stores that report
  to the receiver's mbarrier (three exchanges per sample, no barrier;
  `resident_push_bytes` a lane's step); half of a CTA's threads fetch the
  next step's table rows while the other half send (see the source's
  header).
- "grid" (float32, and bf16 widths no cluster holds): float32 W_h and W_o
  (5.24 MB at the canonical width) fit no cluster but the card's shared
  memory: the fewest CTAs that hold them (32 at dim 1024, "groups") keep
  a slice each (columns of W_h, the same rows of W_o; `pack_grid_weights`,
  once per sampler), and the card holds a few such replicas, each of
  which multiplies a share of the lanes. One cooperative launch a window,
  two grid barriers a sample: every CTA draws and gathers x for its own
  lanes into device memory; then every CTA multiplies its replica's rows
  of x by its slice and writes its group's partial logits, which the
  lanes' owners add in group order at the next sample. Float32 FMA in a
  fixed order (tests/test_torch_sample_window_grid.py emulates its
  decomposition in plain tensor code).

`window_plan` chooses between them by shape, type and what the device
grants (the occupancy API's answers, `device_limits`), before anything is
launched. A window that neither takes (widths no preset has, such as bf16
dim 640, or a card that grants too few CTAs) is refused with an error
that names its widths and the device's limits.

Layouts (the port's choice, lane-major so one CTA reads contiguous rows):
  table (fs0*q, dim)   fused embed+conv, position-major (fused_embed_conv)
  wh (dim, dim), wo (dim, q)   x @ W layout, same dtype as table
  bh (dim,), bo (q,)   float32
  slots (B, fs0, dim)  bottom-tier slot rows, table dtype; rows may be
                       strided (last dimension contiguous)
  buf (B, fs0) int32   the last fs0 samples; may be the last fs0 columns
                       of a wider buffer (a view, not copied)
  noise (B, fs0, q) float32 Gumbel noise, or seed (1,) int64 for Philox
Returns (B, fs0) int32: the fs0 new samples.

On a CPU tensor `sample_window` runs `sample_window_reference` (in the
Philox mode on the noise `philox_gumbel_noise` computes: the numbers both
kernels draw).
`sample_window.launches` counts the windows launched: the calls that
launched a kernel, and a captured CUDA graph's windows each time it is
replayed (serving/mux.py adds them; its capture, and the scratch push
before it, count none); `.resident` and `.grid` by kernel; `.lanes` the
lanes of the resident launches and `.passes` their passes (clusters times
the most passes a cluster makes), so that lanes / passes is how wide a
pass ran. The library is built with nvcc at first use into
msnv_tpu_torch/build/.

The Philox mode is also registered as the operator
`msnv_torch::sample_window` (`sample_window_op`), with
`msnv_torch::pack_window_weights` beside it, so that torch.export can trace
a program that samples windows (the serving artifact, export.py): a ctypes
call cannot be traced. Both plan on the tensors they are given when they
run, never when a program is traced, so nothing of the tracing process's
device is baked into the program.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from msnv_tpu_torch.kernels.build import CSRC, build_library

SOURCE = CSRC / "sample_window.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the resident kernel: lanes of an n-tile (the fewest lanes a cluster
# takes), the widths of its passes, warps per CTA that multiply, the cluster
# sizes it may take, steps of W_h a compute thread holds in registers per
# n-tile, padding of its activation rows (bf16), of its rows of partial sums
# and between two parts' sums (f32)
SUBTILE = 8
RESIDENT_WIDTHS = (8, 16, 24, 32)
RESIDENT_WARPS = 16
CLUSTER_SIZES = (1, 2, 4, 8, 16)
_REG_STEPS = 4
_ACT_PAD, _RED_PAD, _PART_PAD = 8, 4, 4
# the most columns of W_h and of W_o that one of its CTAs owns (four columns
# of a lane a gather thread; a 16-column tile a warp)
_MAX_OWN_H, _MAX_OWN_O = 64, 256
# the shared memory a CTA's layout is made to fit (the most a CTA of an
# H100 may ask for): its partial logits come in as few rounds as allow it
_SMEM_FIT = 232448
# the grid kernel: threads per CTA, the lanes a CTA may multiply at once,
# lanes a CTA draws and gathers at once, the fewest lanes a replica of the
# weights takes
GRID_THREADS, GRID_TILES, _OWN_CHUNK = 256, (1, 2, 4, 8, 16), 8
GRID_TILE, REPLICA_LANES = GRID_TILES[-1], 8

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
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sample_window_resident_launch.argtypes = (
            [vp] * 9 + [ci] * 4 + [ll] * 3 + [ci, ci, ci, vp])
        lib.sample_window_resident_launch.restype = ci
        lib.sample_window_empty_launch.argtypes = [ci] * 7 + [vp]
        lib.sample_window_empty_launch.restype = ci
        lib.sample_window_resident_smem.argtypes = [ci] * 5
        lib.sample_window_resident_smem.restype = ll
        lib.sample_window_max_clusters.argtypes = [ci] * 5
        lib.sample_window_max_clusters.restype = ci
        lib.sample_window_grid_launch.argtypes = (
            [ci, ci] + [vp] * 12 + [ci] * 4 + [ll] * 3 + [ci, ci, vp])
        lib.sample_window_grid_launch.restype = ci
        lib.sample_window_grid_empty_launch.argtypes = [ci] * 7 + [vp, vp]
        lib.sample_window_grid_empty_launch.restype = ci
        lib.sample_window_grid_smem.argtypes = [ci] * 6
        lib.sample_window_grid_smem.restype = ll
        lib.sample_window_grid_ctas.argtypes = [ci] * 6
        lib.sample_window_grid_ctas.restype = ci
        lib.sample_window_device.argtypes = [ctypes.POINTER(ci)]
        lib.sample_window_device.restype = ci
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


# --------------------------------------------------------------------------
# the resident kernel's weights: packed once, a CTA's slice contiguous
# --------------------------------------------------------------------------

def _mma_a_order():
    """(m, k) of the 8 values that each of a warp's 32 threads holds of the
    16 x 16 operand A[m][k] of mma m16n8k16, shaped (32, 8): rows g =
    thread / 4 and g + 8, depths 2 (thread % 4) + {0, 1} and + {8, 9}."""
    thread = torch.arange(32)
    m = (thread // 4)[:, None] + torch.tensor([0, 0, 8, 8, 0, 0, 8, 8])
    k = 2 * (thread % 4)[:, None] + torch.tensor([0, 1, 0, 1, 8, 9, 8, 9])
    return m, k


def _fragment_index(depth: int, cols: int, cluster: int):
    """Flat indices into a (depth, cols) row-major weight, shaped (cluster,
    cols / cluster / 16, depth / 16, 32, 8): for each CTA of the cluster
    its 16-column tiles, for each tile its 16-deep steps, and for each step
    the 8 values that each of a warp's 32 threads holds of the 16 x 16
    operand A[m][k] = w[16 step + k][column m] of mma m16n8k16
    (`_mma_a_order`). W_h's packing: a CTA owns columns."""
    m, k = _mma_a_order()
    per = cols // cluster
    rank = torch.arange(cluster).view(-1, 1, 1, 1, 1)
    tile = torch.arange(per // 16).view(1, -1, 1, 1, 1)
    step = torch.arange(depth // 16).view(1, 1, -1, 1, 1)
    return (step * 16 + k) * cols + rank * per + tile * 16 + m


def _row_fragment_index(depth: int, cols: int, cluster: int):
    """The same for a CTA that owns rows: shaped (cluster, cols / 16, depth
    / cluster / 16, 32, 8), CTA r's rows r depth / cluster .. over all of
    the columns, as its 16-column tiles, each as its 16-deep steps in the
    mma's operand order. W_o's packing: CTA r's rows are the ones its
    columns of h multiply."""
    m, k = _mma_a_order()
    per = depth // cluster
    rank = torch.arange(cluster).view(-1, 1, 1, 1, 1)
    tile = torch.arange(cols // 16).view(1, -1, 1, 1, 1)
    step = torch.arange(per // 16).view(1, 1, -1, 1, 1)
    return (rank * per + step * 16 + k) * cols + tile * 16 + m


def _check_packable(wh, wo, cluster):
    dim, q = wo.shape
    if tuple(wh.shape) != (dim, dim):
        raise ValueError(f"wh {tuple(wh.shape)} does not match wo "
                         f"{tuple(wo.shape)}")
    if cluster < 1 or dim % (16 * cluster) or q % (16 * cluster):
        raise ValueError(f"a cluster of {cluster} cannot split dim {dim} "
                         f"and q {q} in tiles of 16 columns")
    return dim, q


def _window_index(dim: int, q: int, cluster: int):
    """`_fragment_index` of W_h and `_row_fragment_index` of W_o, each
    flattened to (cluster, its slice's elements)."""
    return (_fragment_index(dim, dim, cluster).reshape(cluster, -1),
            _row_fragment_index(dim, q, cluster).reshape(cluster, -1))


@functools.lru_cache(maxsize=None)
def _window_index_on(dim: int, q: int, cluster: int, device):
    """`_window_index` made once per device (10 MB of int64 at the
    canonical width: building it on the host for every pack would cost
    more than the gather)."""
    return tuple(t.to(device) for t in _window_index(dim, q, cluster))


def pack_window_weights(wh, wo, cluster: int):
    """wh (dim, dim) and wo (dim, q) -> (cluster, (dim + q) / cluster * dim)
    in the order the resident kernel reads: row r is what CTA r of a
    cluster keeps in its shared memory, its dim / cluster columns of W_h
    (`_fragment_index`) and then the same dim / cluster rows of W_o over all
    q columns (`_row_fragment_index`), each as [16-column tile][16-deep
    step][thread][8 values], so that one bulk copy brings the slice in and
    a thread's operand is one 16-byte load."""
    dim, q = _check_packable(wh, wo, cluster)
    idx_h, idx_o = _window_index_on(dim, q, cluster, wh.device)
    return torch.cat([wh.contiguous().reshape(-1)[idx_h],
                      wo.contiguous().reshape(-1)[idx_o]], dim=1)


def unpack_window_weights(packed, dim: int, q: int, cluster: int):
    """The inverse of `pack_window_weights`: -> (wh (dim, dim), wo (dim,
    q))."""
    if tuple(packed.shape) != (cluster, (dim + q) // cluster * dim):
        raise ValueError(f"packed weights have shape {tuple(packed.shape)}")
    split = dim // cluster * dim
    out = []
    for part, idx, n in zip((packed[:, :split], packed[:, split:]),
                            _window_index(dim, q, cluster), (dim, q)):
        w = torch.empty(dim * n, dtype=packed.dtype, device=packed.device)
        w[idx.reshape(-1).to(packed.device)] = part.reshape(-1)
        out.append(w.reshape(dim, n))
    return tuple(out)


# --------------------------------------------------------------------------
# the grid kernel's weights: packed once, a CTA's slice contiguous
# --------------------------------------------------------------------------

def _grid_index(dim: int, q: int, groups: int):
    """Flat indices into W_h (dim, dim) and W_o (dim, q), row-major, shaped
    (groups, dim / groups * dim) and (groups, dim / groups * q): for each CTA
    g of a replica its columns g * nh .. of W_h as [column group of 4][j]
    [dd][part][4], depth 4 (j P + part) + dd (P = the threads of a column
    group, each taking blocks of four depths: a warp's loads of one dd are
    neighbours), and the same rows of W_o as [column group of 4 of q][row]
    [4] (nh = dim / groups): a thread reads four columns of one depth with
    one load."""
    nh = dim // groups
    parts = GRID_THREADS // (nh // 4)
    g = torch.arange(groups).view(-1, 1, 1, 1, 1, 1)
    cg = torch.arange(nh // 4).view(1, -1, 1, 1, 1, 1)
    j = torch.arange(dim // (4 * parts)).view(1, 1, -1, 1, 1, 1)
    dd = torch.arange(4).view(1, 1, 1, -1, 1, 1)
    part = torch.arange(parts).view(1, 1, 1, 1, -1, 1)
    e = torch.arange(4).view(1, 1, 1, 1, 1, -1)
    idx_h = (4 * (j * parts + part) + dd) * dim + g * nh + cg * 4 + e
    e = e.view(1, 1, 1, -1)
    cq = torch.arange(q // 4).view(1, -1, 1, 1)
    row = torch.arange(nh).view(1, 1, -1, 1)
    idx_o = (torch.arange(groups).view(-1, 1, 1, 1) * nh + row) * q \
        + cq * 4 + e
    return idx_h.reshape(groups, -1), idx_o.reshape(groups, -1)


@functools.lru_cache(maxsize=None)
def _grid_index_on(dim: int, q: int, groups: int, device):
    return tuple(t.to(device) for t in _grid_index(dim, q, groups))


def _check_grid_packable(wh, wo, groups):
    dim, q = wo.shape
    if tuple(wh.shape) != (dim, dim):
        raise ValueError(f"wh {tuple(wh.shape)} does not match wo "
                         f"{tuple(wo.shape)}")
    if not grid_shape_ok(1, q, dim, groups):
        raise ValueError(f"{groups} CTAs cannot split dim {dim} and q {q} "
                         f"in column groups of 4 and depth blocks of 4 "
                         f"a thread")
    return dim, q


def pack_grid_weights(wh, wo, groups: int):
    """wh (dim, dim) and wo (dim, q) -> (groups, dim / groups * (dim + q)) in
    the order the grid kernel reads: row g is what CTA g of a replica keeps
    in its shared memory (`_grid_index`), one block for its bulk copies."""
    dim, q = _check_grid_packable(wh, wo, groups)
    idx_h, idx_o = _grid_index_on(dim, q, groups, wh.device)
    return torch.cat([wh.contiguous().reshape(-1)[idx_h],
                      wo.contiguous().reshape(-1)[idx_o]], dim=1)


# --------------------------------------------------------------------------
# which kernel a window takes
# --------------------------------------------------------------------------

class WindowPlan(NamedTuple):
    path: str               # "resident" or "grid"
    cluster: int            # CTAs per cluster (grid: CTAs per replica of
                            # the weights)
    clusters: int           # clusters (grid: replicas)
    lanes_per_cluster: int  # the most lanes one cluster walks through
    subtile: int            # lanes in flight at once in a cluster (a CTA):
                            # resident, the width of a pass
    smem_bytes: int         # dynamic shared memory of a CTA


def _depth_split(mtiles: int, ksteps: int) -> int:
    """Over how many warps the resident kernel splits a product's depth."""
    s = 1
    while mtiles * s * 2 <= RESIDENT_WARPS and ksteps % (s * 2) == 0:
        s *= 2
    return s


def resident_smem_bytes(fs0: int, q: int, dim: int, cluster: int,
                        width: int) -> int:
    """Shared memory of one CTA of the resident kernel in passes of `width`
    lanes: what its threads do not hold in registers of its slice of W_h
    (each warp's steps past the first 4 width / 8 in a pass wider than 8,
    all of them in a pass of 8) and its rows of W_o, the pass's x rows (bf16,
    padded) and in the same bytes, once x is read, its own columns of h
    (bf16, padded) and a lane's best class of each pair of its columns (8
    bytes), the Gumbel noise of its own columns of the logits (f32), the
    partial sums of the product with W_h, the cluster's parts of its own
    logits (f32, `_logit_parts` of them, of the columns of a round:
    `resident_rounds`; not over the x rows, which a slower CTA may still be
    multiplying when they land), two buffers of table-row sums (f32, the
    CTA's columns of x), its biases, each CTA's best class of a lane (8
    bytes), the window and the new samples, five mbarriers."""
    return _resident_layout(fs0, q, dim, cluster, width)[0]


def resident_rounds(fs0: int, q: int, dim: int, cluster: int,
                    width: int) -> int:
    """In how many rounds of its columns a CTA of the resident kernel takes
    the cluster's parts of its logits: the fewest (1, 2, 4, ..., each round
    whole 16-column tiles) with which the CTA fits `_SMEM_FIT`. 1 at every
    preset; more where q is large beside dim, whose parts (4 q bytes a lane
    and part) outgrow the x rows (2 dim)."""
    return _resident_layout(fs0, q, dim, cluster, width)[1]


def _resident_layout(fs0, q, dim, cluster, width):
    mh, mo, ksteps = dim // cluster, q // cluster, dim // 16
    split_h = _depth_split(mh // 16, ksteps)
    held = _REG_STEPS * width // SUBTILE if width > SUBTILE else 0
    kreg = min(ksteps // split_h, held)
    weights = (mh // 16) * (ksteps - split_h * kreg) * 512 + mh * q * 2
    # the x rows, and in the same bytes once x is read h and each lane's
    # best of each pair of its columns; the noise
    acts = width * max((dim + _ACT_PAD) * 2, (mh + _ACT_PAD) * 2
                       + (mo // 2) * 8) + width * mo * 4
    red = 4 * split_h * (width * (mh + _RED_PAD) + _PART_PAD)
    sums = 2 * width * mh * 4 + (mh + mo) * 4
    bests = width * cluster * 8
    seq = width * 2 * fs0 * 4
    rounds = 1
    while True:
        parts = 4 * _logit_parts(q, dim, cluster) * (
            width * (mo // rounds + _RED_PAD) + _PART_PAD)
        total = _align16(weights + acts + red + parts + sums + bests
                         + seq) + 5 * 8
        if total <= _SMEM_FIT or mo // rounds % 32:
            return total, rounds
        rounds *= 2


def _logit_parts(q: int, dim: int, cluster: int) -> int:
    """Parts a logit's sum has in the resident kernel: each CTA's rows of
    W_o, split over its warps' depth as a product of q / 16 tiles and dim /
    cluster / 16 steps is."""
    return cluster * _depth_split(q // 16, dim // cluster // 16)


def resident_push_bytes(q: int, dim: int, cluster: int) -> int:
    """Bytes that one lane's sample step writes into the shared memory of a
    resident cluster's CTAs, each CTA's own included: x (each CTA its dim /
    cluster columns, bf16, into every CTA), the partial logits (every part
    of every column, f32, into the CTA that owns the column) and each CTA's
    best of its columns (8 bytes into every CTA): 50 KiB at dim 1024, q
    256, cluster 16."""
    return (dim * 2 * cluster + q * 4 * _logit_parts(q, dim, cluster)
            + 8 * cluster * cluster)


def _width_ok(q: int, cluster: int, width: int) -> bool:
    """Whether a pass of `width` lanes has at most one task (four columns
    of a lane's logits) a compute thread."""
    return q // cluster // 4 * width <= RESIDENT_WARPS * 32


def resident_widths(fs0: int, q: int, dim: int, cluster: int,
                    smem_bytes: int) -> list:
    """The widths of a pass (RESIDENT_WIDTHS) that a cluster of `cluster`
    CTAs of the resident kernel can carry in `smem_bytes` a CTA."""
    return [w for w in RESIDENT_WIDTHS if _width_ok(q, cluster, w)
            and resident_smem_bytes(fs0, q, dim, cluster, w) <= smem_bytes]


def resident_width(fs0: int, q: int, dim: int, cluster: int,
                   smem_bytes: int, lanes: int) -> int:
    """The width of the passes in which a cluster walks through `lanes`:
    the narrowest that takes the fewest passes any width that fits takes
    (a share of 8 lanes or fewer stays at 8)."""
    widths = resident_widths(fs0, q, dim, cluster, smem_bytes)
    passes = -(-lanes // widths[-1])
    return min(w for w in widths if -(-lanes // w) == passes)


def plan_passes(plan: WindowPlan) -> int:
    """The most passes a cluster of a resident plan makes."""
    return -(-plan.lanes_per_cluster // plan.subtile)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def grid_smem_bytes(fs0: int, q: int, dim: int, groups: int, wsize: int,
                    tile: int = 1) -> int:
    """Shared memory of one CTA of the grid kernel with `groups` CTAs a
    replica, weights of `wsize` bytes, multiplying `tile` lanes at once: its
    slice of W_h and W_o; then, in the same bytes, the larger of the
    products' buffers (x of `tile` lanes and its columns of h, f32, the
    partial sums of a product whose depth spans more than a warp) and the
    owners' (the logits and the windows of the lanes it draws for); an
    mbarrier."""
    nh = dim // groups

    def red(n):
        parts = GRID_THREADS // (n // 4)
        return parts // 32 * tile * n if parts > 32 else 0
    products = (tile * dim + tile * nh + max(red(nh), red(q))) * 4
    owners = _OWN_CHUNK * q * 4 + _OWN_CHUNK * fs0 * 4
    return _align16(_align16(nh * (dim + q) * wsize)
                    + max(products, owners)) + 8


def grid_shape_ok(fs0: int, q: int, dim: int, groups: int) -> bool:
    """Whether `groups` CTAs split the weights in column groups of 4, and
    their depth in blocks of 4 a thread, as the grid kernel's products
    divide them among their threads."""
    if fs0 < 1 or not _pow2(groups) or dim % groups:
        return False
    nh = dim // groups
    return (_pow2(nh) and 4 <= nh <= 4 * GRID_THREADS and _pow2(q)
            and 4 <= q <= 4 * GRID_THREADS
            and dim % (4 * GRID_THREADS // (nh // 4)) == 0)


def grid_groups(fs0: int, q: int, dim: int, dtype,
                smem_bytes: int) -> int:
    """The fewest CTAs whose shared memory holds W_h and W_o of `dtype`
    between them (beside the buffers of one lane), for the grid kernel; 0:
    none."""
    wsize = torch.empty((), dtype=dtype).element_size()
    groups = 1
    while groups <= dim:
        if (grid_shape_ok(fs0, q, dim, groups) and grid_smem_bytes(
                fs0, q, dim, groups, wsize) <= smem_bytes):
            return groups
        groups *= 2
    return 0


def grid_tile(fs0: int, q: int, dim: int, groups: int, dtype,
              smem_bytes: int, want: int = GRID_TILE) -> int:
    """The most lanes (of GRID_TILES, up to `want`) that a CTA of the grid
    kernel with `groups` CTAs a replica can multiply at once in
    `smem_bytes`."""
    wsize = torch.empty((), dtype=dtype).element_size()
    for tile in reversed([t for t in GRID_TILES if t <= want]):
        if grid_smem_bytes(fs0, q, dim, groups, wsize, tile) <= smem_bytes:
            return tile
    return 1


def resident_cluster(fs0: int, q: int, dim: int, smem_bytes: int) -> int:
    """The smallest cluster whose CTAs can hold W_h and W_o (dim x dim,
    dim x q, bf16) between them in whole 16-column tiles, few enough for
    a CTA's threads, beside the lanes of a pass of some width; 0: none.
    Small, because what the CTAs exchange grows with their number."""
    if fs0 < 1 or dim < 16 or dim % 16:
        return 0
    for c in CLUSTER_SIZES:
        if (dim % (16 * c) == 0 and q % (16 * c) == 0
                and dim // c <= _MAX_OWN_H and q // c <= _MAX_OWN_O
                and resident_widths(fs0, q, dim, c, smem_bytes)):
            return c
    return 0


def window_plan(B, fs0, q, dim, dtype, max_clusters, smem_bytes,
                grid_ctas=0) -> WindowPlan:
    """Choose the kernel and its launch for a window of B lanes, on a
    device whose CTAs may use `smem_bytes` of shared memory, which holds
    `max_clusters` clusters of the resident kernel at once (of the size
    `resident_cluster` names) and `grid_ctas` CTAs of the grid kernel (on
    a card: the occupancy API's answers). The resident
    kernel needs bf16 weights, a cluster that holds them and at least one
    such cluster granted; as many clusters as granted, at least 8 lanes
    each, share the lanes evenly, and each walks through its share in the
    fewest passes that a width which fits allows, at the narrowest width
    that takes that many (`resident_width`). Everything else takes the grid kernel where
    the card holds the `grid_groups` CTAs that keep the weights: as many
    replicas of them as it holds, up to one per 8 lanes, share the lanes
    evenly, each CTA multiplying as many at a time (up to 16) as its
    shared memory holds beside the weights. Raises for a type, an empty
    window, or a window that neither kernel takes on this device."""
    if dtype not in _DTYPES:
        raise TypeError(f"weights must be float32 or bfloat16, got {dtype}")
    if B < 1 or fs0 < 1:
        raise ValueError(f"empty window: B={B}, fs0={fs0}")
    if dim % 8 or q % 8:
        raise ValueError(f"dim ({dim}) and q ({q}) must be multiples of 8")
    cluster = (resident_cluster(fs0, q, dim, smem_bytes)
               if dtype == torch.bfloat16 and max_clusters >= 1 else 0)
    if cluster:
        clusters = min(max_clusters, -(-B // SUBTILE))
        lanes = -(-B // clusters)
        width = resident_width(fs0, q, dim, cluster, smem_bytes, lanes)
        return WindowPlan("resident", cluster, clusters, lanes, width,
                          resident_smem_bytes(fs0, q, dim, cluster, width))
    groups = grid_groups(fs0, q, dim, dtype, smem_bytes) if grid_ctas else 0
    if groups and grid_ctas >= groups:
        replicas = min(grid_ctas // groups, -(-B // REPLICA_LANES))
        per = -(-B // replicas)
        tile = grid_tile(fs0, q, dim, groups, dtype, smem_bytes,
                         1 << (per - 1).bit_length())
        wsize = torch.empty((), dtype=dtype).element_size()
        return WindowPlan("grid", groups, replicas, per, tile,
                          grid_smem_bytes(fs0, q, dim, groups, wsize, tile))
    raise ValueError(
        f"no kernel takes a window of {dtype} weights at dim {dim}, q {q}, "
        f"fs0 {fs0} on a device that grants {max_clusters} resident "
        f"clusters, {grid_ctas} grid CTAs and {smem_bytes} B of shared "
        f"memory a CTA")


def plan_lanes(plan: WindowPlan, B: int):
    """[(first lane, lanes)] of each cluster (grid: each replica), as the
    kernels compute it: contiguous shares that differ by at most one."""
    base, rem = divmod(B, plan.clusters)
    return [(c * base + min(c, rem), base + (c < rem))
            for c in range(plan.clusters)]


# (device index, fs0, q, dim, dtype) -> (max clusters, smem, grid CTAs)
_limits = {}


def device_limits(device, fs0, q, dim, dtype):
    """(clusters of the resident kernel that a CUDA device holds at once at
    these shapes, most dynamic shared memory of a CTA, CTAs of the grid
    kernel for weights of `dtype` that it holds at once): window_plan's
    last three arguments, from the occupancy API. 0 clusters
    (CTAs) where no cluster (no grid of the card's CTAs) holds the
    weights."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    key = (index, fs0, q, dim, dtype)
    if key not in _limits:
        lib = build()
        smem = ctypes.c_int()
        held = 0
        with torch.cuda.device(index):
            _raise_on(lib, lib.sample_window_device(ctypes.byref(smem)),
                      "device query")
            cluster = resident_cluster(fs0, q, dim, smem.value)
            if cluster:
                _check_resident(lib, fs0, q, dim, cluster)
                # the occupancy with the most shared memory a width that
                # fits asks for: no other holds fewer clusters
                widest = max(
                    resident_widths(fs0, q, dim, cluster, smem.value),
                    key=lambda w: resident_smem_bytes(fs0, q, dim, cluster,
                                                      w))
                held = lib.sample_window_max_clusters(fs0, q, dim, cluster,
                                                      widest)
                _raise_on(lib, max(-held, 0), "occupancy query")
            ctas = 0
            groups = grid_groups(fs0, q, dim, dtype, smem.value)
            if groups:
                # the occupancy with the shared memory of the widest tile
                # that fits: no narrower one holds fewer CTAs
                tile = grid_tile(fs0, q, dim, groups, dtype, smem.value)
                code, wsize = _DTYPES[dtype], torch.empty(
                    (), dtype=dtype).element_size()
                if (lib.sample_window_grid_smem(code, fs0, q, dim, groups,
                                                tile)
                        != grid_smem_bytes(fs0, q, dim, groups, wsize, tile)):
                    raise RuntimeError("the kernel's shared-memory plan "
                                       "differs from grid_smem_bytes")
                ctas = lib.sample_window_grid_ctas(code, fs0, q, dim, groups,
                                                   tile)
                _raise_on(lib, max(-ctas, 0), "grid occupancy query")
        _limits[key] = (held, smem.value, ctas)
    return _limits[key]


def _check_resident(lib, fs0, q, dim, cluster):
    """Raise where the kernel's shared memory differs from
    resident_smem_bytes at some width."""
    for w in RESIDENT_WIDTHS:
        want = (resident_smem_bytes(fs0, q, dim, cluster, w)
                if _width_ok(q, cluster, w) else -1)
        if lib.sample_window_resident_smem(fs0, q, dim, cluster, w) != want:
            raise RuntimeError(f"the kernel's shared-memory plan at width "
                               f"{w} differs from resident_smem_bytes")


def resident_weights(wh, wo, fs0: int):
    """What a sampler makes once and hands to every `sample_window` call as
    `packed=`: the packed weights where windows of these weights take the
    resident or the grid kernel (whose packing does not depend on the
    batch), else None (CPU tensors). Raises where no kernel takes
    them."""
    if wh.device.type != "cuda" or wh.dtype not in _DTYPES:
        return None
    dim, q = wo.shape
    plan = _plan_on(wh.device, 1, fs0, q, dim, wh.dtype)
    pack = (pack_window_weights if plan.path == "resident"
            else pack_grid_weights)
    return pack(wh, wo, plan.cluster)


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"sample_window {what} failed: "
                           + lib.sample_window_error_string(err).decode())


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
    return batch, fs0, q, dim


def _check_cuda(table, wh, bh, wo, bo, slots, buf, noise, seed, packed):
    for t in (table, wh, bh, wo, bo, noise, seed, packed):
        if t is not None and not t.is_contiguous():
            raise ValueError("inputs other than buf and slots must be "
                             "contiguous")
    if buf.stride(1) != 1 or slots.stride(2) != 1:
        raise ValueError("the rows of buf and slots must be contiguous")
    if slots.stride(0) % 8 or slots.stride(1) % 8:
        raise ValueError("the strides of slots must be multiples of 8")
    for t in (table, wh, wo, bh, bo, slots, packed):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("weights, biases and slots must be 16-byte "
                             "aligned")


def _plan_on(device, batch, fs0, q, dim, dtype):
    return window_plan(batch, fs0, q, dim, dtype,
                       *device_limits(device, fs0, q, dim, dtype))


def sample_window(table, wh, bh, wo, bo, slots, buf, *, noise=None,
                  seed=None, packed=None):
    """fs0 samples per lane -> (B, fs0) int32 (layouts in the module
    docstring), with Gumbel `noise` given or drawn from Philox keyed on
    `seed`. CUDA tensors launch the kernel that `window_plan` names, and
    raise where it names none; CPU tensors run the plain version.

    packed: `resident_weights(wh, wo, fs0)`, made once by a caller that
    samples many windows (or flattened, as `pack_window_weights_op`
    returns it); without it the resident or grid kernel's weights are
    packed in this call; the plain version does not read it."""
    batch, fs0, q, dim = _check(table, wh, bh, wo, bo, slots, buf, noise,
                                seed)
    if table.device.type == "cpu":
        if noise is None:
            noise = philox_gumbel_noise(seed, batch, fs0, q)
        return sample_window_reference(table, wh, bh, wo, bo, slots, buf,
                                       noise)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    dev = table.device
    out = torch.empty((batch, fs0), dtype=torch.int32, device=dev)
    if batch == 0:
        return out
    plan = _plan_on(dev, batch, fs0, q, dim, table.dtype)
    _check_cuda(table, wh, bh, wo, bo, slots, buf, noise, seed, packed)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    strides = (buf.stride(0), slots.stride(0), slots.stride(1))
    if packed is None:
        pack = (pack_window_weights if plan.path == "resident"
                else pack_grid_weights)
        packed = pack(wh, wo, plan.cluster)
    else:
        if packed.dim() == 1 and packed.numel() == (dim + q) * dim:
            packed = packed.view(plan.cluster, -1)
        if (packed.dtype != table.dtype or packed.device != dev
                or tuple(packed.shape) != (plan.cluster, (dim + q)
                                           // plan.cluster * dim)):
            raise ValueError(f"packed does not hold these weights for "
                             f"the {plan.path} kernel's "
                             f"{plan.cluster} CTAs")
    if plan.path == "resident":
        err = lib.sample_window_resident_launch(
            ptr(table), ptr(packed), ptr(bh), ptr(bo), ptr(slots), ptr(buf),
            ptr(noise), ptr(seed), ptr(out), batch, fs0, q, dim, *strides,
            plan.cluster, plan.clusters, plan.subtile, stream)
    else:
        f32 = {"dtype": torch.float32, "device": dev}
        xg = torch.empty((batch, dim), **f32)
        part = torch.empty((plan.cluster, batch, q), **f32)
        counter = torch.empty(1, dtype=torch.int32, device=dev)
        err = lib.sample_window_grid_launch(
            _DTYPES[table.dtype], plan.subtile, ptr(table), ptr(packed),
            ptr(bh), ptr(bo), ptr(slots), ptr(buf), ptr(noise), ptr(seed),
            ptr(out), ptr(xg), ptr(part), ptr(counter), batch, fs0, q, dim,
            *strides, plan.cluster, plan.clusters, stream)
    _raise_on(lib, err, f"{plan.path} launch")
    sample_window.launches += 1
    setattr(sample_window, plan.path, getattr(sample_window, plan.path) + 1)
    if plan.path == "resident":
        sample_window.lanes += batch
        sample_window.passes += plan.clusters * plan_passes(plan)
    return out


sample_window.launches = 0
sample_window.resident = 0
sample_window.grid = 0
sample_window.lanes = 0
sample_window.passes = 0


# --------------------------------------------------------------------------
# the operators torch.export traces
# --------------------------------------------------------------------------

@torch.library.custom_op(
    "msnv_torch::sample_window", mutates_args=(),
    schema="(Tensor table, Tensor wh, Tensor bh, Tensor wo, Tensor bo, "
           "Tensor slots, Tensor buf, Tensor seed, Tensor? packed) -> Tensor")
def sample_window_op(table, wh, bh, wo, bo, slots, buf, seed, packed):
    """`sample_window(..., seed=seed, packed=packed)` as an operator: the
    kernel its plan names on CUDA tensors (planned on these tensors, on
    every call), else the plain version. -> (B, fs0) int32."""
    return sample_window(table, wh, bh, wo, bo, slots, buf, seed=seed,
                         packed=packed)


@sample_window_op.register_fake
def _(table, wh, bh, wo, bo, slots, buf, seed, packed):
    return buf.new_empty(buf.shape)


@torch.library.custom_op(
    "msnv_torch::pack_window_weights", mutates_args=(),
    schema="(Tensor wh, Tensor wo, int fs0) -> Tensor")
def pack_window_weights_op(wh, wo, fs0):
    """W_h and W_o for `sample_window_op`'s `packed`, flat ((dim + q) *
    dim,): `resident_weights` for the plan that windows of these weights
    take on this device, decided when the operator runs; on the CPU, W_h
    and W_o flattened and joined (which the plain version does not
    read)."""
    packed = resident_weights(wh, wo, fs0)
    if packed is None:
        return torch.cat([wh.reshape(-1), wo.reshape(-1)])
    return packed.reshape(-1)


@pack_window_weights_op.register_fake
def _(wh, wo, fs0):
    dim, q = wo.shape
    return wh.new_empty(((dim + q) * dim,))


def empty_window(batch, fs0, q, dim, device, dtype=torch.bfloat16):
    """Launch the grid of the kernel that a window of `batch` lanes with
    weights of `dtype` takes (resident or grid) through its exchanges and
    no other work: the cost of a window's step-to-step dependence alone,
    for timing beside the real kernel. Resident: per sample and pass the
    three exchanges with their bytes (x, the partial logits and each CTA's
    best: `resident_push_bytes` a lane), every CTA waiting for everyone's;
    grid: its 2 fs0 grid barriers. Returns the plan; raises where no
    kernel takes the window."""
    plan = _plan_on(device, batch, fs0, q, dim, dtype)
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    if plan.path == "resident":
        err = lib.sample_window_empty_launch(
            batch, fs0, q, dim, plan.cluster, plan.clusters, plan.subtile,
            stream)
    else:
        counter = torch.empty(1, dtype=torch.int32, device=device)
        err = lib.sample_window_grid_empty_launch(
            _DTYPES[dtype], fs0, q, dim, plan.cluster, plan.clusters,
            plan.subtile, counter.data_ptr(), stream)
    _raise_on(lib, err, "empty window launch")
    return plan
