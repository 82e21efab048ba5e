"""The grid sample-window kernel's plan, packing and decomposition on the
CPU: which windows `window_plan` sends to it, its packed weights, and a
plain-tensor emulation of its partial sums (`grid_window_emulation`, here)
against the JAX Pallas kernel in interpret mode on shared Gumbel noise. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py (phase 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.pallas.sample_kernel import make_sample_window
from msnv_tpu_torch.kernels import sample_window as sw

SMEM = 232448        # the most shared memory a CTA of an H100 may ask for
SMS = 132
BF16, F32 = torch.bfloat16, torch.float32


def unpack_grid_weights(packed, dim, q, groups):
    """The inverse of `sw.pack_grid_weights`: -> (wh (dim, dim), wo (dim,
    q)), by where the packing puts each element's flat index."""
    if tuple(packed.shape) != (groups, dim // groups * (dim + q)):
        raise ValueError(f"packed weights have shape {tuple(packed.shape)}")
    ids = sw.pack_grid_weights(
        torch.arange(dim * dim).reshape(dim, dim),
        torch.arange(dim * dim, dim * (dim + q)).reshape(dim, q), groups)
    w = torch.empty(dim * (dim + q), dtype=packed.dtype)
    w[ids.reshape(-1)] = packed.reshape(-1)
    return w[:dim * dim].reshape(dim, dim), w[dim * dim:].reshape(dim, q)


def grid_product(inp, w, block=1):
    """The grid kernel's product as plain tensor code: inp (B, k) f32, w
    (n / 4, k, 4) -> (B, n). The depth of a column group is split over P =
    GRID_THREADS / (n / 4) parts: part s takes depths s, s + P, ... (block
    1) or the blocks of four depths 4 (s + j P) + 0 .. 3 (block 4), summed
    in order; the parts meet by a butterfly (xor, offsets 1, 2, 4, ...)
    inside groups of 32 and those groups' sums are added in order."""
    batch, k = inp.shape
    ncg = w.shape[0]
    parts = sw.GRID_THREADS // ncg
    steps = -(-k // (parts * block))
    pad = steps * parts * block - k
    x = torch.nn.functional.pad(inp, (0, pad)).view(batch, steps, parts,
                                                    block)
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad)).view(ncg, steps, parts,
                                                         block, 4)
    acc = torch.zeros(batch, ncg, parts, 4, dtype=torch.float32)
    for j in range(steps):
        for dd in range(block):
            acc = acc + x[:, None, j, :, dd, None] * wp[None, :, j, :, dd]
    seg = min(parts, 32)
    off = 1
    while off < seg:
        acc = acc + acc[:, :, torch.arange(parts) ^ off]
        off *= 2
    warps = acc.view(batch, ncg, -1, seg, 4)[:, :, :, 0]
    v = warps[:, :, 0]
    for p in range(1, warps.shape[2]):
        v = v + warps[:, :, p]
    return v.reshape(batch, ncg * 4)


def grid_window_emulation(table, packed, bh, bo, slots, buf, noise, groups):
    """The grid kernel's decomposition as plain tensor code (given noise):
    x gathered as the plain version gathers it; for each of the `groups`
    CTAs of a replica its columns of h from its slice of
    `sw.pack_grid_weights`, then its partial logits from its rows of W_o;
    the partials added in group order, then b_o; the draw. -> (samples (B,
    fs0) int32, logits (B, fs0, q) f32). Products by multiply-then-add
    where the kernel fuses them, so the logits agree to rounding, not bit
    for bit."""
    batch, fs0 = buf.shape
    dim = table.shape[1]
    q = bo.shape[0]
    nh = dim // groups
    wdtype = table.dtype
    # each CTA's columns of W_h and rows of W_o, as [column group][depth][4]
    wh, wo = (t.float() for t in unpack_grid_weights(
        packed.reshape(groups, -1), dim, q, groups))
    wh_s = wh.reshape(dim, groups, nh // 4, 4).permute(1, 2, 0, 3)
    wo_s = wo.reshape(groups, nh, q // 4, 4).permute(0, 2, 1, 3)
    offsets = torch.arange(fs0, dtype=torch.int64) * q
    win, seen = buf, []
    for k in range(fs0):
        rows = table[win.long() + offsets].float()
        acc = rows[:, 0]
        for p in range(1, fs0):
            acc = acc + rows[:, p]
        x = torch.relu(acc + slots[:, k].float()).to(wdtype).float()
        logits = None
        for g in range(groups):
            h = torch.relu(grid_product(x, wh_s[g], block=4)
                           + bh[g * nh:(g + 1) * nh]).to(wdtype).float()
            part = grid_product(h, wo_s[g])
            logits = part if logits is None else logits + part
        logits = logits + bo
        seen.append(logits)
        s = torch.argmax(logits + noise[:, k], dim=-1).to(torch.int32)
        win = torch.cat([win[:, 1:], s[:, None]], dim=1)
    return win, torch.stack(seen, 1)


def _covered_once(plan, batch):
    lanes = [b for first, n in sw.plan_lanes(plan, batch)
             for b in range(first, first + n)]
    return lanes == list(range(batch))


# (dtype, dim, CTAs of the grid kernel the card holds, path, CTAs a replica)
PLANS = [
    (F32, 128, SMS, "grid", 1),
    (F32, 1024, SMS, "grid", 32),
    (F32, 2048, SMS, "grid", 128),
    (BF16, 2048, SMS, "grid", 64),
    (BF16, 1024, SMS, "resident", 16),
    (F32, 1024, 0, "tiled", 1),
    (F32, 128, 0, "tiled", 1),
    (BF16, 2048, 0, "tiled", 1),
    (F32, 1024, 31, "tiled", 1),       # fewer CTAs than one replica needs
]


@pytest.mark.parametrize("batch", [1, 3, 128, 1024])
@pytest.mark.parametrize("dtype,dim,ctas,path,cluster", PLANS)
def test_window_plan_names_the_grid_path(dtype, dim, ctas, path, cluster,
                                         batch):
    plan = sw.window_plan(batch, 20, 256, dim, dtype, 8, SMEM, SMS, ctas)
    assert plan.path == path and plan.cluster == cluster
    assert _covered_once(plan, batch) and plan.smem_bytes <= SMEM
    if path != "grid":
        return
    wsize = 4 if dtype == F32 else 2
    assert plan.cluster == sw.grid_groups(20, 256, dim, dtype, SMEM)
    assert plan.smem_bytes == sw.grid_smem_bytes(20, 256, dim, cluster,
                                                 wsize, plan.subtile)
    # replicas of the weights: as many as the card holds, one per 8 lanes
    assert plan.clusters == min(ctas // cluster,
                                -(-batch // sw.REPLICA_LANES))
    assert plan.clusters * plan.cluster <= ctas
    shares = [n for _, n in sw.plan_lanes(plan, batch)]
    assert max(shares) == plan.lanes_per_cluster
    assert max(shares) - min(shares) <= 1
    # the widest tile that fits, up to the lanes of a replica
    assert plan.subtile in sw.GRID_TILES
    assert plan.subtile == sw.grid_tile(
        20, 256, dim, cluster, dtype, SMEM,
        1 << (max(shares) - 1).bit_length())
    if plan.subtile < min(sw.GRID_TILE, max(shares)):
        assert sw.grid_smem_bytes(20, 256, dim, cluster, wsize,
                                  2 * plan.subtile) > SMEM


@pytest.mark.parametrize("dtype,dim,want", [(F32, 128, 1), (F32, 1024, 32),
                                            (F32, 2048, 128),
                                            (BF16, 1024, 16),
                                            (BF16, 2048, 64),
                                            (F32, 1088, 0)])
def test_grid_groups_are_the_fewest_that_hold_the_weights(dtype, dim, want):
    assert sw.grid_groups(20, 256, dim, dtype, SMEM) == want
    if want > 1:
        wsize = 4 if dtype == F32 else 2
        assert sw.grid_smem_bytes(20, 256, dim, want, wsize) <= SMEM
        assert sw.grid_smem_bytes(20, 256, dim, want // 2, wsize) > SMEM
    # the owners' logits of 8 lanes alone are 8 KB
    assert sw.grid_groups(20, 256, dim, dtype, 1 << 12) == 0


@pytest.mark.parametrize("tile", [1, 16])
def test_grid_smem_formula_at_the_canonical_shape(tile):
    # 32 columns of W_h (1024 deep) and 32 rows of W_o, f32; then the larger
    # of x and h for `tile` lanes (no partial sums past a warp: 32 and 4
    # parts) and the owners' logits and windows of 8 lanes; an mbarrier
    products = tile * 1024 * 4 + tile * 32 * 4
    owners = 8 * 256 * 4 + 8 * 20 * 4
    want = 32 * (1024 + 256) * 4 + max(products, owners) + 8
    assert sw.grid_smem_bytes(20, 256, 1024, 32, 4, tile) == want <= SMEM
    assert sw.grid_tile(20, 256, 1024, 32, F32, SMEM) == 16


@pytest.mark.parametrize("dim,q,groups", [(64, 16, 1), (128, 16, 4),
                                          (128, 256, 2), (1024, 256, 32)])
def test_pack_unpack_grid_weights(dim, q, groups):
    rng = np.random.RandomState(dim + groups)
    wh = torch.from_numpy(rng.randn(dim, dim).astype(np.float32))
    wo = torch.from_numpy(rng.randn(dim, q).astype(np.float32))
    packed = sw.pack_grid_weights(wh, wo, groups)
    nh = dim // groups
    assert packed.shape == (groups, nh * (dim + q)) and packed.is_contiguous()
    back_h, back_o = unpack_grid_weights(packed, dim, q, groups)
    assert torch.equal(back_h.view(torch.int32), wh.view(torch.int32))
    assert torch.equal(back_o.view(torch.int32), wo.view(torch.int32))
    # every column of W_h (all of its depth) and every row of W_o (all of
    # q) lies in exactly one CTA's slice: its own columns / rows
    ids_h = torch.arange(dim * dim, dtype=torch.int32).reshape(dim, dim)
    ids_o = torch.arange(dim * q, dtype=torch.int32).reshape(dim, q)
    ids = sw.pack_grid_weights(ids_h, ids_o, groups)
    for g in range(groups):
        assert sorted(ids[g, :nh * dim].tolist()) == sorted(
            ids_h[:, g * nh:(g + 1) * nh].reshape(-1).tolist())
        assert sorted(ids[g, nh * dim:].tolist()) == sorted(
            ids_o[g * nh:(g + 1) * nh].reshape(-1).tolist())
    # a thread's four columns of one depth are neighbours, and the threads
    # of a column group (P of them) take neighbouring blocks of four depths
    parts = sw.GRID_THREADS // (nh // 4)
    assert torch.equal(ids[0, :4], ids_h[0, :4])
    assert torch.equal(ids[0, 4:8], ids_h[4, :4])
    assert torch.equal(ids[0, 4 * parts:4 * parts + 4], ids_h[1, :4])


def test_pack_grid_rejects_what_cannot_split():
    with pytest.raises(ValueError):
        sw.pack_grid_weights(torch.zeros(64, 64), torch.zeros(64, 16), 32)
    with pytest.raises(ValueError):
        sw.pack_grid_weights(torch.zeros(64, 32), torch.zeros(64, 16), 1)
    with pytest.raises(ValueError):
        unpack_grid_weights(torch.zeros(2, 100), 64, 16, 2)


@pytest.mark.parametrize("k,n,block", [(64, 16, 1), (64, 64, 1),
                                       (1024, 32, 1), (4, 256, 1),
                                       (32, 256, 1), (64, 64, 4),
                                       (1024, 32, 4), (1024, 16, 4)])
def test_grid_product_is_the_product(k, n, block):
    """The product's split of the depth (parts within a warp, warps in
    order; single depths or blocks of four) adds up to x @ W at float32
    rounding."""
    rng = np.random.RandomState(k + n)
    x = torch.from_numpy(rng.randn(3, k).astype(np.float32))
    w = torch.from_numpy(rng.randn(k, n).astype(np.float32))
    got = grid_product(x, w.reshape(k, n // 4, 4).permute(1, 0, 2), block)
    want = (x.double() @ w.double()).float()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _inputs(fs0, q, dim, batch, seed):
    """Window inputs from numpy: the port's lane-major layout and the JAX
    kernel's (slots and noise step-major)."""
    rng = np.random.RandomState(seed)
    table = (rng.randn(fs0 * q, dim) / np.sqrt(fs0)).astype(np.float32)
    wh = (rng.randn(dim, dim) / np.sqrt(dim)).astype(np.float32)
    wo = (3 * rng.randn(dim, q) / np.sqrt(dim)).astype(np.float32)
    bh = (0.1 * rng.randn(dim)).astype(np.float32)
    bo = (0.1 * rng.randn(q)).astype(np.float32)
    slots = rng.randn(batch, fs0, dim).astype(np.float32)
    buf = rng.randint(0, q, (batch, fs0)).astype(np.int32)
    u = rng.uniform(1e-6, 1.0, (batch, fs0, q))
    noise = (-np.log(-np.log(u))).astype(np.float32)
    return table, wh, bh, wo, bo, slots, buf, noise


@pytest.mark.parametrize("dim,groups", [(64, 1), (128, 1), (128, 2),
                                        (128, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_emulation_equals_pallas_interpret(dim, groups, seed):
    """fs0 4, q 16, dim 64 (and 128, split over up to 4 CTAs), B 3: the
    emulated decomposition (partial sums of each CTA of a replica, added in
    the kernel's order) draws the samples the Pallas kernel draws on the
    same noise, and its logits agree with float64 ones along the same
    windows to 1e-5 of the largest."""
    fs0, q, batch = 4, 16, 3
    table, wh, bh, wo, bo, slots, buf, noise = _inputs(fs0, q, dim, batch,
                                                       seed)
    kern = make_sample_window(fs0, q, dim, batch, interpret=True)
    want = np.asarray(kern(
        jnp.asarray(table), jnp.asarray(wh), jnp.asarray(bh)[None],
        jnp.asarray(wo), jnp.asarray(bo)[None],
        jnp.asarray(slots.transpose(1, 0, 2)), jnp.asarray(buf),
        jnp.asarray(noise.transpose(1, 0, 2))))
    t = torch.from_numpy
    packed = sw.pack_grid_weights(t(wh), t(wo), groups)
    got, logits = grid_window_emulation(t(table), packed, t(bh), t(bo),
                                        t(slots), t(buf), t(noise), groups)
    np.testing.assert_array_equal(got.numpy(), want)
    # float64 logits along the same windows
    seq = np.concatenate([buf, want], 1)
    for k in range(fs0):
        rows = table[np.arange(fs0) * q + seq[:, k:k + fs0]].astype(np.float64)
        x = np.maximum(rows.sum(1) + slots[:, k], 0)
        h = np.maximum(x @ wh + bh, 0)
        ref = h @ wo + bo
        err = np.abs(logits[:, k].double().numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (k, err)


def test_grid_emulation_equals_the_plain_version_in_bf16():
    """bf16 weights (a width no cluster holds takes the grid kernel): the
    emulation casts x and h as the plain version does; on sharpened logits
    the draws are the plain version's (dim 128 over 4 CTAs)."""
    fs0, q, dim, batch = 4, 16, 128, 3
    args = [torch.from_numpy(a) for a in _inputs(fs0, q, dim, batch, 5)]
    table, wh, bh, wo, bo, slots, buf, noise = args
    table, wh, slots = table.to(BF16), wh.to(BF16), slots.to(BF16)
    wo = (wo * 30).to(BF16)
    packed = sw.pack_grid_weights(wh, wo, 4)
    got, _ = grid_window_emulation(table, packed, bh, bo, slots, buf,
                                   noise, 4)
    want = sw.sample_window_reference(table, wh, bh, wo, bo, slots, buf,
                                      noise)
    assert torch.equal(got, want)


def test_grid_weights_are_for_cuda_tensors_only():
    assert sw.resident_weights(torch.zeros(64, 64),
                               torch.zeros(64, 256), 20) is None
    # the operator the artifact traces: W_h and W_o joined on the CPU
    flat = sw.pack_window_weights_op(torch.ones(64, 64), torch.ones(64, 16), 4)
    assert flat.shape == ((64 + 16) * 64,)
