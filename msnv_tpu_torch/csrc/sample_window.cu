// Sample-window kernels: the bottom tier's fs0 sequential samples of every
// lane, in one launch per window.
//
// Replace the JAX package's pallas/sample_kernel.py `_window_kernel` (v1,
// noise given as input), `_window_kernel_v2` and `_window_kernel_v3`
// (in-kernel PRNG). Per lane and per sample k in [0, fs0):
//
//   x      = relu(slot[k] + sum_p table[p*q + win[p]])   (f32, cast to W)
//   h      = relu(x @ W_h + b_h)                          (f32 acc, cast to W)
//   logits = h @ W_o + b_o                                (f32)
//   s      = argmax(logits + gumbel)    first index on ties, like jnp.argmax
//   win    = win[1:] ++ [s]
//
// and the final window (B, fs0) int32 is the output: after fs0 steps it
// holds exactly the fs0 new samples. W is float or bf16. The temperature is
// folded into W_o / b_o by the caller. The window is read as fs0 columns of
// a wider buffer through a row stride, the slot rows through two strides.
//
// Noise: either given as (B, fs0, q) f32 Gumbel noise (the v1 mode and
// the CPU reference's mode), or drawn here from Philox-4x32-10 keyed on a
// 64-bit seed read from device memory, with counter (class/4, k, lane, 0)
// — so a draw depends on (seed, lane, step, class) only, never on how the
// lanes are spread over CTAs or clusters, and both kernels below draw the
// same bits. u = ((bits >> 8) + 0.5) / 2^24 as in the TPU kernel's draw.
//
// What bounds it on the H100. Per sample every lane needs the whole W_h
// (dim x dim) and W_o (dim x q), 2.5 MB in bf16 at dim 1024, q 256, and
// only fs0 table rows; the fs0 samples of a lane depend on each other. A
// window's least time (the weights once from device memory, or its
// multiply-adds at the tensor cores' rate) is microseconds, so neither
// bytes nor operations bound it: the chain of fs0 dependent samples does,
// and what one sample costs besides its products.
//
// The resident kernel (bf16; `window_resident`). On the TPU the weights sit
// in VMEM for the whole window; here no SM holds them, but a thread-block
// cluster does. A cluster of C CTAs (16 at dim 1024: 16 x 160 KB) keeps W_h
// and W_o in its shared memory for all fs0 steps and for every lane it
// walks through:
//  - Each CTA owns dim / C output columns of W_h and q / C of W_o, all of
//    the depth, so no partial sum crosses the SM-to-SM network. The caller
//    packs the weights once (not per window) so that a CTA's slice is one
//    contiguous block, already in the register order of the tensor cores'
//    `mma`: one thread asks the TMA for it in bulk copies reported to
//    an mbarrier, and a product's thread fetches its whole A operand with
//    one conflict-free 16-byte shared-memory load.
//  - A cluster takes a contiguous share of the lanes and walks through it
//    in sub-tiles of 8 lanes: the lanes are the narrow side (n = 8) of
//    `mma.sync` m16n8k16 (bf16 in, f32 sums), the weights' columns its 16
//    rows. A sub-tile this narrow is not worth a warpgroup's `wgmma`, and 16
//    lanes of activations do not fit beside 160 KB of weights. 16 warps
//    split a product by 16-column tile and by depth; the partial sums over
//    depth are added in a fixed order, so two runs give the same bits.
//  - What crosses the network per sample is small and is pushed, not
//    fetched (remote loads stall on the network's latency): every CTA
//    computes its columns of x, of h and of the logits for the live lanes
//    and writes each into the shared memory of all C CTAs with `st.async`,
//    a store that reports its bytes to an mbarrier of the receiving CTA. A
//    CTA goes on when the bytes it expects of a row have arrived (bounded
//    wait, traps): three such exchanges per sample take the place of
//    `__syncthreads`, at about a third of what a hardware cluster barrier
//    costs in a cluster of 16. Each value is sent by several threads, each
//    to a few of the CTAs, so no thread has many stores in a row. Every
//    CTA adds the Gumbel noise of its own columns to its logits before it
//    sends them, and every CTA repeats the argmax on its own copy, so the
//    new sample needs no fourth exchange. A cluster barrier at the start (every CTA
//    runs, its mbarriers ready) and one at the end (nobody writes into the
//    shared memory of a CTA that is gone) are all that is left of them.
//  - A step is a chain of short dependent pieces, so what counts is how
//    few operations lie on it. Four extra warps only gather: x is the sum
//    of fs0 table rows from L2 (in position order, f32) plus the slot row,
//    and all but the last row are known a step ahead, so the gather warps
//    add those while the others multiply; when a sample is drawn, one
//    table row and the slot row are all that is left to fetch.
// Which C, how many clusters and lanes each: chosen by the caller from the
// shapes and the occupancy API's answer, before the launch.
//
// The grid kernel (float32, and bf16 widths no cluster holds;
// `window_grid`). Float32 W_h and W_o are 5.24 MB at dim 1024: no cluster
// holds them (16 x 227 KB = 3.6 MB), the card's shared memory does (132 x
// 227 KB). So G CTAs, the fewest whose shared memory holds them (32 at dim
// 1024: 160 KB each), each keep dim / G output columns of W_h, all of its
// depth, and the same dim / G rows of W_o, for the whole window; the
// caller packs them once so that a CTA's slice is one block that bulk
// copies bring in. The card holds R such replicas of the weights (4 at dim
// 1024), and each replica multiplies its own contiguous share of the lanes.
// One cooperative launch runs the fs0 samples, two grid barriers apart:
//  - Every CTA also owns a share of the lanes to draw and gather for (the
//    lanes spread over all CTAs of the grid): it adds the G partial logits
//    of each of its lanes in group order, then b_o, draws, and gathers x of
//    the next step (fs0 table rows and the slot row, f32, in position
//    order) into a (B, dim) buffer in device memory. Barrier.
//  - Every CTA reads its replica's rows of x (through L2, up to 16 lanes
//    at a time), multiplies them by its columns of W_h (h = relu(x W_h +
//    b_h) for its columns), then those columns of h by its rows of W_o, and
//    writes the partial logits (B, q) of its group to device memory.
//    Barrier.
//   x and the partial logits are what crosses between SMs: at B 128 512 KB
//   and 4 MB a sample. Gathering x once, by the lane's owner, rather than in
//   every CTA that needs a part of it keeps the table's fs0 rows a lane
//   from being read G times (at B 128 that would be 168 MB a sample).
//  - Products are float32 FMA (exact float32 products, which the tensor
//    cores do not give): the threads of a column group of 4 split the
//    depth (blocks of 4 depths for W_h, so a lane's x comes in one 16-byte
//    load), their partial sums meet by
//    shuffles in a warp (and past 32 through shared memory, in order). The
//    order is fixed, there are no atomics on data: two runs give the same
//    bits, and the draws are the plain version's up to the last bits of a
//    sum. Split TF32 on the tensor cores is left for a later version: its
//    products keep 22 of 24 bits, and it would have to be shown to keep
//    the draws equal.
// What bounds it on an H100 (chip_smoke phase 2): at B 1 the chain of 2
// fs0 grid barriers and the owner's dependent loads (the partials, then
// the table rows), about 10 us a sample, 0.06 ms of barriers a window; at
// B 128 and 1024 the products and what each chunk of lanes costs around
// them (its rows of x from L2, the shuffles, three CTA barriers): about 5
// times the FMA floor at B 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

// round an activation to the weight type and back (the reference casts x
// and h to the weight dtype before each product)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Philox-4x32-10 (Salmon et al., SC'11)
__device__ __forceinline__ uint4 philox(uint4 c, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = ((float)(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

__device__ __forceinline__ uint2 philox_key(const float* noise,
                                            const int64_t* seed) {
  if (noise != nullptr) return make_uint2(0u, 0u);
  const uint64_t s = (uint64_t)seed[0];
  return make_uint2((uint32_t)s, (uint32_t)(s >> 32));
}

// The Gumbel-max draw of one warp for one lane: argmax over the q classes
// of logits[c] + g[c], first index on ties, with g from `noise` (global
// lane gl, step k) or from Philox. Every thread of the warp returns it.
__device__ __forceinline__ int warp_draw(const float* logits, int q,
                                         const float* __restrict__ noise,
                                         uint2 key, int gl, int k, int fs0) {
  const int lane_id = threadIdx.x % 32;
  float best = -INFINITY;
  int best_i = 0;
  for (int c0 = lane_id * 4; c0 < q; c0 += 128) {
    float g[4];
    if (noise != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        g[e] = c0 + e < q ? noise[((size_t)gl * fs0 + k) * q + c0 + e] : 0.f;
    } else {
      const uint4 r = philox(
          make_uint4((uint32_t)(c0 / 4), (uint32_t)k, (uint32_t)gl, 0u), key);
      g[0] = gumbel(r.x);
      g[1] = gumbel(r.y);
      g[2] = gumbel(r.z);
      g[3] = gumbel(r.w);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      if (c < q) {
        const float v = logits[c] + g[e];
        if (v > best) {
          best = v;
          best_i = c;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  return best_i;
}

// Where the window and the slot rows lie: lane b's window is buf[b *
// buf_ld + 0 .. fs0), its slot row of step k slots[b * slot_ld_b + k *
// slot_ld_k + 0 .. dim) (strides in elements).
struct Strides {
  long long buf_ld, slot_ld_b, slot_ld_k;
};

// ---------------------------------------------------------------------------
// The resident kernel (bf16): weights in a cluster's shared memory
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kLanes = 8;            // lanes per sub-tile: the mma's n
constexpr int kResWarps = 16;        // warps that multiply, reduce and draw
constexpr int kComputeThreads = kResWarps * 32;
constexpr int kGatherThreads = 128;  // warps that fetch table rows
constexpr int kResThreads = kComputeThreads + kGatherThreads;
constexpr int kMaxOwnH = 64;         // columns of W_h a CTA may own: four
                                     // a gather thread, 8 lanes
constexpr int kMaxOwnO = 256;        // columns of W_o: a tile a warp
constexpr int kActPad = 8;           // bf16 per activation row: rows of a
                                     // B fragment's 8 lanes fall in 8 banks
constexpr int kRedPad = 4;           // floats per row of partial sums
constexpr uint32_t kBulkBytes = 32768;    // of one bulk copy
constexpr unsigned kSpinLimit = 1u << 24;  // polls before a trap
constexpr int kMaxCluster = 16;
constexpr int kGatherRows = 10;      // table rows a thread fetches at once

// over how many warps the depth of a product with `mtiles` 16-column tiles
// and `ksteps` 16-deep steps is split
__host__ __device__ inline int depth_split(int mtiles, int ksteps) {
  int s = 1;
  while (mtiles * s * 2 <= kResWarps && ksteps % (s * 2) == 0) s *= 2;
  return s;
}

// the mbarriers of a CTA: the weights' arrival, then one for each of the
// three rows of activations that the cluster's CTAs write into each other
enum Bar { kBarWeights = 0, kBarX, kBarH, kBarLogits, kBars };
// the named barriers of a CTA: 0 is __syncthreads
enum Named { kNamedDrawn = 1, kNamedCompute = 2, kNamedGather = 3 };

// Shared memory of one CTA of a cluster of C (byte offsets): its slice of
// the packed weights (W_h's tiles, then W_o's), the sub-tile's x and h rows
// (bf16, all of dim, padded), its logits (f32, all of q), the Gumbel noise
// of its own columns of the logits (f32), the partial sums of a product
// over the depth split, the sub-tile's samples (the window, then the fs0
// new ones), the mbarriers.
struct ResidentLayout {
  int mh, mo;              // columns of W_h and of W_o that this CTA owns
  int ksteps;              // dim / 16
  int split_h, split_o;    // depth splits of the two products
  int act_ld;              // elements per row of x and h
  uint32_t w_bytes, wo_off, x_off, h_off, logits_off, noise_off, red_off,
      seq_off, bar_off, total;
  __host__ __device__ ResidentLayout(int fs0, int q, int dim, int C) {
    mh = dim / C;
    mo = q / C;
    ksteps = dim / 16;
    split_h = depth_split(mh / 16, ksteps);
    split_o = depth_split(mo / 16, ksteps);
    act_ld = dim + kActPad;
    wo_off = (uint32_t)mh * dim * sizeof(bf16);
    w_bytes = (uint32_t)(mh + mo) * dim * sizeof(bf16);
    x_off = w_bytes;
    h_off = x_off + kLanes * act_ld * sizeof(bf16);
    logits_off = h_off + kLanes * act_ld * sizeof(bf16);
    noise_off = logits_off + kLanes * q * sizeof(float);
    red_off = noise_off + kLanes * mo * sizeof(float);
    const int red_h = split_h * kLanes * (mh + kRedPad);
    const int red_o = split_o * kLanes * (mo + kRedPad);
    seq_off = red_off + (red_h > red_o ? red_h : red_o) * sizeof(float);
    bar_off = (seq_off + kLanes * 2 * fs0 * sizeof(int) + 15) / 16 * 16;
    total = bar_off + 8 * kBars;
  }
};

// whether a cluster of C CTAs can split both weights in whole 16-column
// tiles, few enough of them for a CTA's threads
__host__ bool resident_shape_ok(int fs0, int q, int dim, int C) {
  if (fs0 < 1 || q < 16 || dim < 16 || dim % 16 != 0) return false;
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) != 0) return false;
  return dim % (16 * C) == 0 && q % (16 * C) == 0 && dim / C <= kMaxOwnH &&
         q / C <= kMaxOwnO;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// all threads of all CTAs of the cluster (about 0.8 us in a cluster of 16
// on an H100: used at the start and at the end of a launch only)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a barrier of `threads` threads of this CTA: all of them wait ...
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ... or some only announce that they have come
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the address of this CTA's shared-memory address `addr` in the cluster's
// CTA `rank` (this CTA's own rank included)
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// An asynchronous store into another CTA's shared memory that reports its
// bytes to an mbarrier of that CTA: the reader waits for the bytes it
// expects, and the data is visible to it when the wait ends.
__device__ __forceinline__ void st_async(uint32_t remote, uint2 v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t remote, float4 v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(remote_bar)
      : "memory");
}

// How a row of values goes to every CTA of the cluster: each of `tasks`
// values (four columns of a lane) is held by `groups` threads, each of
// which sends it to its own C / groups of the CTAs, so that no thread has
// many stores to make one after the other.
struct Spread {
  bool active;
  int task;
  unsigned first, count;     // the CTAs this thread writes to
  __device__ Spread(int thread, int threads, int tasks, unsigned C) {
    unsigned groups = 1;
    while (tasks * groups * 2 <= (unsigned)threads && groups * 2 <= C)
      groups *= 2;
    active = thread < tasks * (int)groups;
    task = thread % tasks;
    count = C / groups;
    first = thread / tasks * count;
  }
};

// The same where the value is a sum that its threads also share: `group`
// neighbouring threads (a power of two, at most 16) hold a task, split the
// parts of the sum between them (reduce4_shared) and then the CTAs to
// write to. Threads past the last task repeat it and send nothing.
struct SharedSpread {
  bool active;
  int task, group, g;
  unsigned first, count;
  __device__ SharedSpread(int thread, int threads, int tasks, int split,
                          unsigned C) {
    const int want = (int)C > split ? (int)C : split;
    group = 1;
    while (tasks * group * 2 <= threads && group * 2 <= want && group < 16)
      group *= 2;
    g = thread % group;
    const int t = thread / group;
    task = t < tasks ? t : tasks - 1;
    const unsigned senders = (unsigned)group < C ? (unsigned)group : C;
    count = C / senders;
    first = g * count;
    active = t < tasks && (unsigned)g < senders;
  }
};

// v into this thread's CTAs of the cluster, at this CTA's address `addr`,
// reported to each CTA's mbarrier at this CTA's address `bar`
template <class To, class V>
__device__ __forceinline__ void push(const To& to, uint32_t addr,
                                     uint32_t bar, V v) {
  for (unsigned r = to.first; r < to.first + to.count; ++r)
    st_async(map_to_rank(addr, r), v, map_to_rank(bar, r));
}

__device__ __forceinline__ uint2 pack_bf16x4(const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void add_bf16x4(float (&acc)[4], uint2 v) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  acc[0] += lo.x;
  acc[1] += lo.y;
  acc[2] += hi.x;
  acc[3] += hi.y;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, its
// columns contiguous): the warp-level tensor-core product
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// One thread, once per phase: this CTA expects `bytes` on its mbarrier
// `bar` in the phase that has begun, and is its one arrival.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __noinline__ void never_arrived(const char* what) {
  printf("sample_window: %s never arrived (CTA %d)\n", what, blockIdx.x);
  __trap();
}

// wait until the mbarrier's phase of the given parity has completed: all
// the bytes it expected are there, and visible. Bounded: traps.
__device__ __forceinline__ void wait_for_bytes(uint32_t bar, uint32_t parity,
                                               const char* what) {
  uint32_t done = 0;
  for (unsigned spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > kSpinLimit) never_arrived(what);
  }
}

// Thread 0: ask the TMA for this CTA's `bytes` of packed weights at `src`,
// in bulk copies that report to the mbarrier at `bar`.
__device__ __forceinline__ void request_weights(uint32_t dst, const void* src,
                                                uint32_t bytes, uint32_t bar) {
  expect_bytes(bar, bytes);
  for (uint32_t at = 0; at < bytes; at += kBulkBytes) {
    const uint32_t n = bytes - at < kBulkBytes ? bytes - at : kBulkBytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst + at),
        "l"(static_cast<const unsigned char*>(src) + at), "r"(n), "r"(bar)
        : "memory");
  }
}

// One warp's share of a product: a 16-column tile of this CTA's columns
// times a part of the depth, for the sub-tile's 8 lanes.
//   red[part][n][m] = sum over the part's k of act[n][k] * w[k][column m]
// The tile's operand lies at `a` as 512-byte blocks, one per 16-deep step,
// in the mma's register order (a thread's 16 bytes at + 16 * thread); the
// lanes' rows at `b`. Four steps' operands are fetched before their
// products start; two chains of dependent products.
struct ProductTask {
  bool active;
  uint32_t a, b;     // shared-memory addresses of this thread's operands
  float* out;        // where its four sums go
  int ksub, ld;
  __device__ ProductTask(uint32_t frags, int mtiles, int ksteps, int split,
                         uint32_t act, int act_ld, float* red, int ld_) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    active = warp < mtiles * split;
    const int mt = warp % mtiles, s = warp / mtiles;
    ksub = ksteps / split;
    ld = ld_;
    a = frags + ((mt * ksteps + s * ksub) * 32 + lane) * 16;
    b = act + (g * act_ld + s * ksub * 16 + tig * 2) * (int)sizeof(bf16);
    // the thread holds columns mt * 16 + g (+ 8) of lanes 2 tig (+ 1)
    out = red + ((size_t)s * kLanes + 2 * tig) * ld + mt * 16 + g;
  }
  __device__ __forceinline__ void run() const {
    if (!active) return;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    int kk = 0;
    for (; kk + 4 <= ksub; kk += 4) {
      uint4 av[4];
      uint32_t b0[4], b1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        av[j] = lds128(a + (kk + j) * 512);
        b0[j] = lds32(b + (kk + j) * 32);
        b1[j] = lds32(b + (kk + j) * 32 + 16);
      }
      mma_bf16(c0, av[0], b0[0], b1[0]);
      mma_bf16(c1, av[1], b0[1], b1[1]);
      mma_bf16(c0, av[2], b0[2], b1[2]);
      mma_bf16(c1, av[3], b0[3], b1[3]);
    }
    for (; kk < ksub; ++kk)
      mma_bf16(c0, lds128(a + kk * 512), lds32(b + kk * 32),
               lds32(b + kk * 32 + 16));
    out[0] = c0[0] + c1[0];
    out[ld] = c0[1] + c1[1];
    out[8] = c0[2] + c1[2];
    out[ld + 8] = c0[3] + c1[3];
  }
};

// bias + the partial sums of four neighbouring columns of one lane, added
// in the order of the depth's parts
__device__ __forceinline__ void reduce4(const float* red, int split, int ld,
                                        const float4& bias, float (&v)[4]) {
  v[0] = bias.x, v[1] = bias.y, v[2] = bias.z, v[3] = bias.w;
  for (int s = 0; s < split; ++s) {
    const float4 p =
        *reinterpret_cast<const float4*>(red + (size_t)s * kLanes * ld);
    v[0] += p.x, v[1] += p.y, v[2] += p.z, v[3] += p.w;
  }
}

// The same for a product whose depth has many parts: `group` neighbouring
// threads (a power of two, at most 16, aligned) share the parts, each adds
// its own in order, thread 0 of the group also the bias, and a butterfly
// of shuffles leaves the whole sum in all of them. Every thread of the
// warp must call it.
__device__ __forceinline__ void reduce4_shared(const float* red, int split,
                                               int ld, const float4& bias,
                                               int group, int g,
                                               float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (g == 0) v[0] = bias.x, v[1] = bias.y, v[2] = bias.z, v[3] = bias.w;
  const int parts = group < split ? group : split;
  if (g < parts)
    for (int s = g * (split / parts); s < (g + 1) * (split / parts); ++s) {
      const float4 p =
          *reinterpret_cast<const float4*>(red + (size_t)s * kLanes * ld);
      v[0] += p.x, v[1] += p.y, v[2] += p.z, v[3] += p.w;
    }
  for (int off = 1; off < group; off <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] += __shfl_xor_sync(0xffffffffu, v[e], off);
}

__device__ __forceinline__ uint2 table_row(const bf16* __restrict__ table,
                                           int p, int sample, int q, int dim,
                                           int col) {
  return __ldg(reinterpret_cast<const uint2*>(
      table + ((size_t)p * q + sample) * dim + col));
}

// acc += rows 0 .. last - 1 of the fused table for the window w, in
// position order, up to kGatherRows loads under way at once
__device__ __forceinline__ void add_table_rows(float (&acc)[4],
                                               const bf16* __restrict__ table,
                                               const int* w, int last, int q,
                                               int dim, int col) {
  for (int p0 = 0; p0 < last; p0 += kGatherRows) {
    uint2 rows[kGatherRows];
#pragma unroll
    for (int j = 0; j < kGatherRows; ++j)
      if (p0 + j < last)
        rows[j] = table_row(table, p0 + j, w[p0 + j], q, dim, col);
#pragma unroll
    for (int j = 0; j < kGatherRows; ++j)
      if (p0 + j < last) add_bf16x4(acc, rows[j]);
  }
}

// order-preserving map of a float's bits to an unsigned integer
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v);
  return u ^ ((u >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

// how the lanes are spread over the clusters: contiguous shares that differ
// by at most one lane
struct LaneShare {
  int begin, count;
  __host__ __device__ LaneShare(int batch, int clusters, int cluster) {
    const int base = batch / clusters, rem = batch % clusters;
    begin = cluster * base + (cluster < rem ? cluster : rem);
    count = base + (cluster < rem ? 1 : 0);
  }
};

// A CTA has 16 warps that multiply, reduce and draw and 4 that gather. One
// sample k of a sub-tile, in every CTA:
//   gather warps: wait until sample k - 1 is drawn; add its table row (the
//     window's last) and the slot row to the sum of the other rows, which
//     they fetched a step ahead; x to all CTAs; then fetch and add the
//     rows of the next step, off the others' path
//   the others: the Gumbel noise of this CTA's own columns of the logits
//     while x is on its way; wait for all of x; product with W_h; h to all
//     CTAs; wait for all of h; product with W_o; logits + noise to all
//     CTAs; wait for all of them; draw (an argmax).
// Only the live lanes of a sub-tile are sent. A buffer is never written
// while a CTA still reads it: x of the next step is sent by CTAs that have
// drawn, so they had everyone's logits, which a CTA sends after its
// products; h of the next step by CTAs that have all of the next x, sent
// after the draw; the logits likewise after the next h. Within a CTA the
// two products' partial sums share one buffer, and a barrier of the
// compute warps stands between the reads of one and the writes of the next.
__global__ void __launch_bounds__(kResThreads, 1)
    window_resident(const bf16* __restrict__ table,
                    const unsigned char* __restrict__ packed,
                    const float* __restrict__ bh,
                    const float* __restrict__ bo,
                    const bf16* __restrict__ slots,
                    const int* __restrict__ buf,
                    const float* __restrict__ noise,
                    const int64_t* __restrict__ seed, int* __restrict__ out,
                    int batch, int fs0, int q, int dim, Strides st) {
  extern __shared__ __align__(128) unsigned char rsm[];
  const unsigned C = cluster_size(), rank = cluster_rank();
  const ResidentLayout lay(fs0, q, dim, (int)C);
  bf16* const xs = reinterpret_cast<bf16*>(rsm + lay.x_off);
  bf16* const hs = reinterpret_cast<bf16*>(rsm + lay.h_off);
  float* const logits = reinterpret_cast<float*>(rsm + lay.logits_off);
  float* const gum = reinterpret_cast<float*>(rsm + lay.noise_off);
  float* const red = reinterpret_cast<float*>(rsm + lay.red_off);
  int* const seq = reinterpret_cast<int*>(rsm + lay.seq_off);
  const uint32_t bars = smem_addr(rsm + lay.bar_off);
  const uint32_t bar_w = bars + 8 * kBarWeights, bar_x = bars + 8 * kBarX,
                 bar_h = bars + 8 * kBarH, bar_l = bars + 8 * kBarLogits;
  const int tid = threadIdx.x;
  const int mh = lay.mh, mo = lay.mo;
  const int ld_h = mh + kRedPad, ld_o = mo + kRedPad;
  const LaneShare share(batch, gridDim.x / C, blockIdx.x / C);
  const bool gatherer = tid >= kComputeThreads;

  // rows of dead lanes are multiplied too: keep them finite
  for (uint32_t i = tid; i < (lay.logits_off - lay.x_off) / 4;
       i += kResThreads)
    reinterpret_cast<uint32_t*>(rsm + lay.x_off)[i] = 0u;
  if (tid == 0) {
    const int nl = min(kLanes, share.count);
    for (int b = 0; b < kBars; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars +
                                                                    8 * b)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    request_weights(smem_addr(rsm), packed + (size_t)rank * lay.w_bytes,
                    lay.w_bytes, bar_w);
    expect_bytes(bar_x, nl * dim * sizeof(bf16));
    expect_bytes(bar_h, nl * dim * sizeof(bf16));
    expect_bytes(bar_l, nl * q * sizeof(float));
  }
  // every CTA of the cluster runs, its mbarriers ready, before any writes
  // into another's memory
  cluster_sync();

  if (gatherer) {
    // ------------------------------------------------------------------
    // the gather warps: this CTA's columns of x, four of a lane a thread
    // ------------------------------------------------------------------
    const int gt = tid - kComputeThreads;
    for (int sub = 0; sub < share.count; sub += kLanes) {
      const int lane0 = share.begin + sub;
      const int nl = min(kLanes, share.count - sub);
      const Spread to(gt, kGatherThreads, nl * (mh / 4), C);
      const int l = to.task / (mh / 4);
      const int col = (int)rank * mh + to.task % (mh / 4) * 4;
      int* const window = seq + l * 2 * fs0;
      const bf16* const slot =
          slots + (size_t)(lane0 + l) * st.slot_ld_b + col;
      const uint32_t dst = smem_addr(xs + l * lay.act_ld + col);
      // the lanes' windows; the fs0 new samples follow them
      for (int i = gt; i < nl * fs0; i += kGatherThreads)
        seq[i / fs0 * 2 * fs0 + i % fs0] =
            buf[(size_t)(lane0 + i / fs0) * st.buf_ld + i % fs0];
      named_sync(kNamedGather, kGatherThreads);
      float ahead[4] = {0.f, 0.f, 0.f, 0.f};
      if (to.active)
        add_table_rows(ahead, table, window, fs0 - 1, q, dim, col);
      for (int k = 0; k < fs0; ++k) {
        // sample k - 1 is drawn (the others only announce it)
        if (k > 0) named_sync(kNamedDrawn, kResThreads);
        if (!to.active) continue;
        const uint2 last = table_row(table, fs0 - 1, window[k + fs0 - 1], q,
                                     dim, col);
        const uint2 srow = __ldg(reinterpret_cast<const uint2*>(
            slot + (size_t)k * st.slot_ld_k));
        float x[4] = {ahead[0], ahead[1], ahead[2], ahead[3]};
        add_bf16x4(x, last);
        add_bf16x4(x, srow);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = fmaxf(x[e], 0.f);
        push(to, dst, bar_x, pack_bf16x4(x));
        if (k + 1 < fs0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ahead[e] = 0.f;
          add_table_rows(ahead, table, window + k + 1, fs0 - 1, q, dim, col);
        }
      }
      // the others have drawn the last sample of the sub-tile, so every
      // CTA had this CTA's last x: the windows may be overwritten
      named_sync(kNamedDrawn, kResThreads);
    }
  } else {
    // ------------------------------------------------------------------
    // the other warps: products, reductions, the draw
    // ------------------------------------------------------------------
    const uint2 key = philox_key(noise, seed);
    const ProductTask product_h(smem_addr(rsm), mh / 16, lay.ksteps,
                                lay.split_h, smem_addr(xs), lay.act_ld, red,
                                ld_h);
    const ProductTask product_o(smem_addr(rsm + lay.wo_off), mo / 16,
                                lay.ksteps, lay.split_o, smem_addr(hs),
                                lay.act_ld, red, ld_o);
    uint32_t parity = 0;
    bool weights_here = false;
    const int warp = tid >> 5, lane_id = tid & 31;
    // the class of this CTA's columns whose noise the thread makes, for
    // lanes noise_l0, noise_l0 + noise_step, ...
    const int noise_class = (int)rank * mo + tid % mo;
    const int noise_step = kComputeThreads / mo, noise_l0 = tid / mo;

    for (int sub = 0; sub < share.count; sub += kLanes) {
      const int lane0 = share.begin + sub;
      const int nl = min(kLanes, share.count - sub);
      const int next_nl = min(kLanes, share.count - sub - kLanes);
      const Spread to_h(tid, kComputeThreads, nl * (mh / 4), C);
      const SharedSpread to_o(tid, kComputeThreads, nl * (mo / 4),
                              lay.split_o, C);
      const int l_h = to_h.task / (mh / 4), m_h = to_h.task % (mh / 4) * 4;
      const int l_o = to_o.task / (mo / 4), m_o = to_o.task % (mo / 4) * 4;
      const float* const red_h = red + l_h * ld_h + m_h;
      const float* const red_o = red + l_o * ld_o + m_o;
      const float4 bias_h =
          *reinterpret_cast<const float4*>(bh + rank * mh + m_h);
      const float4 bias_o =
          *reinterpret_cast<const float4*>(bo + rank * mo + m_o);
      const uint32_t dst_h =
          smem_addr(hs + l_h * lay.act_ld + (int)rank * mh + m_h);
      const uint32_t dst_o = smem_addr(logits + l_o * q + (int)rank * mo + m_o);

      for (int k = 0; k < fs0; ++k, parity ^= 1) {
        // the live lanes of the next phase (none after the last sample)
        const int after = k + 1 < fs0 ? nl : next_nl;
        // the Gumbel noise of this CTA's columns of the logits, a class
        // of a lane a thread, while x is on its way
        if (noise_l0 < noise_step)
          for (int l = noise_l0; l < nl; l += noise_step) {
            float g;
            if (noise != nullptr) {
              g = noise[((size_t)(lane0 + l) * fs0 + k) * q + noise_class];
            } else {
              const uint4 r = philox(
                  make_uint4((uint32_t)(noise_class / 4), (uint32_t)k,
                             (uint32_t)(lane0 + l), 0u),
                  key);
              const int j = noise_class % 4;
              g = gumbel(j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w);
            }
            gum[l * mo + tid % mo] = g;
          }
        wait_for_bytes(bar_x, parity, "x");
        if (tid == 0 && after > 0)
          expect_bytes(bar_x, after * dim * sizeof(bf16));
        if (!weights_here) {
          wait_for_bytes(bar_w, 0, "the weights");
          weights_here = true;
        }

        // this CTA's columns of h = relu(x @ W_h + b_h), to every CTA
        product_h.run();
        named_sync(kNamedCompute, kComputeThreads);
        if (to_h.active) {
          float h[4];
          reduce4(red_h, lay.split_h, ld_h, bias_h, h);
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] = fmaxf(h[e], 0.f);
          push(to_h, dst_h, bar_h, pack_bf16x4(h));
        }
        wait_for_bytes(bar_h, parity, "h");
        if (tid == 0 && after > 0)
          expect_bytes(bar_h, after * dim * sizeof(bf16));
        // the product with W_o overwrites the partial sums of h: every
        // thread has read its own first (all of h having arrived here says
        // only that the threads which send to this CTA have)
        named_sync(kNamedCompute, kComputeThreads);

        // this CTA's columns of the logits, with their noise, to every CTA
        product_o.run();
        named_sync(kNamedCompute, kComputeThreads);
        {
          float v[4];
          reduce4_shared(red_o, lay.split_o, ld_o, bias_o, to_o.group,
                         to_o.g, v);
          if (to_o.active) {
            const float4 g =
                *reinterpret_cast<const float4*>(gum + l_o * mo + m_o);
            push(to_o, dst_o, bar_l,
                 make_float4(v[0] + g.x, v[1] + g.y, v[2] + g.z,
                             v[3] + g.w));
          }
        }
        wait_for_bytes(bar_l, parity, "the logits");
        if (tid == 0 && after > 0)
          expect_bytes(bar_l, after * q * sizeof(float));

        // every CTA draws every lane's sample: a warp per lane, argmax of
        // the logits with their noise, first index on ties
        if (warp < nl) {
          float best = -INFINITY;
          int best_i = 0;
          for (int c0 = lane_id * 4; c0 < q; c0 += 128) {
            const float4 a =
                *reinterpret_cast<const float4*>(logits + warp * q + c0);
            const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (v[e] > best) {
                best = v[e];
                best_i = c0 + e;
              }
          }
          const uint32_t mine = ordered(best);
          const uint32_t top = __reduce_max_sync(0xffffffffu, mine);
          const uint32_t first = __reduce_min_sync(
              0xffffffffu, mine == top ? (uint32_t)best_i : 0xFFFFFFFFu);
          if (lane_id == 0) seq[warp * 2 * fs0 + fs0 + k] = (int)first;
        }
        __threadfence_block();
        named_arrive(kNamedDrawn, kResThreads);   // the gather warps wait
        named_sync(kNamedCompute, kComputeThreads);
      }

      if (rank == 0)
        for (int i = tid; i < nl * fs0; i += kComputeThreads)
          out[(size_t)(lane0 + i / fs0) * fs0 + i % fs0] =
              seq[(i / fs0) * 2 * fs0 + fs0 + i % fs0];
      named_sync(kNamedCompute, kComputeThreads);   // seq has been read
    }
    if (!weights_here) wait_for_bytes(bar_w, 0, "the weights");
  }
  cluster_sync();   // nobody writes into the memory of a CTA that has left
}

// What a resident window costs before it loads, multiplies or draws: per
// sample and sub-tile three rounds in which every CTA sends 8 bytes to
// every CTA of its cluster and waits for everyone's, on the same grid.
__global__ void __launch_bounds__(kResThreads, 1)
    window_empty(int batch, int fs0) {
  __shared__ __align__(8) unsigned long long bar_mem;
  __shared__ uint2 inbox[kMaxCluster];
  const unsigned C = cluster_size();
  const LaneShare share(batch, gridDim.x / C, blockIdx.x / C);
  const uint32_t bar = smem_addr(&bar_mem);
  const uint32_t bytes = 8 * C;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect_bytes(bar, bytes);
  }
  cluster_sync();
  uint32_t parity = 0;
  for (int sub = 0; sub < share.count; sub += kLanes)
    for (int k = 0; k < 3 * fs0; ++k, parity ^= 1) {
      if (threadIdx.x < C)
        st_async(map_to_rank(smem_addr(inbox + cluster_rank()), threadIdx.x),
                 make_uint2(k, sub), map_to_rank(bar, threadIdx.x));
      wait_for_bytes(bar, parity, "a round of the empty window");
      if (threadIdx.x == 0) expect_bytes(bar, bytes);
      __syncthreads();
    }
  cluster_sync();
}

struct ResidentLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attrs[1];
  ResidentLaunch(int cluster, int clusters, size_t smem,
                 cudaStream_t stream) {
    config = cudaLaunchConfig_t{};
    config.gridDim = dim3(cluster * clusters);
    config.blockDim = dim3(kResThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    config.attrs = attrs;
    config.numAttrs = 1;
  }
};

// shared memory and, above the portable 8, the cluster size a kernel may ask
cudaError_t allow(const void* kernel, size_t smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// ---------------------------------------------------------------------------
// The grid kernel: weights in the shared memory of the whole card
// ---------------------------------------------------------------------------

constexpr int kGridThreads = 256;
constexpr int kGridTile = 16;   // the most lanes a CTA multiplies at once
constexpr int kOwnChunk = 8;    // lanes a CTA draws and gathers at once

__host__ __device__ inline uint32_t align16(uint32_t n) {
  return (n + 15) / 16 * 16;
}

// threads that split the depth of a product with n columns: a column group
// of 4 takes kGridThreads / (n / 4) of them
__host__ __device__ inline int grid_parts(int n) {
  return kGridThreads / (n / 4);
}

// floats of partial sums a product of n columns for `tile` lanes keeps in
// shared memory: one row per warp of a column group, where a group spans
// several warps
__host__ __device__ inline int grid_red_floats(int n, int tile) {
  const int parts = grid_parts(n);
  return parts > 32 ? parts / 32 * tile * n : 0;
}

// Shared memory of a CTA of the grid kernel that multiplies `tile` lanes at
// once (byte offsets): its slice of the packed weights (dim / G columns of
// W_h as [column group][j][dd][part][4], depth 4 (j P + part) + dd, then
// the same rows of W_o as [column group of q][row][4]); then, in the same
// bytes, since the two never run at once, the products' buffers (the rows
// of x and its columns of h of `tile` lanes, f32, the partial sums of a
// product) and the owners' (the logits and the windows of kOwnChunk
// lanes); an mbarrier (the weights' arrival).
struct GridLayout {
  int nh;   // columns of W_h (rows of W_o) a CTA keeps
  uint32_t w_bytes, x_off, h_off, red_off, logits_off, win_off, bar_off,
      total;
  __host__ __device__ GridLayout(int fs0, int q, int dim, int groups,
                                 int wsize, int tile) {
    nh = dim / groups;
    w_bytes = (uint32_t)nh * (dim + q) * wsize;
    x_off = align16(w_bytes);
    h_off = x_off + tile * dim * 4;
    red_off = h_off + tile * nh * 4;
    const int red_h = grid_red_floats(nh, tile),
              red_o = grid_red_floats(q, tile);
    const uint32_t products_end =
        red_off + (red_h > red_o ? red_h : red_o) * 4;
    logits_off = x_off;
    win_off = logits_off + kOwnChunk * q * 4;
    const uint32_t owners_end = win_off + kOwnChunk * fs0 * 4;
    bar_off = align16(products_end > owners_end ? products_end : owners_end);
    total = bar_off + 8;
  }
};

__host__ __device__ inline bool pow2(int n) {
  return n > 0 && (n & (n - 1)) == 0;
}

// whether G CTAs can split the weights in column groups of 4 that the
// products' thread layout divides
__host__ bool grid_shape_ok(int fs0, int q, int dim, int groups) {
  if (fs0 < 1 || !pow2(groups) || dim % groups != 0) return false;
  const int nh = dim / groups;
  return pow2(nh) && nh >= 4 && nh <= 4 * kGridThreads && pow2(q) &&
         q >= 4 && q <= 4 * kGridThreads && dim % (4 * grid_parts(nh)) == 0;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

__device__ __noinline__ void grid_stuck(const char* what, unsigned seen,
                                        unsigned target) {
  printf("sample_window: grid barrier (%s) stuck at %u of %u (CTA %d)\n",
         what, seen, target, blockIdx.x);
  __trap();
}

// All CTAs of the (cooperative) grid: the writes of every thread before it
// are visible, through L2, to the reads of every thread after it.
// Bounded: traps.
__device__ __forceinline__ void grid_sync(unsigned* counter, unsigned target,
                                          const char* what) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned seen, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (++spins > kSpinLimit) grid_stuck(what, seen, target);
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// A product of kGridTile-or-fewer lanes with a slice in shared memory:
//   out(l, c, v): v = sum over i < k of in[l * k + i] * w[c / 4][i][c % 4]
// for l < TILE and c < n. Thread t takes column group t / P and, for DB 1,
// the depths i = t % P + j P (P = grid_parts(n)), in order of j; for DB 4
// the blocks of depths 4 (t % P + j P) + 0 .. 3, in order; by FMA. The P
// sums of a group meet by a butterfly of shuffles inside a warp (offsets 1,
// 2, 4, ...) and, where P > 32, the warps' sums are then added in order
// through `red`; the group's first thread hands them out. Every thread
// calls it; it ends in a barrier.
template <int TILE, int DB, typename W, class Out>
__device__ __forceinline__ void grid_product(const float* in, int k,
                                             const W* w, int n, float* red,
                                             Out out) {
  constexpr int V = TILE * 4;   // sums a thread holds: [lane][column]
  const int parts = grid_parts(n);
  const int cg = threadIdx.x / parts, s = threadIdx.x % parts;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  const W* const wc = w + (size_t)cg * k * 4;
  if constexpr (DB == 1) {
#pragma unroll 4
    for (int i = s; i < k; i += parts) {
      float wv[4];
      load4(wc + (size_t)i * 4, wv);
#pragma unroll
      for (int l = 0; l < TILE; ++l) {
        const float a = in[l * k + i];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[l * 4 + e] = fmaf(a, wv[e], acc[l * 4 + e]);
      }
    }
  } else {
    // blocks of 4 depths: block b = j P + s is depths 4 b .. 4 b + 3, its
    // rows of x one 16-byte load a lane; the slice holds, for each j, the
    // four depths' rows of the P parts side by side ([j][dd][part][4])
    for (int j = 0; 4 * (j * parts + s) < k; ++j) {
      const int b = j * parts + s;
      float4 xv[TILE];
#pragma unroll
      for (int l = 0; l < TILE; ++l)
        xv[l] = *reinterpret_cast<const float4*>(in + l * k + 4 * b);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float wv[4];
        load4(wc + ((size_t)(j * 4 + dd) * parts + s) * 4, wv);
#pragma unroll
        for (int l = 0; l < TILE; ++l) {
          const float a = dd == 0   ? xv[l].x
                          : dd == 1 ? xv[l].y
                          : dd == 2 ? xv[l].z
                                    : xv[l].w;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[l * 4 + e] = fmaf(a, wv[e], acc[l * 4 + e]);
        }
      }
    }
  }
  const int seg = parts < 32 ? parts : 32;
  for (int off = 1; off < seg; off <<= 1)
#pragma unroll
    for (int i = 0; i < V; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (parts > 32) {
    if (s % 32 == 0)
#pragma unroll
      for (int i = 0; i < V; ++i)
        red[(s / 32 * TILE + i / 4) * n + cg * 4 + i % 4] = acc[i];
    __syncthreads();
    if (s == 0)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int at = i / 4 * n + cg * 4 + i % 4;
        float x = red[at];
        for (int p = 1; p < parts / 32; ++p) x += red[p * TILE * n + at];
        out(i / 4, cg * 4 + i % 4, x);
      }
  } else if (s == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) out(i / 4, cg * 4 + i % 4, acc[i]);
  }
  __syncthreads();
}

// CTA b of a grid of R replicas x G groups: group b % G, replica b / G.
// Sample k of a window, in every CTA:
//   its own lanes (LaneShare over the whole grid), kOwnChunk at a time:
//     the logits of sample k - 1 from the G groups' partial sums (in group
//     order, then b_o), the draw; the window of step k; x of step k, to xg
//   grid barrier
//   its replica's lanes, TILE at a time: their x from xg; its columns of h
//     = relu(x W_h + b_h); their product with its rows of W_o, to part
//   grid barrier
// and after the last sample only the owners' draw. xg is written before
// the first barrier of a step and read between the two; part written
// between them and read before the next first one: no buffer is written
// while a CTA still reads it.
template <int TILE, typename W>
__global__ void __launch_bounds__(kGridThreads, 1)
    window_grid(const W* __restrict__ table, const W* __restrict__ packed,
                const float* __restrict__ bh, const float* __restrict__ bo,
                const W* __restrict__ slots, const int* __restrict__ buf,
                const float* __restrict__ noise,
                const int64_t* __restrict__ seed, int* out, float* xg,
                float* part, unsigned* counter, int batch, int fs0, int q,
                int dim, int groups, Strides st) {
  extern __shared__ __align__(128) unsigned char gsm[];
  const GridLayout lay(fs0, q, dim, groups, (int)sizeof(W), TILE);
  const int nh = lay.nh;
  const W* const wh_s = reinterpret_cast<const W*>(gsm);
  const W* const wo_s = wh_s + (size_t)nh * dim;
  float* const xs = reinterpret_cast<float*>(gsm + lay.x_off);
  float* const hs = reinterpret_cast<float*>(gsm + lay.h_off);
  float* const red = reinterpret_cast<float*>(gsm + lay.red_off);
  float* const lg = reinterpret_cast<float*>(gsm + lay.logits_off);
  int* const wn = reinterpret_cast<int*>(gsm + lay.win_off);
  const uint32_t bar_w = smem_addr(gsm + lay.bar_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  const unsigned nblocks = gridDim.x;
  const int g = blockIdx.x % groups;
  const LaneShare rep(batch, gridDim.x / groups, blockIdx.x / groups);
  const LaneShare own(batch, gridDim.x, blockIdx.x);
  const uint2 key = philox_key(noise, seed);
  const W* wtag = nullptr;
  const int q4 = q / 4, dim4 = dim / 4;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_w)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    request_weights(smem_addr(gsm),
                    reinterpret_cast<const unsigned char*>(packed) +
                        (size_t)g * lay.w_bytes,
                    lay.w_bytes, bar_w);
  }
  __syncthreads();   // the mbarrier is ready before anyone waits on it

  unsigned rounds = 0;
  for (int k = 0; k <= fs0; ++k) {
    // ---- the lanes this CTA draws and gathers for
    for (int o = 0; o < own.count; o += kOwnChunk) {
      const int L0 = own.begin + o;
      const int no = min(kOwnChunk, own.count - o);
      if (k > 0) {
        for (int i = tid; i < no * q4; i += kGridThreads) {
          const int l = i / q4, c = i % q4 * 4;
          const float* const p = part + (size_t)(L0 + l) * q + c;
          float4 v = __ldcg(reinterpret_cast<const float4*>(p));
          for (int gg = 1; gg < groups; ++gg) {
            const float4 u = __ldcg(
                reinterpret_cast<const float4*>(p + (size_t)gg * batch * q));
            v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
          }
          const float4 b = __ldg(reinterpret_cast<const float4*>(bo + c));
          v.x += b.x, v.y += b.y, v.z += b.z, v.w += b.w;
          *reinterpret_cast<float4*>(lg + l * q + c) = v;
        }
        __syncthreads();
        for (int l = warp; l < no; l += kGridThreads / 32) {
          const int s =
              warp_draw(lg + l * q, q, noise, key, L0 + l, k - 1, fs0);
          if (lane_id == 0) out[(size_t)(L0 + l) * fs0 + k - 1] = s;
        }
        __syncthreads();
      }
      if (k < fs0) {
        // the window of step k: samples k .. k + fs0 - 1 of the sequence
        // that the input window starts
        for (int i = tid; i < no * fs0; i += kGridThreads) {
          const int l = i / fs0, j = k + i % fs0;
          wn[i] = j < fs0 ? buf[(size_t)(L0 + l) * st.buf_ld + j]
                          : __ldcg(out + (size_t)(L0 + l) * fs0 + j - fs0);
        }
        __syncthreads();
        for (int i = tid; i < no * dim4; i += kGridThreads) {
          const int l = i / dim4, d = i % dim4 * 4;
          float a[4] = {0.f, 0.f, 0.f, 0.f};
          for (int p = 0; p < fs0; ++p) {
            float r[4];
            load4(table + ((size_t)p * q + wn[l * fs0 + p]) * dim + d, r);
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] += r[e];
          }
          float sr[4];
          load4(slots + (size_t)(L0 + l) * st.slot_ld_b +
                    (size_t)k * st.slot_ld_k + d,
                sr);
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[e] = round_to(fmaxf(a[e] + sr[e], 0.f), wtag);
          __stcg(reinterpret_cast<float4*>(xg + (size_t)(L0 + l) * dim + d),
                 make_float4(x[0], x[1], x[2], x[3]));
        }
        __syncthreads();   // the windows are rewritten for the next chunk
      }
    }
    if (k == fs0) break;
    grid_sync(counter, ++rounds * nblocks, "x");
    if (k == 0) wait_for_bytes(bar_w, 0, "the weights");

    // ---- this CTA's columns for its replica's lanes, TILE at a time; the
    // next chunk's x is copied in while one is multiplied
    const int chunks = (rep.count + TILE - 1) / TILE;
    for (int c = 0; c < chunks; ++c) {
      const int L0 = rep.begin + c * TILE;
      const int nl = min(TILE, rep.count - c * TILE);
      // unrolled, so that a thread's loads are under way together
#pragma unroll 16
      for (int i = tid; i < TILE * dim4; i += kGridThreads) {
        const int l = i / dim4, d = i % dim4 * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l < nl)
          v = __ldcg(reinterpret_cast<const float4*>(
              xg + (size_t)(L0 + l) * dim + d));
        *reinterpret_cast<float4*>(xs + l * dim + d) = v;
      }
      __syncthreads();
      grid_product<TILE, 4, W>(xs, dim, wh_s, nh, red,
                            [&](int l, int col, float v) {
                              hs[l * nh + col] = round_to(
                                  fmaxf(v + __ldg(bh + g * nh + col), 0.f),
                                  wtag);
                            });
      // nobody reads buffer c % 2 after the product's closing barrier
      grid_product<TILE, 1, W>(hs, nh, wo_s, q, red, [&](int l, int col,
                                                      float v) {
        if (l < nl) __stcg(part + ((size_t)g * batch + L0 + l) * q + col, v);
      });
    }
    grid_sync(counter, ++rounds * nblocks, "the partial logits");
  }
}

// What a grid window costs before it loads, multiplies or draws: its 2 fs0
// grid barriers, on the same grid.
__global__ void __launch_bounds__(kGridThreads, 1)
    window_grid_empty(unsigned* counter, int rounds) {
  for (int r = 1; r <= rounds; ++r)
    grid_sync(counter, (unsigned)r * gridDim.x, "the empty grid window");
}

// a cooperative launch: the runtime refuses a grid that cannot be resident
// all at once, so a barrier never waits for a CTA that has not started
struct GridLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attrs[1];
  GridLaunch(int blocks, size_t smem, cudaStream_t stream) {
    config = cudaLaunchConfig_t{};
    config.gridDim = dim3(blocks);
    config.blockDim = dim3(kGridThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    attrs[0].id = cudaLaunchAttributeCooperative;
    attrs[0].val.cooperative = 1;
    config.attrs = attrs;
    config.numAttrs = 1;
  }
};

template <typename W>
const void* grid_kernel(int tile) {
  switch (tile) {
    case 1: return reinterpret_cast<const void*>(window_grid<1, W>);
    case 2: return reinterpret_cast<const void*>(window_grid<2, W>);
    case 4: return reinterpret_cast<const void*>(window_grid<4, W>);
    case 8: return reinterpret_cast<const void*>(window_grid<8, W>);
    case 16: return reinterpret_cast<const void*>(window_grid<16, W>);
    default: return nullptr;
  }
}

const void* grid_kernel_for(int dtype, int tile) {
  return dtype == 0 ? grid_kernel<float>(tile)
         : dtype == 1 ? grid_kernel<bf16>(tile)
                      : nullptr;
}

}  // namespace

extern "C" {

// The resident kernel (bfloat16 only): `clusters` clusters of `cluster`
// CTAs. packed: `cluster` slices of (dim / cluster + q / cluster) * dim
// bf16, slice r holding columns r * dim / cluster .. of W_h and then
// r * q / cluster .. of W_o as [16-column tile][16-deep step][32 lanes]
// [8 values] in the register order of mma m16n8k16's A operand. Exactly
// one of noise / seed is non-null. Strides in elements: lane b's window at
// buf + b * buf_ld, its slot row of step k at slots + b * slot_ld_b + k *
// slot_ld_k. Returns the cudaError_t of the launch (0 on success).
int sample_window_resident_launch(const void* table, const void* packed,
                                  const void* bh, const void* bo,
                                  const void* slots, const void* buf,
                                  const void* noise, const void* seed,
                                  void* out, int batch, int fs0, int q,
                                  int dim, long long buf_ld,
                                  long long slot_ld_b, long long slot_ld_k,
                                  int cluster, int clusters, void* stream) {
  if ((noise == nullptr) == (seed == nullptr) || batch < 1 || clusters < 1 ||
      clusters > batch || !resident_shape_ok(fs0, q, dim, cluster))
    return cudaErrorInvalidValue;
  const ResidentLayout lay(fs0, q, dim, cluster);
  const void* kernel = reinterpret_cast<const void*>(window_resident);
  cudaError_t err = allow(kernel, lay.total, cluster);
  if (err != cudaSuccess) return err;
  ResidentLaunch launch(cluster, clusters, lay.total,
                        static_cast<cudaStream_t>(stream));
  Strides st{buf_ld, slot_ld_b, slot_ld_k};
  void* args[] = {&table, &packed, &bh,    &bo,  &slots, &buf, &noise,
                  &seed,  &out,    &batch, &fs0, &q,     &dim, &st};
  return cudaLaunchKernelExC(&launch.config, kernel, args);
}

// the resident kernel's grid, clusters and shared memory through the
// exchanges of a window of `batch` lanes, and no other work
int sample_window_empty_launch(int batch, int fs0, int q, int dim,
                               int cluster, int clusters, void* stream) {
  if (batch < 1 || clusters < 1 || clusters > batch ||
      !resident_shape_ok(fs0, q, dim, cluster))
    return cudaErrorInvalidValue;
  const ResidentLayout lay(fs0, q, dim, cluster);
  const void* kernel = reinterpret_cast<const void*>(window_empty);
  cudaError_t err = allow(kernel, lay.total, cluster);
  if (err != cudaSuccess) return err;
  ResidentLaunch launch(cluster, clusters, lay.total,
                        static_cast<cudaStream_t>(stream));
  void* args[] = {&batch, &fs0};
  return cudaLaunchKernelExC(&launch.config, kernel, args);
}

// shared memory of one CTA of the resident kernel in a cluster of
// `cluster`; -1 where that cluster cannot split the weights
long long sample_window_resident_smem(int fs0, int q, int dim, int cluster) {
  if (!resident_shape_ok(fs0, q, dim, cluster)) return -1;
  return (long long)ResidentLayout(fs0, q, dim, cluster).total;
}

// How many clusters of `cluster` CTAs of the resident kernel the current
// device holds at once (the occupancy API's answer; 0: such a cluster is
// not granted). Negative: minus the cudaError_t.
int sample_window_max_clusters(int fs0, int q, int dim, int cluster) {
  if (!resident_shape_ok(fs0, q, dim, cluster))
    return -(int)cudaErrorInvalidValue;
  const ResidentLayout lay(fs0, q, dim, cluster);
  const void* kernel = reinterpret_cast<const void*>(window_resident);
  cudaError_t err = allow(kernel, lay.total, cluster);
  if (err != cudaSuccess) return -(int)err;
  int sms = 0, dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  // the answer does not depend on the grid as long as it is large enough
  ResidentLaunch launch(cluster, sms / cluster > 0 ? sms / cluster : 1,
                        lay.total, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.config);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

// The grid kernel (dtype: 0 = float32 weights/table/slots, 1 = bfloat16):
// `replicas` x `groups` CTAs, one cooperative launch. packed: `groups`
// slices of dim / groups x (dim + q) elements, slice g holding columns
// g * dim / groups .. of W_h as [column group of 4][j][dd][part][4] (depth
// 4 (j P + part) + dd, P the threads of a column group) and then the same
// rows of W_o as [column group of 4 of q][row][4]. tile: lanes a CTA
// multiplies at once (1, 2, 4, 8 or 16). xg (batch, dim) and part (groups,
// batch, q) are float32 scratch, counter one unsigned (zeroed here). The
// other arguments as for the resident kernel.
int sample_window_grid_launch(int dtype, int tile, const void* table,
                              const void* packed, const void* bh,
                              const void* bo, const void* slots,
                              const void* buf, const void* noise,
                              const void* seed, void* out, void* xg,
                              void* part, void* counter, int batch, int fs0,
                              int q, int dim, long long buf_ld,
                              long long slot_ld_b, long long slot_ld_k,
                              int groups, int replicas, void* stream) {
  const void* kernel = grid_kernel_for(dtype, tile);
  if ((noise == nullptr) == (seed == nullptr) || kernel == nullptr ||
      batch < 1 || replicas < 1 || !grid_shape_ok(fs0, q, dim, groups))
    return cudaErrorInvalidValue;
  const GridLayout lay(fs0, q, dim, groups, dtype == 0 ? 4 : 2, tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow(kernel, lay.total, 1);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counter, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  GridLaunch launch(groups * replicas, lay.total, s);
  Strides st{buf_ld, slot_ld_b, slot_ld_k};
  void* args[] = {&table, &packed, &bh,  &bo,    &slots, &buf,
                  &noise, &seed,   &out, &xg,    &part,  &counter,
                  &batch, &fs0,    &q,   &dim,   &groups, &st};
  return cudaLaunchKernelExC(&launch.config, kernel, args);
}

// the grid kernel's grid and shared memory through the 2 fs0 grid barriers
// of a window, and no other work
int sample_window_grid_empty_launch(int dtype, int fs0, int q, int dim,
                                    int groups, int replicas, int tile,
                                    void* counter, void* stream) {
  if (dtype < 0 || dtype > 1 || replicas < 1 || tile < 1 ||
      !grid_shape_ok(fs0, q, dim, groups))
    return cudaErrorInvalidValue;
  const GridLayout lay(fs0, q, dim, groups, dtype == 0 ? 4 : 2, tile);
  const void* kernel = reinterpret_cast<const void*>(window_grid_empty);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow(kernel, lay.total, 1);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(counter, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  GridLaunch launch(groups * replicas, lay.total, s);
  int rounds = 2 * fs0;
  void* args[] = {&counter, &rounds};
  return cudaLaunchKernelExC(&launch.config, kernel, args);
}

// shared memory of one CTA of the grid kernel with `groups` CTAs a
// replica that multiplies `tile` lanes at once; -1 where they cannot split
// the weights
long long sample_window_grid_smem(int dtype, int fs0, int q, int dim,
                                  int groups, int tile) {
  if (dtype < 0 || dtype > 1 || tile < 1 ||
      !grid_shape_ok(fs0, q, dim, groups))
    return -1;
  return (long long)GridLayout(fs0, q, dim, groups, dtype == 0 ? 4 : 2, tile)
      .total;
}

// How many CTAs of the grid kernel (its widest tile's code, with the shared
// memory of `tile` lanes) the current device holds at once (the occupancy
// API's answer times the SMs). Negative: minus the cudaError_t.
int sample_window_grid_ctas(int dtype, int fs0, int q, int dim, int groups,
                            int tile) {
  const void* kernel = grid_kernel_for(dtype, kGridTile);
  if (kernel == nullptr || tile < 1 || !grid_shape_ok(fs0, q, dim, groups))
    return -(int)cudaErrorInvalidValue;
  const GridLayout lay(fs0, q, dim, groups, dtype == 0 ? 4 : 2, tile);
  cudaError_t err = allow(kernel, lay.total, 1);
  int per_sm = 0, sms = 0, dev = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kGridThreads, lay.total);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// the most dynamic shared memory a CTA of the current device may ask for
int sample_window_device(int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

const char* sample_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
