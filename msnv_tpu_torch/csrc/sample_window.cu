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
// and W_o for all fs0 steps and for every lane it walks through, in its
// shared memory and its registers:
//  - CTA j owns dim / C output columns of W_h, all of its depth, and the
//    same dim / C rows of W_o, all of its q columns: the rows that its own
//    columns of h multiply. So h never leaves the CTA that made it: the CTA
//    multiplies its columns of h by its rows of W_o, which gives a partial
//    sum of every logit over its part of the depth, and sends each CTA the
//    partial sums of the q / C logit columns that CTA owns. The owner adds
//    the C parts (depth order, the bias first, in `sum_tree`'s fixed tree).
//    Where the parts of all of a CTA's columns do not fit in its shared
//    memory beside the rest (q large beside dim: 4 q C bytes a lane against
//    the 2 dim of an x row), they go in rounds of its columns, each owner
//    telling every CTA (an mbarrier arrival) when its buffer has room for
//    the next; one round at every preset.
//    The caller packs the weights once (not per window) so that a CTA's
//    slice is one contiguous block, already in the register order of the
//    tensor cores' `mma`: one thread asks the TMA for what shared memory
//    keeps in bulk copies reported to an mbarrier, and a product's thread
//    fetches its whole A operand with one conflict-free 16-byte load.
//  - A cluster takes a contiguous share of the lanes and walks through it
//    in passes of 8, 16, 24 or 32 lanes: up to four n-tiles of `mma.sync`
//    m16n8k16 (bf16 in, f32 sums) that share one A operand, the lanes the
//    narrow side (n = 8) of each, the weights' columns its 16 rows. A
//    step's chain of exchanges and barriers is paid once for all its lanes,
//    so a share walks through in as few passes as the width allows. 16
//    warps split a product by 16-column tile and by depth (the product with
//    W_o at dim 1024, q 256, C 16: one tile of the logits a warp over the
//    CTA's 4 steps of depth, the same shape as a warp's product with W_h);
//    the partial sums are added in a fixed order, the same at every width,
//    so two runs, and two widths, give the same bits.
//  - Shared memory holds a pass's activations beside the weights: a lane needs
//    its x row (2 KB at dim 1024) and its own columns of h, the partial sums of
//    both products (the C parts of the CTA's own logits arrive from the
//    cluster), its noise and its samples, about 5.5 KB at dim 1024, C 16. 8
//    lanes of that fit beside all of W_h and W_o (160 KB), 32 beside W_o's 32
//    KB alone: in a wider pass the warps hold W_h's operand in registers
//    instead. A warp's 16-column tile of W_h over its part of the depth is 16
//    steps of 16 B a thread at dim 1024 (64 registers); it never changes within
//    a launch. A pass of 8 NT lanes (NT > 1) holds 4 NT steps of it (all 16 at
//    32 lanes), and the rest stay in shared memory; its CTA has 16 warps and no
//    other, so each thread has 128 registers. A pass of 8 lanes holds none, and
//    its CTA has four more warps of 96 registers that fetch the table rows and
//    send x off the others' path (an 8-lane step is a chain of latencies, a
//    wider one is not).
//  - What crosses the network per sample is small and is pushed, not fetched
//    (remote loads stall on the network's latency), with `st.async`: a store
//    into another CTA's shared memory that reports its bytes to an mbarrier of
//    the receiving CTA. A CTA goes on when the bytes it expects of a row have
//    arrived (bounded wait, traps): three such exchanges per sample take the
//    place of `__syncthreads`, at about a third of what a hardware cluster
//    barrier costs in a cluster of 16. (1) x: every CTA computes its columns of
//    x for the live lanes and writes them into all C CTAs (eight columns of a
//    lane, 16 bytes, a store; each value sent by several threads, each to a few
//    of the CTAs, so no thread has many stores in a row). (2) The partial
//    logits: each warp's tile of sums goes to the CTA that owns its columns,
//    one 16-byte store a thread and n-tile (the four sums an mma leaves in a
//    thread, two lanes of two columns, are one row of the owner's buffer, so a
//    warp's stores fill 512 contiguous bytes). (3) Not the logits: every CTA
//    adds the Gumbel noise of its own columns to its logits and sends each
//    lane's best of them (value and class, first index on ties), 8 bytes a
//    lane, into all CTAs; every CTA then takes the best of the C bests (lowest
//    class on ties), which is the argmax over all q columns since a CTA's
//    columns are one block in rank order, so the new sample needs no fourth
//    exchange. A lane's step writes dim 2 C + q 4 C + 8 C^2 bytes into the
//    cluster (50 KiB at dim 1024, q 256, C 16; sending h to every CTA instead
//    of the partial logits took 66 KiB). A cluster barrier at the start (every
//    CTA runs, its mbarriers ready) and one at the end (nobody writes into the
//    shared memory of a CTA that is gone) are all that is left of them.
//  - A step is a chain of short dependent pieces, so what counts is how
//    few operations lie on it. x is the sum of fs0 table rows from L2 (in
//    position order, f32) plus the slot row, and all but the last row are
//    known a step ahead, so they are fetched and added while the cluster
//    waits for its exchanges and multiplies (in a wider pass the later ones
//    by `cp.async` into the x rows' bytes, which take no registers while
//    the copies are under way); when a sample is drawn, one table row and
//    the slot row are all that is left to fetch.
// Which C, how many clusters and lanes each, and the width of a pass:
// chosen by the caller from the shapes and the occupancy API's answer,
// before the launch.
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

constexpr int kLanes = 8;            // lanes of an n-tile: the mma's n
constexpr int kMaxTiles = 4;         // n-tiles a pass carries at most
constexpr int kRegSteps = 4;         // 16-deep steps of W_h that a compute
                                     // thread holds in registers, per n-tile
                                     // of a pass wider than 8 lanes
constexpr int kResWarps = 16;        // warps that multiply, reduce and draw
                                     // (and, in passes wider than 8 lanes,
                                     // gather): 128 registers a thread
constexpr int kResThreads = kResWarps * 32;
constexpr int kPushThreads = kResThreads / 2;  // send x while the others
                                               // fetch table rows
constexpr int kGatherThreads = 128;  // in passes of 8 lanes: four warps of
                                     // their own that fetch table rows and
                                     // send x (96 registers a thread)
constexpr int kMaxOwnH = 64;         // columns of W_h (rows of W_o) a CTA
                                     // may own: a pass of 32 lanes has at
                                     // most one task of x and of h a thread
constexpr int kMaxOwnO = 256;        // logit columns a CTA may own: it
                                     // adds their parts and draws
constexpr int kActPad = 8;           // bf16 per activation row: rows of a
                                     // B fragment's 8 lanes fall in 8 banks
constexpr int kRedPad = 4;           // floats per row of partial sums
constexpr int kPartPad = 4;          // floats between two parts' sums, so
                                     // that the threads adding one lane's
                                     // parts read other banks
constexpr uint32_t kBulkBytes = 32768;    // of one bulk copy
constexpr unsigned kSpinLimit = 1u << 24;  // polls before a trap
constexpr int kMaxCluster = 16;
// table rows a thread fetches at once: fewer where W_h's operand takes
// more of its registers
__host__ __device__ constexpr int gather_rows(int tiles) {
  return tiles <= 2 ? 10 : 4;
}

// 16-deep steps of W_h that a compute thread holds in registers in a pass
// of `width` lanes: none in a pass of 8, whose threads are fewer registers
// each (the gather warps') and whose shared memory holds all of W_h
__host__ __device__ constexpr int reg_steps(int width) {
  return width > kLanes ? kRegSteps * (width / kLanes) : 0;
}

// threads of a CTA in a pass of `tiles` n-tiles
__host__ __device__ constexpr int resident_threads(int tiles) {
  return kResThreads + (tiles == 1 ? kGatherThreads : 0);
}

// over how many warps the depth of a product with `mtiles` 16-column tiles
// and `ksteps` 16-deep steps is split
__host__ __device__ inline int depth_split(int mtiles, int ksteps) {
  int s = 1;
  while (mtiles * s * 2 <= kResWarps && ksteps % (s * 2) == 0) s *= 2;
  return s;
}

// The tree in which the partial sums of the logits are added: `split`
// parts (in order within each of its leaves, the bias first), then a
// balanced tree over the leaves in index order. Its width is the one a
// pass of 8 lanes gives, whatever the pass's width, so that every width
// adds the parts alike.
__host__ __device__ inline int sum_tree(int mo, int split, int C) {
  const int tasks = kLanes * (mo / 4);
  const int want = C > split ? C : split;
  int tree = 1;
  while (tasks * tree * 2 <= kResThreads && tree * 2 <= want &&
         tree < 16)
    tree *= 2;
  return tree;
}

// floats between the partial sums of one part of the depth and the next,
// for `width` lanes of n columns
__host__ __device__ inline int part_floats(int width, int n) {
  return width * (n + kRedPad) + kPartPad;
}

// the mbarriers of a CTA: the weights' arrival, then one for each of the
// three rows of values that the cluster's CTAs write into each other (x,
// the partial logits, the bests), then the one on which the C owners of
// the logits report that their buffers of parts have room for the next
// round (C arrivals a phase)
enum Bar { kBarWeights = 0, kBarX, kBarPart, kBarBest, kBarFree, kBars };

// the shared memory a resident CTA's layout is made to fit: the most a CTA
// of an H100 may ask for (227 KB)
constexpr uint32_t kSmemFit = 232448;

// Shared memory of one CTA of a cluster of C in a pass of `width` lanes (byte
// offsets): what is left of W_h's operand beside the threads' registers (each
// warp's steps from `kreg` on, a block per warp), its slice of W_o (packed),
// the pass's x rows (bf16, all of dim, padded) and, in the same bytes, its own
// columns of h (bf16, padded), each lane's best of each pair of its columns and
// the staged table rows: x is read before h is made, and the next x comes from
// CTAs that have drawn, so had this CTA's bests, which it sends after it has
// read those. Then the Gumbel noise of its own columns of the logits (f32), the
// partial sums of the product with W_h over its depth split, the parts of its
// own logits that the cluster's CTAs send (f32; apart from the x rows, which a
// slower CTA may still be multiplying when a faster one's parts land; in as
// few rounds of mo / rounds columns as let the CTA fit kSmemFit: one at
// every preset, more where q is large beside dim), two
// buffers of the sums of a step's table rows but the last (f32, a lane's
// columns of this CTA: the next step's are made while this step's are read),
// the CTA's biases, each CTA's best of its columns for each lane, the pass's
// samples (the window, then the fs0 new ones), the mbarriers. Made on the host
// and handed to the kernel as a parameter.
struct ResidentLayout {
  int mh, mo;              // columns of W_h (rows of W_o) and logit columns
                           // that this CTA owns
  int ksteps;              // dim / 16
  int split_h, split_o;    // depth splits of the two products in a CTA
  int parts;               // parts a logit's sum has: C x split_o
  int rounds, mr;          // rounds in which the parts arrive, and the
                           // columns of each (mo / rounds)
  int ksub;                // steps of W_h a warp multiplies
  int kreg;                // of them, held in registers
  int act_ld, h_ld;        // elements per row of x, of this CTA's h
  int tree;                // width of the logits' tree (sum_tree)
  int staged;              // rows of the second half's share of the next
                           // step's sum that its threads copy into the x
                           // rows' bytes (cp.async) while they multiply
  uint32_t slice_bytes;    // of this CTA's slice of the packed weights
  uint32_t wo_off, w_bytes, x_off, h_off, noise_off, red_off, part_off,
      ahead_off, bias_off, cand_off, stage_off, best_off, seq_off, bar_off,
      total;
  __host__ __device__ ResidentLayout(int fs0, int q, int dim, int C,
                                     int width) {
    mh = dim / C;
    mo = q / C;
    ksteps = dim / 16;
    split_h = depth_split(mh / 16, ksteps);
    split_o = depth_split(q / 16, mh / 16);
    parts = C * split_o;
    ksub = ksteps / split_h;
    const int held = reg_steps(width);
    kreg = ksub < held ? ksub : held;
    act_ld = dim + kActPad;
    h_ld = mh + kActPad;
    tree = sum_tree(mo, parts, C);
    slice_bytes = (uint32_t)(mh + mo) * dim * sizeof(bf16);
    wo_off = (uint32_t)(mh / 16) * (ksteps - split_h * kreg) * 512;
    w_bytes = wo_off + (uint32_t)mh * q * sizeof(bf16);
    x_off = w_bytes;
    h_off = x_off;
    cand_off = h_off + width * h_ld * sizeof(bf16);
    const uint32_t x_rows = width * act_ld * sizeof(bf16),
                   h_cand = cand_off - x_off + width * (mo / 2) * sizeof(uint2);
    noise_off = x_off + (x_rows > h_cand ? x_rows : h_cand);
    // beside h and the bests, the staged rows: [row][task], 16 bytes each
    stage_off = x_off + h_cand;
    const int later = fs0 - 1 - fs0 / 2;   // rows the second half adds
    const uint32_t row_bytes = width * (mh / 8) * 16;
    const int fit = x_rows > h_cand ? (x_rows - h_cand) / row_bytes : 0;
    staged = width == kLanes ? 0 : later < fit ? later : fit;
    red_off = noise_off + width * mo * sizeof(float);
    part_off = red_off + split_h * part_floats(width, mh) * sizeof(float);
    for (rounds = 1;; rounds *= 2) {
      mr = mo / rounds;
      ahead_off = part_off + parts * part_floats(width, mr) * sizeof(float);
      bias_off = ahead_off + 2 * width * mh * sizeof(float);
      best_off = bias_off + (mh + mo) * sizeof(float);
      seq_off = best_off + width * C * sizeof(uint2);
      bar_off = (seq_off + width * 2 * fs0 * sizeof(int) + 15) / 16 * 16;
      total = bar_off + 8 * kBars;
      // a round's columns stay whole 16-column tiles
      if (total <= kSmemFit || mr % 32 != 0) break;
    }
  }
};

// whether a cluster of C CTAs can split W_h in whole 16-column tiles, W_o
// in the same 16-row blocks and the logits in whole 16-column tiles, few
// enough of them for a CTA's threads, and carry passes of
// `width` lanes (a multiple of 8 up to 32, at most one task of four
// logits' columns a compute thread)
__host__ bool resident_shape_ok(int fs0, int q, int dim, int C, int width) {
  if (fs0 < 1 || q < 16 || dim < 16 || dim % 16 != 0) return false;
  if (C < 1 || C > kMaxCluster || (C & (C - 1)) != 0) return false;
  if (width < kLanes || width > kMaxTiles * kLanes || width % kLanes != 0)
    return false;
  return dim % (16 * C) == 0 && q % (16 * C) == 0 && dim / C <= kMaxOwnH &&
         q / C <= kMaxOwnO && q / C / 4 * width <= kResThreads;
}

// the thread's index, read anew wherever it is asked for: what is made of
// it is not kept in registers from one use to the next
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// The thread's index in a phase of a pass of NT n-tiles: read anew where
// W_h's operand fills half of the registers; in a pass of 8 lanes, which
// holds none, what is made of it may stay in registers from one step to
// the next (a step of 8 lanes is a chain of latencies).
template <int NT>
__device__ __forceinline__ int phase_thread() {
  if constexpr (NT == 1)
    return threadIdx.x;
  else
    return thread_index();
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

// the address of this CTA's shared-memory address `addr` in the cluster's
// CTA `rank` (this CTA's own rank included)
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// One arrival on an mbarrier of a CTA of the cluster (its address from
// map_to_rank): what this CTA's threads read before it cannot see what the
// other CTA writes after its wait on the phase ends.
__device__ __forceinline__ void arrive_remote(uint32_t remote_bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote_bar)
      : "memory");
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

__device__ __forceinline__ void st_async(uint32_t remote, uint4 v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(remote),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(remote_bar)
      : "memory");
}

// How a row of values goes to every CTA of the cluster: each of `tasks`
// values (eight columns of a lane) is held by `groups` threads, each of
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

// How the sums of the logits' tasks (four columns of a lane) are shared
// out: `per` neighbouring threads a task (a power of two, at most the
// tree's width), each adding `leaves` leaves of the tree (sum_tree).
// Threads past the last task repeat it and write nothing.
struct TreeTasks {
  bool active;
  int task, per, j, leaves;
  __device__ TreeTasks(int thread, int threads, int tasks, int tree) {
    per = 1;
    while (tasks * per * 2 <= threads && per * 2 <= tree) per *= 2;
    j = thread % per;
    const int t = thread / per;
    task = t < tasks ? t : tasks - 1;
    active = t < tasks;
    leaves = tree / per;
  }
};

// v into this thread's CTAs of the cluster, at this CTA's address `addr`,
// reported to each CTA's mbarrier at this CTA's address `bar`
__device__ __forceinline__ void push(const Spread& to, uint32_t addr,
                                     uint32_t bar, uint4 v) {
  for (unsigned r = to.first; r < to.first + to.count; ++r)
    st_async(map_to_rank(addr, r), v, map_to_rank(bar, r));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8]) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

__device__ __forceinline__ void add_bf16x2(float& a, float& b, uint32_t v) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  a += f.x;
  b += f.y;
}

__device__ __forceinline__ void add_bf16x8(float (&acc)[8], uint4 v) {
  add_bf16x2(acc[0], acc[1], v.x);
  add_bf16x2(acc[2], acc[3], v.y);
  add_bf16x2(acc[4], acc[5], v.z);
  add_bf16x2(acc[6], acc[7], v.w);
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

// One thread: the mbarriers from `first` on ready, one arrival a phase
// each but kBarFree's C, and visible to the cluster.
__device__ __forceinline__ void init_bars(uint32_t bars, int first,
                                          unsigned C) {
  for (int b = first; b < kBars; ++b)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bars +
                                                                   8 * b),
                 "r"(b == kBarFree ? C : 1u)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// Thread 0: ask the TMA for `bytes` at `src` into this CTA's shared memory
// at `dst`, in bulk copies that report to the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  for (uint32_t at = 0; at < bytes; at += kBulkBytes) {
    const uint32_t n = bytes - at < kBulkBytes ? bytes - at : kBulkBytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst + at),
        "l"(static_cast<const unsigned char*>(src) + at), "r"(n), "r"(bar)
        : "memory");
  }
}

// Thread 0: ask the TMA for this CTA's `bytes` of packed weights at `src`,
// in bulk copies that report to the mbarrier at `bar`.
__device__ __forceinline__ void request_weights(uint32_t dst, const void* src,
                                                uint32_t bytes, uint32_t bar) {
  expect_bytes(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Thread 0: what shared memory keeps of a resident CTA's packed slice (W_h's
// 16-column tiles, each as its ksteps 512-byte steps, then W_o's): of each
// warp's ksub steps of W_h those from kreg on, one block a warp, then all
// of W_o.
__device__ __forceinline__ void request_resident_weights(
    uint32_t dst, const unsigned char* slice, const ResidentLayout& lay,
    uint32_t bar) {
  expect_bytes(bar, lay.w_bytes);
  const uint32_t rest = (uint32_t)(lay.ksub - lay.kreg) * 512;
  if (rest > 0)
    for (int mt = 0; mt < lay.mh / 16; ++mt)
      for (int s = 0; s < lay.split_h; ++s)
        bulk_copy(dst + (uint32_t)(mt * lay.split_h + s) * rest,
                  slice + (size_t)(mt * lay.ksteps + s * lay.ksub + lay.kreg)
                              * 512,
                  rest, bar);
  bulk_copy(dst + lay.wo_off,
            slice + (size_t)(lay.mh / 16) * lay.ksteps * 512,
            lay.w_bytes - lay.wo_off, bar);
}

// One warp's share of a product: task `task` is a 16-column tile of the
// weight's columns (mt) times a part of the depth (s), for the pass's NT
// n-tiles of 8 lanes:
//   sum[n][m] = sum over the part's k of act[n][k] * w[k][column mt 16 + m]
// The tile's operand for the part's first `kreg` 16-deep steps is in the
// thread's registers; the others lie at `a` as 512-byte blocks, one per
// step, in the mma's register order (a thread's 16 bytes at + 16 *
// thread). The lanes' rows at `b`, an n-tile's 8 rows `tile` bytes after
// the one before. Each n-tile's products go into two chains, the even
// steps and the odd ones (the steps past the last multiple of four into
// the first), added at the end: the same sums, in the same order, at every
// width. G n-tiles (1 or 2) at a time, so few sums are live beside W_h's
// operand; each step's operand is fetched once for the G of them. Each
// n-tile's sums go to `emit(*this, n-tile, v)`: v[0], v[1] are column
// mt 16 + g of lanes 2 tig, 2 tig + 1 of the n-tile, v[2], v[3] column
// + 8 of the same (g = lane / 4, tig = lane % 4); the whole warp calls it.
template <int NT, int G>
struct ProductTask {
  bool active;
  int mt, s;            // the task's tile of columns and part of the depth
  uint32_t a, b, tile;  // shared-memory addresses of this thread's operands
  int ksub, kreg, main;
  __device__ ProductTask(uint32_t frags, int mtiles, int ksteps, int split,
                         int kreg_, uint32_t act, int act_ld, int task) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    active = task < mtiles * split;
    mt = task % mtiles;
    s = task / mtiles;
    ksub = ksteps / split;
    kreg = kreg_;
    main = ksub & ~3;
    a = frags + ((mt * split + s) * (ksub - kreg) * 32 + lane) * 16;
    b = act + (g * act_ld + s * ksub * 16 + tig * 2) * (int)sizeof(bf16);
    tile = kLanes * act_ld * (int)sizeof(bf16);
  }
  // step j of the part for n-tiles t0 .. t0 + G - 1 (where NT has them),
  // into the odd steps' chain or the other
  __device__ __forceinline__ void step(float (&c)[G][2][4], const uint4& av,
                                       int j, int t0, bool odd) const {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (t0 + u >= NT) continue;
      const uint32_t bt = b + (t0 + u) * tile + j * 32;
      const uint32_t b0 = lds32(bt), b1 = lds32(bt + 16);
      if (odd)
        mma_bf16(c[u][1], av, b0, b1);
      else
        mma_bf16(c[u][0], av, b0, b1);
    }
  }
  // KR steps from registers, the rest from shared memory in pairs; kAny:
  // any kreg and ksub, the chain of each step decided as it runs
  template <int KR, bool kAny, int R, class Emit>
  __device__ __forceinline__ void sweep(const uint4 (&areg)[R],
                                        const Emit& emit) const {
#pragma unroll
    for (int t0 = 0; t0 < NT; t0 += G) {
      float c[G][2][4] = {};
      if constexpr (kAny) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (j < kreg) step(c, areg[j], j, t0, (j & 1) && j < main);
        for (int j = kreg; j < ksub; ++j)
          step(c, lds128(a + (j - kreg) * 512), j, t0, (j & 1) && j < main);
      } else if constexpr (NT == 1) {
        // one n-tile waits on each load: four steps' operands are fetched
        // before their products
#pragma unroll
        for (int j = 0; j < KR; ++j) step(c, areg[j], j, t0, j & 1);
        int j = KR;
        for (; j + 4 <= ksub; j += 4) {
          uint4 av[4];
          uint32_t b0[4], b1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i] = lds128(a + (j + i - KR) * 512);
            b0[i] = lds32(b + (j + i) * 32);
            b1[i] = lds32(b + (j + i) * 32 + 16);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if ((j + i) & 1)
              mma_bf16(c[0][1], av[i], b0[i], b1[i]);
            else
              mma_bf16(c[0][0], av[i], b0[i], b1[i]);
        }
        for (; j < ksub; ++j)
          step(c, lds128(a + (j - KR) * 512), j, t0, j & 1);
      } else {
#pragma unroll
        for (int j = 0; j < KR; ++j) step(c, areg[j], j, t0, j & 1);
#pragma unroll 2
        for (int j = KR; j < ksub; j += 2) {
          step(c, lds128(a + (j - KR) * 512), j, t0, false);
          step(c, lds128(a + (j + 1 - KR) * 512), j + 1, t0, true);
        }
      }
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (t0 + u >= NT) continue;
        const float v[4] = {c[u][0][0] + c[u][1][0], c[u][0][1] + c[u][1][1],
                            c[u][0][2] + c[u][1][2],
                            c[u][0][3] + c[u][1][3]};
        emit(*this, t0 + u, v);
      }
    }
  }
  // The presets' shapes take one of the first two: ksub a multiple of
  // four (no steps past the last one), and all of the register array or
  // none of it used (a multiple of four steps left for shared memory).
  // (An array of one holds no steps: its sweep is not compiled.)
  template <int R, class Emit>
  __device__ __forceinline__ void run(const uint4 (&areg)[R],
                                      const Emit& emit) const {
    if (!active) return;
    if (R > 1 && main == ksub && kreg == R)
      sweep<R, false>(areg, emit);
    else if (main == ksub && kreg == 0)
      sweep<0, false>(areg, emit);
    else
      sweep<0, true>(areg, emit);
  }
};

// A product's sums into this CTA's partial sums `red`, [part][lane][column]
// (rows of `ld` floats, parts part_floats(width, ld - kRedPad) apart)
struct StoreSums {
  float* red;
  int ld, width;
  template <class Task>
  __device__ __forceinline__ void operator()(const Task& p, int nt,
                                             const float (&v)[4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    float* const o = red + (size_t)p.s * part_floats(width, ld - kRedPad) +
                     (nt * kLanes + 2 * tig) * ld + p.mt * 16 + g;
    o[0] = v[0];
    o[ld] = v[1];
    o[8] = v[2];
    o[ld + 8] = v[3];
  }
};

// Where the value of lane l, column c of the mo logit columns a CTA owns
// lies in a part of its buffer of parts (and in its noise): [16-column
// tile][pair of lanes][c % 8][l % 2][c / 8 % 2], so that the four sums a
// thread of a product holds (lanes 2 tig, 2 tig + 1 of columns g and g + 8
// of a tile) are one 16-byte row, the first lane's two its first 8 bytes,
// and so are the four an adding thread takes
__host__ __device__ inline int pair_index(int l, int c, int width) {
  return (((c / 16) * (width / 2) + l / 2) * 8 + c % 8) * 4 + l % 2 * 2 +
         c / 8 % 2;
}

// The product with W_o's sums (a tile of 16 logit columns over this CTA's
// rows of W_o, part `part0 + s` of the logits' depth) into the CTA that
// owns the columns: its buffer of parts at this CTA's address `parts`,
// which holds the round's mr columns from `first` of the owner's mo (parts
// part_floats(width, mr) floats apart, `pair_index` in each), reported to
// its mbarrier at this CTA's address `bar`: one 16-byte store a thread and
// n-tile, 8 bytes where the pair's second lane is dead. Only the live lanes
// (l < nl) are sent.
struct PushParts {
  uint32_t parts, bar;
  int mo, mr, first, width, nl, part0;
  template <class Task>
  __device__ __forceinline__ void operator()(const Task& p, int nt,
                                             const float (&v)[4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
    const int l = nt * kLanes + 2 * tig;
    if (l >= nl) return;
    const int col = p.mt * 16;
    const unsigned owner = (unsigned)(col / mo);
    const uint32_t at =
        map_to_rank(parts + ((uint32_t)(part0 + p.s) * part_floats(width, mr) +
                             pair_index(l, col % mo - first + g, width)) *
                                (uint32_t)sizeof(float),
                    owner);
    const uint32_t rbar = map_to_rank(bar, owner);
    if (l + 1 < nl)
      st_async(at, make_uint4(__float_as_uint(v[0]), __float_as_uint(v[2]),
                              __float_as_uint(v[1]), __float_as_uint(v[3])),
               rbar);
    else
      st_async(at, make_uint2(__float_as_uint(v[0]), __float_as_uint(v[2])),
               rbar);
  }
};

// bias + the partial sums of eight neighbouring columns of one lane,
// added in the order of the depth's parts (`stride` floats apart)
__device__ __forceinline__ void reduce8(const float* red, int split,
                                        size_t stride, const float* bias,
                                        float (&v)[8]) {
  const float4 b0 = *reinterpret_cast<const float4*>(bias);
  const float4 b1 = *reinterpret_cast<const float4*>(bias + 4);
  v[0] = b0.x, v[1] = b0.y, v[2] = b0.z, v[3] = b0.w;
  v[4] = b1.x, v[5] = b1.y, v[6] = b1.z, v[7] = b1.w;
  for (int s = 0; s < split; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(red + s * stride);
    const float4 o = *reinterpret_cast<const float4*>(red + s * stride + 4);
    v[0] += p.x, v[1] += p.y, v[2] += p.z, v[3] += p.w;
    v[4] += o.x, v[5] += o.y, v[6] += o.z, v[7] += o.w;
  }
}

// The same in the logits' tree (sum_tree): leaf g of `tree` holds parts g
// * split / parts .. in order (parts = min(tree, split); leaf 0 starts
// from the bias, the others from 0), and the leaves meet in a balanced
// tree in index order. The task's `per` threads (TreeTasks) each build the
// tree over their `leaves` leaves, then a butterfly of shuffles across
// them builds the rest and leaves the whole sum in all of them. Every
// thread of the warp must call it.
__device__ __forceinline__ void reduce4_tree(const float* red, int split,
                                             size_t stride, int tree,
                                             const float4& bias,
                                             const TreeTasks& tt,
                                             float (&v)[4]) {
  const int parts = tree < split ? tree : split, chunk = split / parts;
  float leaf[kMaxTiles][4];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    leaf[i][0] = leaf[i][1] = leaf[i][2] = leaf[i][3] = 0.f;
    if (i >= tt.leaves) continue;
    const int g = tt.j * tt.leaves + i;
    if (g == 0)
      leaf[i][0] = bias.x, leaf[i][1] = bias.y, leaf[i][2] = bias.z,
      leaf[i][3] = bias.w;
    if (g < parts)
      for (int s = g * chunk; s < (g + 1) * chunk; ++s) {
        const float4 p = *reinterpret_cast<const float4*>(red + s * stride);
        leaf[i][0] += p.x, leaf[i][1] += p.y, leaf[i][2] += p.z,
            leaf[i][3] += p.w;
      }
  }
#pragma unroll
  for (int w = 1; w < kMaxTiles; w *= 2)
#pragma unroll
    for (int i = 0; i + w < kMaxTiles; i += 2 * w)
      if (i + 2 * w <= tt.leaves)
#pragma unroll
        for (int e = 0; e < 4; ++e) leaf[i][e] += leaf[i + w][e];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = leaf[0][e];
  for (int off = 1; off < tt.per; off <<= 1)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] += __shfl_xor_sync(0xffffffffu, v[e], off);
}

// An asynchronous copy of 16 bytes from device memory into this CTA's
// shared memory, which takes no register while it is under way; the thread
// that asked waits for all of its copies with `wait_copies`.
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// eight columns from `col` of row `sample` of position p of the fused table
__device__ __forceinline__ uint4 table_row(const bf16* __restrict__ table,
                                           int p, int sample, int q, int dim,
                                           int col) {
  return __ldg(reinterpret_cast<const uint4*>(
      table + ((size_t)p * q + sample) * dim + col));
}

// acc += rows first .. last - 1 of the fused table for the window w, in
// position order, up to G loads under way at once
template <int G>
__device__ __forceinline__ void add_table_rows(float (&acc)[8],
                                               const bf16* __restrict__ table,
                                               const int* w, int first,
                                               int last, int q, int dim,
                                               int col) {
  for (int p0 = first; p0 < last; p0 += G) {
    uint4 rows[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (p0 + j < last)
        rows[j] = table_row(table, p0 + j, w[p0 + j], q, dim, col);
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (p0 + j < last) add_bf16x8(acc, rows[j]);
  }
}

// the eight sums at p into acc, or acc into p
__device__ __forceinline__ void load8(float (&acc)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  acc[0] = a.x, acc[1] = a.y, acc[2] = a.z, acc[3] = a.w;
  acc[4] = b.x, acc[5] = b.y, acc[6] = b.z, acc[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&acc)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(p + 4) =
      make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// a value and its class, as one lane's best of some columns
__device__ __forceinline__ uint2 as_best(float v, int i) {
  return make_uint2(__float_as_uint(v), (uint32_t)i);
}

// whether (v, i) beats (best, best_i): larger, or as large and first
__device__ __forceinline__ bool beats(float v, int i, float best,
                                      int best_i) {
  return v > best || (v == best && i < best_i);
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

// the named barriers of a CTA (0 is __syncthreads): the 16 warps that
// multiply; in a pass of 8 lanes also all warps once a sample is drawn, and
// the gather warps alone
enum Named { kNamedCompute = 1, kNamedDrawn = 2, kNamedGather = 3 };

// a barrier of `threads` threads of this CTA: all of them wait ...
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ... or some only announce that they have come
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void compute_sync() {
  named_sync(kNamedCompute, kResThreads);
}

// threads t, t + threads, ...: the pass's windows into seq (the fs0 new
// samples of a lane follow its window)
__device__ __forceinline__ void load_windows(int* seq, const int* buf,
                                             long long buf_ld, int lane0,
                                             int nl, int fs0, int t,
                                             int threads) {
  for (int i = t; i < nl * fs0; i += threads)
    seq[i / fs0 * 2 * fs0 + i % fs0] =
        buf[(size_t)(lane0 + i / fs0) * buf_ld + i % fs0];
}

// Task u of x (lane u / (mh / 8), this CTA's eight columns from u % (mh /
// 8) * 8): rows first .. last - 1 of the window of step k added, in
// position order, to its sums at `sums` (to 0 where first is 0).
template <int G>
__device__ __forceinline__ void add_rows(float* sums,
                                         const bf16* __restrict__ table,
                                         const int* seq, int u, int k,
                                         int first, int last, int fs0, int q,
                                         int dim, int mh, unsigned rank) {
  const int l = u / (mh / 8), m = u % (mh / 8) * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (first > 0) load8(acc, sums + l * mh + m);
  add_table_rows<G>(acc, table, seq + l * 2 * fs0 + k, first, last, q, dim,
                    (int)rank * mh + m);
  store8(sums + l * mh + m, acc);
}

// Task u's rows first .. first + n - 1 of the window of step k into this
// CTA's shared memory at `stage` ([row][task], `tasks` tasks), as copies
// under way (copy_async)
__device__ __forceinline__ void stage_rows(uint32_t stage,
                                           const bf16* __restrict__ table,
                                           const int* seq, int u, int tasks,
                                           int k, int first, int n, int fs0,
                                           int q, int dim, int mh,
                                           unsigned rank) {
  const int l = u / (mh / 8), m = u % (mh / 8) * 8;
  const int* const w = seq + l * 2 * fs0 + k;
  for (int i = 0; i < n; ++i) {
    const int p = first + i;
    copy_async(stage + (uint32_t)(i * tasks + u) * 16,
               table + ((size_t)p * q + w[p]) * dim + (int)rank * mh + m);
  }
}

// The same task's sums at `sums` plus its `n` staged rows (once its copies
// have arrived), in position order, then its rows first + n .. last - 1
// from device memory
template <int G>
__device__ __forceinline__ void add_staged_rows(
    float* sums, uint32_t stage, const bf16* __restrict__ table,
    const int* seq, int u, int tasks, int k, int first, int n, int last,
    int fs0, int q, int dim, int mh, unsigned rank) {
  const int l = u / (mh / 8), m = u % (mh / 8) * 8;
  float acc[8];
  load8(acc, sums + l * mh + m);
  wait_copies();
  for (int i = 0; i < n; ++i)
    add_bf16x8(acc, lds128(stage + (uint32_t)(i * tasks + u) * 16));
  add_table_rows<G>(acc, table, seq + l * 2 * fs0 + k, first + n, last, q,
                    dim, (int)rank * mh + m);
  store8(sums + l * mh + m, acc);
}

// x of step k for the task `to` sends (sample k - 1 is drawn): the sum of
// the window's other rows at `cur`, its last row and the slot row, relu,
// into the x rows of this thread's CTAs
__device__ __forceinline__ void send_x(const Spread& to, const float* cur,
                                       const bf16* __restrict__ table,
                                       const bf16* __restrict__ slots,
                                       const int* seq, bf16* xs,
                                       uint32_t bar_x, int lane0, int k,
                                       int fs0, int q, int dim, int mh,
                                       int act_ld, const Strides& st,
                                       unsigned rank) {
  const int l = to.task / (mh / 8), m = to.task % (mh / 8) * 8;
  const int col = (int)rank * mh + m;
  const uint4 last =
      table_row(table, fs0 - 1, seq[l * 2 * fs0 + k + fs0 - 1], q, dim, col);
  const uint4 srow = __ldg(reinterpret_cast<const uint4*>(
      slots + (size_t)(lane0 + l) * st.slot_ld_b + (size_t)k * st.slot_ld_k +
      col));
  float x[8];
  load8(x, cur + l * mh + m);
  add_bf16x8(x, last);
  add_bf16x8(x, srow);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = fmaxf(x[e], 0.f);
  push(to, smem_addr(xs + l * act_ld + col), bar_x, pack_bf16x8(x));
}

// A CTA has 16 warps that multiply, reduce and draw. A cluster walks
// through its share of the lanes in passes of NT n-tiles (8 NT lanes). One
// sample k of a pass, in every CTA:
//   x: sample k - 1 is drawn; add its table row (the window's last) and
//     the slot row to the sum of the other rows, made during the step
//     before; this CTA's columns of x to all CTAs; fetch the rows of the
//     next step's sum into the other of two buffers. Meanwhile the Gumbel
//     noise of this CTA's own columns of the logits; wait for all of x
//   product with W_h; this CTA's columns of h, kept here; product of them
//     with this CTA's rows of W_o, each tile of partial logits to the CTA
//     that owns its columns; wait for the C parts of this CTA's columns;
//     add them; each lane's best of this CTA's columns (logit + noise,
//     first index on ties) to all CTAs; wait for all of them; draw: the
//     best of the C bests, which is the argmax over all q columns, since a
//     CTA's columns are one block in rank order.
// Who gathers: in a pass of 8 lanes, four more warps (kGatherThreads), off
// the others' path: they wait at a barrier until a sample is drawn, send x
// and fetch all of the next step's rows while the others multiply. In a
// wider pass the 16 warps' registers hold W_h's operand, and no others fit
// beside them: while the first half of the threads send x, the second half
// fetch the first rows of the next step's sum; while the first half makes
// h, the second half asks for the rest as copies into the x rows' bytes
// (x is read by then, and the next x comes after this CTA's bests), and
// adds them once it has sent its partial logits.
// Only the live lanes of a pass are sent. A buffer is never written while
// a CTA still reads it: x of the next step is sent by CTAs that have
// drawn, so they had everyone's bests, which a CTA sends after its
// products and after it has added its parts; the parts of the next step by
// CTAs that have all of the next x, sent after the draw; the bests
// likewise after the parts. Within a CTA barriers stand between the
// product with W_h and the reads of its partial sums, and between the
// writes of h and the product with W_o, which reads them.
// Registers: in a pass wider than 8 lanes every thread holds W_h's operand
// (kreg steps, 16 B a step) for the whole launch, 64 of its 128 registers
// at 32 lanes; the layout is a parameter, read where it is used, and what
// lives from one step to the next lives in shared memory, so the rest fits
// beside it.
template <int NT, bool kRounds>
__global__ void __launch_bounds__(kResThreads + (NT == 1 ? kGatherThreads
                                                         : 0), 1)
    window_resident(const bf16* __restrict__ table,
                    const unsigned char* __restrict__ packed,
                    const float* __restrict__ bh,
                    const float* __restrict__ bo,
                    const bf16* __restrict__ slots,
                    const int* __restrict__ buf,
                    const float* __restrict__ noise,
                    const int64_t* __restrict__ seed, int* __restrict__ out,
                    int batch, int fs0, int q, int dim, Strides st,
                    const ResidentLayout lay) {
  constexpr int W = NT * kLanes;        // lanes of a pass
  constexpr int R = NT > 1 ? reg_steps(W) : 1;  // W_h's steps a register
                                                // array holds
  constexpr int G = gather_rows(NT);
  constexpr bool kGather = NT == 1;     // gather warps of their own
  constexpr int kThreads = resident_threads(NT);
  extern __shared__ __align__(128) unsigned char rsm[];
  const unsigned C = cluster_size(), rank = cluster_rank();
  bf16* const xs = reinterpret_cast<bf16*>(rsm + lay.x_off);
  bf16* const hs = reinterpret_cast<bf16*>(rsm + lay.h_off);
  float* const gum = reinterpret_cast<float*>(rsm + lay.noise_off);
  float* const red = reinterpret_cast<float*>(rsm + lay.red_off);
  float* const parts = reinterpret_cast<float*>(rsm + lay.part_off);
  float* const sums = reinterpret_cast<float*>(rsm + lay.ahead_off);
  float* const bias = reinterpret_cast<float*>(rsm + lay.bias_off);
  uint2* const cand = reinterpret_cast<uint2*>(rsm + lay.cand_off);
  uint2* const bests = reinterpret_cast<uint2*>(rsm + lay.best_off);
  int* const seq = reinterpret_cast<int*>(rsm + lay.seq_off);
  const uint32_t stage = smem_addr(rsm + lay.stage_off);
  const uint32_t bars = smem_addr(rsm + lay.bar_off);
  const uint32_t bar_w = bars + 8 * kBarWeights, bar_x = bars + 8 * kBarX,
                 bar_p = bars + 8 * kBarPart, bar_b = bars + 8 * kBarBest,
                 bar_f = bars + 8 * kBarFree;
  const int tid = threadIdx.x;
  const int mh = lay.mh, mo = lay.mo;
  // the rounds of the partial logits and the columns of each: one of all
  // mo unless kRounds (a build of its own, so that the presets' one round
  // costs nothing)
  const int rounds = kRounds ? lay.rounds : 1, mr = kRounds ? lay.mr : mo;
  // bytes of partial logits a live lane brings this CTA in a round
  const uint32_t part_bytes = (uint32_t)lay.parts * mr * sizeof(float);
  const LaneShare share(batch, gridDim.x / C, blockIdx.x / C);
  const unsigned char* const slice = packed + (size_t)rank * lay.slice_bytes;

  // rows of dead lanes are multiplied too: start them finite
  for (uint32_t i = tid; i < (lay.noise_off - lay.x_off) / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(rsm + lay.x_off)[i] = 0u;
  for (int i = tid; i < mh + mo; i += kThreads)
    bias[i] = i < mh ? bh[rank * mh + i] : bo[rank * mo + i - mh];
  if (tid == 0) {
    const int nl = min(W, share.count);
    init_bars(bars, kBarWeights, C);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    request_resident_weights(smem_addr(rsm), slice, lay, bar_w);
    expect_bytes(bar_x, nl * dim * sizeof(bf16));
    expect_bytes(bar_p, nl * part_bytes);
    expect_bytes(bar_b, nl * C * sizeof(uint2));
  }
  // every CTA of the cluster runs, its mbarriers ready, before any writes
  // into another's memory
  cluster_sync();

  if (kGather && tid >= kResThreads) {
    // ------------------------------------------------------------------
    // the gather warps of a pass of 8 lanes: x, and the next step's rows
    // ------------------------------------------------------------------
    const int g = tid - kResThreads;
    for (int sub = 0; sub < share.count; sub += W) {
      const int lane0 = share.begin + sub;
      const int nl = min(W, share.count - sub);
      const int tasks = nl * (mh / 8);
      const Spread to(g, kGatherThreads, tasks, C);
      load_windows(seq, buf, st.buf_ld, lane0, nl, fs0, g, kGatherThreads);
      named_sync(kNamedGather, kGatherThreads);
      if (g < tasks)
        add_rows<G>(sums, table, seq, g, 0, 0, fs0 - 1, fs0, q, dim, mh,
                    rank);
      named_sync(kNamedGather, kGatherThreads);
      for (int k = 0; k < fs0; ++k) {
        // sample k - 1 is drawn (the others only announce it); the sums
        // of every task are made
        if (k > 0) named_sync(kNamedDrawn, kThreads);
        if (to.active)
          send_x(to, sums + (k & 1) * W * mh, table, slots, seq, xs, bar_x,
                 lane0, k, fs0, q, dim, mh, lay.act_ld, st, rank);
        if (g < tasks && k + 1 < fs0)
          add_rows<G>(sums + ((k + 1) & 1) * W * mh, table, seq, g, k + 1,
                      0, fs0 - 1, fs0, q, dim, mh, rank);
      }
      // the others have drawn the pass's last sample, so every CTA had
      // this CTA's last x: the windows may be overwritten
      named_sync(kNamedDrawn, kThreads);
    }
  } else {
    // ------------------------------------------------------------------
    // the 16 warps: products, reductions, the draw (and, in a pass wider
    // than 8 lanes, x and the next step's rows)
    // ------------------------------------------------------------------
    const uint2 key = philox_key(noise, seed);
    // W_h's operand of this warp's first kreg steps, for the whole launch
    uint4 areg[R];
    {
      const int warp = tid >> 5, mt = warp % (mh / 16), s = warp / (mh / 16);
      const bool active = warp < (mh / 16) * lay.split_h;
      const uint4* const src = reinterpret_cast<const uint4*>(slice) +
                               (mt * lay.ksteps + s * lay.ksub) * 32 +
                               (tid & 31);
#pragma unroll
      for (int j = 0; j < R; ++j)
        areg[j] = active && j < lay.kreg ? __ldg(src + j * 32)
                                         : make_uint4(0, 0, 0, 0);
    }
    const uint4 none[1] = {make_uint4(0, 0, 0, 0)};
    uint32_t parity = 0, pparity = 0, fparity = 0;
    bool weights_here = false;
    // the next step's table rows: the first `half` while x is on its way,
    // the others while the partial logits are
    const int half = fs0 / 2;

    // Each phase below takes the thread's index afresh (phase_thread) and
    // makes what it needs of it there: in a pass wider than 8 lanes nothing
    // but W_h's operand stays in registers from one phase to the next.
    for (int sub = 0; sub < share.count; sub += W) {
      const int lane0 = share.begin + sub;
      const int nl = min(W, share.count - sub);
      const int next_nl = min(W, share.count - sub - W);
      // x and h: task t is lane t / (mh / 8), columns rank * mh + t % (mh /
      // 8) * 8 .. + 7
      const int tasks = nl * (mh / 8);
      if constexpr (!kGather) {
        load_windows(seq, buf, st.buf_ld, lane0, nl, fs0, tid, kResThreads);
        compute_sync();
        {
          const int t = phase_thread<NT>();
          if (t < tasks)
            add_rows<G>(sums, table, seq, t, 0, 0, fs0 - 1, fs0, q, dim, mh,
                        rank);
        }
        compute_sync();
      }

      for (int k = 0; k < fs0; ++k, parity ^= 1) {
        // the live lanes of the next phase (none after the last sample)
        const int after = k + 1 < fs0 ? nl : next_nl;
        if constexpr (!kGather) {
          const int t = phase_thread<NT>();
          if (t < kPushThreads) {
            // this CTA's columns of x, to every CTA
            const Spread to(t, kPushThreads, tasks, C);
            if (to.active)
              send_x(to, sums + (k & 1) * W * mh, table, slots, seq, xs,
                     bar_x, lane0, k, fs0, q, dim, mh, lay.act_ld, st, rank);
          } else if (t - kPushThreads < tasks && k + 1 < fs0) {
            // the first rows of the next step's sum
            add_rows<G>(sums + ((k + 1) & 1) * W * mh, table, seq,
                        t - kPushThreads, k + 1, 0, half, fs0, q, dim, mh,
                        rank);
          }
        }
        {
          // the Gumbel noise of this CTA's columns of the logits, a class
          // of a lane a thread, while x is on its way
          const int t = phase_thread<NT>();
          const int cls = (int)rank * mo + t % mo, step = kResThreads / mo;
          for (int l = t / mo; l < nl && t / mo < step; l += step) {
            float g;
            if (noise != nullptr) {
              g = noise[((size_t)(lane0 + l) * fs0 + k) * q + cls];
            } else {
              const uint4 r = philox(make_uint4((uint32_t)(cls / 4),
                                                (uint32_t)k,
                                                (uint32_t)(lane0 + l), 0u),
                                     key);
              const int j = cls % 4;
              g = gumbel(j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w);
            }
            gum[pair_index(l, t % mo, W)] = g;
          }
        }
        wait_for_bytes(bar_x, parity, "x");
        if (tid == 0 && after > 0)
          expect_bytes(bar_x, after * dim * sizeof(bf16));
        if (!weights_here) {
          wait_for_bytes(bar_w, 0, "the weights");
          weights_here = true;
        }

        // this CTA's columns of h = relu(x @ W_h + b_h), kept here
        ProductTask<NT, (NT <= 2 ? 2 : 1)>(smem_addr(rsm), mh / 16,
                                           lay.ksteps, lay.split_h, lay.kreg,
                                           smem_addr(xs), lay.act_ld,
                                           threadIdx.x >> 5)
            .run(areg, StoreSums{red, mh + kRedPad, W});
        compute_sync();
        {
          const int t = phase_thread<NT>();
          if (!kGather && t >= kPushThreads) {
            // the second half: the next step's other rows under way into
            // the x rows' bytes (x is read) while it multiplies
            if (t - kPushThreads < tasks && k + 1 < fs0)
              stage_rows(stage, table, seq, t - kPushThreads, tasks, k + 1,
                         half, lay.staged, fs0, q, dim, mh, rank);
          } else if (t < tasks) {
            const int l = t / (mh / 8), m = t % (mh / 8) * 8;
            float h[8];
            reduce8(red + l * (mh + kRedPad) + m, lay.split_h,
                    part_floats(W, mh), bias + m, h);
#pragma unroll
            for (int e = 0; e < 8; ++e) h[e] = fmaxf(h[e], 0.f);
            *reinterpret_cast<uint4*>(hs + l * lay.h_ld + m) =
                pack_bf16x8(h);
          }
        }
        compute_sync();

        // the logits in rounds of mr of each owner's columns (one round
        // where the cluster's parts of all mo fit at once)
        for (int round = 0; round < rounds; ++round) {
          const int first = round * mr;
          if (kRounds && round > 0) {
            // every owner has added the last round's parts
            wait_for_bytes(bar_f, fparity, "room for the partial logits");
            fparity ^= 1;
          }
          // its products with this CTA's rows of W_o: every tile of the
          // round's partial logits to the CTA that owns its columns
          {
            const PushParts to{smem_addr(parts), bar_p, mo, mr, first, W, nl,
                               (int)rank * lay.split_o};
            const int per = mr / 16, tiles = per * (int)C;
            for (int task = phase_thread<NT>() >> 5;
                 task < tiles * lay.split_o; task += kResWarps) {
              int ot = task;
              if constexpr (kRounds) {
                // tile i of the round: owner i / per's tile i % per from
                // `first`
                const int i = task % tiles;
                ot = task / tiles * (q / 16) + i / per * (mo / 16) +
                     first / 16 + i % per;
              }
              ProductTask<NT, (NT >= 2 ? 2 : 1)>(
                  smem_addr(rsm + lay.wo_off), q / 16, mh / 16, lay.split_o,
                  0, smem_addr(hs), lay.h_ld, ot)
                  .run(none, to);
            }
          }
          if constexpr (!kGather) {
            // the other rows of the next step's sum
            const int t = phase_thread<NT>();
            if (round == 0 && t >= kPushThreads && t - kPushThreads < tasks &&
                k + 1 < fs0)
              add_staged_rows<G>(sums + ((k + 1) & 1) * W * mh, stage, table,
                                 seq, t - kPushThreads, tasks, k + 1, half,
                                 lay.staged, fs0 - 1, fs0, q, dim, mh, rank);
          }
          wait_for_bytes(bar_p, kRounds ? pparity : parity,
                         "the partial logits");
          pparity ^= 1;
          {
            const int lanes = round + 1 < rounds ? nl : after;
            if (tid == 0 && lanes > 0) expect_bytes(bar_p, lanes * part_bytes);
          }

          // this CTA's columns of the logits with their noise: a task is
          // two lanes (a pair) of two columns c and c + 8 of a tile, and
          // leaves each lane's best of the two ...
          {
            const int t = phase_thread<NT>();
            const TreeTasks to(t, kResThreads, (nl + 1) / 2 * (mr / 2),
                               lay.tree);
            const int lp = to.task / (mr / 2);
            const int r = first / 2 + to.task % (mr / 2);
            const int c = r / 8 * 16 + r % 8, at = pair_index(2 * lp, c, W);
            float v[4];
            reduce4_tree(parts + pair_index(2 * lp, c - first, W), lay.parts,
                         part_floats(W, mr), lay.tree,
                         make_float4(bias[mh + c], bias[mh + c + 8],
                                     bias[mh + c], bias[mh + c + 8]),
                         to, v);
            if (to.active && to.j == 0) {
              const float4 g = *reinterpret_cast<const float4*>(gum + at);
              const float sc[4] = {v[0] + g.x, v[1] + g.y, v[2] + g.z,
                                   v[3] + g.w};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (2 * lp + e >= nl) continue;
                float best = -INFINITY;
                int best_i = 0;
                if (sc[2 * e] > best) {
                  best = sc[2 * e];
                  best_i = (int)rank * mo + c;
                }
                if (sc[2 * e + 1] > best) {
                  best = sc[2 * e + 1];
                  best_i = (int)rank * mo + c + 8;
                }
                cand[(2 * lp + e) * (mo / 2) + r] = as_best(best, best_i);
              }
            }
          }
          compute_sync();
          // this CTA's parts are read: room in it for every CTA's next round
          if (kRounds && round + 1 < rounds) {
            const int t = phase_thread<NT>();
            if (t < (int)C) arrive_remote(map_to_rank(bar_f, t));
          }
        }
        {
          // ... each lane's best of this CTA's columns (the largest, the
          // lowest class on ties), to every CTA
          const int t = phase_thread<NT>();
          if (t < nl * (int)C) {
            const int l = t / (int)C, r = t % (int)C;
            float best = -INFINITY;
            int best_i = 0x7fffffff;
            for (int c = 0; c < mo / 2; ++c) {
              const uint2 b = cand[l * (mo / 2) + c];
              if (beats(__uint_as_float(b.x), (int)b.y, best, best_i)) {
                best = __uint_as_float(b.x);
                best_i = (int)b.y;
              }
            }
            st_async(map_to_rank(smem_addr(bests + l * C + rank), r),
                     as_best(best, best_i), map_to_rank(bar_b, r));
          }
        }
        wait_for_bytes(bar_b, parity, "the bests");
        if (tid == 0 && after > 0)
          expect_bytes(bar_b, after * C * sizeof(uint2));
        {
          // every CTA draws every lane's sample: the best of the C bests, C
          // threads a lane
          const int t = phase_thread<NT>();
          const int l = t / (int)C, r = t % (int)C;
          const bool live = l < nl;
          const uint2 b = live ? bests[l * C + r] : as_best(-INFINITY, 0);
          float best = __uint_as_float(b.x);
          int best_i = (int)b.y;
          for (unsigned off = 1; off < C; off <<= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, best, off);
            const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
            if (beats(ov, oi, best, best_i)) {
              best = ov;
              best_i = oi;
            }
          }
          if (live && r == 0) seq[l * 2 * fs0 + fs0 + k] = best_i;
        }
        if constexpr (kGather) {
          __threadfence_block();
          named_arrive(kNamedDrawn, kThreads);   // the gather warps wait
        }
        compute_sync();
      }

      if (rank == 0)
        for (int i = tid; i < nl * fs0; i += kResThreads)
          out[(size_t)(lane0 + i / fs0) * fs0 + i % fs0] =
              seq[(i / fs0) * 2 * fs0 + fs0 + i % fs0];
      compute_sync();   // seq has been read
    }
    if (!weights_here) wait_for_bytes(bar_w, 0, "the weights");
  }
  cluster_sync();   // nobody writes into the memory of a CTA that has left
}

// What a resident window costs before it loads, multiplies or draws: per
// sample and pass the three exchanges of the real kernel with their bytes
// (x, 2 dim bytes a lane from the cluster into each CTA, in 16-byte
// stores; each CTA's partial logits of every column into the column's
// owner, 4 q bytes a lane and part, in 16-byte stores, in the real
// kernel's rounds; each CTA's best, 8 bytes a lane), every CTA waiting for
// all of each, on the same grid and shared memory.
template <int NT>
__global__ void __launch_bounds__(kResThreads, 1)
    window_empty(int batch, int fs0, int dim, const ResidentLayout lay) {
  constexpr int W = NT * kLanes;
  extern __shared__ __align__(128) unsigned char rsm[];
  const unsigned C = cluster_size(), rank = cluster_rank();
  bf16* const xs = reinterpret_cast<bf16*>(rsm + lay.x_off);
  uint2* const bests = reinterpret_cast<uint2*>(rsm + lay.best_off);
  const uint32_t bars = smem_addr(rsm + lay.bar_off);
  const uint32_t bar_x = bars + 8 * kBarX, bar_p = bars + 8 * kBarPart,
                 bar_b = bars + 8 * kBarBest, bar_f = bars + 8 * kBarFree;
  const uint32_t parts = smem_addr(rsm + lay.part_off);
  const int tid = threadIdx.x, mh = lay.mh, mr = lay.mr;
  const uint32_t part_bytes = (uint32_t)lay.parts * mr * sizeof(float);
  const LaneShare share(batch, gridDim.x / C, blockIdx.x / C);
  if (tid == 0) {
    const int nl = min(W, share.count);
    init_bars(bars, kBarX, C);
    expect_bytes(bar_x, nl * dim * sizeof(bf16));
    expect_bytes(bar_p, nl * part_bytes);
    expect_bytes(bar_b, nl * C * sizeof(uint2));
  }
  cluster_sync();
  uint32_t parity = 0, pparity = 0, fparity = 0;
  // the partial logits as the product with W_o sends them: a warp's task
  // (a tile of 16 columns of the round, a part of this CTA's depth) goes to
  // the tile's owner, a thread's four sums of a pair of lanes of each
  // n-tile a store
  const int per = mr / 16, tiles = per * (int)C, lane = tid & 31;
  const int g = lane >> 2, l0 = 2 * (lane & 3);
  for (int sub = 0; sub < share.count; sub += W) {
    const int nl = min(W, share.count - sub);
    const int next_nl = min(W, share.count - sub - W);
    const Spread to(tid, kResThreads, nl * (mh / 8), C);
    const int at = to.task / (mh / 8) * lay.act_ld + (int)rank * mh +
                   to.task % (mh / 8) * 8;
    const uint4 v = make_uint4(sub, 0, 0, 0);
    for (int k = 0; k < fs0; ++k, parity ^= 1) {
      const int after = k + 1 < fs0 ? nl : next_nl;
      if (to.active) push(to, smem_addr(xs + at), bar_x, v);
      wait_for_bytes(bar_x, parity, "x of the empty window");
      if (tid == 0 && after > 0)
        expect_bytes(bar_x, after * dim * sizeof(bf16));
      for (int round = 0; round < lay.rounds; ++round) {
        if (round > 0) {
          wait_for_bytes(bar_f, fparity, "room in the empty window");
          fparity ^= 1;
        }
        for (int task = tid >> 5; task < tiles * lay.split_o;
             task += kResWarps)
          for (int l = l0; l < nl; l += kLanes) {
            const int s = task / tiles;
            const unsigned owner = (unsigned)(task % tiles / per);
            const uint32_t dst = map_to_rank(
                parts + ((uint32_t)((int)rank * lay.split_o + s) *
                             part_floats(W, mr) +
                         pair_index(l, task % per * 16 + g, W)) *
                            (uint32_t)sizeof(float),
                owner);
            if (l + 1 < nl)
              st_async(dst, v, map_to_rank(bar_p, owner));
            else
              st_async(dst, make_uint2(v.x, v.y), map_to_rank(bar_p, owner));
          }
        wait_for_bytes(bar_p, pparity, "the parts of the empty window");
        pparity ^= 1;
        const int lanes = round + 1 < lay.rounds ? nl : after;
        if (tid == 0 && lanes > 0) expect_bytes(bar_p, lanes * part_bytes);
        if (round + 1 < lay.rounds) {
          __syncthreads();
          if (tid < (int)C) arrive_remote(map_to_rank(bar_f, tid));
        }
      }
      if (tid < nl * (int)C)
        st_async(map_to_rank(smem_addr(bests + tid / C * C + rank), tid % C),
                 make_uint2(k, sub), map_to_rank(bar_b, tid % C));
      wait_for_bytes(bar_b, parity, "the bests of the empty window");
      if (tid == 0 && after > 0)
        expect_bytes(bar_b, after * C * sizeof(uint2));
    }
  }
  cluster_sync();
}

struct ResidentLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attrs[1];
  ResidentLaunch(int cluster, int clusters, size_t smem, int threads,
                 cudaStream_t stream) {
    config = cudaLaunchConfig_t{};
    config.gridDim = dim3(cluster * clusters);
    config.blockDim = dim3(threads);
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

template <int NT>
const void* resident_variant(bool rounds) {
  return rounds ? reinterpret_cast<const void*>(window_resident<NT, true>)
                : reinterpret_cast<const void*>(window_resident<NT, false>);
}

// the resident kernel and its empty window for passes of `width` lanes
// (the kernel's build for partial logits in more than one round, or in one)
const void* resident_kernel(int width, int rounds) {
  switch (width / kLanes) {
    case 1: return resident_variant<1>(rounds > 1);
    case 2: return resident_variant<2>(rounds > 1);
    case 3: return resident_variant<3>(rounds > 1);
    case 4: return resident_variant<4>(rounds > 1);
    default: return nullptr;
  }
}

const void* empty_kernel(int width) {
  switch (width / kLanes) {
    case 1: return reinterpret_cast<const void*>(window_empty<1>);
    case 2: return reinterpret_cast<const void*>(window_empty<2>);
    case 3: return reinterpret_cast<const void*>(window_empty<3>);
    case 4: return reinterpret_cast<const void*>(window_empty<4>);
    default: return nullptr;
  }
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
// CTAs, each walking through its share of the lanes in passes of `width`
// (8, 16, 24 or 32). packed: `cluster` slices of (dim / cluster + q /
// cluster) * dim bf16, slice r holding columns r * dim / cluster .. of W_h
// (all of its depth) and then rows r * dim / cluster .. of W_o (all of its
// q columns), each as [16-column tile][16-deep step][32 lanes][8 values]
// in the register order of mma m16n8k16's A operand.
// Exactly one of noise / seed is non-null. Strides in elements: lane b's
// window at buf + b * buf_ld, its slot row of step k at slots + b *
// slot_ld_b + k * slot_ld_k. Returns the cudaError_t of the launch (0 on
// success).
int sample_window_resident_launch(const void* table, const void* packed,
                                  const void* bh, const void* bo,
                                  const void* slots, const void* buf,
                                  const void* noise, const void* seed,
                                  void* out, int batch, int fs0, int q,
                                  int dim, long long buf_ld,
                                  long long slot_ld_b, long long slot_ld_k,
                                  int cluster, int clusters, int width,
                                  void* stream) {
  if ((noise == nullptr) == (seed == nullptr) || batch < 1 || clusters < 1 ||
      clusters > batch || !resident_shape_ok(fs0, q, dim, cluster, width))
    return cudaErrorInvalidValue;
  const ResidentLayout lay(fs0, q, dim, cluster, width);
  const void* kernel = resident_kernel(width, lay.rounds);
  cudaError_t err = allow(kernel, lay.total, cluster);
  if (err != cudaSuccess) return err;
  ResidentLaunch launch(cluster, clusters, lay.total,
                        resident_threads(width / kLanes),
                        static_cast<cudaStream_t>(stream));
  Strides st{buf_ld, slot_ld_b, slot_ld_k};
  void* args[] = {&table, &packed, &bh,  &bo,  &slots, &buf, &noise, &seed,
                  &out,   &batch,  &fs0, &q,   &dim,   &st,  (void*)&lay};
  return cudaLaunchKernelExC(&launch.config, kernel, args);
}

// the resident kernel's grid, clusters and shared memory through the
// exchanges of a window of `batch` lanes in passes of `width`, with their
// bytes, and no other work
int sample_window_empty_launch(int batch, int fs0, int q, int dim,
                               int cluster, int clusters, int width,
                               void* stream) {
  if (batch < 1 || clusters < 1 || clusters > batch ||
      !resident_shape_ok(fs0, q, dim, cluster, width))
    return cudaErrorInvalidValue;
  const ResidentLayout lay(fs0, q, dim, cluster, width);
  const void* kernel = empty_kernel(width);
  cudaError_t err = allow(kernel, lay.total, cluster);
  if (err != cudaSuccess) return err;
  ResidentLaunch launch(cluster, clusters, lay.total, kResThreads,
                        static_cast<cudaStream_t>(stream));
  void* args[] = {&batch, &fs0, &dim, (void*)&lay};
  return cudaLaunchKernelExC(&launch.config, kernel, args);
}

// shared memory of one CTA of the resident kernel in a cluster of
// `cluster` in passes of `width` lanes; -1 where that cluster cannot split
// the weights or carry such passes
long long sample_window_resident_smem(int fs0, int q, int dim, int cluster,
                                      int width) {
  if (!resident_shape_ok(fs0, q, dim, cluster, width)) return -1;
  return (long long)ResidentLayout(fs0, q, dim, cluster, width).total;
}

// How many clusters of `cluster` CTAs of the resident kernel for passes of
// `width` lanes the current device holds at once (the occupancy API's
// answer; 0: such a cluster is not granted). Negative: minus the
// cudaError_t.
int sample_window_max_clusters(int fs0, int q, int dim, int cluster,
                               int width) {
  if (!resident_shape_ok(fs0, q, dim, cluster, width))
    return -(int)cudaErrorInvalidValue;
  const ResidentLayout lay(fs0, q, dim, cluster, width);
  const void* kernel = resident_kernel(width, lay.rounds);
  cudaError_t err = allow(kernel, lay.total, cluster);
  if (err != cudaSuccess) return -(int)err;
  int sms = 0, dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  // the answer does not depend on the grid as long as it is large enough
  ResidentLaunch launch(cluster, sms / cluster > 0 ? sms / cluster : 1,
                        lay.total, resident_threads(width / kLanes),
                        nullptr);
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
