// Fused GRU layer for the training path: the recurrent sweep of one layer,
// forward and backward, as hand-written kernels.
//
// Replaces the JAX package's pallas/gru_kernel.py: `_fwd_kernel` (through
// `_fwd_impl`) and `_bwd_kernel` (through `_gru_layer_bwd`). Per timestep t
// of the forward, with torch gate order [r, z, n]:
//
//   hproj = h @ W_hh^T + b_hh          (inputs rounded to W's type, f32 sums)
//   r = sigmoid(xp_r + hproj_r)   z = sigmoid(xp_z + hproj_z)
//   n = tanh(xp_n + r * hproj_n)  h' = (1 - z) * n + z * h
//
// emitting ys[t] = h' and, for training, hproj[t]. The backward sweeps t
// from T-1 to 0: it recomputes the gates from the saved x_proj, hproj and
// h_prev, forms dh_total = dy[t] + dh, emits
//   dxp[t]    = [dr_pre, dz_pre, dn_pre]
//   dhproj[t] = [dr_pre, dz_pre, dn_pre * r]
// and carries dh = dh_total * z + dhproj[t] @ W_hh; dh0 is the last carry.
// x_proj, h, ys, hproj and every gradient are float32; W is float32 (exact
// products) or bfloat16 (the mixed-precision train step).
//
// What bounds it on the H100. Per layer and step the product is 0.8 GFLOP
// at B 128, H 1024 (under a microsecond of tensor-core time) against 6 MB of
// bf16 weights and 1.5-3 MB of streamed f32 activations, so neither the
// memory rate nor the arithmetic rate is near: the chain of T steps, each of
// which needs all of the previous h (resp. dhproj) on every SM, bounds a
// sweep. On the TPU the grid is sequential and h stays in VMEM beside the
// whole weight; here no SM holds the weight and a step cannot stay inside
// one CTA. What a step costs is what it does besides the product: starting
// and draining a launch, fetching the weight again, fetching the left
// operand, and handing the result to the other SMs.
//
// Design for bfloat16 products (the train step): ONE PERSISTENT KERNEL PER
// SWEEP, launched cooperatively. The grid is (H / 16 column slices) x (row
// tiles of B), one CTA per SM, in clusters of neighbouring column slices.
//  - Weights resident. A cluster of C CTAs shares the product of its C
//    slices' columns and splits its depth K: every CTA holds, for the whole
//    sweep, its K-slice of the cluster's columns of W_hh (96 * H bytes:
//    96 KB at H 1024, whatever C is), read from the weight as stored,
//    (3H, H): the forward's operand rows are rows of W_hh; the backward
//    transposes its columns on the way in. Splitting K rather than the
//    columns makes the products wide (wgmma m64n96k16 forward, m64n128k16
//    backward, both operands from shared memory in the no-swizzle K-major
//    layout, float32 accumulators in registers) and cuts what a CTA
//    fetches of the left operand by C. The C partial sums of a CTA's own
//    columns come through distributed shared memory and are added in rank
//    order; the gate math follows in registers.
//  - A grid barrier per step (an atomic counter and a bounded spin), not a
//    launch. What crosses it is a bf16 copy of h (resp. dhproj), written by
//    every CTA for its own columns straight in the tiled order of the
//    readers' shared memory, one slab per step, so no slab is read and
//    written in the same step and a reader's whole K-slice is one
//    contiguous block: the thread that sees the barrier complete asks the
//    TMA for it (bulk copies through L2, which is where other SMs' writes
//    are visible; L1 is not coherent between SMs), an mbarrier per chunk
//    reports its arrival, and a chunk's products run while the next ones
//    land. The float32 state of a CTA's own tile never leaves its
//    registers.
//  - Only that slab is written before a CTA arrives at the barrier. The
//    outputs that no CTA reads during the sweep (ys, hproj, the row-major
//    bf16 copy for the weight-gradient product; backward dxp, dhproj) are
//    written, and the next step's inputs from device memory are fetched,
//    between the arrival and the wait.
// Design for float32 products (the default float32 train step, and every
// evaluation): ONE PERSISTENT KERNEL PER SWEEP as well, with the products
// on the tensor cores in split TF32. Each operand x is cut into
// x_hi = tf32(x) and x_lo = tf32(x - x_hi), and a product is the three TF32
// products a_hi b_hi + a_hi b_lo + a_lo b_hi summed in float32 (wgmma
// m64nNk8 .tf32): each operand keeps 22 of its 24 bits and the dropped
// a_lo b_lo is 2^-22 of the product, so the sum is float32's up to the
// order of its terms.
//  - What bounds it. A (B 128, H 1024) step is 0.8 GFLOP, 2.4 GFLOP of TF32
//    work in three passes: 4.9 us of the card's 495 TFLOP/s dense, 0.254 ms
//    for a sweep of 52 steps, against 0.625 ms of float32 FMA at 67 TFLOP/s.
//    So the design is the bf16 one with what float32 costs in room: W_hh's
//    hi and lo parts are 24 MiB, which only the whole card's shared memory
//    holds (132 x 227 KB), so no CTA may hold a copy another CTA holds.
//  - A cluster of 2 CTAs owns TN columns of the state for a 128-row tile of
//    the batch; its CTAs split the depth in halves and each keeps, for the
//    whole sweep, its half of the cluster's columns of W_hh, hi and lo (192
//    H bytes: 192 KiB at H 1024, in both directions). Each computes the
//    whole tile over its half (two warpgroups of 64 rows), then takes 64
//    rows: its own and the other CTA's partial sums, through distributed
//    shared memory, in rank order.
//  - The weight is split once per call to the layer by the wrapper (the
//    forward's split is kept for the backward); the left operand (h, resp.
//    dhproj) is split in registers, since wgmma takes A from registers. It
//    crosses the grid barrier as float32 in the order of wgmma's A
//    fragments (16 rows x 8 columns in 512 contiguous bytes, a thread's
//    four values one 16-byte word), so a warp brings its 16 rows in with one
//    coalesced load per thread and k8 step, straight into registers through
//    L2 (ld.global.cg: where the other SMs' writes are) and 16 k8 steps
//    ahead of the products: the weights leave no shared memory for a ring.
//    Each CTA reads 128 rows x K/2 of it a step (256 KB forward, 768 KB
//    backward at H 1024).
//  - What a step costs on an H100: ptxas serializes these kernels' wgmmas
//    (each waits for the one before; C7510, though their SASS has no call),
//    so the small m64n48k8 and m64n16k8 products run at about a half and
//    a quarter of the tensor cores' rate, and they, not the loads, set the
//    time of a step.
// Sums are in a fixed order and there are no float atomics: two runs give
// the same bits. Shapes the persistent kernels cannot hold (a grid that is
// not resident at once, a slice larger than shared memory) take the
// per-step version below; the caller chooses by shape.
//
// The per-step version: ONE LAUNCH PER TIMESTEP, ordered by the stream, all
// enqueued by one C call. Forward: a grid over (16-column slices of H) x
// (64-row tiles of B); a CTA computes the three gate columns j, H+j, 2H+j
// of hproj for its rows, then the gate math, and writes ys[t] reading
// ys[t-1] (or h0): no buffer is read and written by one launch, so no grid
// barrier is needed. Backward: T + 1 launches; launch t fuses the product
// of step t+1 (dhproj[t+1] @ W_hh, restricted to the CTA's own columns)
// with the elementwise part of step t, which needs only those columns of
// dh; dh_total * z passes between launches in a (B, H) scratch each element
// of which is read and rewritten by the same thread. The product inside a
// launch, by the weight's type, both with sums in a fixed order:
//  - float32: FMA, a register-tiled loop (4 x 4 outputs per thread) over
//    32-deep chunks staged in shared memory, the chunk split over thread
//    groups whose partial sums are added in order. Exact float32 products.
//  - bfloat16: tensor cores, warp-level mma (the wmma API, m16n16k16,
//    float32 accumulators) over chunks that a ring of cp.async stages keeps
//    in flight; the left operand comes from a bf16 copy of h (resp. of
//    dhproj) that the previous launch's epilogue wrote beside the float32
//    one. The chunk's depth is split over two warp groups, added in order.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int TM = 64;         // batch rows per CTA
constexpr int TN = 16;         // columns of H per CTA (per gate, forward)
constexpr int KC = 32;         // depth of one staged chunk
constexpr int HS_LD = TM + 4;  // padded row stride of the staged A tile

constexpr int kFwdSlices = 3, kFwdGroups = 2;   // 384 threads
constexpr int kBwdSlices = 1, kBwdGroups = 4;   // 256 threads

constexpr int kFwdThreads = (kFwdSlices * TN / 4) * (TM / 4) * kFwdGroups;
constexpr int kBwdThreads = (kBwdSlices * TN / 4) * (TM / 4) * kBwdGroups;

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// red[g][row][c] = partial sums over thread group g of
//   sum_k a[row][k] * w[k][slice(c)]      row < TM, c < NS * TN, k < K
// where column c = s * TN + cc reads w[k * ldw + s * slice_stride + cc].
// Rows >= `rows` are treated as zero. K must be a multiple of KC and `a`
// rows 16-byte aligned. Ends with a __syncthreads: red is readable.
template <int NS, int KG>
__device__ __forceinline__ void tile_product(
    const float* a, int lda, int rows, const float* w, int ldw,
    int slice_stride, int K, float (&hs)[KC][HS_LD],
    float (&ws)[KC][NS * TN], float (&red)[KG][TM][NS * TN]) {
  constexpr int NC = NS * TN;
  constexpr int NQ = NC / 4;
  constexpr int NT = NQ * (TM / 4) * KG;
  constexpr int KSUB = KC / KG;
  const int tid = threadIdx.x;
  const int kg = tid / (NQ * (TM / 4));
  const int within = tid % (NQ * (TM / 4));
  const int cq = within % NQ;
  const int rq = within / NQ;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();   // the previous chunk has been consumed
    for (int i = tid; i < TM * (KC / 4); i += NT) {
      const int row = i / (KC / 4);
      const int kq = i % (KC / 4);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < rows)
        v = *reinterpret_cast<const float4*>(a + (size_t)row * lda + k0 +
                                             kq * 4);
      hs[kq * 4 + 0][row] = v.x;
      hs[kq * 4 + 1][row] = v.y;
      hs[kq * 4 + 2][row] = v.z;
      hs[kq * 4 + 3][row] = v.w;
    }
    for (int i = tid; i < KC * NC; i += NT) {
      const int kk = i / NC;
      const int c = i % NC;
      const int s = c / TN;
      const int cc = c % TN;
      ws[kk][c] = w[(size_t)(k0 + kk) * ldw + (size_t)s * slice_stride + cc];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < KSUB; ++u) {
      const int kk = kg * KSUB + u;
      const float4 av = *reinterpret_cast<const float4*>(&hs[kk][rq * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][cq * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[kg][rq * 4 + r][cq * 4 + c] = acc[r][c];
  __syncthreads();
}

// Gate math of one forward step for this CTA's (rows x TN) tile. red holds
// `groups` partial products laid out [group][TM][3 * TN]. Writes y, the
// bf16 copy y_b (if given) and the residual hproj (if given).
__device__ __forceinline__ void fwd_epilogue(
    const float* red, int groups, int nthreads, int rows, int row0, int j0,
    const float* __restrict__ h_prev, const float* __restrict__ b_hh,
    const float* __restrict__ xp, float* __restrict__ y,
    __nv_bfloat16* __restrict__ y_b, float* __restrict__ hproj, int H) {
  constexpr int NC = 3 * TN;
  for (int e = threadIdx.x; e < TM * TN; e += nthreads) {
    const int row = e / TN;
    const int cc = e % TN;
    if (row >= rows) continue;
    const int j = j0 + cc;
    const size_t b = (size_t)(row0 + row);
    float hp[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      float s = red[row * NC + g * TN + cc];
      for (int q = 1; q < groups; ++q)
        s += red[(q * TM + row) * NC + g * TN + cc];
      hp[g] = s + b_hh[g * H + j];
    }
    const float* xrow = xp + b * 3 * H;
    const float h = h_prev[b * H + j];
    const float r = sigmoid_f32(xrow[j] + hp[0]);
    const float z = sigmoid_f32(xrow[H + j] + hp[1]);
    const float n = tanhf(xrow[2 * H + j] + r * hp[2]);
    const float h_new = (1.0f - z) * n + z * h;
    y[b * H + j] = h_new;
    if (y_b != nullptr) y_b[b * H + j] = __float2bfloat16_rn(h_new);
    if (hproj != nullptr) {
      float* prow = hproj + b * 3 * H;
      prow[j] = hp[0];
      prow[H + j] = hp[1];
      prow[2 * H + j] = hp[2];
    }
  }
}

// The elementwise part of one backward launch for this CTA's tile. With
// `product`, red holds `groups` partial products [group][TM][TN] of step
// t+1 and dh = dhz + their sum, else dh = 0. With xp null this is the last
// launch and dh goes to dh0; else step t's gate gradients are written (and
// dhproj's bf16 copy, if given) and dhz is replaced by dh_total * z.
__device__ __forceinline__ void bwd_epilogue(
    const float* red, int groups, int nthreads, bool product, int rows,
    int row0, int j0, float* dhz, const float* xp, const float* hproj,
    const float* h_prev, const float* dy, float* dxp, float* dhproj,
    __nv_bfloat16* dhproj_b, float* dh0, int H) {
  for (int e = threadIdx.x; e < TM * TN; e += nthreads) {
    const int row = e / TN;
    const int cc = e % TN;
    if (row >= rows) continue;
    const int j = j0 + cc;
    const size_t b = (size_t)(row0 + row);
    float dh = 0.0f;
    if (product) {
      float s = red[row * TN + cc];
      for (int q = 1; q < groups; ++q) s += red[(q * TM + row) * TN + cc];
      dh = dhz[b * H + j] + s;
    }
    if (xp == nullptr) {
      dh0[b * H + j] = dh;
      continue;
    }
    const float* xrow = xp + b * 3 * H;
    const float* prow = hproj + b * 3 * H;
    const float hprev = h_prev[b * H + j];
    const float hn = prow[2 * H + j];
    const float r = sigmoid_f32(xrow[j] + prow[j]);
    const float z = sigmoid_f32(xrow[H + j] + prow[H + j]);
    const float n = tanhf(xrow[2 * H + j] + r * hn);
    const float dh_total = dy[b * H + j] + dh;
    const float dn_pre = dh_total * (1.0f - z) * (1.0f - n * n);
    const float dz_pre = dh_total * (hprev - n) * z * (1.0f - z);
    const float dr_pre = dn_pre * hn * r * (1.0f - r);
    float* gx = dxp + b * 3 * H;
    float* gp = dhproj + b * 3 * H;
    gx[j] = dr_pre;
    gx[H + j] = dz_pre;
    gx[2 * H + j] = dn_pre;
    gp[j] = dr_pre;
    gp[H + j] = dz_pre;
    gp[2 * H + j] = dn_pre * r;
    if (dhproj_b != nullptr) {
      __nv_bfloat16* gb = dhproj_b + b * 3 * H;
      gb[j] = __float2bfloat16_rn(dr_pre);
      gb[H + j] = __float2bfloat16_rn(dz_pre);
      gb[2 * H + j] = __float2bfloat16_rn(dn_pre * r);
    }
    dhz[b * H + j] = dh_total * z;
  }
}

// One forward timestep, float32 (FMA) version. h_prev (B, H) is ys[t-1] or h0; xp
// (B, 3H); y (B, H); hproj (B, 3H) or null (evaluation: no residual).
__global__ void __launch_bounds__(kFwdThreads)
    gru_fwd_step(const float* __restrict__ h_prev,
                 const float* __restrict__ w_hh_t,
                 const float* __restrict__ b_hh, const float* __restrict__ xp,
                 float* __restrict__ y, float* __restrict__ hproj, int B,
                 int H) {
  constexpr int NS = kFwdSlices, KG = kFwdGroups;
  __shared__ __align__(16) float hs[KC][HS_LD];
  __shared__ __align__(16) float ws[KC][NS * TN];
  __shared__ __align__(16) float red[KG][TM][NS * TN];
  const int j0 = blockIdx.x * TN;
  const int row0 = blockIdx.y * TM;
  const int rows = min(TM, B - row0);
  tile_product<NS, KG>(h_prev + (size_t)row0 * H, H, rows, w_hh_t + j0,
                          3 * H, H, H, hs, ws, red);
  fwd_epilogue(&red[0][0][0], KG, kFwdThreads, rows, row0, j0, h_prev, b_hh,
               xp, y, nullptr, hproj, H);
}

// One launch of the backward sweep, float32 (FMA) version: the product of step t+1
// (if dhproj_next is given) restricted to this CTA's columns, then the
// elementwise part of step t (if xp is given) or the write of dh0.
// dhz (B, H) carries dh_total * z from one launch to the next.
__global__ void __launch_bounds__(kBwdThreads)
    gru_bwd_step(const float* dhproj_next, const float* __restrict__ w_hh,
                 float* dhz, const float* xp, const float* hproj,
                 const float* h_prev, const float* dy, float* dxp,
                 float* dhproj, float* dh0, int B, int H) {
  constexpr int NS = kBwdSlices, KG = kBwdGroups;
  __shared__ __align__(16) float hs[KC][HS_LD];
  __shared__ __align__(16) float ws[KC][NS * TN];
  __shared__ __align__(16) float red[KG][TM][NS * TN];
  const int j0 = blockIdx.x * TN;
  const int row0 = blockIdx.y * TM;
  const int rows = min(TM, B - row0);
  const bool product = dhproj_next != nullptr;   // uniform over the grid
  if (product)
    tile_product<NS, KG>(dhproj_next + (size_t)row0 * 3 * H, 3 * H, rows,
                            w_hh + j0, H, 0, 3 * H, hs, ws, red);
  bwd_epilogue(&red[0][0][0], KG, kBwdThreads, product, rows, row0, j0, dhz,
               xp, hproj, h_prev, dy, dxp, dhproj, nullptr, dh0, H);
}

// ---------------------------------------------------------------------------
// Tensor-core version (bfloat16 operands, float32 accumulators)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcSplit = 2;                        // warp groups over depth
constexpr int kTcWarps = (TM / 16) * kTcSplit;     // 8
constexpr int kTcThreads = kTcWarps * 32;          // 256
constexpr int kTcStages = 4;

// Shared-memory plan of one tile product with NS column slices and chunks
// KCT deep: kTcStages stages of [A: TM x (KCT + 8)] [B: KCT x (NC + 8)]
// bf16 (8 elements of padding keep the rows 16 bytes apart in banks), then
// the float32 partial products [kTcSplit][TM][NC].
template <int NS, int KCT>
struct TcPlan {
  static constexpr int NC = NS * TN;
  static constexpr int A_LD = KCT + 8;
  static constexpr int B_LD = NC + 8;
  static constexpr int A_ELEMS = TM * A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + KCT * B_LD;
  static constexpr size_t RED_OFFSET =
      (size_t)kTcStages * STAGE_ELEMS * sizeof(bf16);
  static constexpr size_t BYTES =
      RED_OFFSET + (size_t)kTcSplit * TM * NC * sizeof(float);
};

// red[g][row][c] (g < kTcSplit) = partial sums over warp group g of
//   sum_k a[row][k] * w[k][slice(c)]
// with a (rows x K, bf16, row stride lda) and w as in tile_product. Rows
// >= `rows` are zero. K must be a multiple of KCT; a's and w's rows 16-byte
// aligned. Ends with a __syncthreads: red is readable.
template <int NS, int KCT>
__device__ __forceinline__ void tile_product_tc(
    const bf16* a, int lda, int rows, const bf16* w, int ldw,
    int slice_stride, int K, unsigned char* smem) {
  using P = TcPlan<NS, KCT>;
  using namespace nvcuda;
  constexpr int KSTEPS = KCT / 16 / kTcSplit;   // k-steps per warp per chunk
  bf16* const stages = reinterpret_cast<bf16*>(smem);
  float* const red = reinterpret_cast<float*>(smem + P::RED_OFFSET);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int strip = warp % (TM / 16);   // 16-row strip of the tile
  const int group = warp / (TM / 16);   // which part of each chunk's depth
  const int nchunks = K / KCT;

  auto load_chunk = [&](int chunk) {
    bf16* const as = stages + (size_t)(chunk % kTcStages) * P::STAGE_ELEMS;
    bf16* const bs = as + P::A_ELEMS;
    const int k0 = chunk * KCT;
    for (int i = tid; i < TM * (KCT / 8); i += kTcThreads) {
      const int row = i / (KCT / 8);
      const int piece = i % (KCT / 8);
      bf16* const dst = as + row * P::A_LD + piece * 8;
      if (row < rows)
        __pipeline_memcpy_async(dst, a + (size_t)row * lda + k0 + piece * 8,
                                16);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = tid; i < KCT * NS * 2; i += kTcThreads) {
      const int kk = i / (NS * 2);
      const int s = (i % (NS * 2)) / 2;
      const int half = i % 2;
      __pipeline_memcpy_async(
          bs + kk * P::B_LD + s * TN + half * 8,
          w + (size_t)(k0 + kk) * ldw + (size_t)s * slice_stride + half * 8,
          16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) wmma::fill_fragment(acc[s], 0.0f);

  // a commit per step, empty or not, keeps the group count in step
  for (int c = 0; c < kTcStages - 1; ++c) {
    if (c < nchunks) load_chunk(c);
    __pipeline_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    if (c + kTcStages - 1 < nchunks) load_chunk(c + kTcStages - 1);
    __pipeline_commit();
    __pipeline_wait_prior(kTcStages - 1);   // chunk c has landed
    __syncthreads();
    const bf16* const as =
        stages + (size_t)(c % kTcStages) * P::STAGE_ELEMS;
    const bf16* const bs = as + P::A_ELEMS;
#pragma unroll
    for (int u = 0; u < KSTEPS; ++u) {
      const int kk = (group * KSTEPS + u) * 16;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, as + strip * 16 * P::A_LD + kk, P::A_LD);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, bs + kk * P::B_LD + s * 16, P::B_LD);
        wmma::mma_sync(acc[s], af, bf, acc[s]);
      }
    }
    __syncthreads();   // the stage may be refilled
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    wmma::store_matrix_sync(
        red + ((size_t)group * TM + strip * 16) * P::NC + s * 16, acc[s],
        P::NC, wmma::mem_row_major);
  __syncthreads();
}

constexpr int kFwdChunkTc = 64;
constexpr int kBwdChunkTc = 128;

// One forward timestep on the tensor cores. h_prev_b is the bf16 copy of
// h_prev; y_b receives the bf16 copy of y for the next step.
__global__ void __launch_bounds__(kTcThreads)
    gru_fwd_step_tc(const float* __restrict__ h_prev,
                    const bf16* __restrict__ h_prev_b,
                    const bf16* __restrict__ w_hh_t,
                    const float* __restrict__ b_hh,
                    const float* __restrict__ xp, float* __restrict__ y,
                    bf16* __restrict__ y_b, float* __restrict__ hproj, int B,
                    int H) {
  using P = TcPlan<3, kFwdChunkTc>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int j0 = blockIdx.x * TN;
  const int row0 = blockIdx.y * TM;
  const int rows = min(TM, B - row0);
  tile_product_tc<3, kFwdChunkTc>(h_prev_b + (size_t)row0 * H, H, rows,
                                  w_hh_t + j0, 3 * H, H, H, smem);
  fwd_epilogue(reinterpret_cast<const float*>(smem + P::RED_OFFSET), kTcSplit,
               kTcThreads, rows, row0, j0, h_prev, b_hh, xp, y, y_b, hproj,
               H);
}

// One launch of the backward sweep on the tensor cores. dhproj_next_b is
// the bf16 copy of dhproj[t+1]; dhproj_b receives that of dhproj[t].
__global__ void __launch_bounds__(kTcThreads)
    gru_bwd_step_tc(const bf16* dhproj_next_b, const bf16* __restrict__ w_hh,
                    float* dhz, const float* xp, const float* hproj,
                    const float* h_prev, const float* dy, float* dxp,
                    float* dhproj, bf16* dhproj_b, float* dh0, int B, int H) {
  using P = TcPlan<1, kBwdChunkTc>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int j0 = blockIdx.x * TN;
  const int row0 = blockIdx.y * TM;
  const int rows = min(TM, B - row0);
  const bool product = dhproj_next_b != nullptr;   // uniform over the grid
  if (product)
    tile_product_tc<1, kBwdChunkTc>(dhproj_next_b + (size_t)row0 * 3 * H,
                                    3 * H, rows, w_hh + j0, H, 0, 3 * H, smem);
  bwd_epilogue(reinterpret_cast<const float*>(smem + P::RED_OFFSET), kTcSplit,
               kTcThreads, product, rows, row0, j0, dhz, xp, hproj, h_prev,
               dy, dxp, dhproj, dhproj_b, dh0, H);
}

cudaError_t forward(const float* x_proj, const float* w_hh_t,
                    const float* b_hh,
                    const float* h0, float* ys, float* hproj, int T, int B,
                    int H, cudaStream_t stream) {
  const dim3 grid(H / TN, (B + TM - 1) / TM);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    gru_fwd_step<<<grid, kFwdThreads, 0, stream>>>(
            t == 0 ? h0 : ys + (t - 1) * bh, w_hh_t, b_hh,
            x_proj + t * 3 * bh, ys + t * bh,
            hproj == nullptr ? nullptr : hproj + t * 3 * bh, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t backward(const float* x_proj, const float* hproj, const float* h0,
                     const float* ys, const float* dy, const float* w_hh,
                     float* dxp, float* dhproj, float* dh0, float* dhz, int T,
                     int B, int H, cudaStream_t stream) {
  const dim3 grid(H / TN, (B + TM - 1) / TM);
  const int threads = kBwdThreads;
  const size_t bh = (size_t)B * H;
  for (int t = T - 1; t >= -1; --t) {
    const float* next = t == T - 1 ? nullptr : dhproj + (t + 1) * 3 * bh;
    if (t >= 0)
      gru_bwd_step<<<grid, threads, 0, stream>>>(
          next, w_hh, dhz, x_proj + t * 3 * bh, hproj + t * 3 * bh,
          t == 0 ? h0 : ys + (t - 1) * bh, dy + t * bh, dxp + t * 3 * bh,
          dhproj + t * 3 * bh, nullptr, B, H);
    else
      gru_bwd_step<<<grid, threads, 0, stream>>>(
          next, w_hh, dhz, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, dh0, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The tensor-core sweeps. scratch_b holds two (B, H) resp. (B, 3H) bf16
// buffers used in turn: a launch reads the one the previous launch wrote.
// The caller has put the bf16 copy of h0 into the forward's first buffer.
cudaError_t forward_tc(const float* x_proj, const bf16* w_hh_t,
                       const float* b_hh, const float* h0, float* ys,
                       float* hproj, bf16* scratch_b, int T, int B, int H,
                       cudaStream_t stream) {
  const size_t smem = TcPlan<3, kFwdChunkTc>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_step_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H / TN, (B + TM - 1) / TM);
  const size_t bh = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    gru_fwd_step_tc<<<grid, kTcThreads, smem, stream>>>(
        t == 0 ? h0 : ys + (t - 1) * bh, scratch_b + (t & 1) * bh, w_hh_t,
        b_hh, x_proj + t * 3 * bh, ys + t * bh,
        scratch_b + ((t + 1) & 1) * bh,
        hproj == nullptr ? nullptr : hproj + t * 3 * bh, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t backward_tc(const float* x_proj, const float* hproj,
                        const float* h0, const float* ys, const float* dy,
                        const bf16* w_hh, float* dxp, float* dhproj,
                        float* dh0, float* dhz, bf16* scratch_b, int T, int B,
                        int H, cudaStream_t stream) {
  const size_t smem = TcPlan<1, kBwdChunkTc>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_step_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H / TN, (B + TM - 1) / TM);
  const size_t bh = (size_t)B * H;
  for (int t = T - 1; t >= -1; --t) {
    const bf16* next =
        t == T - 1 ? nullptr : scratch_b + ((t + 1) & 1) * 3 * bh;
    if (t >= 0)
      gru_bwd_step_tc<<<grid, kTcThreads, smem, stream>>>(
          next, w_hh, dhz, x_proj + t * 3 * bh, hproj + t * 3 * bh,
          t == 0 ? h0 : ys + (t - 1) * bh, dy + t * bh, dxp + t * 3 * bh,
          dhproj + t * 3 * bh, scratch_b + (t & 1) * 3 * bh, nullptr, B, H);
    else
      gru_bwd_step_tc<<<grid, kTcThreads, smem, stream>>>(
          next, w_hh, dhz, nullptr, nullptr, nullptr, nullptr, nullptr,
          nullptr, nullptr, dh0, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// H a multiple of the chunk depth: 32 for the float32 (FMA) version, 128
// for the bfloat16 (tensor-core) version's backward
bool bad_shape(int T, int B, int H, int dtype) {
  const int m = dtype == 1 ? kBwdChunkTc : KC;
  return T < 1 || B < 1 || H < m || H % m != 0;
}

// ---------------------------------------------------------------------------
// Persistent version (bfloat16 operands): one cooperative launch per sweep
// ---------------------------------------------------------------------------
//
// A cluster of C CTAs (neighbours along the column slices, same row tile)
// shares one product: ROWS rows x (C slices' columns), with the depth K
// split over the CTAs. Shared memory of a CTA: its K-slice of the cluster's
// columns of W_hh for the whole sweep (96 * H bytes whatever C is), then
// one region that holds its K-slice of the left operand (ROWS x K/C,
// bf16) while a step's products run and its partial sums (ROWS x N, f32)
// after, which the other CTAs of the cluster read through distributed
// shared memory. Both operands are laid out for wgmma without
// swizzle, K-major: 8 rows x 16 bytes form a core matrix of 128 contiguous
// bytes; core matrices that are neighbours along K lie kCoreBytes apart
// (the descriptor's leading byte offset), groups of 8 rows one `sbo` apart
// (its stride byte offset).
//
// The left operand crosses the grid barrier in device memory ALREADY IN
// THAT LAYOUT: beside the row-major bf16 copy of h (resp. dhproj) that the
// weight-gradient product reads afterwards, every CTA writes its columns
// into a tiled copy in which each (row tile, K-slice) is one contiguous
// block, cut into chunks along K. The reader then needs no per-thread
// copies (cp.async through the load/store unit was several times slower
// than the TMA on an H100): one thread asks the TMA for a bulk copy per
// chunk, an mbarrier per chunk reports its arrival, and the products of a
// chunk start while the later chunks are on their way.

constexpr int kCoreBytes = 128;
constexpr unsigned kSpinLimit = 1u << 24;           // polls before a trap

// NPER operand rows per column slice (3 * TN forward, TN backward), K the
// whole depth (H forward, 3H backward); clusters of C CTAs of ROWS_ batch
// rows each, a warpgroup per 64 rows. The shapes are chosen by what must be
// resident at once. A cluster lies inside one GPC, so an H100 of 132 SMs
// may hold only 30 clusters of 4 or 15 of 8 (the occupancy API's answer on
// an NVIDIA H100 80GB HBM3), but 66 of 2: a (B 128, H 1024) sweep fits as
// 64 clusters of 2 x 64 rows or as 8 clusters of 8 x 128 rows, and the
// backward's deeper K-slice only fits shared memory when split eight ways.
// What the other CTAs' partial sums cost over the SM-to-SM network, which
// is slow, grows with C - 1: the forward takes the smallest C that fits.
template <int NPER, int C_, int ROWS_>
struct ClusterPlan {
  static constexpr int C = C_;
  static constexpr int ROWS = ROWS_;
  static constexpr int THREADS = 2 * ROWS_;
  static constexpr int N = NPER * C;       // width of the cluster's product
  // the partial sums, [owner CTA's rank][row][its NPER columns + 4]: what
  // one CTA fetches from another is one block, and the 8 rows of a warp's
  // access are spread evenly over the banks
  static constexpr int P_LD = NPER + 4;
  static constexpr int P_BLOCK = ROWS * P_LD;
  __host__ __device__ static size_t w_bytes(int K) {
    return (size_t)N * (K / C) * sizeof(bf16);
  }
  __host__ __device__ static size_t bytes(int K) {
    const size_t a = (size_t)ROWS * (K / C) * sizeof(bf16);
    const size_t p = (size_t)C * P_BLOCK * sizeof(float);
    return w_bytes(K) + (a > p ? a : p);
  }
  // a CTA per column slice and row tile
  static dim3 grid(int B, int H) { return dim3(H / TN, (B + ROWS - 1) / ROWS); }
};
using FwdPlan = ClusterPlan<3 * TN, 2, 64>;
using BwdPlan = ClusterPlan<TN, 8, 128>;

// The tiled copy of a (steps, B, K) left operand for clusters of C: per
// step and row tile rows * K elements, [K-slice][chunk][8-row group]
// [8-column group of the chunk][row of 8][column of 8]: a chunk of a slice
// is the shared-memory image of that part of the operand.
constexpr int kMaxChunks = 4;
struct Tiling {
  int rows;           // of a row tile
  int kslice;         // depth of a CTA's slice
  int chunks;         // per slice: 4, 2 or 1, as the slice divides
  int kgc;            // 8-column groups per chunk (even: whole k16 steps)
  int chunk_elems;
  __host__ __device__ Tiling(int K, int C, int rows_) {
    rows = rows_;
    kslice = K / C;
    const int kgs = kslice / 8;
    chunks = kgs % 8 == 0 ? 4 : kgs % 4 == 0 ? 2 : 1;
    kgc = kgs / chunks;
    chunk_elems = rows * kgc * 8;
  }
  // where (row of the tile, column of K) lies in its row tile's block
  __device__ size_t offset(int row, int col) const {
    const int kg = col % kslice / 8;
    return (size_t)(col / kslice) * rows * kslice +
           (size_t)(kg / kgc) * chunk_elems +
           ((row >> 3) * kgc + kg % kgc) * 64 + (row & 7) * 8 + (col & 7);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory (the weight slice, once)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// shared memory written by this thread becomes visible to wgmma's reads
// and ordered before the TMA's writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// One bulk copy (the TMA, no tensor map) of `bytes` contiguous bytes from
// global to shared memory, reported to the mbarrier `bar`, on which this
// thread is the one arrival. The copy reads through L2, so it sees what
// other SMs wrote before the last grid barrier (request_slice's proxy fence
// orders it after those writes).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wait until the mbarrier's phase of the given parity has completed;
// bounded like the grid barrier's spin
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (unsigned spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > kSpinLimit) {
      printf("gru_layer: a bulk copy never arrived (CTA %d,%d)\n", blockIdx.x,
             blockIdx.y);
      __trap();
    }
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// no-swizzle K-major operand descriptor (offsets in bytes)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 128, f32) = or += a (64 x 16, bf16) * b^T (b: 128 x 16, K-major)
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 96, f32) = or += a (64 x 16, bf16) * b^T (b: 96 x 16, K-major)
__device__ __forceinline__ void wgmma_bf16(float (&d)[48], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// all threads of all CTAs of the cluster; shared-memory writes before it
// are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four floats at shared-memory address `addr` of the cluster's CTA `rank`
// (another CTA's: through the SM-to-SM network)
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, unsigned rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// The grid barrier, in two halves so that loads which need not be ordered
// by it can be started between them. Every CTA arrives; none passes the wait
// before all have arrived. `target` is the count after this barrier (CTAs x
// barriers so far): the counter only grows during a sweep and the launcher
// zeroes it before. Writes made before the arrival are visible, through L2,
// to every CTA after the wait; the thread that sees the barrier complete
// runs `on_pass` at once. A barrier that is never completed traps instead
// of hanging.
__device__ __forceinline__ void grid_arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

template <class F>
__device__ __forceinline__ void grid_wait(unsigned* counter, unsigned target,
                                          F on_pass) {
  if (threadIdx.x == 0) {
    unsigned seen, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (++spins > kSpinLimit) {
        printf("gru_layer: grid barrier stuck at %u of %u (CTA %d,%d)\n", seen,
               target, blockIdx.x, blockIdx.y);
        __trap();
      }
    } while (seen < target);
    __threadfence();
    on_pass();      // thread 0, as soon as it knows that all have arrived
  }
  __syncthreads();
}

// Thread 0 asks the TMA for this CTA's K-slice of the left operand (rows
// x kslice, tiled, at `src` in device memory), a bulk copy per chunk. The
// full proxy fence orders the copies after the other SMs' (generic) writes
// of `src` as this thread came to know them at the grid barrier, and after
// this CTA's reads of the partial sums that lay at `asm_`.
__device__ __forceinline__ void request_slice(const bf16* src,
                                              const Tiling& tl, uint32_t asm_,
                                              uint32_t bars) {
  const uint32_t chunk_bytes = tl.chunk_elems * sizeof(bf16);
  asm volatile("fence.proxy.async;\n" ::: "memory");
  for (int c = 0; c < tl.chunks; ++c)
    bulk_load(asm_ + c * chunk_bytes, src + (size_t)c * tl.chunk_elems,
              chunk_bytes, bars + 8 * c);
}

// acc (64 x N, f32, in wgmma's register layout; the warpgroup's 64 of the
// CTA's rows) = a * w^T: this CTA's share of the cluster's product, a the
// slice that request_slice asked for, w (N x kslice) resident at `wsm`.
// Everyone waits for each chunk on its mbarrier (phase `parity`); the
// (asynchronous) products of a chunk run while the later chunks arrive.
// Ends with a __syncthreads: the operand at `asm_` is free.
template <int N>
__device__ __forceinline__ void slice_product(const Tiling& tl, uint32_t asm_,
                                              uint32_t wsm, uint32_t bars,
                                              uint32_t parity,
                                              float (&acc)[N / 2]) {
  const uint32_t chunk_bytes = tl.chunk_elems * sizeof(bf16);
  const uint32_t sbo_a = tl.kgc * kCoreBytes;
  const uint32_t sbo_w = (tl.kslice / 8) * kCoreBytes;
  const uint32_t mine = asm_ + (threadIdx.x / 128) * 8 * sbo_a;  // 64 rows on
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int c = 0; c < tl.chunks; ++c) {
    mbarrier_wait(bars + 8 * c, parity);
    wgmma_fence();
    for (int s = 0; s < tl.kgc / 2; ++s)
      wgmma_bf16(acc,
                 wgmma_desc(mine + c * chunk_bytes + s * 2 * kCoreBytes,
                            kCoreBytes, sbo_a),
                 wgmma_desc(wsm + (c * tl.kgc + 2 * s) * kCoreBytes,
                            kCoreBytes, sbo_w),
                 (c | s) != 0);
    wgmma_commit();
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  __syncthreads();
}

__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void add4(float (&s)[4], const float4& v) {
  s[0] += v.x;
  s[1] += v.y;
  s[2] += v.z;
  s[3] += v.w;
}

// the gates on the fast exponential (ex2.approx and an approximate
// division, a few float32 roundings off the accurate functions, far inside
// what rounding the products' operands to bf16 costs): one or two
// warpgroups per SM cannot hide the accurate versions' long dependent chains
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 2.0f * sigmoid_fast(2.0f * x) - 1.0f;
}

// Where wgmma leaves a warpgroup's product: the 8-column tile i holds rows
// row(hr), hr in {0, 1}, columns 8 * i + col() + {0, 1}, at
// acc[4 * i + 2 * hr + {0, 1}].
struct AccThread {
  int warp, lane;
  __device__ AccThread() : warp(threadIdx.x >> 5), lane(threadIdx.x & 31) {}
  __device__ int row(int hr) const { return warp * 16 + (lane >> 2) + 8 * hr; }
  __device__ int col() const { return (lane & 3) * 2; }
};

// What a thread owns of the CTA's ROWS x TN tile of the state, after the
// partial sums are added: rows row(0) and row(1), columns col() .. col() +
// 3. A warp then touches 8 rows x 64 bytes of float32 per access, whole
// sectors, with half the requests that wgmma's own layout would need.
template <int ROWS>
struct TileThread {
  int r, q;
  __device__ TileThread() : r(threadIdx.x >> 2), q(threadIdx.x & 3) {}
  __device__ int row(int hr) const { return r + (ROWS / 2) * hr; }
  __device__ int col() const { return 4 * q; }
};

// the partial sums, as wgmma left them, into the CTA's own buffer (which
// lies over the left operand: slice_product has ended), each owner's
// columns into its block
template <class P>
__device__ __forceinline__ void store_partials(float* partial,
                                               const float (&acc)[P::N / 2]) {
  constexpr int NPER = P::P_LD - 4;      // columns per owner
  const AccThread at;
#pragma unroll
  for (int i = 0; i < P::N / 8; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      st2(partial + (8 * i / NPER) * P::P_BLOCK + at.row(hr) * P::P_LD +
              8 * i % NPER + at.col(),
          acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
}

// The forward sweep of one layer. w is W_hh as stored, (3H, H) bf16: column
// j of gate g is its row g * H + j, contiguous along K. hb (T + 1, B, H)
// bf16 receives h0 and every ys[t] rounded to bf16, and hbt the same tiled
// (T + 1 steps x row tiles x ROWS * H): step t reads hbt[t] (all columns,
// written by all CTAs before the last barrier) and writes hbt[t + 1] (its
// own columns). Of the cluster's product the CTA of rank q
// computes the K-slice q for all C slices' columns (operand row
// q' * 3 TN + g * TN + cc is column cc of gate g of slice q'), then adds
// the C partial sums of its own columns in rank order and does their gate
// math. The CTA's own tile of h stays in registers as float32. Only hbt
// has to be written before the barrier's arrival; hb, ys and hproj are
// written and x_proj[t + 1] is fetched between the arrival and the wait.
__global__ void __launch_bounds__(FwdPlan::THREADS, 1)
    gru_fwd_persistent(const float* __restrict__ x_proj,
                       const bf16* __restrict__ w,
                       const float* __restrict__ b_hh,
                       const float* __restrict__ h0, float* __restrict__ ys,
                       float* __restrict__ hproj, bf16* __restrict__ hb,
                       bf16* hbt, unsigned* counter, int T, int B, int H) {
  using P = FwdPlan;
  constexpr int C = P::C, ROWS = P::ROWS, THREADS = P::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long arrival[kMaxChunks];
  const Tiling tl(H, C, ROWS);
  const int kslice = tl.kslice;
  const uint32_t bars = smem_addr(arrival);
  const uint32_t wsm = smem_addr(smem);
  const uint32_t asm_ = wsm + (uint32_t)P::w_bytes(H);
  float* const partial = reinterpret_cast<float*>(smem + P::w_bytes(H));
  const uint32_t sbo = (kslice / 8) * kCoreBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TileThread<ROWS> me;
  const unsigned rank = cluster_rank();
  const int j0 = blockIdx.x * TN;
  const int jc0 = j0 - (int)rank * TN;       // the cluster's first column
  const int row0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, B - row0);
  const unsigned nblocks = gridDim.x * gridDim.y;
  // this row tile's block of step t in hbt: + t * step
  const size_t step = (size_t)gridDim.y * ROWS * H;
  bf16* const tile = hbt + (size_t)blockIdx.y * ROWS * H;

  if (threadIdx.x == 0) {
    for (int c = 0; c < kMaxChunks; ++c) mbarrier_init(bars + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int u = warp; u < P::N / 8 * (kslice / 32); u += THREADS / 32) {
    const int n8 = u % (P::N / 8);
    const int kg = (u / (P::N / 8)) * 4 + (lane >> 3);
    const int n = n8 * 8 + (lane & 7);
    const int col = jc0 + n / (3 * TN) * TN + n % TN;
    const int gate = n % (3 * TN) / TN;
    cp_async_16(wsm + n8 * sbo + kg * kCoreBytes + (lane & 7) * 16,
                w + ((size_t)gate * H + col) * H + rank * kslice + kg * 8);
  }
  cp_async_commit();

  // rows past the batch compute on row 0's inputs and store nothing
  const int j = j0 + me.col();
  bool live[2];
  size_t brow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    live[hr] = me.row(hr) < rows;
    brow[hr] = row0 + (live[hr] ? me.row(hr) : 0);
  }
  float h[2][4];
  float4 bias[3], xp[2][3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bias[g] = ld4(b_hh + g * H + j);
  auto fetch_xp = [&](int t) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        xp[hr][g] = ld4(x_proj + ((size_t)t * B + brow[hr]) * 3 * H + g * H + j);
  };
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float4 v = ld4(h0 + brow[hr] * H + j);
    h[hr][0] = v.x, h[hr][1] = v.y, h[hr][2] = v.z, h[hr][3] = v.w;
    if (live[hr]) {
      st4(tile + tl.offset(me.row(hr), j), h[hr]);
      st4(hb + brow[hr] * H + j, h[hr]);
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  grid_arrive(counter);
  fetch_xp(0);
  grid_wait(counter, nblocks, [&] {
    request_slice(tile + (size_t)rank * ROWS * kslice, tl, asm_, bars);
  });

  float hp[2][3][4];
  // hb, ys and hproj of step t, which no CTA reads during the sweep
  auto write_outputs = [&](int t) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (!live[hr]) continue;
      const size_t b = (size_t)t * B + brow[hr];
      st4(hb + (b + B) * H + j, h[hr]);
      st4(ys + b * H + j, h[hr]);
      if (hproj != nullptr) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
          st4(hproj + b * 3 * H + g * H + j, hp[hr][g]);
      }
    }
  };

  for (int t = 0; t < T; ++t) {
    {
      float acc[P::N / 2];
      slice_product<P::N>(tl, asm_, wsm, bars, t & 1, acc);
      store_partials<P>(partial, acc);
    }
    cluster_sync();
    // every load is under way before the first sum waits for one
    float4 part[C][2][3];
#pragma unroll
    for (int q = 0; q < C; ++q)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int g = 0; g < 3; ++g)
        {
          const float* const mine = partial + rank * P::P_BLOCK +
                                    me.row(hr) * P::P_LD + g * TN + me.col();
          part[q][hr][g] =
              q == rank ? ld4(mine) : ld_cluster4(smem_addr(mine), q);
        }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        hp[hr][g][0] = bias[g].x, hp[hr][g][1] = bias[g].y;
        hp[hr][g][2] = bias[g].z, hp[hr][g][3] = bias[g].w;
#pragma unroll
        for (int q = 0; q < C; ++q) add4(hp[hr][g], part[q][hr][g]);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float xr[4] = {xp[hr][0].x, xp[hr][0].y, xp[hr][0].z, xp[hr][0].w};
      const float xz[4] = {xp[hr][1].x, xp[hr][1].y, xp[hr][1].z, xp[hr][1].w};
      const float xn[4] = {xp[hr][2].x, xp[hr][2].y, xp[hr][2].z, xp[hr][2].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = sigmoid_fast(xr[e] + hp[hr][0][e]);
        const float z = sigmoid_fast(xz[e] + hp[hr][1][e]);
        const float n = tanh_fast(xn[e] + r * hp[hr][2][e]);
        h[hr][e] = (1.0f - z) * n + z * h[hr][e];
      }
      if (live[hr])
        st4(tile + (t + 1) * step + tl.offset(me.row(hr), j), h[hr]);
    }
    if (t + 1 == T) {
      write_outputs(t);
      break;
    }
    // the TMA's next writes land where the partial sums were read
    fence_proxy_async();
    grid_arrive(counter);
    write_outputs(t);
    fetch_xp(t + 1);
    grid_wait(counter, nblocks * (t + 2), [&] {
      request_slice(tile + (t + 1) * step + (size_t)rank * ROWS * kslice,
                    tl, asm_, bars);
    });
  }
  cluster_sync();   // no CTA leaves while another may read its partial sums
}

// 16 bits of v: element n (0..7) of the 8 bf16 values it holds
__device__ __forceinline__ uint32_t bf16_bits(const uint4& v, int n) {
  const uint32_t word = n / 2 == 0 ? v.x : n / 2 == 1 ? v.y
                        : n / 2 == 2 ? v.z : v.w;
  return n % 2 ? word >> 16 : word & 0xFFFFu;
}

// The reverse sweep of one layer, T + 1 steps (t = T - 1 .. -1) as in the
// per-step version: step t adds the product of step t + 1 (dhb[t + 1] times
// the columns of W_hh) to the carried dh_total * z, which stays in
// registers, then does the elementwise part of step t. dhb (T, B, 3H) bf16
// receives every dhproj[t] rounded to bf16, dhbt the same tiled (T steps x
// row tiles x ROWS * 3H). The product is split over the
// cluster as in the forward; the operand is the cluster's C * TN columns
// of the CTA's K-slice of W_hh's rows, transposed on the way into shared
// memory (K contiguous), once. dhT, if given, is the final state's
// cotangent: it starts the carry, so dy need not be copied to fold it in.
// Only dhbt has to be written before the barrier's arrival; dhb, dxp and
// dhproj are written and the saved tensors of step t - 1 are fetched
// between the arrival and the wait.
__global__ void __launch_bounds__(BwdPlan::THREADS, 1)
    gru_bwd_persistent(const float* __restrict__ x_proj,
                       const float* __restrict__ hproj,
                       const float* __restrict__ h0,
                       const float* __restrict__ ys,
                       const float* __restrict__ dy,
                       const float* __restrict__ dhT,
                       const bf16* __restrict__ w, float* __restrict__ dxp,
                       float* __restrict__ dhproj, bf16* __restrict__ dhb,
                       bf16* dhbt, float* __restrict__ dh0,
                       unsigned* counter, int T, int B, int H) {
  using P = BwdPlan;
  constexpr int C = P::C, ROWS = P::ROWS, THREADS = P::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long arrival[kMaxChunks];
  const Tiling tl(3 * H, C, ROWS);
  const int kslice = tl.kslice;
  const uint32_t bars = smem_addr(arrival);
  const uint32_t wsm = smem_addr(smem);
  const uint32_t asm_ = wsm + (uint32_t)P::w_bytes(3 * H);
  float* const partial = reinterpret_cast<float*>(smem + P::w_bytes(3 * H));
  const uint32_t sbo = (kslice / 8) * kCoreBytes;
  const TileThread<ROWS> me;
  const unsigned rank = cluster_rank();
  const int j0 = blockIdx.x * TN;
  const int jc0 = j0 - (int)rank * TN;
  const int row0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, B - row0);
  const unsigned nblocks = gridDim.x * gridDim.y;
  const size_t bh = (size_t)B * H;
  // this row tile's block of step t in dhbt: + t * step
  const size_t step = (size_t)gridDim.y * ROWS * 3 * H;
  bf16* const tile = dhbt + (size_t)blockIdx.y * ROWS * 3 * H;

  if (threadIdx.x == 0) {
    for (int c = 0; c < kMaxChunks; ++c) mbarrier_init(bars + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // operand row n (< C * TN), depth k: W_hh[rank * kslice + k][jc0 + n]. A
  // thread transposes 8 x 8 blocks: 8 depths of 8 columns in, 8 columns of
  // 8 depths out.
  for (int u = threadIdx.x; u < (P::N / 8) * (kslice / 8); u += THREADS) {
    const int n8 = u % (P::N / 8);
    const int kg = u / (P::N / 8);
    uint4 in[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      in[i] = *reinterpret_cast<const uint4*>(
          w + (size_t)(rank * kslice + kg * 8 + i) * H + jc0 + n8 * 8);
    uint4* const out = reinterpret_cast<uint4*>(smem + (size_t)n8 * sbo +
                                                (size_t)kg * kCoreBytes);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      out[n] = make_uint4(bf16_bits(in[0], n) | bf16_bits(in[1], n) << 16,
                          bf16_bits(in[2], n) | bf16_bits(in[3], n) << 16,
                          bf16_bits(in[4], n) | bf16_bits(in[5], n) << 16,
                          bf16_bits(in[6], n) | bf16_bits(in[7], n) << 16);
  }
  fence_proxy_async();   // the first barrier's __syncthreads completes this

  // rows past the batch compute on row 0's inputs and store nothing
  const int j = j0 + me.col();
  bool live[2];
  size_t brow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    live[hr] = me.row(hr) < rows;
    brow[hr] = row0 + (live[hr] ? me.row(hr) : 0);
  }
  float dhz[2][4];
  float4 xp[2][3], hp[2][3], hprev[2], dyv[2];
  auto fetch = [&](int t) {
    const float* const prev = t == 0 ? h0 : ys + (t - 1) * bh;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const size_t b = (size_t)t * B + brow[hr];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        xp[hr][g] = ld4(x_proj + b * 3 * H + g * H + j);
        hp[hr][g] = ld4(hproj + b * 3 * H + g * H + j);
      }
      hprev[hr] = ld4(prev + brow[hr] * H + j);
      dyv[hr] = ld4(dy + b * H + j);
    }
  };
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float4 v = dhT != nullptr ? ld4(dhT + brow[hr] * H + j)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dhz[hr][0] = v.x, dhz[hr][1] = v.y, dhz[hr][2] = v.z, dhz[hr][3] = v.w;
  }
  fetch(T - 1);

  float dr_pre[2][4], dz_pre[2][4], dn_pre[2][4], dnr[2][4];
  // dhb, dxp and dhproj of step t, which no CTA reads during the sweep
  auto write_outputs = [&](int t) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (!live[hr]) continue;
      const size_t at = ((size_t)t * B + brow[hr]) * 3 * H + j;
      st4(dhb + at, dr_pre[hr]);
      st4(dhb + at + H, dz_pre[hr]);
      st4(dhb + at + 2 * H, dnr[hr]);
      st4(dxp + at, dr_pre[hr]);
      st4(dxp + at + H, dz_pre[hr]);
      st4(dxp + at + 2 * H, dn_pre[hr]);
      st4(dhproj + at, dr_pre[hr]);
      st4(dhproj + at + H, dz_pre[hr]);
      st4(dhproj + at + 2 * H, dnr[hr]);
    }
  };

  for (int t = T - 1; t >= -1; --t) {
    if (t < T - 1) {
      {
        float acc[P::N / 2];
        slice_product<P::N>(tl, asm_, wsm, bars, (T - t) & 1, acc);
        store_partials<P>(partial, acc);
      }
      cluster_sync();
      float4 part[C][2];
#pragma unroll
      for (int q = 0; q < C; ++q)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
        {
          const float* const mine =
              partial + rank * P::P_BLOCK + me.row(hr) * P::P_LD + me.col();
          part[q][hr] = q == rank ? ld4(mine) : ld_cluster4(smem_addr(mine), q);
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int q = 0; q < C; ++q) add4(dhz[hr], part[q][hr]);
    }
    // dhz now holds dh, the carry into step t
    if (t < 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (live[hr]) st4(dh0 + brow[hr] * H + j, dhz[hr]);
      break;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float xr[4] = {xp[hr][0].x, xp[hr][0].y, xp[hr][0].z, xp[hr][0].w};
      const float xz[4] = {xp[hr][1].x, xp[hr][1].y, xp[hr][1].z, xp[hr][1].w};
      const float xn[4] = {xp[hr][2].x, xp[hr][2].y, xp[hr][2].z, xp[hr][2].w};
      const float pr[4] = {hp[hr][0].x, hp[hr][0].y, hp[hr][0].z, hp[hr][0].w};
      const float pz[4] = {hp[hr][1].x, hp[hr][1].y, hp[hr][1].z, hp[hr][1].w};
      const float hn[4] = {hp[hr][2].x, hp[hr][2].y, hp[hr][2].z, hp[hr][2].w};
      const float hv[4] = {hprev[hr].x, hprev[hr].y, hprev[hr].z, hprev[hr].w};
      const float dv[4] = {dyv[hr].x, dyv[hr].y, dyv[hr].z, dyv[hr].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = sigmoid_fast(xr[e] + pr[e]);
        const float z = sigmoid_fast(xz[e] + pz[e]);
        const float n = tanh_fast(xn[e] + r * hn[e]);
        const float dh_total = dv[e] + dhz[hr][e];
        dn_pre[hr][e] = dh_total * (1.0f - z) * (1.0f - n * n);
        dz_pre[hr][e] = dh_total * (hv[e] - n) * z * (1.0f - z);
        dr_pre[hr][e] = dn_pre[hr][e] * hn[e] * r * (1.0f - r);
        dnr[hr][e] = dn_pre[hr][e] * r;
        dhz[hr][e] = dh_total * z;
      }
      if (live[hr]) {
        bf16* const gb = tile + t * step;
        st4(gb + tl.offset(me.row(hr), j), dr_pre[hr]);
        st4(gb + tl.offset(me.row(hr), H + j), dz_pre[hr]);
        st4(gb + tl.offset(me.row(hr), 2 * H + j), dnr[hr]);
      }
    }
    // the TMA's next writes land where the partial sums were read
    fence_proxy_async();
    grid_arrive(counter);
    write_outputs(t);
    if (t >= 1) fetch(t - 1);
    grid_wait(counter, nblocks * (T - t), [&] {
      request_slice(tile + t * step + (size_t)rank * ROWS * kslice, tl,
                    asm_, bars);
    });
  }
  cluster_sync();   // no CTA leaves while another may read its partial sums
}

// ---------------------------------------------------------------------------
// Persistent version (float32 products): split TF32, one launch per sweep
// ---------------------------------------------------------------------------

constexpr int kF32Round = 8;              // k8 steps split and issued at once
constexpr int kF32Ahead = 2 * kF32Round;  // k8 steps of A in flight

// A cluster of 2 CTAs per TN columns of the state and 128-row tile of the
// batch; N the width of the cluster's product (3 TN forward, TN backward).
// Shared memory of a CTA: its K-slice of the cluster's N columns of W_hh,
// the hi part then the lo part (K-major, no swizzle: 8 operand rows x 4
// floats form a 128-byte core matrix, neighbours along K kCoreBytes apart),
// then the partial sums of all 128 rows [row][N + 4].
template <int N_>
struct F32Plan {
  static constexpr int C = 2;
  static constexpr int ROWS = 128;
  static constexpr int THREADS = 256;    // two warpgroups, 64 rows each
  static constexpr int N = N_;
  static constexpr int P_LD = N + 4;
  __host__ __device__ static size_t w_bytes(int K) {
    return 2 * (size_t)N * (K / C) * sizeof(float);
  }
  __host__ __device__ static size_t bytes(int K) {
    return w_bytes(K) + (size_t)ROWS * P_LD * sizeof(float);
  }
  static dim3 grid(int B, int H) {
    return dim3(C * H / TN, (B + ROWS - 1) / ROWS);
  }
};
using FwdPlanF32 = F32Plan<3 * TN>;
using BwdPlanF32 = F32Plan<TN>;

// Where (row, col) of one row tile's 128 x K float32 left operand lies in
// its slab: [16-row strip][k8 block][lane][4], the 16-byte word of lane
// (row % 8) * 4 + col % 4 holding rows row % 8 + {0, 8} x cols col % 4 +
// {0, 4} of the 16 x 8 block in the order of wgmma's A fragment a0..a3.
__device__ __forceinline__ size_t frag_offset(int row, int col, int K) {
  return ((size_t)(row >> 4) * (K >> 3) + (col >> 3)) * 128 +
         ((row & 7) * 4 + (col & 3)) * 4 + ((row >> 3) & 1) +
         2 * ((col >> 2) & 1);
}

// x rounded to TF32 (to nearest, ties away from zero): a float32 bit
// pattern whose 13 low mantissa bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (2^-22 of x at most); x - hi is exact in float32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (64 x 48, f32) = or += a (64 x 8, tf32, registers) * b^T (b: 48 x 8,
// K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[24],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 16, f32) = or += a (64 x 8, tf32, registers) * b^T (b: 16 x 8)
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// One round of f32_slice_product: the A fragments of k8 steps s0 ..
// s0 + kF32Round - 1 (in raw[HALF * kF32Round ..]) split, their slots
// refilled kF32Ahead steps on (the slice's last block again past its end:
// no branch), then 3 wgmmas a step. The round waits for its wgmmas: their A
// registers are rewritten by the next round.
template <int N, int HALF>
__device__ __forceinline__ void f32_round(float4 (&raw)[kF32Ahead],
                                          const float4* a4, int s0,
                                          int steps, uint32_t w_hi,
                                          uint32_t w_lo, uint32_t sbo,
                                          float (&acc)[N / 2]) {
  uint32_t hi[kF32Round][4], lo[kF32Round][4];
#pragma unroll
  for (int i = 0; i < kF32Round; ++i) {
    float4& v = raw[HALF * kF32Round + i];
    split_tf32(v.x, hi[i][0], lo[i][0]);
    split_tf32(v.y, hi[i][1], lo[i][1]);
    split_tf32(v.z, hi[i][2], lo[i][2]);
    split_tf32(v.w, hi[i][3], lo[i][3]);
    v = __ldcg(a4 + (size_t)min(s0 + kF32Ahead + i, steps - 1) * 32);
  }
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kF32Round; ++i) {
    const uint32_t k = (uint32_t)(s0 + i) * 2 * kCoreBytes;   // 8 floats
    wgmma_tf32(acc, hi[i], wgmma_desc(w_hi + k, kCoreBytes, sbo),
               s0 + i != 0);
    wgmma_tf32(acc, hi[i], wgmma_desc(w_lo + k, kCoreBytes, sbo), 1);
    wgmma_tf32(acc, lo[i], wgmma_desc(w_hi + k, kCoreBytes, sbo), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
}

// acc (64 x N, f32, in wgmma's register layout; the warpgroup's 64 of the
// tile's rows) = a * w^T over this CTA's K-slice of `steps` k8 steps (a
// multiple of kF32Round). a4 is this thread's 16-byte word of the slice's
// first k8 block of its warp's 16 rows in the slab (the next block 512
// bytes on); w_hi, w_lo the resident weight (N x kslice, 8-row groups
// `sbo` apart).
template <int N>
__device__ __forceinline__ void f32_slice_product(const float4* a4,
                                                  int steps, uint32_t w_hi,
                                                  uint32_t w_lo, uint32_t sbo,
                                                  float (&acc)[N / 2]) {
  float4 raw[kF32Ahead];
#pragma unroll
  for (int i = 0; i < kF32Ahead; ++i)
    raw[i] = __ldcg(a4 + (size_t)min(i, steps - 1) * 32);
  for (int s0 = 0; s0 < steps; s0 += kF32Ahead) {
    f32_round<N, 0>(raw, a4, s0, steps, w_hi, w_lo, sbo, acc);
    if (s0 + kF32Round < steps)
      f32_round<N, 1>(raw, a4, s0 + kF32Round, steps, w_hi, w_lo, sbo, acc);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// the warpgroups' partial sums, as wgmma left them, into the CTA's
// [row][P_LD] buffer
template <class P>
__device__ __forceinline__ void store_partials_f32(
    float* partial, const float (&acc)[P::N / 2]) {
  const AccThread at;
#pragma unroll
  for (int i = 0; i < P::N / 8; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      st2(partial + at.row(hr) * P::P_LD + 8 * i + at.col(),
          acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
}

// What a thread owns of the cluster's (128 rows x TN columns) tile after
// the partial sums are added: row row() of the tile, columns 4 q .. 4 q + 3
// of the cluster's TN; CTA `rank` takes the rows 64 rank .. 64 rank + 63.
struct F32Thread {
  int r, q;
  __device__ F32Thread(unsigned rank)
      : r((int)rank * 64 + (threadIdx.x >> 2)), q(threadIdx.x & 3) {}
  __device__ int col() const { return 4 * q; }
};

// The forward sweep of one layer, float32. w is W_hh split, (2, 3H, H)
// float32: hi then lo, column j of gate g a row g * H + j of each. slabs
// holds two steps of the left operand, each (row tiles x 128 x H) in
// frag_offset's order: step t reads slab t % 2 and writes slab (t + 1) %
// 2, so no slab is read and written in one step. The CTA of rank q holds the
// K-slice q of the cluster's 3 TN columns (operand row g * TN + jj is
// column j0 + jj of gate g) and computes it for all 128 rows; its own tile
// of h stays in registers as float32. Only the slab is written before the
// barrier's arrival; ys and hproj are written and x_proj[t + 1] is fetched
// between the arrival and the wait.
__global__ void __launch_bounds__(FwdPlanF32::THREADS, 1)
    gru_fwd_persistent_f32(const float* __restrict__ x_proj,
                           const float* __restrict__ w,
                           const float* __restrict__ b_hh,
                           const float* __restrict__ h0,
                           float* __restrict__ ys, float* __restrict__ hproj,
                           float* slabs, unsigned* counter, int T, int B,
                           int H) {
  using P = FwdPlanF32;
  constexpr int N = P::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kslice = H / P::C;
  const int steps = kslice / 8;
  const uint32_t w_hi = smem_addr(smem);
  const uint32_t w_lo = w_hi + (uint32_t)(P::w_bytes(H) / 2);
  float* const partial = reinterpret_cast<float*>(smem + P::w_bytes(H));
  const uint32_t sbo = (kslice / 4) * kCoreBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned rank = cluster_rank();
  const F32Thread me(rank);
  const int j0 = (blockIdx.x >> 1) * TN;     // the cluster's first column
  const int row0 = blockIdx.y * P::ROWS;
  const unsigned nblocks = gridDim.x * gridDim.y;
  const size_t slab = (size_t)gridDim.y * P::ROWS * H;
  float* const tile = slabs + (size_t)blockIdx.y * P::ROWS * H;
  const float4* const a4 =
      reinterpret_cast<const float4*>(
          tile + ((size_t)warp * (H / 8) + rank * steps) * 128) + lane;

  // 8 operand rows x 4 k-groups a warp: each 16 bytes of the weight as
  // stored, K contiguous
  for (int u = warp; u < (N / 8) * (kslice / 16); u += P::THREADS / 32) {
    const int n8 = u % (N / 8);
    const int kg = (u / (N / 8)) * 4 + (lane >> 3);
    const int n = n8 * 8 + (lane & 7);
    const float* const src =
        w + ((size_t)(n / TN) * H + j0 + n % TN) * H + rank * kslice + kg * 4;
    const uint32_t dst = n8 * sbo + kg * kCoreBytes + (lane & 7) * 16;
    cp_async_16(w_hi + dst, src);
    cp_async_16(w_lo + dst, src + (size_t)3 * H * H);
  }
  cp_async_commit();

  // rows past the batch compute on row 0's inputs and store nothing
  const int j = j0 + me.col();
  const bool live = row0 + me.r < B;
  const size_t brow = row0 + (live ? me.r : 0);
  float h[4];
  float4 bias[3], xp[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) bias[g] = ld4(b_hh + g * H + j);
  auto fetch_xp = [&](int t) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
      xp[g] = ld4(x_proj + ((size_t)t * B + brow) * 3 * H + g * H + j);
  };
  auto put_h = [&](int t) {       // this thread's h into slab t % 2
    if (!live) return;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(t & 1) * slab + frag_offset(me.r, j + e, H)] = h[e];
  };
  {
    const float4 v = ld4(h0 + brow * H + j);
    h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
  }
  put_h(0);
  cp_async_wait_all();
  fence_proxy_async();
  grid_arrive(counter);
  fetch_xp(0);
  grid_wait(counter, nblocks, [] {});

  float hp[3][4];
  auto write_outputs = [&](int t) {   // ys and hproj, read by no CTA
    if (!live) return;
    const size_t b = (size_t)t * B + brow;
    st4(ys + b * H + j, h);
    if (hproj != nullptr) {
#pragma unroll
      for (int g = 0; g < 3; ++g) st4(hproj + b * 3 * H + g * H + j, hp[g]);
    }
  };

  for (int t = 0; t < T; ++t) {
    {
      float acc[N / 2];
      f32_slice_product<N>(a4 + (t & 1) * (slab / 4), steps, w_hi, w_lo,
                           sbo, acc);
      store_partials_f32<P>(partial, acc);
    }
    cluster_sync();
    float4 part[P::C][3];
#pragma unroll
    for (int q = 0; q < P::C; ++q)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float* const mine =
            partial + me.r * P::P_LD + g * TN + me.col();
        part[q][g] = q == (int)rank ? ld4(mine)
                                    : ld_cluster4(smem_addr(mine), q);
      }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      hp[g][0] = bias[g].x, hp[g][1] = bias[g].y;
      hp[g][2] = bias[g].z, hp[g][3] = bias[g].w;
#pragma unroll
      for (int q = 0; q < P::C; ++q) add4(hp[g], part[q][g]);
    }
    const float xr[4] = {xp[0].x, xp[0].y, xp[0].z, xp[0].w};
    const float xz[4] = {xp[1].x, xp[1].y, xp[1].z, xp[1].w};
    const float xn[4] = {xp[2].x, xp[2].y, xp[2].z, xp[2].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = sigmoid_f32(xr[e] + hp[0][e]);
      const float z = sigmoid_f32(xz[e] + hp[1][e]);
      const float n = tanhf(xn[e] + r * hp[2][e]);
      h[e] = (1.0f - z) * n + z * h[e];
    }
    if (t + 1 == T) {
      write_outputs(t);
      break;
    }
    put_h(t + 1);
    grid_arrive(counter);
    write_outputs(t);
    fetch_xp(t + 1);
    grid_wait(counter, nblocks * (t + 2), [] {});
  }
  cluster_sync();   // no CTA leaves while another may read its partial sums
}

// The reverse sweep of one layer, float32, T + 1 steps (t = T - 1 .. -1)
// as in the bf16 version: step t adds the product of step t + 1
// (dhproj[t + 1] times the columns of W_hh) to the carried dh_total * z,
// which stays in registers, then does the elementwise part of step t and
// puts dhproj[t] into slab t % 2 (each (row tiles x 128 x 3H) in
// frag_offset's order). The operand of the CTA of rank q is the cluster's
// TN columns of the K-slice q of W_hh's rows (w split as in the forward),
// transposed on the way into shared memory, once. dhT, if given, starts the
// carry. Only the slab is written before the barrier's arrival; dxp and
// dhproj are written and the saved tensors of step t - 1 are fetched
// between the arrival and the wait.
__global__ void __launch_bounds__(BwdPlanF32::THREADS, 1)
    gru_bwd_persistent_f32(const float* __restrict__ x_proj,
                           const float* __restrict__ hproj,
                           const float* __restrict__ h0,
                           const float* __restrict__ ys,
                           const float* __restrict__ dy,
                           const float* __restrict__ dhT,
                           const float* __restrict__ w,
                           float* __restrict__ dxp,
                           float* __restrict__ dhproj, float* slabs,
                           float* __restrict__ dh0, unsigned* counter, int T,
                           int B, int H) {
  using P = BwdPlanF32;
  constexpr int N = P::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = 3 * H;
  const int kslice = K / P::C;
  const int steps = kslice / 8;
  const uint32_t w_hi = smem_addr(smem);
  const uint32_t w_lo = w_hi + (uint32_t)(P::w_bytes(K) / 2);
  float* const partial = reinterpret_cast<float*>(smem + P::w_bytes(K));
  const uint32_t sbo = (kslice / 4) * kCoreBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned rank = cluster_rank();
  const F32Thread me(rank);
  const int j0 = (blockIdx.x >> 1) * TN;
  const int row0 = blockIdx.y * P::ROWS;
  const unsigned nblocks = gridDim.x * gridDim.y;
  const size_t bh = (size_t)B * H;
  const size_t slab = (size_t)gridDim.y * P::ROWS * K;
  float* const tile = slabs + (size_t)blockIdx.y * P::ROWS * K;
  const float4* const a4 =
      reinterpret_cast<const float4*>(
          tile + ((size_t)warp * (K / 8) + rank * steps) * 128) + lane;

  // operand row n (< TN), depth k: w[rank * kslice + k][j0 + n]. A thread
  // moves 4 depths x 4 columns, transposed, of the hi and of the lo part.
  for (int u = threadIdx.x; u < (N / 4) * (kslice / 4); u += P::THREADS) {
    const int n4 = u % (N / 4);
    const int k4 = u / (N / 4);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const float* const src = w + (size_t)part * K * H +
                               (size_t)(rank * kslice + 4 * k4) * H + j0 +
                               4 * n4;
      float in[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ld4(src + (size_t)i * H);
        in[i][0] = v.x, in[i][1] = v.y, in[i][2] = v.z, in[i][3] = v.w;
      }
      unsigned char* const base = smem + part * (P::w_bytes(K) / 2);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = 4 * n4 + m;
        *reinterpret_cast<float4*>(base + (size_t)(n / 8) * sbo +
                                   (size_t)k4 * kCoreBytes + (n % 8) * 16) =
            make_float4(in[0][m], in[1][m], in[2][m], in[3][m]);
      }
    }
  }
  fence_proxy_async();   // the first barrier's __syncthreads completes this

  // rows past the batch compute on row 0's inputs and store nothing
  const int j = j0 + me.col();
  const bool live = row0 + me.r < B;
  const size_t brow = row0 + (live ? me.r : 0);
  float dhz[4];
  float4 xp[3], hp[3], hprev, dyv;
  auto fetch = [&](int t) {
    const float* const prev = t == 0 ? h0 : ys + (t - 1) * bh;
    const size_t b = (size_t)t * B + brow;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      xp[g] = ld4(x_proj + b * 3 * H + g * H + j);
      hp[g] = ld4(hproj + b * 3 * H + g * H + j);
    }
    hprev = ld4(prev + brow * H + j);
    dyv = ld4(dy + b * H + j);
  };
  {
    const float4 v = dhT != nullptr ? ld4(dhT + brow * H + j)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dhz[0] = v.x, dhz[1] = v.y, dhz[2] = v.z, dhz[3] = v.w;
  }
  fetch(T - 1);

  float dr_pre[4], dz_pre[4], dn_pre[4], dnr[4];
  auto write_outputs = [&](int t) {   // dxp and dhproj, read by no CTA
    if (!live) return;
    const size_t at = ((size_t)t * B + brow) * 3 * H + j;
    st4(dxp + at, dr_pre);
    st4(dxp + at + H, dz_pre);
    st4(dxp + at + 2 * H, dn_pre);
    st4(dhproj + at, dr_pre);
    st4(dhproj + at + H, dz_pre);
    st4(dhproj + at + 2 * H, dnr);
  };

  for (int t = T - 1; t >= -1; --t) {
    if (t < T - 1) {
      {
        float acc[N / 2];
        f32_slice_product<N>(a4 + ((t + 1) & 1) * (slab / 4), steps, w_hi,
                             w_lo, sbo, acc);
        store_partials_f32<P>(partial, acc);
      }
      cluster_sync();
      float4 part[P::C];
#pragma unroll
      for (int q = 0; q < P::C; ++q) {
        const float* const mine = partial + me.r * P::P_LD + me.col();
        part[q] = q == (int)rank ? ld4(mine) : ld_cluster4(smem_addr(mine), q);
      }
#pragma unroll
      for (int q = 0; q < P::C; ++q) add4(dhz, part[q]);
    }
    // dhz now holds dh, the carry into step t
    if (t < 0) {
      if (live) st4(dh0 + brow * H + j, dhz);
      break;
    }
    const float xr[4] = {xp[0].x, xp[0].y, xp[0].z, xp[0].w};
    const float xz[4] = {xp[1].x, xp[1].y, xp[1].z, xp[1].w};
    const float xn[4] = {xp[2].x, xp[2].y, xp[2].z, xp[2].w};
    const float pr[4] = {hp[0].x, hp[0].y, hp[0].z, hp[0].w};
    const float pz[4] = {hp[1].x, hp[1].y, hp[1].z, hp[1].w};
    const float hn[4] = {hp[2].x, hp[2].y, hp[2].z, hp[2].w};
    const float hv[4] = {hprev.x, hprev.y, hprev.z, hprev.w};
    const float dv[4] = {dyv.x, dyv.y, dyv.z, dyv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = sigmoid_f32(xr[e] + pr[e]);
      const float z = sigmoid_f32(xz[e] + pz[e]);
      const float n = tanhf(xn[e] + r * hn[e]);
      const float dh_total = dv[e] + dhz[e];
      dn_pre[e] = dh_total * (1.0f - z) * (1.0f - n * n);
      dz_pre[e] = dh_total * (hv[e] - n) * z * (1.0f - z);
      dr_pre[e] = dn_pre[e] * hn[e] * r * (1.0f - r);
      dnr[e] = dn_pre[e] * r;
      dhz[e] = dh_total * z;
    }
    if (live) {
      float* const s = tile + (t & 1) * slab;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[frag_offset(me.r, j + e, K)] = dr_pre[e];
        s[frag_offset(me.r, H + j + e, K)] = dz_pre[e];
        s[frag_offset(me.r, 2 * H + j + e, K)] = dnr[e];
      }
    }
    grid_arrive(counter);
    write_outputs(t);
    if (t >= 1) fetch(t - 1);
    grid_wait(counter, nblocks * (T - t), [] {});
  }
  cluster_sync();   // no CTA leaves while another may read its partial sums
}

// `steps` grid barriers and nothing else: what a sweep of that many steps
// costs before it loads, multiplies or stores anything.
__global__ void __launch_bounds__(FwdPlan::THREADS, 1)
    gru_empty_sweep(unsigned* counter, int steps) {
  const unsigned nblocks = gridDim.x * gridDim.y;
  for (int s = 0; s < steps; ++s) {
    grid_arrive(counter);
    grid_wait(counter, nblocks * (s + 1), [] {});
  }
}

bool bad_persistent_shape(int T, int B, int H) {
  return T < 1 || B < 1 || H < 128 || H % 128 != 0;
}

struct PersistentLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attrs[2];
  // Clusters of `cluster` CTAs along x, launched cooperatively: the runtime
  // refuses a grid that cannot be resident all at once, so a barrier never
  // waits for a CTA that has not started.
  PersistentLaunch(dim3 grid, int threads, int cluster, size_t smem,
                   cudaStream_t stream) {
    config = cudaLaunchConfig_t{};
    config.gridDim = grid;
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    config.attrs = attrs;
    config.numAttrs = 2;
  }
};

// zero the barrier's counter, then launch
template <class P>
cudaError_t launch_persistent(const void* kernel, void** args,
                              unsigned* counter, int B, int H, int K,
                              cudaStream_t stream) {
  const size_t smem = P::bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  PersistentLaunch launch(P::grid(B, H), P::THREADS, P::C, smem, stream);
  return cudaLaunchKernelExC(&launch.config, kernel, args);
}

// CTAs of `kernel` that the device holds at once, in whole clusters; minus
// the cudaError_t on failure
template <class P>
int resident_ctas(const void* kernel, int H, int K) {
  const size_t smem = P::bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  // the occupancy depends on the cluster's shape and the CTA's resources,
  // not on the grid: ask with one cluster's worth of batch rows
  PersistentLaunch launch(P::grid(P::ROWS, H), P::THREADS, P::C, smem,
                          nullptr);
  launch.config.numAttrs = 1;            // the cluster's shape only
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.config);
  if (err != cudaSuccess) return -(int)err;
  return clusters * P::C;
}

}  // namespace

extern "C" {

// The per-step sweeps. dtype: 0 = float32 weight (FMA), 1 = bfloat16
// weight (tensor cores). All
// other tensors are float32 and contiguous: x_proj (T, B, 3H), w_hh_t
// (H, 3H) in `dtype`, b_hh (3H), h0 (B, H), ys (T, B, H), hproj (T, B, 3H)
// or null. With dtype 1, scratch_b is two (B, H) bf16 buffers of which the
// first holds h0; with dtype 0 it is not read. H must be a multiple of 32
// (float32) or 128 (bfloat16). Enqueues T launches on `stream`; returns the
// cudaError_t (0 on success).
int gru_layer_fwd_launch(int dtype, const void* x_proj, const void* w_hh_t,
                         const void* b_hh, const void* h0, void* ys,
                         void* hproj, void* scratch_b, int T, int B, int H,
                         void* stream) {
  if (bad_shape(T, B, H, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x_proj);
  const float* b = static_cast<const float*>(b_hh);
  const float* h = static_cast<const float*>(h0);
  float* y = static_cast<float*>(ys);
  float* hp = static_cast<float*>(hproj);
  if (dtype == 0)
    return forward(xp, static_cast<const float*>(w_hh_t), b, h, y, hp, T, B,
                   H, s);
  if (dtype == 1 && scratch_b != nullptr)
    return forward_tc(xp, static_cast<const bf16*>(w_hh_t), b, h, y, hp,
                      static_cast<bf16*>(scratch_b), T, B, H, s);
  return cudaErrorInvalidValue;
}

// The reverse sweep. In: x_proj, hproj (T, B, 3H), h0 (B, H), ys (T, B, H)
// (h_prev[t] is h0 for t = 0, else ys[t-1]), dy (T, B, H) with the final
// state's cotangent already folded into dy[T-1], w_hh (3H, H) in `dtype`.
// Out: dxp, dhproj (T, B, 3H), dh0 (B, H); dhz (B, H) is scratch, and with
// dtype 1 so is scratch_b, two (B, 3H) bf16 buffers. Enqueues T + 1
// launches on `stream`.
int gru_layer_bwd_launch(int dtype, const void* x_proj, const void* hproj,
                         const void* h0, const void* ys, const void* dy,
                         const void* w_hh, void* dxp, void* dhproj, void* dh0,
                         void* dhz, void* scratch_b, int T, int B, int H,
                         void* stream) {
  if (bad_shape(T, B, H, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x_proj);
  const float* hp = static_cast<const float*>(hproj);
  const float* h = static_cast<const float*>(h0);
  const float* y = static_cast<const float*>(ys);
  const float* g = static_cast<const float*>(dy);
  float* o_dxp = static_cast<float*>(dxp);
  float* o_dhp = static_cast<float*>(dhproj);
  float* o_dh0 = static_cast<float*>(dh0);
  float* scratch = static_cast<float*>(dhz);
  if (dtype == 0)
    return backward(xp, hp, h, y, g, static_cast<const float*>(w_hh), o_dxp,
                    o_dhp, o_dh0, scratch, T, B, H, s);
  if (dtype == 1 && scratch_b != nullptr)
    return backward_tc(xp, hp, h, y, g, static_cast<const bf16*>(w_hh), o_dxp,
                       o_dhp, o_dh0, scratch, static_cast<bf16*>(scratch_b),
                       T, B, H, s);
  return cudaErrorInvalidValue;
}

// The persistent sweeps with bfloat16 products: ONE cooperative launch
// each. w_hh is (3H, H) bf16 as stored, for both directions. hb (T + 1, B,
// H) and dhb (T, B, 3H) are bf16 outputs: h0 and ys, resp. dhproj, rounded
// to bf16 (the left operands of the weight-gradient product outside). hbt
// and dhbt are scratch for the same values in the kernels' own tiled
// order: (T + 1) steps x ceil(B / 64) row tiles x 64 x H resp. T steps x
// ceil(B / 128) row tiles x 128 x 3H bf16. counter is one 32-bit word of
// scratch. hproj may be null (no residual),
// and so may dhT (no cotangent of the final state; else it is added to
// dy[T-1]'s). H must be a multiple of 128 and the grid must be resident at
// once (gru_layer_persistent_capacity): forward (H / 16) x ceil(B / 64)
// CTAs in clusters of 2, backward (H / 16) x ceil(B / 128) in clusters of
// 8, with gru_layer_persistent_smem bytes each. The launch fails otherwise.
int gru_layer_fwd_persistent_launch(const void* x_proj, const void* w_hh,
                                    const void* b_hh, const void* h0,
                                    void* ys, void* hproj, void* hb,
                                    void* hbt, void* counter, int T, int B,
                                    int H, void* stream) {
  if (bad_persistent_shape(T, B, H)) return cudaErrorInvalidValue;
  void* args[] = {&x_proj, &w_hh, &b_hh,    &h0, &ys, &hproj,
                  &hb,     &hbt,  &counter, &T,  &B,  &H};
  return launch_persistent<FwdPlan>(
      reinterpret_cast<const void*>(gru_fwd_persistent), args,
      static_cast<unsigned*>(counter), B, H, H,
      static_cast<cudaStream_t>(stream));
}

int gru_layer_bwd_persistent_launch(const void* x_proj, const void* hproj,
                                    const void* h0, const void* ys,
                                    const void* dy, const void* dhT,
                                    const void* w_hh, void* dxp, void* dhproj,
                                    void* dhb, void* dhbt, void* dh0,
                                    void* counter, int T, int B, int H,
                                    void* stream) {
  if (bad_persistent_shape(T, B, H)) return cudaErrorInvalidValue;
  void* args[] = {&x_proj, &hproj, &h0,   &ys,  &dy,      &dhT, &w_hh, &dxp,
                  &dhproj, &dhb,   &dhbt, &dh0, &counter, &T,   &B,    &H};
  return launch_persistent<BwdPlan>(
      reinterpret_cast<const void*>(gru_bwd_persistent), args,
      static_cast<unsigned*>(counter), B, H, 3 * H,
      static_cast<cudaStream_t>(stream));
}

// The persistent sweeps with float32 products (split TF32 on the tensor
// cores): ONE cooperative launch each. w_split is W_hh split by the
// caller, (2, 3H, H) float32: [0] = tf32(W_hh) (round to nearest, ties away
// from zero), [1] = tf32(W_hh - [0]); both directions read it as stored.
// slabs is scratch for two steps of the left operand in the kernels' own
// order: 2 x ceil(B / 128) row tiles x 128 x H (forward) resp. 3H
// (backward) float32. counter is one 32-bit word of scratch. hproj may be
// null (no residual), and so may dhT. Other tensors as for the bf16
// persistent sweeps, all float32. H must be a multiple of 128 and the grid
// resident at once: (H / 8) x ceil(B / 128) CTAs in clusters of 2 in both
// directions, with gru_layer_persistent_smem(H, backward, 0) bytes each.
int gru_layer_fwd_persistent_f32_launch(const void* x_proj,
                                        const void* w_split,
                                        const void* b_hh, const void* h0,
                                        void* ys, void* hproj, void* slabs,
                                        void* counter, int T, int B, int H,
                                        void* stream) {
  if (bad_persistent_shape(T, B, H)) return cudaErrorInvalidValue;
  void* args[] = {&x_proj, &w_split, &b_hh,    &h0, &ys, &hproj,
                  &slabs,  &counter, &T,       &B,  &H};
  return launch_persistent<FwdPlanF32>(
      reinterpret_cast<const void*>(gru_fwd_persistent_f32), args,
      static_cast<unsigned*>(counter), B, H, H,
      static_cast<cudaStream_t>(stream));
}

int gru_layer_bwd_persistent_f32_launch(
    const void* x_proj, const void* hproj, const void* h0, const void* ys,
    const void* dy, const void* dhT, const void* w_split, void* dxp,
    void* dhproj, void* slabs, void* dh0, void* counter, int T, int B, int H,
    void* stream) {
  if (bad_persistent_shape(T, B, H)) return cudaErrorInvalidValue;
  void* args[] = {&x_proj, &hproj, &h0,  &ys,      &dy, &dhT, &w_split,
                  &dxp,    &dhproj, &slabs, &dh0, &counter, &T, &B, &H};
  return launch_persistent<BwdPlanF32>(
      reinterpret_cast<const void*>(gru_bwd_persistent_f32), args,
      static_cast<unsigned*>(counter), B, H, 3 * H,
      static_cast<cudaStream_t>(stream));
}

// `steps` grid barriers on the persistent sweeps' grid for (B, H), with
// their shared memory, and no other work.
int gru_layer_empty_sweep_launch(void* counter, int steps, int B, int H,
                                 void* stream) {
  if (bad_persistent_shape(steps, B, H)) return cudaErrorInvalidValue;
  void* args[] = {&counter, &steps};
  return launch_persistent<FwdPlan>(
      reinterpret_cast<const void*>(gru_empty_sweep), args,
      static_cast<unsigned*>(counter), B, H, H,
      static_cast<cudaStream_t>(stream));
}

// the shared memory a CTA of the persistent forward (backward != 0: the
// backward) sweep asks for, with products in dtype (0 = float32, 1 =
// bfloat16)
int gru_layer_persistent_smem(int H, int backward, int dtype) {
  if (dtype == 0)
    return (int)(backward ? BwdPlanF32::bytes(3 * H) : FwdPlanF32::bytes(H));
  return (int)(backward ? BwdPlan::bytes(3 * H) : FwdPlan::bytes(H));
}

// The most dynamic shared memory a CTA of the current device may ask for.
int gru_layer_smem_limit(int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// How many CTAs of the persistent forward (backward != 0: backward) sweep
// with products in dtype (as above) the current device holds at once at
// width H, in whole clusters, from the occupancy API: what the choice
// between the persistent and the per-step sweeps is made from. Negative:
// minus the cudaError_t.
int gru_layer_persistent_capacity(int H, int backward, int dtype) {
  if (bad_persistent_shape(1, 1, H)) return -(int)cudaErrorInvalidValue;
  if (dtype == 0)
    return backward ? resident_ctas<BwdPlanF32>(
                          reinterpret_cast<const void*>(
                              gru_bwd_persistent_f32), H, 3 * H)
                    : resident_ctas<FwdPlanF32>(
                          reinterpret_cast<const void*>(
                              gru_fwd_persistent_f32), H, H);
  return backward
             ? resident_ctas<BwdPlan>(
                   reinterpret_cast<const void*>(gru_bwd_persistent), H, 3 * H)
             : resident_ctas<FwdPlan>(
                   reinterpret_cast<const void*>(gru_fwd_persistent), H, H);
}

const char* gru_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
