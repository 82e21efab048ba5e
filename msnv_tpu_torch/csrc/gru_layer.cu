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
// at B 128, H 1024 against 6 MB of bf16 weights (L2-resident across the
// steps) and 1.5-3 MB of streamed f32 activations, so neither the memory
// rate nor the arithmetic rate is near: at T = 13 / 52 the device-wide
// dependence between steps (every column of h' needs all of h) and the
// launch per step bound it. On the TPU the grid is sequential and h stays in
// VMEM beside the whole weight; here no SM holds the weight and a step
// cannot stay inside one CTA.
//
// Design of this first version (right and simple): ONE LAUNCH PER TIMESTEP,
// ordered by the stream, all enqueued by one C call. Forward: a grid over
// (16-column slices of H) x (64-row tiles of B); a CTA computes the three
// gate columns j, H+j, 2H+j of hproj for its rows, then the gate math, and
// writes ys[t] reading ys[t-1] (or h0): no buffer is read and written by one
// launch, so no grid barrier is needed. Backward: T + 1 launches; launch t
// fuses the product of step t+1 (dhproj[t+1] @ W_hh, restricted to the
// CTA's own columns) with the elementwise part of step t, which needs only
// those columns of dh; dh_total * z passes between launches in a (B, H)
// scratch each element of which is read and rewritten by the same thread.
// The product inside a launch, by the weight's type, both with sums in a
// fixed order (no atomics: results do not vary from run to run):
//  - float32: FMA, a register-tiled loop (4 x 4 outputs per thread) over
//    32-deep chunks staged in shared memory, the chunk split over thread
//    groups whose partial sums are added in order. Exact float32 products.
//  - bfloat16: tensor cores, warp-level mma (the wmma API, m16n16k16,
//    float32 accumulators) over chunks that a ring of cp.async stages keeps
//    in flight; the left operand comes from a bf16 copy of h (resp. of
//    dhproj) that the previous launch's epilogue wrote beside the float32
//    one, so the staging moves 2 bytes a value and converts nothing. The
//    chunk's depth is split over two warp groups, added in order.
// wgmma and TMA, a persistent cooperative kernel with the weights split over
// the SMs' shared memory, and a CUDA graph over the launches are left to
// later work.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

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

}  // namespace

extern "C" {

// dtype: 0 = float32 weight (FMA), 1 = bfloat16 weight (tensor cores). All
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

const char* gru_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
