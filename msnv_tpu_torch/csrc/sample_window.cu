// Sample-window kernel: the bottom tier's fs0 sequential samples for a tile
// of lanes, in one launch.
//
// Replaces the JAX package's pallas/sample_kernel.py `_window_kernel` (v1,
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
// holds exactly the fs0 new samples. W is float or bf16 (template). The
// temperature is folded into W_o / b_o by the caller.
//
// Noise: either given as (B, fs0, q) f32 Gumbel noise (the v1 mode and
// the CPU reference's mode), or drawn here from Philox-4x32-10 keyed on a
// 64-bit seed read from device memory, with counter (class/4, k, lane, 0)
// — so a draw depends on (seed, lane, step, class) only, never on the
// tiling. u = ((bits >> 8) + 0.5) / 2^24 as in the TPU kernel's draw.
//
// What bounds it on the H100: per sample, every lane needs the full W_h
// (dim x dim) and W_o (dim x q) — 2.5 MB in bf16 at dim 1024, q 256 — and
// only fs0 table rows. At small batch the work is a matrix-vector product:
// the weight stream from L2 (13 MB of weights fit the 50 MB L2) into one
// SM bounds it, far above the HBM bound of reading the weights once. At
// large batch it is operation-bound (2 * (dim^2 + dim*q) per lane-sample).
//
// Design of this first version (right and simple): one CTA of 256 threads
// per tile of TILE lanes (1..8). The window, x, h and logits rows stay in
// shared memory for all fs0 steps; weights are read from global memory
// (L2-resident) with 16-byte loads, each weight reused across the TILE
// lanes of the CTA. Lanes are independent, so the sequential dependence
// between samples needs only __syncthreads inside the CTA. Sums over a
// column are split over `groups` thread groups and reduced in a fixed
// order (no atomics: results do not vary from run to run). Tensor cores,
// TMA and a split of the weights over a cluster are left to later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // columns per 16-byte (bf16) / 32-byte (f32) load

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an activation to the weight type and back (the reference casts x
// and h to the weight dtype before each product)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// thread groups that split the reduction dimension of a product with n
// output columns (one group covers n / kVec column chunks)
__host__ __device__ __forceinline__ int reduce_groups(int n) {
  const int chunks = n / kVec;
  return chunks >= kThreads ? 1 : kThreads / chunks;
}

// out[l*n + j] = bias[j] + sum_i in[l*k + i] * w[i*n + j], l < TILE.
// in/out/red in shared memory, w (k, n) row-major in global memory.
template <int TILE, typename W>
__device__ void matvec(const float* in, int k, const W* __restrict__ w,
                       const float* __restrict__ bias, int n, float* red,
                       float* out) {
  const int chunks = n / kVec;
  const int groups = reduce_groups(n);
  for (int task = threadIdx.x; task < chunks * groups; task += blockDim.x) {
    const int c = task % chunks;
    const int g = task / chunks;
    float acc[TILE][kVec];
#pragma unroll
    for (int l = 0; l < TILE; ++l)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[l][e] = 0.f;
#pragma unroll 4
    for (int i = g; i < k; i += groups) {
      float wv[kVec];
      load8(w + (size_t)i * n + c * kVec, wv);
#pragma unroll
      for (int l = 0; l < TILE; ++l) {
        const float a = in[l * k + i];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[l][e] = fmaf(a, wv[e], acc[l][e]);
      }
    }
#pragma unroll
    for (int l = 0; l < TILE; ++l)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        red[(g * TILE + l) * n + c * kVec + e] = acc[l][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * n; idx += blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += red[g * TILE * n + idx];
    out[idx] = s + bias[idx % n];
  }
  __syncthreads();
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

template <int TILE, typename W>
__global__ void __launch_bounds__(kThreads)
    sample_window_kernel(const W* __restrict__ table,
                         const W* __restrict__ wh,
                         const float* __restrict__ bh,
                         const W* __restrict__ wo,
                         const float* __restrict__ bo,
                         const W* __restrict__ slots,
                         const int* __restrict__ buf,
                         const float* __restrict__ noise,
                         const int64_t* __restrict__ seed,
                         int* __restrict__ out, int batch, int fs0, int q,
                         int dim) {
  extern __shared__ float smem[];
  const int red_size = max(reduce_groups(dim) * TILE * dim,
                           reduce_groups(q) * TILE * q);
  float* xs = smem;                      // TILE x dim
  float* hs = xs + TILE * dim;           // TILE x dim
  float* logits = hs + TILE * dim;       // TILE x q
  float* red = logits + TILE * q;        // red_size
  int* win = reinterpret_cast<int*>(red + red_size);  // TILE x fs0
  int* drawn = win + TILE * fs0;                      // TILE

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * TILE;
  const int nl = min(TILE, batch - lane0);
  const W* wtag = nullptr;

  for (int i = tid; i < TILE * fs0; i += blockDim.x) {
    const int l = i / fs0;
    win[i] = l < nl ? buf[(size_t)(lane0 + l) * fs0 + i % fs0] : 0;
  }
  uint2 key = make_uint2(0u, 0u);
  if (noise == nullptr) {
    const uint64_t s = (uint64_t)seed[0];
    key = make_uint2((uint32_t)s, (uint32_t)(s >> 32));
  }
  __syncthreads();

  for (int k = 0; k < fs0; ++k) {
    // x = relu(sum of fs0 gathered table rows + slot row)
    for (int idx = tid; idx < TILE * dim; idx += blockDim.x) {
      const int l = idx / dim;
      const int d = idx % dim;
      float x = 0.f;
      if (l < nl) {
        float acc = 0.f;
        for (int p = 0; p < fs0; ++p)
          acc += to_f32(table[((size_t)p * q + win[l * fs0 + p]) * dim + d]);
        x = acc + to_f32(slots[((size_t)(lane0 + l) * fs0 + k) * dim + d]);
      }
      xs[idx] = round_to(fmaxf(x, 0.f), wtag);
    }
    __syncthreads();
    matvec<TILE, W>(xs, dim, wh, bh, dim, red, hs);
    for (int idx = tid; idx < TILE * dim; idx += blockDim.x)
      hs[idx] = round_to(fmaxf(hs[idx], 0.f), wtag);
    __syncthreads();
    matvec<TILE, W>(hs, dim, wo, bo, q, red, logits);

    // Gumbel-max draw: one warp per lane
    const int warp = tid / 32;
    const int lane_id = tid % 32;
    for (int l = warp; l < nl; l += blockDim.x / 32) {
      const int gl = lane0 + l;
      float best = -INFINITY;
      int best_i = 0;
      for (int c0 = lane_id * 4; c0 < q; c0 += 128) {
        float g[4];
        if (noise != nullptr) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            g[e] = c0 + e < q
                       ? noise[((size_t)gl * fs0 + k) * q + c0 + e]
                       : 0.f;
        } else {
          const uint4 r = philox(
              make_uint4((uint32_t)(c0 / 4), (uint32_t)k, (uint32_t)gl, 0u),
              key);
          g[0] = gumbel(r.x);
          g[1] = gumbel(r.y);
          g[2] = gumbel(r.z);
          g[3] = gumbel(r.w);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + e;
          if (c < q) {
            const float v = logits[l * q + c] + g[e];
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
      if (lane_id == 0) drawn[l] = best_i;
    }
    __syncthreads();
    if (tid < nl) {
      int* row = win + tid * fs0;
      for (int p = 0; p + 1 < fs0; ++p) row[p] = row[p + 1];
      row[fs0 - 1] = drawn[tid];
    }
    __syncthreads();
  }

  for (int i = tid; i < nl * fs0; i += blockDim.x)
    out[(size_t)(lane0 + i / fs0) * fs0 + i % fs0] = win[i];
}

template <int TILE>
size_t smem_bytes(int fs0, int q, int dim) {
  const size_t red = (size_t)std::max(reduce_groups(dim) * TILE * dim,
                                      reduce_groups(q) * TILE * q);
  return (2 * (size_t)TILE * dim + (size_t)TILE * q + red) * sizeof(float) +
         ((size_t)TILE * fs0 + TILE) * sizeof(int);
}

template <int TILE, typename W>
cudaError_t launch(const void* table, const void* wh, const void* bh,
                   const void* wo, const void* bo, const void* slots,
                   const void* buf, const void* noise, const void* seed,
                   void* out, int batch, int fs0, int q, int dim,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<TILE>(fs0, q, dim);
  cudaError_t err = cudaFuncSetAttribute(
      sample_window_kernel<TILE, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (batch + TILE - 1) / TILE;
  sample_window_kernel<TILE, W><<<grid, kThreads, smem, stream>>>(
      static_cast<const W*>(table), static_cast<const W*>(wh),
      static_cast<const float*>(bh), static_cast<const W*>(wo),
      static_cast<const float*>(bo), static_cast<const W*>(slots),
      static_cast<const int*>(buf), static_cast<const float*>(noise),
      static_cast<const int64_t*>(seed), static_cast<int*>(out), batch, fs0,
      q, dim);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_tile(int tile, const void* table, const void* wh,
                        const void* bh, const void* wo, const void* bo,
                        const void* slots, const void* buf,
                        const void* noise, const void* seed, void* out,
                        int batch, int fs0, int q, int dim,
                        cudaStream_t stream) {
  switch (tile) {
    case 1:
      return launch<1, W>(table, wh, bh, wo, bo, slots, buf, noise, seed,
                          out, batch, fs0, q, dim, stream);
    case 2:
      return launch<2, W>(table, wh, bh, wo, bo, slots, buf, noise, seed,
                          out, batch, fs0, q, dim, stream);
    case 4:
      return launch<4, W>(table, wh, bh, wo, bo, slots, buf, noise, seed,
                          out, batch, fs0, q, dim, stream);
    case 8:
      return launch<8, W>(table, wh, bh, wo, bo, slots, buf, noise, seed,
                          out, batch, fs0, q, dim, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 weights/table/slots, 1 = bfloat16. tile: lanes per
// CTA (1, 2, 4 or 8). Exactly one of noise / seed is non-null. Returns the
// cudaError_t of the launch (0 on success).
int sample_window_launch(int dtype, int tile, const void* table,
                         const void* wh, const void* bh, const void* wo,
                         const void* bo, const void* slots, const void* buf,
                         const void* noise, const void* seed, void* out,
                         int batch, int fs0, int q, int dim, void* stream) {
  if ((noise == nullptr) == (seed == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tile<float>(tile, table, wh, bh, wo, bo, slots, buf, noise,
                              seed, out, batch, fs0, q, dim, s);
  if (dtype == 1)
    return launch_tile<__nv_bfloat16>(tile, table, wh, bh, wo, bo, slots,
                                      buf, noise, seed, out, batch, fs0, q,
                                      dim, s);
  return cudaErrorInvalidValue;
}

// dynamic shared memory one launch takes, for the wrapper's checks
long long sample_window_smem_bytes(int tile, int fs0, int q, int dim) {
  switch (tile) {
    case 1: return (long long)smem_bytes<1>(fs0, q, dim);
    case 2: return (long long)smem_bytes<2>(fs0, q, dim);
    case 4: return (long long)smem_bytes<4>(fs0, q, dim);
    case 8: return (long long)smem_bytes<8>(fs0, q, dim);
    default: return -1;
  }
}

const char* sample_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
