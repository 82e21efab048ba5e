// Fused fo-pool of a QRNN layer (Bradbury et al., Quasi-Recurrent Neural
// Networks, ICLR 2017), forward and backward, for the training path.
//
// Replaces no TPU kernel: the JAX package runs this recurrence as a
// `lax.scan` of elementwise steps (msnv_tpu/ops/qrnn.py). Eagerly, in
// PyTorch, that loop costs three elementwise launches a step forward and
// more backward, for every layer of every tier; this source does a layer's
// whole sweep in one launch each way.
//
// From the gate pre-activations g (B, T, 3H), gate order [z, f, o] (the
// input projection W x + b, computed outside as one product), and the
// carried cell c0 (B, H), per step t:
//
//   z = tanh(g_z)   f = sigmoid(g_f)   o = sigmoid(g_o)
//   c_t = f c_{t-1} + (1 - f) z        h_t = o c_t
//
// The forward emits h (B, T, H) in g's type, every c_t (B, T, H) in float32
// for the backward, and c_T (B, H). The backward walks t from T-1 to 0 with
// the carried dc (from dc_T, or 0):
//
//   dc += dh_t o       do = dh_t c_t
//   df = dc (c_{t-1} - z)   dz = dc (1 - f)   dc = dc f
//   dg = [dz (1 - z^2), df f (1 - f), do o (1 - o)]
//
// and emits dg (B, T, 3H) in g's type and dc0 (B, H). c and dc are carried
// in float32 registers; g, h, dh and dg are float32 or bfloat16.
//
// What bounds it on the H100: bytes. Each step of an element reads three
// gate values and writes h and c (forward), or reads the gates, dh and c
// and writes three gradients (backward), a few flops each: 12 B and 18 B an
// element in bfloat16, against 3.35 TB/s. Each thread owns one (b, j) and
// walks T; neighbouring threads own neighbouring j, so every access of a
// warp is one contiguous run. The chain of T steps is short (13 or 52 at
// the benchmark's widths), so a thread loads the inputs of kSteps steps
// before it computes any of them: those loads are in flight together and
// the chain waits on memory once per kSteps steps, not once per step. At
// most 64 registers a thread (kMinBlocks CTAs of kThreads an SM): at B 128,
// H 1024 the grid's 1,024 CTAs are then resident at once on the card's 132
// SMs, where at 72 registers 924 were and the last 100 made a second wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 8;
constexpr int kMinBlocks = 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fo_pool_fwd(const T* __restrict__ g, const float* __restrict__ c0,
            T* __restrict__ h, float* __restrict__ cs, float* __restrict__ cT,
            int B, int steps, int H) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * H) return;
  const int64_t b = idx / H;
  const int64_t j = idx - b * H;
  const T* gb = g + b * steps * 3 * H + j;
  T* hb = h + b * steps * H + j;
  float* cb = cs == nullptr ? nullptr : cs + b * steps * H + j;
  float c = c0[idx];
  for (int t0 = 0; t0 < steps; t0 += kSteps) {
    float az[kSteps], af[kSteps], ao[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (t0 + u < steps) {
        const T* q = gb + static_cast<int64_t>(t0 + u) * 3 * H;
        az[u] = to_f32(q[0]);
        af[u] = to_f32(q[H]);
        ao[u] = to_f32(q[2 * H]);
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = t0 + u;
      if (t < steps) {
        const float z = tanhf(az[u]);
        const float f = sigmoid_f32(af[u]);
        const float o = sigmoid_f32(ao[u]);
        c = f * c + (1.0f - f) * z;
        hb[static_cast<int64_t>(t) * H] = from_f32<T>(o * c);
        if (cb != nullptr) cb[static_cast<int64_t>(t) * H] = c;
      }
    }
  }
  cT[idx] = c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fo_pool_bwd(const T* __restrict__ g, const float* __restrict__ c0,
            const float* __restrict__ cs, const T* __restrict__ dh,
            const float* __restrict__ dcT, T* __restrict__ dg,
            float* __restrict__ dc0, int B, int steps, int H) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * H) return;
  const int64_t b = idx / H;
  const int64_t j = idx - b * H;
  const T* gb = g + b * steps * 3 * H + j;
  T* db = dg + b * steps * 3 * H + j;
  const T* hb = dh + b * steps * H + j;
  const float* cb = cs + b * steps * H + j;
  const float cinit = c0[idx];
  float dc = dcT == nullptr ? 0.0f : dcT[idx];
  for (int t1 = steps - 1; t1 >= 0; t1 -= kSteps) {
    // step t = t1 - u; cc[u] is c_t, cc[u + 1] is c_{t-1} (c0 before 0)
    float az[kSteps], af[kSteps], ao[kSteps], dhv[kSteps], cc[kSteps + 1];
#pragma unroll
    for (int u = 0; u <= kSteps; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        cc[u] = cb[static_cast<int64_t>(t) * H];
      } else if (t == -1) {
        cc[u] = cinit;
      }
      if (u < kSteps && t >= 0) {
        const T* q = gb + static_cast<int64_t>(t) * 3 * H;
        az[u] = to_f32(q[0]);
        af[u] = to_f32(q[H]);
        ao[u] = to_f32(q[2 * H]);
        dhv[u] = to_f32(hb[static_cast<int64_t>(t) * H]);
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        const float z = tanhf(az[u]);
        const float f = sigmoid_f32(af[u]);
        const float o = sigmoid_f32(ao[u]);
        const float d_o = dhv[u] * cc[u];
        dc += dhv[u] * o;
        const float df = dc * (cc[u + 1] - z);
        const float dz = dc * (1.0f - f);
        dc *= f;
        T* q = db + static_cast<int64_t>(t) * 3 * H;
        q[0] = from_f32<T>(dz * (1.0f - z * z));
        q[H] = from_f32<T>(df * f * (1.0f - f));
        q[2 * H] = from_f32<T>(d_o * o * (1.0f - o));
      }
    }
  }
  dc0[idx] = dc;
}

bool bad_shape(int B, int steps, int H) {
  return B < 1 || steps < 1 || H < 1 ||
         static_cast<int64_t>(B) * H > (int64_t{1} << 31) - kThreads;
}

int blocks(int B, int H) {
  return static_cast<int>((static_cast<int64_t>(B) * H + kThreads - 1) /
                          kThreads);
}

template <typename T>
int forward(const void* g, const float* c0, void* h, float* cs, float* cT,
            int B, int steps, int H, cudaStream_t s) {
  fo_pool_fwd<T><<<blocks(B, H), kThreads, 0, s>>>(
      static_cast<const T*>(g), c0, static_cast<T*>(h), cs, cT, B, steps, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* g, const float* c0, const float* cs, const void* dh,
             const float* dcT, void* dg, float* dc0, int B, int steps, int H,
             cudaStream_t s) {
  fo_pool_bwd<T><<<blocks(B, H), kThreads, 0, s>>>(
      static_cast<const T*>(g), c0, cs, static_cast<const T*>(dh), dcT,
      static_cast<T*>(dg), dc0, B, steps, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The forward sweep of one layer. dtype: 0 = float32, 1 = bfloat16, the
// type of g (B, T, 3H) and h (B, T, H); c0 (B, H), cs (B, T, H) or null (no
// backward to come) and cT (B, H) are float32. Every tensor is contiguous.
// One launch on `stream`; returns the cudaError_t (0 on success).
int fo_pool_fwd_launch(int dtype, const void* g, const void* c0, void* h,
                       void* cs, void* cT, int B, int T, int H, void* stream) {
  if (bad_shape(B, T, H)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(c0);
  float* cso = static_cast<float*>(cs);
  float* cto = static_cast<float*>(cT);
  if (dtype == 0) return forward<float>(g, c, h, cso, cto, B, T, H, s);
  if (dtype == 1) return forward<bf16>(g, c, h, cso, cto, B, T, H, s);
  return cudaErrorInvalidValue;
}

// The reverse sweep of one layer. In: g (B, T, 3H) and dh (B, T, H) in
// `dtype`'s type, c0 (B, H), cs (B, T, H) as the forward wrote it, dcT
// (B, H) or null (no cotangent on c_T), all float32 but g and dh. Out: dg
// (B, T, 3H) in `dtype`'s type, dc0 (B, H) float32. One launch on `stream`.
int fo_pool_bwd_launch(int dtype, const void* g, const void* c0,
                       const void* cs, const void* dh, const void* dcT,
                       void* dg, void* dc0, int B, int T, int H,
                       void* stream) {
  if (bad_shape(B, T, H) || cs == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(c0);
  const float* csi = static_cast<const float*>(cs);
  const float* dct = static_cast<const float*>(dcT);
  float* dco = static_cast<float*>(dc0);
  if (dtype == 0)
    return backward<float>(g, c, csi, dh, dct, dg, dco, B, T, H, s);
  if (dtype == 1)
    return backward<bf16>(g, c, csi, dh, dct, dg, dco, B, T, H, s);
  return cudaErrorInvalidValue;
}

const char* fo_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
