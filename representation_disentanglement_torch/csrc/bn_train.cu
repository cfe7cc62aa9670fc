// Fused BatchNorm training pass for Hopper (sm_90a): the statistics kernel
// and the normalize kernel of BatchNorm in train mode over grouped
// activations.
//
// x is a contiguous [G, B, C, H, W] tensor (NCHW with the group axis
// leading): G groups of B samples, each group normalized with its own batch
// statistics over (B, H, W).  The plane of (g, b, c) is the contiguous run
// of H*W values at offset ((g*B + b)*C + c)*H*W.
//
// rdt_bn_stats (K6) replaces the TPU Pallas kernel
// representation_disentanglement_tpu/ops/pallas_bn.py::_stats_kernel: per
// (group, channel), the sums of x and x^2 in f32 over the B planes, then
//     mean = sum(x) / n,   var = sum(x^2) / n - mean^2     (n = B*H*W)
// the biased one-pass variance of the TPU kernel, not clamped (neither is
// the TPU's).  Outputs: mean and var [G, C] f32.
//
// rdt_bn_norm (K7) replaces pallas_bn.py::_norm_kernel:
//     y = (x - mean) * (rsqrt(var + eps) * scale) + bias
// in f32, rounded once to x's dtype.  The per-channel factor is kept as
// the TPU kernel has it; it is not folded into x * a + b', and scale and
// bias are not rounded to x's dtype first (the unfused path,
// ops/norm.py::batch_norm_apply, does round them, so its bf16 results
// differ from these by design).
//
// Types: x and y f32 or bf16; scale and bias share one dtype, f32 or bf16;
// mean and var f32.
//
// Design.  On the TPU the grid ran in order and K6 carried its sums across
// the B blocks of a group in VMEM scratch.  Here the loop over B sits
// inside the block: K6 takes one block of 512 threads per (group,
// channel) and reduces its B planes with warp shuffles and one shared-
// memory step across the 16 warps.  Where H*W is a multiple of 8 and x is
// 16-byte aligned, each thread reads 8 values per access (one 16-byte load
// for bf16, two for f32), over the flattened (b, vector) index so that
// planes smaller than the block (10x12: 15 vectors) still spread over all
// threads; elsewhere (5x6 planes: 60 bf16 bytes) it reads one value at a
// time.  K7 is elementwise: one thread per 8 values (or per value where
// H*W is not a multiple of 8), its channel from the plane index.
//
// Bound: bytes.  K6 reads x once and does 3 f32 operations per value; K7
// reads x once and writes y once with 3 operations per value.  Both are
// far below the card's ratio of operations to bytes.  G*C blocks for K6 is
// 128 to 2560 at the flagship shapes: at G*C = 128 (the anatomy U-Net's
// last BatchNorm, 32 channels at 80x96) the grid is under one wave on 132
// SMs and each block reduces 122,880 values alone.  A split reduction (a
// second pass over partial sums) would fill the card; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kStatsThreads = 512;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kNormThreads = 256;
constexpr int kVec = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// One block per (group, channel), blockIdx.x = g * C + c.  batch * hw fits
// in an int (checked by the entry point).
template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kStatsThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ var, int batch, int channels, int hw) {
  __shared__ float red[2][kStatsWarps];
  const int gc = blockIdx.x;
  const int g = gc / channels;
  const int c = gc - g * channels;
  const int64_t sample_stride = static_cast<int64_t>(channels) * hw;
  const T* base = x + (static_cast<int64_t>(g) * batch * channels + c) * hw;

  float s = 0.f, q = 0.f;
  if (kVectorized) {
    const int per_plane = hw / kVec;
    const int nvec = per_plane * batch;
#pragma unroll 4
    for (int v = threadIdx.x; v < nvec; v += kStatsThreads) {
      const int b = v / per_plane;
      const int i = (v - b * per_plane) * kVec;
      float e[kVec];
      load8(base + b * sample_stride + i, e);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s += e[k];
        q += e[k] * e[k];
      }
    }
  } else {
    const int n = hw * batch;
    for (int j = threadIdx.x; j < n; j += kStatsThreads) {
      const int b = j / hw;
      const float e = to_f32(base[b * sample_stride + (j - b * hw)]);
      s += e;
      q += e * e;
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kStatsWarps ? red[0][lane] : 0.f;
    q = lane < kStatsWarps ? red[1][lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      const float inv_n = 1.f / static_cast<float>(batch * hw);
      const float m = s * inv_n;
      mean[gc] = m;
      var[gc] = q * inv_n - m * m;
    }
  }
}

// Elementwise: thread t normalizes values [t*step, t*step + step), step 8
// (vectorized, hw a multiple of 8, so the 8 values share one plane) or 1.
template <typename T, typename P, bool kVectorized>
__global__ void __launch_bounds__(kNormThreads)
bn_norm_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ var, const P* __restrict__ scale,
               const P* __restrict__ bias, T* __restrict__ y, int batch,
               int channels, int64_t hw, int64_t total, float eps) {
  const int64_t step = kVectorized ? kVec : 1;
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kNormThreads + threadIdx.x) * step;
  if (i >= total) return;
  const int64_t plane = i / hw;                       // (g*B + b)*C + c
  const int c = static_cast<int>(plane % channels);
  const int g = static_cast<int>(plane / (static_cast<int64_t>(batch) * channels));
  const int gc = g * channels + c;
  const float m = mean[gc];
  const float a = rsqrtf(var[gc] + eps) * to_f32(scale[c]);
  const float b = to_f32(bias[c]);
  if (kVectorized) {
    float e[kVec];
    load8(x + i, e);
#pragma unroll
    for (int k = 0; k < kVec; ++k) e[k] = (e[k] - m) * a + b;
    store8(y + i, e);
  } else {
    y[i] = from_f32<T>((to_f32(x[i]) - m) * a + b);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
void launch_stats(const void* x, float* mean, float* var, int gc, int batch,
                  int channels, int hw, bool vectorized, cudaStream_t stream) {
  if (vectorized) {
    bn_stats_kernel<T, true><<<gc, kStatsThreads, 0, stream>>>(
        static_cast<const T*>(x), mean, var, batch, channels, hw);
  } else {
    bn_stats_kernel<T, false><<<gc, kStatsThreads, 0, stream>>>(
        static_cast<const T*>(x), mean, var, batch, channels, hw);
  }
}

template <typename T, typename P>
void launch_norm(const void* x, const float* mean, const float* var,
                 const void* scale, const void* bias, void* y, int batch,
                 int channels, int64_t hw, int64_t total, float eps,
                 bool vectorized, cudaStream_t stream) {
  const int64_t step = vectorized ? kVec : 1;
  const int64_t threads = (total + step - 1) / step;
  const unsigned blocks =
      static_cast<unsigned>((threads + kNormThreads - 1) / kNormThreads);
  if (vectorized) {
    bn_norm_kernel<T, P, true><<<blocks, kNormThreads, 0, stream>>>(
        static_cast<const T*>(x), mean, var, static_cast<const P*>(scale),
        static_cast<const P*>(bias), static_cast<T*>(y), batch, channels, hw,
        total, eps);
  } else {
    bn_norm_kernel<T, P, false><<<blocks, kNormThreads, 0, stream>>>(
        static_cast<const T*>(x), mean, var, static_cast<const P*>(scale),
        static_cast<const P*>(bias), static_cast<T*>(y), batch, channels, hw,
        total, eps);
  }
}

}  // namespace

// K6: mean and var [G, C] f32 of x [G, B, C, H, W] (hw = H*W).  Launches on
// `stream` of `device` and returns cudaGetLastError() (0 on success).
// x_bf16 selects bf16 (1) or f32 (0) for x.
extern "C" int rdt_bn_stats(const void* x, void* mean, void* var,
                            long long groups, long long batch,
                            long long channels, long long hw, int x_bf16,
                            int device, void* stream) {
  if (groups <= 0 || batch <= 0 || channels <= 0 || hw <= 0 ||
      groups * channels > INT_MAX || batch * hw > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vectorized = hw % kVec == 0 && aligned16(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gc = static_cast<int>(groups * channels);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  if (x_bf16) {
    launch_stats<__nv_bfloat16>(x, m, v, gc, static_cast<int>(batch),
                                static_cast<int>(channels),
                                static_cast<int>(hw), vectorized, s);
  } else {
    launch_stats<float>(x, m, v, gc, static_cast<int>(batch),
                        static_cast<int>(channels), static_cast<int>(hw),
                        vectorized, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: y = (x - mean) * (rsqrt(var + eps) * scale) + bias, y of x's shape
// and dtype.  x_bf16 selects x's and y's dtype, p_bf16 scale's and bias's.
// Launches on `stream` of `device` and returns cudaGetLastError().
extern "C" int rdt_bn_norm(const void* x, const void* mean, const void* var,
                           const void* scale, const void* bias, void* y,
                           long long groups, long long batch,
                           long long channels, long long hw, int x_bf16,
                           int p_bf16, float eps, int device, void* stream) {
  if (groups <= 0 || batch <= 0 || channels <= 0 || hw <= 0 ||
      groups * channels > INT_MAX || batch * channels > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = groups * batch * channels * hw;
  const bool vectorized =
      hw % kVec == 0 && aligned16(x) && aligned16(y);
  const long long blocks =
      (total / (vectorized ? kVec : 1) + kNormThreads - 1) / kNormThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  const int b = static_cast<int>(batch);
  const int c = static_cast<int>(channels);
  if (x_bf16 && p_bf16) {
    launch_norm<__nv_bfloat16, __nv_bfloat16>(x, m, v, scale, bias, y, b, c,
                                              hw, total, eps, vectorized, s);
  } else if (x_bf16) {
    launch_norm<__nv_bfloat16, float>(x, m, v, scale, bias, y, b, c, hw,
                                      total, eps, vectorized, s);
  } else if (p_bf16) {
    launch_norm<float, __nv_bfloat16>(x, m, v, scale, bias, y, b, c, hw,
                                      total, eps, vectorized, s);
  } else {
    launch_norm<float, float>(x, m, v, scale, bias, y, b, c, hw, total, eps,
                              vectorized, s);
  }
  return static_cast<int>(cudaGetLastError());
}
