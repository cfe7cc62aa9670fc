// Fused SPADE interior for Hopper (sm_90a):
//
//     out = instance_norm(zi) * (1 + gamma) + beta
//
// Replaces the two TPU Pallas kernels of the JAX package,
// representation_disentanglement_tpu/ops/pallas_kernels.py::_kernel (the
// [H, W, C] slab kernel, C a multiple of 128) and ::_packed_kernel (small C
// viewed as [H, W*C], channels reduced by an iota-selector matmul).  Both
// compute one function; the split existed only because a TPU pads its lane
// dimension to 128.  Hopper has no lanes to pad, so one kernel serves every
// SPADE block, sp6 (C=32 at 160x192) included.
//
// Layout: zi, gamma, beta and out are contiguous NCHW [N, C, H, W] of equal
// shape, so each (sample, channel) plane of H*W values is contiguous.  zi is
// f32 or bf16; gamma and beta share one dtype, f32 or bf16, which may differ
// from zi's; out has zi's dtype.
//
// Numerics: per plane, f32 mean and biased variance over H*W, then
// (zi - mean) * rsqrt(var + eps) * (1 + gamma) + beta in f32, rounded once
// to the output dtype (the TPU kernel's numerics).  The variance is
// two-pass (mean first, then the mean of squared deviations), as in the
// plain path ops/norm.instance_norm; the TPU kernel's one-pass
// E[x^2] - E[x]^2 differs from it by about 1e-6 in f32.
//
// Design: one block of 256 threads per plane.  The block reduces the plane
// in f32 (warp shuffles, then one shared-memory step across the 8 warps)
// for the mean, again for the variance, then re-reads the plane with gamma
// and beta and writes the output.  Where H*W is a multiple of 8 and every
// pointer is 16-byte aligned, each thread moves 8 values per access (one
// 16-byte load for bf16, two for f32).  At the serving shapes that gives
// 2048 (sp6) to 8192 (sp1-sp4) blocks for 132 SMs.
//
// Bound: bytes.  The work is about ten f32 operations per element against
// 8 (bf16) to 16 (f32) bytes moved, far below the card's ratio of
// operations to bytes.  The least traffic is one read each of zi, gamma and
// beta and one write of out.  This kernel reads zi three times; a plane is
// at most 120 KB (sp6 in f32), so the second and third reads come from L2
// (50 MB) rather than device memory.  What a later version would change:
// hold the plane in shared memory so zi is read once, run on channels_last
// activations, or fuse the statistics into the epilogue of the conv that
// produces zi.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

// Sum of v over the block; every thread gets the result.  red holds
// kWarps + 1 floats and is free again when the function returns.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[kWarps] = t;
  }
  __syncthreads();
  const float r = red[kWarps];
  __syncthreads();
  return r;
}

template <typename TZ, typename TG, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
in_modulate_kernel(const TZ* __restrict__ zi, const TG* __restrict__ gamma,
                   const TG* __restrict__ beta, TZ* __restrict__ out,
                   int64_t hw, float eps) {
  __shared__ float red[kWarps + 1];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hw;
  const TZ* z = zi + base;
  const TG* g = gamma + base;
  const TG* b = beta + base;
  TZ* o = out + base;
  const float inv_n = 1.f / static_cast<float>(hw);

  float s = 0.f;
  if (kVectorized) {
    for (int64_t i = threadIdx.x * kVec; i < hw; i += kThreads * kVec) {
      float v[kVec];
      load8(z + i, v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) s += v[k];
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) s += to_f32(z[i]);
  }
  const float mean = block_sum(s, red) * inv_n;

  float q = 0.f;
  if (kVectorized) {
    for (int64_t i = threadIdx.x * kVec; i < hw; i += kThreads * kVec) {
      float v[kVec];
      load8(z + i, v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float d = v[k] - mean;
        q += d * d;
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
      const float d = to_f32(z[i]) - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) * inv_n + eps);

  if (kVectorized) {
    for (int64_t i = threadIdx.x * kVec; i < hw; i += kThreads * kVec) {
      float v[kVec], gv[kVec], bv[kVec];
      load8(z + i, v);
      load8(g + i, gv);
      load8(b + i, bv);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        v[k] = (v[k] - mean) * rstd * (1.f + gv[k]) + bv[k];
      store8(o + i, v);
    }
  } else {
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
      const float v = (to_f32(z[i]) - mean) * rstd;
      o[i] = from_f32<TZ>(v * (1.f + to_f32(g[i])) + to_f32(b[i]));
    }
  }
}

template <typename TZ, typename TG>
void launch(const void* zi, const void* gamma, const void* beta, void* out,
            long long planes, long long hw, bool vectorized, float eps,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(planes));
  if (vectorized) {
    in_modulate_kernel<TZ, TG, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const TZ*>(zi), static_cast<const TG*>(gamma),
        static_cast<const TG*>(beta), static_cast<TZ*>(out), hw, eps);
  } else {
    in_modulate_kernel<TZ, TG, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const TZ*>(zi), static_cast<const TG*>(gamma),
        static_cast<const TG*>(beta), static_cast<TZ*>(out), hw, eps);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Launches the kernel on `stream` of `device` and returns cudaGetLastError()
// (0 on success).  z_bf16 / g_bf16 select bf16 (1) or f32 (0) for zi/out and
// for gamma/beta.
extern "C" int rdt_in_modulate(const void* zi, const void* gamma,
                               const void* beta, void* out, long long planes,
                               long long hw, int z_bf16, int g_bf16, float eps,
                               int device, void* stream) {
  if (planes <= 0 || planes > INT_MAX || hw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vectorized = hw % kVec == 0 && aligned16(zi) &&
                          aligned16(gamma) && aligned16(beta) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_bf16 && g_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(zi, gamma, beta, out, planes, hw,
                                         vectorized, eps, s);
  } else if (z_bf16) {
    launch<__nv_bfloat16, float>(zi, gamma, beta, out, planes, hw, vectorized,
                                 eps, s);
  } else if (g_bf16) {
    launch<float, __nv_bfloat16>(zi, gamma, beta, out, planes, hw, vectorized,
                                 eps, s);
  } else {
    launch<float, float>(zi, gamma, beta, out, planes, hw, vectorized, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
