// Fused BatchNorm training pass for Hopper (sm_90a): the statistics kernel
// and the normalize kernel of BatchNorm in train mode over grouped
// activations.
//
// x is a contiguous [G, B, C, H, W] tensor (NCHW with the group axis
// leading): G groups of B samples, each group normalized with its own batch
// statistics over (B, H, W).  The plane of (g, b, c) is the contiguous run
// of H*W values at offset ((g*B + b)*C + c)*H*W, and the C planes of one
// sample (g, b) lie one after another.
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
// Bound: bytes.  K6 reads x once (3 f32 operations per value), K7 reads x
// and writes y once (3 operations per value), far below the card's ratio
// of operations to bytes.  At the flagship's shapes x is 1 to 79 MB.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6),
// three things hold the kernels from the bound: the loads a thread has in
// flight, the work a block does before its first load issues, and, at the
// small planes, the launch itself (an empty kernel at the same grid takes
// 1.2-1.6 us there).  With the L2 cache flushed by a write, a read also
// pays the write-back of the dirty lines it evicts, so K6 cannot reach its
// bound cold below about 50 MB.
//
// Both kernels load `vec` values at a time: 16 bytes (8 bf16, 4 f32) down
// to the widest power of two that divides H*W and the pointers' alignment
// (ops/fused_bn.py::bn_vec), so that no vector crosses a plane (5x6 bf16
// loads 4 bytes).
//
// K6.  On the TPU the grid ran in order and K6 carried its sums across the
// B blocks of a group in VMEM scratch; a block per (group, channel) left
// the card under one wave at 80x96 and half of its threads idle on the
// small planes.  Here K6 runs under the plan of ops/fused_bn.py::bn_plan
// (the CPU tests check that it reads every vector exactly once): a plane
// holds V = H*W/vec vectors, cut into chunks of at most vt; a block is
// (vt, ct, streams) threads over a tile of ct channels of one group, so a
// thread's channel is fixed and its (sample, chunk) rows advance by
// additions, with no division per value.  Small planes put several
// channels in a block, so that a warp streams the contiguous [ct, H*W] run
// of a sample (10x12: 2 channels of 16 lanes in 4 streams).  Each thread
// issues 4 loads (predicated, in volatile asm so that the compiler keeps
// them together) before it uses any.  The channel's lanes reduce by
// shuffles within segments of min(vt, 32) lanes, then the channel's first
// thread adds the segments of every stream from shared memory in order.
// No atomics and no workspace: the order of every sum is fixed by the
// plan, so two launches on the same input give the same bits.
//
// K7 is elementwise over the flat tensor: one thread per vector, its
// channel from the plane index.  Tiles of channels with the factors in
// registers and 4 rows in flight per thread, measured against this body
// on the H100, were no faster at the planes of 20x24 and more, where this
// body already reaches about 80% of the bound from HBM (PERF.md, section
// 6); what they gained was the 5x6 planes, which the vector width above
// gives this body as well.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kNormThreads = 256;
constexpr int kInFlight = 4;         // K6: rows loaded before any is used

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

// VW values of T as one access of sizeof(T) * VW bytes (2 to 16): a load
// or store of an integer vector of that size, so that a 16-byte vector is
// one 128-bit instruction, then the values in registers.
template <int Bytes>
struct RawOf;
template <>
struct RawOf<2> {
  using type = unsigned short;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<16> {
  using type = uint4;
};

template <typename T, int VW>
using Raw = typename RawOf<sizeof(T) * VW>::type;

// K6's loads are volatile asm so that the compiler does not sink one into
// the branch that uses it: the loads of a batch stay in flight together.
// They are predicated: a slot of a batch past the rows of the thread
// issues no load and leaves zeros.
__device__ __forceinline__ void ld_nc(const void* p, bool on, uint4& r) {
  r = make_uint4(0u, 0u, 0u, 0u);
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %5, 0;\n"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4]; }"
      : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w)
      : "l"(p), "r"(static_cast<int>(on)));
}
__device__ __forceinline__ void ld_nc(const void* p, bool on, uint2& r) {
  r = make_uint2(0u, 0u);
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %3, 0;\n"
      "@q ld.global.nc.v2.u32 {%0, %1}, [%2]; }"
      : "+r"(r.x), "+r"(r.y)
      : "l"(p), "r"(static_cast<int>(on)));
}
__device__ __forceinline__ void ld_nc(const void* p, bool on,
                                      unsigned int& r) {
  r = 0u;
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.u32 %0, [%1]; }"
      : "+r"(r)
      : "l"(p), "r"(static_cast<int>(on)));
}
__device__ __forceinline__ void ld_nc(const void* p, bool on,
                                      unsigned short& r) {
  r = 0;
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0;\n"
      "@q ld.global.nc.u16 %0, [%1]; }"
      : "+h"(r)
      : "l"(p), "r"(static_cast<int>(on)));
}

template <typename T, int VW>
__device__ __forceinline__ Raw<T, VW> load_raw(const T* p, bool on) {
  Raw<T, VW> r;
  ld_nc(p, on, r);
  return r;
}

// The VW values of a raw vector in f32, and back rounded to T: bf16 in
// pairs (one conversion instruction for two values).
template <typename T, int VW>
__device__ __forceinline__ void unpack(const Raw<T, VW>& r, float e[VW]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VW >= 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < VW / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      e[2 * k] = f.x;
      e[2 * k + 1] = f.y;
    }
  } else {
    const T* v = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < VW; ++k) e[k] = to_f32(v[k]);
  }
}

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float e[VW]) {
  Raw<T, VW> r;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VW >= 2) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < VW / 2; ++k) {
      h[k] = __floats2bfloat162_rn(e[2 * k], e[2 * k + 1]);
    }
  } else {
    T* v = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int k = 0; k < VW; ++k) v[k] = from_f32<T>(e[k]);
  }
  *reinterpret_cast<Raw<T, VW>*>(p) = r;
}

// Pairwise sum of N values (N a power of two); overwrites a.
template <int N>
__device__ __forceinline__ float tree_sum(float a[N]) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) a[i] += a[i + w];
  }
  return a[0];
}

// (b, ch) of row r = b * chunks + ch, and the step (db, dc) of `step`
// rows; without a division where a plane is one chunk.
struct Rows {
  int b, ch, db, dc;
};

__device__ __forceinline__ Rows rows_from(int r, int step, int chunks) {
  Rows w;
  if (chunks == 1) {
    w.b = r;
    w.ch = 0;
    w.db = step;
    w.dc = 0;
  } else {
    w.b = r / chunks;
    w.ch = r - w.b * chunks;
    w.db = step / chunks;
    w.dc = step - w.db * chunks;
  }
  return w;
}

__device__ __forceinline__ void next_row(Rows& w, int chunks) {
  w.ch += w.dc;
  w.b += w.db;
  if (w.ch >= chunks) {
    w.ch -= chunks;
    ++w.b;
  }
}

// K6.  grid (tiles, groups), blocks of (vt, ct, streams) threads:
// threadIdx.x the vector lane within a chunk of a plane, .y the channel
// within the block's tile of ct channels, .z the stream.  The rows of a
// tile, (sample, chunk) pairs, are dealt to the streams in turn: stream s
// takes row s, then every streams-th row after it.  Blocks loop over the
// groups beyond the grid's 65535 in y.
template <typename T, int VW>
__global__ void __launch_bounds__(kMaxThreads, 2)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ var, int groups, int batch, int channels,
                int hw) {
  __shared__ float part[2][kMaxThreads];
  const int vt = blockDim.x, ct = blockDim.y, streams = blockDim.z;
  const int lane = threadIdx.x, cl = threadIdx.y, stream = threadIdx.z;
  const int tid = lane + (cl + stream * ct) * vt;
  const int nv = hw / VW;
  const int chunks = nv <= vt ? 1 : (nv + vt - 1) / vt;
  const Rows w0 = rows_from(stream, streams, chunks);
  const int64_t sample_stride = static_cast<int64_t>(channels) * hw;
  // vt is a power of two up to 32 or a multiple of 32: a segment of
  // min(vt, 32) lanes never straddles a warp or a channel
  const int seg = vt < 32 ? vt : 32;
  const int seg_shift = __ffs(seg) - 1;
  const float inv_n = 1.f / static_cast<float>(batch * hw);
  const int c = blockIdx.x * ct + cl;
  const bool active = c < channels;

  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    float s = 0.f, q = 0.f;
    if (active) {
      const T* base =
          x + (static_cast<int64_t>(g) * batch * channels + c) * hw;
      Rows w = w0;
      while (w.b < batch) {
        // every load is issued before any is used; a row past the end, or
        // a lane past the plane, loads nothing and adds zeros
        Raw<T, VW> raw[kInFlight];
        bool ok[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int v = w.ch * vt + lane;
          ok[u] = w.b < batch && v < nv;
          raw[u] = load_raw<T, VW>(
              base + (ok[u] ? w.b * sample_stride + v * VW : 0), ok[u]);
          next_row(w, chunks);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          float e[VW], sq[VW];
          unpack<T, VW>(raw[u], e);
#pragma unroll
          for (int k = 0; k < VW; ++k) sq[k] = e[k] * e[k];
          const float vs = tree_sum<VW>(e), vq = tree_sum<VW>(sq);
          s += ok[u] ? vs : 0.f;
          q += ok[u] ? vq : 0.f;
        }
      }
    }

    // The lanes of a channel: by shuffles within each segment (every lane
    // of a segment ends with the same bits), then the channel's first
    // thread adds its segments of every stream from shared memory, in
    // order.
    for (int o = seg >> 1; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if ((lane & (seg - 1)) == 0) {
      part[0][tid >> seg_shift] = s;
      part[1][tid >> seg_shift] = q;
    }
    __syncthreads();
    if (active && stream == 0 && lane == 0) {
      const int per = (ct * vt) >> seg_shift;
      const int first = (cl * vt) >> seg_shift, n = vt >> seg_shift;
      s = part[0][first];
      q = part[1][first];
      for (int st = 0; st < streams; ++st) {
        for (int k = st == 0 ? 1 : 0; k < n; ++k) {
          s += part[0][st * per + first + k];
          q += part[1][st * per + first + k];
        }
      }
      const int gc = g * channels + c;
      const float m = s * inv_n;
      mean[gc] = m;
      var[gc] = q * inv_n - m * m;
    }
    __syncthreads();                     // part is reused by the next group
  }
}

// K7.  Thread t normalizes the VW values [t * VW, t * VW + VW) of the flat
// x; VW divides hw, so they share one plane and one channel.
template <typename T, typename P, int VW>
__global__ void __launch_bounds__(kNormThreads)
bn_norm_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ var, const P* __restrict__ scale,
               const P* __restrict__ bias, T* __restrict__ y, int batch,
               int channels, int64_t hw, int64_t total, float eps) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kNormThreads + threadIdx.x) * VW;
  if (i >= total) return;
  const int64_t plane = i / hw;                       // (g*B + b)*C + c
  const int c = static_cast<int>(plane % channels);
  const int g =
      static_cast<int>(plane / (static_cast<int64_t>(batch) * channels));
  const int gc = g * channels + c;
  const float m = mean[gc];
  const float a = rsqrtf(var[gc] + eps) * to_f32(scale[c]);
  const float b = to_f32(bias[c]);
  float e[VW];
  unpack<T, VW>(*reinterpret_cast<const Raw<T, VW>*>(x + i), e);
#pragma unroll
  for (int k = 0; k < VW; ++k) e[k] = (e[k] - m) * a + b;
  store_vec<T, VW>(y + i, e);
}

__global__ void empty_kernel() {}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes)) ==
         0;
}

// vec a power of two of at most 16 bytes that divides hw.
bool vec_ok(long long hw, int esize, int vec) {
  return (vec == 1 || vec == 2 || vec == 4 || vec == 8) &&
         vec * esize <= 16 && hw % vec == 0;
}

// K6's block: vt a power of two up to 32 or a multiple of 32, so that its
// shuffles stay within a channel; vt * ct * streams threads, a multiple of
// 32 up to kMaxThreads.
bool block_ok(int vt, int ct, int streams, int threads) {
  if (vt < 1 || ct < 1 || streams < 1 || streams > 64) return false;
  if (vt <= 32 ? (vt & (vt - 1)) != 0 : vt % 32 != 0) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return false;
  }
  return static_cast<long long>(vt) * ct * streams == threads;
}

constexpr long long kMaxGridY = 65535;

// f(std::integral_constant<int, VW>) for the plan's vec (8 only for bf16:
// vec_ok refuses more than 16 bytes).
template <typename T, typename F>
cudaError_t with_vec(int vec, F f) {
  switch (vec) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return f(std::integral_constant<int, 16 / sizeof(T)>());
  }
}

template <typename T>
cudaError_t stats_typed(const void* x, float* mean, float* var, int groups,
                        int batch, int channels, int hw, int vec, dim3 grid,
                        dim3 block, cudaStream_t s) {
  return with_vec<T>(vec, [&](auto vw) {
    bn_stats_kernel<T, decltype(vw)::value><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), mean, var, groups, batch, channels, hw);
    return cudaSuccess;
  });
}

template <typename T, typename P>
cudaError_t norm_typed(const void* x, const float* mean, const float* var,
                       const void* scale, const void* bias, void* y,
                       int batch, int channels, int64_t hw, int64_t total,
                       float eps, int vec, unsigned blocks, cudaStream_t s) {
  return with_vec<T>(vec, [&](auto vw) {
    bn_norm_kernel<T, P, decltype(vw)::value><<<blocks, kNormThreads, 0, s>>>(
        static_cast<const T*>(x), mean, var, static_cast<const P*>(scale),
        static_cast<const P*>(bias), static_cast<T*>(y), batch, channels, hw,
        total, eps);
    return cudaSuccess;
  });
}

}  // namespace

// K6: mean and var [G, C] f32 of x [G, B, C, H, W] (hw = H*W) under the
// plan (vec, vt, ct, streams, threads) of ops/fused_bn.py::bn_plan.
// Launches on `stream` of `device` and returns the launch's CUDA error (0
// on success); a plan that does not fit the shape or x's alignment is
// refused with cudaErrorInvalidValue.  x_bf16 selects bf16 (1) or f32 (0).
extern "C" int rdt_bn_stats(const void* x, void* mean, void* var,
                            long long groups, long long batch,
                            long long channels, long long hw, int x_bf16,
                            int vec, int vt, int ct, int streams,
                            int threads, int device, void* stream) {
  const int esize = x_bf16 ? 2 : 4;
  if (groups <= 0 || batch <= 0 || channels <= 0 || hw <= 0 ||
      groups * channels > INT_MAX || batch * hw > INT_MAX ||
      !vec_ok(hw, esize, vec) || !block_ok(vt, ct, streams, threads) ||
      !aligned(x, vec * esize)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((channels + ct - 1) / ct),
                  static_cast<unsigned>(groups < kMaxGridY ? groups
                                                           : kMaxGridY));
  const dim3 block(vt, ct, streams);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(groups), b = static_cast<int>(batch);
  const int c = static_cast<int>(channels), n = static_cast<int>(hw);
  err = x_bf16 ? stats_typed<__nv_bfloat16>(x, m, v, g, b, c, n, vec, grid,
                                            block, s)
               : stats_typed<float>(x, m, v, g, b, c, n, vec, grid, block, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K7: y = (x - mean) * (rsqrt(var + eps) * scale) + bias, y of x's shape
// and dtype, vec values per thread (ops/fused_bn.py::bn_vec).  x_bf16
// selects x's and y's dtype, p_bf16 scale's and bias's.  Launches on
// `stream` of `device` and returns the launch's CUDA error; a vec that
// does not fit hw or the pointers' alignment is refused.
extern "C" int rdt_bn_norm(const void* x, const void* mean, const void* var,
                           const void* scale, const void* bias, void* y,
                           long long groups, long long batch,
                           long long channels, long long hw, int x_bf16,
                           int p_bf16, float eps, int vec, int device,
                           void* stream) {
  const int esize = x_bf16 ? 2 : 4;
  if (groups <= 0 || batch <= 0 || channels <= 0 || hw <= 0 ||
      groups * channels > INT_MAX || batch * channels > INT_MAX ||
      !vec_ok(hw, esize, vec) || !aligned(x, vec * esize) ||
      !aligned(y, vec * esize)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = groups * batch * channels * hw;
  const long long blocks =
      (total / vec + kNormThreads - 1) / kNormThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* v = static_cast<const float*>(var);
  const int b = static_cast<int>(batch);
  const int c = static_cast<int>(channels);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (x_bf16 && p_bf16) {
    err = norm_typed<__nv_bfloat16, __nv_bfloat16>(
        x, m, v, scale, bias, y, b, c, hw, total, eps, vec, nb, s);
  } else if (x_bf16) {
    err = norm_typed<__nv_bfloat16, float>(x, m, v, scale, bias, y, b, c,
                                           hw, total, eps, vec, nb, s);
  } else if (p_bf16) {
    err = norm_typed<float, __nv_bfloat16>(x, m, v, scale, bias, y, b, c,
                                           hw, total, eps, vec, nb, s);
  } else {
    err = norm_typed<float, float>(x, m, v, scale, bias, y, b, c, hw, total,
                                   eps, vec, nb, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on a grid of `blocks` blocks of `threads`, launched as
// K6 and K7 are: the floor of a launch at a kernel's grid, for timing
// only.
extern "C" int rdt_bn_empty(long long blocks, int threads, int device,
                            void* stream) {
  if (blocks < 1 || blocks > INT_MAX || threads < 1 ||
      threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
