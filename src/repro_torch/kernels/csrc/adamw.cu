// AdamW for NVIDIA Hopper (sm_90a), CUDA C++: the global norm's sum of
// squares, and the update of one leaf in a single pass, in place.
//
// Replaces no TPU kernel: the JAX optimizer (src/repro/optim/adamw.py) is
// plain jnp that XLA fuses under jit.  The port's eager form
// (src/repro_torch/optim/adamw.py, kept for CPU and meta leaves) runs
// about twenty ATen kernels a leaf, each reading and writing whole f32
// tensors: about 200 bytes of device memory a parameter, and whole-leaf
// f32 temporaries (4.3 GB each for a [8, 64, 2048, 1024] stacked expert
// leaf).  The arithmetic needs far fewer bytes a parameter (bf16 params
// and grads, f32 moments and master weights):
//
//   sum of squares: the grad read once                          2 B
//   update: grad read; m, v, master read and written; param
//           written; the clipped grad written back if clipped  28-30 B
//
// 30-32 B a parameter: for the 3.56 B parameters of the benchmark's
// olmoe_1b_7b_pp2 stage, 107-114 GB, 32-34 ms at the H100 SXM's 3.35 TB/s.
// Both passes are bound by memory; their design moves each byte once:
//
// * repro_adamw_sumsq: one launch over a device table of the grad leaves
//   (rows of int64: address, elements, first chunk, dtype).  Each leaf is
//   cut into chunks of `chunk` elements; blocks stride over the chunks,
//   and each chunk's squares (f32, from 16-byte loads) are summed by one
//   block in a fixed order into its own partial.  A one-block pass then
//   sums each leaf's partials in a fixed order and the leaves in leaf
//   order (as the eager global_norm adds its per-leaf sums).  No float
//   atomics: the same grads give the same bits on every run, whatever
//   the grid.
// * repro_adamw_update: one thread moves 8 elements a step with 16-byte
//   loads and stores (two for f32 arrays), streaming cache hints (every
//   byte is touched once), 64-bit offsets (a stacked expert leaf has over
//   10^9 elements) and a scalar tail.  The clip scale, the bias
//   corrections and the learning rate are read from device pointers (the
//   optimizer's 0-d tensors), so nothing waits for the host.  Where the
//   scale in the grad's type is exactly 1 the grad is left as it is (the
//   multiply would not change it) and not stored.
//
// Arithmetic.  Each element is updated by the eager path's operations in
// their order, every one rounded to f32 by itself (the _rn intrinsics,
// which are never contracted into an FMA; IEEE division and square root),
// so m, v, master and the param come out bit-equal to the eager path for
// the same clip scale:
//
//   g   = f32(G(g * f32(G(scale))))        G: the grad's type
//   m32 = b1 m + (1 - b1) g
//   v32 = b2 v + ((1 - b2) g) g             m, v stored in their type
//   u   = ((m32 / bc1) / (sqrt(v32 / bc2) + eps) + wd master) lr
//   master -= u;  param = P(master)         P: the param's type, RNE
//
// The constants come in as f32 from the host's doubles (1 - b1 taken in
// double first), as ATen takes a Python scalar.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;               // elements a thread moves per step
constexpr int kTableCols = 4;         // address, elements, first chunk, dtype
constexpr int kFinishThreads = 1024;

enum : long long { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T (nearest even) and widened back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 8 elements from a 16-byte-aligned address, streamed (read once)
__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ float2 widen2(__nv_bfloat162 h) { return __bfloat1622float2(h); }
__device__ __forceinline__ float2 widen2(__half2 h) { return __half22float2(h); }

// 8 elements of a 2-byte type from a 16-byte-aligned address, streamed
template <typename T, typename H2>
__device__ __forceinline__ void load8_half(const T* p, float (&x)[kVec]) {
  const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
  H2 h[4];
  memcpy(h, &r, sizeof(r));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = widen2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  load8_half<__nv_bfloat16, __nv_bfloat162>(p, x);
}

__device__ __forceinline__ void load8(const __half* p, float (&x)[kVec]) {
  load8_half<__half, __half2>(p, x);
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(x[4], x[5], x[6], x[7]));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[kVec]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  uint4 r;
  memcpy(&r, h, sizeof(r));
  __stcs(reinterpret_cast<uint4*>(p), r);
}

__device__ __forceinline__ void store8(__half* p, const float (&x)[kVec]) {
  __half2 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(x[2 * i], x[2 * i + 1]);
  uint4 r;
  memcpy(&r, h, sizeof(r));
  __stcs(reinterpret_cast<uint4*>(p), r);
}

// The sum of `x` over the block, in a fixed order (warp trees, then the
// warps' sums by the first warp); every thread gets it.  `red` holds
// blockDim.x / 32 floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < warps ? red[lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  __syncthreads();                    // red is free again
  return x;
}

// This thread's share of the squares of leaf elements [begin, end)
template <typename T>
__device__ __forceinline__ float chunk_sumsq(const T* x, long long begin, long long end) {
  float acc = 0.0f;
  constexpr int kPer = 16 / sizeof(T);          // elements in 16 bytes
  long long i = begin + static_cast<long long>(threadIdx.x) * kPer;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0) {
#pragma unroll 4
    for (; i + kPer <= end; i += static_cast<long long>(blockDim.x) * kPer) {
      if constexpr (kPer == 4) {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(x + i));
        acc = fmaf(a.x, a.x, acc); acc = fmaf(a.y, a.y, acc);
        acc = fmaf(a.z, a.z, acc); acc = fmaf(a.w, a.w, acc);
      } else {
        float f[kVec];
        load8(x + i, f);
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc = fmaf(f[k], f[k], acc);
      }
    }
    // the ragged end: fewer than kPer elements left in this thread's step
    for (long long j = i; j < end && j < i + kPer; ++j) {
      const float f = to_f32(x[j]);
      acc = fmaf(f, f, acc);
    }
  } else {
    for (long long j = begin + threadIdx.x; j < end; j += blockDim.x) {
      const float f = to_f32(x[j]);
      acc = fmaf(f, f, acc);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const long long* __restrict__ table, int n_leaves, long long n_chunks,
                 long long chunk, float* __restrict__ partials) {
  __shared__ float red[kThreads / 32];
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    // the last leaf whose first chunk is at most c (an empty leaf owns none)
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid * kTableCols + 2] <= c) lo = mid; else hi = mid - 1;
    }
    const long long* row = table + lo * kTableCols;
    const void* x = reinterpret_cast<const void*>(row[0]);
    const long long begin = (c - row[2]) * chunk;
    const long long end = min(begin + chunk, row[1]);
    float acc;
    switch (row[3]) {
      case kBF16: acc = chunk_sumsq(static_cast<const __nv_bfloat16*>(x), begin, end); break;
      case kF16: acc = chunk_sumsq(static_cast<const __half*>(x), begin, end); break;
      default: acc = chunk_sumsq(static_cast<const float*>(x), begin, end); break;
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) partials[c] = acc;
  }
}

// sums[l]: leaf l's partials in order; sums[n_leaves]: the leaves' sums
// added one after another in leaf order, from 0
__global__ void __launch_bounds__(kFinishThreads)
    sumsq_finish_kernel(const long long* __restrict__ table, int n_leaves, long long n_chunks,
                        const float* __restrict__ partials, float* __restrict__ sums) {
  __shared__ float red[kFinishThreads / 32];
  for (int l = 0; l < n_leaves; ++l) {
    const long long first = table[l * kTableCols + 2];
    const long long last = l + 1 < n_leaves ? table[(l + 1) * kTableCols + 2] : n_chunks;
    float acc = 0.0f;
    for (long long c = first + threadIdx.x; c < last; c += blockDim.x) acc += partials[c];
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) sums[l] = acc;
  }
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int l = 0; l < n_leaves; ++l) total = __fadd_rn(total, sums[l]);
    sums[n_leaves] = total;
  }
}

// One element's AdamW update from its clipped grad `g`; m and v come back
// as their f32 values (the caller stores them in their type), w is the
// new master weight.
__device__ __forceinline__ void adamw_elem(float g, float& m, float& v, float& w, float bc1,
                                           float bc2, float lr, const Hyper& h) {
  const float m32 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  const float v32 = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v32, bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m32, bc1), denom);
  u = __fmul_rn(__fadd_rn(u, __fmul_rn(h.wd, w)), lr);
  w = __fsub_rn(w, u);
  m = m32;
  v = v32;
}

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(P* __restrict__ g, M* __restrict__ m, M* __restrict__ v,
                        float* __restrict__ w, P* __restrict__ p, long long n, bool vec,
                        const float* __restrict__ scale, const float* __restrict__ bc1p,
                        const float* __restrict__ bc2p, const float* __restrict__ lrp, Hyper h) {
  const float s = round_to<P>(*scale);
  const bool clip = s != 1.0f;           // a multiply by 1 leaves the grad as it is
  const float bc1 = *bc1p, bc2 = *bc2p, lr = *lrp;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_vec = vec ? n / kVec : 0;
  for (long long i = first; i < n_vec; i += stride) {
    const long long o = i * kVec;
    float gg[kVec], mm[kVec], vv[kVec], ww[kVec];
    load8(g + o, gg);
    load8(m + o, mm);
    load8(v + o, vv);
    load8(w + o, ww);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      gg[k] = round_to<P>(__fmul_rn(gg[k], s));
      adamw_elem(gg[k], mm[k], vv[k], ww[k], bc1, bc2, lr, h);
    }
    if (clip) store8(g + o, gg);
    store8(m + o, mm);
    store8(v + o, vv);
    store8(w + o, ww);
    store8(p + o, ww);
  }
  for (long long i = n_vec * kVec + first; i < n; i += stride) {
    const float gi = round_to<P>(__fmul_rn(to_f32(g[i]), s));
    float mi = to_f32(m[i]), vi = to_f32(v[i]), wi = w[i];
    adamw_elem(gi, mi, vi, wi, bc1, bc2, lr, h);
    if (clip) g[i] = from_f32<P>(gi);
    m[i] = from_f32<M>(mi);
    v[i] = from_f32<M>(vi);
    w[i] = wi;
    p[i] = from_f32<P>(wi);
  }
}

// Blocks of kThreads that fill the card with `kernel` at once: a
// grid-stride loop needs no more.
template <typename K>
long long resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 132;
  return static_cast<long long>(sms) * std::max(per_sm, 1);
}

template <typename P, typename M>
int launch_update(void* g, void* m, void* v, void* w, void* p, long long n, const float* scale,
                  const float* bc1, const float* bc2, const float* lr, Hyper h, cudaStream_t s) {
  const bool vec = ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
                     reinterpret_cast<uintptr_t>(p)) % 16) == 0;
  const long long work = vec ? std::max(n / kVec, n % kVec) : n;
  const long long blocks = std::min((work + kThreads - 1) / kThreads,
                                    resident_blocks(adamw_update_kernel<P, M>));
  adamw_update_kernel<P, M><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<P*>(g), static_cast<M*>(m), static_cast<M*>(v), static_cast<float*>(w),
      static_cast<P*>(p), n, vec, scale, bc1, bc2, lr, h);
  return cudaGetLastError();
}

template <typename P>
int dispatch_moment(int moment_dtype, void* g, void* m, void* v, void* w, void* p, long long n,
                    const float* scale, const float* bc1, const float* bc2, const float* lr,
                    Hyper h, cudaStream_t s) {
  switch (moment_dtype) {
    case kF32: return launch_update<P, float>(g, m, v, w, p, n, scale, bc1, bc2, lr, h, s);
    case kBF16: return launch_update<P, __nv_bfloat16>(g, m, v, w, p, n, scale, bc1, bc2, lr, h, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Sums of squares of `n_leaves` grad leaves described by `table` (device,
// int64 rows of kTableCols: address, elements, first chunk, dtype 0 f32 /
// 1 bf16 / 2 f16; first chunks ascending, each leaf owning
// ceil(elements / chunk) chunks, `n_chunks` in all).  `partials` holds
// n_chunks floats of scratch; `sums` gets each leaf's sum, then their sum.
extern "C" int repro_adamw_sumsq(const void* table, int n_leaves, long long n_chunks,
                                 long long chunk, void* partials, void* sums, void* stream) {
  if (n_leaves <= 0 || n_chunks < 0 || chunk <= 0 || chunk % kVec != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(table);
  float* part = static_cast<float*>(partials);
  if (n_chunks > 0) {
    const long long blocks = std::min(n_chunks, resident_blocks(sumsq_kernel));
    sumsq_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(t, n_leaves, n_chunks, chunk,
                                                                    part);
    const int err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sumsq_finish_kernel<<<1, kFinishThreads, 0, s>>>(t, n_leaves, n_chunks, part,
                                                   static_cast<float*>(sums));
  return cudaGetLastError();
}

// One leaf's AdamW update in place: g (the grad, clipped in place where
// the scale in its type is not 1), m and v (moments), w (f32 master) and
// p (the param), `n` elements each, contiguous.  param_dtype (also the
// grad's): 0 f32, 1 bf16, 2 f16; moment_dtype: 0 f32, 1 bf16.  scale,
// bc1, bc2, lr: f32 device scalars.
extern "C" int repro_adamw_update(void* g, void* m, void* v, void* w, void* p, long long n,
                                  int param_dtype, int moment_dtype, const void* scale,
                                  const void* bc1, const void* bc2, const void* lr, float b1,
                                  float omb1, float b2, float omb2, float eps, float wd,
                                  void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* c1 = static_cast<const float*>(bc1);
  const float* c2 = static_cast<const float*>(bc2);
  const float* l = static_cast<const float*>(lr);
  switch (param_dtype) {
    case kF32: return dispatch_moment<float>(moment_dtype, g, m, v, w, p, n, sc, c1, c2, l, h, s);
    case kBF16:
      return dispatch_moment<__nv_bfloat16>(moment_dtype, g, m, v, w, p, n, sc, c1, c2, l, h, s);
    case kF16: return dispatch_moment<__half>(moment_dtype, g, m, v, w, p, n, sc, c1, c2, l, h, s);
    default: return cudaErrorInvalidValue;
  }
}
