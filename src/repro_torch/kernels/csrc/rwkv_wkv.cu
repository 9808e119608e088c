// RWKV6 WKV recurrence for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv_wkv.py (wkv_bhsd,
// body _kernel).  Per (b, h), with an f32 state S[key i][value j] of
// hd x hd, for t = 0 .. S-1:
//
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// r/k/v/w/out are [B*H, S, hd], u is [H, hd] and s0/sT are [B*H, hd, hd],
// all contiguous.  r, k and v share one type (f32 or bf16), w has its own
// (f32 or bf16): the model's decay is f32 under bf16 activations, and
// rounding it to bf16 would change the result.  Every input is read in its
// own type and upcast to f32, as the TPU kernel does; out is written in r's
// type and sT in f32.  Nothing is clamped: the model clamps w before the
// call.  Built without --use_fast_math, so denormal state entries left by
// long decays are kept (no flush to zero).
//
// Bound at the main-path shape (one rwkv6_1b6 prefill layer: B=2, S=4096,
// H=32, hd=64, bf16 r/k/v/out and f32 w): about 5*hd^2 f32 operations per
// (b, h, t) -- hd^2 FMAs for r.S and one multiply and one FMA per element
// for the update -- 5.37 GFLOP, 0.080 ms at the H100 SXM's 67 TFLOP/s f32 on
// the CUDA cores (spec sheet, 700 W); the 201 MB of r/k/v/w/out take 0.060
// ms at 3.35 TB/s.  So it is bound by operations.
//
// Design.  This first version is simple and right, not fast.
// * The TPU kernel's sequential chunk axis (state carried in VMEM between
//   grid steps) becomes the time loop inside one block: one block per
//   (b, h), with hd threads.  Thread j owns value column j of the state in
//   registers (hd floats; HD is a template parameter so the column stays
//   in registers), so the recurrence needs no reduction across threads.
// * At each step the block stages r_t, k_t and w_t (upcast to f32) in
//   shared memory, which every thread then reads as broadcasts; v_t[j]
//   stays in thread j's register.  u is staged once.  The staging buffers
//   are double-buffered, so one __syncthreads per step suffices, and each
//   thread loads step t+1 from device memory while it computes step t.
// * There is no chunk restriction: any S >= 1 runs, and S = 1 is one
//   decode step with s0 the cache's state.  sT is a separate output, so
//   a caller may not pass the same buffer as s0 and sT.
// * At the main path's B*H = 64 blocks of 64 threads the card runs far
//   below its bound: 64 of 132 SMs hold one block of two warps each.  A
//   chunked formulation on the tensor cores and more blocks than B*H are
//   later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(HD)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const TW* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sT,
               int heads, int seq) {
  __shared__ __align__(16) float r_s[2][HD];
  __shared__ __align__(16) float k_s[2][HD];
  __shared__ __align__(16) float w_s[2][HD];
  __shared__ __align__(16) float u_s[HD];

  const int j = threadIdx.x;
  const size_t bh = blockIdx.x;
  const size_t base = bh * static_cast<size_t>(seq) * HD + j;   // (bh, t=0, j)
  const float* s0_bh = s0 + bh * HD * HD + j;

  float state[HD];                       // column j: state[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < HD; ++i) state[i] = s0_bh[i * HD];
  u_s[j] = u[(bh % heads) * HD + j];

  float rn = to_f32(r[base]), kn = to_f32(k[base]), vn = to_f32(v[base]), wn = to_f32(w[base]);
  for (int t = 0; t < seq; ++t) {
    const int buf = t & 1;
    r_s[buf][j] = rn;
    k_s[buf][j] = kn;
    w_s[buf][j] = wn;
    const float vt = vn;
    // Also orders the u_s store before its first read.  The other buffer
    // is free: every thread finished step t-1 before this barrier.
    __syncthreads();
    if (t + 1 < seq) {                   // step t+1's loads overlap step t
      const size_t nxt = base + static_cast<size_t>(t + 1) * HD;
      rn = to_f32(r[nxt]);
      kn = to_f32(k[nxt]);
      vn = to_f32(v[nxt]);
      wn = to_f32(w[nxt]);
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = k_s[buf][i] * vt;
      acc += r_s[buf][i] * (state[i] + u_s[i] * kv);
      state[i] = state[i] * w_s[buf][i] + kv;
    }
    store(out + base + static_cast<size_t>(t) * HD, acc);
  }

  float* sT_bh = sT + bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) sT_bh[i * HD] = state[i];
}

template <typename T, typename TW, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* s0, void* out, float* sT, int bh, int heads, int seq,
                   cudaStream_t stream) {
  wkv_fwd_kernel<T, TW, HD><<<bh, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, s0, static_cast<T*>(out), sT, heads, seq);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t dispatch_hd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* s0, void* out, float* sT, int bh,
                        int heads, int seq, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, TW, 8>(r, k, v, w, u, s0, out, sT, bh, heads, seq, stream);
    case 16: return launch<T, TW, 16>(r, k, v, w, u, s0, out, sT, bh, heads, seq, stream);
    case 32: return launch<T, TW, 32>(r, k, v, w, u, s0, out, sT, bh, heads, seq, stream);
    case 64: return launch<T, TW, 64>(r, k, v, w, u, s0, out, sT, bh, heads, seq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v [bh, seq, hd] of one type (bf16_rkv ? bf16 : f32), w [bh, seq, hd]
// (bf16_w ? bf16 : f32), u [heads, hd] f32, s0 [bh, hd, hd] f32; writes out
// [bh, seq, hd] in r's type and sT [bh, hd, hd] f32.  All contiguous, on one
// device; sT must not alias s0.  Launches on `stream` and does not
// synchronise; returns the cudaError_t of the launch.
extern "C" int repro_wkv_fwd(const void* r, const void* k, const void* v, const void* w,
                             const void* u, const void* s0, void* out, void* sT, int bh,
                             int heads, int seq, int hd, int bf16_rkv, int bf16_w,
                             void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || seq <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  if (bf16_rkv) {
    if (bf16_w)
      return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, uf, s0f, out, sTf, bh, heads,
                                                       seq, hd, s);
    return dispatch_hd<__nv_bfloat16, float>(r, k, v, w, uf, s0f, out, sTf, bh, heads, seq, hd, s);
  }
  if (bf16_w)
    return dispatch_hd<float, __nv_bfloat16>(r, k, v, w, uf, s0f, out, sTf, bh, heads, seq, hd, s);
  return dispatch_hd<float, float>(r, k, v, w, uf, s0f, out, sTf, bh, heads, seq, hd, s);
}
