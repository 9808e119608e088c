// RWKV6 WKV recurrence for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv_wkv.py (wkv_bhsd,
// body _kernel).  Per (b, h), with an f32 state S[key i][value j] of
// hd x hd, for t = 0 .. S-1:
//
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// r/k/v/w/out are [B, H, S, hd] given by their strides (elements) over B,
// H and S, one set for r/k/v/w and one for out, with a unit stride over
// hd: the model's [B, S, H, hd] tensors are read and written in place,
// without a transposing copy.
// u is [H, hd] f32 and s0/sT are [B, H, hd, hd] f32, contiguous.  r, k and
// v share one type (f32 or bf16), w has its own (f32 or bf16): the model's
// decay is f32 under bf16 activations, and rounding it to bf16 would
// change the result.  Every input is read in its own type and upcast to
// f32, as the TPU kernel does; out is written in r's type and sT in f32.
// Nothing is clamped and any w in [0, 1] is taken: the model clamps w
// before the call.  Built without --use_fast_math, so denormal state
// entries left by long decays are kept (no flush to zero).  sT must not
// alias s0.
//
// Bound at the main-path shape (one rwkv6_1b6 prefill layer: B=2, S=4096,
// H=32, hd=64, bf16 r/k/v/out and f32 w): about 5*hd^2 f32 operations per
// (b, h, t) -- hd^2 FMAs for r.S and one multiply and one FMA per element
// for the update -- 5.37 GFLOP, 0.080 ms at the H100 SXM's 67 TFLOP/s f32 on
// the CUDA cores (spec sheet, 700 W); the 201 MB of r/k/v/w/out take 0.060
// ms at 3.35 TB/s.  So it is bound by operations.  Two kernels compute the
// function; the wrapper picks one, and neither falls back to the other:
//
// * wkv_fwd_chunked_kernel (repro_wkv_fwd_chunked): bf16 r/k/v at hd 64,
//   f32 or bf16 w; chunks of 16 steps on the tensor cores.  Every rwkv6_1b6
//   bf16 prefill layer runs it.
// * wkv_fwd_kernel (repro_wkv_fwd): every dtype at hd 8-64, one step at a
//   time on the CUDA cores.  It serves f32 calls, hd below 64, and the S=1
//   decode step.
//
// The chunked kernel.  The sequential kernel is a latency chain: one block
// of hd threads per (b, h) walks the S steps, each a chain of hd dependent
// FMAs behind a barrier and a load, about 1100 cycles a step; 64 blocks of
// two warps leave half the card idle.  The chunked kernel shortens the
// chain 16-fold and fills the card:
// * Value columns are independent (column j of S evolves from v[:, j]
//   alone), so one block owns one (b, h) and a slice of kNV = 32 value
//   columns, with one consumer warp per 16 columns: B*H*2 = 128 blocks at
//   the main shape, one per SM, each preparing its chunks for two consumer
//   warps.  Slices of 16 (256 blocks, two per SM) prepare every chunk four
//   times per head, and the preparation sets the pace, so they were slower
//   (PERF.md).
//   The blocks of one (b, h) are adjacent in blockIdx and read the same
//   r/k/w tiles from L2 at about the same time.
// * Time runs in chunks of C = 16 steps.  With P_t = prod_{s<t} w_s and
//   E_b = prod_{b<s<16} w_s inside the chunk (exclusive running products,
//   both <= 1):
//     out_t = (r_t * P_t) . S + sum_{b<=t} A[t][b] v_b
//     A[t][b] = sum_i r_t[i] k_b[i] prod_{b<s<t} w_s[i]  (b < t),
//     A[t][t] = sum_i r_t[i] u[i] k_t[i]                 (the bonus)
//     S' = diag(P_16) S + sum_b (k_b * E_b) v_b^T
//   The state chain is S/16 steps long; each is a few tensor-core products
//   inside one consumer warp.  A chunk of 64 with 16-step sub-chunks would shorten
//   it to S/64 but needs the off-diagonal sub-chunk blocks of A as extra
//   products over all hd keys: per 16 steps and 16 value columns the
//   chunk of 16 does about half the tensor work, so it is kept.
// * The state slice lives in the consumer warp's registers as the
//   accumulators of S^T (16 values x 64 keys, m16n8k16 layout), which are,
//   pair by pair, the A-operand fragments of the next chunk's cross
//   product O^T = S^T (r*P)^T: the state never goes through shared memory
//   and is written to sT once, at the end.
// * Tensor cores: mma.sync.m16n8k16 bf16 with f32 accumulators, operands
//   from ldmatrix (V^T and k*E with the transpose bit).  wgmma's 64-row
//   tiles do not fit a 16-row state slice, and the tensor work is small.
// * Numerics: no f32 operand is rounded to bf16 once.  Each f32 operand is
//   split into bf16 parts (hi = bf16(x), lo = bf16(x - hi), a third from
//   what is left) and the partial products that reach f32 precision are
//   summed in f32: the cross product takes S (hi, lo) x r*P (hi, lo)
//   without lo x lo, A . V takes A's hi and lo against exact bf16 v, and
//   the update takes k*E in three parts against v.  One bf16 rounding of
//   each misses the state limit by about 350-580x and the out limit by
//   about 60-200x; two parts of k*E take 0.4-1.5 of the state limit
//   (tests/test_torch_wkv_numerics.py rehearses this arithmetic).  Decays
//   are products of w only: no log, no division, no clamp; products of
//   factors <= 1 underflow only where the true value does.
// * The diagonal 16 x 16 block of A and the bonus run on the CUDA cores, as
//   direct running products of w per (row b, group of 4 keys), then a sum
//   over the 16 groups by warp shuffles.  A thread takes rows b and 15 - b,
//   so every thread walks 15 steps, and reads r_t and w_t once for both;
//   row b < 8 is the only one that can be active in the first 8 steps and
//   is always active in the last 8, so each half tests one row.
// * Work split: four preparation warps, one producer warp and two
//   consumer warps.  The producer issues cp.async loads of r, k, w and the
//   v slice into a three-stage ring (zero-filled past S), waits for the
//   next chunk's and releases it to the preparation warps by a named
//   barrier.  Those turn chunk p+1 into the bf16 parts of r*P and k*E, then
//   of A, while the consumers run chunk p's products; one block barrier a
//   chunk.  No barrier waits on a copy's transaction count, so a lost copy
//   cannot hang the card.
// * Shared memory is read into registers before anything is stored, no
//   array is indexed at run time (nothing goes through local memory), and
//   values go to bf16 in pairs (F2FP on the ALUs, not F2F on the
//   conversion pipe).  The preparation warps set the pace; more of them,
//   or the decays on fewer threads, made the kernel slower, so the limit
//   is their instruction stream on the SM, not its latency (PERF.md).  The
//   consumer's 52 mma a chunk run as three independent accumulator
//   chains.
// * Ragged S: steps past S are loaded as zeros (r, k, v) and their w is
//   taken as 1, so they add nothing to S; their outputs are not stored.
//   Any S >= 1 runs.
//
// The sequential kernel.
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
//   decode step with s0 the cache's state.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Strides (elements) of the [B, H, S, hd] views of r/k/v/w/out.
struct Strides {
  long long b, h, s;
};

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(HD)
wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const TW* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sT,
               int heads, int seq, Strides st, Strides ost) {
  __shared__ __align__(16) float r_s[2][HD];
  __shared__ __align__(16) float k_s[2][HD];
  __shared__ __align__(16) float w_s[2][HD];
  __shared__ __align__(16) float u_s[HD];

  const int j = threadIdx.x;
  const size_t bh = blockIdx.x;
  // (b, h, t, j) of the inputs and of out, advanced one step at a time
  long long at = static_cast<long long>(bh / heads) * st.b +
                 static_cast<long long>(bh % heads) * st.h + j;
  long long oat = static_cast<long long>(bh / heads) * ost.b +
                  static_cast<long long>(bh % heads) * ost.h + j;
  const float* s0_bh = s0 + bh * HD * HD + j;

  float state[HD];                       // column j: state[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < HD; ++i) state[i] = s0_bh[i * HD];
  u_s[j] = u[(bh % heads) * HD + j];

  float rn = to_f32(r[at]), kn = to_f32(k[at]), vn = to_f32(v[at]), wn = to_f32(w[at]);
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
      at += st.s;
      rn = to_f32(r[at]);
      kn = to_f32(k[at]);
      vn = to_f32(v[at]);
      wn = to_f32(w[at]);
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = k_s[buf][i] * vt;
      acc += r_s[buf][i] * (state[i] + u_s[i] * kv);
      state[i] = state[i] * w_s[buf][i] + kv;
    }
    store(out + oat, acc);
    oat += ost.s;
  }

  float* sT_bh = sT + bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) sT_bh[i * HD] = state[i];
}

template <typename T, typename TW, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* s0, void* out, float* sT, int bh, int heads, int seq,
                   Strides st, Strides ost, cudaStream_t stream) {
  wkv_fwd_kernel<T, TW, HD><<<bh, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, s0, static_cast<T*>(out), sT, heads, seq, st, ost);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t dispatch_hd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* s0, void* out, float* sT, int bh,
                        int heads, int seq, int hd, Strides st, Strides ost,
                        cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, TW, 8>(r, k, v, w, u, s0, out, sT, bh, heads, seq, st, ost, stream);
    case 16: return launch<T, TW, 16>(r, k, v, w, u, s0, out, sT, bh, heads, seq, st, ost, stream);
    case 32: return launch<T, TW, 32>(r, k, v, w, u, s0, out, sT, bh, heads, seq, st, ost, stream);
    case 64: return launch<T, TW, 64>(r, k, v, w, u, s0, out, sT, bh, heads, seq, st, ost, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace


// ---------------------------------------------------------------------------
// The chunked tensor-core kernel (bf16 r/k/v, hd 64).
namespace {

constexpr int kHD = 64;                // keys (and values) per head
constexpr int kC = 16;                 // steps per chunk
constexpr int kNV = 32;                // value columns per block (two consumer warps)
constexpr int kStages = 3;             // load ring: chunks p+1 and p+2 in flight
constexpr int kPrepThreads = 128;      // four preparation warps
constexpr int kLd = kHD + 8;           // padded bf16 row of r*P and k*E: ldmatrix
                                       // rows 144 bytes apart hit distinct banks
constexpr int kALd = kC + 8;           // padded bf16 row of A
constexpr int kGroups = 16;            // key groups of 4 in the diagonal block of A

template <typename TW>
struct ChunkSmem {                     // byte offsets from a 16-aligned base
  static constexpr int kVLd = kNV + 8;  // padded bf16 row of the v slice
  // one load stage: r, k [C][HD] bf16, w [C][HD] TW, v [C][kVLd] bf16
  static constexpr int kR = 0;
  static constexpr int kK = kR + kC * kHD * 2;
  static constexpr int kW = kK + kC * kHD * 2;
  static constexpr int kV = kW + kC * kHD * static_cast<int>(sizeof(TW));
  static constexpr int kStage = kV + kC * kVLd * 2;
  // one preparation buffer: r*P in 2 parts, k*E in 3, A in 2, P_16
  static constexpr int kRp = 0;
  static constexpr int kKe = kRp + 2 * kC * kLd * 2;
  static constexpr int kA = kKe + 3 * kC * kLd * 2;
  static constexpr int kP16 = kA + 2 * kC * kALd * 2;
  static constexpr int kPrep = kP16 + kHD * 4;
  static constexpr int kLoads = 0;
  static constexpr int kPreps = kLoads + kStages * kStage;
  static constexpr int kU = kPreps + 2 * kPrep;
  static constexpr int kBytes = kU + kHD * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory through L2; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier of the preparation warps only (warps 0-3).
__device__ __forceinline__ void prep_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPrepThreads) : "memory");
}

// The producer warp (warp 4) arrives once a chunk's copies have landed;
// the preparation warps wait there before reading them.
__device__ __forceinline__ void loads_arrive() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(kPrepThreads + 32) : "memory");
}
__device__ __forceinline__ void loads_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kPrepThreads + 32) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// hi = bf16(x, y) and lo = bf16 of what hi leaves, as packed pairs.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

__device__ __forceinline__ void set_one(float* p) { *p = 1.f; }
__device__ __forceinline__ void set_one(__nv_bfloat16* p) { *p = __float2bfloat16(1.f); }

// Four consecutive values as f32, from 16 (f32) or 8 (bf16) aligned bytes.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  x[0] = __low2float(lo), x[1] = __high2float(lo), x[2] = __low2float(hi), x[3] = __high2float(hi);
}

// Sum a[0 .. 2M) over the 2M lanes of a lane group, M = 8: each stage
// keeps half of the entries and adds the partner lane's other half, so lane
// g ends with the sum of entry g in a[0].  M is a template parameter so
// every index is a constant and a stays in registers.
template <int M, int N>
__device__ __forceinline__ void butterfly(float (&a)[N], int g) {
  const bool up = g & M;
#pragma unroll
  for (int e = 0; e < M; ++e) {
    // select values, not elements: a conditional between two elements can
    // become a select between addresses, which puts a in local memory
    const float lo = a[e], hi = a[e + M];
    a[e] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, M);
  }
  if constexpr (M > 1) butterfly<M / 2>(a, g);
}

// Store x0 at p0 and x1 at p1, each in NPARTS bf16 parts, part q a plane
// `plane` elements after the first.  The two are converted as one pair:
// one value alone compiles to F2F, on the conversion pipe (16 results a
// clock per SM), a pair to F2FP on the ALUs.
template <int NPARTS>
__device__ __forceinline__ void store_split2(__nv_bfloat16* p0, __nv_bfloat16* p1, int plane,
                                             float x0, float x1) {
#pragma unroll
  for (int q = 0; q < NPARTS; ++q) {
    const __nv_bfloat162 part = __floats2bfloat162_rn(x0, x1);
    p0[q * plane] = __low2bfloat16(part);
    p1[q * plane] = __high2bfloat16(part);
    x0 -= __low2float(part);
    x1 -= __high2float(part);
  }
}

// preparation, producer and consumer warps
constexpr int kChunkedThreads = kPrepThreads + 32 + 32 * (kNV / 16);

template <typename TW>
__global__ void __launch_bounds__(kChunkedThreads)
wkv_fwd_chunked_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const TW* __restrict__ w,
                       const float* __restrict__ u, const float* __restrict__ s0,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ sT, int heads,
                       int seq, Strides st, Strides ost) {
  using L = ChunkSmem<TW>;
  constexpr int kSlices = kHD / kNV;
  extern __shared__ __align__(16) unsigned char smem[];
  float* u_s = reinterpret_cast<float*>(smem + L::kU);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool prep = tid < kPrepThreads;
  const bool producer = warp == kPrepThreads / 32;
  const int bh = blockIdx.x / kSlices;
  const int slice = blockIdx.x % kSlices;
  const int head = bh % heads;
  const long long base = static_cast<long long>(bh / heads) * st.b +
                         static_cast<long long>(head) * st.h;
  const long long obase = static_cast<long long>(bh / heads) * ost.b +
                          static_cast<long long>(head) * ost.h;
  const int n_chunks = (seq + kC - 1) / kC;

  auto stage = [&](int p) { return smem + L::kLoads + (p % kStages) * L::kStage; };
  auto prep_buf = [&](int p) { return smem + L::kPreps + (p & 1) * L::kPrep; };

  // cp.async of chunk p into its stage, by the producer warp; rows past S
  // are zero-filled.
  auto issue_loads = [&](int p) {
    unsigned char* sp = stage(p);
    const int t0 = p * kC;
    auto piece = [&](int dst_off, const void* src, int row) {
      cp_async16(smem_addr(sp + dst_off), src, t0 + row < seq ? 16 : 0);
    };
    auto row_off = [&](int row) {        // element offset of step t0 + row (0 past S)
      return base + static_cast<long long>(t0 + row < seq ? t0 + row : 0) * st.s;
    };
    for (int e = lane; e < kC * 8; e += 32) {            // r and k: 8 pieces a row
      const int row = e >> 3, c = e & 7;
      const long long off = row_off(row) + c * 8;
      piece(L::kR + (row * kHD + c * 8) * 2, r + off, row);
      piece(L::kK + (row * kHD + c * 8) * 2, k + off, row);
    }
    constexpr int kWPieces = kHD * static_cast<int>(sizeof(TW)) / 16;   // per row
    constexpr int kPer = 16 / static_cast<int>(sizeof(TW));
    for (int e = lane; e < kC * kWPieces; e += 32) {
      const int row = e / kWPieces, c = e % kWPieces;
      piece(L::kW + row * kHD * static_cast<int>(sizeof(TW)) + c * 16, w + row_off(row) + c * kPer,
            row);
    }
    constexpr int kVPieces = kNV / 8;
    for (int e = lane; e < kC * kVPieces; e += 32) {
      const int row = e / kVPieces, c = e % kVPieces;
      piece(L::kV + (row * L::kVLd + c * 8) * 2, v + row_off(row) + slice * kNV + c * 8, row);
    }
    cp_async_commit();
  };

  // Chunk p's loads -> bf16 parts of r*P, k*E and A, and P_16, in prep_buf(p),
  // by the preparation warps.  Shared memory is read into registers before
  // anything is stored: the compiler cannot move a load above a store to the
  // same array, so interleaving them would serialise every step on the
  // shared-memory latency.
  auto prepare = [&](int p) {
    unsigned char* sp = stage(p);
    const __nv_bfloat16* r_s = reinterpret_cast<const __nv_bfloat16*>(sp + L::kR);
    const __nv_bfloat16* k_s = reinterpret_cast<const __nv_bfloat16*>(sp + L::kK);
    TW* w_s = reinterpret_cast<TW*>(sp + L::kW);
    unsigned char* pb = prep_buf(p);
    __nv_bfloat16* rp = reinterpret_cast<__nv_bfloat16*>(pb + L::kRp);
    __nv_bfloat16* ke = reinterpret_cast<__nv_bfloat16*>(pb + L::kKe);
    __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(pb + L::kA);
    float* p16 = reinterpret_cast<float*>(pb + L::kP16);
    const int valid = min(kC, seq - p * kC);
    if (valid < kC) {                    // w past S is 1: those steps must not decay S
      for (int e = valid * kHD + tid; e < kC * kHD; e += kPrepThreads) set_one(w_s + e);
      prep_sync();
    }

    {                                    // one key per thread, forward or backward
      const bool fwd = tid < kHD;
      const int i = fwd ? tid : tid - kHD;
      const __nv_bfloat16* x_s = fwd ? r_s : k_s;
      float xv[kC], wv[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        xv[t] = to_f32(x_s[t * kHD + i]);
        wv[t] = to_f32(w_s[t * kHD + i]);
      }
      float run = 1.f;
      if (fwd) {                         // r_t * P_t, P_t = prod_{s<t} w_s
#pragma unroll
        for (int t = 0; t < kC; t += 2) {
          const float x0 = xv[t] * run;
          run *= wv[t];
          const float x1 = xv[t + 1] * run;
          run *= wv[t + 1];
          store_split2<2>(rp + t * kLd + i, rp + (t + 1) * kLd + i, kC * kLd, x0, x1);
        }
        p16[i] = run;
      } else {                           // k_b * E_b, E_b = prod_{b<s<C} w_s
#pragma unroll
        for (int b = kC - 1; b >= 0; b -= 2) {
          const float x1 = xv[b] * run;
          run *= wv[b];
          const float x0 = xv[b - 1] * run;
          run *= wv[b - 1];
          store_split2<3>(ke + (b - 1) * kLd + i, ke + b * kLd + i, kC * kLd, x0, x1);
        }
      }
    }

    // A by running products.  For row b and a group of 4 keys, x = k_b *
    // prod_{b<s<t} w_s and a[t] = r_t[g] . x[g] (t > b), the bonus at t = b,
    // 0 above the diagonal.  Thread (pair q, group g) takes rows b0 = q and
    // b1 = 15 - q, so every thread walks 15 steps, reading r_t and w_t once
    // for both rows; nothing is stored during the walk.  The 16 groups of a
    // pair are the 16 lanes of a half-warp: a butterfly of shuffles sums
    // them, leaving lane g with A[t = g][b0] and A[g][b1].
    {
      const int g = tid % kGroups, q = tid / kGroups;
      const int b0 = q, b1 = kC - 1 - q;
      float x0[4], x1[4], uq[4], rb[4];
      load4(u_s + 4 * g, uq);
      load4(k_s + b0 * kHD + 4 * g, x0);
      load4(k_s + b1 * kHD + 4 * g, x1);
      load4(r_s + b0 * kHD + 4 * g, rb);
      const float bonus0 = (rb[0] * uq[0] * x0[0] + rb[1] * uq[1] * x0[1]) +
                           (rb[2] * uq[2] * x0[2] + rb[3] * uq[3] * x0[3]);
      load4(r_s + b1 * kHD + 4 * g, rb);
      const float bonus1 = (rb[0] * uq[0] * x1[0] + rb[1] * uq[1] * x1[1]) +
                           (rb[2] * uq[2] * x1[2] + rb[3] * uq[3] * x1[3]);
      // b0 < C/2 <= b1: in the first half of the steps only row b0 can be
      // active, in the second half row b0 always is, so each half tests
      // one row at run time
      float a0[kC], a1[kC];
#pragma unroll
      for (int t = 0; t < kC / 2; ++t) {
        float rt[4], wt[4];
        load4(r_s + t * kHD + 4 * g, rt);
        load4(w_s + t * kHD + 4 * g, wt);
        const float dot0 = (rt[0] * x0[0] + rt[1] * x0[1]) + (rt[2] * x0[2] + rt[3] * x0[3]);
        a0[t] = t > b0 ? dot0 : t == b0 ? bonus0 : 0.f;
        a1[t] = 0.f;
        if (t > b0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x0[e] *= wt[e];
        }
      }
#pragma unroll
      for (int t = kC / 2; t < kC; ++t) {
        float rt[4], wt[4];
        load4(r_s + t * kHD + 4 * g, rt);
        load4(w_s + t * kHD + 4 * g, wt);
        a0[t] = (rt[0] * x0[0] + rt[1] * x0[1]) + (rt[2] * x0[2] + rt[3] * x0[3]);
        const float dot1 = (rt[0] * x1[0] + rt[1] * x1[1]) + (rt[2] * x1[2] + rt[3] * x1[3]);
        a1[t] = t > b1 ? dot1 : t == b1 ? bonus1 : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) x0[e] *= wt[e];
        if (t > b1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x1[e] *= wt[e];
        }
      }
      butterfly<kGroups / 2>(a0, g);
      butterfly<kGroups / 2>(a1, g);
      store_split2<2>(a_s + g * kALd + b0, a_s + g * kALd + b1, kC * kALd, a0[0], a1[0]);
    }
  };

  // The consumer warp's state: S^T[j][i] for its 16 value columns, as the
  // accumulators of 8 n-tiles over the keys.  Lane (g, tq) holds
  // S[nt][0..1] = (j = g, i = 8 nt + 2 tq + 0..1), S[nt][2..3] = (j = g + 8, ...).
  const int cw = warp - kPrepThreads / 32 - 1;
  const int g = lane >> 2, tq = lane & 3;
  const int j_blk = cw * 16;                       // first column within the slice
  const int j_col = slice * kNV + j_blk;           // first column within hd
  float S[8][4];
  if (producer) {
    issue_loads(0);
    if (n_chunks > 1) issue_loads(1);
    else cp_async_commit();
    cp_async_wait<1>();                            // chunk 0 has landed
    loads_arrive();
  } else if (prep) {
    if (tid < kHD) u_s[tid] = u[head * kHD + tid];
    loads_sync();                                  // chunk 0 and u_s visible
    prepare(0);
  } else {
    const float* s0_bh = s0 + static_cast<size_t>(bh) * kHD * kHD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nt + 2 * tq + (e & 1), j = j_col + g + 8 * (e >> 1);
        S[nt][e] = s0_bh[i * kHD + j];
      }
  }
  __syncthreads();

  for (int p = 0; p < n_chunks; ++p) {
    if (producer) {
      cp_async_wait<0>();                          // chunk p+1 has landed
      loads_arrive();
      if (p + 2 < n_chunks) issue_loads(p + 2);
      else cp_async_commit();
    } else if (prep) {
      loads_sync();
      if (p + 1 < n_chunks) prepare(p + 1);
    } else {
      const unsigned char* pb = prep_buf(p);
      const uint32_t rp = smem_addr(pb + L::kRp);
      const uint32_t ke = smem_addr(pb + L::kKe);
      const uint32_t a_s = smem_addr(pb + L::kA);
      const float* p16 = reinterpret_cast<const float*>(pb + L::kP16);
      const uint32_t v_s = smem_addr(stage(p) + L::kV);
      const int mi = lane >> 3, ri = lane & 7;

      // O^T[j][t] = S^T (r*P)^T: S's accumulators are the A fragments.
      // Rows t = ri + 8 (mi >> 1), keys 16 ks + 8 (mi & 1) of r*P; the
      // fragments of step ks + 1 load while step ks multiplies.
      auto rp_row = [&](int ks) {
        return rp + ((ri + 8 * (mi >> 1)) * kLd + 16 * ks + 8 * (mi & 1)) * 2;
      };
      // three accumulators, one per partial product, so each is a chain of
      // 4 dependent mma, not 12; summed once at the end
      float O[2][4] = {}, O_hl[2][4] = {}, O_lh[2][4] = {};
      uint32_t bh_[4], bl_[4];
      ldsm_x4(bh_, rp_row(0));
      ldsm_x4(bl_, rp_row(0) + kC * kLd * 2);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t s_hi[4], s_lo[4];
        split2(S[2 * ks][0], S[2 * ks][1], s_hi[0], s_lo[0]);
        split2(S[2 * ks][2], S[2 * ks][3], s_hi[1], s_lo[1]);
        split2(S[2 * ks + 1][0], S[2 * ks + 1][1], s_hi[2], s_lo[2]);
        split2(S[2 * ks + 1][2], S[2 * ks + 1][3], s_hi[3], s_lo[3]);
        uint32_t ch[4], cl[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) ch[x] = bh_[x], cl[x] = bl_[x];
        if (ks + 1 < 4) {
          ldsm_x4(bh_, rp_row(ks + 1));
          ldsm_x4(bl_, rp_row(ks + 1) + kC * kLd * 2);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(O[nt], s_hi, ch[2 * nt], ch[2 * nt + 1]);
          mma_bf16(O_hl[nt], s_hi, cl[2 * nt], cl[2 * nt + 1]);
          mma_bf16(O_lh[nt], s_lo, ch[2 * nt], ch[2 * nt + 1]);
        }
      }
      // V^T as the A operand: v slice rows b = ri + 8 (mi >> 1), columns
      // j_blk + 8 (mi & 1), transposed
      uint32_t vt[4];
      ldsm_x4_trans(vt, v_s + ((ri + 8 * (mi >> 1)) * L::kVLd + j_blk + 8 * (mi & 1)) * 2);
      {                                            // O^T += V^T A^T
        const uint32_t row = ((ri + 8 * (mi >> 1)) * kALd + 8 * (mi & 1)) * 2;
        uint32_t ah[4], al[4];
        ldsm_x4(ah, a_s + row);
        ldsm_x4(al, a_s + kC * kALd * 2 + row);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(O_hl[nt], vt, ah[2 * nt], ah[2 * nt + 1]);
          mma_bf16(O_lh[nt], vt, al[2 * nt], al[2 * nt + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) O[nt][e] += O_hl[nt][e] + O_lh[nt][e];
      // S^T = S^T diag(P_16) + V^T (k*E), k*E in three parts (least first);
      // rows b = ri + 8 (mi & 1), keys 16 np + 8 (mi >> 1), transposed
      auto ke_row = [&](int n) {         // n = 4 part + np, parts from the least
        return ke + (((2 - n / 4) * kC + ri + 8 * (mi & 1)) * kLd + 16 * (n % 4) +
                     8 * (mi >> 1)) * 2;
      };
      uint32_t kb[4];
      ldsm_x4_trans(kb, ke_row(0));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 d = *reinterpret_cast<const float2*>(p16 + 8 * nt + 2 * tq);
        S[nt][0] *= d.x;
        S[nt][1] *= d.y;
        S[nt][2] *= d.x;
        S[nt][3] *= d.y;
      }
#pragma unroll
      for (int n = 0; n < 12; ++n) {
        uint32_t cur[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) cur[x] = kb[x];
        if (n + 1 < 12) ldsm_x4_trans(kb, ke_row(n + 1));
        const int np = n % 4;
        mma_bf16(S[2 * np], vt, cur[0], cur[1]);
        mma_bf16(S[2 * np + 1], vt, cur[2], cur[3]);
      }
      // out[t][j]: lane holds (j = g, g + 8; t = 8 nt + 2 tq + 0..1),
      // converted in (t, t + 1) pairs
      const int t0 = p * kC;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int t = t0 + 8 * nt + 2 * tq;
          const __nv_bfloat162 o = __floats2bfloat162_rn(O[nt][e], O[nt][e + 1]);
          __nv_bfloat16* dst = out + obase + static_cast<long long>(t) * ost.s + j_col + g +
                               8 * (e >> 1);
          if (t < seq) dst[0] = __low2bfloat16(o);
          if (t + 1 < seq) dst[ost.s] = __high2bfloat16(o);
        }
    }
    __syncthreads();
  }

  if (!prep && !producer) {
    float* sT_bh = sT + static_cast<size_t>(bh) * kHD * kHD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * nt + 2 * tq + (e & 1), j = j_col + g + 8 * (e >> 1);
        sT_bh[i * kHD + j] = S[nt][e];
      }
  }
}

template <typename TW>
cudaError_t launch_chunked(const void* r, const void* k, const void* v, const void* w,
                           const float* u, const float* s0, void* out, float* sT, int bh,
                           int heads, int seq, Strides st, Strides ost, cudaStream_t stream) {
  constexpr int bytes = ChunkSmem<TW>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(wkv_fwd_chunked_kernel<TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv_fwd_chunked_kernel<TW><<<bh * (kHD / kNV), kChunkedThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const TW*>(w), u, s0,
      static_cast<__nv_bfloat16*>(out), sT, heads, seq, st, ost);
  return cudaGetLastError();
}

}  // namespace

// r/k/v/w: [batch, heads, seq, hd] at element strides (stride_b, stride_h,
// stride_s), out at (out_stride_b, out_stride_h, out_stride_s), each with
// a unit stride over hd; r/k/v/out of one type
// (bf16_rkv ? bf16 : f32), w bf16_w ? bf16 : f32; u [heads, hd] f32, s0
// and sT [batch, heads, hd, hd] f32 contiguous.  One device; sT must not
// alias s0.  Launches the sequential kernel on `stream` and does not
// synchronise; returns the cudaError_t of the launch.
extern "C" int repro_wkv_fwd(const void* r, const void* k, const void* v, const void* w,
                             const void* u, const void* s0, void* out, void* sT, int batch,
                             int heads, int seq, int hd, long long stride_b, long long stride_h,
                             long long stride_s, long long out_stride_b,
                             long long out_stride_h, long long out_stride_s, int bf16_rkv,
                             int bf16_w, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) return cudaErrorInvalidValue;
  const Strides st{stride_b, stride_h, stride_s};
  const Strides ost{out_stride_b, out_stride_h, out_stride_s};
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  if (bf16_rkv) {
    if (bf16_w)
      return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, uf, s0f, out, sTf, bh, heads,
                                                       seq, hd, st, ost, s);
    return dispatch_hd<__nv_bfloat16, float>(r, k, v, w, uf, s0f, out, sTf, bh, heads, seq, hd,
                                             st, ost, s);
  }
  if (bf16_w)
    return dispatch_hd<float, __nv_bfloat16>(r, k, v, w, uf, s0f, out, sTf, bh, heads, seq, hd,
                                             st, ost, s);
  return dispatch_hd<float, float>(r, k, v, w, uf, s0f, out, sTf, bh, heads, seq, hd, st, ost,
                                   s);
}

// The chunked kernel: as repro_wkv_fwd with bf16 r/k/v/out and hd 64.
// The bases of r/k/v/w and their strides in bytes must be multiples of 16
// (cp.async).
extern "C" int repro_wkv_fwd_chunked(const void* r, const void* k, const void* v, const void* w,
                                     const void* u, const void* s0, void* out, void* sT,
                                     int batch, int heads, int seq, int hd, long long stride_b,
                                     long long stride_h, long long stride_s,
                                     long long out_stride_b, long long out_stride_h,
                                     long long out_stride_s, int bf16_w, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || hd != kHD) return cudaErrorInvalidValue;
  const Strides st{stride_b, stride_h, stride_s};
  const Strides ost{out_stride_b, out_stride_h, out_stride_s};
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  if (bf16_w)
    return launch_chunked<__nv_bfloat16>(r, k, v, w, uf, s0f, out, sTf, bh, heads, seq, st, ost,
                                         s);
  return launch_chunked<float>(r, k, v, w, uf, s0f, out, sTf, bh, heads, seq, st, ost, s);
}

// Dynamic shared memory of one chunked block (bytes).
extern "C" int repro_wkv_chunked_smem_bytes(int bf16_w) {
  return bf16_w ? ChunkSmem<__nv_bfloat16>::kBytes : ChunkSmem<float>::kBytes;
}
