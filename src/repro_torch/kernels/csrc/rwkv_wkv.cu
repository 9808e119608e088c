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
//
// The backward kernel (wkv_bwd_kernel, repro_wkv_bwd).  The TPU kernel has
// no backward (JAX differentiates its jnp scan), so nothing is translated:
// it computes dr, dk, dv, dw, du and ds0 of the function above from the
// forward's inputs, dout and dsT, for every call the forward kernels take
// (f32 or bf16 r/k/v, f32 or bf16 w, hd 8-64, any S >= 1).  With S_t the
// state before step t and G_t = dL/dS_t (G_S = dsT):
//
//   dr_t[i] = sum_j S_t[i][j] dout_t[j] + u[i] k_t[i] (v_t . dout_t)
//   dk_t[i] = sum_j G_{t+1}[i][j] v_t[j] + u[i] r_t[i] (v_t . dout_t)
//   dv_t[j] = sum_i G_{t+1}[i][j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dout_t[j]
//   dw_t[i] = sum_j G_{t+1}[i][j] S_t[i][j]
//   du[i]   = sum_t r_t[i] k_t[i] (v_t . dout_t),   ds0 = G_0
//   G_t[i][j] = w_t[i] G_{t+1}[i][j] + r_t[i] dout_t[j]
//
// * Rows of S and of G, and columns of G, each evolve alone, so one thread
//   carries one row or one column in registers and a step needs no sum
//   across threads.  A block is one warp of 32 rows or 32 columns (hd of
//   them below hd 32); the grid is (b*h, row blocks then column blocks):
//   128 blocks at the training shape (B=1, H=32, hd 64), where the
//   sequential forward has 32.
// * A row block sweeps forward from s0 (dr, du, and its rows of S before
//   every 16th step written to a global scratch as checkpoints), then
//   backward from dsT chunk by chunk: it recomputes the chunk's 16 states
//   of its rows from their checkpoint into shared memory (a thread-private
//   column each) and reads them back in reverse for dw, next to dk.  Only
//   the thread that wrote a checkpoint reads it, so no barrier orders them.
//   A column block sweeps backward alone (dv, then ds0).  No atomics: du is
//   one partial per (b, h), summed over b by the wrapper, so two calls give
//   identical bits.
// * dw from the states themselves.  The identity
//   w_t dw_t = sum_{s>t} r_s.(S_s dout_s) - sum_{s>=t} k_s.(G_{s+1} v_s)
//   (plus the end terms) needs no stored states, but it subtracts sums over
//   up to S steps of f32-rounded terms and divides by w >= e^-8: at S=4096
//   its dw misses the limit more than 100-fold, where the recompute meets
//   it (tests/test_torch_wkv_bwd.py).  The checkpoints take
//   B*H*((S-1)/16)*hd^2*4 bytes: 134 MB at the training shape.
// * Each chunk of r, k, v, w and dout is staged into shared memory as f32,
//   with v.dout and sum_i r u k per step; the vectors every thread reads
//   whole (dout and v by rows, r, k and w by columns) come as float4
//   broadcasts.  Dots run as four partial sums.
// * Bound at the training shape (B=1, S=4096, H=32, hd 64, bf16 r/k/v/dout
//   and gradients, f32 w and dw): the function's work is one S recurrence,
//   one G recurrence and four hd-long dots a (row, step), 12 hd^2 f32
//   operations per (b, h, t): 6.4 GFLOP, 0.096 ms at 67 TFLOP/s; its 184 MB
//   take 0.055 ms at 3.35 TB/s, so it is bound by operations.  The kernel
//   runs S twice (the recompute) and G twice (rows and columns), and each
//   block is one warp walking a chain of S steps: latency, not throughput,
//   sets its time.  It serves f32 r/k/v, hd 8-32 and S < 16.
//
// The chunk-parallel backward (wkv_bwd_chain_kernel + wkv_bwd_chunk_kernel,
// repro_wkv_bwd_chunked): the same function for the calls the chunked
// forward takes (bf16 r/k/v at hd 64, f32 or bf16 w), every rwkv6_1b6
// training layer.  Its bound is the one above: 0.0962 ms of operations,
// 0.0554 ms of bytes at the training shape.  The "backward" kernel took
// 6.86 ms there (71x the bound): 128 blocks of one warp (one of an SM's four
// schedulers issues, stalling on every shared-memory load and FMA chain),
// each walking all 4096 steps three times in series, nothing on the tensor
// cores.  Here the only serial chains are S/16 chunks long.  With C = 16,
// P_t and E_b the exclusive products of w from a chunk's start and to its
// end, and P_end the whole chunk's:
// * Chains (wkv_bwd_chain_kernel, one launch for both): S_{c+1} =
//   diag(P_end) S_c + sum_b (k_b E_b) v_b^T forward and, with Ghat_c =
//   dL/dS after chunk c, Ghat_{c-1} = diag(P_end) Ghat_c + sum_t (r_t P_t)
//   dout_t^T backward from dsT, ending at ds0.  Both are the chunked
//   forward's state update: the same device functions, f32 a*F in three
//   bf16 parts against exact bf16 v or dout, f32 accumulators, decays as
//   products of w.  A block is one (b, h, 16 value columns, chain), so B=1
//   H=32 gives 256 blocks; each writes the value before every chunk to f32
//   scratch (2 x 134 MB at the training shape).
// * Chunks (wkv_bwd_chunk_kernel): a block of 16 warps walks 8 consecutive
//   chunks of one (b, h), the next chunk's r/k/v/w/dout tiles and its
//   S_c and Ghat_c entries in flight by cp.async.  Thread (row i, column
//   group) holds 8 entries of S and of G in registers.  S runs forward from
//   S_c to keep the states after steps 4, 8 and 12 (shared memory), then
//   each 4-step sub-chunk from the last recomputes its states into
//   registers and G walks back from Ghat_c: dr, dk, dw = rowsum(G_{t+1} *
//   S_t) (direct, not by suffix sums) and dv's partial products.  Row sums
//   are butterflies over the row's 8 lanes; dv's column sums are
//   butterflies over a warp's 4 rows, then the 16 warps' partials summed in
//   a fixed order in shared memory.  du is one partial per chunk, summed by
//   the wrapper.  No atomics: two calls give identical bits.
// * Steps past S read r/k/v/dout as 0 and w as 1, as in the forward.
// * Measured (PERF.md): the chunk kernel takes about three quarters of the
//   time.  At 128 registers (16 warps an SM) it is held by the latency of
//   its per-step chains (loads, dots, shuffles), not by issue slots or
//   shared-memory bandwidth: halving its barriers did not move it, and
//   neither did preparing the chains' chunks on four warps instead of two.
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


// ---------------------------------------------------------------------------
// The backward kernel (every dtype, hd 8-64).
namespace {

constexpr int kBwdChunk = 16;          // steps between state checkpoints

template <int HD>
struct BwdShape {
  static constexpr int kGroup = HD < 32 ? HD : 32;   // rows (or columns) a block: one warp
  static constexpr int kGroups = HD / kGroup;        // row blocks (and column blocks) a head
  // floats of dynamic shared memory: r, k, v, w, dout of one chunk
  // ([kBwdChunk][HD] each, f32), u [HD], v.dout and sum(r*u*k) [kBwdChunk],
  // then the row blocks' states of one chunk [kBwdChunk][HD][kGroup]
  static constexpr int kStage = 5 * kBwdChunk * HD;
  static constexpr int kFloats = kStage + HD + 2 * kBwdChunk + kBwdChunk * HD * kGroup;
  static constexpr int kBytes = kFloats * 4;
};

// sum_j a[j] * b[j] for a in registers and b in shared memory (16-byte
// aligned), in four partial sums
template <int HD>
__device__ __forceinline__ float dot(const float (&a)[HD], const float* b) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < HD; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(b + j);
    acc[0] = fmaf(a[j], q.x, acc[0]);
    acc[1] = fmaf(a[j + 1], q.y, acc[1]);
    acc[2] = fmaf(a[j + 2], q.z, acc[2]);
    acc[3] = fmaf(a[j + 3], q.w, acc[3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Loads steps t0 .. t0+n-1 of r, k, v, w and dout, upcast to f32, into
// shared memory, then v.dout and sum_i r*u*k of each step.  Every thread of
// the block calls it; it ends behind a barrier.
template <typename T, typename TW, int HD>
__device__ __forceinline__ void stage_chunk(float* sm, const T* __restrict__ r,
                                            const T* __restrict__ k, const T* __restrict__ v,
                                            const TW* __restrict__ w,
                                            const T* __restrict__ dout, long long in_base,
                                            long long do_base, Strides st, Strides dst, int t0,
                                            int n) {
  constexpr int G = BwdShape<HD>::kGroup;
  constexpr int kC = kBwdChunk * HD;
  float* r_s = sm;
  float* k_s = sm + kC;
  float* v_s = sm + 2 * kC;
  float* w_s = sm + 3 * kC;
  float* d_s = sm + 4 * kC;
  const float* u_s = sm + 5 * kC;
  float* vdo_s = sm + 5 * kC + HD;
  float* ruk_s = vdo_s + kBwdChunk;
#pragma unroll 4
  for (int e = threadIdx.x; e < n * HD; e += G) {
    const int tt = e / HD, j = e % HD;
    const long long at = in_base + static_cast<long long>(t0 + tt) * st.s + j;
    const long long dat = do_base + static_cast<long long>(t0 + tt) * dst.s + j;
    r_s[e] = to_f32(r[at]);
    k_s[e] = to_f32(k[at]);
    v_s[e] = to_f32(v[at]);
    w_s[e] = to_f32(w[at]);
    d_s[e] = to_f32(dout[dat]);
  }
  __syncthreads();
  for (int tt = threadIdx.x; tt < n; tt += G) {
    float vdo = 0.f, ruk = 0.f;
#pragma unroll 8
    for (int j = 0; j < HD; ++j) {
      vdo = fmaf(v_s[tt * HD + j], d_s[tt * HD + j], vdo);
      ruk = fmaf(r_s[tt * HD + j] * u_s[j], k_s[tt * HD + j], ruk);
    }
    vdo_s[tt] = vdo;
    ruk_s[tt] = ruk;
  }
  __syncthreads();
}

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(BwdShape<HD>::kGroup)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const TW* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ s0, const T* __restrict__ dout,
               const float* __restrict__ dsT, T* __restrict__ dr, T* __restrict__ dk,
               T* __restrict__ dv, TW* __restrict__ dw, float* __restrict__ du,
               float* __restrict__ ds0, float* __restrict__ ckpt, int heads, int seq,
               Strides st, Strides dst, Strides gst) {
  using Sh = BwdShape<HD>;
  constexpr int G = Sh::kGroup;
  constexpr int kC = kBwdChunk * HD;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* smem = reinterpret_cast<float*>(bwd_smem);
  const float* r_s = smem;
  const float* k_s = smem + kC;
  const float* v_s = smem + 2 * kC;
  const float* w_s = smem + 3 * kC;
  const float* d_s = smem + 4 * kC;
  float* u_s = smem + 5 * kC;
  const float* vdo_s = u_s + HD;
  const float* ruk_s = vdo_s + kBwdChunk;
  float* hist = u_s + HD + 2 * kBwdChunk;

  const int lane = threadIdx.x;
  const size_t bh = blockIdx.x;
  const int b = static_cast<int>(bh / heads), h = static_cast<int>(bh % heads);
  const long long in_base = b * st.b + h * st.h;
  const long long do_base = b * dst.b + h * dst.h;
  const long long g_base = b * gst.b + h * gst.h;
  const bool rows = blockIdx.y < Sh::kGroups;
  const int idx = (rows ? blockIdx.y : blockIdx.y - Sh::kGroups) * G + lane;
  const int nch = (seq + kBwdChunk - 1) / kBwdChunk;
  const float* s0_bh = s0 + bh * HD * HD;
  const float* dsT_bh = dsT ? dsT + bh * HD * HD : nullptr;
  for (int j = lane; j < HD; j += G) u_s[j] = u[h * HD + j];   // read after a barrier
  auto stage = [&](int c) {
    stage_chunk<T, TW, HD>(smem, r, k, v, w, dout, in_base, do_base, st, dst, c * kBwdChunk,
                           min(kBwdChunk, seq - c * kBwdChunk));
  };

  if (rows) {
    // Row i of the state and of its gradient evolve alone.
    const int i = idx;
    const float ui = u[h * HD + i];
    // checkpoint c (the state before step c * kBwdChunk, c >= 1) of row i,
    // stored [c][j][i] so that a warp's stores are adjacent
    float* ck = ckpt + bh * static_cast<size_t>(nch - 1) * HD * HD + i;

    // Forward sweep: the state from s0; dr, du and the checkpoints.
    float S[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) S[j] = s0_bh[i * HD + j];
    float du_acc = 0.f;
    for (int c = 0; c < nch; ++c) {
      if (c > 0) {
#pragma unroll
        for (int j = 0; j < HD; ++j) ck[(static_cast<size_t>(c - 1) * HD + j) * HD] = S[j];
      }
      stage(c);
      const int t0 = c * kBwdChunk, n = min(kBwdChunk, seq - t0);
      for (int tt = 0; tt < n; ++tt) {
        const float ri = r_s[tt * HD + i], ki = k_s[tt * HD + i], wi = w_s[tt * HD + i];
        const float vdo = vdo_s[tt];
        const float sdo = dot<HD>(S, d_s + tt * HD);
        store(dr + g_base + static_cast<long long>(t0 + tt) * gst.s + i, fmaf(ui * ki, vdo, sdo));
        du_acc = fmaf(ri * ki, vdo, du_acc);
        const float* vt = v_s + tt * HD;
#pragma unroll
        for (int j = 0; j < HD; ++j) S[j] = fmaf(S[j], wi, ki * vt[j]);
      }
      __syncthreads();                   // the next chunk overwrites the stage
    }
    du[bh * HD + i] = du_acc;

    // Backward sweep, chunk by chunk from the last: the chunk's states
    // recomputed from its checkpoint into shared memory, then dk and dw
    // with G (row i of dL/dS after the step) carried back from dsT.
    float Gr[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) Gr[j] = dsT_bh ? dsT_bh[i * HD + j] : 0.f;
    float* my_hist = hist + lane;        // [tt][j][lane]: thread-private column
    for (int c = nch - 1; c >= 0; --c) {
      stage(c);
      const int t0 = c * kBwdChunk, n = min(kBwdChunk, seq - t0);
      {
        float Sx[HD];
#pragma unroll
        for (int j = 0; j < HD; ++j)
          Sx[j] = c == 0 ? s0_bh[i * HD + j] : ck[(static_cast<size_t>(c - 1) * HD + j) * HD];
        for (int tt = 0; tt < n; ++tt) {
#pragma unroll
          for (int j = 0; j < HD; ++j) my_hist[(tt * HD + j) * G] = Sx[j];
          const float ki = k_s[tt * HD + i], wi = w_s[tt * HD + i];
          const float* vt = v_s + tt * HD;
#pragma unroll
          for (int j = 0; j < HD; ++j) Sx[j] = fmaf(Sx[j], wi, ki * vt[j]);
        }
      }
      for (int tt = n - 1; tt >= 0; --tt) {
        const float ri = r_s[tt * HD + i], wi = w_s[tt * HD + i];
        const float* ht = my_hist + tt * HD * G;
        float dwa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < HD; ++j) dwa[j & 3] = fmaf(Gr[j], ht[j * G], dwa[j & 3]);
        const float gv = dot<HD>(Gr, v_s + tt * HD);
        const long long at = g_base + static_cast<long long>(t0 + tt) * gst.s + i;
        store(dk + at, fmaf(ui * ri, vdo_s[tt], gv));
        store(dw + at, (dwa[0] + dwa[1]) + (dwa[2] + dwa[3]));
        const float* dt = d_s + tt * HD;
#pragma unroll
        for (int j = 0; j < HD; ++j) Gr[j] = fmaf(wi, Gr[j], ri * dt[j]);
      }
      __syncthreads();
    }
  } else {
    // Column j of G evolves alone: dv, then ds0 = G before step 0.
    const int j = idx;
    float Gc[HD];
#pragma unroll
    for (int i = 0; i < HD; ++i) Gc[i] = dsT_bh ? dsT_bh[i * HD + j] : 0.f;
    for (int c = nch - 1; c >= 0; --c) {
      stage(c);
      const int t0 = c * kBwdChunk, n = min(kBwdChunk, seq - t0);
      for (int tt = n - 1; tt >= 0; --tt) {
        const float dj = d_s[tt * HD + j];
        const float gk = dot<HD>(Gc, k_s + tt * HD);
        store(dv + g_base + static_cast<long long>(t0 + tt) * gst.s + j, fmaf(ruk_s[tt], dj, gk));
        const float* rt = r_s + tt * HD;
        const float* wt = w_s + tt * HD;
#pragma unroll
        for (int i = 0; i < HD; ++i) Gc[i] = fmaf(wt[i], Gc[i], rt[i] * dj);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < HD; ++i) ds0[bh * HD * HD + i * HD + j] = Gc[i];
  }
}

template <typename T, typename TW, int HD>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const void* w,
                       const float* u, const float* s0, const void* dout, const float* dsT,
                       void* dr, void* dk, void* dv, void* dw, float* du, float* ds0,
                       float* ckpt, int bh, int heads, int seq, Strides st, Strides dst,
                       Strides gst, cudaStream_t stream) {
  using Sh = BwdShape<HD>;
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_kernel<T, TW, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Sh::kBytes);
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<T, TW, HD><<<dim3(bh, 2 * Sh::kGroups), Sh::kGroup, Sh::kBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, s0, static_cast<const T*>(dout), dsT, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<TW*>(dw), du, ds0, ckpt, heads,
      seq, st, dst, gst);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t dispatch_bwd(int hd, const void* r, const void* k, const void* v, const void* w,
                         const float* u, const float* s0, const void* dout, const float* dsT,
                         void* dr, void* dk, void* dv, void* dw, float* du, float* ds0,
                         float* ckpt, int bh, int heads, int seq, Strides st, Strides dst,
                         Strides gst, cudaStream_t s) {
  switch (hd) {
    case 8: return launch_bwd<T, TW, 8>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0,
                                        ckpt, bh, heads, seq, st, dst, gst, s);
    case 16: return launch_bwd<T, TW, 16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0,
                                          ckpt, bh, heads, seq, st, dst, gst, s);
    case 32: return launch_bwd<T, TW, 32>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0,
                                          ckpt, bh, heads, seq, st, dst, gst, s);
    case 64: return launch_bwd<T, TW, 64>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0,
                                          ckpt, bh, heads, seq, st, dst, gst, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The backward: dr, dk, dv (r's type), dw (w's type), du [batch, heads,
// hd] f32 (one partial per batch row, to be summed over it) and ds0
// [batch, heads, hd, hd] f32 of repro_wkv_fwd's function, for the output
// gradient dout (r's type, [B, H, S, hd] at its own strides, unit stride
// over hd) and the final state's dsT (f32 [B, H, hd, hd] contiguous, or
// null for zero).  r/k/v/w as in repro_wkv_fwd (strides stride_*); the four
// gradients of [B, H, S, hd] share the strides grad_stride_*.  ckpt is f32
// scratch of batch * heads * ((seq - 1) / 16) * hd * hd floats.  Launches
// on `stream` and does not synchronise; returns the cudaError_t.
extern "C" int repro_wkv_bwd(const void* r, const void* k, const void* v, const void* w,
                             const void* u, const void* s0, const void* dout, const void* dsT,
                             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                             void* ckpt, int batch, int heads, int seq, int hd,
                             long long stride_b, long long stride_h, long long stride_s,
                             long long dout_stride_b, long long dout_stride_h,
                             long long dout_stride_s, long long grad_stride_b,
                             long long grad_stride_h, long long grad_stride_s, int bf16_rkv,
                             int bf16_w, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0) return cudaErrorInvalidValue;
  const Strides st{stride_b, stride_h, stride_s};
  const Strides dst{dout_stride_b, dout_stride_h, dout_stride_s};
  const Strides gst{grad_stride_b, grad_stride_h, grad_stride_s};
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  const float* dsTf = static_cast<const float*>(dsT);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  float* ckf = static_cast<float*>(ckpt);
  if (bf16_rkv) {
    if (bf16_w)
      return dispatch_bwd<__nv_bfloat16, __nv_bfloat16>(hd, r, k, v, w, uf, s0f, dout, dsTf, dr,
                                                        dk, dv, dw, duf, ds0f, ckf, bh, heads,
                                                        seq, st, dst, gst, s);
    return dispatch_bwd<__nv_bfloat16, float>(hd, r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv,
                                              dw, duf, ds0f, ckf, bh, heads, seq, st, dst, gst,
                                              s);
  }
  if (bf16_w)
    return dispatch_bwd<float, __nv_bfloat16>(hd, r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv,
                                              dw, duf, ds0f, ckf, bh, heads, seq, st, dst, gst,
                                              s);
  return dispatch_bwd<float, float>(hd, r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv, dw, duf,
                                    ds0f, ckf, bh, heads, seq, st, dst, gst, s);
}

// Dynamic shared memory of one backward block (bytes) at head dim hd.
extern "C" int repro_wkv_bwd_smem_bytes(int hd) {
  switch (hd) {
    case 8: return BwdShape<8>::kBytes;
    case 16: return BwdShape<16>::kBytes;
    case 32: return BwdShape<32>::kBytes;
    case 64: return BwdShape<64>::kBytes;
    default: return -1;
  }
}


// ---------------------------------------------------------------------------
// The chunk-parallel backward (bf16 r/k/v, hd 64): two chains, then chunks.
namespace {

// The chains.  One block per (b, h, kChainNV value columns, chain): the
// state chain S_{c+1} = diag(P_end) S_c + sum_b (k_b E_b) v_b^T forward over
// the chunks, or the gradient chain G_c' = diag(P_end) G_c + sum_t (r_t P_t)
// dout_t^T backward over them, each chunk's value written to a checkpoint
// before the chunk is applied.  The forward kernel's state update, with
// (a, F, b) = (k, E, v) or (r, P, dout): two preparation warps (one key a
// thread: the running product of w and a*F in three bf16 parts), a
// producer warp (cp.async ring) and one consumer warp (16 value columns in
// mma accumulators).
constexpr int kChainPrep = 64;                     // one key a thread
constexpr int kChainNV = 16;                       // value columns a block: one consumer warp
constexpr int kChainSlices = kHD / kChainNV;       // 4 blocks a (b, h) and chain
constexpr int kChainThreads = kChainPrep + 32 + 32;
constexpr int kChainStages = 6;                    // load ring: chunks p+1 .. p+5 in flight

template <typename TW>
struct ChainSmem {                                 // byte offsets from a 16-aligned base
  static constexpr int kBLd = kChainNV + 8;        // padded bf16 row of the b slice
  // one load stage: a [C][HD] bf16, w [C][HD] TW, b [C][kBLd] bf16
  static constexpr int kA = 0;
  static constexpr int kW = kA + kC * kHD * 2;
  static constexpr int kB = kW + kC * kHD * static_cast<int>(sizeof(TW));
  static constexpr int kStage = kB + kC * kBLd * 2;
  // one preparation buffer: a*F in 3 parts, P_end
  static constexpr int kAF = 0;
  static constexpr int kDec = kAF + 3 * kC * kLd * 2;
  static constexpr int kPrep = kDec + kHD * 4;
  static constexpr int kLoads = 0;
  static constexpr int kPreps = kLoads + kChainStages * kStage;
  static constexpr int kBytes = kPreps + 2 * kPrep;
};

__device__ __forceinline__ void chain_prep_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kChainPrep) : "memory");
}
__device__ __forceinline__ void chain_loads_arrive() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(kChainPrep + 32) : "memory");
}
__device__ __forceinline__ void chain_loads_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kChainPrep + 32) : "memory");
}

// One chain of one block: kGrad false is the state chain (a = k, b = v,
// from x0 = s0, first chunk first), true the gradient chain (a = r, b =
// dout, from x0 = dsT or zero, last chunk first; its end value, ds0, goes
// to xT).  ck receives [B*H][n_chunks][HD][HD] f32, the value before each
// chunk is applied.
template <typename TW, bool kGrad>
__device__ __forceinline__ void chain_body(unsigned char* smem, const __nv_bfloat16* __restrict__ a,
                                           const TW* __restrict__ w,
                                           const __nv_bfloat16* __restrict__ bm,
                                           const float* __restrict__ x0, float* __restrict__ ck,
                                           float* __restrict__ xT, int heads, int seq, Strides st,
                                           Strides bst, int blk) {
  using L = ChainSmem<TW>;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const bool prep = tid < kChainPrep;
  const bool producer = warp == kChainPrep / 32;
  const int bh = blk / kChainSlices;
  const int slice = blk % kChainSlices;
  const int head = bh % heads;
  const long long base = static_cast<long long>(bh / heads) * st.b +
                         static_cast<long long>(head) * st.h;
  const long long bbase = static_cast<long long>(bh / heads) * bst.b +
                          static_cast<long long>(head) * bst.h;
  const int n_chunks = (seq + kC - 1) / kC;
  auto chunk_of = [&](int p) { return kGrad ? n_chunks - 1 - p : p; };
  auto stage = [&](int p) { return smem + L::kLoads + (p % kChainStages) * L::kStage; };
  auto prep_buf = [&](int p) { return smem + L::kPreps + (p & 1) * L::kPrep; };

  // cp.async of the p-th chunk in chain order into its stage, by the
  // producer warp; rows past S are zero-filled
  auto issue_loads = [&](int p) {
    unsigned char* sp = stage(p);
    const int t0 = chunk_of(p) * kC;
    auto row_ok = [&](int row) { return t0 + row < seq; };
    auto row_t = [&](int row) { return static_cast<long long>(row_ok(row) ? t0 + row : 0); };
    for (int e = lane; e < kC * 8; e += 32) {            // a: 8 pieces a row
      const int row = e >> 3, c = e & 7;
      cp_async16(smem_addr(sp + L::kA + (row * kHD + c * 8) * 2),
                 a + base + row_t(row) * st.s + c * 8, row_ok(row) ? 16 : 0);
    }
    constexpr int kWPieces = kHD * static_cast<int>(sizeof(TW)) / 16;
    constexpr int kPer = 16 / static_cast<int>(sizeof(TW));
    for (int e = lane; e < kC * kWPieces; e += 32) {
      const int row = e / kWPieces, c = e % kWPieces;
      cp_async16(smem_addr(sp + L::kW + row * kHD * static_cast<int>(sizeof(TW)) + c * 16),
                 w + base + row_t(row) * st.s + c * kPer, row_ok(row) ? 16 : 0);
    }
    constexpr int kBPieces = kChainNV / 8;
    for (int e = lane; e < kC * kBPieces; e += 32) {
      const int row = e / kBPieces, c = e % kBPieces;
      cp_async16(smem_addr(sp + L::kB + (row * L::kBLd + c * 8) * 2),
                 bm + bbase + row_t(row) * bst.s + slice * kChainNV + c * 8, row_ok(row) ? 16 : 0);
    }
    cp_async_commit();
  };

  // The p-th chunk's loads -> the bf16 parts of a*F and P_end, one key a
  // thread; every register is loaded before anything is stored.
  auto prepare = [&](int p) {
    unsigned char* sp = stage(p);
    const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(sp + L::kA);
    TW* w_s = reinterpret_cast<TW*>(sp + L::kW);
    unsigned char* pb = prep_buf(p);
    __nv_bfloat16* af = reinterpret_cast<__nv_bfloat16*>(pb + L::kAF);
    float* dec = reinterpret_cast<float*>(pb + L::kDec);
    const int valid = min(kC, seq - chunk_of(p) * kC);
    if (valid < kC) {                    // w past S is 1: those steps must not decay
      for (int e = valid * kHD + tid; e < kC * kHD; e += kChainPrep) set_one(w_s + e);
      chain_prep_sync();
    }
    const int i = tid;
    float xv[kC], wv[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      xv[t] = to_f32(a_s[t * kHD + i]);
      wv[t] = to_f32(w_s[t * kHD + i]);
    }
    float run = 1.f;
    if (kGrad) {                         // r_t * P_t, P_t = prod_{s<t} w_s
#pragma unroll
      for (int t = 0; t < kC; t += 2) {
        const float x0v = xv[t] * run;
        run *= wv[t];
        const float x1v = xv[t + 1] * run;
        run *= wv[t + 1];
        store_split2<3>(af + t * kLd + i, af + (t + 1) * kLd + i, kC * kLd, x0v, x1v);
      }
    } else {                             // k_b * E_b, E_b = prod_{b<s<C} w_s
#pragma unroll
      for (int b = kC - 1; b >= 0; b -= 2) {
        const float x1v = xv[b] * run;
        run *= wv[b];
        const float x0v = xv[b - 1] * run;
        run *= wv[b - 1];
        store_split2<3>(af + (b - 1) * kLd + i, af + b * kLd + i, kC * kLd, x0v, x1v);
      }
    }
    dec[i] = run;                        // P_end, the whole chunk's product
  };

  // The consumer's value: X^T[j][i] for its 16 value columns, as the
  // accumulators of 8 n-tiles over the keys; lane (g, tq) holds
  // X[nt][0..1] = (j = g, i = 8 nt + 2 tq + 0..1), X[nt][2..3] = (j = g + 8, ...).
  const int g = lane >> 2, tq = lane & 3;
  const int j_col = slice * kChainNV;
  float X[8][4];
  auto x_at = [&](int nt, int e) {      // offset of X[nt][e] in a [HD][HD] matrix
    return (8 * nt + 2 * tq + (e & 1)) * kHD + j_col + g + 8 * (e >> 1);
  };
  // Iteration p = -1 loads chunks 0 .. D-1, prepares chunk 0 and sets X;
  // iteration p >= 0 loads chunk p+D into the slot chunk p-1 left, prepares
  // p+1 and applies p (D = kChainStages - 1: the chain is a few hundred
  // cycles a chunk, a load from device memory several times that).  Each
  // of issue_loads and prepare has one call site, so both are inlined.
  constexpr int D = kChainStages - 1;
  for (int p = -1; p < n_chunks; ++p) {
    if (producer) {
      for (int q = p < 0 ? 0 : p + D; q <= p + D; ++q) {
        if (q < n_chunks) issue_loads(q);
        else cp_async_commit();
      }
      cp_async_wait<D - 1>();                      // chunk p+1 has landed
      chain_loads_arrive();
    } else if (prep) {
      chain_loads_sync();
      if (p + 1 < n_chunks) prepare(p + 1);
    } else if (p < 0) {
      const float* x0_bh = x0 ? x0 + static_cast<size_t>(bh) * kHD * kHD : nullptr;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) X[nt][e] = x0_bh ? x0_bh[x_at(nt, e)] : 0.f;
    } else {
      float* ck_c = ck + (static_cast<size_t>(bh) * n_chunks + chunk_of(p)) * kHD * kHD;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ck_c[x_at(nt, e)] = X[nt][e];
      const unsigned char* pb = prep_buf(p);
      const uint32_t af = smem_addr(pb + L::kAF);
      const float* dec = reinterpret_cast<const float*>(pb + L::kDec);
      const uint32_t b_s = smem_addr(stage(p) + L::kB);
      const int mi = lane >> 3, ri = lane & 7;
      // b^T as the A operand: rows t = ri + 8 (mi >> 1), columns 8 (mi & 1),
      // transposed
      uint32_t bt[4];
      ldsm_x4_trans(bt, b_s + ((ri + 8 * (mi >> 1)) * L::kBLd + 8 * (mi & 1)) * 2);
      // X^T = X^T diag(P_end) + b^T (a*F), a*F in three parts (least
      // first); rows t = ri + 8 (mi & 1), keys 16 np + 8 (mi >> 1), transposed
      auto af_row = [&](int n) {         // n = 4 part + np, parts from the least
        return af + (((2 - n / 4) * kC + ri + 8 * (mi & 1)) * kLd + 16 * (n % 4) +
                     8 * (mi >> 1)) * 2;
      };
      uint32_t fb[4];
      ldsm_x4_trans(fb, af_row(0));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 d = *reinterpret_cast<const float2*>(dec + 8 * nt + 2 * tq);
        X[nt][0] *= d.x;
        X[nt][1] *= d.y;
        X[nt][2] *= d.x;
        X[nt][3] *= d.y;
      }
#pragma unroll
      for (int n = 0; n < 12; ++n) {
        uint32_t cur[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) cur[x] = fb[x];
        if (n + 1 < 12) ldsm_x4_trans(fb, af_row(n + 1));
        const int np = n % 4;
        mma_bf16(X[2 * np], bt, cur[0], cur[1]);
        mma_bf16(X[2 * np + 1], bt, cur[2], cur[3]);
      }
    }
    __syncthreads();
  }

  if (kGrad && !prep && !producer) {
    float* xT_bh = xT + static_cast<size_t>(bh) * kHD * kHD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) xT_bh[x_at(nt, e)] = X[nt][e];
  }
}

// Both chains in one launch: blocks [0, n) the state chain, [n, 2n) the
// gradient chain, n = B*H*kChainSlices.
template <typename TW>
__global__ void __launch_bounds__(kChainThreads)
wkv_bwd_chain_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const TW* __restrict__ w,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ s0,
                     const float* __restrict__ dsT, float* __restrict__ sck,
                     float* __restrict__ gck, float* __restrict__ ds0, int heads, int seq,
                     Strides st, Strides dst, int n) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  if (static_cast<int>(blockIdx.x) < n)
    chain_body<TW, false>(chain_smem, k, w, v, s0, sck, nullptr, heads, seq, st, st, blockIdx.x);
  else
    chain_body<TW, true>(chain_smem, r, w, dout, dsT, gck, ds0, heads, seq, st, dst,
                         blockIdx.x - n);
}

// The chunks.  One block of 16 warps walks kB3Chunks consecutive chunks of
// one (b, h); thread (row i = tid / 8, column group cg = tid % 8) owns the
// 8 entries (i, 4 cg + 0..3) and (i, 32 + 4 cg + 0..3) of S and of G, in
// registers.
constexpr int kB3Threads = 512;
constexpr int kB3Warps = kB3Threads / 32;
constexpr int kB3Sub = 4;                          // steps a recompute sub-chunk
constexpr int kB3Subs = kC / kB3Sub;
constexpr int kB3Chunks = 8;                       // chunks a block

template <typename TW>
struct B3Smem {                                    // byte offsets from a 16-aligned base
  static constexpr int kTile = kC * kHD;
  // one load stage: r, k, v, dout [C][HD] bf16, w [C][HD] TW, S_c and G_c [HD][HD] f32
  static constexpr int kR = 0;
  static constexpr int kK = kR + kTile * 2;
  static constexpr int kV = kK + kTile * 2;
  static constexpr int kD = kV + kTile * 2;
  static constexpr int kW = kD + kTile * 2;
  static constexpr int kSc = kW + kTile * static_cast<int>(sizeof(TW));
  static constexpr int kGc = kSc + kHD * kHD * 4;
  static constexpr int kStage = kGc + kHD * kHD * 4;
  // f32 copies of r, k, v, dout, w [C][HD]; u [HD], v.dout and sum r*u*k [C]
  static constexpr int kF = 2 * kStage;
  static constexpr int kU = kF + 5 * kTile * 4;
  // the states after steps 4, 8 and 12 [3][HD][HD]; dr, dk, dw, dv [4][C][HD];
  // dv partial sums of each warp's 4 rows [warps][kB3Sub][HD]
  static constexpr int kCk = kU + (kHD + 2 * kC) * 4;
  static constexpr int kOut = kCk + (kB3Subs - 1) * kHD * kHD * 4;
  static constexpr int kDvp = kOut + 4 * kTile * 4;
  static constexpr int kBytes = kDvp + kB3Warps * kB3Sub * kHD * 4;
};

// x[0..3] and x[4..7] from the float4s at p and p + 32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 32);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 32) = make_float4(x[4], x[5], x[6], x[7]);
}

// sum_e a[e] b[e] in two partial sums
__device__ __forceinline__ float dot8(const float (&a)[8], const float (&b)[8]) {
  float s0 = a[0] * b[0], s1 = a[1] * b[1];
#pragma unroll
  for (int e = 2; e < 8; e += 2) {
    s0 = fmaf(a[e], b[e], s0);
    s1 = fmaf(a[e + 1], b[e + 1], s1);
  }
  return s0 + s1;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store_pair(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename TW>
__global__ void __launch_bounds__(kB3Threads, 1)
wkv_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const TW* __restrict__ w,
                     const float* __restrict__ u, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ sck, const float* __restrict__ gck,
                     __nv_bfloat16* __restrict__ dr, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, TW* __restrict__ dw,
                     float* __restrict__ du_part, int heads, int seq, Strides st, Strides dst,
                     Strides gst) {
  using L = B3Smem<TW>;
  extern __shared__ __align__(16) unsigned char b3_smem[];
  float* r_s = reinterpret_cast<float*>(b3_smem + L::kF);
  float* k_s = r_s + L::kTile;
  float* v_s = k_s + L::kTile;
  float* d_s = v_s + L::kTile;
  float* w_s = d_s + L::kTile;
  float* u_s = reinterpret_cast<float*>(b3_smem + L::kU);
  float* vdo_s = u_s + kHD;
  float* ruk_s = vdo_s + kC;
  float* ck_s = reinterpret_cast<float*>(b3_smem + L::kCk);
  float* o_s = reinterpret_cast<float*>(b3_smem + L::kOut);    // dr, dk, dw, dv
  float* dvp = reinterpret_cast<float*>(b3_smem + L::kDvp);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int i = tid >> 3, cg = tid & 7;
  const int own = i * kHD + 4 * cg;                // first owned entry of a [HD][HD] matrix
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const long long in_base = static_cast<long long>(b) * st.b + static_cast<long long>(h) * st.h;
  const long long do_base = static_cast<long long>(b) * dst.b + static_cast<long long>(h) * dst.h;
  const long long g_base = static_cast<long long>(b) * gst.b + static_cast<long long>(h) * gst.h;
  const int nch = (seq + kC - 1) / kC;
  const int c_begin = blockIdx.x * kB3Chunks;
  const int c_end = min(c_begin + kB3Chunks, nch);
  auto stage = [&](int it) { return b3_smem + (it & 1) * L::kStage; };

  // cp.async of chunk c into stage(it): each thread one 16-byte piece of
  // each of r, k, v and dout, its share of w, and its own entries of S_c
  // and G_c (which only it reads); rows past S zero-filled
  auto issue = [&](int c, int it) {
    unsigned char* sp = stage(it);
    const int t0 = c * kC;
    {
      const int row = tid >> 3, piece = tid & 7;   // 16 rows x 8 pieces, one tile
      const int tile = row >> 4, t = row & 15;     // tid < 128: r; < 256: k; ...
      const bool ok = t0 + t < seq;
      const long long tt = ok ? t0 + t : 0;
      const int off = (t * kHD + piece * 8) * 2;
      if (tile == 0) cp_async16(smem_addr(sp + L::kR + off), r + in_base + tt * st.s + piece * 8, ok ? 16 : 0);
      else if (tile == 1) cp_async16(smem_addr(sp + L::kK + off), k + in_base + tt * st.s + piece * 8, ok ? 16 : 0);
      else if (tile == 2) cp_async16(smem_addr(sp + L::kV + off), v + in_base + tt * st.s + piece * 8, ok ? 16 : 0);
      else cp_async16(smem_addr(sp + L::kD + off), dout + do_base + tt * dst.s + piece * 8, ok ? 16 : 0);
    }
    constexpr int kWPieces = kHD * static_cast<int>(sizeof(TW)) / 16;
    constexpr int kPer = 16 / static_cast<int>(sizeof(TW));
    for (int e = tid; e < kC * kWPieces; e += kB3Threads) {
      const int t = e / kWPieces, piece = e % kWPieces;
      const bool ok = t0 + t < seq;
      const long long tt = ok ? t0 + t : 0;
      cp_async16(smem_addr(sp + L::kW + t * kHD * static_cast<int>(sizeof(TW)) + piece * 16),
                 w + in_base + tt * st.s + piece * kPer, ok ? 16 : 0);
    }
    const size_t ck_off = (static_cast<size_t>(bh) * nch + c) * kHD * kHD + own;
    cp_async16(smem_addr(sp + L::kSc + own * 4), sck + ck_off, 16);
    cp_async16(smem_addr(sp + L::kSc + (own + 32) * 4), sck + ck_off + 32, 16);
    cp_async16(smem_addr(sp + L::kGc + own * 4), gck + ck_off, 16);
    cp_async16(smem_addr(sp + L::kGc + (own + 32) * 4), gck + ck_off + 32, 16);
  };

  issue(c_begin, 0);
  cp_async_commit();
  if (tid < kHD) u_s[tid] = u[h * kHD + tid];
  const float ui = u[h * kHD + i];

  for (int c = c_begin, it = 0; c < c_end; ++c, ++it) {
    if (c + 1 < c_end) issue(c + 1, it + 1);
    cp_async_commit();
    cp_async_wait<1>();                            // chunk c has landed
    __syncthreads();                               // for every thread; the last out tile is stored
    const int t0 = c * kC;
    const int valid = min(kC, seq - t0);
    {                                              // the chunk in f32; w past S is 1
      const unsigned char* sp = stage(it);
      const int e = 2 * tid;                       // one pair of each tile
      const int t = e >> 6;
      auto conv = [&](int off, float* dst_s) {
        const float2 x = load_pair(reinterpret_cast<const __nv_bfloat16*>(sp + off) + e);
        *reinterpret_cast<float2*>(dst_s + e) = x;
      };
      conv(L::kR, r_s);
      conv(L::kK, k_s);
      conv(L::kV, v_s);
      conv(L::kD, d_s);
      const float2 x = t < valid ? load_pair(reinterpret_cast<const TW*>(sp + L::kW) + e)
                                 : make_float2(1.f, 1.f);
      *reinterpret_cast<float2*>(w_s + e) = x;
    }
    __syncthreads();
    {                                              // v_t . dout_t and sum_i r_t u k_t: warp t
      const int t = warp, j = 2 * lane;
      const float2 vv = load_pair(v_s + t * kHD + j), dd = load_pair(d_s + t * kHD + j);
      const float2 rr = load_pair(r_s + t * kHD + j), kk = load_pair(k_s + t * kHD + j);
      const float2 uu = load_pair(u_s + j);
      float vdo = fmaf(vv.y, dd.y, vv.x * dd.x);
      float ruk = fmaf(rr.y * uu.y, kk.y, rr.x * uu.x * kk.x);
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        vdo += __shfl_xor_sync(0xffffffffu, vdo, m);
        ruk += __shfl_xor_sync(0xffffffffu, ruk, m);
      }
      if (lane == 0) vdo_s[t] = vdo, ruk_s[t] = ruk;
    }
    __syncthreads();
    if (tid < kHD) {                               // this chunk's du partial
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) acc = fmaf(r_s[t * kHD + tid] * k_s[t * kHD + tid], vdo_s[t], acc);
      du_part[(static_cast<size_t>(bh) * nch + c) * kHD + tid] = acc;
    }

    const float* sc_s = reinterpret_cast<const float*>(stage(it) + L::kSc);
    const float* gc_s = reinterpret_cast<const float*>(stage(it) + L::kGc);
    // forward: the states after steps 4, 8 and 12, from S_c
    {
      float S[8], vt[8];
      load8(sc_s + own, S);
#pragma unroll
      for (int t = 0; t < kC - kB3Sub; ++t) {
        load8(v_s + t * kHD + 4 * cg, vt);
        const float kt = k_s[t * kHD + i], wt = w_s[t * kHD + i];
#pragma unroll
        for (int e = 0; e < 8; ++e) S[e] = fmaf(S[e], wt, kt * vt[e]);
        if ((t + 1) % kB3Sub == 0) store8(ck_s + ((t + 1) / kB3Sub - 1) * kHD * kHD + own, S);
      }
    }
    // backward, a sub-chunk at a time from the last: its 4 states
    // recomputed, then dr, dk, dw and the dv partials with G carried back
    // from G_c
    float G[8];
    load8(gc_s + own, G);
    for (int sc = kB3Subs - 1; sc >= 0; --sc) {
      const int tb = sc * kB3Sub;
      float H[kB3Sub][8], rp[kB3Sub];
      load8(sc == 0 ? sc_s + own : ck_s + (sc - 1) * kHD * kHD + own, H[0]);
#pragma unroll
      for (int q = 0; q + 1 < kB3Sub; ++q) {
        const int t = tb + q;
        float vt[8];
        load8(v_s + t * kHD + 4 * cg, vt);
        const float kt = k_s[t * kHD + i], wt = w_s[t * kHD + i];
#pragma unroll
        for (int e = 0; e < 8; ++e) H[q + 1][e] = fmaf(H[q][e], wt, kt * vt[e]);
      }
      float a[2 * kB3Sub];                         // dk partials, then dw partials
#pragma unroll
      for (int q = kB3Sub - 1; q >= 0; --q) {
        const int t = tb + q;
        float vt[8], dt[8], dvv[8];
        load8(v_s + t * kHD + 4 * cg, vt);
        load8(d_s + t * kHD + 4 * cg, dt);
        const float kt = k_s[t * kHD + i], wt = w_s[t * kHD + i], rt = r_s[t * kHD + i];
        rp[q] = dot8(H[q], dt);
        a[q] = dot8(G, vt);
        a[kB3Sub + q] = dot8(G, H[q]);
#pragma unroll
        for (int e = 0; e < 8; ++e) dvv[e] = G[e] * kt;
        // sum dvv over the warp's 4 rows (lanes 8 apart): lane (r4, cg)
        // keeps entries 2 r4 and 2 r4 + 1, columns dv_col(2 r4) + 0..1
        {
          const bool up = lane & 16;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lo = dvv[e], hi = dvv[e + 4];
            dvv[e] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, 16);
          }
        }
        {
          const bool up = lane & 8;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lo = dvv[e], hi = dvv[e + 2];
            dvv[e] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, 8);
          }
        }
        const int base_e = 2 * (lane >> 3);
        const int col = base_e < 4 ? 4 * cg + base_e : 32 + 4 * cg + base_e - 4;
        *reinterpret_cast<float2*>(dvp + (warp * kB3Sub + q) * kHD + col) =
            make_float2(dvv[0], dvv[1]);
#pragma unroll
        for (int e = 0; e < 8; ++e) G[e] = fmaf(G[e], wt, rt * dt[e]);
      }
      // row sums over the row's 8 lanes: lane cg keeps entry cg of a
      // (dk for cg < 4, else dw; step tb + cg % 4) and entry cg % 4 of rp
      butterfly<4>(a, cg);
      butterfly<2>(rp, cg);
      rp[0] += __shfl_xor_sync(0xffffffffu, rp[0], 4);
      {
        const int t = tb + (cg & 3);
        const float vdo = vdo_s[t];
        if (cg < 4) {
          o_s[(1 * kC + t) * kHD + i] = fmaf(ui * r_s[t * kHD + i], vdo, a[0]);   // dk
          o_s[(0 * kC + t) * kHD + i] = fmaf(ui * k_s[t * kHD + i], vdo, rp[0]);  // dr
        } else {
          o_s[(2 * kC + t) * kHD + i] = a[0];                                    // dw
        }
      }
      __syncthreads();                             // every warp's dv partials
      {                                            // dv: the 16 warps' sums in order,
        const int half = tid & 1;                  // warps 0-7 and 8-15 on lane pairs
        const int q = (tid >> 1) / kHD, j = (tid >> 1) % kHD, t = tb + q;
        float acc = 0.f;
#pragma unroll
        for (int wp = 0; wp < kB3Warps / 2; ++wp)
          acc += dvp[((half * kB3Warps / 2 + wp) * kB3Sub + q) * kHD + j];
        const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
        if (!half) o_s[(3 * kC + t) * kHD + j] = fmaf(ruk_s[t], d_s[t * kHD + j], acc + other);
      }
      __syncthreads();                             // dvp free again; the out tile complete
    }

    // the out tile, in pairs along hd, steps past S not stored
    for (int e = tid; e < 4 * kC * (kHD / 2); e += kB3Threads) {
      const int kind = e / (kC * kHD / 2), rem = e % (kC * kHD / 2);
      const int t = rem / (kHD / 2), j = 2 * (rem % (kHD / 2));
      if (t >= valid) continue;
      const float2 x = load_pair(o_s + (kind * kC + t) * kHD + j);
      const long long at = g_base + static_cast<long long>(t0 + t) * gst.s + j;
      if (kind == 2) store_pair(dw + at, x.x, x.y);
      else store_pair((kind == 0 ? dr : kind == 1 ? dk : dv) + at, x.x, x.y);
    }
  }
}

template <typename TW>
cudaError_t launch_bwd_chunked(const void* r, const void* k, const void* v, const void* w,
                               const float* u, const float* s0, const void* dout,
                               const float* dsT, void* dr, void* dk, void* dv, void* dw,
                               float* du_part, float* ds0, float* sck, float* gck, int bh,
                               int heads, int seq, Strides st, Strides dst, Strides gst,
                               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int chain_bytes = ChainSmem<TW>::kBytes;
  constexpr int chunk_bytes = B3Smem<TW>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_chain_kernel<TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, chain_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv_bwd_chunk_kernel<TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
  if (err != cudaSuccess) return err;
  const int n = bh * kChainSlices;
  wkv_bwd_chain_kernel<TW><<<2 * n, kChainThreads, chain_bytes, stream>>>(
      static_cast<const bf*>(r), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const TW*>(w), static_cast<const bf*>(dout), s0, dsT, sck, gck, ds0, heads, seq,
      st, dst, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nch = (seq + kC - 1) / kC;
  const dim3 grid((nch + kB3Chunks - 1) / kB3Chunks, bh);
  wkv_bwd_chunk_kernel<TW><<<grid, kB3Threads, chunk_bytes, stream>>>(
      static_cast<const bf*>(r), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const TW*>(w), u, static_cast<const bf*>(dout), sck, gck, static_cast<bf*>(dr),
      static_cast<bf*>(dk), static_cast<bf*>(dv), static_cast<TW*>(dw), du_part, heads, seq, st,
      dst, gst);
  return cudaGetLastError();
}

}  // namespace

// The chunk-parallel backward: as repro_wkv_bwd with bf16 r/k/v/dout and
// gradients, hd 64, f32 or bf16 w (bf16_w), for any S >= 1.  du_part is
// [batch, heads, ceil(S/16), hd] f32, one partial per chunk, to be summed
// over batch and chunks.  sck and gck are f32 scratch of batch * heads *
// ceil(S/16) * hd * hd floats each (the state before every chunk, the
// gradient after it).  The bases of r/k/v/w/dout and their strides in
// bytes must be multiples of 16 (cp.async), those of the gradients of 8.
// Two launches on `stream` (the chains, then the chunks), no
// synchronisation; returns the first cudaError_t.
extern "C" int repro_wkv_bwd_chunked(const void* r, const void* k, const void* v, const void* w,
                                     const void* u, const void* s0, const void* dout,
                                     const void* dsT, void* dr, void* dk, void* dv, void* dw,
                                     void* du_part, void* ds0, void* sck, void* gck, int batch,
                                     int heads, int seq, int hd, long long stride_b,
                                     long long stride_h, long long stride_s,
                                     long long dout_stride_b, long long dout_stride_h,
                                     long long dout_stride_s, long long grad_stride_b,
                                     long long grad_stride_h, long long grad_stride_s, int bf16_w,
                                     void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || hd != kHD || batch * heads > 65535)
    return cudaErrorInvalidValue;
  const Strides st{stride_b, stride_h, stride_s};
  const Strides dst{dout_stride_b, dout_stride_h, dout_stride_s};
  const Strides gst{grad_stride_b, grad_stride_h, grad_stride_s};
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  const float* dsTf = static_cast<const float*>(dsT);
  float* dup = static_cast<float*>(du_part);
  float* ds0f = static_cast<float*>(ds0);
  float* sckf = static_cast<float*>(sck);
  float* gckf = static_cast<float*>(gck);
  if (bf16_w)
    return launch_bwd_chunked<__nv_bfloat16>(r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv, dw, dup,
                                             ds0f, sckf, gckf, bh, heads, seq, st, dst, gst, s);
  return launch_bwd_chunked<float>(r, k, v, w, uf, s0f, dout, dsTf, dr, dk, dv, dw, dup, ds0f,
                                   sckf, gckf, bh, heads, seq, st, dst, gst, s);
}

// Dynamic shared memory (bytes) of one block of the chunk-parallel
// backward's chain kernel (chunks 0) or chunk kernel (chunks 1).
extern "C" int repro_wkv_bwd_chunked_smem_bytes(int bf16_w, int chunks) {
  if (chunks) return bf16_w ? B3Smem<__nv_bfloat16>::kBytes : B3Smem<float>::kBytes;
  return bf16_w ? ChainSmem<__nv_bfloat16>::kBytes : ChainSmem<float>::kBytes;
}
