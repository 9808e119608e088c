// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _kernel): softmax(q k^T * hd^-0.5) v over
// q [BHq, S, hd] and k/v [BHkv, S, hd], causal or full, GQA by mapping
// query head bh to kv head bh / group without repeating K/V.  The running
// max, sum and accumulator stay in f32, masked scores get the TPU kernel's
// -1e30, and the output is cast to the input type.  Two kernels compute
// that function; the wrapper picks one by dtype and hd, and neither falls
// back to the other:
//
// * flash_fwd_wgmma_kernel (repro_flash_attention_fwd_wgmma): bf16 at hd 64
//   and 128, on the tensor cores with TMA.  Every llama3_8b prefill layer
//   runs it.
// * flash_fwd_kernel (repro_flash_attention_fwd): f32 and bf16 at hd 16,
//   32, 64 and 128, f32 arithmetic on the CUDA cores.  It serves f32 calls
//   and bf16 at hd 16 and 32.
//
// Both forward kernels take an optional f32 lse [BHq, S] output: the
// natural-log sum of exp(scores * hd^-0.5) of each row, the one number per
// row that the backward needs to recompute p.  Serving passes null.  The
// backward (repro_flash_attention_bwd, at the end of this file) has no TPU
// counterpart: the TPU kernel is forward only and JAX differentiates its
// jnp model path; it is described where it begins.
//
// Bound at the main-path shape (one llama3_8b prefill layer: B=1, S=4096,
// Hq=32, Hkv=8, hd=128, causal, bf16): the unmasked half of the score
// matrix needs 4*hd*S*(S+1)/2*Hq = 137.5 GFLOP, 0.139 ms at the H100 SXM's
// 989 TFLOP/s bf16 dense (spec sheet, 700 W); q/k/v/o are 83.9 MB, 0.025 ms
// at 3.35 TB/s.  So it is bound by operations, on the tensor cores.
//
// The tensor-core kernel.
// * Numerics.  The TPU kernel keeps p in f32 for the P.V product.  Rounding
//   p once to bf16 for the tensor cores, as FlashAttention does, computes
//   another function: against the f32 reference it misses the one-bf16-ulp
//   limit by 50-80x at S = 1024-4096.  So p is split into two bf16 operands,
//   hi = bf16(p) and lo = bf16(p - hi), and O += hi.V + lo.V: both products
//   are exact in f32 and the split leaves at most 2^-18 of p.  This is 1.5x
//   the algorithm's tensor work.  The scores are the exact f32 products of
//   bf16 q and k, scaled afterwards in f32 by hd^-0.5 * log2(e), so that
//   exp2 gives the TPU kernel's exp; this differs from its f32 q * scale by
//   f32 rounding only.  The row sum l comes from the f32 p.
// * Work split.  One block of 288 threads owns 128 query rows of one
//   (b, head): warps 0-7 are two consumer warpgroups of 64 rows each, warp
//   8 the producer.  The producer's first lane issues the TMA loads: the q
//   tile once, then the 128-key K and V tiles of a two-stage ring, each
//   stage guarded by full barriers (transaction bytes) and an empty barrier
//   that all 256 consumer threads arrive on once they are done with it.
//   K and V have their own full barriers, so S = Q.K^T starts before V
//   lands.  No setmaxnreg: ptxas gives the 288 threads 168 registers each
//   (it sizes the block as three warpgroups), which spills 72 bytes at hd
//   128 and none at hd 64; giving the consumers more is later work.
// * Layout.  Tiles sit in shared memory as the 128-byte swizzle of TMA: a
//   row of hd bf16 values is split into 64-column panels of 128 bytes, 8
//   rows to a 1024-byte atom.  q and K are read K-major by wgmma; V is read
//   MN-major (the descriptor's transpose bit), so neither is transposed in
//   memory.  GQA is the kv-head coordinate bh / group of the K/V loads.
//   TMA writes zeros for rows past S, which covers the ragged tail.
// * Scores and softmax in registers.  S = Q.K^T is wgmma m64n128k16 with
//   f32 accumulators; each thread holds two rows (r, r + 8) of 32 columns,
//   so a row's max needs two shuffles in its quad of threads.  Tiles that
//   cross the diagonal or the tail are masked; tiles wholly above the
//   diagonal are skipped, as the CUDA-core kernel does.  The f32 scores
//   accumulator maps one to one onto the A-operand registers of the next
//   wgmma, so hi and lo go to P.V from registers.
// * Epilogue: O / max(l, 1e-30), rounded once to bf16, rows past S skipped.
//   With an lse pointer, the first thread of each quad also stores its two
//   rows' (m + log2 l) * ln 2: the log-sum-exp back in natural units.
// * Heaviest q tiles are launched first.
//
// The CUDA-core kernel.
// * The TPU kernel's sequential K axis becomes a loop inside the block:
//   one block of 256 threads owns one (bh, 64-row q tile) and walks the
//   64-column K/V tiles, keeping q*scale (upcast, scaled in f32) in shared
//   memory and its slice of the output accumulator in registers (4 rows x
//   hd/16 columns per thread).
// * K and V tiles share one shared buffer (K for the scores, then V for
//   the product), which keeps a block at 83.5 KB for hd=128 so two blocks
//   fit on an SM.  Rows have one float of padding, so the 16 threads of
//   a half-warp read 16 different banks and the two rows a warp reads
//   from the q and score tiles lie in different banks.
// * Masking: columns >= S (the ragged tail) and, when causal, columns >
//   row get -1e30 before the softmax, the TPU kernel's constant.  Tiles
//   wholly above the diagonal are skipped: there the TPU kernel adds
//   exactly zero (p = exp(-1e30 - m) = 0, corr = 1).  Tail rows and
//   columns are loaded as zeros and tail rows are never stored.
// * Causal work grows with the q tile index, so the heaviest tiles are
//   launched first.
#include <cstdint>
#include <cuda.h>          // CUtensorMap and its enums only: no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k/v columns per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over a 64 x 64 score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD>
struct Layout {
  static constexpr int kQLd = HD + 1;    // padded row of the q tile
  static constexpr int kKvLd = HD + 1;   // padded row of the K/V tile
  static constexpr int kSLd = kBK + 1;   // padded row of the score tile
  static constexpr int kFloats = kBQ * kQLd + kBK * kKvLd + kBQ * kSLd + 3 * kBQ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int seq, int group, float scale, int causal) {
  using L = Layout<HD>;
  constexpr int kCols = HD / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][kQLd]     q * scale
  float* kvs = qs + kBQ * L::kQLd;       // [kBK][kKvLd]    K tile, then V tile
  float* ss = kvs + kBK * L::kKvLd;      // [kBQ][kSLd]     scores, then p
  float* m_s = ss + kBQ * L::kSLd;       // [kBQ] running max
  float* l_s = m_s + kBQ;                // [kBQ] running sum
  float* c_s = l_s + kBQ;                // [kBQ] this tile's correction

  const int tid = threadIdx.x;
  const int tx = tid & 15;               // columns tx + 16 j
  const int ty = tid >> 4;               // rows ty + 16 i
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const size_t head = static_cast<size_t>(seq) * HD;
  const T* qp = q + bh * head;
  const T* kp = k + (bh / group) * head;
  const T* vp = v + (bh / group) * head;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = q0 + r;
    qs[r * L::kQLd + d] = row < seq ? to_f32(qp[static_cast<size_t>(row) * HD + d]) * scale : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  int n_k = (seq + kBK - 1) / kBK;
  if (causal) n_k = min(n_k, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, col = k0 + r;
      kvs[r * L::kKvLd + d] = col < seq ? to_f32(kp[static_cast<size_t>(col) * HD + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * L::kQLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kvs[(tx + 16 * j) * L::kKvLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = k0 + c;
        const bool keep = col < seq && (!causal || col <= q0 + r);
        ss[r * L::kSLd + c] = keep ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // V replaces K in the shared buffer while the warps run the softmax.
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, col = k0 + r;
      kvs[r * L::kKvLd + d] = col < seq ? to_f32(vp[static_cast<size_t>(col) * HD + d]) : 0.f;
    }
    {
      const int warp = tid >> 5, lane = tid & 31;
      constexpr int kRowsPerWarp = kBQ / (kThreads / 32);
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        float* srow = ss + r * L::kSLd;
        const float s0 = srow[lane], s1 = srow[lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        srow[lane] = p0;
        srow[lane + 32] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          l_s[r] = l_s[r] * corr + sum;
          m_s[r] = m_new;
          c_s[r] = corr;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], w[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * L::kSLd + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = kvs[kk * L::kKvLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  T* op = o + bh * head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= seq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(op + static_cast<size_t>(row) * HD + tx + 16 * j, acc[i][j] / l);
    // m_s is in the units of the scaled scores, so this is the row's log-sum-exp
    if (lse != nullptr && tx == 0) lse[static_cast<size_t>(bh) * seq + row] = m_s[r] + logf(l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int bh_kv, int seq, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, bh / bh_kv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                        int bh_kv, int seq, int hd, float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, bh_kv, seq, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, bh_kv, seq, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, bh_kv, seq, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, bh_kv, seq, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace


// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, hd 64 and 128).
namespace {

constexpr int kTcBM = 128;                 // q rows per block: two warpgroups of 64
constexpr int kTcBN = 128;                 // keys per K/V tile
constexpr int kTcStages = 2;               // K/V ring depth
constexpr int kTcConsumers = 256;          // threads of the two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32;   // and one producer warp
constexpr int kPanelCols = 64;             // bf16 columns of one 128-byte swizzled panel
constexpr int kRowBytes = 128;             // bytes of one panel row
// a wait that outlasts this many polls means a lost TMA transaction:
// trap, so the launch fails instead of hanging the card
constexpr unsigned kSpinLimit = 1u << 24;

template <int HD>
struct TcSmem {                            // byte offsets from a 1024-aligned base
  static constexpr int kQBytes = kTcBM * HD * 2;
  static constexpr int kTileBytes = kTcBN * HD * 2;      // one K or one V tile
  static constexpr int kK = kQBytes;                     // K of stage s at kK + s * kTileBytes
  static constexpr int kV = kK + kTcStages * kTileBytes;
  static constexpr int kBar = kV + kTcStages * kTileBytes;
  // barriers: q full, K full [stages], V full [stages], empty [stages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kTcStages);
  static constexpr size_t kAlloc = kBytes + 1024;        // slack to align the base
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (unsigned polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == kSpinLimit) __trap();
  }
}

// One TMA tile load of a [heads, seq, hd] tensor into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// K-major (q, K): 8-row groups 1024 bytes apart; the leading offset is
// unused by the swizzled K-major layout.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 8 * kRowBytes);
}

// MN-major (V as B of P.V): 8-key groups 1024 bytes apart; 64-column panels
// of hd a whole tile apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, kTcBN * kRowBytes, 8 * kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching accumulators across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define FA_F8(a, i)                                                                       \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]),            \
      "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])
#define FA_F32(a, i) FA_F8(a, i), FA_F8(a, i + 8), FA_F8(a, i + 16), FA_F8(a, i + 24)
#define FA_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_D64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= a[64 x 16] . b[128 x 16]^T, a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_scores(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_F32(d, 0), FA_F32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] += a[64 x 16] . b[16 x N]: a from registers (bf16 pairs), b
// MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_F32(d, 0), FA_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p = hi + lo with hi = bf16(p) and lo = bf16(p - hi), as bf16 pairs.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int seq, int group, float scale_log2, int causal) {
  using L = TcSmem<HD>;
  constexpr int kPanels = HD / kPanelCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;   // the swizzle atom's alignment
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;                  // + 8 * stage
  const uint32_t v_full = k_full + 8 * kTcStages;
  const uint32_t empty = v_full + 8 * kTcStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBM;
  int n_kv = (seq + kTcBN - 1) / kTcBN;
  if (causal) n_kv = min(n_kv, (q0 + kTcBM - 1) / kTcBN + 1);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // producer warp: one lane issues every load of the block
    if (tid == kTcConsumers) {
      const int kvh = bh / group;
      mbar_expect_tx(q_full, L::kQBytes);
      for (int p = 0; p < kPanels; ++p)
        tma_load(base + p * kTcBM * kRowBytes, &tm_q, q_full, p * kPanelCols, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kTcStages;
        mbar_wait(empty + 8 * s, ((j / kTcStages) & 1) ^ 1);   // the first round passes
        const uint32_t kd = base + L::kK + s * L::kTileBytes;
        const uint32_t vd = base + L::kV + s * L::kTileBytes;
        mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(kd + p * kTcBN * kRowBytes, &tm_k, k_full + 8 * s, p * kPanelCols, j * kTcBN, kvh);
        mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(vd + p * kTcBN * kRowBytes, &tm_v, v_full + 8 * s, p * kPanelCols, j * kTcBN, kvh);
      }
    }
    return;
  }

  // consumer warpgroup wg owns rows q0 + 64 wg .. + 63; this thread holds
  // rows r and r + 8 at columns 8 c + col + {0, 1} of every 8-column chunk c
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row_a = q0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int col = 2 * (lane % 4);
  const uint32_t q_tile = base + wg * 64 * kRowBytes;

  float acc[HD / 2];                       // O, f32
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;      // running max of scaled scores (log2 units)
  float l_a = 0.f, l_b = 0.f;              // this thread's share of the running sum
  float s[kTcBN / 2];                      // scores, then p

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kTcStages;
    const uint32_t parity = (j / kTcStages) & 1;
    const uint32_t k_tile = base + L::kK + st * L::kTileBytes;
    const uint32_t v_tile = base + L::kV + st * L::kTileBytes;

    mbar_wait(k_full + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk % 4) * 32;   // 16 columns into panel kk / 4
      wgmma_scores(s, desc_k_major(q_tile + (kk / 4) * kTcBM * kRowBytes + koff),
                   desc_k_major(k_tile + (kk / 4) * kTcBN * kRowBytes + koff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int k0 = j * kTcBN;
#pragma unroll
    for (int i = 0; i < kTcBN / 2; ++i) s[i] *= scale_log2;
    if (k0 + kTcBN > seq || (causal && k0 + kTcBN - 1 > q0 + wg * 64)) {
#pragma unroll
      for (int i = 0; i < kTcBN / 2; ++i) {
        const int c = k0 + 8 * (i / 4) + col + (i & 1);
        const int r = (i & 2) ? row_b : row_a;
        if (c >= seq || (causal && c > r)) s[i] = kNegInf;
      }
    }

    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < kTcBN / 2; i += 4) {
      mx_a = fmaxf(mx_a, fmaxf(s[i], s[i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[i + 2], s[i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the quad of threads that share a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;

    // p in f32 for the row sum, then as hi + lo bf16 pairs: pair i holds
    // elements 2i and 2i+1, which is the A-operand register order of P.V
    uint32_t hi[kTcBN / 4], lo[kTcBN / 4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < kTcBN / 4; ++i) {
      const float m = (i & 1) ? m_b : m_a;
      const float p0 = exp2f(s[2 * i] - m), p1 = exp2f(s[2 * i + 1] - m);
      if (i & 1) sum_b += p0 + p1;
      else sum_a += p0 + p1;
      split_bf16(p0, p1, hi[i], lo[i]);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? corr_b : corr_a;

    mbar_wait(v_full + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBN / 16; ++kk)
      wgmma_pv(acc, hi + 4 * kk, desc_mn_major(v_tile + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < kTcBN / 16; ++kk)
      wgmma_pv(acc, lo + 4 * kk, desc_mn_major(v_tile + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  if (lse != nullptr && col == 0) {        // m and l are the quad's own: one store a row
    constexpr float kLn2 = 0.6931471805599453f;
    float* lp = lse + static_cast<size_t>(bh) * seq;
    if (row_a < seq) lp[row_a] = (m_a + log2f(l_a)) * kLn2;
    if (row_b < seq) lp[row_b] = (m_b + log2f(l_b)) * kLn2;
  }
  __nv_bfloat16* op = o + static_cast<size_t>(bh) * seq * HD;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int d = 8 * c + col;
    if (row_a < seq)
      *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(row_a) * HD + d) =
          __floats2bfloat162_rn(acc[4 * c] / l_a, acc[4 * c + 1] / l_a);
    if (row_b < seq)
      *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(row_b) * HD + d) =
          __floats2bfloat162_rn(acc[4 * c + 2] / l_b, acc[4 * c + 3] / l_b);
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library links no libcuda; null if the driver has none.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The tensor map of a contiguous bf16 [heads, seq, hd] tensor, read in
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzled; rows
// past seq read as zeros.
bool tensor_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int heads, int seq,
                int hd, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(seq) * hd * 2};
  const cuuint32_t box[3] = {kPanelCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                         int bh_kv, int seq, float scale, int causal, cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(encode, &tm_q, q, bh, seq, HD, kTcBM) ||
      !tensor_map(encode, &tm_k, k, bh_kv, seq, HD, kTcBN) ||
      !tensor_map(encode, &tm_v, v, bh_kv, seq, HD, kTcBN))
    return cudaErrorInvalidValue;
  const size_t bytes = TcSmem<HD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kTcBM - 1) / kTcBM);
  // scores are scaled into log2 units so that exp2 gives exp
  flash_fwd_wgmma_kernel<HD><<<grid, kTcThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, seq, bh / bh_kv,
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace

// q [bh, seq, hd], k/v [bh_kv, seq, hd], o [bh, seq, hd], all contiguous, on
// one device, of one type (is_bf16 ? bf16 : f32); lse null or f32 [bh, seq].
// The CUDA-core kernel: any of those types at hd 16, 32, 64 or 128.
// Launches on `stream` and does not synchronise; returns the cudaError_t of
// the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int bh, int bh_kv, int seq, int hd,
                                         int is_bf16, int causal, float scale, void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || seq <= 0 || (seq + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, l, bh, bh_kv, seq, hd, scale, causal, s);
  return dispatch_hd<float>(q, k, v, o, l, bh, bh_kv, seq, hd, scale, causal, s);
}

// The same arguments; the tensor-core kernel, which takes bf16 (is_bf16 = 1)
// at hd 64 or 128 with 16-byte-aligned q, k and v, and nothing else.
extern "C" int repro_flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                               void* o, void* lse, int bh, int bh_kv, int seq,
                                               int hd, int is_bf16, int causal, float scale,
                                               void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || seq <= 0 ||
      (seq + kTcBM - 1) / kTcBM > 65535 || !is_bf16)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;   // TMA reads from 16-byte-aligned bases only
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64: return launch_wgmma<64>(q, k, v, o, l, bh, bh_kv, seq, scale, causal, s);
    case 128: return launch_wgmma<128>(q, k, v, o, l, bh, bh_kv, seq, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the tensor-core kernel at `hd`, in bytes (0 if
// it does not take that hd).
extern "C" int repro_flash_attention_wgmma_smem_bytes(int hd) {
  switch (hd) {
    case 64: return static_cast<int>(TcSmem<64>::kAlloc);
    case 128: return static_cast<int>(TcSmem<128>::kAlloc);
    default: return 0;
  }
}


// ---------------------------------------------------------------------------
// The backward kernel (f32 and bf16, hd 16-128, CUDA cores).
//
// No TPU kernel to replace: src/repro/kernels/flash_attention.py is
// forward only, and JAX differentiates its jnp model path.  This computes
// the gradient of the forward above, the function reference_attention
// computes, from q, k, v, dO and the forward's lse: with
// p = exp(scale q.k - lse) (0 where masked), dP = dO.V^T and
// D = rowsum(p * dP),
//
//   dV = P^T dO,   dS = P * (dP - D),   dK = scale dS^T Q,   dQ = scale dS K,
//
// GQA's dK and dV summed over the query heads of each kv head.  Everything
// is f32 on the CUDA cores from inputs upcast on load, and each gradient is
// rounded once to the input type, so in bf16 it differs from autograd of
// the plain version by at most one ulp.
//
// * D.  FlashAttention takes D = rowsum(dO * O) from the saved output.  In
//   bf16, O is rounded to 2^-9, and the resulting dS = P (dP - D) error
//   lands on every key of a row: against the plain version's f32 gradient
//   it misses the one-ulp limit by 6-160x (tests/test_torch_flash_bwd_
//   numerics.py).  So D is summed from p * dP itself, in f32, in the pass
//   that computes dQ, which sees every key of its rows: dQ = scale
//   (sum p dP K - D sum p K), two accumulators instead of one.  The
//   backward does not read O at all.
// * Step 1, flash_bwd_dq_kernel: one block of 256 threads per (q head,
//   64-row q tile), heaviest tiles first; it keeps q and dO, walks the
//   64-key K/V tiles (up to the diagonal when causal), and writes dQ and D.
// * Step 2, flash_bwd_dkdv_kernel: one block per (kv head, 64-key tile),
//   keeping K and V; it walks every q tile of every query head of its
//   group (from the diagonal on when causal), so GQA's sum over the group
//   happens in the block.  No atomics in either step: two identical calls
//   give bit-identical gradients.
// * The thread layout is the CUDA-core forward's: a 16 x 16 grid over a
//   64 x 64 tile, rows ty + 16 i, columns tx + 16 j; tiles in shared memory
//   with one float of padding a row.  At hd 128 a block takes 162 KB of
//   shared memory, so one block runs on an SM.
// * Bound at the training shape (one llama3_8b layer: B=1, S=4096, 32/8
//   heads, hd 128, causal, bf16): five products over the unmasked half of
//   the score matrix, 2.5x the forward's 137.5 GFLOP, 0.347 ms at the bf16
//   tensor-core peak, 5.1 ms at the f32 CUDA-core peak; bound by
//   operations.  This kernel runs eight products' worth (the recomputed
//   scores and dP in both steps, and the two dQ accumulators) on the CUDA
//   cores; the tensor cores are later work.
namespace {

constexpr int kBT = 64;        // q rows and keys per tile of the backward

template <int HD>
struct BwdLayout {
  static constexpr int kLd = HD + 1;                 // padded row of a [64][HD] tile
  static constexpr int kSLd = kBT + 1;               // padded row of a 64 x 64 tile
  static constexpr int kTile = kBT * kLd;
  static constexpr int kFloats = 4 * kTile + 2 * kBT * kSLd + 2 * kBT;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// rows row0 .. row0 + 63 of a [seq, HD] head into a padded f32 tile, zeros
// past seq
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int seq) {
  for (int i = threadIdx.x; i < kBT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = row0 + r;
    dst[r * (HD + 1) + d] = row < seq ? to_f32(src[static_cast<size_t>(row) * HD + d]) : 0.f;
  }
}

// s[i][j] = a1[ty+16i] . b1[tx+16j] and t[i][j] = a2[ty+16i] . b2[tx+16j]
// over HD, for rows of padded [64][HD] tiles
template <int HD>
__device__ __forceinline__ void two_products(const float* a1, const float* b1, const float* a2,
                                             const float* b2, float (&s)[4][4],
                                             float (&t)[4][4]) {
  constexpr int kLd = HD + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float x[4], y[4], u[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = a1[(ty + 16 * i) * kLd + d];
      u[i] = a2[(ty + 16 * i) * kLd + d];
      y[i] = b1[(tx + 16 * i) * kLd + d];
      w[i] = b2[(tx + 16 * i) * kLd + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i], y[j], s[i][j]);
        t[i][j] = fmaf(u[i], w[j], t[i][j]);
      }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int seq, int group,
                    float scale, int causal) {
  using L = BwdLayout<HD>;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;                      // [64][kLd] q
  float* dos = qs + L::kTile;            // [64][kLd] dO
  float* ks = dos + L::kTile;            // [64][kLd] K tile
  float* vs = ks + L::kTile;             // [64][kLd] V tile
  float* ps = vs + L::kTile;             // [64][kSLd] p
  float* pds = ps + kBT * L::kSLd;       // [64][kSLd] p * dP
  float* lse_s = pds + kBT * L::kSLd;    // [64]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBT;
  const size_t head = static_cast<size_t>(seq) * HD;
  const T* kp = k + (bh / group) * head;
  const T* vp = v + (bh / group) * head;

  load_tile<T, HD>(qs, q + bh * head, q0, seq);
  load_tile<T, HD>(dos, dout + bh * head, q0, seq);
  if (tid < kBT) lse_s[tid] = q0 + tid < seq ? lse[static_cast<size_t>(bh) * seq + q0 + tid] : 0.f;

  float acc_a[4][kCols], acc_b[4][kCols];   // sum p dP K and sum p K
  float dsum[4];                            // this thread's share of D
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_a[i][j] = acc_b[i][j] = 0.f;
  }

  int n_k = (seq + kBT - 1) / kBT;
  if (causal) n_k = min(n_k, (q0 + kBT - 1) / kBT + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBT;
    load_tile<T, HD>(ks, kp, k0, seq);
    load_tile<T, HD>(vs, vp, k0, seq);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<HD>(qs, ks, dos, vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        const bool keep = row < seq && col < seq && (!causal || col <= row);
        const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float pdp = p * dp[i][j];
        dsum[i] += pdp;
        ps[r * L::kSLd + c] = p;
        pds[r * L::kSLd + c] = pdp;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBT; ++c) {
      float x[4], y[4], w[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = pds[(ty + 16 * i) * L::kSLd + c];
        y[i] = ps[(ty + 16 * i) * L::kSLd + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = ks[c * L::kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc_a[i][j] = fmaf(x[i], w[j], acc_a[i][j]);
          acc_b[i][j] = fmaf(y[i], w[j], acc_b[i][j]);
        }
    }
    __syncthreads();
  }

  // D of row ty + 16 i: the 16 threads of a row are lanes 0-15 or 16-31 of
  // one warp
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);

  T* dqp = dq + bh * head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store(dqp + static_cast<size_t>(row) * HD + tx + 16 * j,
            scale * (acc_a[i][j] - dsum[i] * acc_b[i][j]));
    if (tx == 0) delta[static_cast<size_t>(bh) * seq + row] = dsum[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int seq, int group, float scale, int causal) {
  using L = BwdLayout<HD>;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;                      // [64][kLd] K tile of this block
  float* vs = ks + L::kTile;             // [64][kLd] V tile of this block
  float* qs = vs + L::kTile;             // [64][kLd] q tile
  float* dos = qs + L::kTile;            // [64][kLd] dO tile
  float* ps = dos + L::kTile;            // [64 q rows][kSLd] p
  float* dss = ps + kBT * L::kSLd;       // [64 q rows][kSLd] dS
  float* lse_s = dss + kBT * L::kSLd;    // [64]
  float* d_s = lse_s + kBT;              // [64]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kBT;       // key tile 0 has the most q tiles under a causal mask
  const size_t head = static_cast<size_t>(seq) * HD;
  load_tile<T, HD>(ks, k + bkv * head, k0, seq);
  load_tile<T, HD>(vs, v + bkv * head, k0, seq);

  float acc_dk[4][kCols], acc_dv[4][kCols];   // keys ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  const int n_q = (seq + kBT - 1) / kBT;
  const int first = causal ? k0 / kBT : 0;
  for (int h = 0; h < group; ++h) {
    const int bh = bkv * group + h;
    for (int qt = first; qt < n_q; ++qt) {
      const int q0 = qt * kBT;
      __syncthreads();                   // the last tile's readers are done
      load_tile<T, HD>(qs, q + bh * head, q0, seq);
      load_tile<T, HD>(dos, dout + bh * head, q0, seq);
      if (tid < kBT) {
        const size_t at = static_cast<size_t>(bh) * seq + q0 + tid;
        lse_s[tid] = q0 + tid < seq ? lse[at] : 0.f;
        d_s[tid] = q0 + tid < seq ? delta[at] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];           // q rows ty + 16 i against keys tx + 16 j
      two_products<HD>(qs, ks, dos, vs, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, col = k0 + c;
          const bool keep = row < seq && col < seq && (!causal || col <= row);
          const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          ps[r * L::kSLd + c] = p;
          dss[r * L::kSLd + c] = p * (dp[i][j] - d_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T q over the tile's 64 q rows
#pragma unroll 4
      for (int r = 0; r < kBT; ++r) {
        float x[4], y[4], w[kCols], z[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = ps[r * L::kSLd + ty + 16 * i];
          y[i] = dss[r * L::kSLd + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          w[j] = dos[r * L::kLd + tx + 16 * j];
          z[j] = qs[r * L::kLd + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            acc_dv[i][j] = fmaf(x[i], w[j], acc_dv[i][j]);
            acc_dk[i][j] = fmaf(y[i], z[j], acc_dk[i][j]);
          }
      }
    }
  }

  T* dkp = dk + bkv * head;
  T* dvp = dv + bkv * head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= seq) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const size_t at = static_cast<size_t>(key) * HD + tx + 16 * j;
      store(dkp + at, scale * acc_dk[i][j]);
      store(dvp + at, acc_dv[i][j]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, float* delta, void* dq, void* dk, void* dv, int bh,
                       int bh_kv, int seq, float scale, int causal, cudaStream_t stream) {
  const int bytes = static_cast<int>(BwdLayout<HD>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (seq + kBT - 1) / kBT;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, HD><<<dim3(bh, tiles), kThreads, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), seq, bh / bh_kv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: step 2 reads the D that step 1 wrote
  flash_bwd_dkdv_kernel<T, HD><<<dim3(bh_kv, tiles), kThreads, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), seq, bh / bh_kv,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, float* delta, void* dq, void* dk, void* dv, int bh,
                         int bh_kv, int seq, int hd, float scale, int causal,
                         cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_bwd<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, bh, bh_kv, seq, scale, causal, stream);
    case 32: return launch_bwd<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, bh_kv, seq, scale, causal, stream);
    case 64: return launch_bwd<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, bh_kv, seq, scale, causal, stream);
    case 128: return launch_bwd<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, bh_kv, seq, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The gradient of repro_flash_attention_fwd's function.  q, dout, dq
// [bh, seq, hd]; k, v, dk, dv [bh_kv, seq, hd]; all contiguous, on one
// device, of one type (is_bf16 ? bf16 : f32); lse f32 [bh, seq] from a
// forward call on the same q, k, v and causal flag; delta f32 [bh, seq]
// scratch, written with D.  hd 16, 32, 64 or 128, any seq >= 1.  Launches
// two kernels on `stream` and does not synchronise; returns the cudaError_t
// of the launches.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, void* delta,
                                         void* dq, void* dk, void* dv, int bh, int bh_kv,
                                         int seq, int hd, int is_bf16, int causal, float scale,
                                         void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || seq <= 0 || (seq + kBT - 1) / kBT > 65535 ||
      lse == nullptr || delta == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (is_bf16)
    return dispatch_bwd<__nv_bfloat16>(q, k, v, dout, l, d, dq, dk, dv, bh, bh_kv, seq, hd,
                                       scale, causal, s);
  return dispatch_bwd<float>(q, k, v, dout, l, d, dq, dk, dv, bh, bh_kv, seq, hd, scale, causal,
                             s);
}

// Dynamic shared memory of the backward kernels at `hd`, in bytes (0 if
// they do not take that hd).
extern "C" int repro_flash_attention_bwd_smem_bytes(int hd) {
  switch (hd) {
    case 16: return static_cast<int>(BwdLayout<16>::kBytes);
    case 32: return static_cast<int>(BwdLayout<32>::kBytes);
    case 64: return static_cast<int>(BwdLayout<64>::kBytes);
    case 128: return static_cast<int>(BwdLayout<128>::kBytes);
    default: return 0;
  }
}
