// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _kernel): softmax(q k^T * hd^-0.5) v over
// q [BHq, S, hd] and k/v [BHkv, S, hd], causal or full, GQA by mapping
// query head bh to kv head bh / group without repeating K/V, with an
// optional sliding window (below).  The running
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
// backward has no TPU counterpart: the TPU kernel is forward only and JAX
// differentiates its jnp model path.  Two backwards compute its gradient,
// each described where it begins, and as for the forward the wrapper picks
// one by dtype and hd:
//
// * repro_flash_attention_bwd_wgmma: bf16 at hd 64 and 128 (the calls
//   whose forward is the tensor-core kernel), on the tensor cores with
//   TMA.  Every llama3_8b training layer runs it.
// * repro_flash_attention_bwd: f32 and bf16 at hd 16-128, f32 arithmetic
//   on the CUDA cores.  It serves f32 calls and bf16 at hd 16 and 32.
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
// The sliding window (every kernel of this file, forward and backward).
// `window` W > 0 keeps key k for query q only if k > q - W, the JAX
// model's mask (src/repro/models/attention.py:79), independently of the
// causal flag: without it every later key stays.  W = 0 is no window.
// Every kernel is instantiated with and without a window (kWindow; the
// latter compiles to the code that had no window argument), and a window
// of at least S masks nothing, so the entry points launch the
// instantiation without one: the same code, tiles and bits as no window.
// Tiles that lie wholly outside every row's window are skipped
// (window_first_tile / window_end_tile); only a tile that crosses the
// window's lower edge for some row of its warpgroup (or block) is masked
// element by element.  A row whose first visited tile is wholly outside
// its own window sees only -1e30 scores there: p = exp(0) = 1 adds finite
// garbage to its sums, which the next tile's correction exp(-1e30 - m)
// multiplies by exactly 0, as in the JAX model's scan.  Every row keeps
// one key (its own when causal, key S - 1 otherwise), so no lse is -inf
// and no NaN arises.
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
// * Masking: columns >= S (the ragged tail), when causal columns > row,
//   and with a window columns <= row - W get -1e30 before the softmax, the
//   TPU kernel's constant.  Tiles wholly above the diagonal, and those
//   wholly before the window of the block's first row, are skipped: there the TPU kernel adds
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

// The first `tile`-wide key tile that holds a key inside the window of a
// query row from q_first on: key k is kept for row q only if k > q - window.
__host__ __device__ __forceinline__ int window_first_tile(int q_first, int window, int tile) {
  return window > 0 && q_first - window + 1 > 0 ? (q_first - window + 1) / tile : 0;
}

// One past the last `tile`-row query tile (of n) that keeps some key at or
// before k_last: row q keeps key k only if q < k + window.
__host__ __device__ __forceinline__ int window_end_tile(int k_last, int window, int tile, int n) {
  return window > 0 ? min(n, (k_last + window - 1) / tile + 1) : n;
}

// Whether key `col` lies in the window of query `row` (no window: always).
__device__ __forceinline__ bool in_window(int col, int row, int window) {
  return window == 0 || col > row - window;
}

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

template <typename T, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int seq, int group, float scale, int causal, int window) {
  using L = Layout<HD>;
  constexpr int kCols = HD / 16;         // output columns per thread
  if (!kWindow) window = 0;
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

  for (int kt = window_first_tile(q0, window, kBK); kt < n_k; ++kt) {
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
        const bool keep = col < seq && (!causal || col <= q0 + r) && in_window(col, q0 + r, window);
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

template <typename T, int HD, bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int bh_kv, int seq, float scale, int causal, int window, cudaStream_t stream) {
  const size_t bytes = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD, kWindow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, HD, kWindow><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, bh / bh_kv, scale, causal, window);
  return cudaGetLastError();
}

template <typename T, bool kWindow>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                        int bh_kv, int seq, int hd, float scale, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, kWindow>(q, k, v, o, lse, bh, bh_kv, seq, scale, causal, window, stream);
    case 32: return launch<T, 32, kWindow>(q, k, v, o, lse, bh, bh_kv, seq, scale, causal, window, stream);
    case 64: return launch<T, 64, kWindow>(q, k, v, o, lse, bh, bh_kv, seq, scale, causal, window, stream);
    case 128: return launch<T, 128, kWindow>(q, k, v, o, lse, bh, bh_kv, seq, scale, causal, window, stream);
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
// of hd a whole tile of `rows` rows apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, int rows = kTcBN) {
  return smem_desc(addr, rows * kRowBytes, 8 * kRowBytes);
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
// until at most N committed groups are in flight (they complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// d[64 x 64] (+)= a[64 x 16] . b[64 x 16]^T, a and b K-major in shared memory.
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_F32(d, 0)
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

template <int HD, bool kWindow>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int seq, int group, float scale_log2, int causal,
                       int window) {
  using L = TcSmem<HD>;
  constexpr int kPanels = HD / kPanelCols;
  if (!kWindow) window = 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;   // the swizzle atom's alignment
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;                  // + 8 * stage
  const uint32_t v_full = k_full + 8 * kTcStages;
  const uint32_t empty = v_full + 8 * kTcStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBM;
  int end = (seq + kTcBN - 1) / kTcBN;
  if (causal) end = min(end, (q0 + kTcBM - 1) / kTcBN + 1);
  const int first = window_first_tile(q0, window, kTcBN);   // key tile of ring slot 0
  const int n_kv = end - first;

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
        const int k0 = (first + j) * kTcBN;
        mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(kd + p * kTcBN * kRowBytes, &tm_k, k_full + 8 * s, p * kPanelCols, k0, kvh);
        mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(vd + p * kTcBN * kRowBytes, &tm_v, v_full + 8 * s, p * kPanelCols, k0, kvh);
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
  // the warpgroup's last row that is stored: a tile with a key at or
  // before last_row - window crosses the window's lower edge
  const int last_row = min(q0 + wg * 64 + 63, seq - 1);

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

    const int k0 = (first + j) * kTcBN;
#pragma unroll
    for (int i = 0; i < kTcBN / 2; ++i) s[i] *= scale_log2;
    if (k0 + kTcBN > seq || (causal && k0 + kTcBN - 1 > q0 + wg * 64) ||
        (window > 0 && k0 + window <= last_row)) {
#pragma unroll
      for (int i = 0; i < kTcBN / 2; ++i) {
        const int c = k0 + 8 * (i / 4) + col + (i & 1);
        const int r = (i & 2) ? row_b : row_a;
        if (c >= seq || (causal && c > r) || !in_window(c, r, window)) s[i] = kNegInf;
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

template <int HD, bool kWindow>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                         int bh_kv, int seq, float scale, int causal, int window,
                         cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(encode, &tm_q, q, bh, seq, HD, kTcBM) ||
      !tensor_map(encode, &tm_k, k, bh_kv, seq, HD, kTcBN) ||
      !tensor_map(encode, &tm_v, v, bh_kv, seq, HD, kTcBN))
    return cudaErrorInvalidValue;
  const size_t bytes = TcSmem<HD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD, kWindow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kTcBM - 1) / kTcBM);
  // scores are scaled into log2 units so that exp2 gives exp
  flash_fwd_wgmma_kernel<HD, kWindow><<<grid, kTcThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, seq, bh / bh_kv,
      scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q [bh, seq, hd], k/v [bh_kv, seq, hd], o [bh, seq, hd], all contiguous, on
// one device, of one type (is_bf16 ? bf16 : f32); lse null or f32 [bh, seq];
// window >= 0 (0, or at least seq: none).  The CUDA-core kernel: any of
// those types at hd 16, 32, 64 or 128.  Launches on `stream` and does not
// synchronise; returns the cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int bh, int bh_kv, int seq, int hd,
                                         int is_bf16, int causal, int window, float scale,
                                         void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || seq <= 0 || (seq + kBQ - 1) / kBQ > 65535 ||
      window < 0)
    return cudaErrorInvalidValue;
  if (window >= seq) window = 0;          // masks no key: the kernel without a window
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return window ? dispatch_hd<__nv_bfloat16, true>(q, k, v, o, l, bh, bh_kv, seq, hd, scale,
                                                      causal, window, s)
                  : dispatch_hd<__nv_bfloat16, false>(q, k, v, o, l, bh, bh_kv, seq, hd, scale,
                                                       causal, 0, s);
  return window ? dispatch_hd<float, true>(q, k, v, o, l, bh, bh_kv, seq, hd, scale, causal,
                                           window, s)
                : dispatch_hd<float, false>(q, k, v, o, l, bh, bh_kv, seq, hd, scale, causal, 0,
                                            s);
}

// The same arguments; the tensor-core kernel, which takes bf16 (is_bf16 = 1)
// at hd 64 or 128 with 16-byte-aligned q, k and v, and nothing else.
extern "C" int repro_flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                               void* o, void* lse, int bh, int bh_kv, int seq,
                                               int hd, int is_bf16, int causal, int window,
                                               float scale, void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || seq <= 0 ||
      (seq + kTcBM - 1) / kTcBM > 65535 || !is_bf16 || window < 0)
    return cudaErrorInvalidValue;
  if (window >= seq) window = 0;          // masks no key: the kernel without a window
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;   // TMA reads from 16-byte-aligned bases only
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64:
      return window ? launch_wgmma<64, true>(q, k, v, o, l, bh, bh_kv, seq, scale, causal,
                                             window, s)
                    : launch_wgmma<64, false>(q, k, v, o, l, bh, bh_kv, seq, scale, causal, 0, s);
    case 128:
      return window ? launch_wgmma<128, true>(q, k, v, o, l, bh, bh_kv, seq, scale, causal,
                                              window, s)
                    : launch_wgmma<128, false>(q, k, v, o, l, bh, bh_kv, seq, scale, causal, 0,
                                               s);
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
//   64-key K/V tiles (up to the diagonal when causal, from the window's
//   first tile with one), and writes dQ and D.
// * Step 2, flash_bwd_dkdv_kernel: one block per (kv head, 64-key tile),
//   keeping K and V; it walks every q tile of every query head of its
//   group (from the diagonal on when causal, up to the last row whose
//   window reaches its keys with one), so GQA's sum over the group
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
//   cores; bf16 at hd 64 and 128 goes to the tensor-core backward below.
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

template <typename T, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, int seq, int group,
                    float scale, int causal, int window) {
  using L = BwdLayout<HD>;
  constexpr int kCols = HD / 16;
  if (!kWindow) window = 0;
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
  for (int kt = window_first_tile(q0, window, kBT); kt < n_k; ++kt) {
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
        const bool keep = row < seq && col < seq && (!causal || col <= row) &&
                          in_window(col, row, window);
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

template <typename T, int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int seq, int group, float scale, int causal, int window) {
  using L = BwdLayout<HD>;
  constexpr int kCols = HD / 16;
  if (!kWindow) window = 0;
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
  // key tile 0 has the most q tiles under a causal mask alone; under a
  // window most key tiles see the same W rows, so the order stays simple
  const int k0 = blockIdx.y * kBT;
  const size_t head = static_cast<size_t>(seq) * HD;
  load_tile<T, HD>(ks, k + bkv * head, k0, seq);
  load_tile<T, HD>(vs, v + bkv * head, k0, seq);

  float acc_dk[4][kCols], acc_dv[4][kCols];   // keys ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  const int first = causal ? k0 / kBT : 0;
  const int end = window_end_tile(k0 + kBT - 1, window, kBT, (seq + kBT - 1) / kBT);
  for (int h = 0; h < group; ++h) {
    const int bh = bkv * group + h;
    for (int qt = first; qt < end; ++qt) {
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
          const bool keep = row < seq && col < seq && (!causal || col <= row) &&
                            in_window(col, row, window);
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

template <typename T, int HD, bool kWindow>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, float* delta, void* dq, void* dk, void* dv, int bh,
                       int bh_kv, int seq, float scale, int causal, int window,
                       cudaStream_t stream) {
  const int bytes = static_cast<int>(BwdLayout<HD>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD, kWindow>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD, kWindow>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (seq + kBT - 1) / kBT;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, HD, kWindow><<<dim3(bh, tiles), kThreads, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), seq, bh / bh_kv, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: step 2 reads the D that step 1 wrote
  flash_bwd_dkdv_kernel<T, HD, kWindow><<<dim3(bh_kv, tiles), kThreads, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), seq, bh / bh_kv,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T, bool kWindow>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, float* delta, void* dq, void* dk, void* dv, int bh,
                         int bh_kv, int seq, int hd, float scale, int causal, int window,
                         cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_bwd<T, 16, kWindow>(q, k, v, dout, lse, delta, dq, dk, dv, bh, bh_kv, seq, scale, causal, window, stream);
    case 32: return launch_bwd<T, 32, kWindow>(q, k, v, dout, lse, delta, dq, dk, dv, bh, bh_kv, seq, scale, causal, window, stream);
    case 64: return launch_bwd<T, 64, kWindow>(q, k, v, dout, lse, delta, dq, dk, dv, bh, bh_kv, seq, scale, causal, window, stream);
    case 128: return launch_bwd<T, 128, kWindow>(q, k, v, dout, lse, delta, dq, dk, dv, bh, bh_kv, seq, scale, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The gradient of repro_flash_attention_fwd's function.  q, dout, dq
// [bh, seq, hd]; k, v, dk, dv [bh_kv, seq, hd]; all contiguous, on one
// device, of one type (is_bf16 ? bf16 : f32); lse f32 [bh, seq] from a
// forward call on the same q, k, v, causal flag and window; delta f32
// [bh, seq] scratch, written with D.  hd 16, 32, 64 or 128, any seq >= 1,
// window >= 0 (0, or at least seq: none).  Launches two kernels on
// `stream` and does not synchronise; returns the cudaError_t of the
// launches.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, void* delta,
                                         void* dq, void* dk, void* dv, int bh, int bh_kv,
                                         int seq, int hd, int is_bf16, int causal, int window,
                                         float scale, void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || seq <= 0 || (seq + kBT - 1) / kBT > 65535 ||
      lse == nullptr || delta == nullptr || window < 0)
    return cudaErrorInvalidValue;
  if (window >= seq) window = 0;          // masks no key: the kernels without a window
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (is_bf16)
    return window ? dispatch_bwd<__nv_bfloat16, true>(q, k, v, dout, l, d, dq, dk, dv, bh, bh_kv,
                                                       seq, hd, scale, causal, window, s)
                  : dispatch_bwd<__nv_bfloat16, false>(q, k, v, dout, l, d, dq, dk, dv, bh,
                                                        bh_kv, seq, hd, scale, causal, 0, s);
  return window ? dispatch_bwd<float, true>(q, k, v, dout, l, d, dq, dk, dv, bh, bh_kv, seq, hd,
                                            scale, causal, window, s)
                : dispatch_bwd<float, false>(q, k, v, dout, l, d, dq, dk, dv, bh, bh_kv, seq, hd,
                                             scale, causal, 0, s);
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


// ---------------------------------------------------------------------------
// The tensor-core backward (bf16, hd 64 and 128).
//
// The same function as the CUDA-core backward above, for the calls whose
// forward is the tensor-core kernel: bf16 q, k, v, dO at hd 64 and 128.
// Bound at the training shape (B=1, S=4096, 32/8 heads, hd 128, causal):
// five products over the unmasked half of the score matrix, 343.6 GFLOP,
// 0.347 ms at the bf16 tensor-core peak (989 TFLOP/s, H100 SXM, 700 W);
// q/k/v/dO/dq/dk/dv are 92 MB, 0.027 ms at 3.35 TB/s.  Bound by
// operations, on the tensor cores.  Two kernels on one stream, no atomics:
// two identical calls give identical bits.
//
// * Numerics.  Every product is a wgmma with bf16 operands and f32
//   accumulators, so the products of bf16 inputs are exact.  p and dS are
//   f32; as the forward's P.V, each f32 A operand is split into
//   hi = bf16(x) and lo = bf16(x - hi), two wgmmas, which leaves 2^-17 of
//   x.  One rounding of p or dS instead misses the one-ulp limit by more
//   than 10x (tests/test_torch_flash_bwd_numerics.py).  p = exp2(S scale log2(e) -
//   lse log2(e)), the forward's natural-log lse taken to log2 units.
//   D = rowsum(p * dP) is summed in f32, never from the rounded O.  Each
//   gradient is rounded once to bf16.
// * Promotion.  The tensor cores add into their f32 accumulators with
//   truncation, and the error of each addition scales with the running
//   sum.  Under a causal mask with GQA 4:1 at S=4096, the first keys' dK
//   and dV sum 2048 wgmma steps whose first terms are the largest, and
//   where the sum cancels to a small value a kernel that kept one
//   accumulator missed the one-ulp limit several times over, while
//   autograd's f32 sum stayed within it.  So after
//   every tile each thread adds its accumulator fragment into an f32
//   master in shared memory with round-to-nearest adds and restarts the
//   fragment from zero: a fragment sums 8 wgmma steps.  The outputs come
//   from the masters.  Promoting every tile also compiled without spills
//   and ran faster on the card than promoting every 2 or 4 tiles.
// * flash_bwd_dq_wgmma_kernel: one block per (q head, 128 q rows),
//   heaviest first; the forward's layout: 288 threads, two consumer
//   warpgroups of 64 rows and a producer warp whose first lane issues
//   every TMA load; q and dO loaded once, 64-key K/V tiles through a
//   three-stage mbarrier ring.  D takes two sweeps over the keys: the
//   first computes S = q.K^T and dP = dO.V^T (one wgmma m64n64k16 each
//   per 16 of hd) and sums D; the second computes them again, forms
//   dS = p (dP - D) in registers and adds dS.K to one accumulator, K read
//   MN-major from the same tile.  The other way, dQ = scale (sum p dP K -
//   D sum p K) in one sweep as the CUDA-core kernel does, needs two
//   hd-wide accumulators beside S and dP, more registers than a thread
//   has, and it cancels in the difference; two sweeps run the same six
//   bf16 products per tile (S, dP twice; dS.K as hi and lo).  The block
//   writes each row's {lse log2(e), D} to `rowstat` for the second kernel.
// * flash_bwd_dkdv_wgmma_kernel: one block per (kv head, key tile), keys
//   first to last, so that under a causal mask the heaviest blocks start
//   first (under a window most blocks see the same W rows: the order
//   stays).  K and V are loaded once; 64-row q and dO tiles of every query
//   head of the GQA group stream through a three-stage ring (from the
//   diagonal on when causal), so the group's sum stays in the block.
//   S^T = K.q^T and dP^T = V.dO^T put the keys on wgmma's M, so P^T and
//   dS^T come out in the registers of the next products' A operand;
//   dV += P^T.dO and dK += dS^T.q read dO and q MN-major.  lse and D of
//   the tile's 64 rows are read from `rowstat`.  Each consumer warpgroup
//   sums 64 keys x 64 columns of dK and dV: at hd 64 a block has 128 keys
//   and each warpgroup its own 64; at hd 128 a block has 64 keys, both
//   warpgroups compute their S^T and dP^T, and each sums one half of hd.
// * Registers.  ptxas gives the 288 threads 168 registers each (it sizes
//   the block as three warpgroups).  A 384-thread block whose consumers
//   asked setmaxnreg for 240 still spilled: ptxas's allocator kept them
//   near 168.  So the tiles are cut to fit: a consumer holds at most
//   64 f32 accumulators (dQ at hd 128, or dK and dV) beside 64 of S and
//   dP.  Executed work per pair of q row and key: 12 bf16 products at hd
//   64, 14 at hd 128 (S^T and dP^T twice), against the bound's 5.
// * Shared memory at hd 128: dQ 225 KB (q, dO, three stages of K and V,
//   the 64 KB master); dK/dV 193 KB (K, V, three stages of q and dO, the
//   two 32 KB masters): one block an SM.
namespace {

constexpr int kDqBN = 64;                  // keys per K/V tile of the dQ kernel
constexpr int kDqStages = 3;               // its K/V ring
constexpr int kDkvBQ = 64;                 // q rows per step of the dK/dV kernel
constexpr int kDkvStages = 3;              // its q/dO ring
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct DqSmem {                            // byte offsets from a 1024-aligned base
  static constexpr int kQBytes = kTcBM * HD * 2;         // the q tile, then the dO tile
  static constexpr int kDo = kQBytes;
  static constexpr int kTileBytes = kDqBN * HD * 2;      // one K or one V tile
  static constexpr int kK = 2 * kQBytes;                 // K of stage s at kK + s * kTileBytes
  static constexpr int kV = kK + kDqStages * kTileBytes;
  static constexpr int kMaster = kV + kDqStages * kTileBytes;   // f32 dQ, HD / 2 a thread
  static constexpr int kBar = kMaster + HD / 2 * 4 * kTcConsumers;
  // barriers: q and dO full, K full [stages], V full [stages], empty [stages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kDqStages);
  static constexpr size_t kAlloc = kBytes + 1024;
};

template <int HD>
struct DkvSmem {
  static constexpr int kKeys = HD == 128 ? 64 : 128;     // keys of a block
  static constexpr int kKvBytes = kKeys * HD * 2;        // its K tile, then its V tile
  static constexpr int kV = kKvBytes;
  static constexpr int kStepBytes = kDkvBQ * HD * 2;     // one q or one dO tile
  static constexpr int kQ = 2 * kKvBytes;                // q of stage s at kQ + s * kStepBytes
  static constexpr int kDo = kQ + kDkvStages * kStepBytes;
  static constexpr int kMaster = kDo + kDkvStages * kStepBytes;   // f32 dK, then f32 dV
  static constexpr int kMasterBytes = 32 * 4 * kTcConsumers;     // 32 floats a thread
  static constexpr int kBar = kMaster + 2 * kMasterBytes;
  // barriers: K and V full, q full [stages], dO full [stages], empty [stages]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kDkvStages);
  static constexpr size_t kAlloc = kBytes + 1024;
};

// Rows of `rowstat`: the dQ kernel writes every row of its 128-row tiles.
__host__ __device__ constexpr int rowstat_rows(int seq) { return (seq + kTcBM - 1) / kTcBM * kTcBM; }

// acc into the f32 master (first: the master starts at acc), acc to zero.
// The master holds a float4 per four registers, thread-minor, so a warp's
// accesses fall in distinct banks.
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N], float4* master, bool first) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    float4 m = first ? make_float4(0.f, 0.f, 0.f, 0.f) : master[i * kTcConsumers + threadIdx.x];
    m.x += acc[4 * i];
    m.y += acc[4 * i + 1];
    m.z += acc[4 * i + 2];
    m.w += acc[4 * i + 3];
    master[i * kTcConsumers + threadIdx.x] = m;
    acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
  }
}

// Element 4 i + e of this thread's fragment, from the master.
__device__ __forceinline__ float mastered(const float4* master, int i4, int e) {
  const float4 m = master[i4 * kTcConsumers + threadIdx.x];
  return e == 0 ? m.x : e == 1 ? m.y : e == 2 ? m.z : m.w;
}

template <int HD, bool kWindow>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, float2* __restrict__ rowstat,
                          __nv_bfloat16* __restrict__ dq, int seq, int group, float scale,
                          int causal, int window) {
  using L = DqSmem<HD>;
  constexpr int kPanels = HD / kPanelCols;
  if (!kWindow) window = 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  float4* master = reinterpret_cast<float4*>(smem_raw + (base - smem_addr(smem_raw)) + L::kMaster);
  const uint32_t qd_full = base + L::kBar;
  const uint32_t k_full = qd_full + 8;                 // + 8 * stage
  const uint32_t v_full = k_full + 8 * kDqStages;
  const uint32_t empty = v_full + 8 * kDqStages;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBM;
  int end = (seq + kDqBN - 1) / kDqBN;
  if (causal) end = min(end, (q0 + kTcBM - 1) / kDqBN + 1);
  const int first = window_first_tile(q0, window, kDqBN);   // key tile of ring slot 0
  const int n_kv = end - first;

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
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
      mbar_expect_tx(qd_full, 2 * L::kQBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(base + p * kTcBM * kRowBytes, &tm_q, qd_full, p * kPanelCols, q0, bh);
        tma_load(base + L::kDo + p * kTcBM * kRowBytes, &tm_do, qd_full, p * kPanelCols, q0, bh);
      }
      // two sweeps over the key tiles: D, then dQ
      for (int j = 0; j < 2 * n_kv; ++j) {
        const int s = j % kDqStages;
        const int k0 = (first + j % n_kv) * kDqBN;
        mbar_wait(empty + 8 * s, ((j / kDqStages) & 1) ^ 1);   // the first round passes
        const uint32_t kd = base + L::kK + s * L::kTileBytes;
        const uint32_t vd = base + L::kV + s * L::kTileBytes;
        mbar_expect_tx(k_full + 8 * s, L::kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(kd + p * kDqBN * kRowBytes, &tm_k, k_full + 8 * s, p * kPanelCols, k0, kvh);
        mbar_expect_tx(v_full + 8 * s, L::kTileBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(vd + p * kDqBN * kRowBytes, &tm_v, v_full + 8 * s, p * kPanelCols, k0, kvh);
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
  const uint32_t do_tile = base + L::kDo + wg * 64 * kRowBytes;
  const float scale_log2 = scale * kLog2e;
  // lse in log2 units; rows past seq are never stored, any value will do
  const float* lp = lse + static_cast<size_t>(bh) * seq;
  const float lse_a = row_a < seq ? lp[row_a] * kLog2e : 0.f;
  const float lse_b = row_b < seq ? lp[row_b] * kLog2e : 0.f;
  const int last_row = min(q0 + wg * 64 + 63, seq - 1);   // the warpgroup's last stored row

  float acc[HD / 2];                       // the latest tile's dS K
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float s[kDqBN / 2], dp[kDqBN / 2];       // S, then p; dP

  // S and dP of the key tile in ring slot j (both sweeps walk the same
  // tiles), then p = exp2(S scale log2(e) - lse log2(e)) in place of S,
  // 0 past seq, above the diagonal and outside the window
  const auto tile = [&](int j) {
    const int st = j % kDqStages;
    const uint32_t parity = (j / kDqStages) & 1;
    const int k0 = (first + j % n_kv) * kDqBN;
    const uint32_t k_tile = base + L::kK + st * L::kTileBytes;
    const uint32_t v_tile = base + L::kV + st * L::kTileBytes;
    mbar_wait(k_full + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk % 4) * 32;   // 16 columns into panel kk / 4
      wgmma_scores(s, desc_k_major(q_tile + (kk / 4) * kTcBM * kRowBytes + koff),
                   desc_k_major(k_tile + (kk / 4) * kDqBN * kRowBytes + koff), kk > 0);
    }
    wgmma_commit();
    mbar_wait(v_full + 8 * st, parity);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk % 4) * 32;
      wgmma_scores(dp, desc_k_major(do_tile + (kk / 4) * kTcBM * kRowBytes + koff),
                   desc_k_major(v_tile + (kk / 4) * kDqBN * kRowBytes + koff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();                       // S has landed; dP is still running
    fence_regs(s);
    const bool edge = k0 + kDqBN > seq || (causal && k0 + kDqBN - 1 > q0 + wg * 64) ||
                      (window > 0 && k0 + window <= last_row);
#pragma unroll
    for (int i = 0; i < kDqBN / 2; ++i) {
      const float p = exp2f(fmaf(s[i], scale_log2, (i & 2) ? -lse_b : -lse_a));
      const int c = k0 + 8 * (i / 4) + col + (i & 1);
      const int r = (i & 2) ? row_b : row_a;
      s[i] = edge && (c >= seq || (causal && c > r) || !in_window(c, r, window)) ? 0.f : p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
  };

  mbar_wait(qd_full, 0);
  float d_a = 0.f, d_b = 0.f;              // sweep 1: this thread's share of D
  for (int j = 0; j < n_kv; ++j) {
    tile(j);
#pragma unroll
    for (int i = 0; i < kDqBN / 2; ++i) {
      if (i & 2) d_b = fmaf(s[i], dp[i], d_b);
      else d_a = fmaf(s[i], dp[i], d_a);
    }
    mbar_arrive(empty + 8 * (j % kDqStages));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // D: the quad's shares summed
    d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
    d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
  }
  if (col == 0) {                          // every row of the tile, past seq too
    float2* rs = rowstat + static_cast<size_t>(bh) * rowstat_rows(seq);
    rs[row_a] = make_float2(lse_a, d_a);
    rs[row_b] = make_float2(lse_b, d_b);
  }

  for (int j = n_kv; j < 2 * n_kv; ++j) {  // sweep 2: dQ
    tile(j);
    // dS = p (dP - D) as hi + lo bf16 pairs in the A-operand order of dS.K
    uint32_t hi[kDqBN / 4], lo[kDqBN / 4];
#pragma unroll
    for (int i = 0; i < kDqBN / 4; ++i) {
      const float d = (i & 1) ? d_b : d_a;
      split_bf16(s[2 * i] * (dp[2 * i] - d), s[2 * i + 1] * (dp[2 * i + 1] - d), hi[i], lo[i]);
    }
    const uint32_t k_tile = base + L::kK + (j % kDqStages) * L::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqBN / 16; ++kk)
      wgmma_pv(acc, hi + 4 * kk, desc_mn_major(k_tile + kk * 16 * kRowBytes, kDqBN));
#pragma unroll
    for (int kk = 0; kk < kDqBN / 16; ++kk)
      wgmma_pv(acc, lo + 4 * kk, desc_mn_major(k_tile + kk * 16 * kRowBytes, kDqBN));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * (j % kDqStages));
    promote(acc, master, j == n_kv);
  }

  __nv_bfloat16* dqp = dq + static_cast<size_t>(bh) * seq * HD;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const int d = 8 * c + col;
    if (row_a < seq)
      *reinterpret_cast<__nv_bfloat162*>(dqp + static_cast<size_t>(row_a) * HD + d) =
          __floats2bfloat162_rn(scale * mastered(master, c, 0), scale * mastered(master, c, 1));
    if (row_b < seq)
      *reinterpret_cast<__nv_bfloat162*>(dqp + static_cast<size_t>(row_b) * HD + d) =
          __floats2bfloat162_rn(scale * mastered(master, c, 2), scale * mastered(master, c, 3));
  }
}

template <int HD, bool kWindow>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float2* __restrict__ rowstat, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int seq, int group, float scale,
                            int causal, int window) {
  using L = DkvSmem<HD>;
  constexpr int kPanels = HD / kPanelCols;
  if (!kWindow) window = 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  float4* master_dk =
      reinterpret_cast<float4*>(smem_raw + (base - smem_addr(smem_raw)) + L::kMaster);
  float4* master_dv = master_dk + L::kMasterBytes / 16;
  const uint32_t kv_full = base + L::kBar;
  const uint32_t q_full = kv_full + 8;                 // + 8 * stage
  const uint32_t do_full = q_full + 8 * kDkvStages;
  const uint32_t empty = do_full + 8 * kDkvStages;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * L::kKeys;    // key tile 0 has the most q tiles under a causal mask
  const int first = causal ? k0 / kDkvBQ : 0;   // earlier q rows see none of these keys
  // nor do rows past the window of the block's last key
  const int end = window_end_tile(k0 + L::kKeys - 1, window, kDkvBQ, (seq + kDkvBQ - 1) / kDkvBQ);
  const int per_head = end - first;
  const int steps = group * per_head;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(do_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    if (tid == kTcConsumers) {
      mbar_expect_tx(kv_full, 2 * L::kKvBytes);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(base + p * L::kKeys * kRowBytes, &tm_k, kv_full, p * kPanelCols, k0, bkv);
        tma_load(base + L::kV + p * L::kKeys * kRowBytes, &tm_v, kv_full, p * kPanelCols, k0,
                 bkv);
      }
      // every q tile of every query head of the group, head by head
      for (int j = 0; j < steps; ++j) {
        const int s = j % kDkvStages;
        const int bh = bkv * group + j / per_head;
        const int q0 = (first + j % per_head) * kDkvBQ;
        mbar_wait(empty + 8 * s, ((j / kDkvStages) & 1) ^ 1);
        const uint32_t qd = base + L::kQ + s * L::kStepBytes;
        const uint32_t dd = base + L::kDo + s * L::kStepBytes;
        mbar_expect_tx(q_full + 8 * s, L::kStepBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(qd + p * kDkvBQ * kRowBytes, &tm_q, q_full + 8 * s, p * kPanelCols, q0, bh);
        mbar_expect_tx(do_full + 8 * s, L::kStepBytes);
        for (int p = 0; p < kPanels; ++p)
          tma_load(dd + p * kDkvBQ * kRowBytes, &tm_do, do_full + 8 * s, p * kPanelCols, q0, bh);
      }
    }
    return;
  }

  // consumer warpgroup wg sums keys key0 .. + 63 at hd columns col0 .. + 63;
  // this thread holds keys key_a and key_a + 8 at q rows 8 c + col + {0, 1}
  // of every chunk c of S^T, and at columns col0 + 8 c + col + {0, 1} of dK
  // and dV
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int key0 = k0 + (HD == 128 ? 0 : 64 * wg);
  const int col0 = HD == 128 ? 64 * wg : 0;
  const int key_a = key0 + (tid % 128) / 32 * 16 + lane / 4;
  const int key_b = key_a + 8;
  const int col = 2 * (lane % 4);
  const uint32_t k_rows = base + (key0 - k0) * kRowBytes;
  const uint32_t v_rows = base + L::kV + (key0 - k0) * kRowBytes;
  const uint32_t panel = (col0 / kPanelCols) * kDkvBQ * kRowBytes;   // col0's panel of q and dO
  const float scale_log2 = scale * kLog2e;
  const int stat_rows = rowstat_rows(seq);

  float acc_dk[32], acc_dv[32];            // the latest step's sums
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  float s[kDkvBQ / 2], dp[kDkvBQ / 2];     // S^T, then P^T; dP^T

  mbar_wait(kv_full, 0);
  for (int j = 0; j < steps; ++j) {
    const int st = j % kDkvStages;
    const uint32_t parity = (j / kDkvStages) & 1;
    const int bh = bkv * group + j / per_head;
    const int q0 = (first + j % per_head) * kDkvBQ;
    const uint32_t q_tile = base + L::kQ + st * L::kStepBytes;
    const uint32_t do_tile = base + L::kDo + st * L::kStepBytes;

    mbar_wait(q_full + 8 * st, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk % 4) * 32;
      wgmma_scores(s, desc_k_major(k_rows + (kk / 4) * L::kKeys * kRowBytes + koff),
                   desc_k_major(q_tile + (kk / 4) * kDkvBQ * kRowBytes + koff), kk > 0);
    }
    wgmma_commit();
    mbar_wait(do_full + 8 * st, parity);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t koff = (kk % 4) * 32;
      wgmma_scores(dp, desc_k_major(v_rows + (kk / 4) * L::kKeys * kRowBytes + koff),
                   desc_k_major(do_tile + (kk / 4) * kDkvBQ * kRowBytes + koff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp2(S^T scale log2(e) - lse[q] log2(e)) and dS^T = P^T (dP^T -
    // D[q]), 0 past seq, above the diagonal and outside the window; both as
    // hi + lo bf16 pairs
    const bool edge = q0 + kDkvBQ > seq || (causal && q0 < key0 + 63) ||
                      (window > 0 && key0 + window <= min(q0 + kDkvBQ - 1, seq - 1));
    // {lse log2(e), D} of q rows 8 c + col and + 1: one 16-byte load a chunk
    const float2* stat = rowstat + static_cast<size_t>(bh) * stat_rows + q0 + col;
    uint32_t p_hi[kDkvBQ / 4], p_lo[kDkvBQ / 4], ds_hi[kDkvBQ / 4], ds_lo[kDkvBQ / 4];
#pragma unroll
    for (int c = 0; c < kDkvBQ / 8; ++c) {
      const float4 rs = __ldg(reinterpret_cast<const float4*>(stat + 8 * c));
      const int qr = q0 + 8 * c + col;
#pragma unroll
      for (int h = 0; h < 2; ++h) {        // pair 2 c + h: key_a, then key_b
        const int i = 4 * c + 2 * h;
        const int key = h ? key_b : key_a;
        float p0 = exp2f(fmaf(s[i], scale_log2, -rs.x));
        float p1 = exp2f(fmaf(s[i + 1], scale_log2, -rs.z));
        if (edge) {
          if (qr >= seq || (causal && qr < key) || !in_window(key, qr, window)) p0 = 0.f;
          if (qr + 1 >= seq || (causal && qr + 1 < key) || !in_window(key, qr + 1, window))
            p1 = 0.f;
        }
        split_bf16(p0, p1, p_hi[2 * c + h], p_lo[2 * c + h]);
        split_bf16(p0 * (dp[i] - rs.y), p1 * (dp[i + 1] - rs.w), ds_hi[2 * c + h],
                   ds_lo[2 * c + h]);
      }
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvBQ / 16; ++kk)
      wgmma_pv(acc_dv, p_hi + 4 * kk, desc_mn_major(do_tile + panel + kk * 16 * kRowBytes, kDkvBQ));
#pragma unroll
    for (int kk = 0; kk < kDkvBQ / 16; ++kk)
      wgmma_pv(acc_dv, p_lo + 4 * kk, desc_mn_major(do_tile + panel + kk * 16 * kRowBytes, kDkvBQ));
#pragma unroll
    for (int kk = 0; kk < kDkvBQ / 16; ++kk)
      wgmma_pv(acc_dk, ds_hi + 4 * kk, desc_mn_major(q_tile + panel + kk * 16 * kRowBytes, kDkvBQ));
#pragma unroll
    for (int kk = 0; kk < kDkvBQ / 16; ++kk)
      wgmma_pv(acc_dk, ds_lo + 4 * kk, desc_mn_major(q_tile + panel + kk * 16 * kRowBytes, kDkvBQ));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    mbar_arrive(empty + 8 * st);
    promote(acc_dk, master_dk, j == 0);
    promote(acc_dv, master_dv, j == 0);
  }

  const size_t head = static_cast<size_t>(bkv) * seq * HD;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int d = col0 + 8 * c + col;
    if (key_a < seq) {
      const size_t at = head + static_cast<size_t>(key_a) * HD + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          scale * mastered(master_dk, c, 0), scale * mastered(master_dk, c, 1));
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(mastered(master_dv, c, 0), mastered(master_dv, c, 1));
    }
    if (key_b < seq) {
      const size_t at = head + static_cast<size_t>(key_b) * HD + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          scale * mastered(master_dk, c, 2), scale * mastered(master_dk, c, 3));
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(mastered(master_dv, c, 2), mastered(master_dv, c, 3));
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD, bool kWindow>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, float2* rowstat, void* dq, void* dk, void* dv,
                             int bh, int bh_kv, int seq, float scale, int causal, int window,
                             cudaStream_t stream) {
  using Lq = DqSmem<HD>;
  using Lkv = DkvSmem<HD>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // q and dO in 128-row boxes for the dQ kernel and 64-row boxes for the
  // dK/dV kernel; K and V in the boxes of each kernel's key tile
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_q64, tm_do64, tm_kb, tm_vb;
  if (!tensor_map(encode, &tm_q, q, bh, seq, HD, kTcBM) ||
      !tensor_map(encode, &tm_do, dout, bh, seq, HD, kTcBM) ||
      !tensor_map(encode, &tm_k, k, bh_kv, seq, HD, kDqBN) ||
      !tensor_map(encode, &tm_v, v, bh_kv, seq, HD, kDqBN) ||
      !tensor_map(encode, &tm_q64, q, bh, seq, HD, kDkvBQ) ||
      !tensor_map(encode, &tm_do64, dout, bh, seq, HD, kDkvBQ) ||
      !tensor_map(encode, &tm_kb, k, bh_kv, seq, HD, Lkv::kKeys) ||
      !tensor_map(encode, &tm_vb, v, bh_kv, seq, HD, Lkv::kKeys))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<HD, kWindow>, Lq::kAlloc);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkdv_wgmma_kernel<HD, kWindow>, Lkv::kAlloc);
  if (err != cudaSuccess) return err;
  const int group = bh / bh_kv;
  flash_bwd_dq_wgmma_kernel<HD, kWindow><<<dim3(bh, (seq + kTcBM - 1) / kTcBM), kTcThreads,
                                           Lq::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, rowstat, static_cast<__nv_bfloat16*>(dq), seq, group, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: the dK/dV kernel reads the rowstat that the dQ kernel wrote
  flash_bwd_dkdv_wgmma_kernel<HD, kWindow><<<dim3(bh_kv, (seq + Lkv::kKeys - 1) / Lkv::kKeys),
                                             kTcThreads, Lkv::kAlloc, stream>>>(
      tm_q64, tm_kb, tm_vb, tm_do64, rowstat, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq, group, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// The tensor-core backward: repro_flash_attention_bwd's arguments, for bf16
// (is_bf16 = 1) at hd 64 or 128 with 16-byte-aligned q, k, v and dout, and
// nothing else.  The scratch is f32 [bh, round_up(seq, 128), 2] (`rowstat`:
// each row's lse in log2 units and D), written by the first kernel and read
// by the second.
extern "C" int repro_flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               void* rowstat, void* dq, void* dk, void* dv,
                                               int bh, int bh_kv, int seq, int hd, int is_bf16,
                                               int causal, int window, float scale,
                                               void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || seq <= 0 ||
      (seq + kDkvBQ - 1) / kDkvBQ > 65535 || !is_bf16 || lse == nullptr || rowstat == nullptr ||
      window < 0)
    return cudaErrorInvalidValue;
  if (window >= seq) window = 0;          // masks no key: the kernels without a window
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(rowstat)) % 16 != 0)
    return cudaErrorMisalignedAddress;   // TMA and the rowstat loads need 16-byte alignment
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float2* rs = static_cast<float2*>(rowstat);
  switch (hd) {
    case 64:
      return window ? launch_bwd_wgmma<64, true>(q, k, v, dout, l, rs, dq, dk, dv, bh, bh_kv, seq,
                                                 scale, causal, window, s)
                    : launch_bwd_wgmma<64, false>(q, k, v, dout, l, rs, dq, dk, dv, bh, bh_kv,
                                                  seq, scale, causal, 0, s);
    case 128:
      return window ? launch_bwd_wgmma<128, true>(q, k, v, dout, l, rs, dq, dk, dv, bh, bh_kv,
                                                  seq, scale, causal, window, s)
                    : launch_bwd_wgmma<128, false>(q, k, v, dout, l, rs, dq, dk, dv, bh, bh_kv,
                                                   seq, scale, causal, 0, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the tensor-core backward's two kernels at `hd`,
// in bytes: which = 0 the dQ kernel, 1 the dK/dV kernel (0 if hd is not
// 64 or 128).
extern "C" int repro_flash_attention_bwd_wgmma_smem_bytes(int hd, int which) {
  switch (hd) {
    case 64: return static_cast<int>(which ? DkvSmem<64>::kAlloc : DqSmem<64>::kAlloc);
    case 128: return static_cast<int>(which ? DkvSmem<128>::kAlloc : DqSmem<128>::kAlloc);
    default: return 0;
  }
}
