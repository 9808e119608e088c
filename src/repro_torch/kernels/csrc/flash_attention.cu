// Flash attention forward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _kernel): softmax(q k^T * hd^-0.5) v over
// q [BHq, S, hd] and k/v [BHkv, S, hd], causal or full, GQA by mapping
// query head bh to kv head bh / group without repeating K/V.  f32 and
// bf16 inputs; q, k and v are upcast to f32 and q is scaled in f32, as
// the TPU kernel does, and the running max, sum and accumulator stay in
// f32.  The output is cast to the input type.
//
// Bound at the main-path shape (one llama3_8b prefill layer: B=1,
// S=4096, Hq=32, Hkv=8, hd=128, causal, bf16): the unmasked half of the
// score matrix needs 4*hd*S*(S+1)/2*Hq = 137.5 GFLOP, 0.139 ms at the
// H100 SXM's 989 TFLOP/s bf16 dense (spec sheet, 700 W); q/k/v/o are
// 83.9 MB, 0.025 ms at 3.35 TB/s.  So it is bound by operations.
//
// Design.  This first version is simple and right, not fast: it does
// its arithmetic in f32 on the CUDA cores (no tensor cores), so it sits
// far from that bound; wgmma, TMA and warp specialisation come later.
// * The TPU kernel's sequential K axis becomes a loop inside the block:
//   one block of 256 threads owns one (bh, 64-row q tile) and walks the
//   64-column K/V tiles, keeping q*scale in shared memory and its slice
//   of the output accumulator in registers (4 rows x hd/16 columns per
//   thread).
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
                 const T* __restrict__ v, T* __restrict__ o,
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
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int bh_kv,
                   int seq, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), seq, bh / bh_kv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, int bh, int bh_kv,
                        int seq, int hd, float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, bh, bh_kv, seq, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, bh_kv, seq, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, bh_kv, seq, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, bh_kv, seq, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [bh, seq, hd], k/v [bh_kv, seq, hd], o [bh, seq, hd], all contiguous, on
// one device, of one type (is_bf16 ? bf16 : f32).  Launches on `stream` and
// does not synchronise; returns the cudaError_t of the launch.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int bh, int bh_kv, int seq, int hd, int is_bf16,
                                         int causal, float scale, void* stream) {
  if (bh <= 0 || bh_kv <= 0 || bh % bh_kv != 0 || seq <= 0 || (seq + kBQ - 1) / kBQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_hd<__nv_bfloat16>(q, k, v, o, bh, bh_kv, seq, hd, scale, causal, s);
  return dispatch_hd<float>(q, k, v, o, bh, bh_kv, seq, hd, scale, causal, s);
}
