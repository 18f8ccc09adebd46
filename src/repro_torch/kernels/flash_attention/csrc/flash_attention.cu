// flash_attention: GQA attention forward with an online softmax on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py, function
// _flash_kernel (called through flash_attention), and computes what it
// computes: for each (batch, query head h) and each query row, softmax
// over the keys of kv head h / group of (q . k) * D^-0.5, with a causal
// mask (k <= q) and an optional sliding window (k > q - window), times
// v. The running (m, l, acc) of the online softmax are float32; a
// masked score is -1e30 and its weight is 0; the output is
// acc / max(l, 1e-30) in the input's type (float32 or bf16). Unlike the
// TPU kernel, S need not be a multiple of the tile: a ragged last tile
// of queries or keys is masked here.
//
// What bounds it on this card. At the serving shape (B=4, S=512,
// Hq=25, Hkv=5, D=64, bf16, causal) the function moves 15.7 MB (q, k,
// v read once, out written once), 4.7 us at 3.35 TB/s, and needs 3.4
// GFLOP, 3.4 us at the bf16 tensor-core peak: it is near the ridge,
// and a kernel that reaches either bound has to run its products on the
// tensor cores (wgmma) from tiles staged by TMA. This first kernel does
// not: its products are float32 multiply-adds on the CUDA cores with
// both operands read from shared memory, so shared-memory bandwidth
// (two loads per multiply-add) sets its time.
//
// What the design does. One block per (b * Hq + h, query tile of
// block_q<D>() rows: 64, or 32 at D=256, where 64 rows' tiles would take
// 280,064 B of shared memory, above the 232,448 B a block may have); the
// TPU grid's sequential kv axis becomes a loop inside the block, since
// blocks run in no order. The block loads its query tile once and walks
// only the kv tiles that the causal mask and the window leave (the
// TPU kernel's pl.when skip), so the work per query tile is O(window).
// Each kv tile is converted to float32 into shared memory (rows padded
// by one float so that a warp reading 32 keys' rows hits 32 banks); the
// scores, the per-row max and sum (one warp per row, shuffles) and the
// rescaled accumulator all stay in shared memory, so nothing but q, k,
// v and the output touches device memory. Inputs are read through their
// strides, so the model's (B, S, H, D) projections are used in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;       // keys per kv tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Strides {  // in elements: batch, head, sequence (last dim is 1)
  long long q[3], k[3], v[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// query rows per block: 64, and 32 at D=256 to fit a block's shared memory
template <int D>
__host__ __device__ constexpr int block_q() {
  return D == 256 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
  // q, k (pitch D+1), v, acc (pitch D), scores (pitch BK+1), m, l, corr:
  // 214,528 B at D=192, 205,696 B at D=256 (32 query rows)
  constexpr int kBQ = block_q<D>();
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * D +
         kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides st, int Hq,
          int group, int S, float scale, int causal, int window) {
  extern __shared__ float smem[];
  constexpr int kBQ = block_q<D>();
  constexpr int QP = D + 1;
  constexpr int SP = kBK + 1;
  float* sq = smem;               // kBQ x QP
  float* sk = sq + kBQ * QP;      // kBK x QP
  float* sv = sk + kBK * QP;      // kBK x D
  float* sacc = sv + kBK * D;     // kBQ x D
  float* ss = sacc + kBQ * D;     // kBQ x SP
  float* sm = ss + kBQ * SP;      // kBQ
  float* sl = sm + kBQ;           // kBQ
  float* scorr = sl + kBQ;        // kBQ

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / group;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D, qi = q0 + i;
    sq[i * QP + d] = qi < S ? to_f32(qb[qi * st.q[2] + d]) : 0.f;
    sacc[e] = 0.f;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    sm[i] = kNegInf;
    sl[i] = 0.f;
  }

  // kv tiles that some row of this query tile may see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  for (int t = k_first / kBK; t <= k_last / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int j = e / D, d = e % D, kj = k0 + j;
      const bool in = kj < S;
      sk[j * QP + d] = in ? to_f32(kb[kj * st.k[2] + d]) : 0.f;
      sv[e] = in ? to_f32(vb[kj * st.v[2] + d]) : 0.f;
    }
    __syncthreads();

    // scores, masked to -1e30
    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int i = e / kBK, j = e % kBK, qi = q0 + i, kj = k0 + j;
      const float* qr = sq + i * QP;
      const float* kr = sk + j * QP;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
      bool keep = kj < S;
      if (causal) keep = keep && kj <= qi;
      if (window > 0) keep = keep && kj > qi - window;
      ss[i * SP + j] = keep ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per row, each lane two columns
    for (int i = warp; i < kBQ; i += kThreads / 32) {
      float* sr = ss + i * SP;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm[i];
      const float m_cur = fmaxf(m_prev, mx);
      const float p0 = s0 == kNegInf ? 0.f : expf(s0 - m_cur);
      const float p1 = s1 == kNegInf ? 0.f : expf(s1 - m_cur);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_cur);
        sl[i] = sl[i] * corr + sum;
        sm[i] = m_cur;
        scorr[i] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
    for (int e = tid; e < kBQ * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const float* pr = ss + i * SP;
      float a = sacc[e] * scorr[i];
#pragma unroll 16
      for (int j = 0; j < kBK; ++j) a += pr[j] * sv[j * D + d];
      sacc[e] = a;
    }
  }
  __syncthreads();

  T* ob = o + ((long long)b * Hq + h) * S * D;
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int i = e / D, d = e % D, qi = q0 + i;
    if (qi < S) store(ob + (long long)qi * D + d, sacc[e] / fmaxf(sl[i], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int Hq, int Hkv, int S, float scale,
           int causal, int window, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hq, (S + block_q<D>() - 1) / block_q<D>());
  flash_fwd<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, Hq, Hq / Hkv, S,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const Strides& st, int B, int Hq, int Hkv, int S, int D,
             float scale, int causal, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, st, B, Hq, Hkv, S, scale, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, st, B, Hq, Hkv, S, scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, st, B, Hq, Hkv, S, scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, st, B, Hq, Hkv, S, scale, causal, window, s);
    case 192: return launch<T, 192>(q, k, v, o, st, B, Hq, Hkv, S, scale, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, o, st, B, Hq, Hkv, S, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. q (B, Hq, S, D), k and v (B, Hkv, S, D), each read
// through `strides` (9 values: batch, head and sequence strides of q,
// k, v in elements; the last dim is contiguous); o is a contiguous
// (B, Hq, S, D) of the same type. bf16 when `is_bf16`, else float32.
// Scores are (q . k) * scale; window <= 0 means none. Returns the
// cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int B, int Hq,
                           int Hkv, int S, int D, float scale, int causal,
                           int window, int is_bf16, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, st, B, Hq, Hkv, S, D, scale,
                                   causal, window, s);
  return dispatch<float>(q, k, v, o, st, B, Hq, Hkv, S, D, scale, causal,
                         window, s);
}

}  // extern "C"
