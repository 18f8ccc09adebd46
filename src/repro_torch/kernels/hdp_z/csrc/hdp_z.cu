// hdp_z: the doubly sparse HDP z-sweep on Hopper (sm_90a), one document
// per warp. It is now the "warp" route of kernels/hdp_z/hdp_z.py, taken
// only where the "lanes" route (csrc/hdp_z_lanes.cu, one document per
// lane) does not fit: 32 documents' int16 m above the card's shared
// memory per block, or L above 32767.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hdp_z/hdp_z.py,
// function _z_kernel (called through hdp_z_pallas), and computes what it
// computes: for every document, the per-document topic histogram m from
// the incoming z, then a sequential collapsed-Gibbs pass over the
// document's tokens. Per live token: m[z_old] -= 1; term (b)
// wb = vals * m[ids] over the word's W table slots, drawn by inverse CDF
// over the slot prefix c; term (a) by an O(1) alias draw over the same
// slots; the branch (t < qb) | (qa <= 0); a token with zero total mass
// keeps its topic; m[k_new] += 1. Outputs z_new (D, L), the final m
// (D, K) and, with emit_delta, dn (K, V): +1 at (k_new, v) and -1 at
// (z_old, v) for every live token whose topic changed.
//
// Two modes, as in the TPU kernel:
//   table mode    q_a (V,), fpack (V, 2, W) f32 [vals, aprob],
//                 ipack (V, 2, W) i32 [ids, alias]
//   prologue mode apsi (K,) = alpha * psi, vals (V, W) f32, ids (V, W)
//                 i32; wa = vals * apsi[ids], q_a = sum(wa) and the
//                 alias entry of the drawn slot are built per token.
// Table mode also takes compact tables, fpack in bf16 and ipack in int16
// (K <= 32768), each element widened as it is read (bf16 to float32 by
// a 16-bit shift, int16 to int32 by sign extension; both exact).
//
// What bounds it on the card. Within a document every token depends on
// the one before (m changes), so a sweep is a chain of L dependent steps
// per document; the float sums over the W slots follow one canonical
// order, left to right (qb = c[W-1]), which the plain PyTorch version
// (kernels/hdp_z/ref.py) also follows, so the two agree bit for bit.
// That order is serial: lane 0 of the warp walks the slots. The bytes
// the sweep must move (tokens, z, mask, uniforms, m, tables, dn: under
// 1 GB at PubMed 0.01 with K=1000, W=256) take a fraction of a
// millisecond at 3.35 TB/s; the dependent chain of W float adds per
// token, not memory, sets the time.
//
// What the design does about it. One warp per document, several
// documents per block, so the card holds thousands of independent
// chains in flight and hides each chain's latency behind the others.
// m (K int32) lives in the warp's slice of dynamic shared memory, so
// the gather m[ids] never leaves the SM. The word's table row is read
// straight from global memory (the tables, about 28 MB at the main
// shape, stay in the 50 MB L2). Lanes split the W-wide work (products,
// comparisons, counts by ballot); only the prefix sums are serial. In
// prologue mode only the drawn slot's alias entry is derived (O(W) per
// token, not the O(W^2) one-hot build), and only when the global branch
// is taken. There is no grid-wide state: dn is zeroed by the caller and
// accumulated with int32 atomicAdd, which commutes, so the result does
// not depend on block order. The build uses --fmad=false and the _rn
// intrinsics so that no multiply-add is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The element types of a table row: float32 values and int32 ids, or
// (COMPACT) bf16 values and int16 ids; widen() reads either as float32
// and int32, exactly.
template <bool COMPACT>
struct Tab {
  using F = float;
  using I = int32_t;
};
template <>
struct Tab<true> {
  using F = uint16_t;  // bf16 bits
  using I = int16_t;
};
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}
__device__ __forceinline__ int widen(int32_t x) { return x; }
__device__ __forceinline__ int widen(int16_t x) { return x; }

// Count of slots j < W with pred(j), identical in every lane.
template <class Pred>
__device__ __forceinline__ int warp_count(int W, int lane, Pred pred) {
  int cnt = 0;
  for (int base = 0; base < W; base += 32) {
    const int j = base + lane;
    cnt += __popc(__ballot_sync(kFull, j < W && pred(j)));
  }
  return cnt;
}

// First slot j < W with pred(j), or -1; identical in every lane.
template <class Pred>
__device__ __forceinline__ int warp_first(int W, int lane, Pred pred) {
  for (int base = 0; base < W; base += 32) {
    const int j = base + lane;
    const unsigned b = __ballot_sync(kFull, j < W && pred(j));
    if (b) return base + __ffs(b) - 1;
  }
  return -1;
}

template <bool IN_KERNEL, bool EMIT, bool COMPACT>
__global__ void hdp_z_kernel(
    const int32_t* __restrict__ tokens,  // (D, L)
    const uint8_t* __restrict__ mask,    // (D, L) bool
    const int32_t* __restrict__ z_in,    // (D, L)
    const float* __restrict__ uni,       // (D, L, 3)
    const float* __restrict__ q_a,       // table mode: (V,)
    const float* __restrict__ apsi,      // prologue mode: (K,)
    const typename Tab<COMPACT>::F* __restrict__ fvals,  // (V, 2, W) or (V, W)
    const typename Tab<COMPACT>::I* __restrict__ ivals,  // (V, 2, W) or (V, W)
    int32_t* __restrict__ z_out,         // (D, L)
    int32_t* __restrict__ m_out,         // (D, K)
    int32_t* __restrict__ dn,            // (K, V), zeroed by the caller
    int D, int L, int K, int V, int W) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int doc = blockIdx.x * (blockDim.x >> 5) + warp;

  // Per-warp slice: m[K] | c[W] | prologue: q[W] dcum[W] ucum[W] rank[W]
  const int per_warp = K + (IN_KERNEL ? 5 : 1) * W;
  int32_t* m = smem + (size_t)warp * per_warp;
  float* c = reinterpret_cast<float*>(m + K);
  float* q = c + W;
  float* dcum = q + W;
  float* ucum = dcum + W;
  int32_t* rank = reinterpret_cast<int32_t*>(ucum + W);

  if (doc >= D) return;  // whole warp: no block-wide barrier is used
  const int64_t row = (int64_t)doc * L;
  const int fstride = IN_KERNEL ? W : 2 * W;

  for (int k = lane; k < K; k += 32) m[k] = 0;
  __syncwarp();
  for (int i = lane; i < L; i += 32)
    if (mask[row + i]) atomicAdd(&m[z_in[row + i]], 1);
  __syncwarp();

  for (int i = 0; i < L; ++i) {
    const int z_old = z_in[row + i];
    if (!mask[row + i]) {  // padding keeps its value and touches nothing
      if (lane == 0) z_out[row + i] = z_old;
      continue;
    }
    const int v = tokens[row + i];
    const auto* vrow = fvals + (int64_t)v * fstride;
    const auto* idrow = ivals + (int64_t)v * fstride;
    const float u1 = uni[(row + i) * 3 + 0];
    const float u2 = uni[(row + i) * 3 + 1];
    const float u3 = uni[(row + i) * 3 + 2];

    if (lane == 0) m[z_old] -= 1;  // m^{-i}, before the gather
    __syncwarp();
    for (int j = lane; j < W; j += 32) {
      const int id = widen(idrow[j]);
      const float val = widen(vrow[j]);
      c[j] = __fmul_rn(val, (float)m[id]);
      if (IN_KERNEL) q[j] = __fmul_rn(val, apsi[id]);
    }
    __syncwarp();

    // Canonical order: one lane, left to right over the slots.
    float qb = 0.f, qa = 0.f, total = 0.f;
    if (lane == 0) {
      float acc = c[0];
      for (int j = 1; j < W; ++j) {
        acc = __fadd_rn(acc, c[j]);
        c[j] = acc;
      }
      qb = acc;
      if (IN_KERNEL) {
        // q_a sums the raw wa; the alias normalisation sums the wa with
        // non-finite and negative entries cleared (core/alias.py).
        const float w0 = q[0];
        float a = w0;
        float tsum = (isfinite(w0) && w0 > 0.f) ? w0 : 0.f;
        for (int j = 1; j < W; ++j) {
          const float wj = q[j];
          a = __fadd_rn(a, wj);
          tsum = __fadd_rn(tsum, (isfinite(wj) && wj > 0.f) ? wj : 0.f);
        }
        qa = a;
        total = tsum;
      }
    }
    __syncwarp();  // lane 0's prefix c is visible to every lane
    qb = __shfl_sync(kFull, qb, 0);
    if (IN_KERNEL) {
      qa = __shfl_sync(kFull, qa, 0);
      total = __shfl_sync(kFull, total, 0);
    } else {
      qa = q_a[v];
    }
    const float tot = __fadd_rn(qa, qb);
    const float t = __fmul_rn(u1, tot);
    const bool doc_branch = (t < qb) || (qa <= 0.f);

    int k_new = z_old;
    if (tot > 0.f) {
      if (doc_branch) {
        int slot_b = warp_count(W, lane, [&](int j) { return c[j] < t; });
        slot_b = min(slot_b, W - 1);
        k_new = widen(idrow[slot_b]);
      } else {
        const int s = min((int)__fmul_rn(u2, (float)W), W - 1);
        float prob;
        int alias;
        if (IN_KERNEL) {
          // q = p / mean(p), then the deficit/surplus lines.
          for (int j = lane; j < W; j += 32) {
            const float wj = q[j];
            const float pj = (isfinite(wj) && wj > 0.f) ? wj : 0.f;
            const float qj =
                total > 0.f
                    ? __fmul_rn(__fdiv_rn(pj, fmaxf(total, 1e-30f)), (float)W)
                    : 1.0f;
            q[j] = qj;
          }
          __syncwarp();
          int ns = 0, nl = 0;
          if (lane == 0) {
            float da = 0.f, ua = 0.f;
            for (int j = 0; j < W; ++j) {
              const float qj = q[j];
              const bool sm = qj < 1.0f;
              const float dj = sm ? __fsub_rn(1.0f, qj) : 0.f;
              const float uj = sm ? 0.f : __fsub_rn(qj, 1.0f);
              da = j == 0 ? dj : __fadd_rn(da, dj);
              ua = j == 0 ? uj : __fadd_rn(ua, uj);
              dcum[j] = da;
              ucum[j] = ua;
              rank[j] = sm ? ns++ : nl++;
            }
          }
          ns = __shfl_sync(kFull, ns, 0);
          nl = __shfl_sync(kFull, nl, 0);
          __syncwarp();
          const float qs = q[s];
          if (qs < 1.0f) {
            // small: donor = the large of rank r, r = #{large j: U[j] < D-before}
            prob = qs;
            const float dprev = __fsub_rn(dcum[s], __fsub_rn(1.0f, qs));
            const int r = warp_count(W, lane, [&](int j) {
              return !(q[j] < 1.0f) && ucum[j] < dprev;
            });
            alias = s;
            if (r < nl)
              alias = warp_first(W, lane, [&](int j) {
                return !(q[j] < 1.0f) && rank[j] == r;
              });
          } else {
            // large: demotes at the small of rank mstar = #{small m: S[m] <= U[s]}
            const float us = ucum[s];
            const int mstar = warp_count(W, lane, [&](int j) {
              return q[j] < 1.0f && dcum[j] <= us;
            });
            prob = 1.0f;
            alias = s;
            if (mstar < ns) {
              const int p2 = warp_first(W, lane, [&](int j) {
                return q[j] < 1.0f && rank[j] == mstar;
              });
              prob = __fsub_rn(__fadd_rn(1.0f, us), dcum[p2]);
              const int nr = rank[s] + 1;
              if (nr < nl)
                alias = warp_first(W, lane, [&](int j) {
                  return !(q[j] < 1.0f) && rank[j] == nr;
                });
            }
          }
          prob = fminf(fmaxf(prob, 0.f), 1.f);
        } else {
          prob = widen(vrow[W + s]);
          alias = widen(idrow[W + s]);
        }
        k_new = widen(idrow[u3 < prob ? s : alias]);
      }
    }

    if (lane == 0) {
      m[k_new] += 1;
      z_out[row + i] = k_new;
      if (EMIT && k_new != z_old) {
        atomicAdd(dn + (int64_t)k_new * V + v, 1);
        atomicAdd(dn + (int64_t)z_old * V + v, -1);
      }
    }
    __syncwarp();
  }

  for (int k = lane; k < K; k += 32) m_out[(int64_t)doc * K + k] = m[k];
}

template <bool IN_KERNEL, bool EMIT, bool COMPACT = false>
int launch(const void* tokens, const void* mask, const void* z_in,
           const void* uni, const void* q_a, const void* apsi,
           const void* fvals, const void* ivals, void* z_out, void* m_out,
           void* dn, int D, int L, int K, int V, int W, int warps,
           cudaStream_t stream) {
  using F = typename Tab<COMPACT>::F;
  using I = typename Tab<COMPACT>::I;
  const size_t per_warp = (size_t)(K + (IN_KERNEL ? 5 : 1) * W) * 4;
  const size_t smem = per_warp * warps;
  auto fn = hdp_z_kernel<IN_KERNEL, EMIT, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (D + warps - 1) / warps;
  fn<<<grid, warps * 32, smem, stream>>>(
      static_cast<const int32_t*>(tokens), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(z_in), static_cast<const float*>(uni),
      static_cast<const float*>(q_a), static_cast<const float*>(apsi),
      static_cast<const F*>(fvals), static_cast<const I*>(ivals),
      static_cast<int32_t*>(z_out), static_cast<int32_t*>(m_out),
      static_cast<int32_t*>(dn), D, L, K, V, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt in to on `device`.
int hdp_z_smem_limit(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Launch one sweep on `stream`. Prologue mode when apsi is not null
// (q_a unused), table mode otherwise; dn null means no delta; compact
// != 0 (table mode only) takes fvals as bf16 and ivals as int16.
// Returns the cudaError_t of the launch (0 on success).
int hdp_z_launch(const void* tokens, const void* mask, const void* z_in,
                 const void* uni, const void* q_a, const void* apsi,
                 const void* fvals, const void* ivals, void* z_out,
                 void* m_out, void* dn, int D, int L, int K, int V, int W,
                 int warps, int compact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool in_kernel = apsi != nullptr;
  const bool emit = dn != nullptr;
  if (compact && (in_kernel || K > 32768)) return (int)cudaErrorInvalidValue;
  if (compact && emit)
    return launch<false, true, true>(tokens, mask, z_in, uni, q_a, apsi, fvals,
                                     ivals, z_out, m_out, dn, D, L, K, V, W, warps, s);
  if (compact)
    return launch<false, false, true>(tokens, mask, z_in, uni, q_a, apsi, fvals,
                                      ivals, z_out, m_out, dn, D, L, K, V, W, warps, s);
  if (in_kernel && emit)
    return launch<true, true>(tokens, mask, z_in, uni, q_a, apsi, fvals,
                              ivals, z_out, m_out, dn, D, L, K, V, W, warps, s);
  if (in_kernel)
    return launch<true, false>(tokens, mask, z_in, uni, q_a, apsi, fvals,
                               ivals, z_out, m_out, dn, D, L, K, V, W, warps, s);
  if (emit)
    return launch<false, true>(tokens, mask, z_in, uni, q_a, apsi, fvals,
                               ivals, z_out, m_out, dn, D, L, K, V, W, warps, s);
  return launch<false, false>(tokens, mask, z_in, uni, q_a, apsi, fvals,
                              ivals, z_out, m_out, dn, D, L, K, V, W, warps, s);
}

}  // extern "C"
