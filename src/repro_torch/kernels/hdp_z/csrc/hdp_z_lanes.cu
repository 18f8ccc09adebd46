// hdp_z_lanes: the doubly sparse HDP z-sweep on Hopper (sm_90a), one
// document per lane. The "lanes" route of kernels/hdp_z/hdp_z.py.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hdp_z/hdp_z.py:71,
// function _z_kernel (called through hdp_z_pallas), and computes what
// csrc/hdp_z.cu (the "warp" route) computes, bit for bit: per document
// the topic histogram m of the incoming z, then a sequential
// collapsed-Gibbs pass over its tokens; z_new (D, L), the final m
// (D, K) and, with emit_delta, dn (K, V). Table mode (q_a, fpack,
// ipack) and prologue mode (apsi, vals, ids; q_a and the drawn slot's
// alias entry derived per token) as in hdp_z.cu. Table mode also takes
// compact tables, as the TPU kernel does: fpack in bf16 and ipack in
// int16 (K <= 32768), each element widened as it is read (bf16 to
// float32 by a 16-bit shift, int16 to int32 by sign extension; both
// exact), so the sweep is bitwise the one on the widened tables.
//
// What bounds it on this card. Every float sum over a word's slots
// follows one canonical order, left to right (core/alias.py); the plain
// version (kernels/hdp_z/ref.py) and hdp_z.cu keep it, and the three
// agree bit for bit. A left-to-right sum is a chain of dependent adds,
// so inside one document there is no parallelism to give a warp: the
// warp route has lane 0 walk each sum while 31 lanes wait, over all W
// slots, and that issue, not memory, sets its time. The bytes the sweep
// must move take a fraction of a millisecond at 3.35 TB/s. Here, with a
// document per lane, 32 documents' m fill 64 KB of shared memory at
// K = 1000, so an SM holds three warps: one per scheduler, each a chain
// of dependent loads, gathers and adds, with no other warp to hide its
// latency. Latency, not issue or bytes, is what is left.
//
// What the design does about it.
//  1. One document per lane: a warp sweeps 32 documents, each lane its
//     own tokens and its own left-to-right sums, so every issued
//     instruction does 32 documents' work. m lives in shared memory as
//     uint16 (counts never exceed L <= 32767; count_f turns one into the
//     same float exactly), interleaved by lane (m[k * 32 + lane]) so a
//     gather costs at most a two-way bank conflict. apsi is staged once
//     per block. Documents go to lanes longest first, so a warp's 32 are
//     of about one length. The final m leaves through a 32 x 33 tile,
//     one document's row at a time, coalesced; dn by int32 atomicAdd,
//     which commutes. z_out arrives as a copy of z_in, so only live
//     positions are written.
//  2. Loads run ahead of the chain: a document's topics and mask 16
//     positions at a time for the count; positions 4 at a time, 4 to 7
//     ahead; the next position's uniforms and first 20 live slots
//     (16-byte pieces where the row allows, VEC) are in flight in
//     registers while this one is swept. The walks over those 20 slots
//     are straight-line code (every gather issues at once); slots past
//     them, rare on a sparse state, go through out-of-line functions.
//  3. Each walk stops at the word's live slots: live[v] is 1 + the
//     index of the row's last slot whose value is non-zero or not
//     finite (in prologue mode also whose apsi[id] is not finite). Every
//     later slot adds +-0.0 to each sum, so the prefix qb, q_a and the
//     alias total are unchanged, and the inverse-CDF count never takes
//     a later slot: on the doc branch t = u1 * tot <= qb = c[j] for
//     every j >= live (u1 in [0, 1]). The term-(b) line c is not
//     stored beyond 20 slots: the first walk leaves its first 20
//     prefixes in the warp's staging tile, and past them a second walk
//     repeats the same adds in the same order. The count stops at the
//     first c[j] >= t, which is exact while c is nondecreasing (no
//     negative product seen in the first walk; else it counts every
//     live slot). On the prologue's global branch the alias entry is
//     derived per lane with the same q, dcum, ucum and rank lines and
//     the same comparisons as hdp_z.cu over all W slots: live slots are
//     read from the row, and every slot past live has q = 0 (small,
//     deficit 1.0), so its part of the lines is built in registers.
//     Both lines are nondecreasing, so each count of hdp_z.cu ("larges
//     with ucum < dprev", "smalls with dcum <= us") ends at the first
//     slot that fails it, and the slot it selects is that one.
// The build uses --fmad=false and the _rn intrinsics so that no
// multiply-add is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 8;
constexpr int kStage = kLanes * (kLanes + 1);  // int32s of a staging tile

__host__ __device__ constexpr size_t apsi_bytes(int K) {
  return ((size_t)K * 4 + 15) / 16 * 16;
}

// A group of 20 consecutive slots of a row, values and ids, held in
// registers (every index below is a compile-time constant once the
// loops that read it are unrolled).
constexpr int kGroup = 20;

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

struct Group {
  float f[kGroup];
  int id[kGroup];
};
static_assert(kGroup * kLanes <= kStage, "a lane's prefixes fit the tile");

// Slots [j0, j0 + 20) of a row that lie below `end`, zero elsewhere.
// VEC: 4 slots a load, 16 bytes of float32 or int32, 8 of bf16 or int16
// (the row is 16-byte aligned and W % 4 == 0, so a piece that starts
// below end <= W lies in the row); scalars otherwise.
template <bool VEC, class F, class I>
__device__ __forceinline__ void load_group(const F* __restrict__ fp,
                                           const I* __restrict__ ip,
                                           int j0, int end, Group& g) {
#pragma unroll
  for (int c = 0; c < kGroup; c += 4) {
    if constexpr (VEC && sizeof(F) == 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      int4 b = make_int4(0, 0, 0, 0);
      if (j0 + c < end) {
        a = __ldg(reinterpret_cast<const float4*>(fp + j0 + c));
        b = __ldg(reinterpret_cast<const int4*>(ip + j0 + c));
      }
      g.f[c] = a.x; g.f[c + 1] = a.y; g.f[c + 2] = a.z; g.f[c + 3] = a.w;
      g.id[c] = b.x; g.id[c + 1] = b.y; g.id[c + 2] = b.z; g.id[c + 3] = b.w;
    } else if constexpr (VEC) {
      uint2 a = make_uint2(0u, 0u), b = make_uint2(0u, 0u);
      if (j0 + c < end) {
        a = __ldg(reinterpret_cast<const uint2*>(fp + j0 + c));
        b = __ldg(reinterpret_cast<const uint2*>(ip + j0 + c));
      }
      const uint32_t fa[2] = {a.x, a.y}, ib[2] = {b.x, b.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // slot c + e in bits 16 (e % 2)
        const uint32_t sh = 16u * (e & 1);
        g.f[c + e] = widen((uint16_t)(fa[e >> 1] >> sh));
        g.id[c + e] = widen((int16_t)(ib[e >> 1] >> sh));
      }
    } else {
#pragma unroll
      for (int e = c; e < c + 4; ++e) {
        const bool in = j0 + e < end;
        g.f[e] = in ? widen(__ldg(fp + j0 + e)) : 0.f;
        g.id[e] = in ? widen(__ldg(ip + j0 + e)) : 0;
      }
    }
  }
}

// Calls fn(j, value, id) for slots j = j0, j0 + 1, ... < n of a row in
// order until fn returns true, and returns that slot, or n. The slots
// are read a group at a time, the next group's loads in flight while
// this one's slots are walked.
template <bool VEC, class F, class I, class Fn>
__device__ __forceinline__ int walk_rows(const F* __restrict__ fp,
                                         const I* __restrict__ ip,
                                         int j0, int n, Fn fn) {
  if (j0 >= n) return n;
  Group cur;
  load_group<VEC>(fp, ip, j0, n, cur);
  for (; j0 < n; j0 += kGroup) {
    Group nxt;
    load_group<VEC>(fp, ip, j0 + kGroup, n, nxt);
#pragma unroll
    for (int e = 0; e < kGroup; ++e)
      if (j0 + e < n && fn(j0 + e, cur.f[e], cur.id[e])) return j0 + e;
    cur = nxt;
  }
  return n;
}

// A count (0 <= m < 2^16) as a float, exactly: 2^23 + m is a float whose
// low bits are m, and subtracting 2^23 is exact. Two full-rate ops in
// place of a quarter-rate conversion.
__device__ __forceinline__ float count_f(uint16_t m) {
  return __fsub_rn(__uint_as_float(0x4B000000u | m), 8388608.f);
}

// One position of a document.
struct Pos {
  int z, v;
  float u1, u2, u3;
  bool on;
};

// Four consecutive positions of a document, loaded ahead of their turn:
// tokens, topics and mask bytes (position e in byte e).
struct Batch {
  int4 tok, z;
  uint32_t msk;
};

// Positions [i, i + 4) of the document whose positions start at `row`;
// those at or past L are zero. vec: 16-byte loads (L % 4 == 0 and the
// arrays 16-byte aligned, the mask 4-byte aligned), scalars otherwise.
__device__ __forceinline__ Batch load_batch(const int32_t* __restrict__ tokens,
                                            const uint8_t* __restrict__ mask,
                                            const int32_t* __restrict__ z_in,
                                            int64_t row, int i, int L,
                                            bool vec) {
  const int64_t p = row + i;
  Batch b;
  if (vec) {
    b.tok = __ldg(reinterpret_cast<const int4*>(tokens + p));
    b.z = __ldg(reinterpret_cast<const int4*>(z_in + p));
    b.msk = __ldg(reinterpret_cast<const unsigned int*>(mask + p));
    return b;
  }
  int t[4], z[4];
  b.msk = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = i + e < L;
    t[e] = in ? __ldg(tokens + p + e) : 0;
    z[e] = in ? __ldg(z_in + p + e) : 0;
    b.msk |= (in && __ldg(mask + p + e)) ? 1u << (8 * e) : 0u;
  }
  b.tok = make_int4(t[0], t[1], t[2], t[3]);
  b.z = make_int4(z[0], z[1], z[2], z[3]);
  return b;
}

// Position e (0..3) of a batch, by selects (no indexed registers), with
// its uniforms u.
__device__ __forceinline__ Pos pos_of(const Batch& b, int e, float3 u) {
  Pos x;
  x.v = e == 0 ? b.tok.x : e == 1 ? b.tok.y : e == 2 ? b.tok.z : b.tok.w;
  x.z = e == 0 ? b.z.x : e == 1 ? b.z.y : e == 2 ? b.z.z : b.z.w;
  x.on = ((b.msk >> (8 * e)) & 0xffu) != 0;
  x.u1 = u.x;
  x.u2 = u.y;
  x.u3 = u.z;
  return x;
}

__device__ __forceinline__ float3 load_uni(const float* __restrict__ uni,
                                           int64_t p) {
  return make_float3(__ldg(uni + p * 3), __ldg(uni + p * 3 + 1),
                     __ldg(uni + p * 3 + 2));
}

// q of a slot as core/alias.py::_normalized gives it, for total > 0.
__device__ __forceinline__ float norm_q(float val, float ap, float total,
                                        float wf) {
  const float wa = __fmul_rn(val, ap);
  const float p = (isfinite(wa) && wa > 0.f) ? wa : 0.f;
  return __fmul_rn(__fdiv_rn(p, fmaxf(total, 1e-30f)), wf);
}

// Prologue mode, the global branch: the alias entry (prob, alias) of
// slot s of the word's row, as hdp_z.cu derives it over all W slots,
// from the n live slots. Out of line: it is the cold path, and the hot
// loop's code stays small.
struct Entry {
  float prob;
  int alias;
};

template <bool VEC>
__device__ __noinline__ Entry alias_entry(const float* __restrict__ vrow,
                                          const int32_t* __restrict__ idrow,
                                          const float* __restrict__ apsi_s,
                                          int n, int W, int s, float total) {
  Entry r{1.f, s};
  // total 0: every q = 1.0, every slot large, and each keeps itself
  if (!(total > 0.f)) return r;
  const float wf = (float)W;
  // The lines up to s; for a large s, on to the next large.
  float dcum = 0.f, ucum = 0.f, qs = 0.f, ds = 0.f, us = 0.f;
  int next_large = -1;
  walk_rows<VEC>(vrow, idrow, 0, n, [&](int j, float val, int id) {
    const float qj = norm_q(val, apsi_s[id], total, wf);
    const bool sm = qj < 1.f;
    const float dj = sm ? __fsub_rn(1.f, qj) : 0.f;
    const float uj = sm ? 0.f : __fsub_rn(qj, 1.f);
    dcum = j == 0 ? dj : __fadd_rn(dcum, dj);
    ucum = j == 0 ? uj : __fadd_rn(ucum, uj);
    if (j == s) {
      qs = qj;
      ds = dcum;
      us = ucum;
      return sm;
    }
    if (j > s && !sm) {
      next_large = j;
      return true;
    }
    return false;
  });
  if (s >= n) {  // slots n..s past live: q = 0, deficit 1.0
    ds = dcum;
    for (int j = n; j <= s; ++j) ds = j == 0 ? 1.f : __fadd_rn(ds, 1.f);
    qs = 0.f;
  }
  if (qs < 1.f) {
    // small: the donor is the first large whose running surplus reaches
    // the deficit before s (hdp_z.cu: the large of rank r); none: itself
    r.prob = qs;
    const float dprev = __fsub_rn(ds, __fsub_rn(1.f, qs));
    float uc = 0.f;
    const int donor = walk_rows<VEC>(vrow, idrow, 0, n,
                                     [&](int j, float val, int id) {
      const float qj = norm_q(val, apsi_s[id], total, wf);
      const bool sm = qj < 1.f;
      const float uj = sm ? 0.f : __fsub_rn(qj, 1.f);
      uc = j == 0 ? uj : __fadd_rn(uc, uj);
      return !sm && !(uc < dprev);
    });
    if (donor < n) r.alias = donor;  // every large lies below live
  } else {
    // large: demotes at the first small whose running deficit passes its
    // surplus us (hdp_z.cu: the small of rank mstar); then its alias is
    // the next large
    float dc = 0.f;
    int p2 = walk_rows<VEC>(vrow, idrow, 0, n, [&](int j, float val, int id) {
      const float qj = norm_q(val, apsi_s[id], total, wf);
      const bool sm = qj < 1.f;
      const float dj = sm ? __fsub_rn(1.f, qj) : 0.f;
      dc = j == 0 ? dj : __fadd_rn(dc, dj);
      return sm && !(dc <= us);
    });
    if (p2 == n) {  // on through the slots past live, all small
      for (; p2 < W; ++p2) {
        dc = p2 == 0 ? 1.f : __fadd_rn(dc, 1.f);
        if (!(dc <= us)) break;
      }
    }
    if (p2 < W) {
      r.prob = __fsub_rn(__fadd_rn(1.f, us), dc);
      if (next_large >= 0) r.alias = next_large;
    }
  }
  r.prob = fminf(fmaxf(r.prob, 0.f), 1.f);
  return r;
}

// The first walk's running sums: qb and, in prologue mode, q_a and the
// alias total; mono while no product was negative.
struct Sums {
  float qb, qa, total;
  bool mono;
};

template <bool IN_KERNEL>
__device__ __forceinline__ void add_slot(Sums& a, int j, float val, int id,
                                         float wb,
                                         const float* __restrict__ apsi_s) {
  a.mono = a.mono && !(wb < 0.f);
  a.qb = j == 0 ? wb : __fadd_rn(a.qb, wb);
  if (IN_KERNEL) {
    const float wa = __fmul_rn(val, apsi_s[id]);
    const float pj = (isfinite(wa) && wa > 0.f) ? wa : 0.f;
    a.qa = j == 0 ? wa : __fadd_rn(a.qa, wa);
    a.total = j == 0 ? pj : __fadd_rn(a.total, pj);
  }
}

// The first walk past slot 20 (out of line, as it is rare).
template <bool IN_KERNEL, bool VEC, class F, class I>
__device__ __noinline__ Sums first_walk_rest(const F* __restrict__ vrow,
                                             const I* __restrict__ idrow,
                                             const uint16_t* mcol,
                                             const float* apsi_s, int n,
                                             Sums a) {
  walk_rows<VEC>(vrow, idrow, kGroup, n, [&](int j, float val, int id) {
    add_slot<IN_KERNEL>(a, j, val, id,
                        __fmul_rn(val, count_f(mcol[id * kLanes])), apsi_s);
    return false;
  });
  return a;
}

// The second walk's state: the prefix c, the count of c < t, and the
// topic of the slot where it stopped (hit).
struct Count {
  float c;
  int cnt, k;
  bool hit;
};

// The second walk past slot 20 (out of line, as it is rare).
template <bool VEC, class F, class I>
__device__ __noinline__ Count second_walk_rest(
    const F* __restrict__ vrow, const I* __restrict__ idrow,
    const uint16_t* mcol, int n, float t, bool mono, Count r) {
  walk_rows<VEC>(vrow, idrow, kGroup, n, [&](int j, float val, int id) {
    r.c = __fadd_rn(r.c, __fmul_rn(val, count_f(mcol[id * kLanes])));
    if (r.c < t) {
      ++r.cnt;
      return false;
    }
    if (mono) {
      r.hit = true;
      r.k = id;
    }
    return mono;
  });
  return r;
}

template <bool IN_KERNEL, bool EMIT, bool VEC, bool COMPACT>
__global__ void __launch_bounds__(kMaxWarps * kLanes) hdp_z_lanes_kernel(
    const int32_t* __restrict__ tokens,  // (D, L)
    const uint8_t* __restrict__ mask,    // (D, L) bool
    const int32_t* __restrict__ z_in,    // (D, L)
    const float* __restrict__ uni,       // (D, L, 3)
    const float* __restrict__ q_a,       // table mode: (V,)
    const float* __restrict__ apsi,      // prologue mode: (K,)
    const typename Tab<COMPACT>::F* __restrict__ fvals,  // (V, 2, W) or (V, W)
    const typename Tab<COMPACT>::I* __restrict__ ivals,  // (V, 2, W) or (V, W)
    const int32_t* __restrict__ live,    // (V,)
    const int32_t* __restrict__ order,   // (D,) documents, longest first
    int32_t* __restrict__ z_out,         // (D, L), a copy of z_in
    int32_t* __restrict__ m_out,         // (D, K)
    int32_t* __restrict__ dn,            // (K, V), zeroed by the caller
    int D, int L, int K, int V, int W, bool vec_pos) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // block: apsi (K f32, prologue mode) | per warp: m[K][32] uint16 |
  // per warp: a 32 x 33 int32 staging tile for m out
  const float* apsi_s = reinterpret_cast<const float*>(smem);
  uint16_t* mw =
      reinterpret_cast<uint16_t*>(smem + (IN_KERNEL ? apsi_bytes(K) : 0)) +
      (size_t)warp * K * kLanes;
  uint16_t* mcol = mw + lane;  // this lane's document: m[k] at mcol[k * 32]
  int32_t* stage =
      reinterpret_cast<int32_t*>(smem + (IN_KERNEL ? apsi_bytes(K) : 0) +
                                 (size_t)(blockDim.x >> 5) * K * kLanes * 2) +
      warp * kStage;
  if (IN_KERNEL) {
    float* dst = reinterpret_cast<float*>(smem);
    for (int k = threadIdx.x; k < K; k += blockDim.x) dst[k] = apsi[k];
    __syncthreads();
  }
  const int doc0 = (blockIdx.x * (blockDim.x >> 5) + warp) * kLanes;
  if (doc0 >= D) return;  // whole warp; no block-wide barrier follows
  // longest documents first: a warp's lanes sweep documents of about one
  // length, and no lane waits long for the warp's longest
  const int doc = doc0 + lane < D ? __ldg(order + doc0 + lane) : D;
  const int fstride = IN_KERNEL ? W : 2 * W;
  const float wf = (float)W;

  // zero the warp's m (K * 32 uint16, a multiple of 16 bytes), together
  for (int q = lane; q < K * kLanes * 2 / 16; q += kLanes)
    reinterpret_cast<int4*>(mw)[q] = make_int4(0, 0, 0, 0);
  __syncwarp();
  if (doc < D) {
    const int64_t row = (int64_t)doc * L;
    int end = 0;  // 1 + the document's last live position
    for (int i0 = 0; i0 < L; i0 += 16) {  // 16 positions' loads at once
      bool on[16];
      bool any = false;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        on[e] = i0 + e < L && mask[row + i0 + e];
        any = any || on[e];
      }
      if (!any) continue;  // padding: no topic to read
      int zz[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) zz[e] = on[e] ? z_in[row + i0 + e] : 0;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (on[e]) {
          mcol[zz[e] * kLanes] += 1;
          end = i0 + e + 1;
        }
    }

    // Loads run ahead of the chain of dependent tokens: the positions a
    // batch of 4 at a time, 4 to 7 positions ahead; the live count of the
    // position two ahead; the next position's uniforms and live slots
    // among its first 20 (a 16-byte piece past them is not read) while
    // this one is swept.
    Batch cb = load_batch(tokens, mask, z_in, row, 0, L, vec_pos);
    Batch nb = cb;
    if (L > 4) nb = load_batch(tokens, mask, z_in, row, 4, L, vec_pos);
    const float3 u0 = make_float3(0.f, 0.f, 0.f);
    Pos nx = pos_of(cb, 0, load_uni(uni, row));
    const Pos nx2 = pos_of(cb, 1, u0);
    Group rn;
    int n_nx = nx.on ? __ldg(live + nx.v) : 0;
    int n_nx2 = end > 1 && nx2.on ? __ldg(live + nx2.v) : 0;
    load_group<VEC>(fvals + (int64_t)nx.v * fstride,
                    ivals + (int64_t)nx.v * fstride, 0, n_nx, rn);
    for (int i0 = 0; i0 < end; i0 += 4) {
#pragma unroll 1
      for (int e = 0; e < 4 && i0 + e < end; ++e) {
        const int i = i0 + e;
        const int64_t p = row + i;
        const Pos cur = nx;
        const Group first = rn;
        const int n = n_nx;
        if (i + 1 < end) {
          const float3 u = load_uni(uni, p + 1);
          nx = e < 3 ? pos_of(cb, e + 1, u) : pos_of(nb, 0, u);
          n_nx = n_nx2;
          load_group<VEC>(fvals + (int64_t)nx.v * fstride,
                          ivals + (int64_t)nx.v * fstride, 0, n_nx, rn);
        }
        if (i + 2 < end) {
          const Pos x = e < 2 ? pos_of(cb, e + 2, u0) : pos_of(nb, e - 2, u0);
          n_nx2 = x.on ? __ldg(live + x.v) : 0;
        }

        const int z_old = cur.z;
        if (!cur.on) continue;  // padding: z_out holds z already
        const int v = cur.v;
        const auto* vrow = fvals + (int64_t)v * fstride;
        const auto* idrow = ivals + (int64_t)v * fstride;
        mcol[z_old * kLanes] -= 1;  // m^{-i}, before the gather

        // First walk: qb (and in prologue mode q_a and the alias total),
        // left to right over the live slots; the first 20 prefixes wait
        // in the warp's staging tile (free during the sweep) for the
        // second walk.
        // Straight-line code: all 20 gathers issue at once, and a slot
        // past n leaves every sum as it was (its gather reads topic 0).
        Sums a{0.f, IN_KERNEL ? 0.f : __ldg(q_a + v), 0.f, true};
        float* c0 = reinterpret_cast<float*>(stage) + lane;  // c0[j * 32]
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const bool in = j < n;
          const int id = in ? first.id[j] : 0;
          const float wb = __fmul_rn(first.f[j], count_f(mcol[id * kLanes]));
          Sums b = a;
          add_slot<IN_KERNEL>(b, j, first.f[j], id, wb, apsi_s);
          c0[j * kLanes] = b.qb;
          a.qb = in ? b.qb : a.qb;
          a.qa = in ? b.qa : a.qa;
          a.total = in ? b.total : a.total;
          a.mono = in ? b.mono : a.mono;
        }
        if (n > kGroup)
          a = first_walk_rest<IN_KERNEL, VEC>(vrow, idrow, mcol, apsi_s, n, a);
        const float tot = __fadd_rn(a.qa, a.qb);
        const float t = __fmul_rn(cur.u1, tot);
        const bool doc_branch = (t < a.qb) || (a.qa <= 0.f);

        int k_new = z_old;
        if (tot > 0.f) {
          if (doc_branch) {
            // Second walk: the slot is the count of c < t, which ends at
            // the first c >= t while c is nondecreasing; the first 20
            // prefixes are the first walk's, past them the same adds again.
            Count r{c0[(kGroup - 1) * kLanes], 0, z_old, false};
#pragma unroll
            for (int j = 0; j < kGroup; ++j) {  // straight-line, as above
              const bool on = !r.hit && j < n;
              const bool below = c0[j * kLanes] < t;
              const bool stop = on && !below && a.mono;
              r.cnt += on && below;
              r.k = stop ? first.id[j] : r.k;
              r.hit = r.hit || stop;
            }
            if (!r.hit && n > kGroup)
              r = second_walk_rest<VEC>(vrow, idrow, mcol, n, t, a.mono, r);
            k_new = r.hit ? r.k : widen(__ldg(idrow + min(r.cnt, W - 1)));
          } else {
            const int s = min((int)__fmul_rn(cur.u2, wf), W - 1);
            Entry e;
            if constexpr (IN_KERNEL) {
              e = alias_entry<VEC>(vrow, idrow, apsi_s, n, W, s, a.total);
            } else {
              e.prob = widen(__ldg(vrow + W + s));
              e.alias = widen(__ldg(idrow + W + s));
            }
            k_new = widen(__ldg(idrow + (cur.u3 < e.prob ? s : e.alias)));
          }
        }

        mcol[k_new * kLanes] += 1;
        z_out[p] = k_new;
        if (EMIT && k_new != z_old) {
          atomicAdd(dn + (int64_t)k_new * V + v, 1);
          atomicAdd(dn + (int64_t)z_old * V + v, -1);
        }
      }
      cb = nb;
      if (i0 + 8 < end)
        nb = load_batch(tokens, mask, z_in, row, i0 + 8, L, vec_pos);
    }
  }
  __syncwarp();

  // m out, 32 topics at a time (the staging tile's prefixes are spent):
  // each lane moves its document's counts
  // into the warp's staging tile, then the warp writes the tile's rows,
  // one document each, coalesced (row stride 33: no bank conflicts)
  // (straight-line: each lane's 32 loads issue at once)
  const int docs = min(kLanes, D - doc0);
  int64_t out_row[kLanes];  // each lane's document's row of m_out
#pragma unroll
  for (int d = 0; d < kLanes; ++d)
    out_row[d] = (int64_t)__shfl_sync(0xffffffffu, doc, d) * K;
  for (int k0 = 0; k0 < K; k0 += kLanes) {
    int x[kLanes];
#pragma unroll
    for (int c = 0; c < kLanes; ++c)
      x[c] = mw[min(k0 + c, K - 1) * kLanes + lane];
#pragma unroll
    for (int c = 0; c < kLanes; ++c) stage[lane * (kLanes + 1) + c] = x[c];
    __syncwarp();
#pragma unroll
    for (int d = 0; d < kLanes; ++d) x[d] = stage[d * (kLanes + 1) + lane];
    if (k0 + lane < K) {
#pragma unroll
      for (int d = 0; d < kLanes; ++d)
        if (d < docs) m_out[out_row[d] + k0 + lane] = x[d];
    }
    __syncwarp();
  }
}

// A launch's arguments, as the C entry point receives them.
struct Args {
  const void *tokens, *mask, *z_in, *uni, *q_a, *apsi, *fvals, *ivals,
      *live, *order;
  void *z_out, *m_out, *dn;
  int D, L, K, V, W, warps;
  bool vec_pos;
};

template <bool IN_KERNEL, bool EMIT, bool VEC, bool COMPACT = false>
int launch(const Args& a, cudaStream_t stream) {
  using F = typename Tab<COMPACT>::F;
  using I = typename Tab<COMPACT>::I;
  const size_t smem = (IN_KERNEL ? apsi_bytes(a.K) : 0) +
                      (size_t)a.warps * (a.K * kLanes * sizeof(uint16_t) +
                                         kStage * sizeof(int32_t));
  auto fn = hdp_z_lanes_kernel<IN_KERNEL, EMIT, VEC, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int docs_per_block = a.warps * kLanes;
  const int grid = (a.D + docs_per_block - 1) / docs_per_block;
  fn<<<grid, a.warps * kLanes, smem, stream>>>(
      static_cast<const int32_t*>(a.tokens),
      static_cast<const uint8_t*>(a.mask),
      static_cast<const int32_t*>(a.z_in), static_cast<const float*>(a.uni),
      static_cast<const float*>(a.q_a), static_cast<const float*>(a.apsi),
      static_cast<const F*>(a.fvals), static_cast<const I*>(a.ivals),
      static_cast<const int32_t*>(a.live),
      static_cast<const int32_t*>(a.order), static_cast<int32_t*>(a.z_out),
      static_cast<int32_t*>(a.m_out), static_cast<int32_t*>(a.dn), a.D, a.L,
      a.K, a.V, a.W, a.vec_pos);
  return (int)cudaGetLastError();
}

template <bool IN_KERNEL, bool EMIT, bool COMPACT = false>
int launch_vec(bool vec_rows, const Args& a, cudaStream_t s) {
  return vec_rows ? launch<IN_KERNEL, EMIT, true, COMPACT>(a, s)
                  : launch<IN_KERNEL, EMIT, false, COMPACT>(a, s);
}

}  // namespace

extern "C" {

// Largest dynamic shared memory one block may opt in to on `device`.
int hdp_z_lanes_smem_limit(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Launch one sweep on `stream`: prologue mode when apsi is not null
// (q_a unused), table mode otherwise; dn null means no delta. compact
// != 0 (table mode only) takes fvals as bf16 and ivals as int16.
// vec_rows != 0 reads the rows 4 slots at a time (W % 4 == 0, rows
// 16-byte aligned); vec_pos != 0 reads tokens, z, mask and uniforms 4
// positions at a time (L % 4 == 0, the arrays 16-byte and the mask
// 4-byte aligned). Returns the cudaError_t of the launch (0 on success).
int hdp_z_lanes_launch(const void* tokens, const void* mask,
                       const void* z_in, const void* uni, const void* q_a,
                       const void* apsi, const void* fvals,
                       const void* ivals, const void* live,
                       const void* order, void* z_out, void* m_out, void* dn,
                       int D, int L, int K, int V, int W, int warps,
                       int vec_rows, int vec_pos, int compact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  if (compact && (apsi != nullptr || K > 32768)) return (int)cudaErrorInvalidValue;
  const Args a{tokens, mask, z_in, uni, q_a, apsi, fvals, ivals, live,
               order, z_out, m_out, dn, D, L, K, V, W, warps,
               vec_pos != 0};
  const bool vr = vec_rows != 0;
  if (compact)
    return dn != nullptr ? launch_vec<false, true, true>(vr, a, s)
                         : launch_vec<false, false, true>(vr, a, s);
  if (apsi != nullptr)
    return dn != nullptr ? launch_vec<true, true>(vr, a, s)
                         : launch_vec<true, false>(vr, a, s);
  return dn != nullptr ? launch_vec<false, true>(vr, a, s)
                       : launch_vec<false, false>(vr, a, s);
}

}  // extern "C"
