// ssd_chunk_sm90_wide: the Mamba-2 SSD intra-chunk pass written for Hopper
// (sm_90a) at a wide state (mamba2-780m's N = 128), its three products on
// the tensor cores at float32 accuracy (3xTF32), B and C streamed in
// slices of the state, and C B^T computed once for the heads that share it.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py:31,
// function _ssd_chunk_kernel (called through ssd_intra_chunk), for chunk
// CL <= 128, head dim P <= 64 and 32 < N <= 128 with P and N multiples
// of 4 (ssd.route); ssd_chunk_sm90.cu keeps N <= 32 and ssd_chunk.cu
// every other shape. It computes what the TPU kernel computes, float32 in
// and out, for each (batch b, chunk c, head h):
//   a    = dt * A[h],  cum = inclusive cumsum(a)           (CL,)
//   seg  = sum of a_k over k = j+1..i, for i >= j           (CL, CL)
//   L    = exp(seg) for i >= j, else 0                      (CL, CL)
//   y    = ((C B^T) o L) (x * dt)                           (CL, P)
//   st   = (B * exp(sum of a_k over k = j+1..CL-1))^T (x * dt)  (N, P)
//   dec  = exp(cum)                                         (CL,)
// L and the decays are taken from sums of same-sign steps, never as
// exp(cum_i - cum_j) (kernels/ssd/ref.py::segsum).
//
// What bounds it on this card. At mamba2-780m's serving shape (B=4,
// S=512, H=48, P=64, N=128, CL=128) the function moves 78.4 MB (x in, y
// and the states out, 25 MB each): 23.4 us at 3.35 TB/s. Its products,
// the lower triangle of C B^T (k = N) once a (b, c), since B and C are
// the same for every head, and per head that of (G o L)(x dt) and the
// states (M = N), are 2.46 GFLOP; three TF32 passes at the tensor-core
// peak (495 TFLOP/s) and the elementwise work take 15.5 us, so the bytes
// bound it.
//
// What the design does.
//  - The products are those of ssd_chunk_sm90.cu (mma.sync.m16n8k8 .tf32,
//    float32 accumulators, each operand split into hi and lo, three
//    passes lo.hi + hi.lo + hi.hi, each k-step's passes summed into a
//    zeroed accumulator and then added to the running float32 sum), with
//    its permuted k index and its in-register scaling of the scores (lo
//    is left for the tensor core to truncate there as here: rounding it
//    to tf32 too bought no accuracy against a float64 oracle and cost
//    3.8%, launch/ablate_ssd.py's rounded_lo).
//  - A CTA takes a unit: one (b, c) and a group of its heads. Where B and
//    C are shared by the heads (head stride 0, as the model passes them)
//    G = C B^T is the same for all of them and is computed once a unit;
//    then only L (from dt A[h]) and x differ by head. The host picks the
//    group size so that the units fill the card's SMs in as few waves as
//    its cost model finds (mamba2's shape: 8 groups of 6 heads, 128 units
//    on 132 SMs, one wave). Where B or C differ by head a unit is one head.
//  - Staging that fits one SM (218,176 B at N=128, P=64, CL=128): B is
//    held whole for the unit (the state product reads it for every head);
//    B and C arrive in slices of 32 state columns, a ring of two C slices,
//    so G's k-steps over one slice run while the next slice's copies are
//    in flight; x and dt of the next head are copied while this head
//    computes (a ring of two). G's lower triangle, 36 16 x 16 blocks,
//    waits in shared memory in the accumulators' own layout between the
//    heads, a float4 a lane, so each warp reads it back free of bank
//    conflicts.
//  - 8 warps, one CTA an SM. Warp w = 4 ph + r takes the row tiles 7 - r
//    and r (9 16-row blocks of the triangle, the same for every warp): in
//    G it computes half ph (8 columns) of each of their blocks over all N;
//    in y it computes P columns 32 ph .. 32 ph + 31 of those rows (the
//    scores of a block are made by both warps of a pair, from the two
//    halves of G). In the state product it takes state rows 32 r ..
//    32 r + 31 and P columns 32 ph .. 32 ph + 31.
//  - The segment-sum lines come from 16-row blocks: one lane a block sums
//    its pre and sfx lines and its total, then the mid sums between
//    blocks, the sums of the blocks before it and after it; dec and the
//    decay to the chunk's end are exp(before + pre) and exp(sfx + after).
//    All are sums of same-sign steps in a fixed order.
//  - N is zero-padded to a multiple of 32, P to 8, CL to 16 in shared
//    memory; padding is exact. Row strides N + 4, P + 4 and 36 keep every
//    fragment load free of bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCL = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kSlice = 32;           // state columns a slice of B and C
constexpr int kCs = kSlice + 4;      // row stride of a C slice
constexpr int kMaxBlocks = kMaxCL / 16;
constexpr int kSlots = kMaxBlocks + 1;  // G's blocks a warp: tiles 7 - r and r
constexpr int kDiag = 16 * 17 / 2;   // a lower-triangular 16 x 16 table
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// Flag, Strides, the cp.async helpers, split, exp2_approx, mma, mma3_add
// and load_x are copies of those in ssd_chunk_sm90.cu: a fix to one
// belongs in the other. Each source builds alone, with its own flags, and
// launch/ablate_ssd.py patches these functions' text in each file.

// A compile-time flag passed to a generic lambda.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

struct Strides {  // in elements: batch, sequence, head (last dim is 1)
  long long x[3], dt[3], b[3], c[3];
};

// Shared memory in floats: B whole (CLp rows of bs), two C slices (CLp
// rows of kCs), two x (CLp rows of xs) and two dt (CLp); G's lower
// triangle (a 16 x 16 block is 2 halves x 32 lanes x 4); pre, sfx and
// w*dt (CLp each); the mid sums between sub-blocks (kMaxBlocks^2); the
// sums before and after each sub-block (2 kMaxBlocks); one diagonal-block
// seg table a warp.
struct Layout {
  int CLp, Pp, Np, NS, xs, bs;
  int b, c, cslot, x, xslot, dt, g;
  int pre, sfx, wdt, blk, ends, diag, total;
};

__host__ __device__ inline Layout make_layout(int CL, int N, int P) {
  Layout L;
  L.CLp = (CL + 15) / 16 * 16;
  L.Pp = (P + 7) / 8 * 8;
  L.Np = (N + kSlice - 1) / kSlice * kSlice;
  L.NS = L.Np / kSlice;
  L.xs = L.Pp + 4;
  L.bs = L.Np + 4;
  const int rt = L.CLp / 16;
  L.b = 0;
  L.c = L.b + L.CLp * L.bs;
  L.cslot = L.CLp * kCs;
  L.x = L.c + 2 * L.cslot;
  L.xslot = L.CLp * L.xs;
  L.dt = L.x + 2 * L.xslot;
  L.g = L.dt + 2 * L.CLp;
  L.pre = L.g + rt * (rt + 1) / 2 * 256;
  L.sfx = L.pre + L.CLp;
  L.wdt = L.sfx + L.CLp;
  L.blk = L.wdt + L.CLp;
  L.ends = L.blk + kMaxBlocks * kMaxBlocks;
  L.diag = L.ends + 2 * kMaxBlocks;
  L.total = L.diag + kWarps * kDiag;
  return L;
}

struct Params {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  float* st;
  float* dec;
  Strides sd;
  int S, H, P, N, CL, NC;
  int groups;  // head groups a (b, c); H where B or C differ by head
  int units;   // B * NC * groups
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v = hi + lo up to what TF32 drops. hi is v rounded to tf32 as
// cvt.rna.tf32.f32 rounds it (to nearest, ties away from zero), in two
// integer operations: the cvt issues at a fraction of their rate. lo =
// v - hi is exact in float32; the tensor core ignores its low 13 bits.
// A NaN v leaves a NaN lo.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += A (16 x 8, row) * B (8 x 8, col), tf32 operands, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += one k-step's three passes lo.hi + hi.lo + hi.hi, summed apart
// from acc first.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// x at rows j0 + 2q, j0 + 2q + 1 and column p as the B operand of a
// k-step whose physical k = q, q + 4 stands for j = j0 + 2q, j0 + 2q + 1.
__device__ __forceinline__ void load_x(const float* xst, int xs, int j0, int q, int p,
                                       uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  split(xst[(j0 + 2 * q) * xs + p], bh[0], bl[0]);
  split(xst[(j0 + 2 * q + 1) * xs + p], bh[1], bl[1]);
}

// (b, c) and the heads h0 .. h1 - 1 of a unit.
struct Unit {
  int b, c, h0, h1;
  long long t0;
  __device__ Unit(int u, const Params& pr) {
    const int grp = u % pr.groups;
    const int bc = u / pr.groups;
    c = bc % pr.NC;
    b = bc / pr.NC;
    h0 = grp * pr.H / pr.groups;
    h1 = (grp + 1) * pr.H / pr.groups;
    t0 = (long long)c * pr.CL;
  }
};

// Slice s of the unit's B (into the whole B) and C (into ring slot s & 1),
// read at head h0 (a head stride of 0 shares them). The columns of a
// partial last slice past N are written as zeros into the C slot, whose
// other slices fill them.
__device__ void load_slice(const Params& pr, const Layout& L, const Unit& un, int s,
                           float* smem) {
  const Strides& sd = pr.sd;
  const int n0 = kSlice * s;
  const int w4 = min(kSlice, pr.N - n0) / 4;
  const float* bsrc = pr.bm + un.b * sd.b[0] + un.t0 * sd.b[1] + un.h0 * sd.b[2] + n0;
  const float* csrc = pr.cm + un.b * sd.c[0] + un.t0 * sd.c[1] + un.h0 * sd.c[2] + n0;
  float* bdst = smem + L.b + n0;
  float* cdst = smem + L.c + (s & 1) * L.cslot;
  for (int e = threadIdx.x; e < pr.CL * (kSlice / 4); e += kThreads) {
    const int i = e / (kSlice / 4), k = e % (kSlice / 4);
    if (k < w4) {
      cp_async16(bdst + i * L.bs + 4 * k, bsrc + i * sd.b[1] + 4 * k);
      cp_async16(cdst + i * kCs + 4 * k, csrc + i * sd.c[1] + 4 * k);
    } else {
      *reinterpret_cast<float4*>(cdst + i * kCs + 4 * k) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// x and dt of head h of the unit into ring slot `slot`.
__device__ void load_head(const Params& pr, const Layout& L, const Unit& un, int h, int slot,
                          float* smem) {
  const Strides& sd = pr.sd;
  const float* xsrc = pr.x + un.b * sd.x[0] + un.t0 * sd.x[1] + h * sd.x[2];
  const float* dsrc = pr.dt + un.b * sd.dt[0] + un.t0 * sd.dt[1] + h * sd.dt[2];
  float* xdst = smem + L.x + slot * L.xslot;
  float* ddst = smem + L.dt + slot * L.CLp;
  const int p4 = pr.P / 4;
  for (int e = threadIdx.x; e < pr.CL * p4; e += kThreads) {
    const int i = e / p4, k = e - i * p4;
    cp_async16(xdst + i * L.xs + 4 * k, xsrc + i * sd.x[1] + 4 * k);
  }
  for (int i = threadIdx.x; i < pr.CL; i += kThreads)
    cp_async4(ddst + i, dsrc + i * sd.dt[1]);
}

__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_sm90_wide(Params pr) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(pr.CL, pr.N, pr.P);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int CL = pr.CL, P = pr.P, N = pr.N;
  const int RT = L.CLp / 16, NTt = L.Pp / 8;
  float* pre = smem + L.pre;
  float* sfx = smem + L.sfx;
  float* wdt = smem + L.wdt;
  float* blk = smem + L.blk;
  float* ends = smem + L.ends;  // [0, 8): sums before a sub-block; [8, 16): after
  float* diag = smem + L.diag + warp * kDiag;
  float* gsm = smem + L.g;

  // Padding (rows past CL, columns past P and N) stays zero: the copies
  // write only real positions.
  for (int e = tid; e < L.total; e += kThreads) smem[e] = 0.f;
  __syncthreads();

  // This warp's share: row tiles t_hi and t_lo (those below RT) and half
  // (8-column tile) ph of each of their blocks of G, y's column tiles
  // 4 ph .. 4 ph + 3, and the state's rows 32 r .. 32 r + 31 at the same
  // column tiles.
  const int r = warp & 3, ph = warp >> 2;
  const int t_hi = kMaxBlocks - 1 - r, t_lo = r;
  // G's 9 blocks of this warp: slot k < nhi is block (t_hi, k), the
  // others (t_lo, k - nhi); at CL < 128 the slots of a tile past the
  // chunk compute what is not stored
  const int nhi = t_hi + 1;
  const bool y_on = 4 * ph < NTt;
  const bool st_on = 32 * r < L.Np && 4 * ph < NTt;
  int pcol[4];  // the x column this thread reads in each of its column tiles
#pragma unroll
  for (int u = 0; u < 4; ++u) pcol[u] = 8 * min(4 * ph + u, NTt - 1) + g;

  int u = blockIdx.x;
  int xi = 0;  // heads this CTA has taken: x and dt in ring slot xi & 1
  if (u < pr.units) load_head(pr, L, Unit(u, pr), Unit(u, pr).h0, 0, smem);
  cp_async_commit();
  for (; u < pr.units; u += gridDim.x) {
    const Unit un(u, pr);

    // ---- G = C B^T over the state, slice by slice ----
    __syncthreads();  // the last unit's reads of B, C and G are done
    load_slice(pr, L, un, 0, smem);
    cp_async_commit();
    float gacc[kSlots][4];
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[k][e] = 0.f;
#pragma unroll 1
    for (int s = 0; s < L.NS; ++s) {
      cp_async_wait_all();
      __syncthreads();  // slice s has landed; the other C slot is free
      if (s + 1 < L.NS) load_slice(pr, L, un, s + 1, smem);
      cp_async_commit();
      const float* cst = smem + L.c + (s & 1) * L.cslot;
      const float* bst = smem + L.b + kSlice * s;
#pragma unroll 1
      for (int ks = 0; ks < kSlice / 8; ++ks) {
        // C's rows of the two row tiles as A operands
        uint32_t ch[2][4], cl[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* c0 = cst + (16 * min(u ? t_lo : t_hi, RT - 1) + g) * kCs + 8 * ks + q;
          split(c0[0], ch[u][0], cl[u][0]);
          split(c0[8 * kCs], ch[u][1], cl[u][1]);
          split(c0[4], ch[u][2], cl[u][2]);
          split(c0[8 * kCs + 4], ch[u][3], cl[u][3]);
        }
        // every slot in one branch-free run, so the passes of different
        // slots overlap
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const bool hi = k < nhi;
          const int m = min(hi ? k : k - nhi, RT - 1);
          // B's rows of this block's half ph as the B operand
          const float* b0 = bst + (16 * m + 8 * ph + g) * L.bs + 8 * ks + q;
          uint32_t bh[2], bl[2], ah[4], al[4];
          split(b0[0], bh[0], bl[0]);
          split(b0[4], bh[1], bl[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = hi ? ch[0][e] : ch[1][e];
            al[e] = hi ? cl[0][e] : cl[1][e];
          }
          mma3_add(gacc[k], ah, al, bh, bl);
        }
      }
    }
    // G's blocks wait in shared memory: block (t, m) at t (t + 1) / 2 + m,
    // half ph, a float4 a lane
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const bool hi = k < nhi;
      const int t = hi ? t_hi : t_lo, m = hi ? k : k - nhi;
      if (t < RT) {
        const int bi = t * (t + 1) / 2 + m;
        *reinterpret_cast<float4*>(gsm + ((bi * 2 + ph) * 32 + lane) * 4) =
            make_float4(gacc[k][0], gacc[k][1], gacc[k][2], gacc[k][3]);
      }
    }

    // ---- the unit's heads ----
#pragma unroll 1
    for (int h = un.h0; h < un.h1; ++h, ++xi) {
      cp_async_wait_all();
      __syncthreads();  // x and dt of h have landed, G is in place, the
                        // last head is done with the other slot
      if (h + 1 < un.h1) {
        load_head(pr, L, un, h + 1, (xi + 1) & 1, smem);
      } else if (u + (int)gridDim.x < pr.units) {
        const Unit next(u + gridDim.x, pr);
        load_head(pr, L, next, next.h0, (xi + 1) & 1, smem);
      }
      cp_async_commit();
      const float* xst = smem + L.x + (xi & 1) * L.xslot;
      const float* dts = smem + L.dt + (xi & 1) * L.CLp;
      const float ah = pr.a[h];

      // dec, w * dt and the segment-sum lines, by warp 0: lane J sums
      // 16-row block J's pre and sfx lines and its total, then its mid
      // sums and the sums before and after it; then every lane takes
      // rows lane, lane + 32, ...
      if (warp == 0) {
        if (lane < RT) {
          const int o = 16 * lane;
          float a16[16];
#pragma unroll
          for (int k = 0; k < 16; k += 4) {
            const float4 d4 = *reinterpret_cast<const float4*>(dts + o + k);
            a16[k] = __fmul_rn(d4.x, ah);
            a16[k + 1] = __fmul_rn(d4.y, ah);
            a16[k + 2] = __fmul_rn(d4.z, ah);
            a16[k + 3] = __fmul_rn(d4.w, ah);
          }
          float po[16], so[16];
          float p = 0.f, s = 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            po[k] = p = k == 0 ? a16[0] : __fadd_rn(p, a16[k]);
            so[15 - k] = s;
            s = __fadd_rn(s, a16[15 - k]);
          }
#pragma unroll
          for (int k = 0; k < 16; k += 4) {
            *reinterpret_cast<float4*>(pre + o + k) =
                make_float4(po[k], po[k + 1], po[k + 2], po[k + 3]);
            *reinterpret_cast<float4*>(sfx + o + k) =
                make_float4(so[k], so[k + 1], so[k + 2], so[k + 3]);
          }
          blk[lane * (kMaxBlocks + 1)] = p;
        }
        __syncwarp();
        if (lane < RT) {
          float tot[kMaxBlocks];
#pragma unroll
          for (int I = 0; I < kMaxBlocks; ++I)
            tot[I] = I < RT ? blk[I * (kMaxBlocks + 1)] : 0.f;
          // mid sums of block J = lane: blk[J][I] = the totals of J+1..I-1;
          // what is left after the last is the sum after J
          float mid = 0.f, before = 0.f;
#pragma unroll
          for (int I = 0; I < kMaxBlocks; ++I) {
            if (I < lane) before = __fadd_rn(before, tot[I]);
            if (I > lane && I < RT) {
              blk[lane * kMaxBlocks + I] = mid;
              mid = __fadd_rn(mid, tot[I]);
            }
          }
          ends[lane] = before;
          ends[kMaxBlocks + lane] = mid;
        }
        __syncwarp();
        float* decb = pr.dec + ((long long)un.b * pr.S + un.t0) * pr.H + h;
        for (int i = lane; i < L.CLp; i += 32) {
          const int I = i / 16;
          wdt[i] = expf(__fadd_rn(sfx[i], ends[kMaxBlocks + I])) * dts[i];
          if (i < CL) decb[(long long)i * pr.H] = expf(__fadd_rn(ends[I], pre[i]));
        }
      }
      __syncthreads();

      // ---- y = ((C B^T) o L o dt) x: row tile t_hi, then t_lo ----
      if (y_on) {
#pragma unroll 1
        for (int rr = 0; rr < 2; ++rr) {
          const int rt = rr == 0 ? t_hi : t_lo;
          if (rt >= RT) continue;
          const int i0 = 16 * rt + g;
          // this row tile's diagonal block: seg[r][c] at diag[r(r+1)/2 + c],
          // column c summed by lane c from row c + 1 down
          __syncwarp();  // the previous row tile's reads are done
          if (lane < 16) {
            const int o = 16 * rt;
            float a16[16];
#pragma unroll
            for (int k = 0; k < 16; k += 4) {
              const float4 d4 = *reinterpret_cast<const float4*>(dts + o + k);
              a16[k] = __fmul_rn(d4.x, ah);
              a16[k + 1] = __fmul_rn(d4.y, ah);
              a16[k + 2] = __fmul_rn(d4.z, ah);
              a16[k + 3] = __fmul_rn(d4.w, ah);
            }
            float run = 0.f;
            diag[lane * (lane + 1) / 2 + lane] = 0.f;
#pragma unroll
            for (int rw = 1; rw < 16; ++rw)
              if (rw > lane) {
                run = __fadd_rn(run, a16[rw]);
                diag[rw * (rw + 1) / 2 + lane] = run;
              }
          }
          __syncwarp();
          const float* dg0 = diag + g * (g + 1) / 2;        // row g
          const float* dg1 = diag + (g + 8) * (g + 9) / 2;  // row g + 8
          const float pi0 = pre[i0], pi1 = pre[i0 + 8];
          const float* grow = gsm + (rt * (rt + 1) / 2) * 256 + lane * 4;
          float acc[4][4];
#pragma unroll
          for (int v = 0; v < 4; ++v)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[v][e] = 0.f;
          // the 16-column block m: G's two halves, scaled into the scores'
          // two k-steps, then y's
          auto column_block = [&](const int m, auto diagonal) {
            constexpr bool on_diagonal = decltype(diagonal)::value;
            uint32_t sh[2][4], sl[2][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              // (i0, jc), (i0, jc+1), (i0+8, jc), (i0+8, jc+1)
              const float4 d = *reinterpret_cast<const float4*>(grow + (m * 2 + half) * 128);
              const int jc = 16 * m + 8 * half + 2 * q;
              const float2 dj = *reinterpret_cast<const float2*>(dts + jc);
              float e0, e1, e2, e3;
              if constexpr (!on_diagonal) {
                const float2 sj = *reinterpret_cast<const float2*>(sfx + jc);
                const float mid = blk[m * kMaxBlocks + rt];
                const float s0 = __fadd_rn(sj.x, mid), s1 = __fadd_rn(sj.y, mid);
                e0 = __fadd_rn(s0, pi0);
                e1 = __fadd_rn(s1, pi0);
                e2 = __fadd_rn(s0, pi1);
                e3 = __fadd_rn(s1, pi1);
              } else {
                const int c = 8 * half + 2 * q;  // jc's column in the block
                e0 = c <= g ? dg0[c] : -INFINITY;
                e1 = c + 1 <= g ? dg0[c + 1] : -INFINITY;
                e2 = c <= g + 8 ? dg1[c] : -INFINITY;
                e3 = c + 1 <= g + 8 ? dg1[c + 1] : -INFINITY;
              }
              // the A operand at physical k = q (j = jc) and q + 4 (jc + 1)
              split(d.x * exp2_approx(e0 * kLog2e) * dj.x, sh[half][0], sl[half][0]);
              split(d.z * exp2_approx(e2 * kLog2e) * dj.x, sh[half][1], sl[half][1]);
              split(d.y * exp2_approx(e1 * kLog2e) * dj.y, sh[half][2], sl[half][2]);
              split(d.w * exp2_approx(e3 * kLog2e) * dj.y, sh[half][3], sl[half][3]);
            }
#pragma unroll
            for (int v = 0; v < 4; ++v) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                uint32_t xh[2], xl[2];
                load_x(xst, L.xs, 16 * m + 8 * half, q, pcol[v], xh, xl);
                mma3_add(acc[v], sh[half], sl[half], xh, xl);
              }
            }
          };
#pragma unroll 2
          for (int m = 0; m < rt; ++m) column_block(m, Flag<false>{});
          column_block(rt, Flag<true>{});
          float* yr = pr.y + (((long long)un.b * pr.S + un.t0) * pr.H + h) * P;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int p = 8 * (4 * ph + v) + 2 * q;
            if (p >= P) continue;
            if (i0 < CL)
              *reinterpret_cast<float2*>(yr + (long long)i0 * pr.H * P + p) =
                  make_float2(acc[v][0], acc[v][1]);
            if (i0 + 8 < CL)
              *reinterpret_cast<float2*>(yr + (long long)(i0 + 8) * pr.H * P + p) =
                  make_float2(acc[v][2], acc[v][3]);
          }
        }
      }

      // ---- st = (B o w dt)^T x: state rows 32 r .. 32 r + 31 ----
      if (st_on) {
        const float* bst = smem + L.b;
        float sacc[2][4][4];
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int w = 0; w < 4; ++w)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[v][w][e] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < L.CLp / 8; ++kk) {
          const int j0 = 8 * kk, ja = j0 + 2 * q;
          const float2 w = *reinterpret_cast<const float2*>(wdt + ja);
          uint32_t sah[2][4], sal[2][4];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int m0 = 32 * r + 16 * v + g;
            split(bst[ja * L.bs + m0] * w.x, sah[v][0], sal[v][0]);
            split(bst[ja * L.bs + m0 + 8] * w.x, sah[v][1], sal[v][1]);
            split(bst[(ja + 1) * L.bs + m0] * w.y, sah[v][2], sal[v][2]);
            split(bst[(ja + 1) * L.bs + m0 + 8] * w.y, sah[v][3], sal[v][3]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            uint32_t xh[2], xl[2];
            load_x(xst, L.xs, j0, q, pcol[c], xh, xl);
#pragma unroll
            for (int v = 0; v < 2; ++v) mma3_add(sacc[v][c], sah[v], sal[v], xh, xl);
          }
        }
        float* stb = pr.st + (((long long)un.b * pr.NC + un.c) * pr.H + h) * N * P;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int m0 = 32 * r + 16 * v + g, m1 = m0 + 8;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = 8 * (4 * ph + c) + 2 * q;
            if (p >= P) continue;
            if (m0 < N)
              *reinterpret_cast<float2*>(stb + (long long)m0 * P + p) =
                  make_float2(sacc[v][c][0], sacc[v][c][1]);
            if (m1 < N)
              *reinterpret_cast<float2*>(stb + (long long)m1 * P + p) =
                  make_float2(sacc[v][c][2], sacc[v][c][3]);
          }
        }
      }
    }
  }
}

// Work in mma3 units (three m16n8k8 passes) of G for one (b, c) and of
// y and the state for one head.
struct Cost {
  long long g, head;
};

Cost cost_of(int CL, int N, int P) {
  const Layout L = make_layout(CL, N, P);
  const long long rt = L.CLp / 16, blocks = rt * (rt + 1) / 2, nt = L.Pp / 8;
  return {blocks * 2 * (L.Np / 8), blocks * 2 * nt + (L.Np / 16) * nt * (L.CLp / 8)};
}

// The head groups a (b, c) splits into: where B and C are shared by the
// heads, the count whose units (slots a wave) finish first under the
// cost model (ties to fewer groups, less G recomputed); else one a head.
int head_groups(int B, int NC, int H, const Cost& cost, long long slots, bool shared) {
  if (!shared) return H;
  int best = 1;
  long long best_cost = -1;
  for (int groups = 1; groups <= H; ++groups) {
    const long long units = (long long)B * NC * groups;
    const long long waves = (units + slots - 1) / slots;
    const long long most = (H + groups - 1) / groups;  // heads of the largest group
    const long long c = waves * (cost.g + most * cost.head);
    if (best_cost < 0 || c < best_cost) {
      best = groups;
      best_cost = c;
    }
  }
  return best;
}

struct Device {
  int configured = 0, sms = 0, per_sm = 0;
};

int configure(Device** out) {
  static Device devices[kMaxDevices];
  auto kernel = ssd_chunk_sm90_wide;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (!d.configured) {
    // the most any accepted shape needs: CL = 128, P = 64, N = 128
    const int most = make_layout(kMaxCL, kMaxN, kMaxP).total * (int)sizeof(float);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.per_sm, kernel, kThreads, most);
    if (err != cudaSuccess) return (int)err;
    if (d.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    d.configured = 1;
  }
  *out = &d;
  return 0;
}

bool accepted(int S, int P, int N, int CL) {
  return CL >= 1 && CL <= kMaxCL && P >= 4 && P <= kMaxP && P % 4 == 0 && N >= 4 &&
         N <= kMaxN && N % 4 == 0 && S % CL == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA uses at chunk CL, state N, head dim P.
int ssd_chunk_sm90_wide_smem_bytes(int CL, int N, int P) {
  return make_layout(CL, N, P).total * (int)sizeof(float);
}

// The launch's plan on the current device, into out[0..3]: head groups a
// (b, c), units (CTAs of work), the persistent grid and CTAs an SM.
// `shared` says whether B and C have a head stride of 0.
int ssd_chunk_sm90_wide_plan(int B, int S, int H, int P, int N, int CL, int shared,
                             int* out) {
  if (!accepted(S, P, N, CL) || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Device* d = nullptr;
  const int err = configure(&d);
  if (err) return err;
  const long long slots = (long long)d->per_sm * d->sms;
  const int groups = head_groups(B, S / CL, H, cost_of(CL, N, P), slots, shared != 0);
  const long long units = (long long)B * (S / CL) * groups;
  out[0] = groups;
  out[1] = (int)units;
  out[2] = (int)(units < slots ? units : slots);
  out[3] = d->per_sm;
  return 0;
}

// Launch on `stream`. x (B, S, H, P), dt (B, S, H), B and C (B, S, H, N)
// are float32 read through `strides` (12 values: batch, sequence and
// head strides of x, dt, B, C in elements; the last dim is contiguous,
// a head stride may be 0); x, B and C need 16-byte aligned base
// pointers and strides, P and N multiples of 4 (the wrapper checks).
// a (H,) is contiguous. Outputs are contiguous float32: y (B, S, H, P),
// st (B, S/CL, H, N, P), dec (B, S, H). S must be a multiple of CL,
// CL <= 128, P <= 64, N <= 128. Returns the cudaError_t of the launch.
int ssd_chunk_sm90_wide_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y, void* st,
                               void* dec, const long long* strides, int B, int S,
                               int H, int P, int N, int CL, void* stream) {
  if (!accepted(S, P, N, CL)) return (int)cudaErrorInvalidValue;
  Params pr;
  pr.x = static_cast<const float*>(x);
  pr.dt = static_cast<const float*>(dt);
  pr.a = static_cast<const float*>(a);
  pr.bm = static_cast<const float*>(bm);
  pr.cm = static_cast<const float*>(cm);
  pr.y = static_cast<float*>(y);
  pr.st = static_cast<float*>(st);
  pr.dec = static_cast<float*>(dec);
  for (int i = 0; i < 3; ++i) {
    pr.sd.x[i] = strides[i];
    pr.sd.dt[i] = strides[3 + i];
    pr.sd.b[i] = strides[6 + i];
    pr.sd.c[i] = strides[9 + i];
  }
  pr.S = S;
  pr.H = H;
  pr.P = P;
  pr.N = N;
  pr.CL = CL;
  pr.NC = S / CL;
  const bool shared = pr.sd.b[2] == 0 && pr.sd.c[2] == 0;
  int plan[4];
  const int err = ssd_chunk_sm90_wide_plan(B, S, H, P, N, CL, shared ? 1 : 0, plan);
  if (err) return err;
  pr.groups = plan[0];
  pr.units = plan[1];
  const int bytes = make_layout(CL, N, P).total * (int)sizeof(float);
  ssd_chunk_sm90_wide<<<plan[2], kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(pr);
  return (int)cudaGetLastError();
}

}  // extern "C"
