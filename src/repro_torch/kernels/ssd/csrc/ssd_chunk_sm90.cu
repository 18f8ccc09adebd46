// ssd_chunk_sm90: the Mamba-2 SSD intra-chunk pass written for Hopper
// (sm_90a), its three products on the tensor cores at float32 accuracy
// (3xTF32) and each chunk's tiles loaded while the previous one computes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py:31,
// function _ssd_chunk_kernel (called through ssd_intra_chunk), for chunk
// CL <= 128, head dim P <= 64 and state N <= 32 with P and N multiples
// of 4 (ssd.route); ssd_chunk.cu keeps every other shape on the CUDA
// cores. It computes what the TPU kernel computes, float32 in and out,
// for each (batch b, chunk c, head h):
//   a    = dt * A[h],  cum = inclusive cumsum(a)           (CL,)
//   seg  = sum of a_k over k = j+1..i, for i >= j           (CL, CL)
//   L    = exp(seg) for i >= j, else 0                      (CL, CL)
//   y    = ((C B^T) o L) (x * dt)                           (CL, P)
//   st   = (B * exp(sum of a_k over k = j+1..CL-1))^T (x * dt)  (N, P)
//   dec  = exp(cum)                                         (CL,)
// L and the decay to the chunk's end are taken from segment sums, not
// as exp(cum_i - cum_j): on the model's dt and A cum reaches -1900
// within a chunk, and the difference of two such sums loses the digits
// that exp(seg) needs near the diagonal (kernels/ssd/ref.py::segsum).
//
// What bounds it on this card. At the serving shape (B=4, S=512, H=50,
// P=64, N=16, CL=128) the function moves 56.8 MB (x in and y out, 26 MB
// each, the states 3.3 MB; B and C are shared by the heads and small):
// 17.0 us at 3.35 TB/s. Its products are 1.27 GFLOP; three TF32 passes
// on the tensor cores (495 TFLOP/s) take 7.7 us, so bytes bound it.
//
// What the design does.
//  - All three products run on the tensor cores with
//    mma.sync.m16n8k8 .tf32 and float32 accumulators: G = C B^T
//    (k = N), y = (G o L)(x dt) (k = j <= i) and st = (B o w)^T (x dt)
//    (M = N). Each operand v is split into hi, v rounded to tf32 as
//    cvt.rna.tf32.f32 rounds it (to nearest, ties away from zero), and
//    lo = v - hi, and a product is lo.hi + hi.lo + hi.hi: one TF32 pass
//    misses the 2e-4 tolerance by 32-276x, three stay 10x inside it. hi
//    is rounded by two integer operations and lo is left for the tensor
//    core to drop its low 13 bits, because cvt issues at a fraction of
//    their rate (launch/ablate_ssd.py times the two). The three passes
//    of each k-step of y and st sum into a zeroed accumulator that is
//    then added to the running float32 sum, so the tensor cores'
//    truncating adds only ever see one k-step.
//  - mma.sync and not wgmma: wgmma reads tf32 only K-major from shared
//    memory, and x, y's B operand, is p-contiguous, so a wgmma kernel
//    has to convert every tile into transposed hi and lo copies first;
//    st's M = N = 16 is below wgmma's 64 rows.
//  - Only the 16 x 8 tiles on or below the diagonal are computed. A
//    warp takes row tiles t and CL/16 - 1 - t, so the four warps do the
//    same work (two at CL = 64 split P between them, four at CL <= 32).
//    It computes a row tile in 16-column blocks, two blocks at a time,
//    each block's two k-steps of scores together.
//  - The scores never go through shared memory: G's accumulators are
//    scaled in registers by exp(seg_ij) * dt_j, masked to 0 for j > i
//    before the exp. seg is built from 16-row sub-blocks so that no sum
//    in it is a difference: for j in block J below i's block I, seg =
//    (sfx_j + mid_JI) + pre_i, with pre_i the sum from I's first row to
//    i, sfx_j the sum from j + 1 to J's last row and mid_JI the sum of
//    the whole blocks between, all sums of same-sign steps; within a
//    diagonal block each warp writes seg into a 16 x 16 lower-triangular
//    table, one column a lane, summed from k = j + 1 down the rows (the
//    plain version's order). The
//    accumulator holds columns 2q and 2q+1 of a quad's rows where the A
//    operand wants columns q and q+4, so y's k index is permuted instead
//    of the scores: physical k = q, q+4 stands for j = 2q, 2q+1, and x
//    is read at those rows. The state product uses the same permutation.
//  - Persistent CTAs of 4 warps, two an SM at the serving shape, walk
//    the (b, c, h) tiles head-fastest (heads of one chunk share B and C
//    in L2). x, B, C and dt are staged by cp.async (16 bytes; 4 for dt,
//    whose rows are H floats apart) into a two-stage ring: the next
//    tile's copies are in flight while this one computes. B and C are
//    read through their strides, so the model's stride-0 views over
//    heads are never copied per head.
//  - N and P are zero-padded to multiples of 8, CL to a multiple of 16,
//    in shared memory; padding is exact (zero rows of B, C, x and dt).
//    Row strides P + 4 and N + 4 (odd multiples of 4 floats) keep every
//    fragment load free of bank conflicts.
//  - One lane of warp 0 sums cum (for dec) and the reverse sums to the
//    chunk's end (for the state) sequentially, the next 8 steps loaded
//    while 8 are added; meanwhile one lane of warp 1 per 16-row block
//    sums its pre and sfx lines and its total, then its row of mid sums;
//    each lane of a diagonal table's column sums from registers.
//  - y and the states leave straight from the accumulators: each warp
//    store fills the whole 32-byte sectors of eight rows. (Staging y
//    through shared memory would need the x buffer, which the other
//    warps read until every row tile is done.)
//  - The kernel's shared-memory opt-in is set once per device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCL = 128;
constexpr int kMaxP = 64;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

// Flag, Strides, the cp.async helpers, split, exp2_approx, mma, mma3_add
// and load_x have copies in ssd_chunk_sm90_wide.cu: a fix to one belongs
// in the other. Each source builds alone, with its own flags, and
// launch/ablate_ssd.py patches these functions' text in each file.

// A compile-time flag passed to a generic lambda.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

struct Strides {  // in elements: batch, sequence, head (last dim is 1)
  long long x[3], dt[3], b[3], c[3];
};

constexpr int kMaxBlocks = kMaxCL / 16;  // 16-row sub-blocks of a chunk
constexpr int kDiag = 16 * 17 / 2;        // a lower-triangular 16 x 16 table

// Shared memory in floats: two stages of x (CLp rows of xs), B and C
// (CLp rows of bs each) and dt (CLp); then pre, sfx and w*dt (CLp each),
// the mid sums between sub-blocks (kMaxBlocks^2, block totals on the
// diagonal) and one diagonal-block seg table a warp.
struct Layout {
  int CLp, Pp, Np, xs, bs;
  int x, b, c, dt, stage;
  int pre, sfx, wdt, blk, diag, total;
};

__host__ __device__ inline Layout make_layout(int CL, int N, int P) {
  Layout L;
  L.CLp = (CL + 15) / 16 * 16;
  L.Pp = (P + 7) / 8 * 8;
  L.Np = (N + 7) / 8 * 8;
  L.xs = L.Pp + 4;
  L.bs = L.Np + 4;
  L.x = 0;
  L.b = L.x + L.CLp * L.xs;
  L.c = L.b + L.CLp * L.bs;
  L.dt = L.c + L.CLp * L.bs;
  L.stage = L.dt + L.CLp;  // a multiple of 16 floats: CLp is
  L.pre = 2 * L.stage;
  L.sfx = L.pre + L.CLp;
  L.wdt = L.sfx + L.CLp;
  L.blk = L.wdt + L.CLp;
  L.diag = L.blk + kMaxBlocks * kMaxBlocks;
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
  int S, H, P, N, CL, NC, tiles;
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

// 2^x on the special-function unit (relative error about 2^-22; a
// result below 2^-126 is 0, which is what it adds to a sum anyway).
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

// d += the three passes lo.hi + hi.lo + hi.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// acc += one k-step's three passes, summed apart from acc first.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(d, ah, al, bh, bl);
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

// This thread's share of rows of `w4` 16-byte pieces: piece k of rows
// r0, r0 + step, ... (on is false for the threads left over).
struct Rows {
  int r0, k, step;
  bool on;
  __device__ Rows(int w4) {
    step = kThreads / w4;
    r0 = threadIdx.x / w4;
    k = threadIdx.x - r0 * w4;
    on = r0 < step;
  }
};

struct Tile {
  int b, c, h;
  long long t0;
  __device__ Tile(int tile, const Params& pr) {
    h = tile % pr.H;
    const int bc = tile / pr.H;
    c = bc % pr.NC;
    b = bc / pr.NC;
    t0 = (long long)c * pr.CL;
  }
};

__device__ void load_tile(const Params& pr, const Layout& L, const Rows& xr,
                          const Rows& br, float* stage, const Tile& t) {
  const Strides& sd = pr.sd;
  const float* xsrc = pr.x + t.b * sd.x[0] + t.t0 * sd.x[1] + t.h * sd.x[2];
  const float* bsrc = pr.bm + t.b * sd.b[0] + t.t0 * sd.b[1] + t.h * sd.b[2];
  const float* csrc = pr.cm + t.b * sd.c[0] + t.t0 * sd.c[1] + t.h * sd.c[2];
  const float* dsrc = pr.dt + t.b * sd.dt[0] + t.t0 * sd.dt[1] + t.h * sd.dt[2];
  if (xr.on)
    for (int i = xr.r0; i < pr.CL; i += xr.step)
      cp_async16(stage + L.x + i * L.xs + 4 * xr.k, xsrc + i * sd.x[1] + 4 * xr.k);
  if (br.on)
    for (int i = br.r0; i < pr.CL; i += br.step) {
      cp_async16(stage + L.b + i * L.bs + 4 * br.k, bsrc + i * sd.b[1] + 4 * br.k);
      cp_async16(stage + L.c + i * L.bs + 4 * br.k, csrc + i * sd.c[1] + 4 * br.k);
    }
  for (int i = threadIdx.x; i < pr.CL; i += kThreads)
    cp_async4(stage + L.dt + i, dsrc + i * sd.dt[1]);
}

// KN: k-steps of 8 over the state in C B^T (N <= 8 * KN). NTW: the
// 8-column tiles of y a warp owns (its row tiles times NTW tiles).
template <int KN, int NTW>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_sm90(Params pr) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(pr.CL, pr.N, pr.P);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int CL = pr.CL, P = pr.P, N = pr.N;
  float* pre = smem + L.pre;
  float* sfx = smem + L.sfx;
  float* wdt = smem + L.wdt;
  float* blk = smem + L.blk;
  float* diag = smem + L.diag + warp * kDiag;
  const Rows xr(P / 4), br(N / 4);

  // Padding (rows past CL, columns past P and N) stays zero: the copies
  // write only real positions.
  for (int e = tid; e < L.total; e += kThreads) smem[e] = 0.f;
  __syncthreads();

  // The work of this warp in every tile: row tiles t_hi >= t_lo of one
  // group, and the 8-column tiles nt0 .. nt0 + NTW - 1 of y (those past
  // the last, NTt - 1, repeat it and are not stored).
  const int RT = L.CLp / 16, NG = (RT + 1) / 2;
  const int ngw = NG < kWarps ? NG : kWarps;
  const int nsplit = kWarps / ngw;
  const int NTt = L.Pp / 8;
  const int grp = warp % ngw;
  const int nt0 = (warp / ngw) * NTW;
  const bool y_warp = warp < ngw * nsplit && nt0 < NTt;
  const int t_hi = RT - 1 - grp, t_lo = grp;
  const bool two = t_hi != t_lo;
  int pcol[NTW];  // the x column this thread reads in each of its tiles
#pragma unroll
  for (int u = 0; u < NTW; ++u) pcol[u] = 8 * min(nt0 + u, NTt - 1) + g;
  const int MT = (L.Np + 15) / 16;  // 16-row tiles of the state
  // the state's two column tiles of this warp: warp and warp + 4
  const int st_pc0 = 8 * min(warp, NTt - 1) + g;
  const int st_pc1 = 8 * min(warp + kWarps, NTt - 1) + g;

  int tile = blockIdx.x;
  if (tile < pr.tiles) load_tile(pr, L, xr, br, smem, Tile(tile, pr));
  cp_async_commit();
  for (int it = 0; tile < pr.tiles; ++it, tile += gridDim.x) {
    float* stage = smem + (it & 1) * L.stage;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the other stage is free
    const int next = tile + gridDim.x;
    if (next < pr.tiles)
      load_tile(pr, L, xr, br, smem + ((it + 1) & 1) * L.stage, Tile(next, pr));
    cp_async_commit();

    const Tile t(tile, pr);
    const float* xst = stage + L.x;
    const float* bst = stage + L.b;
    const float* cst = stage + L.c;
    const float* dts = stage + L.dt;

    // ---- dec, w * dt and the segment-sum lines ----
    // Warp 0: lane 0 sums cum and the sums from j + 1 to the chunk's end
    // sequentially, then the warp turns them into dec and w * dt. Warp
    // 1, meanwhile: one lane per 16-row block sums its pre and sfx lines
    // and its total, then its row of mid sums. Every load of dt is issued
    // ahead of the adds that wait on it: the compiler cannot move a
    // shared load past the shared stores between.
    const float ah = pr.a[t.h];
    const int RT = L.CLp / 16;
    if (warp == 0) {
      // cum goes to warp 0's diagonal table, free until after the barrier
      float* cum = diag;
      if (lane == 0) {
        // a padded step adds -0, so the padding's cum is the last real
        // one and its sums to the end are 0
        float run = 0.f, rev = 0.f;
        float4 u = *reinterpret_cast<const float4*>(dts);
        float4 v = *reinterpret_cast<const float4*>(dts + 4);
        float4 w = *reinterpret_cast<const float4*>(dts + L.CLp - 8);
        float4 x = *reinterpret_cast<const float4*>(dts + L.CLp - 4);
        for (int i0 = 0; i0 < L.CLp; i0 += 8) {
          const int r0 = L.CLp - 8 - i0;
          const float f[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
          const float r[8] = {w.x, w.y, w.z, w.w, x.x, x.y, x.z, x.w};
          if (i0 + 8 < L.CLp) {  // the next 8 steps of each, ahead
            u = *reinterpret_cast<const float4*>(dts + i0 + 8);
            v = *reinterpret_cast<const float4*>(dts + i0 + 12);
            w = *reinterpret_cast<const float4*>(dts + r0 - 8);
            x = *reinterpret_cast<const float4*>(dts + r0 - 4);
          }
          float fo[8], ro[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            fo[k] = run = __fadd_rn(run, __fmul_rn(f[k], ah));
            ro[7 - k] = rev;
            rev = __fadd_rn(rev, __fmul_rn(r[7 - k], ah));
          }
          *reinterpret_cast<float4*>(cum + i0) = make_float4(fo[0], fo[1], fo[2], fo[3]);
          *reinterpret_cast<float4*>(cum + i0 + 4) = make_float4(fo[4], fo[5], fo[6], fo[7]);
          *reinterpret_cast<float4*>(wdt + r0) = make_float4(ro[0], ro[1], ro[2], ro[3]);
          *reinterpret_cast<float4*>(wdt + r0 + 4) = make_float4(ro[4], ro[5], ro[6], ro[7]);
        }
      }
      __syncwarp();
      float* decb = pr.dec + ((long long)t.b * pr.S + t.t0) * pr.H + t.h;
      for (int i = lane; i < L.CLp; i += 32) {
        wdt[i] = expf(wdt[i]) * dts[i];
        if (i < CL) decb[(long long)i * pr.H] = expf(cum[i]);
      }
    } else if (warp == 1) {
      if (lane < RT) {
        // block `lane`: pre from its first row, sfx from j + 1 to its
        // last row, and its total on the diagonal of blk
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
        float p = 0.f, q = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          po[k] = p = k == 0 ? a16[0] : __fadd_rn(p, a16[k]);
          so[15 - k] = q;
          q = __fadd_rn(q, a16[15 - k]);
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
        // mid sums of block J = lane: blk[J][I] = the totals of J+1..I-1
        float tot[kMaxBlocks];
#pragma unroll
        for (int I = 0; I < kMaxBlocks; ++I)
          tot[I] = I < RT ? blk[I * (kMaxBlocks + 1)] : 0.f;
        float mid = 0.f;
#pragma unroll
        for (int I = 1; I < kMaxBlocks; ++I)
          if (I > lane && I < RT) {
            blk[lane * kMaxBlocks + I] = mid;
            mid = __fadd_rn(mid, tot[I]);
          }
      }
    }
    __syncthreads();

    // ---- y = ((C B^T) o L o dt) x, tiles on or below the diagonal ----
    // Row tile t_hi, then t_lo; each 16-column block j0 = 16m, m <= t,
    // is two k-steps whose scores are computed together.
    if (y_warp) {
#pragma unroll 1
      for (int rr = 0; rr < 2; ++rr) {
        if (rr == 1 && !two) break;
        const int rt = rr == 0 ? t_hi : t_lo;
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
          for (int r = 1; r < 16; ++r)
            if (r > lane) {
              run = __fadd_rn(run, a16[r]);
              diag[r * (r + 1) / 2 + lane] = run;
            }
        }
        __syncwarp();
        const float* dg0 = diag + g * (g + 1) / 2;             // row g
        const float* dg1 = diag + (g + 8) * (g + 9) / 2;       // row g + 8
        // C's rows i0, i0 + 8 as A operands
        uint32_t ch[KN][4], cl[KN][4];
#pragma unroll
        for (int kn = 0; kn < KN; ++kn) {
          const int n0 = 8 * kn + q;
          const bool in = 8 * kn < L.Np;
          split(in ? cst[i0 * L.bs + n0] : 0.f, ch[kn][0], cl[kn][0]);
          split(in ? cst[(i0 + 8) * L.bs + n0] : 0.f, ch[kn][1], cl[kn][1]);
          split(in ? cst[i0 * L.bs + n0 + 4] : 0.f, ch[kn][2], cl[kn][2]);
          split(in ? cst[(i0 + 8) * L.bs + n0 + 4] : 0.f, ch[kn][3], cl[kn][3]);
        }
        const float pi0 = pre[i0], pi1 = pre[i0 + 8];
        float acc[NTW][4];
#pragma unroll
        for (int u = 0; u < NTW; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
        // the 16-column block m of this row tile: its two k-steps of
        // scores, then y's; the diagonal block (m == rt) reads seg from
        // the warp's table, the others add their three lines, so the
        // loop over the blocks below the diagonal has no branch
        auto column_block = [&](const int m, auto diagonal) {
          constexpr bool on_diagonal = decltype(diagonal)::value;
          uint32_t sh[2][4], sl[2][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int jb = 16 * m + 8 * half;
            // B's rows jb..jb+7 as the B operand of C B^T, one chain
            // of three passes for each k-step over the state
            float d[KN][4];
#pragma unroll
            for (int kn = 0; kn < KN; ++kn) {
#pragma unroll
              for (int e = 0; e < 4; ++e) d[kn][e] = 0.f;
              const bool in = 8 * kn < L.Np;
              uint32_t bh[2], bl[2];
              split(in ? bst[(jb + g) * L.bs + 8 * kn + q] : 0.f, bh[0], bl[0]);
              split(in ? bst[(jb + g) * L.bs + 8 * kn + q + 4] : 0.f, bh[1], bl[1]);
              mma3(d[kn], ch[kn], cl[kn], bh, bl);
            }
#pragma unroll
            for (int kn = 1; kn < KN; ++kn)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[0][e] += d[kn][e];
            const int jc = jb + 2 * q;
            const float2 dj = *reinterpret_cast<const float2*>(dts + jc);
            // d holds (i0, jc), (i0, jc+1), (i0+8, jc), (i0+8, jc+1);
            // their seg, -inf above the diagonal
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
            split(d[0][0] * exp2_approx(e0 * kLog2e) * dj.x, sh[half][0], sl[half][0]);
            split(d[0][2] * exp2_approx(e2 * kLog2e) * dj.x, sh[half][1], sl[half][1]);
            split(d[0][1] * exp2_approx(e1 * kLog2e) * dj.y, sh[half][2], sl[half][2]);
            split(d[0][3] * exp2_approx(e3 * kLog2e) * dj.y, sh[half][3], sl[half][3]);
          }
#pragma unroll
          for (int u = 0; u < NTW; ++u) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              uint32_t xh[2], xl[2];
              load_x(xst, L.xs, 16 * m + 8 * half, q, pcol[u], xh, xl);
              mma3_add(acc[u], sh[half], sl[half], xh, xl);
            }
          }
        };
#pragma unroll 2
        for (int m = 0; m < rt; ++m) column_block(m, Flag<false>{});
        column_block(rt, Flag<true>{});
        // y leaves from the accumulators: a warp's store fills eight
        // rows' 32-byte sectors
        float* yr = pr.y + (((long long)t.b * pr.S + t.t0) * pr.H + t.h) * P;
#pragma unroll
        for (int u = 0; u < NTW; ++u) {
          const int p = 8 * (nt0 + u) + 2 * q;
          if (p >= P) continue;
          if (i0 < CL)
            *reinterpret_cast<float2*>(yr + (long long)i0 * pr.H * P + p) =
                make_float2(acc[u][0], acc[u][1]);
          if (i0 + 8 < CL)
            *reinterpret_cast<float2*>(yr + (long long)(i0 + 8) * pr.H * P + p) =
                make_float2(acc[u][2], acc[u][3]);
        }
      }
    }

    // ---- st = (B o w dt)^T x: warp w takes column tiles w, w + 4 ----
    float* stb = pr.st + (((long long)t.b * pr.NC + t.c) * pr.H + t.h) * N * P;
    if (warp < NTt) {
      for (int mt = 0; mt < MT; ++mt) {
        float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const int m0 = 16 * mt + g, m1 = m0 + 8;
        const bool in0 = m0 < L.Np, in1 = m1 < L.Np;
#pragma unroll 2
        for (int kk = 0; kk < L.CLp / 8; ++kk) {
          const int j0 = 8 * kk, ja = j0 + 2 * q;
          const float2 w = *reinterpret_cast<const float2*>(wdt + ja);
          uint32_t ah[4], al[4];
          split(in0 ? bst[ja * L.bs + m0] * w.x : 0.f, ah[0], al[0]);
          split(in1 ? bst[ja * L.bs + m1] * w.x : 0.f, ah[1], al[1]);
          split(in0 ? bst[(ja + 1) * L.bs + m0] * w.y : 0.f, ah[2], al[2]);
          split(in1 ? bst[(ja + 1) * L.bs + m1] * w.y : 0.f, ah[3], al[3]);
          uint32_t xh[2], xl[2];
          load_x(xst, L.xs, j0, q, st_pc0, xh, xl);
          mma3_add(sacc[0], ah, al, xh, xl);
          load_x(xst, L.xs, j0, q, st_pc1, xh, xl);
          mma3_add(sacc[1], ah, al, xh, xl);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int p = 8 * (warp + v * kWarps) + 2 * q;
          if (p >= P) continue;
          if (m0 < N)
            *reinterpret_cast<float2*>(stb + (long long)m0 * P + p) =
                make_float2(sacc[v][0], sacc[v][1]);
          if (m1 < N)
            *reinterpret_cast<float2*>(stb + (long long)m1 * P + p) =
                make_float2(sacc[v][2], sacc[v][3]);
        }
      }
    }
  }
}

template <int KN, int NTW>
int launch(const Params& pr, int bytes, cudaStream_t stream, int* ctas_per_sm) {
  struct Device {
    int configured = 0, sms = 0, last_bytes = -1, per_sm = 0;
  };
  static Device devices[kMaxDevices];
  auto kernel = ssd_chunk_sm90<KN, NTW>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (!d.configured) {
    // the most any accepted shape needs: CL = 128, P = 64, N = 8 * KN
    const int most = make_layout(kMaxCL, 8 * KN, kMaxP).total * (int)sizeof(float);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    d.configured = 1;
  }
  if (bytes != d.last_bytes) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&d.per_sm, kernel, kThreads, bytes);
    if (err != cudaSuccess) return (int)err;
    if (d.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    d.last_bytes = bytes;
  }
  if (ctas_per_sm) {
    *ctas_per_sm = d.per_sm;
    return 0;
  }
  const long long slots = (long long)d.per_sm * d.sms;
  const int grid = (int)(pr.tiles < slots ? pr.tiles : slots);
  kernel<<<grid, kThreads, bytes, stream>>>(pr);
  return (int)cudaGetLastError();
}

// The instantiation for a shape: KN k-steps over N, NTW column tiles a
// warp (the column tiles of P split between the warps of a row group,
// rounded up to a power of two).
template <int KN>
int dispatch(const Params& pr, int bytes, cudaStream_t stream, int* ctas_per_sm) {
  const Layout L = make_layout(pr.CL, pr.N, pr.P);
  const int NG = (L.CLp / 16 + 1) / 2;
  const int nsplit = kWarps / (NG < kWarps ? NG : kWarps);
  const int per = (L.Pp / 8 + nsplit - 1) / nsplit;
  if (per <= 1) return launch<KN, 1>(pr, bytes, stream, ctas_per_sm);
  if (per <= 2) return launch<KN, 2>(pr, bytes, stream, ctas_per_sm);
  if (per <= 4) return launch<KN, 4>(pr, bytes, stream, ctas_per_sm);
  return launch<KN, 8>(pr, bytes, stream, ctas_per_sm);
}

int run(const Params& pr, cudaStream_t stream, int* ctas_per_sm) {
  const int bytes = make_layout(pr.CL, pr.N, pr.P).total * (int)sizeof(float);
  return pr.N <= 16 ? dispatch<2>(pr, bytes, stream, ctas_per_sm)
                    : dispatch<4>(pr, bytes, stream, ctas_per_sm);
}

bool accepted(int S, int P, int N, int CL) {
  return CL >= 1 && CL <= kMaxCL && P >= 4 && P <= kMaxP && P % 4 == 0 && N >= 4 &&
         N <= 32 && N % 4 == 0 && S % CL == 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA uses at chunk CL, state N, head dim P.
int ssd_chunk_sm90_smem_bytes(int CL, int N, int P) {
  return make_layout(CL, N, P).total * (int)sizeof(float);
}

// CTAs of the kernel for (CL, N, P) that fit an SM of the current
// device (the persistent grid is this times the SMs), into *out.
int ssd_chunk_sm90_ctas_per_sm(int CL, int N, int P, int* out) {
  if (!accepted(CL, P, N, CL)) return (int)cudaErrorInvalidValue;
  Params pr{};
  pr.CL = CL;
  pr.N = N;
  pr.P = P;
  return run(pr, nullptr, out);
}

// Launch on `stream`. x (B, S, H, P), dt (B, S, H), B and C (B, S, H, N)
// are float32 read through `strides` (12 values: batch, sequence and
// head strides of x, dt, B, C in elements; the last dim is contiguous,
// a head stride may be 0); x, B and C need 16-byte aligned base
// pointers and strides, P and N multiples of 4 (the wrapper checks).
// a (H,) is contiguous. Outputs are contiguous float32: y (B, S, H, P),
// st (B, S/CL, H, N, P), dec (B, S, H). S must be a multiple of CL,
// CL <= 128, P <= 64, N <= 32. Returns the cudaError_t of the launch.
int ssd_chunk_sm90_launch(const void* x, const void* dt, const void* a,
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
  pr.tiles = B * pr.NC * H;
  return run(pr, static_cast<cudaStream_t>(stream), nullptr);
}

}  // extern "C"
