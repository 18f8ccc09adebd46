// flash_fwd_sm90: GQA attention forward in bf16 at head dims 64, 128,
// 192 and 256, written for Hopper (sm_90a): both products on the tensor
// cores (wgmma), the K and V tiles staged by TMA.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py, function
// _flash_kernel (called through flash_attention), for bf16 inputs at
// D in {64, 128, 192, 256}; flash_attention.cu keeps float32 and bf16 at
// D in {16, 32} on the CUDA cores. It computes what the TPU kernel
// computes: for each (batch, query head h) and each query row, softmax
// over the keys of kv head h / group of (q . k) * D^-0.5, with a causal
// mask (k <= q) and an optional sliding window (k > q - window), times v.
// The running (m, l, acc) of the online softmax are float32; a masked
// score is -1e30 with weight 0, so a row masked so far keeps m = -1e30
// and corr = 1; the output is acc / max(l, 1e-30) in bf16, a contiguous
// (B, Hq, S, D). Any S: TMA zero-fills the rows of a ragged last tile
// and the kernel masks them.
//
// What bounds it on this card. At hymba's serving shape (B=4, S=512,
// Hq=25, Hkv=5, D=64, causal) the function moves 15.7 MB (q, k, v read
// once, out written once), 4.7 us at 3.35 TB/s, and needs 3.4 GFLOP of
// unmasked products, 3.4 us at the bf16 tensor-core peak; the tiles it
// computes (masked corners included) are about 3.8 GFLOP. At that size
// latency, occupancy and the grid's tail set the time, not either peak.
// At paligemma's prefill (B=4, S=768, Hq=8, Hkv=1, D=256) the products
// (9.7 GFLOP, 9.8 us) bind, not the 28.3 MB (8.5 us).
//
// What the design does.
//  - One CTA per (b * Hq + h, 64-row query tile): one consumer
//    warpgroup (warps 0-3) owns the 64 rows, one producer warp (warp 4)
//    issues every load. Query tiles are walked longest first (the last
//    tile of a causal row sees the most keys), so the causal tail does
//    not idle the card.
//  - TMA loads the Q tile once and streams K and V tiles of kBK = 64
//    keys through a ring of kStages = 2 stages; one mbarrier pair per
//    stage (full: the producer's expected bytes; empty: the 128 consumer
//    threads) guards it. Each operand is described by a 4-D tensor map
//    over its strided (B, H, S, D) view, dims {D, S, H, B}, so the
//    model's (B, S, H, D) projections are read in place. Tiles land with
//    the 128 B swizzle, one 128 B atom per 64 columns (D/64 of them).
//    Shared memory (Smem<D>::kAlloc): 42,024 B at D=64, 82,984 at 128,
//    123,944 at 192, 164,904 at 256 (one CTA an SM at 192 and 256).
//  - S = Q K^T: wgmma m64n64k16, Q and K both from shared memory
//    (K-major descriptors), D/16 k-steps. bf16 x bf16 products are exact
//    in float32, so this is the reference's float32 q.k up to the order
//    of the sum.
//  - The online softmax runs in registers, in the wgmma accumulator
//    layout: each row's 64 scores are spread over the 4 threads of a
//    quad, so a row max takes two shuffles; exp2f with scale * log2(e)
//    in one multiply. Masks are applied only on tiles that the
//    diagonal, the window's edge or the end of S crosses; tiles that
//    are fully masked are not loaded at all.
//  - O += P V: P rounded to bf16 in registers is wgmma's A operand (the
//    accumulator layout of S is the A-fragment layout of P), V the B
//    operand from shared memory in its MN-major (transposed) form: one
//    m64n128k16 per 128 columns of V and one m64n64k16 for the 64 left
//    over (D = 64, 192), each on its own slice of O. O stays in float32
//    registers (D/2 a consumer thread: 96 at D=192, 128 at D=256, beside
//    S's 32 and P's 16) and is rescaled by corr. Rounding P to bf16 is
//    the one departure from the reference's float32 P; the CPU test of
//    the rounding budget bounds it, and SDPA rounds P too. ptxas -v
//    reports each instantiation's registers and spills (chip_smoke.py
//    phase 1 prints them; PERF.md keeps them).
//  - The epilogue divides by max(l, 1e-30), rounds to bf16 and stores
//    the rows below S.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA: one consumer warpgroup
constexpr int kBK = 64;          // keys per kv tile
constexpr int kStages = 2;       // kv ring depth
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 1000;  // + CUresult of a failed tensor-map encode
constexpr int kNoEncoder = 2000;    // the CUDA driver has no cuTensorMapEncodeTiled

// Shared memory, from a 1024 B aligned base (the 128 B swizzle's
// period): each tile is D/64 column blocks of rows x 128 B.
template <int D>
struct Smem {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                // kStages K tiles
  static constexpr int kV = kK + kStages * kKVBytes;     // kStages V tiles
  static constexpr int kBar = kV + kStages * kKVBytes;   // full, empty, q
  static constexpr int kAlloc = kBar + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the 4-D tensor map at coordinates {d, s, h, b} into shared
// memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(s), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128 B swizzle; lbo and sbo in
// 16 B units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, smem,
// MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// O (64 x D, f32) += P (64 x 16, bf16 registers) V (16 x D) for one
// 16-key step, V's rows from `vaddr` (MN-major, 128 B swizzle: sbo steps 8
// rows of 128 B, lbo the next 64 columns, whose block lies kBK * 128 B on).
// One n128 wgmma per 128 columns, then one n64 for the rest, each on its
// slice of O's registers (columns 8j.. of O are acc[4j..4j+3]).
template <int D>
__device__ __forceinline__ void pv_step(float (&acc)[D / 2], const uint32_t (&pa)[4],
                                        uint32_t vaddr) {
  constexpr uint32_t kBlock = kBK * 128;  // bytes of one 64-column block
#pragma unroll
  for (int c = 0; c < D / 128; ++c)
    wgmma_rs<128>(*reinterpret_cast<float(*)[64]>(acc + 64 * c), pa,
                  desc_sw128(vaddr + 2 * c * kBlock, kBlock / 16, 64), 1);
  if constexpr (D % 128 != 0)
    wgmma_rs<64>(*reinterpret_cast<float(*)[32]>(acc + D / 2 - 32), pa,
                 desc_sw128(vaddr + (D / 128) * 2 * kBlock, 64, 64), 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int Hq, int group, int S,
               int n_qtiles, int BH, float scale_log2, int causal, int window) {
  using L = Smem<D>;
  constexpr int kCB = D / 64;  // 128 B column blocks per row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages,
                 qbar = empty + 8 * kStages;

  // longest query tiles first: blocks are started in index order
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qtiles - 1 - (int)blockIdx.x / BH) * kBQ;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  // kv tiles that some row of this query tile may see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int t_first = k_first / kBK;
  const int n_tiles = k_last / kBK - t_first + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp; one lane issues
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int c = 0; c < kCB; ++c)
        tma_load(sq + c * kBQ * 128, &tq, qbar, 64 * c, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * s, (i / kStages - 1) & 1);
        const int k0 = (t_first + i) * kBK;
        const uint32_t fb = full + 8 * s;
        mbar_expect_tx(fb, 2 * L::kKVBytes);
        for (int c = 0; c < kCB; ++c) {
          tma_load(sk + s * L::kKVBytes + c * kBK * 128, &tk, fb, 64 * c, k0, hk, b);
          tma_load(sv + s * L::kKVBytes + c * kBK * 128, &tv, fb, 64 * c, k0, hk, b);
        }
      }
    }
    return;
  }

  // Consumers. Accumulator layout (m64nN): thread t of the warpgroup
  // holds rows r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8; for each
  // group j of 8 columns, d[4j], d[4j+1] are (r0, 8j + cq + {0, 1}) and
  // d[4j+2], d[4j+3] are (r0 + 8, the same columns), cq = 2 * (t % 4).
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = (t_first + i) * kBK;
    mbar_wait(full + 8 * s, (i / kStages) & 1);

    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * (kBQ * 128) + (kk % 4) * 32;
      const uint32_t koff = s * L::kKVBytes + (kk / 4) * (kBK * 128) + (kk % 4) * 32;
      wgmma_ss_n64(sc, desc_sw128(sq + off, 1, 64), desc_sw128(sk + koff, 1, 64),
                   kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scores in log2 units; masked ones -1e30, only where a mask bites
    const bool masked = (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + kBQ - 1 - window) ||
                        k0 + kBK > S;
    if (masked) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qi = q0 + r0 + 8 * ((e / 2) % 2);
        const int kj = k0 + 8 * (e / 4) + cq + e % 2;
        const bool keep = kj < S && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
        sc[e] = keep ? sc[e] * scale_log2 : kNegInf;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
    }

    // online softmax: each row's max over its quad, then p = 2^(s - m)
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m[r], mx);
      corr[r] = exp2f(m[r] - m_cur);
      m[r] = m_cur;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[4 * j + 2 * r + c];
          x = (masked && x == kNegInf) ? 0.f : exp2f(x - m_cur);
          sum += x;
        }
      }
      l[r] = l[r] * corr[r] + sum;  // this thread's part of the row sum
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= corr[(e / 2) % 2];

    // P in bf16 as wgmma's A fragments, one per 16 keys
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);

    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // V rows 16kk.. of this stage
      pv_step<D>(acc, pa[kk], sv + s * L::kKVBytes + kk * 16 * 128);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }

  // epilogue: the row sums over the quad, O / max(l, 1e-30) in bf16
  __nv_bfloat16* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int qi = q0 + r0 + 8 * r;
    if (qi < S) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + (size_t)qi * D + 8 * j + cq) =
            pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, fetched once, so the library
// needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 4-D map {D, S, H, B} over a strided (B, H, S, D) bf16 view, boxes
// of 64 columns x `rows` rows, 128 B swizzle; out-of-bounds rows read 0.
int encode(CUtensorMap* map, const void* ptr, const long long* st, int B,
           int H, int S, int D, int rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Hq, int Hkv, int S, float scale,
           int causal, int window, cudaStream_t stream) {
  // once per instantiation, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::kAlloc);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, st, B, Hq, S, D, kBQ);
  if (!err) err = encode(&tk, k, st + 3, B, Hkv, S, D, kBK);
  if (!err) err = encode(&tv, v, st + 6, B, Hkv, S, D, kBK);
  if (err) return err;
  const int n_qtiles = (S + kBQ - 1) / kBQ;
  flash_fwd_sm90<D><<<B * Hq * n_qtiles, kThreads, Smem<D>::kAlloc, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hq / Hkv, S, n_qtiles,
      B * Hq, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`. q (B, Hq, S, D), k and v (B, Hkv, S, D), bf16,
// each read through `strides` (9 values: batch, head and sequence
// strides of q, k, v in elements; the last dim is contiguous; every
// base pointer 16 B aligned and every stride a multiple of 8 elements,
// as TMA needs); o is a contiguous (B, Hq, S, D) bf16. D is 64, 128, 192
// or 256.
// Scores are (q . k) * scale; window <= 0 means none. Returns 0, the
// cudaError_t of the launch, 1000 + the CUresult of a failed
// tensor-map encode, or 2000 if the CUDA driver has no tensor-map encoder.
int flash_fwd_sm90_launch(const void* q, const void* k, const void* v, void* o,
                          const long long* strides, int B, int Hq, int Hkv,
                          int S, int D, float scale, int causal, int window,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, strides, B, Hq, Hkv, S, scale, causal, window, s);
    case 128:
      return launch<128>(q, k, v, o, strides, B, Hq, Hkv, S, scale, causal, window, s);
    case 192:
      return launch<192>(q, k, v, o, strides, B, Hq, Hkv, S, scale, causal, window, s);
    case 256:
      return launch<256>(q, k, v, o, strides, B, Hq, Hkv, S, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a CTA of the D kernel takes, in bytes (0 for
// another D).
int flash_fwd_sm90_smem_bytes(int D) {
  switch (D) {
    case 64: return Smem<64>::kAlloc;
    case 128: return Smem<128>::kAlloc;
    case 192: return Smem<192>::kAlloc;
    case 256: return Smem<256>::kAlloc;
    default: return 0;
  }
}

}  // extern "C"
