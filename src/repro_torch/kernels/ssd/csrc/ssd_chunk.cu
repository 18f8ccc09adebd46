// ssd_chunk: the Mamba-2 SSD intra-chunk pass on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py, function
// _ssd_chunk_kernel (called through ssd_intra_chunk), and computes what
// it computes, all in float32, for each (batch b, chunk c, head h) with
// chunk length CL, state N and head dim P:
//   a    = dt * A[h]                          (CL,)   log-decay steps
//   cum  = inclusive cumsum(a)                (CL,)
//   seg  = sum of a_k over k = j+1..i         (CL, CL) for i >= j
//   L    = exp(seg) for i >= j, else 0                  (CL, CL)
//   y    = ((C B^T) o L) (x * dt)             (CL, P)  intra-chunk output
//   st   = (B * exp(sum of a_k, k = j+1..CL-1))^T (x dt)  (N, P) chunk state
//   dec  = exp(cum)                           (CL,)   decay from chunk start
// The inter-chunk scan over chunks stays in PyTorch (kernels/ssd/ops.py).
//
// What bounds it on this card. At the serving shape (B=4, S=512, H=50,
// P=64, N=16, CL=128) the function reads x (26 MB) and writes y (26 MB)
// plus the states (3.3 MB); B and C are shared by all heads and are
// small. That is about 17 us at 3.35 TB/s. Its float32 work (the
// lower-triangular C B^T and (C B^T o L)(x dt), the states and the
// exps, about 1.3 GFLOP) is about 19 us at the 67 TFLOP/s float32 peak,
// so the two bounds are close. This first kernel runs its products on
// the CUDA cores with both operands in shared memory, so shared-memory
// bandwidth (two loads per multiply-add in the CL x CL x P product) sets
// its time.
//
// What the design does. One block per (b, c, h); there is nothing to
// carry between blocks. The block stages x * dt (CL x P), B and C
// (CL x N) and the cumulative decays in shared memory, then computes the
// masked score rows in passes of 64 rows (64 x CL floats, 32 KB at
// CL=128), so the whole block fits in about 84 KB of dynamic shared
// memory and two blocks share an SM. Only i >= j scores are computed,
// and the y product runs over j <= i only. L and the decays to the
// chunk's end come from segment sums, never from cum_i - cum_j, whose
// two sums reach -1900 within a chunk on the model's dt and A and
// cancel (kernels/ssd/ref.py::segsum): before each pass of score rows
// one thread a column j carries seg[i][j] down the rows, adding a_i
// from i = j + 1 (the plain version's order), and one thread sums cum
// and the decays to the end sequentially, the latter from the end. B and C are read through their strides, so the model's
// B and C, shared by all heads, come in as a stride-0 view and are never
// copied per head.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // score rows per pass

struct Strides {  // in elements: batch, sequence, head (last dim is 1)
  long long x[3], dt[3], b[3], c[3];
};

__host__ __device__ inline int rows_per_pass(int CL) {
  return CL < kRows ? CL : kRows;
}

__host__ __device__ inline int smem_floats(int CL, int N, int P) {
  // a, cum, wend, the columns' running seg (CL each); x*dt (CL x P);
  // B (CL x (N+1)); C (CL x N); score rows (rows_per_pass x CL)
  return 4 * CL + CL * P + CL * (N + 1) + CL * N + rows_per_pass(CL) * CL;
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ a, const float* __restrict__ bm,
          const float* __restrict__ cm, float* __restrict__ y,
          float* __restrict__ st, float* __restrict__ dec, Strides sd,
          int S, int H, int P, int N, int CL) {
  extern __shared__ float smem[];
  const int BP = N + 1;
  const int RB = rows_per_pass(CL);
  float* av = smem;              // CL: a = dt * A
  float* cum = av + CL;          // CL
  float* wend = cum + CL;        // CL: dt, then exp(sum a_k, k = j+1..CL-1)
  float* srun = wend + CL;       // CL: column j's seg at the last row seen
  float* sx = srun + CL;         // CL x P: x * dt
  float* sb = sx + CL * P;       // CL x BP
  float* sc = sb + CL * BP;      // CL x N
  float* ss = sc + CL * N;       // RB x CL

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CL;
  const int nc = gridDim.y;
  const int tid = threadIdx.x;
  const float* xb = x + b * sd.x[0] + h * sd.x[2];
  const float* dtb = dt + b * sd.dt[0] + h * sd.dt[2];
  const float* bb = bm + b * sd.b[0] + h * sd.b[2];
  const float* cb = cm + b * sd.c[0] + h * sd.c[2];

  const float ah = a[h];
  for (int i = tid; i < CL; i += kThreads) {
    const float d = dtb[(t0 + i) * sd.dt[1]];
    wend[i] = d;
    av[i] = __fmul_rn(d, ah);
    srun[i] = 0.f;
  }
  __syncthreads();
  for (int e = tid; e < CL * P; e += kThreads) {
    const int i = e / P, p = e % P;
    sx[e] = xb[(t0 + i) * sd.x[1] + p] * wend[i];
  }
  for (int e = tid; e < CL * N; e += kThreads) {
    const int i = e / N, n = e % N;
    sb[i * BP + n] = bb[(t0 + i) * sd.b[1] + n];
    sc[e] = cb[(t0 + i) * sd.c[1] + n];
  }
  __syncthreads();  // x * dt has read wend's dt
  if (tid == 0) {
    float run = 0.f, rev = 0.f;
    for (int i = 0; i < CL; ++i) {
      run = __fadd_rn(run, av[i]);
      cum[i] = run;
      const int j = CL - 1 - i;
      wend[j] = rev;
      rev = __fadd_rn(rev, av[j]);
    }
  }
  __syncthreads();

  float* decb = dec + ((long long)b * S + t0) * H + h;
  for (int i = tid; i < CL; i += kThreads) {
    decb[(long long)i * H] = expf(cum[i]);
    wend[i] = expf(wend[i]);
  }

  float* yb = y + (((long long)b * S + t0) * H + h) * P;
  for (int r0 = 0; r0 < CL; r0 += RB) {
    const int rows = min(RB, CL - r0);
    __syncthreads();  // the previous pass's rows are no longer read
    // seg of this pass's rows: column j carries its sum down the rows
    for (int j = tid; j < CL; j += kThreads) {
      float run = srun[j];
      for (int ir = 0; ir < rows; ++ir) {
        const int i = r0 + ir;
        if (i > j) run = __fadd_rn(run, av[i]);
        ss[ir * CL + j] = run;
      }
      srun[j] = run;
    }
    __syncthreads();
    for (int e = tid; e < rows * CL; e += kThreads) {
      const int i = r0 + e / CL, j = e % CL;
      float v = 0.f;
      if (j <= i) {
        const float* cr = sc + i * N;
        const float* br = sb + j * BP;
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot += cr[n] * br[n];
        v = dot * expf(ss[e]);
      }
      ss[e] = v;
    }
    __syncthreads();
    for (int e = tid; e < rows * P; e += kThreads) {
      const int ir = e / P, p = e % P, i = r0 + ir;
      const float* sr = ss + ir * CL;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += sr[j] * sx[j * P + p];
      yb[(long long)i * H * P + p] = acc;
    }
  }

  // chunk state: sum_j exp(cum_last - cum_j) B_j (x_j dt_j)^T
  float* stb = st + ((((long long)b * nc + c) * H + h) * N) * P;
  for (int e = tid; e < N * P; e += kThreads) {
    const int n = e / P, p = e % P;
    float acc = 0.f;
    for (int j = 0; j < CL; ++j) acc += sb[j * BP + n] * wend[j] * sx[j * P + p];
    stb[e] = acc;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block uses at chunk CL, state N, head dim P.
int ssd_chunk_smem_bytes(int CL, int N, int P) {
  return smem_floats(CL, N, P) * (int)sizeof(float);
}

// Launch on `stream`. x (B, S, H, P), dt (B, S, H), B and C (B, S, H, N)
// are float32 read through `strides` (12 values: batch, sequence and
// head strides of x, dt, B, C in elements; the last dim is contiguous,
// a head stride may be 0); a (H,) is contiguous. Outputs are contiguous
// float32: y (B, S, H, P), st (B, S/CL, H, N, P), dec (B, S, H). S must
// be a multiple of CL. Returns the cudaError_t of the launch.
int ssd_chunk_launch(const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, void* y, void* st,
                     void* dec, const long long* strides, int B, int S,
                     int H, int P, int N, int CL, void* stream) {
  Strides sd;
  for (int i = 0; i < 3; ++i) {
    sd.x[i] = strides[i];
    sd.dt[i] = strides[3 + i];
    sd.b[i] = strides[6 + i];
    sd.c[i] = strides[9 + i];
  }
  const int bytes = ssd_chunk_smem_bytes(CL, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, S / CL, B);
  ssd_chunk<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(dec), sd, S, H, P, N, CL);
  return (int)cudaGetLastError();
}

}  // extern "C"
