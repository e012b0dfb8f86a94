// Tensor-core body of the blocked matrix product for fp32 A and B (sm_90a):
// 3xTF32 on wgmma.
//
// Replaces: the Pallas TPU kernel `_mm_kernel` / `matmul` of the JAX
// package (src/repro/kernels/systolic_matmul/kernel.py), for fp32 inputs;
// systolic_matmul.cu dispatches fp32 here and keeps its FMA body for bf16.
//
// Bound: operations.  M=N=K=4096 is 137 GFLOP of fp32 products; as three
// TF32 products it is 412 GFLOP at the card's dense TF32 rate (495
// TFLOP/s), against 201 MB of compulsory traffic (and 403 MB more for the
// split operands below).
//
// Precision.  One TF32 product keeps 10 mantissa bits of each operand,
// which the fp32 gate (1e-4 max|ref|) does not survive at long K.  Each
// operand is split x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (both
// rounded to nearest by cvt.rna: the tensor core would truncate the low 13
// bits), and A.B = A_hi.B_hi + A_hi.B_lo + A_lo.B_hi (+ A_lo.B_lo, below
// 2^-22 of each term, dropped): about 21 mantissa bits of each product.
// The tensor core's fp32 accumulation is biased towards zero (a relative
// error growing linearly with K), so the wgmma accumulator holds only
// PROMOTE k slabs (K = 128) and is then added to an fp32 sum in registers
// with ordinary round-to-nearest adds, as fp8 GEMMs do.  chip_smoke.py
// prints, beside every fp32 row, the error and its signed bias, and what
// one TF32 product and what two would give.
//
// Design.  A pre-pass (`split_rows`, `split_cols_t`) reads A (M,K) and
// B (K,N) once and writes A_hi, A_lo (M,Kp) and, transposed, B^T_hi,
// B^T_lo (N,Kp) into scratch the caller allocates, Kp = K rounded up to
// the k slab with zeros: TF32 wgmma takes both operands K-major only, and
// the padding ends every question of alignment and raggedness (any M, N,
// K and any contiguous view run).  The product: one block owns a 128x128 C
// tile; two consumer warpgroups own 64 rows each, one producer warp streams
// 16-wide k slabs (64-byte rows, 64B swizzle) of the four operands through
// a six-stage ring with TMA (rows past M or N read as zero), one `full`
// and one `empty` mbarrier a stage.  Per slab and warpgroup: six
// m64n128k8 wgmma (lo.hi, hi.lo, then hi.hi, twice) into the partial
// accumulator, committed as one group; the stage is released when the next
// slab's group has been issued and this one has completed (or when the
// partial sum is added).  A 128x256 tile would leave no registers for the
// second accumulator.  C is cast once to the output type; stores past M, N
// are masked.
#pragma once
#include "sm90.cuh"

namespace {
namespace mm90 {

using namespace sm90;

constexpr int NWG = 2;                 // consumer warpgroups
constexpr int BM = 64 * NWG, BN = 128, BK = 16;
constexpr int NT = 128 * (NWG + 1);    // + one producer warpgroup
// 2 consumer warpgroups at 232 registers + the producer at 40 = 64,512 of
// the SM's 65,536
constexpr int CREGS = 232, PREGS = 40;
constexpr uint32_t A_BYTES = BM * BK * 4, B_BYTES = BN * BK * 4;
constexpr uint32_t STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
constexpr int ST = 6;                  // 6 x 32 KB
constexpr int PROMOTE = 8;             // k slabs a partial sum holds
constexpr size_t SMEM_BYTES = 1024 + ST * (size_t)STAGE_BYTES + 8 * 2 * ST;

// K rounded up to the k slab
__host__ __device__ constexpr int padded_k(int K) {
  return (K + BK - 1) / BK * BK;
}

struct Maps {
  CUtensorMap a_hi, a_lo, b_hi, b_lo;
};

// A (M,K) -> hi, lo (M,Kp), zeros in columns [K, Kp); blocks stride over
// the rows (y) and the columns (x)
__global__ void split_rows(const float* __restrict__ A, float* __restrict__ hi,
                           float* __restrict__ lo, int M, int K, int Kp) {
  for (int m = blockIdx.y; m < M; m += gridDim.y)
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < Kp;
         k += gridDim.x * blockDim.x)
      split_tf32(k < K ? A[(size_t)m * K + k] : 0.f, hi, lo,
                 (size_t)m * Kp + k);
}

// B (K,N) -> B^T hi, lo (N,Kp), zeros in columns [K, Kp); 32x32 tiles
// through shared memory so that both the reads and the writes coalesce
__global__ void split_cols_t(const float* __restrict__ B,
                             float* __restrict__ hi, float* __restrict__ lo,
                             int K, int N, int Kp) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;    // 32 x 8
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int k = k0 + ty + j, n = n0 + tx;
    t[ty + j][tx] = (k < K && n < N) ? B[(size_t)k * N + n] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int n = n0 + ty + j, k = k0 + tx;
    if (n < N && k < Kp)
      split_tf32(t[tx][ty + j], hi, lo, (size_t)n * Kp + k);
  }
}

template <typename TOut>
__device__ __forceinline__ void store(TOut* p, float x) {
  if constexpr (sizeof(TOut) == 4)
    *p = x;
  else
    *p = __float2bfloat16_rn(x);
}

template <typename TOut>
__global__ void __launch_bounds__(NT, 1)
mm_kernel(__grid_constant__ const Maps maps, TOut* __restrict__ C, int M,
          int N, int Kp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // stage st: A_hi, A_lo, B_hi, B_lo at sS + st STAGE_BYTES
  const uint32_t sS = (raw + 1023) & ~1023u;
  const uint32_t full = sS + ST * STAGE_BYTES;     // full[st] = full + 8 st
  const uint32_t empty = full + 8 * ST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = Kp / BK;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup() == NWG) {
    // ------------------------------------ producer (its first warp works)
    regs_dealloc<PREGS>();
    if (warp != 4 * NWG || lane != 0) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % ST, k0 = kt * BK;
      if (kt >= ST) mbar_wait(empty + 8 * st, ((kt / ST) - 1) & 1);
      const uint32_t base = sS + st * STAGE_BYTES, bar = full + 8 * st;
      mbar_arrive_expect_tx(bar, STAGE_BYTES);
      tma_load_2d(base, &maps.a_hi, bar, k0, m0);
      tma_load_2d(base + A_BYTES, &maps.a_lo, bar, k0, m0);
      tma_load_2d(base + 2 * A_BYTES, &maps.b_hi, bar, k0, n0);
      tma_load_2d(base + 2 * A_BYTES + B_BYTES, &maps.b_lo, bar, k0, n0);
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  regs_alloc<CREGS>();
  const int wg = warp / 4, wq = warp % 4;
  // part: the wgmma accumulator of PROMOTE slabs; acc: their fp32 sum
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // a 16-wide fp32 slab is a 64-byte row: the descriptors' width 32
  constexpr int W = BK * 2;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % ST;
    mbar_wait(full + 8 * st, (kt / ST) & 1);
    const uint32_t a_hi = sS + st * STAGE_BYTES + 64 * wg * BK * 4;
    const uint32_t a_lo = a_hi + A_BYTES;
    const uint32_t b_hi = sS + st * STAGE_BYTES + 2 * A_BYTES;
    const uint32_t b_lo = b_hi + B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 8; ++k) {         // k8 steps of 32 bytes
      const uint64_t ah = desc_kmajor(a_hi + 32 * k, W);
      const uint64_t bh = desc_kmajor(b_hi + 32 * k, W);
      // the first product of a partial sum overwrites it
      mma_tf32_n128(part, desc_kmajor(a_lo + 32 * k, W), bh,
                    k != 0 || kt % PROMOTE != 0);
      mma_tf32_n128(part, ah, desc_kmajor(b_lo + 32 * k, W), 1);
      mma_tf32_n128(part, ah, bh, 1);
    }
    wgmma_commit();
    if (kt % PROMOTE == PROMOTE - 1 || kt == nk - 1) {
      wgmma_wait<0>();
      fence_regs<BN / 2>(part);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    } else {
      // this slab's group may run on; the previous one has completed
      wgmma_wait<1>();
    }
    if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % ST));
  }

  // ---- epilogue: d[4i + e] at row 16 wq + l/4 + 8 (e/2), column
  // 8 i + 2 (l % 4) + (e % 2) of the warpgroup's 64 x 128 tile
  const int r0 = m0 + 64 * wg + 16 * wq + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    if (m >= M) continue;
    TOut* row = C + (size_t)m * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = c0 + 8 * i + e;
        if (n < N) store(row + n, acc[4 * i + 2 * h + e]);
      }
  }
}

// Floats of scratch that `launch` needs for (M, N, K).
inline long long scratch_floats(int M, int N, int K) {
  return 2LL * ((long long)M + N) * padded_k(K);
}

template <typename TOut>
int launch(const float* a, const float* b, TOut* c, float* scratch, int M,
           int N, int K, cudaStream_t stream) {
  const int Kp = padded_k(K);
  float* a_hi = scratch;
  float* a_lo = a_hi + (size_t)M * Kp;
  float* b_hi = a_lo + (size_t)M * Kp;
  float* b_lo = b_hi + (size_t)N * Kp;
  split_rows<<<dim3((Kp + 255) / 256, M < 16384 ? M : 16384), 256, 0,
               stream>>>(a, a_hi, a_lo, M, K, Kp);
  split_cols_t<<<dim3((Kp + 31) / 32, (N + 31) / 32), dim3(32, 8), 0,
                 stream>>>(b, b_hi, b_lo, K, N, Kp);
  Maps maps;
  int e = make_map_f32(&maps.a_hi, a_hi, Kp, M, BK, BM);
  if (!e) e = make_map_f32(&maps.a_lo, a_lo, Kp, M, BK, BM);
  if (!e) e = make_map_f32(&maps.b_hi, b_hi, Kp, N, BK, BN);
  if (!e) e = make_map_f32(&maps.b_lo, b_lo, Kp, N, BK, BN);
  if (e) return e;
  static bool opted[64] = {};
  if (int e2 = smem_opt_in((const void*)mm_kernel<TOut>, SMEM_BYTES, opted))
    return e2;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<TOut><<<grid, NT, SMEM_BYTES, stream>>>(maps, c, M, N, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mm90
}  // namespace
