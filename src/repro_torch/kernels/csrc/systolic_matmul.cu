// Blocked matrix product  C(M,N) = A(M,K) @ B(K,N)  for sm_90a.
//
// Replaces: the Pallas TPU kernel `_mm_kernel` / `matmul` of the JAX
// package (src/repro/kernels/systolic_matmul/kernel.py).  There the k axis
// is a sequential grid dimension and the fp32 accumulator lives in VMEM
// scratch between grid steps.  Thread blocks on the GPU run in no order
// and share nothing, so here one block owns one C tile and walks k in a
// loop with the accumulator in registers; C is written once.
//
// Bodies: fp32 inputs run the tensor-core body of systolic_matmul_sm90.cuh
// (3xTF32 on wgmma: each operand split into two TF32 words, three
// products, about 21 mantissa bits of each product, within the fp32 parity
// tolerance of 1e-4*max|ref| where one TF32 product is not); bf16 inputs
// run the FMA body in this file.  Both accumulate in fp32 and round once
// to the output type.
//
// FMA body (bf16).  Inputs are upcast to fp32 BEFORE the product and every
// product and sum is a true fp32 FMA; the yardstick is the fp32 FMA rate
// outside the tensor cores.
//
// Design: 128x128 C tile per block of 256 threads, k tile of 16, both
// operand tiles staged in shared memory as fp32 (A transposed, so both are
// read as conflict-free float4 along the tile's m / n axis).  Each thread
// holds an 8x8 register tile split into four 4x4 quadrants 64 apart, which
// keeps the float4 shared-memory reads of a quarter-warp on distinct
// banks.  The next k tile is fetched into registers while the current one
// is multiplied.  M, N and K need not be multiples of anything: loads
// outside the matrices read as zero and stores are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "systolic_matmul_sm90.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 16, NT = 256;
constexpr int LDS = BM + 4;          // padded row, keeps float4 alignment
constexpr int A_PER_T = BM * BK / NT;  // 8 elements of the A tile per thread
constexpr int B_PER_T = BK * BN / NT;  // 8 elements of the B tile per thread

using TIn = __nv_bfloat16;

__device__ __forceinline__ void from_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

template <typename TOut>
__global__ void __launch_bounds__(NT)
mm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
          TOut* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][LDS];  // As[k][m]
  __shared__ __align__(16) float Bs[BK][LDS];  // Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // global -> register staging; A: 16 consecutive k of one row per
  // half-warp, B: 128 consecutive n of one k row per four warps.
  const int a_k = tid % BK, a_m = tid / BK;    // + 16 * i
  const int b_n = tid % BN, b_k = tid / BN;    // + 2 * i
  // staged in the input type: a bf16 value is widened only when it is
  // written to shared memory, so nothing waits on these loads before the
  // FMAs of the current tile have been issued
  TIn ra[A_PER_T], rb[B_PER_T];
  const TIn zero = __float2bfloat16_rn(0.f);

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) {
      const int m = m0 + a_m + 16 * i, k = k0 + a_k;
      ra[i] = (m < M && k < K) ? A[(size_t)m * K + k] : zero;
    }
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) {
      const int k = k0 + b_k + 2 * i, n = n0 + b_n;
      rb[i] = (k < K && n < N) ? B[(size_t)k * N + n] : zero;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_T; ++i) As[a_k][a_m + 16 * i] = __bfloat162float(ra[i]);
#pragma unroll
    for (int i = 0; i < B_PER_T; ++i) Bs[b_k + 2 * i][b_n] = __bfloat162float(rb[i]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();               // previous tile fully consumed
    stage();
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);   // overlaps with the FMAs below
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 4 + (i % 4) + 64 * (i / 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 4 + (j % 4) + 64 * (j / 4);
      if (n < N) from_f32(acc[i][j], &C[(size_t)m * N + n]);
    }
  }
}

template <typename TOut>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<TOut><<<grid, NT, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that `systolic_matmul` needs: 2 (M + N) Kp for fp32
// inputs (the split operands, Kp = K rounded up to 16), none for bf16.
extern "C" long long systolic_matmul_scratch(int M, int N, int K,
                                             int in_bf16) {
  return in_bf16 ? 0 : mm90::scratch_floats(M, N, K);
}

// Launches on `stream`, does not synchronise, allocates nothing: fp32
// inputs need `scratch` of systolic_matmul_scratch() floats, 16-byte
// aligned (the split pre-pass writes it, TMA reads it); bf16 inputs ignore
// it.
// in_bf16 / out_bf16: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// (or the error of the tensor-map encoding or of the shared-memory opt-in).
extern "C" int systolic_matmul(const void* a, const void* b, void* c, int M,
                               int N, int K, int in_bf16, int out_bf16,
                               void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (in_bf16) {
    return out_bf16 ? launch<__nv_bfloat16>(a, b, c, M, N, K, s)
                    : launch<float>(a, b, c, M, N, K, s);
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const float *fa = static_cast<const float*>(a),
              *fb = static_cast<const float*>(b);
  float* w = static_cast<float*>(scratch);
  return out_bf16 ? mm90::launch(fa, fb, static_cast<__nv_bfloat16*>(c), w, M,
                                 N, K, s)
                  : mm90::launch(fa, fb, static_cast<float*>(c), w, M, N, K, s);
}
