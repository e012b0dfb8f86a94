// Flash-attention backward for sm_90a: the dk/dv kernel and the dq kernel.
//
// Replaces: the Pallas TPU kernels `_dkdv_kernel` / `flash_dkdv` and
// `_dq_kernel` / `flash_dq` of the JAX package
// (src/repro/kernels/flash_attention/kernel.py).  Both recompute the
// probabilities from the forward's log-sum-exp instead of storing them:
//     s  = (q . k) * scale,  p = exp(where(mask, s, NEG) - lse), p = where(mask, p, 0)
//     dp = do . v,           ds = p * (dp - delta) * scale
//     dv += p^T . do,  dk += ds^T . q        (dk/dv kernel)
//     dq += ds . k                           (dq kernel)
// with delta = sum(do * out) over the head dim, computed outside the kernels.
//
// Translation of the grid.  On the TPU the minor grid axis runs in order
// and the output block stays in VMEM while it sweeps; here that axis is a
// loop inside one thread block and the accumulator stays in registers:
//   * dq: one block owns (batch, head, 64-row q tile) and walks the live kv
//     tiles (grid axis j of `_dq_kernel`);
//   * dk/dv: one block owns (batch, kv head, 64-row kv tile) and walks the
//     G query heads of that kv head times every live q tile.  The reference
//     zero-initialises dk/dv only at (h % G == 0, i == 0) and relies on the
//     TPU's sequential grid to sum the G heads into one output block; blocks
//     run concurrently on the GPU, so the head sum lives inside one block.
//     No atomics: the result does not depend on scheduling.
//
// Bodies: bf16 inputs run the tensor-core bodies of flash_dkdv_sm90.cuh
// and flash_dq_sm90.cuh (wgmma on TMA-fed rings; p and ds, or ds alone,
// carried as bf16 hi + lo pairs); fp32 inputs run the FMA bodies in this
// file, all maths in fp32 FMAs.
//
// Semantics kept from the reference bodies: layout q/do (B,H,Sq,D),
// k/v (B,KH,Skv,D), kv head = h / (H/KH) by index; outputs fp32;
// NEG = -1e30 is finite, so p is zeroed by the mask and not by underflow;
// tiles with no unmasked element are skipped (`_tile_live`: causal upper
// bound, window lower bound); positions outside Sq / Skv are masked.  The kernels use
// their own 64x64 tile whatever bq/bk the caller's burst model uses, which
// changes the result only by fp32 rounding.
//
// Bound: operations.  Causal attention at B=2, H=32, S=2048, D=64 needs
// 8*D FLOPs per live (q, k) pair and head in dk/dv (68.7 GFLOP) and 6*D in
// dq (51.5 GFLOP) against about 100 MB of compulsory traffic in bf16.  With
// true-fp32 products the yardstick of the FMA bodies (fp32 inputs) is the
// fp32 FMA rate; that of the bf16 bodies the bf16 tensor-core rate.
//
// FMA design: 256 threads as a 16x16 grid, each owning a 4x4 patch of the
// 64x64 score tile (rows ty*4+i, columns tx*4+j) and, in the accumulation,
// the same 4 rows times D/16 columns strided by 16 — the layout of
// flash_fwd.cu.  Operands of the score products are held transposed in
// shared memory (float4 reads along the row / column axis), operands of the
// accumulations row-major.  The dk/dv kernel computes the score tile
// transposed (kv rows, q columns), so that p^T and ds^T are its own rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_dkdv_sm90.cuh"
#include "flash_dq_sm90.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, NT = 256;
constexpr int LDT = 64 + 4;            // padded row of a transposed tile
constexpr float NEG = -1.0e30f;

// Rows [r0, r0+64) of a (S, D) matrix into shared memory: once transposed
// (t[d*LDT + r]) and, if `rm` is given, once row-major (rm[r*(D+4) + d]).
// Rows outside S read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* t, float* rm,
                                          const float* __restrict__ src,
                                          int r0, int S, int tid) {
  for (int idx = tid; idx < 64 * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const float x = (r0 + r < S) ? src[(size_t)(r0 + r) * D + d] : 0.f;
    t[d * LDT + r] = x;
    if (rm) rm[r * (D + 4) + d] = x;
  }
}

// s[i][j] = sum_d A[d][ty*4+i] * B[d][tx*4+j] over two transposed tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* At, const float* Bt,
                                         int ty, int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a4 = *reinterpret_cast<const float4*>(&At[d * LDT + ty * 4]);
    const float4 b4 = *reinterpret_cast<const float4*>(&Bt[d * LDT + tx * 4]);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][j] += sum_c P[ty*4+i][c] * M[c][tx + 16 j], P (64 x LDT) and
// M (64 x D+4) row-major in shared memory
template <int D>
__device__ __forceinline__ void tile_acc(const float* P, const float* M,
                                         int ty, int tx,
                                         float acc[4][D / 16]) {
  constexpr int DT = D / 16, LDR = D + 4;
#pragma unroll 2
  for (int c = 0; c < 64; c += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(&P[(ty * 4 + i) * LDT + c]);
      p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float m[DT];
#pragma unroll
      for (int j = 0; j < DT; ++j) m[j] = M[(c + cc) * LDR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[i][j] = fmaf(p[i][cc], m[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ bool tile_live(int q0, int k0, int causal,
                                          int window) {
  bool live = true;
  if (causal) live = live && (k0 <= q0 + BQ - 1);
  if (window) live = live && (k0 + BKV - 1 > q0 - window);
  return live;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Skv,
                                        int causal, int window) {
  bool o = qpos < Sq && kpos < Skv;
  if (causal) o = o && (kpos <= qpos);
  if (window) o = o && (kpos > qpos - window);
  return o;
}

template <int D>
constexpr size_t dq_smem() {
  // Qt, dOt, Kt, Vt [D][LDT] + Ks [BKV][D+4] + dS [BQ][LDT]
  return sizeof(float) * (4 * D * LDT + BKV * (D + 4) + BQ * LDT);
}

template <int D>
constexpr size_t dkdv_smem() {
  // Kt, Vt, Qt, dOt [D][LDT] + Qs, dOs [BQ][D+4] + P [BKV][LDT] + lse, delta
  return sizeof(float) * (4 * D * LDT + 2 * BQ * (D + 4) + BKV * LDT + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ Q, const float* __restrict__ Kg,
          const float* __restrict__ Vg, const float* __restrict__ dO,
          const float* __restrict__ LSE, const float* __restrict__ DELTA,
          float* __restrict__ dQ, int H, int KH, int Sq, int Skv, int causal,
          int window, float scale) {
  constexpr int DT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                    // [D][LDT]
  float* dOt = Qt + D * LDT;           // [D][LDT]
  float* Kt = dOt + D * LDT;           // [D][LDT]
  float* Vt = Kt + D * LDT;            // [D][LDT]
  float* Ks = Vt + D * LDT;            // [BKV][D+4]
  float* dS = Ks + BKV * (D + 4);      // [BQ][LDT]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qi = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qi * BQ;
  const size_t bh = (size_t)b * H + h;

  const float* Kb = Kg + ((size_t)b * KH + kvh) * Skv * D;
  const float* Vb = Vg + ((size_t)b * KH + kvh) * Skv * D;
  load_tile<D>(Qt, nullptr, Q + bh * Sq * D, q0, Sq, tid);
  load_tile<D>(dOt, nullptr, dO + bh * Sq * D, q0, Sq, tid);

  float lse[4], delta[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse[i] = row < Sq ? LSE[bh * Sq + row] : 0.f;   // rows past Sq: unwritten
    delta[i] = row < Sq ? DELTA[bh * Sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }

  const int nkv = (Skv + BKV - 1) / BKV;
  for (int kj = 0; kj < nkv; ++kj) {
    const int k0 = kj * BKV;
    if (!tile_live(q0, k0, causal, window)) continue;   // uniform per block
    __syncthreads();                   // previous tile's K, V, dS consumed
    load_tile<D>(Kt, Ks, Kb, k0, Skv, tid);
    load_tile<D>(Vt, nullptr, Vb, k0, Skv, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(Qt, Kt, ty, tx, s);
    tile_dot<D>(dOt, Vt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qpos, k0 + tx * 4 + j, Sq, Skv, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse[i]) : 0.f;
        ds[j] = p * (dp[i][j] - delta[i]) * scale;
      }
      *reinterpret_cast<float4*>(&dS[(ty * 4 + i) * LDT + tx * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    tile_acc<D>(dS, Ks, ty, tx, acc);  // dq += ds . k
  }

  float* dQb = dQ + bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) dQb[(size_t)row * D + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const float* __restrict__ Q, const float* __restrict__ Kg,
            const float* __restrict__ Vg, const float* __restrict__ dO,
            const float* __restrict__ LSE, const float* __restrict__ DELTA,
            float* __restrict__ dK, float* __restrict__ dV, int H, int KH,
            int Sq, int Skv, int causal, int window, float scale) {
  constexpr int DT = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                    // [D][LDT]   Kt[d][kv row]
  float* Vt = Kt + D * LDT;            // [D][LDT]
  float* Qt = Vt + D * LDT;            // [D][LDT]   Qt[d][q row]
  float* dOt = Qt + D * LDT;           // [D][LDT]
  float* Qs = dOt + D * LDT;           // [BQ][D+4]  Qs[q row][d]
  float* dOs = Qs + BQ * (D + 4);      // [BQ][D+4]
  float* P = dOs + BQ * (D + 4);       // [BKV][LDT] p^T, then ds^T
  float* Ls = P + BKV * LDT;           // [BQ]
  float* Ds = Ls + BQ;                 // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int kj = blockIdx.x;           // under a causal mask early kv tiles
  const int kvh = blockIdx.y, b = blockIdx.z;   // see the most q tiles
  const int G = H / KH;
  const int k0 = kj * BKV;
  const size_t bkv = (size_t)b * KH + kvh;

  load_tile<D>(Kt, nullptr, Kg + bkv * Skv * D, k0, Skv, tid);
  load_tile<D>(Vt, nullptr, Vg + bkv * Skv * D, k0, Skv, tid);

  float dk[4][DT], dv[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nq = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * H + kvh * G + g;
    const float* Qb = Q + bh * Sq * D;
    const float* dOb = dO + bh * Sq * D;
    for (int qi = 0; qi < nq; ++qi) {
      const int q0 = qi * BQ;
      if (!tile_live(q0, k0, causal, window)) continue;  // uniform per block
      __syncthreads();                 // previous tile's operands consumed
      load_tile<D>(Qt, Qs, Qb, q0, Sq, tid);
      load_tile<D>(dOt, dOs, dOb, q0, Sq, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        Ls[tid] = in ? LSE[bh * Sq + q0 + tid] : 0.f;
        Ds[tid] = in ? DELTA[bh * Sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      // transposed tile: rows are kv positions, columns q positions
      float s[4][4], dp[4][4];
      tile_dot<D>(Kt, Qt, ty, tx, s);
      tile_dot<D>(Vt, dOt, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx * 4 + j;
          const bool ok = visible(q0 + c, kpos, Sq, Skv, causal, window);
          s[i][j] = ok ? expf(s[i][j] * scale - Ls[c]) : 0.f;        // p
          dp[i][j] = s[i][j] * (dp[i][j] - Ds[c]) * scale;            // ds
        }
        *reinterpret_cast<float4*>(&P[(ty * 4 + i) * LDT + tx * 4]) =
            make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      }
      __syncthreads();
      tile_acc<D>(P, dOs, ty, tx, dv);    // dv += p^T . do
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&P[(ty * 4 + i) * LDT + tx * 4]) =
            make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      __syncthreads();
      tile_acc<D>(P, Qs, ty, tx, dk);     // dk += ds^T . q
    }
  }

  float* dKb = dK + bkv * Skv * D;
  float* dVb = dV + bkv * Skv * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Skv) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      dKb[(size_t)row * D + tx + 16 * j] = dk[i][j];
      dVb[(size_t)row * D + tx + 16 * j] = dv[i][j];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float *o1, *o2;                      // dq, or dk and dv
  int B, H, KH, Sq, Skv, causal, window;
  float scale;
  cudaStream_t stream;
};

// Both kernels need more than 48 KB of shared memory at D = 64 and above,
// so the opt-in is made before every launch.
template <int D, bool DKDV>
int launch(const Args& a) {
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *dout = static_cast<const float*>(a.dout);
  if constexpr (DKDV) {
    constexpr size_t smem = dkdv_smem<D>();
    auto kern = dkdv_kernel<D>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((a.Skv + BKV - 1) / BKV, a.KH, a.B);
    kern<<<grid, NT, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, a.o1,
                                       a.o2, a.H, a.KH, a.Sq, a.Skv, a.causal,
                                       a.window, a.scale);
  } else {
    constexpr size_t smem = dq_smem<D>();
    auto kern = dq_kernel<D>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    kern<<<grid, NT, smem, a.stream>>>(q, k, v, dout, a.lse, a.delta, a.o1,
                                       a.H, a.KH, a.Sq, a.Skv, a.causal,
                                       a.window, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool DKDV>
int dispatch(int D, int is_bf16, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.KH <= 0 || a.H % a.KH || a.Sq <= 0 ||
      a.Skv <= 0 || a.H > 65535 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
#define FB_CASE(DD)                                                        \
  case DD:                                                                 \
    if constexpr (DKDV)                                                    \
      return is_bf16 ? dkdv90::launch<DD>(a.q, a.k, a.v, a.dout, a.lse,     \
                                          a.delta, a.o1, a.o2, a.B, a.H,    \
                                          a.KH, a.Sq, a.Skv, a.causal,      \
                                          a.window, a.scale, a.stream)      \
                     : launch<DD, true>(a);                                 \
    else                                                                   \
      return is_bf16 ? dq90::launch<DD>(a.q, a.k, a.v, a.dout, a.lse,     \
                                        a.delta, a.o1, a.B, a.H, a.KH,      \
                                        a.Sq, a.Skv, a.causal, a.window,    \
                                        a.scale, a.stream)                  \
                     : launch<DD, false>(a);
  switch (D) {
    FB_CASE(16)
    FB_CASE(32)
    FB_CASE(64)
    FB_CASE(80)
    FB_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FB_CASE
}

}  // namespace

// Both launch on `stream`, do not synchronise and allocate nothing.
// q/dout (B,H,Sq,D) and k/v (B,KH,Skv,D) of one type (is_bf16 selects bf16,
// else fp32); lse/delta (B,H,Sq) fp32; outputs fp32: dk/dv (B,KH,Skv,D),
// dq (B,H,Sq,D).  D must be 16, 32, 64, 80 or 128 and KH must divide H;
// bf16 needs q, k, v and dout 16-byte aligned (TMA).
// Return cudaGetLastError() (or the error of the tensor-map encoding or of
// the shared-memory opt-in).
extern "C" int flash_dkdv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dk, void* dv, int B, int H, int KH, int Sq,
                          int Skv, int D, int causal, int window, float scale,
                          int is_bf16, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<float*>(dk),
               static_cast<float*>(dv), B, H, KH, Sq, Skv, causal, window,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(D, is_bf16, a);
}

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int H, int KH, int Sq, int Skv, int D,
                        int causal, int window, float scale, int is_bf16,
                        void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<float*>(dq),
               nullptr, B, H, KH, Sq, Skv, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(D, is_bf16, a);
}
