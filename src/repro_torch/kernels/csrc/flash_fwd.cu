// Online-softmax attention forward for sm_90a.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` / `flash_fwd` of the JAX
// package (src/repro/kernels/flash_attention/kernel.py).  There the kv
// block index j is the minor-most, sequentially executed grid axis and the
// running max `m`, denominator `l` and output accumulator live in VMEM
// scratch between grid steps.  Here one thread block owns one
// (batch, head, q tile) and walks the kv tiles in a loop; m, l and the
// accumulator stay in registers for the whole walk and the (Sq, Skv) score
// matrix never reaches device memory.
//
// Three bodies, chosen by the input type and head dim in `flash_fwd` below:
//   * bf16 q/k/v: the tensor-core body of flash_fwd_sm90.cuh (wgmma on a
//     TMA-fed ring in shared memory, P rounded to bf16 for P.V);
//   * fp32 q/k/v, D <= 80: the tensor-core body of flash_fwd_tf32_sm90.cuh
//     (3xTF32 wgmma after a split pre-pass; the fp32 parity tolerance of
//     2e-5 rules out one TF32 product);
//   * fp32 q/k/v, D = 128: the FMA body in this file, all maths in fp32
//     FMAs (the 3xTF32 body's operands do not fit in shared memory there).
//
// Semantics kept from the reference body by all three:
//   * layout q (B,H,Sq,D), k/v (B,KH,Skv,D); kv head = h / (H/KH), by index;
//   * s = (q.k) * scale, masked entries set to NEG = -1e30 (finite);
//   * p = exp(s - m_new) is zeroed BY THE MASK, not by underflow: a row that
//     is wholly masked inside a live tile has m_new = NEG and exp(0) = 1;
//   * tiles with no unmasked element are skipped by the `_tile_live`
//     predicate (causal upper bound and sliding-window lower bound);
//   * l is clamped at 1e-30, out = acc / l cast to q's type,
//     lse = m + log(l) in fp32.
// The result does not depend on the tile sizes beyond rounding, so the
// kernels use their own tiles whatever bq/bk the caller's burst model
// uses; positions outside Sq / Skv are masked, so neither has to be a
// multiple of the tile.
//
// FMA body (fp32, D = 128).  Bound: operations; with true-fp32 products the
// yardstick is the fp32 FMA rate outside the tensor cores.
// Design: 256 threads as a 16x16 grid.  Scores: a 64x64 tile, 4x4 per
// thread, from Q and K tiles held transposed in shared memory (float4 reads
// along the row / column axis).  The 16 threads that share a row group are
// 16 consecutive lanes, so row max and row sum are four xor-shuffles.  P
// goes to shared memory; O += P.V gives each thread the same 4 rows and
// D/16 columns strided by 16, so the softmax rescale is applied in
// registers without any exchange.  Heaviest (latest, under a causal mask) q
// tiles are scheduled first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_fwd_sm90.cuh"
#include "flash_fwd_tf32_sm90.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, NT = 256;
constexpr int LDT = 64 + 4;            // padded row of a 64-wide tile
constexpr float NEG = -1.0e30f;

template <int D>
constexpr size_t smem_bytes() {
  // Qt[D][LDT] + Kt[D][LDT] + Vs[BKV][D+4] + Ps[BQ][LDT]
  return sizeof(float) * (2 * D * LDT + BKV * (D + 4) + BQ * LDT);
}

// xor-shuffles over 8,4,2,1 stay inside a group of 16 consecutive lanes
__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ Q, const float* __restrict__ Kg,
           const float* __restrict__ Vg, float* __restrict__ O,
           float* __restrict__ LSE, int H, int KH, int Sq, int Skv,
           int causal, int window, float scale) {
  constexpr int DT = D / 16;           // output columns per thread
  constexpr int LDV = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                    // [D][LDT]   Qt[d][row]
  float* Kt = Qt + D * LDT;            // [D][LDT]   Kt[d][col]
  float* Vs = Kt + D * LDT;            // [BKV][LDV] Vs[col][d]
  float* Ps = Vs + BKV * LDV;          // [BQ][LDT]  Ps[row][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qi = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qi * BQ;

  const float* Qb = Q + ((size_t)b * H + h) * Sq * D;
  const float* Kb = Kg + ((size_t)b * KH + kvh) * Skv * D;
  const float* Vb = Vg + ((size_t)b * KH + kvh) * Skv * D;

  // Q tile, transposed into shared memory once
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    Qt[d * LDT + r] = (q0 + r < Sq) ? Qb[(size_t)(q0 + r) * D + d] : 0.f;
  }

  float m_run[4], l_run[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }

  const int nkv = (Skv + BKV - 1) / BKV;
  for (int kj = 0; kj < nkv; ++kj) {
    const int k0 = kj * BKV;
    // `_tile_live` for this kernel's own tiles (uniform across the block)
    bool live = true;
    if (causal) live = live && (k0 <= q0 + BQ - 1);
    if (window) live = live && (k0 + BKV - 1 > q0 - window);
    if (!live) continue;

    __syncthreads();                   // previous tile's K, V, P consumed
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < Skv;
      const size_t g = (size_t)(k0 + r) * D + d;
      Kt[d * LDT + r] = in ? Kb[g] : 0.f;
      Vs[r * LDV + d] = in ? Vb[g] : 0.f;
    }
    __syncthreads();

    // ---- scores: s[i][j] for rows ty*4+i, cols tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(&Qt[d * LDT + ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Kt[d * LDT + tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

    // ---- mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool o = kpos < Skv;
        if (causal) o = o && (kpos <= qpos);
        if (window) o = o && (kpos > qpos - window);
        ok[j] = o;
        s[i][j] = o ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m_run[i], mx);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[j];
      }
      sum = group16_sum(sum);
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= corr;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * LDT + tx * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // ---- acc[i][j] += sum_c P[row_i][c] * V[c][tx + 16 j]
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * LDT + c]);
        p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float v[DT];
#pragma unroll
        for (int j = 0; j < DT; ++j) v[j] = Vs[(c + cc) * LDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DT; ++j)
            acc[i][j] = fmaf(p[i][cc], v[j], acc[i][j]);
      }
    }
  }

  // ---- finalise: clamp l, normalise, cast; lse = m + log(l)
  float* Ob = O + ((size_t)b * H + h) * Sq * D;
  float* Lb = LSE + ((size_t)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      Ob[(size_t)row * D + tx + 16 * j] = acc[i][j] / l;
    if (tx == 0) Lb[row] = m_run[i] + logf(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KH, int Sq, int Skv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = fwd_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KH, Sq,
      Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that `flash_fwd` needs: the split operands of the fp32
// tensor-core body, 0 for the other bodies.
extern "C" long long flash_fwd_scratch(int B, int H, int KH, int Sq, int Skv,
                                       int D, int is_bf16) {
  return is_bf16 || D > 80 ? 0
                           : fwd32::scratch_floats(B, H, KH, Sq, Skv, D);
}

// Launches on `stream`, does not synchronise, allocates nothing.
// q/out (B,H,Sq,D), k/v (B,KH,Skv,D), lse (B,H,Sq) fp32; is_bf16 selects the
// type of q, k, v and out: bf16 runs the tensor-core body (q, k and v
// 16-byte aligned), fp32 the 3xTF32 body (D <= 80, `scratch` of
// flash_fwd_scratch() floats, 16-byte aligned) or at D = 128 the FMA body.
// D must be 16, 32, 64, 80 or 128 and KH must divide H.  Returns
// cudaGetLastError() (or the error of the tensor-map encoding or of the
// shared-memory opt-in).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, void* scratch, int B, int H,
                         int KH, int Sq, int Skv, int D, int causal,
                         int window, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 ||
      H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  float* w = static_cast<float*>(scratch);
  if (!is_bf16 && D <= 80 && w == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
#define FB_CASE(DD)                                                          \
  case DD:                                                                   \
    return is_bf16 ? fwd90::launch<DD>(q, k, v, out, l, B, H, KH, Sq, Skv,   \
                                       causal, window, scale, s)             \
                   : fwd32::launch<DD>(qf, kf, vf, of, l, w, B, H, KH, Sq,   \
                                       Skv, causal, window, scale, s);
  switch (D) {
    FB_CASE(16)
    FB_CASE(32)
    FB_CASE(64)
    FB_CASE(80)
    case 128:
      return is_bf16 ? fwd90::launch<128>(q, k, v, out, l, B, H, KH, Sq, Skv,
                                          causal, window, scale, s)
                     : launch<128>(q, k, v, out, l, B, H, KH, Sq, Skv, causal,
                                   window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FB_CASE
}
