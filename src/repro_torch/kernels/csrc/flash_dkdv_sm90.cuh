// Tensor-core body of the attention dk/dv backward for bf16 q/k/v/dout
// (sm_90a).
//
// Replaces: the Pallas TPU kernel `_dkdv_kernel` / `flash_dkdv` of the JAX
// package (src/repro/kernels/flash_attention/kernel.py), for bf16 inputs;
// flash_bwd.cu dispatches bf16 here and keeps its fp32-FMA body for fp32.
//
// Bound: operations.  Causal attention at B=2, H=32, S=2048, D=64 needs
// 8 D FLOPs a live (q, k) pair and head (69 GFLOP) against ~50 MB of
// compulsory traffic; the yardstick is the bf16 tensor-core rate.
//
// Design.  As in the FMA body, one block owns (batch, kv head, 128-row kv
// tile) and walks the G query heads of that kv head times the live q tiles
// (64 rows), with dk and dv in fp32 registers for the whole walk, written
// once; no atomics.  Two consumer warpgroups own 64 kv rows each; one
// producer warp copies the K and V tiles once (TMA) and streams each step's
// (Q tile, dO tile) through a two-stage ring with TMA, and its lse / delta
// slices with plain loads, one `full` and one `empty` mbarrier a stage.
// Per step and warpgroup (the score tile is computed transposed, kv rows by
// q columns, so that p^T and ds^T are accumulator rows), four commit
// groups so that each elementwise pass runs beside a product:
//   * S^T = K.Q^T, then dP^T = V.dO^T, by wgmma, all operands K-major in
//     shared memory, fp32 accumulators;
//   * P^T = exp(S^T scale - lse) while dP^T is computed, zeroed by the
//     mask; only steps that cross the diagonal, the window edge or the end
//     of Sq are masked;
//   * dV += P^T.dO by wgmma (register-A P^T, dO MN-major in shared memory,
//     the transposed-B form); dS^T = P^T (dP^T - delta) scale while it
//     runs; then dK += dS^T.Q likewise.
// Precision: the gate is 5e-4 max(1, max|plain|) against fp32 maths.  One
// bf16 rounding of P^T and dS^T (relative 2^-9) is too coarse for it, so
// each is carried as a pair hi = bf16(x), lo = bf16(x - hi) (about 16
// mantissa bits) and multiplied twice: six wgmma a step instead of four.
// A warpgroup whose 64 kv rows see nothing of a live q tile skips the step.
#pragma once
#include "sm90.cuh"

namespace {
namespace dkdv90 {

using namespace sm90;

constexpr int NWG = 2;                 // consumer warpgroups
constexpr int BKV = 64 * NWG, BQ = 64, ST = 2;
constexpr int NT = 128 * (NWG + 1);    // + one producer warpgroup
// 2 consumer warpgroups at 232 registers + the producer at 40 = 64,512 of
// the SM's 65,536
constexpr int CREGS = 232, PREGS = 40;

struct Maps {
  CUtensorMap k[2], v[2], q[2], dout[2];   // one per slab
};

template <int D>
constexpr size_t smem_bytes() {
  // alignment slack, K, V, ST x (Q, dO), ST x (lse, delta), barriers
  return 1024 + 2 * (size_t)BKV * D * 2 + 2 * ST * (size_t)BQ * D * 2 +
         ST * 2 * BQ * 4 + 8 * (2 * ST + 1);
}

// any unmasked element between kv rows [k0, k0 + rows) and q rows
// [q0, q0 + BQ)?
__device__ __forceinline__ bool live(int q0, int k0, int rows, int causal,
                                     int window) {
  bool ok = true;
  if (causal) ok = ok && (k0 <= q0 + BQ - 1);
  if (window) ok = ok && (k0 + rows - 1 > q0 - window);
  return ok;
}

// P^T = exp2(S^T scale log2(e) - lse log2(e)) in place of S^T, on the
// accumulator of m64n64k16 (rows: kv, columns: q); where MASK, p is zeroed
// outside the visible q columns [lo, hi] of each row (offsets from the
// thread's first column).  L holds lse log2(e) of the step's q rows.
template <bool MASK>
__device__ __forceinline__ void probs(float* s, const float* L, int cl,
                                      float sl2, const int (&lo)[2],
                                      const int (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    const float2 lse = *reinterpret_cast<const float2*>(L + 8 * i + cl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * i + (e & 1);
      const float p = ex2(fmaf(s[4 * i + e], sl2, -((e & 1) ? lse.y : lse.x)));
      s[4 * i + e] = (!MASK || (j >= lo[e / 2] && j <= hi[e / 2])) ? p : 0.f;
    }
  }
}

// dS^T = P^T (dP^T - delta) scale in place of dP^T; `delta` holds the step's
// q rows' delta.
__device__ __forceinline__ void dsoft(const float* p, float* dp,
                                      const float* delta, int cl,
                                      float scale) {
#pragma unroll
  for (int i = 0; i < BQ / 8; ++i) {
    const float2 d = *reinterpret_cast<const float2*>(delta + 8 * i + cl);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * i + e] =
          p[4 * i + e] * (dp[4 * i + e] - ((e & 1) ? d.y : d.x)) * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
dkdv_kernel(__grid_constant__ const Maps maps,
            const float* __restrict__ LSE, const float* __restrict__ DELTA,
            float* __restrict__ dK, float* __restrict__ dV, int H, int KH,
            int Sq, int Skv, int causal, int window, float scale) {
  using SL = Slabs<D>;
  constexpr int W0 = SL::width(0), W1 = SL::width(SL::N - 1);
  constexpr uint32_t KV_BYTES = BKV * D * 2, Q_BYTES = BQ * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t sK = raw + pad;
  const uint32_t sV = sK + KV_BYTES;
  const uint32_t sQ = sV + KV_BYTES;               // stage st: + st Q_BYTES
  const uint32_t sO = sQ + ST * Q_BYTES;           // dO, likewise
  float* Ls = reinterpret_cast<float*>(smem_raw + pad + 2 * KV_BYTES +
                                       2 * ST * Q_BYTES);  // [ST][2][BQ]
  const uint32_t full = smem_u32(Ls + ST * 2 * BQ);
  const uint32_t empty = full + 8 * ST;
  const uint32_t kvbar = empty + 8 * ST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // blocks are dispatched x fastest: the kv tile is the slowest index, so
  // the early kv tiles, which see the most q tiles under a causal mask, of
  // every (batch, kv head) go first
  const int kvh = blockIdx.x, b = blockIdx.y, kj = blockIdx.z;
  const int G = H / KH;
  const int k0 = kj * BKV;
  const int nq = (Sq + BQ - 1) / BQ;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 128 * NWG);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup() == NWG) {
    // ------------------------------------ producer (its first warp works)
    regs_dealloc<PREGS>();
    if (warp != 4 * NWG) return;
    const int bkv = b * KH + kvh;
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * KV_BYTES);
#pragma unroll
      for (int s = 0; s < SL::N; ++s) {
        tma_load_3d(sK + SL::offset(s, BKV), &maps.k[s], kvbar, 64 * s, k0,
                    bkv);
        tma_load_3d(sV + SL::offset(s, BKV), &maps.v[s], kvbar, 64 * s, k0,
                    bkv);
      }
    }
    int n = 0;
    for (int g = 0; g < G; ++g) {
      const int bh = b * H + kvh * G + g;
      for (int qi = 0; qi < nq; ++qi) {
        const int q0 = qi * BQ;
        if (!live(q0, k0, BKV, causal, window)) continue;
        const int st = n % ST;
        if (n >= ST) mbar_wait(empty + 8 * st, ((n / ST) - 1) & 1);
        float* L = Ls + st * 2 * BQ;
#pragma unroll
        for (int r = lane; r < BQ; r += 32) {
          const bool in = q0 + r < Sq;
          L[r] = in ? LSE[(size_t)bh * Sq + q0 + r] * LOG2E : 0.f;
          L[BQ + r] = in ? DELTA[(size_t)bh * Sq + q0 + r] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full + 8 * st, 2 * Q_BYTES);
#pragma unroll
          for (int s = 0; s < SL::N; ++s) {
            tma_load_3d(sQ + st * Q_BYTES + SL::offset(s, BQ), &maps.q[s],
                        full + 8 * st, 64 * s, q0, bh);
            tma_load_3d(sO + st * Q_BYTES + SL::offset(s, BQ), &maps.dout[s],
                        full + 8 * st, 64 * s, q0, bh);
          }
        } else {
          mbar_arrive(full + 8 * st);
        }
        ++n;
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  regs_alloc<CREGS>();
  const int wg = warp / 4, wq = warp % 4;
  const int ka = k0 + 64 * wg;                     // this warpgroup's rows
  const int row0 = ka + 16 * wq + lane / 4;        // and row0 + 8
  const int cl = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  const uint32_t kA = sK + 64 * wg * 2 * W0, vA = sV + 64 * wg * 2 * W0;
  const uint32_t kA1 = sK + SL::offset(1, BKV) + 64 * wg * 2 * W1;
  const uint32_t vA1 = sV + SL::offset(1, BKV) + 64 * wg * 2 * W1;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kvbar, 0);
  int n = 0;
  for (int g = 0; g < G; ++g) {
    for (int qi = 0; qi < nq; ++qi) {
      const int q0 = qi * BQ;
      if (!live(q0, k0, BKV, causal, window)) continue;
      const int st = n % ST;
      mbar_wait(full + 8 * st, (n / ST) & 1);
      if (live(q0, ka, 64, causal, window)) {
        const uint32_t qst = sQ + st * Q_BYTES, ost = sO + st * Q_BYTES;
        const float* L = Ls + st * 2 * BQ;

        // ---- S^T = K Q^T, then dP^T = V dO^T, two commit groups
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < W0 / 16; ++k)
          mma_ss_n64(s, desc_kmajor(kA + 32 * k, W0),
                     desc_kmajor(qst + 32 * k, W0), k != 0);
        if constexpr (SL::N == 2) {
#pragma unroll
          for (int k = 0; k < W1 / 16; ++k)
            mma_ss_n64(s, desc_kmajor(kA1 + 32 * k, W1),
                       desc_kmajor(qst + SL::offset(1, BQ) + 32 * k, W1), 1);
        }
        wgmma_commit();
#pragma unroll
        for (int k = 0; k < W0 / 16; ++k)
          mma_ss_n64(dp, desc_kmajor(vA + 32 * k, W0),
                     desc_kmajor(ost + 32 * k, W0), k != 0);
        if constexpr (SL::N == 2) {
#pragma unroll
          for (int k = 0; k < W1 / 16; ++k)
            mma_ss_n64(dp, desc_kmajor(vA1 + 32 * k, W1),
                       desc_kmajor(ost + SL::offset(1, BQ) + 32 * k, W1), 1);
        }
        wgmma_commit();

        // ---- P^T while dP^T is computed; masked where the step needs it
        wgmma_wait<1>();
        fence_regs<BQ / 2>(s);
        if ((q0 + BQ > Sq) || (causal && ka + 63 > q0) ||
            (window && ka <= q0 + BQ - 1 - window)) {
          int lo[2], hi[2];            // visible q columns of each kv row
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int kp = row0 + 8 * r, c0 = q0 + cl;
            lo[r] = (causal ? kp : 0) - c0;
            hi[r] = (window ? min(Sq - 1, kp + window - 1) : Sq - 1) - c0;
          }
          probs<true>(s, L, cl, sl2, lo, hi);
        } else {
          const int none[2] = {0, 0};
          probs<false>(s, L, cl, sl2, none, none);
        }

        // ---- dV += P^T dO; dS^T while it runs; dK += dS^T Q
        issue_split<D, BQ>(dv, s, ost);
        wgmma_commit();
        wgmma_wait<1>();               // dP^T is complete
        fence_regs<BQ / 2>(dp);
        dsoft(s, dp, L + BQ, cl, scale);
        issue_split<D, BQ>(dk, dp, qst);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(dk);
        fence_regs<D / 2>(dv);
      }
      mbar_arrive(empty + 8 * st);
      ++n;
    }
  }

  // ---- epilogue: rows past Skv are not written
  const size_t bkv = (size_t)b * KH + kvh;
  float* dKb = dK + bkv * Skv * D;
  float* dVb = dV + bkv * Skv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Skv) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const size_t at = (size_t)row * D + 8 * i + cl;
      *reinterpret_cast<float2*>(&dKb[at]) =
          make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
      *reinterpret_cast<float2*>(&dVb[at]) =
          make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dk, float* dv, int B,
           int H, int KH, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t stream) {
  using SL = Slabs<D>;
  Maps maps;
  for (int s = 0; s < SL::N; ++s) {
    const int w = SL::width(s);
    int e = make_map(&maps.k[s], k, D, Skv, B * KH, w, BKV);
    if (!e) e = make_map(&maps.v[s], v, D, Skv, B * KH, w, BKV);
    if (!e) e = make_map(&maps.q[s], q, D, Sq, B * H, w, BQ);
    if (!e) e = make_map(&maps.dout[s], dout, D, Sq, B * H, w, BQ);
    if (e) return e;
  }
  constexpr size_t smem = smem_bytes<D>();
  static bool opted[64] = {};
  if (int e = smem_opt_in((const void*)dkdv_kernel<D>, smem, opted)) return e;
  dim3 grid(KH, B, (Skv + BKV - 1) / BKV);
  dkdv_kernel<D><<<grid, NT, smem, stream>>>(maps, lse, delta, dk, dv, H,
                                              KH, Sq, Skv, causal, window,
                                              scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dkdv90
}  // namespace
