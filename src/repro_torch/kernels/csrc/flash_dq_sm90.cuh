// Tensor-core body of the attention dq backward for bf16 q/k/v/dout
// (sm_90a).
//
// Replaces: the Pallas TPU kernel `_dq_kernel` / `flash_dq` of the JAX
// package (src/repro/kernels/flash_attention/kernel.py), for bf16 inputs;
// flash_bwd.cu dispatches bf16 here and keeps its fp32-FMA body for fp32.
//
// Bound: operations.  Causal attention at B=2, H=32, S=2048, D=64 needs
// 6 D FLOPs a live (q, k) pair and head (51.5 GFLOP) against ~42 MB of
// compulsory traffic; the yardstick is the bf16 tensor-core rate.
//
// Design.  As in the FMA body, one block owns (batch, head, q tile) and
// walks the live kv tiles with dq in fp32 registers, written once; no
// atomics.  Three consumer warpgroups own 64 q rows each (a 192-row q
// tile, as in the forward); one producer warp copies the Q and dO tiles
// once (TMA) and streams the 64-row K and V tiles through a two-stage ring,
// one `full` and one `empty` mbarrier a stage.  K and V are read at kv head
// h / G by the map's coordinate, never repeated.  lse and delta of a
// thread's two rows stay in registers for the whole walk.  Per tile and
// warpgroup, three commit groups:
//   * S = Q.K^T, then dP = dO.V^T, by wgmma, all operands K-major in shared
//     memory, fp32 accumulators;
//   * P = exp2(S scale log2(e) - lse log2(e)) while dP is computed, zeroed
//     by the mask; only tiles that cross the diagonal, the window edge or
//     the end of Skv are masked, by each row's visible column range;
//   * dS = P (dP - delta) scale, then dQ += dS.K by wgmma (register-A dS,
//     K MN-major in shared memory: the transposed-B form of the forward's
//     P.V).
// Precision: the gate is 5e-4 max(1, max|plain|) against fp32 maths; dS is
// carried as a bf16 pair hi + lo (about 16 mantissa bits) and multiplied
// twice, as in flash_dkdv_sm90.cuh (one rounding is measured beside every
// row by chip_smoke.py).  P enters no product, so it is never rounded.
// A warpgroup whose 64 rows see nothing of a live tile (or lie past Sq)
// skips the step; dead tiles of the block are never loaded.  The q tile is
// the slowest grid index and runs backwards, so the heaviest tiles under a
// causal mask start first.  Rows past Sq are not written.
#pragma once
#include "sm90.cuh"

namespace {
namespace dq90 {

using namespace sm90;

constexpr int NWG = 3;                 // consumer warpgroups
constexpr int BQ = 64 * NWG, BKV = 64, ST = 2;
constexpr int NT = 128 * (NWG + 1);    // + one producer warpgroup
// 3 consumer warpgroups at 160 registers + the producer at 24 = 64,512 of
// the SM's 65,536
constexpr int CREGS = 160, PREGS = 24;

struct Maps {
  CUtensorMap q[2], dout[2], k[2], v[2];   // one per slab
};

template <int D>
constexpr size_t smem_bytes() {
  // alignment slack, Q, dO, ST x (K, V), 2 ST + 1 barriers
  return 1024 + 2 * (size_t)BQ * D * 2 + 2 * ST * (size_t)BKV * D * 2 +
         8 * (2 * ST + 1);
}

// any unmasked element between q rows [q0, q0 + rows) and kv rows
// [k0, k0 + BKV)?
__device__ __forceinline__ bool live(int q0, int rows, int k0, int causal,
                                     int window) {
  bool ok = true;
  if (causal) ok = ok && (k0 <= q0 + rows - 1);
  if (window) ok = ok && (k0 + BKV - 1 > q0 - window);
  return ok;
}

// P = exp2(S scale log2(e) - lse log2(e)) in place of S, on the accumulator
// of m64n64k16 (rows: q, columns: kv); where MASK, p is zeroed outside the
// visible columns [lo, hi] of each row (offsets from the thread's first
// column).  L holds lse log2(e) of the thread's two rows.
template <bool MASK>
__device__ __forceinline__ void probs(float* s, const float (&L)[2],
                                      float sl2, const int (&lo)[2],
                                      const int (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 8 * i + (e & 1);
      const float p = ex2(fmaf(s[4 * i + e], sl2, -L[e / 2]));
      s[4 * i + e] = (!MASK || (j >= lo[e / 2] && j <= hi[e / 2])) ? p : 0.f;
    }
}

// S (or dP) = X.Y^T of one warpgroup's 64 rows of X (at `xa`, BQ rows a
// slab) and the BKV rows of Y (at `yb`) into acc (issued, not committed)
template <int D>
__device__ __forceinline__ void issue_scores(float* acc, uint32_t xa,
                                             uint32_t yb, int wg) {
  using SL = Slabs<D>;
  constexpr int W0 = SL::width(0), W1 = SL::width(SL::N - 1);
  const uint32_t x0 = xa + 64 * wg * 2 * W0;
#pragma unroll
  for (int k = 0; k < W0 / 16; ++k)
    mma_ss_n64(acc, desc_kmajor(x0 + 32 * k, W0),
               desc_kmajor(yb + 32 * k, W0), k != 0);
  if constexpr (SL::N == 2) {
    const uint32_t x1 = xa + SL::offset(1, BQ) + 64 * wg * 2 * W1;
    const uint32_t y1 = yb + SL::offset(1, BKV);
#pragma unroll
    for (int k = 0; k < W1 / 16; ++k)
      mma_ss_n64(acc, desc_kmajor(x1 + 32 * k, W1),
                 desc_kmajor(y1 + 32 * k, W1), 1);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
dq_kernel(__grid_constant__ const Maps maps, const float* __restrict__ LSE,
          const float* __restrict__ DELTA, float* __restrict__ dQ, int H,
          int KH, int Sq, int Skv, int causal, int window, float scale) {
  using SL = Slabs<D>;
  constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sO = sQ + Q_BYTES;                // dO
  const uint32_t sK = sO + Q_BYTES;                // stage st: + st KV_BYTES
  const uint32_t sV = sK + ST * KV_BYTES;
  const uint32_t full = sV + ST * KV_BYTES;        // full[st] = full + 8 st
  const uint32_t empty = full + 8 * ST;
  const uint32_t qbar = empty + 8 * ST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // blocks are dispatched x fastest: the q tile is the slowest index and
  // runs backwards, so the heaviest tiles of every head go first
  const int h = blockIdx.x, b = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qi * BQ;
  // the live kv tiles of the block are one run [kj0, kj1)
  const int nkv = (Skv + BKV - 1) / BKV;
  int kj0 = 0, kj1 = nkv;
  while (kj0 < nkv && !live(q0, BQ, kj0 * BKV, causal, window)) ++kj0;
  while (kj1 > kj0 && !live(q0, BQ, (kj1 - 1) * BKV, causal, window)) --kj1;
  const int ntiles = kj1 - kj0;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * NWG);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warpgroup() == NWG) {
    // ------------------------------------ producer (its first warp works)
    regs_dealloc<PREGS>();
    if (warp != 4 * NWG) return;
    if (lane == 0) {
      const int bh = b * H + h, bkv = b * KH + kvh;
      mbar_arrive_expect_tx(qbar, 2 * Q_BYTES);
#pragma unroll
      for (int s = 0; s < SL::N; ++s) {
        tma_load_3d(sQ + SL::offset(s, BQ), &maps.q[s], qbar, 64 * s, q0, bh);
        tma_load_3d(sO + SL::offset(s, BQ), &maps.dout[s], qbar, 64 * s, q0,
                    bh);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % ST, k0 = (kj0 + n) * BKV;
        if (n >= ST) mbar_wait(empty + 8 * st, ((n / ST) - 1) & 1);
        mbar_arrive_expect_tx(full + 8 * st, 2 * KV_BYTES);
#pragma unroll
        for (int s = 0; s < SL::N; ++s) {
          tma_load_3d(sK + st * KV_BYTES + SL::offset(s, BKV), &maps.k[s],
                      full + 8 * st, 64 * s, k0, bkv);
          tma_load_3d(sV + st * KV_BYTES + SL::offset(s, BKV), &maps.v[s],
                      full + 8 * st, 64 * s, k0, bkv);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  regs_alloc<CREGS>();
  const int wg = warp / 4, wq = warp % 4;
  const int qa = q0 + 64 * wg;                     // this warpgroup's rows
  const int row0 = qa + 16 * wq + lane / 4;        // and row0 + 8
  const int cl = 2 * (lane % 4);
  const float sl2 = scale * LOG2E;
  const size_t bh = (size_t)b * H + h;
  float L[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;                  // rows past Sq: p (dp -
    L[r] = row < Sq ? LSE[bh * Sq + row] * LOG2E : 0.f;   // delta) = 0,
    dl[r] = row < Sq ? DELTA[bh * Sq + row] : 0.f;        // never written
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int st = n % ST, k0 = (kj0 + n) * BKV;
    mbar_wait(full + 8 * st, (n / ST) & 1);
    if (qa < Sq && live(qa, 64, k0, causal, window)) {
      const uint32_t kst = sK + st * KV_BYTES, vst = sV + st * KV_BYTES;

      // ---- S = Q K^T, then dP = dO V^T, two commit groups
      float s[BKV / 2], dp[BKV / 2];
      wgmma_fence();
      issue_scores<D>(s, sQ, kst, wg);
      wgmma_commit();
      issue_scores<D>(dp, sO, vst, wg);
      wgmma_commit();

      // ---- P while dP is computed; masked where the tile needs it
      wgmma_wait<1>();
      fence_regs<BKV / 2>(s);
      if ((k0 + BKV > Skv) || (causal && k0 + BKV - 1 > qa) ||
          (window && k0 <= qa + 63 - window)) {
        int lo[2], hi[2];              // visible kv columns of each row
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = row0 + 8 * r, c0 = k0 + cl;
          hi[r] = (causal ? min(qp, Skv - 1) : Skv - 1) - c0;
          lo[r] = window ? qp - window + 1 - c0 : -BKV;
        }
        probs<true>(s, L, sl2, lo, hi);
      } else {
        const int none[2] = {0, 0};
        probs<false>(s, L, sl2, none, none);
      }

      // ---- dS = P (dP - delta) scale, then dQ += dS K
      wgmma_wait<0>();
      fence_regs<BKV / 2>(dp);
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - dl[e / 2]) * scale;
      issue_split<D, BKV>(dq, dp, kst);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dq);
    }
    mbar_arrive(empty + 8 * st);       // K and V of tile n are consumed
  }

  // ---- epilogue: rows past Sq are not written
  float* dQb = dQ + bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(&dQb[(size_t)row * D + 8 * i + cl]) =
          make_float2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq, int B, int H,
           int KH, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t stream) {
  using SL = Slabs<D>;
  Maps maps;
  for (int s = 0; s < SL::N; ++s) {
    const int w = SL::width(s);
    int e = make_map(&maps.q[s], q, D, Sq, B * H, w, BQ);
    if (!e) e = make_map(&maps.dout[s], dout, D, Sq, B * H, w, BQ);
    if (!e) e = make_map(&maps.k[s], k, D, Skv, B * KH, w, BKV);
    if (!e) e = make_map(&maps.v[s], v, D, Skv, B * KH, w, BKV);
    if (e) return e;
  }
  constexpr size_t smem = smem_bytes<D>();
  static bool opted[64] = {};
  if (int e = smem_opt_in((const void*)dq_kernel<D>, smem, opted)) return e;
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  dq_kernel<D><<<grid, NT, smem, stream>>>(maps, lse, delta, dq, H, KH, Sq,
                                            Skv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dq90
}  // namespace
