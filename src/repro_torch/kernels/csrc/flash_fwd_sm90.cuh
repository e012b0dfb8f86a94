// Tensor-core body of the attention forward for bf16 q/k/v (sm_90a).
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` / `flash_fwd` of the JAX
// package (src/repro/kernels/flash_attention/kernel.py), for bf16 inputs;
// flash_fwd.cu dispatches bf16 here and keeps its fp32-FMA body for fp32.
//
// Bound: operations.  Causal attention at B=2, H=32, S=2048, D=64 is 34
// GFLOP (4 D FLOPs a live (q, k) pair) against ~34 MB of compulsory
// traffic; the yardstick is the bf16 tensor-core rate (989 TFLOP/s), which
// only `wgmma` reaches.  At D=64 the exponentials cost about as much as
// the products: 16 exp2 a clock an SM against 4,096 bf16 FLOPs, i.e. one
// exp2 per 256 FLOPs, exactly what each score needs (4 D).
//
// Design.  One block owns (batch, head, 192-row q tile), heaviest tiles
// (latest, under a causal mask) first: three consumer warpgroups of 64 q
// rows each (more warps to hide the latency of each warpgroup's serial
// product -> softmax -> product chain), and one producer warpgroup whose
// first warp issues the copies.  The producer copies the Q tile once and
// streams the live K and V tiles (128 rows; 64 at D >= 80) through a
// two-stage ring in shared memory with TMA, one `full` and one `empty`
// mbarrier a stage, so tile j+1 lands while tile j is multiplied.  Tiles
// stay bf16 in shared memory, cut into swizzled slabs (sm90.cuh).  Per
// tile and warpgroup:
//   * S = Q.K^T by wgmma, both operands K-major in shared memory, fp32
//     accumulator;
//   * online softmax on the accumulator registers: a row lives in the 4
//     lanes of a quad, so its max and sum are two xor-shuffles; exp2 in one
//     MUFU instruction with log2(e) folded into the scale; masked entries
//     are set to NEG = -1e30 (finite) and p is zeroed BY THE MASK, so a row
//     wholly masked inside a live tile contributes nothing; only tiles that
//     cross the diagonal, the window edge or the end of Skv are masked, by
//     comparing each column with its row's visible range;
//   * O += P.V by wgmma with P packed to bf16 in registers (register-A
//     form) and V MN-major in shared memory (transposed-B form), one
//     instruction per slab of the head dim; the rescale of O by
//     exp(m_old - m_new) is applied to the accumulator registers.
// Dead tiles are skipped by the block-uniform `_tile_live` predicate (the
// live ones are one contiguous run).  The epilogue clamps l at 1e-30,
// writes out = O / l in bf16 and lse = m + log l in fp32 once, and skips
// rows past Sq.  TMA fills rows past Sq / Skv with zeros; the mask removes
// the columns.
#pragma once
#include "sm90.cuh"

namespace {
namespace fwd90 {

using namespace sm90;

constexpr int NWG = 3;                 // consumer warpgroups
constexpr int BQ = 64 * NWG, ST = 2;   // q rows a block, ring stages
constexpr int NT = 128 * (NWG + 1);    // + one producer warpgroup
// 3 consumer warpgroups at 160 registers + the producer at 24 = 64,512 of
// the SM's 65,536
constexpr int CREGS = 160, PREGS = 24;
constexpr float NEG = -1.0e30f;

// kv rows a tile: 128, or 64 at D >= 80 (the score and output accumulators
// and P's fragments then stay within 160 registers)
template <int D>
__host__ __device__ constexpr int bkv() {
  return D >= 80 ? 64 : 128;
}

struct Maps {
  CUtensorMap q[2], k[2], v[2];        // one per slab
};

template <int D>
constexpr size_t smem_bytes() {
  // 1024 bytes of alignment slack, Q, ST x (K, V), 2 ST + 1 barriers
  return 1024 + (size_t)BQ * D * 2 + 2 * ST * (size_t)bkv<D>() * D * 2 +
         8 * (2 * ST + 1);
}

// `_tile_live` for a (BQ-row q tile, BKV-row kv tile)
template <int BKV>
__device__ __forceinline__ bool tile_live(int q0, int k0, int causal,
                                          int window) {
  bool live = true;
  if (causal) live = live && (k0 <= q0 + BQ - 1);
  if (window) live = live && (k0 + BKV - 1 > q0 - window);
  return live;
}

// One tile's online-softmax step on the S accumulator of m64nNk16 (see
// sm90.cuh) in place: where MASK, scores whose column lies outside [lo, hi]
// of their row (offsets from the thread's first column) are set to NEG;
// the running max m (log2 domain) and sum l are updated, s is overwritten
// by p = exp2(s scale log2(e) - m) (zero where masked) and corr is
// exp2(m_old - m_new).  Max and sum run as two chains a row.
template <bool MASK, int N>
__device__ __forceinline__ void online_softmax(float* s, float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float sl2, const int (&lo)[2],
                                               const int (&hi)[2]) {
  auto ok = [&](int i, int e) {
    const int j = 8 * i + (e & 1);
    return !MASK || (j >= lo[e / 2] && j <= hi[e / 2]);
  };
  float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!ok(i, e)) s[4 * i + e] = NEG;
      mx[e / 2][i & 1] = fmaxf(mx[e / 2][i & 1], s[4 * i + e]);
    }
  float nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[r][0], mx[r][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    // scale > 0, so the max of the scaled scores is the scaled max
    const float mn = fmaxf(m[r], x == NEG ? NEG : x * sl2);
    corr[r] = ex2(m[r] - mn);
    m[r] = mn;
    nm[r] = -mn;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ok(i, e) ? ex2(fmaf(s[4 * i + e], sl2, nm[e / 2])) : 0.f;
      s[4 * i + e] = p;
      sum[e / 2][i & 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = sum[r][0] + sum[r][1];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[r] = l[r] * corr[r] + x;
  }
}

// What a consumer warpgroup needs to process kv tiles.
struct Consumer {
  uint32_t sQ, sK, sV, full, empty;    // shared addresses
  int wg, row0, cl, qa, Skv, causal, window, kj0, ntiles;
  float sl2;
};

// S = Q K^T of ring stage st into acc (issued, committed, not waited for)
template <int D>
__device__ __forceinline__ void issue_s(const Consumer& c, int st, float* acc) {
  using SL = Slabs<D>;
  constexpr int BKV = bkv<D>(), W0 = SL::width(0), W1 = SL::width(SL::N - 1);
  const uint32_t kst = c.sK + st * BKV * D * 2;
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < W0 / 16; ++k)
    mma_ss<BKV>(acc, desc_kmajor(c.sQ + 64 * c.wg * 2 * W0 + 32 * k, W0),
                desc_kmajor(kst + 32 * k, W0), k != 0);
  if constexpr (SL::N == 2) {
    const uint32_t qb = c.sQ + SL::offset(1, BQ) + 64 * c.wg * 2 * W1;
    const uint32_t kb = kst + SL::offset(1, BKV);
#pragma unroll
    for (int k = 0; k < W1 / 16; ++k)
      mma_ss<BKV>(acc, desc_kmajor(qb + 32 * k, W1),
                  desc_kmajor(kb + 32 * k, W1), 1);
  }
  wgmma_commit();
}

// Tile n of the warpgroup's walk: S = Q K^T into s, online softmax, then
// O += P V; the tile's ring stage is released at the end.
template <int D>
__device__ __forceinline__ void tile_step(const Consumer& c, int n, float* s,
                                          float* o, float (&m)[2],
                                          float (&l)[2]) {
  using SL = Slabs<D>;
  constexpr int BKV = bkv<D>(), W0 = SL::width(0), W1 = SL::width(SL::N - 1);
  const int st = n % ST;
  mbar_wait(c.full + 8 * st, (n / ST) & 1);
  issue_s<D>(c, st, s);
  wgmma_wait<0>();
  fence_regs<BKV / 2>(s);

  // ---- mask (only tiles that cross the diagonal, window edge or Skv)
  const int k0 = (c.kj0 + n) * BKV;
  float corr[2];
  if ((k0 + BKV > c.Skv) || (c.causal && k0 + BKV - 1 > c.qa) ||
      (c.window && k0 <= c.qa + 63 - c.window)) {
    int lo[2], hi[2];                  // visible columns of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = c.row0 + 8 * r, c0 = k0 + c.cl;
      hi[r] = (c.causal ? min(qp, c.Skv - 1) : c.Skv - 1) - c0;
      lo[r] = c.window ? qp - c.window + 1 - c0 : -BKV;
    }
    online_softmax<true, BKV>(s, m, l, corr, c.sl2, lo, hi);
  } else {
    const int none[2] = {0, 0};
    online_softmax<false, BKV>(s, m, l, corr, c.sl2, none, none);
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * i + e] *= corr[e / 2];

  // ---- O += P V, P packed to bf16 in registers
  uint32_t a[BKV / 16][4];
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  const uint32_t vst = c.sV + st * BKV * D * 2;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    mma_rs<W0>(o, a[kk], desc_mnmajor(vst + kk * 32 * W0, W0));
    if constexpr (SL::N == 2)
      mma_rs<W1>(o + 32, a[kk],
                 desc_mnmajor(vst + SL::offset(1, BKV) + kk * 32 * W1, W1));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(o);
  mbar_arrive(c.empty + 8 * st);       // K and V of tile n are consumed
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
fwd_kernel(__grid_constant__ const Maps maps, __nv_bfloat16* __restrict__ O,
           float* __restrict__ LSE, int H, int KH, int Sq, int Skv,
           int causal, int window, float scale) {
  using SL = Slabs<D>;
  constexpr int BKV = bkv<D>();
  constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BKV * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + Q_BYTES;                // stage st: + st KV_BYTES
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
  // the live kv tiles are one run [kj0, kj0 + ntiles)
  const int nkv = (Skv + BKV - 1) / BKV;
  int kj0 = 0, kj1 = nkv;
  while (kj0 < nkv && !tile_live<BKV>(q0, kj0 * BKV, causal, window)) ++kj0;
  while (kj1 > kj0 && !tile_live<BKV>(q0, (kj1 - 1) * BKV, causal, window))
    --kj1;
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
      mbar_arrive_expect_tx(qbar, Q_BYTES);
#pragma unroll
      for (int s = 0; s < SL::N; ++s)
        tma_load_3d(sQ + SL::offset(s, BQ), &maps.q[s], qbar, 64 * s, q0, bh);
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
  Consumer c;
  c.sQ = sQ;
  c.wg = wg;
  c.sK = sK;
  c.sV = sV;
  c.full = full;
  c.empty = empty;
  c.qa = q0 + 64 * wg;
  c.row0 = c.qa + 16 * wq + lane / 4;              // and row0 + 8
  c.cl = 2 * (lane % 4);
  c.Skv = Skv;
  c.causal = causal;
  c.window = window;
  c.kj0 = kj0;
  c.ntiles = ntiles;
  c.sl2 = scale * LOG2E;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float s[BKV / 2];

  mbar_wait(qbar, 0);
  for (int n = 0; n < ntiles; ++n) tile_step<D>(c, n, s, o, m, l);

  // ---- epilogue: clamp l, normalise, cast; lse = m + log l
  const size_t bh = (size_t)b * H + h;
  __nv_bfloat16* Ob = O + bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = c.row0 + 8 * r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(&Ob[(size_t)row * D + 8 * i + c.cl]) =
          __floats2bfloat162_rn(o[4 * i + 2 * r] * inv,
                                o[4 * i + 2 * r + 1] * inv);
    if (lane % 4 == 0) LSE[bh * Sq + row] = m[r] * LN2 + logf(lc);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KH, int Sq, int Skv, int causal, int window,
           float scale, cudaStream_t stream) {
  using SL = Slabs<D>;
  Maps maps;
  for (int s = 0; s < SL::N; ++s) {
    const int w = SL::width(s);
    int e = make_map(&maps.q[s], q, D, Sq, B * H, w, BQ);
    if (!e) e = make_map(&maps.k[s], k, D, Skv, B * KH, w, bkv<D>());
    if (!e) e = make_map(&maps.v[s], v, D, Skv, B * KH, w, bkv<D>());
    if (e) return e;
  }
  constexpr size_t smem = smem_bytes<D>();
  static bool opted[64] = {};
  if (int e = smem_opt_in((const void*)fwd_kernel<D>, smem, opted)) return e;
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  fwd_kernel<D><<<grid, NT, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), lse, H, KH, Sq, Skv, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd90
}  // namespace
