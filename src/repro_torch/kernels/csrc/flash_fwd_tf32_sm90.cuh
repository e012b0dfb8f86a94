// Tensor-core body of the attention forward for fp32 q/k/v (sm_90a):
// 3xTF32 on wgmma.
//
// Replaces: the Pallas TPU kernel `_fwd_kernel` / `flash_fwd` of the JAX
// package (src/repro/kernels/flash_attention/kernel.py), for fp32 inputs
// at head dims up to 80; flash_fwd.cu dispatches fp32 here (its FMA body
// keeps D = 128, which shared memory does not hold here, and no path runs).
//
// Bound: operations.  Causal attention at B=1, H=32, S=2048, D=64 is 17
// GFLOP (4 D FLOPs a live (q, k) pair) against 67 MB of compulsory fp32
// traffic: 0.035 ms at the dense TF32 rate (495 TFLOP/s), 0.257 ms at the
// fp32 FMA rate.  This body runs three TF32 products for each of the
// function's two, so its own floor is three times the TF32 figure.
//
// Precision.  One TF32 product keeps 10 mantissa bits of each operand, too
// few for the 2e-5 gate.  Each operand is split x = hi + lo, hi = tf32(x),
// lo = tf32(x - hi) (cvt.rna: the tensor core would truncate), and
// X.Y = X_lo.Y_hi + X_hi.Y_lo + X_hi.Y_hi (X_lo.Y_lo, below 2^-22 of each
// term, dropped), for S = Q.K^T and for O += P.V.  The tensor core's fp32
// accumulation truncates, so each kv tile's P.V goes into a fresh
// accumulator that is added to the rescaled O with ordinary fp32 adds: the
// promotion happens once a tile (64 or 32 kv rows).  chip_smoke.py prints,
// beside every fp32 forward row, what one TF32 rounding of each operand
// would give and the kernel's signed bias.
//
// Design.  TF32 wgmma reads both shared-memory operands K-major only, and P.V
// reduces over kv, so V must sit in shared memory transposed.  A pre-pass
// (`split_rows`, `split_vt`) reads q, k and v once and writes Q_hi, Q_lo,
// K_hi, K_lo (row-major, as the inputs) and V^T_hi, V^T_lo ((B KH, D, Skvp),
// Skvp = Skv rounded up to 8 with zeros) into scratch the caller allocates.
// V^T's kv order is permuted inside every group of 8 (storage position c
// holds kv 2c for c < 4, 2(c - 4) + 1 after): the S accumulator gives a
// thread the scores of columns 2t and 2t + 1 of each 8, the TF32 A fragment
// wants columns t and t + 4, so with that order the thread's scores ARE its
// A fragment, no shuffle.  The product: one block owns (batch, head,
// 128-row q tile), heaviest first; two consumer warpgroups of 64 q rows and
// a producer warp, which copies Q_hi / Q_lo once and streams K_hi, K_lo,
// V^T_hi, V^T_lo tiles through a two-stage ring with TMA (128B-swizzled
// 32-float slabs; rows past the end read as zero or as the next head's,
// both masked).  Per tile and warpgroup: S by 3 (D / 8) SS wgmma m64nBKVk8;
// the online softmax of the bf16 body (per-row mask ranges on edge tiles
// only, exp2 in one MUFU instruction); O *= corr; P split in registers (hi
// in place of S); the tile's P.V by 3 (BKV / 8) RS wgmma m64nDk8 into the
// fresh accumulator; O += it.  The epilogue clamps l at 1e-30 and writes
// out = O / l and lse = m + log l.
#pragma once
#include "flash_fwd_sm90.cuh"
#include "sm90.cuh"

namespace {
namespace fwd32 {

using namespace sm90;

constexpr int NWG = 2;                 // consumer warpgroups
constexpr int BQ = 64 * NWG, ST = 2;   // q rows a block, ring stages
constexpr int NT = 128 * (NWG + 1);    // + one producer warpgroup
constexpr int CREGS = 232, PREGS = 40;
constexpr float NEG = fwd90::NEG;

// kv rows a tile: 64, or 32 at D = 80 (shared memory)
template <int D>
__host__ __device__ constexpr int bkv() {
  return D >= 80 ? 32 : 64;
}

// A row of D floats in slabs of at most 32 (128 bytes, 128B swizzle); a
// 16-float remainder (D = 16, 80) is a 64-byte slab with 64B swizzle.
template <int D>
struct FSlabs {
  static_assert(D == 16 || D == 32 || D == 64 || D == 80, "D <= 80");
  static constexpr int N = (D + 31) / 32;
  __host__ __device__ static constexpr int width(int s) {
    return D - 32 * s < 32 ? D - 32 * s : 32;
  }
  // byte offset of slab s in a region of `rows` rows
  __host__ __device__ static constexpr uint32_t offset(int s, int rows) {
    return (uint32_t)(s * rows * 128);
  }
};

// Skv rounded up to whole groups of 8 (the V^T permutation)
__host__ __device__ constexpr int padded_kv(int Skv) {
  return (Skv + 7) / 8 * 8;
}

// storage position c of a group of 8 in V^T holds kv perm(c)
__host__ __device__ constexpr int perm(int c) {
  return c < 4 ? 2 * c : 2 * (c - 4) + 1;
}

template <int D>
constexpr size_t smem_bytes() {
  // 1024 bytes of alignment slack, Q hi + lo, ST x (K hi + lo, V^T hi + lo),
  // 2 ST + 1 barriers
  return 1024 + 2 * (size_t)BQ * D * 4 + ST * 4 * (size_t)bkv<D>() * D * 4 +
         8 * (2 * ST + 1);
}

struct Maps {
  CUtensorMap q_hi[3], q_lo[3], k_hi[3], k_lo[3];  // one per D slab
  CUtensorMap v_hi, v_lo;                          // 32-kv slabs of V^T
};

// x (n floats) -> hi, lo of the same layout (any alignment: the split
// operands, not x, feed TMA)
__global__ void split_rows(const float* __restrict__ x, float* __restrict__ hi,
                           float* __restrict__ lo, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    split_tf32(x[i], hi, lo, i);
}

// v (planes, Skv, D) -> V^T hi, lo (planes, D, Skvp), kv permuted in groups
// of 8 and zero past Skv; 32 x 32 tiles through shared memory so that both
// the reads and the writes coalesce.  Grid (Skvp / 32 rounded up, D / 32
// rounded up, planes), block 32 x 8.
__global__ void split_vt(const float* __restrict__ v, float* __restrict__ hi,
                         float* __restrict__ lo, int Skv, int D, int Skvp) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const size_t plane = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* vp = v + plane * Skv * D;
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int k = k0 + ty + j, d = d0 + tx;
    t[ty + j][tx] = (k < Skv && d < D) ? vp[(size_t)k * D + d] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int d = d0 + ty + j, c = k0 + tx;        // storage position c
    if (d < D && c < Skvp) {
      const int kl = (tx & ~7) + perm(tx & 7);     // its kv, in the tile
      split_tf32(t[kl][ty + j], hi, lo, (plane * D + d) * Skvp + c);
    }
  }
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

// S = Q K^T (3xTF32) of the warpgroup's Q rows and one stage's K tiles
// into s (issued, committed)
template <int D>
__device__ __forceinline__ void issue_s(uint32_t q_hi, uint32_t q_lo,
                                        uint32_t k_hi, uint32_t k_lo,
                                        int wg, float* s) {
  using SL = FSlabs<D>;
  constexpr int BKV = bkv<D>();
  wgmma_fence();
#pragma unroll
  for (int sl = 0; sl < SL::N; ++sl) {
    const int w = SL::width(sl);       // floats; the descriptor takes 2 w
    const uint32_t qo = SL::offset(sl, BQ) + 64 * wg * 4 * w;
    const uint32_t ko = SL::offset(sl, BKV);
#pragma unroll
    for (int k = 0; k < w / 8; ++k) {
      const uint64_t qh = desc_kmajor(q_hi + qo + 32 * k, 2 * w);
      const uint64_t kh = desc_kmajor(k_hi + ko + 32 * k, 2 * w);
      // the first product of the tile overwrites s
      mma_tf32_ss<BKV>(s, desc_kmajor(q_lo + qo + 32 * k, 2 * w), kh,
                       sl != 0 || k != 0);
      mma_tf32_ss<BKV>(s, qh, desc_kmajor(k_lo + ko + 32 * k, 2 * w), 1);
      mma_tf32_ss<BKV>(s, qh, kh, 1);
    }
  }
  wgmma_commit();
}

// What a consumer warpgroup needs to process kv tiles.
struct Consumer {
  uint32_t sQh, sQl, sS, full, empty;  // shared addresses
  int wg, row0, cl, qa, Skv, causal, window, kj0;
  float sl2;
};

// Tile n of the warpgroup's walk: S, online softmax, O *= corr, then the
// tile's P.V into a fresh accumulator added to O; the stage is released.
template <int D>
__device__ __forceinline__ void tile_step(const Consumer& c, int n, float* s,
                                          float* o, float* part, float (&m)[2],
                                          float (&l)[2]) {
  constexpr int BKV = bkv<D>();
  constexpr uint32_t T = (uint32_t)BKV * D * 4;   // one operand tile
  const int st = n % ST;
  const uint32_t base = c.sS + st * 4 * T;        // K hi, K lo, V^T hi, lo
  mbar_wait(c.full + 8 * st, (n / ST) & 1);
  issue_s<D>(c.sQh, c.sQl, base, base + T, c.wg, s);
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
    fwd90::online_softmax<true, BKV>(s, m, l, corr, c.sl2, lo, hi);
  } else {
    const int none[2] = {0, 0};
    fwd90::online_softmax<false, BKV>(s, m, l, corr, c.sl2, none, none);
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * i + e] *= corr[e / 2];

  // ---- P = hi + lo in registers (hi in place of s); the A fragment of
  // k8 step i is (s[4i], s[4i + 2], s[4i + 1], s[4i + 3]) under V^T's order
  float plo[BKV / 2];
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    const float h = tf32_rna(s[i]);
    plo[i] = tf32_rna(s[i] - h);
    s[i] = h;
  }
  const uint32_t vh = base + 2 * T, vl = base + 3 * T;
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < BKV / 8; ++i) {
    const uint32_t ah[4] = {__float_as_uint(s[4 * i]),
                            __float_as_uint(s[4 * i + 2]),
                            __float_as_uint(s[4 * i + 1]),
                            __float_as_uint(s[4 * i + 3])};
    const uint32_t al[4] = {__float_as_uint(plo[4 * i]),
                            __float_as_uint(plo[4 * i + 2]),
                            __float_as_uint(plo[4 * i + 1]),
                            __float_as_uint(plo[4 * i + 3])};
    // k8 step i: 32-kv slab i / 4 (D rows of 128 bytes), 32 bytes a step
    const uint32_t off = (i / 4) * D * 128 + 32 * (i % 4);
    const uint64_t dh = desc_kmajor(vh + off, 64);
    mma_tf32_rs<D>(part, al, dh, i != 0);
    mma_tf32_rs<D>(part, ah, desc_kmajor(vl + off, 64), 1);
    mma_tf32_rs<D>(part, ah, dh, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(part);
  mbar_arrive(c.empty + 8 * st);       // the tile's operands are consumed
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] += part[i];
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
fwd_kernel(__grid_constant__ const Maps maps, float* __restrict__ O,
           float* __restrict__ LSE, int H, int KH, int Sq, int Skv,
           int causal, int window, float scale) {
  using SL = FSlabs<D>;
  constexpr int BKV = bkv<D>();
  constexpr uint32_t Q_BYTES = BQ * D * 4, T = (uint32_t)BKV * D * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQh = (raw + 1023) & ~1023u;
  const uint32_t sQl = sQh + Q_BYTES;
  const uint32_t sS = sQl + Q_BYTES;               // stage st: + st 4 T
  const uint32_t full = sS + ST * 4 * T;           // full[st] = full + 8 st
  const uint32_t empty = full + 8 * ST;
  const uint32_t qbar = empty + 8 * ST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // blocks are dispatched x fastest: the q tile is the slowest index and
  // runs backwards, so the heaviest tiles of every head go first
  const int h = blockIdx.x, b = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / (H / KH);
  const int q0 = qi * BQ;
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
      const int qrow = (b * H + h) * Sq + q0;
      const int kvp = b * KH + kvh, krow = kvp * Skv;
      mbar_arrive_expect_tx(qbar, 2 * Q_BYTES);
#pragma unroll
      for (int s = 0; s < SL::N; ++s) {
        tma_load_2d(sQh + SL::offset(s, BQ), &maps.q_hi[s], qbar, 32 * s, qrow);
        tma_load_2d(sQl + SL::offset(s, BQ), &maps.q_lo[s], qbar, 32 * s, qrow);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % ST, k0 = (kj0 + n) * BKV;
        if (n >= ST) mbar_wait(empty + 8 * st, ((n / ST) - 1) & 1);
        const uint32_t bar = full + 8 * st, base = sS + st * 4 * T;
        mbar_arrive_expect_tx(bar, 4 * T);
#pragma unroll
        for (int s = 0; s < SL::N; ++s) {
          tma_load_2d(base + SL::offset(s, BKV), &maps.k_hi[s], bar, 32 * s,
                      krow + k0);
          tma_load_2d(base + T + SL::offset(s, BKV), &maps.k_lo[s], bar,
                      32 * s, krow + k0);
        }
#pragma unroll
        for (int j = 0; j < BKV / 32; ++j) {
          tma_load_2d(base + 2 * T + j * D * 128, &maps.v_hi, bar, k0 + 32 * j,
                      kvp * D);
          tma_load_2d(base + 3 * T + j * D * 128, &maps.v_lo, bar, k0 + 32 * j,
                      kvp * D);
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  regs_alloc<CREGS>();
  const int wg = warp / 4, wq = warp % 4;
  Consumer c;
  c.sQh = sQh;
  c.sQl = sQl;
  c.sS = sS;
  c.full = full;
  c.empty = empty;
  c.wg = wg;
  c.qa = q0 + 64 * wg;
  c.row0 = c.qa + 16 * wq + lane / 4;              // and row0 + 8
  c.cl = 2 * (lane % 4);
  c.Skv = Skv;
  c.causal = causal;
  c.window = window;
  c.kj0 = kj0;
  c.sl2 = scale * LOG2E;

  float o[D / 2], part[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float s[BKV / 2];

  mbar_wait(qbar, 0);
  for (int n = 0; n < ntiles; ++n) tile_step<D>(c, n, s, o, part, m, l);

  // ---- epilogue: clamp l, normalise; lse = m + log l
  const size_t bh = (size_t)b * H + h;
  float* Ob = O + bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = c.row0 + 8 * r;
    if (row >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(&Ob[(size_t)row * D + 8 * i + c.cl]) =
          make_float2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    if (lane % 4 == 0) LSE[bh * Sq + row] = m[r] * LN2 + logf(lc);
  }
}

// Floats of scratch that `launch` needs.
inline long long scratch_floats(int B, int H, int KH, int Sq, int Skv, int D) {
  return 2LL * D * ((long long)B * H * Sq + (long long)B * KH * Skv +
                    (long long)B * KH * padded_kv(Skv));
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, float* scratch, int B, int H, int KH, int Sq, int Skv,
           int causal, int window, float scale, cudaStream_t stream) {
  using SL = FSlabs<D>;
  constexpr int BKV = bkv<D>();
  const int Skvp = padded_kv(Skv);
  const long long nq = (long long)B * H * Sq * D;
  const long long nk = (long long)B * KH * Skv * D;
  float* q_hi = scratch;
  float* q_lo = q_hi + nq;
  float* k_hi = q_lo + nq;
  float* k_lo = k_hi + nk;
  float* v_hi = k_lo + nk;
  float* v_lo = v_hi + (long long)B * KH * D * Skvp;
  auto blocks = [](long long n) {
    return (unsigned)(n / 256 + 1 < 8192 ? n / 256 + 1 : 8192);
  };
  split_rows<<<blocks(nq), 256, 0, stream>>>(q, q_hi, q_lo, nq);
  split_rows<<<blocks(nk), 256, 0, stream>>>(k, k_hi, k_lo, nk);
  split_vt<<<dim3((Skvp + 31) / 32, (D + 31) / 32, B * KH), dim3(32, 8), 0,
             stream>>>(v, v_hi, v_lo, Skv, D, Skvp);
  Maps maps;
  int e = 0;
  for (int s = 0; s < SL::N && !e; ++s) {
    const int w = SL::width(s);
    // a D-float row viewed from column 32 s: base shifted, same stride
    e = make_map_f32(&maps.q_hi[s], q_hi, D, B * H * Sq, w, BQ);
    if (!e) e = make_map_f32(&maps.q_lo[s], q_lo, D, B * H * Sq, w, BQ);
    if (!e) e = make_map_f32(&maps.k_hi[s], k_hi, D, B * KH * Skv, w, BKV);
    if (!e) e = make_map_f32(&maps.k_lo[s], k_lo, D, B * KH * Skv, w, BKV);
  }
  if (!e) e = make_map_f32(&maps.v_hi, v_hi, Skvp, B * KH * D, 32, D);
  if (!e) e = make_map_f32(&maps.v_lo, v_lo, Skvp, B * KH * D, 32, D);
  if (e) return e;
  constexpr size_t smem = smem_bytes<D>();
  static bool opted[64] = {};
  if (int e2 = smem_opt_in((const void*)fwd_kernel<D>, smem, opted)) return e2;
  dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  fwd_kernel<D><<<grid, NT, smem, stream>>>(maps, o, lse, H, KH, Sq, Skv,
                                            causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd32
}  // namespace
