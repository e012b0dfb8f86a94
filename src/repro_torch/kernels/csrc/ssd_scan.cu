// Mamba-2 SSD chunked scan (state-space dual form, with the D skip) for
// sm_90a: the chunks in parallel, C B^T shared by a block's heads, every
// product on the tensor cores.
//
// Replaces: the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` of the JAX
// package (src/repro/kernels/mamba2_scan/kernel.py).  There the grid is
// (B, H/hb, L/cl) with the chunk axis minor-most and run in order, and the
// (hb, P, N) state stays in VMEM scratch between chunks.  Blocks of a GPU
// grid run in no order, so here the carried state is taken apart by the
// standard chunked decomposition: the state entering chunk c is a sum of
// the chunks' own contributions, decayed, which three launches compute.
//
// Semantics kept from the reference body, per chunk of cl steps (fp32
// maths on upcast x, B, C; dt, A, D fp32):
//     cum  = cumsum(dt * A)                                  (A < 0: cum falls)
//     M    = (C B^T)[i][j] * exp(cum_i - cum_j) * dt_j     for j <= i, else 0
//     y    = M x + exp(cum) * (C state^T) + D x
//     state = state * exp(cum_last) + (x * dt * exp(cum_last - cum))^T B
// Every exponent is <= 0.  Entries above the diagonal are set to zero
// explicitly and their exponential is never taken, so no sentinel value
// reaches exp().  y (B,L,H,P) and the final state (B,H,P,N) in fp32.
//
// The three launches of one call:
//   1. `chunk_state`, one block per (batch, chunk, group of heads): for
//      each head, cum and the chunk's own state contribution
//      S_c = (x * dt * exp(cum_last - cum))^T B, which needs no earlier
//      state, into scratch (B, nc, H, P, N), and cum_last into (B, nc, H);
//   2. `state_pass`, one block per (batch, head): walks the chunks in order,
//      state_c = state_{c-1} * exp(cum_last_c) + S_c, overwriting S_c with
//      the state that ENTERS chunk c (zero for the first), and writes the
//      final state;
//   3. `chunk_out`, one block per (batch, chunk, group of heads): C B^T
//      once for the group, then for each head
//      y = exp(cum) * (C state_in^T) + M x + D x, written once.
// Nothing is carried from one block to another inside a launch, so no
// ordering of blocks is assumed; the stream orders the launches.
//
// Bound: bytes, on the tensor cores.  At zamba2-2.7b's width (cl=128,
// P=N=64, H=80, L=1536) the function moves 49 MB (mostly y in fp32):
// 0.015 ms at 3.35 TB/s; its FLOPs, cl (cl+1) N a chunk (C B^T on the
// causal triangle) and cl (cl+1) P + 4 cl P N a chunk and head (M x, C
// state^T, the state update), are 3.0 G: 0.003 ms at the bf16 rate, 0.045
// at the fp32 FMA rate.
//
// Tensor cores: mma.sync m16n8k16 in bf16 with fp32 accumulation, operand
// fragments built from shared memory (any layout, no TMA: every operand is
// loaded, converted and, where needed, transposed by the block itself).  In
// bf16 (the served path) x, B and C are exact bf16 operands; M, the
// weighted x^T and the incoming state are fp32 and go in as bf16 hi + lo
// pairs (x = hi + lo to about 16 bits): two products each.  For fp32 x,
// B and C every operand is such a pair and each product is three
// (hi.hi + hi.lo + lo.hi).  chip_smoke.py prints, beside every row, what
// one bf16 rounding of the fp32 operands would give.  Each warp owns 16
// rows of the chunk; C B^T stays in that warp's registers for all the heads
// of the block, and its fragments are exactly the A fragments of M (the
// m16n8 accumulator layout is the m16k16 operand layout), so M is built in
// registers from them.
//
// Limits: cl, P and N multiples of 4, cl <= 128, P <= 64, N <= 64 (register
// fragments sized for them; smaller ones are padded with zeros to 16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::split_pack;   // x0, x1 as packed bf16 hi + lo pairs

constexpr int CL_MAX = 128, P_MAX = 64, N_MAX = 64;
// heads a block: bf16 operands take one (the output launch then fits in
// 128 registers, two blocks an SM), fp32 ones four (C B^T, three products
// there, shared by four heads); measured faster each way at the served
// shape
template <typename T>
__host__ __device__ constexpr int heads() {
  return sizeof(T) == 2 ? 1 : 4;
}
constexpr int NW_OUT = CL_MAX / 16;    // warps of chunk_out: 16 rows each
constexpr int NW_STATE = P_MAX / 16;   // warps of chunk_state: 16 p each
// row strides in bf16 of the operand tiles: 16-column multiples + 8, so
// that the 8 x 4 threads of a fragment load hit 32 distinct banks
constexpr int LDN = N_MAX + 8;         // [row][n]
constexpr int LDJ = CL_MAX + 8;        // [p or n][j]

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x as bf16 hi (and lo = bf16(x - hi))
__device__ __forceinline__ void split1(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulator.  a: (g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..) of the 16 x 16 A tile; b: rows
// (k) 2t..2t+1 and 2t+8..2t+9 of column g of the 16 x 8 B tile; d: (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the 32-bit word of two consecutive bf16 at row r, column c (even)
__device__ __forceinline__ uint32_t word(const __nv_bfloat16* m, int ld, int r,
                                         int c) {
  return *reinterpret_cast<const uint32_t*>(m + r * ld + c);
}
// A fragment of the 16 x 16 tile at (r0, c0) of a [row][col] bf16 matrix
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* m,
                                       int ld, int r0, int c0, int g, int t) {
  a[0] = word(m, ld, r0 + g, c0 + 2 * t);
  a[1] = word(m, ld, r0 + g + 8, c0 + 2 * t);
  a[2] = word(m, ld, r0 + g, c0 + 2 * t + 8);
  a[3] = word(m, ld, r0 + g + 8, c0 + 2 * t + 8);
}
// B fragment of the 16 (k) x 8 (n) tile at (k0, n0), from a matrix stored
// [n][k] (k contiguous)
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* m,
                                       int ld, int k0, int n0, int g, int t) {
  b[0] = word(m, ld, n0 + g, k0 + 2 * t);
  b[1] = word(m, ld, n0 + g, k0 + 2 * t + 8);
}

// cum = cumsum(dt a) over a chunk of cl16 steps (steps past cl have dt = 0),
// by one warp: consecutive steps per lane, then a shuffle scan of the lane
// totals
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cum,
                                             float a, int cl16, int lane) {
  const int per = (cl16 + 31) / 32, lo = lane * per;
  float run = 0.f;
  for (int j = 0; j < per; ++j)
    if (lo + j < cl16) {
      run += dts[lo + j] * a;
      cum[lo + j] = run;
    }
  float tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += y;
  }
  const float off = tot - run;         // sum over the lanes before this one
  for (int j = 0; j < per; ++j)
    if (lo + j < cl16) cum[lo + j] += off;
}

struct Dims {
  int L, H, P, N, cl, nc;
};

// 4 consecutive elements as floats (one 8-byte load of bf16, 16 of fp32)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

// A rows16 x cols16 tile of the global matrix at `src` (row stride `ld`
// elements; zero outside rows x cols, cols a multiple of 4) handed to
// store(r, c, v) four columns at a time.  Every load of the thread is
// issued before the first store, so their latencies overlap.
template <int NT, int MAXV, typename T, typename Store>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t ld,
                                      int rows, int cols, int rows16,
                                      int cols16, Store store) {
  constexpr int U = (MAXV + NT - 1) / NT;
  const int cv = cols16 / 4, nv = rows16 * cv;
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = threadIdx.x + u * NT, r = idx / cv, c = 4 * (idx % cv);
    v[u] = (idx < nv && r < rows && c < cols) ? load4(src + r * ld + c)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = threadIdx.x + u * NT;
    if (idx < nv) store(idx / cv, 4 * (idx % cv), v[u]);
  }
}

// The same tile handed over transposed: store(r, c, v) with v four
// columns of row r, but consecutive threads take consecutive rows (the
// caller writes a column-major copy, conflict-free in shared memory; each
// 32-byte sector a thread reads is read whole by it and its neighbours).
template <int NT, int MAXV, typename T, typename Store>
__device__ __forceinline__ void stage_t(const T* __restrict__ src, size_t ld,
                                        int rows, int cols, int rows16,
                                        int cols16, Store store) {
  constexpr int U = (MAXV + NT - 1) / NT;
  const int nv = rows16 * (cols16 / 4);
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = threadIdx.x + u * NT, r = idx % rows16,
              c = 4 * (idx / rows16);
    v[u] = (idx < nv && r < rows && c < cols) ? load4(src + r * ld + c)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int idx = threadIdx.x + u * NT;
    if (idx < nv) store(idx % rows16, 4 * (idx / rows16), v[u]);
  }
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// four values as bf16 at m[0..3] (hi), and their lo halves at l[0..3]
template <bool SPLIT>
__device__ __forceinline__ void put4(__nv_bfloat16* m, __nv_bfloat16* l,
                                     float4 v) {
  if constexpr (SPLIT) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split1(at(v, e), m[e], l[e]);
  } else {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(m) = u;
  }
}
// the same four values down a column: m[0], m[ld], m[2 ld], m[3 ld]
template <bool SPLIT>
__device__ __forceinline__ void put4_col(__nv_bfloat16* m, __nv_bfloat16* l,
                                         int ld, float4 v) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (SPLIT)
      split1(at(v, e), m[e * ld], l[e * ld]);
    else
      m[e * ld] = __float2bfloat16_rn(at(v, e));
  }
}

// x of head h, transposed: xT[p][j] (bf16 hi, and lo for fp32 x), zero
// past cl and P
template <typename T, int NT>
__device__ __forceinline__ void stage_xt(const T* __restrict__ X,
                                         __nv_bfloat16* xh, __nv_bfloat16* xl,
                                         const Dims& d, int b, int c, int h,
                                         int cl16, int P16) {
  stage_t<NT, CL_MAX * P_MAX / 4>(
      X + (((size_t)b * d.L + c * d.cl) * d.H + h) * d.P, (size_t)d.H * d.P,
      d.cl, d.P, cl16, P16, [&](int j, int p, float4 v) {
        put4_col<sizeof(T) == 4>(xh + p * LDJ + j, xl + p * LDJ + j, LDJ, v);
      });
}

// dt of the block's heads (zero past cl), dts[hh][j], and each head's
// cumulative sum cum[hh][j], scanned by warp hh; the block's warps must
// number at least HG.  Ends with the block synchronised.
template <int NT, int HG>
__device__ __forceinline__ void stage_dt(const float* __restrict__ DT,
                                         const float* __restrict__ A,
                                         float* dts, float* cum,
                                         const Dims& d, int b, int c, int h0,
                                         int cl16) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < (CL_MAX * HG + NT - 1) / NT; ++u) {
    const int idx = tid + u * NT, j = idx / HG, hh = idx % HG;
    if (j < cl16)
      dts[hh * CL_MAX + j] =
          (j < d.cl && h0 + hh < d.H)
              ? DT[((size_t)b * d.L + c * d.cl + j) * d.H + h0 + hh]
              : 0.f;
  }
  __syncthreads();
  const int warp = tid / 32;
  if (warp < HG && h0 + warp < d.H)
    chunk_cumsum(dts + warp * CL_MAX, cum + warp * CL_MAX, A[h0 + warp], cl16,
                 tid % 32);
  __syncthreads();
}

// ------------------------------------------------------------- launch 1
// Shared memory: BT [N_MAX][LDJ] and xT [P_MAX][LDJ] (hi, and lo for fp32),
// then dt, cum and w of the block's heads (HG x CL_MAX floats each).
template <typename T>
constexpr size_t state_smem() {
  return (sizeof(T) == 4 ? 2 : 1) * 2 *
             (size_t)(N_MAX > P_MAX ? N_MAX : P_MAX) * LDJ * 2 +
         3 * heads<T>() * CL_MAX * 4;
}

template <typename T>
__global__ void __launch_bounds__(32 * NW_STATE)
chunk_state(const T* __restrict__ X, const float* __restrict__ DT,
            const T* __restrict__ Bg, const float* __restrict__ A, Dims d,
            float* __restrict__ S, float* __restrict__ CLAST) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int NT = 32 * NW_STATE, MX = N_MAX > P_MAX ? N_MAX : P_MAX;
  constexpr int HG = heads<T>();
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* bth = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* btl = bth + MX * LDJ;             // fp32 only
  __nv_bfloat16* xh = bth + (SPLIT ? 2 : 1) * MX * LDJ;
  __nv_bfloat16* xl = xh + MX * LDJ;               // fp32 only
  float* dts = reinterpret_cast<float*>(xh + (SPLIT ? 2 : 1) * MX * LDJ);
  float* cum = dts + HG * CL_MAX;
  float* w = cum + HG * CL_MAX;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c = blockIdx.y, b = blockIdx.z, h0 = blockIdx.x * HG;
  const int cl16 = (d.cl + 15) / 16 * 16, P16 = (d.P + 15) / 16 * 16;
  const int N16 = (d.N + 15) / 16 * 16, N8 = (d.N + 7) / 8;

  // B of the chunk, transposed: BT[n][j], zero past cl and N
  stage_t<NT, CL_MAX * N_MAX / 4>(
      Bg + ((size_t)b * d.L + c * d.cl) * d.N, (size_t)d.N, d.cl, d.N, cl16,
      N16, [&](int j, int n, float4 v) {
        put4_col<SPLIT>(bth + n * LDJ + j, btl + n * LDJ + j, LDJ, v);
      });
  stage_dt<NT, HG>(DT, A, dts, cum, d, b, c, h0, cl16);
  // the state-update weights of every head: dt exp(cum_last - cum) <= dt
  for (int idx = tid; idx < HG * cl16; idx += NT) {
    const int hh = idx / cl16, j = idx % cl16;
    const float* cu = cum + hh * CL_MAX;
    w[hh * CL_MAX + j] = dts[hh * CL_MAX + j] * expf(cu[d.cl - 1] - cu[j]);
  }
  if (tid < HG && h0 + tid < d.H)
    CLAST[((size_t)b * d.nc + c) * d.H + h0 + tid] =
        cum[tid * CL_MAX + d.cl - 1];

  for (int hh = 0; hh < HG; ++hh) {
    const int h = h0 + hh;
    if (h >= d.H) break;
    __syncthreads();                   // the previous head's x^T read
    stage_xt<T, NT>(X, xh, xl, d, b, c, h, cl16, P16);
    __syncthreads();
    const float* wh = w + hh * CL_MAX;

    // S_c[p][n] = sum_j (x[j][p] w[j]) B[j][n]: warp owns p rows 16 warp..
    if (16 * warp < P16) {
      const int p0 = 16 * warp;
      float acc[N_MAX / 8][4] = {};
      for (int j0 = 0; j0 < cl16; j0 += 16) {
        // A = (x w)^T at (p0, j0): fp32, as hi + lo pairs
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = p0 + g + 8 * (r & 1), j = j0 + 2 * t + 8 * (r >> 1);
          float v0 = __bfloat162float(xh[p * LDJ + j]);
          float v1 = __bfloat162float(xh[p * LDJ + j + 1]);
          if constexpr (SPLIT) {
            v0 += __bfloat162float(xl[p * LDJ + j]);
            v1 += __bfloat162float(xl[p * LDJ + j + 1]);
          }
          split_pack(v0 * wh[j], v1 * wh[j + 1], ah[r], al[r]);
        }
#pragma unroll
        for (int nt = 0; nt < N_MAX / 8; ++nt) {
          if (nt >= N8) break;
          uint32_t bh[2];
          frag_b(bh, bth, LDJ, j0, 8 * nt, g, t);
          mma(acc[nt], al, bh);
          if constexpr (SPLIT) {
            uint32_t bl[2];
            frag_b(bl, btl, LDJ, j0, 8 * nt, g, t);
            mma(acc[nt], ah, bl);
          }
          mma(acc[nt], ah, bh);
        }
      }
      float* Sh = S + (((size_t)b * d.nc + c) * d.H + h) * d.P * d.N;
#pragma unroll
      for (int nt = 0; nt < N_MAX / 8; ++nt) {
        const int n = 8 * nt + 2 * t;
        if (n >= d.N) break;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + g + 8 * r;
          if (p < d.P)
            *reinterpret_cast<float2*>(&Sh[(size_t)p * d.N + n]) =
                make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- launch 2
// S[b][c][h] (the chunk's own contribution) -> the state entering chunk c;
// the final state to ST.  One element of one (batch, head) a thread; the
// loads of 8 chunks are issued before their stores.
__global__ void __launch_bounds__(256)
state_pass(float* __restrict__ S, const float* __restrict__ CLAST, Dims d,
           float* __restrict__ ST) {
  const int h = blockIdx.y, b = blockIdx.z, PN = d.P * d.N;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= PN) return;
  float run = 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += 8) {
    float own[8], dec[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c < d.nc) {
        own[u] = S[(((size_t)b * d.nc + c) * d.H + h) * PN + idx];
        dec[u] = expf(CLAST[((size_t)b * d.nc + c) * d.H + h]);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c < d.nc) {
        S[(((size_t)b * d.nc + c) * d.H + h) * PN + idx] = run;
        run = run * dec[u] + own[u];
      }
    }
  }
  ST[((size_t)b * d.H + h) * PN + idx] = run;
}

// ------------------------------------------------------------- launch 3
// Shared memory: C and B row-major [CL_MAX][LDN], xT [P_MAX][LDJ] (each hi,
// and lo for fp32), the incoming state [P_MAX][LDN] as hi + lo, then dt
// and cum of the block's heads (HG x CL_MAX floats each).
template <typename T>
constexpr size_t out_smem() {
  return ((sizeof(T) == 4 ? 2 : 1) *
              (2 * (size_t)CL_MAX * LDN + (size_t)P_MAX * LDJ) +
          2 * (size_t)P_MAX * LDN) * 2 +
         2 * heads<T>() * CL_MAX * 4;
}

template <typename T>
__global__ void __launch_bounds__(32 * NW_OUT)
chunk_out(const T* __restrict__ X, const float* __restrict__ DT,
          const T* __restrict__ Bg, const T* __restrict__ Cg,
          const float* __restrict__ A, const float* __restrict__ Dg, Dims d,
          const float* __restrict__ S, float* __restrict__ Y) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int NT = 32 * NW_OUT, K = SPLIT ? 2 : 1, HG = heads<T>();
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* ch = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* cl_ = ch + CL_MAX * LDN;          // fp32 only
  __nv_bfloat16* bh = ch + K * CL_MAX * LDN;
  __nv_bfloat16* bl = bh + CL_MAX * LDN;           // fp32 only
  __nv_bfloat16* xh = bh + K * CL_MAX * LDN;
  __nv_bfloat16* xl = xh + P_MAX * LDJ;            // fp32 only
  __nv_bfloat16* sh = xh + K * P_MAX * LDJ;
  __nv_bfloat16* sl = sh + P_MAX * LDN;
  float* dts = reinterpret_cast<float*>(sl + P_MAX * LDN);
  float* cum = dts + HG * CL_MAX;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c = blockIdx.y, b = blockIdx.z, h0 = blockIdx.x * HG;
  const int cl16 = (d.cl + 15) / 16 * 16, P16 = (d.P + 15) / 16 * 16;
  const int N16 = (d.N + 15) / 16 * 16, P8 = (d.P + 7) / 8;
  const int i0 = 16 * warp;            // the warp's 16 rows of the chunk
  const bool rows = i0 < cl16;

  // C and B of the chunk, row-major, zero past cl and N
  const size_t cb0 = ((size_t)b * d.L + c * d.cl) * d.N;
  stage<NT, CL_MAX * N_MAX / 4>(Cg + cb0, (size_t)d.N, d.cl, d.N, cl16, N16,
                                [&](int j, int n, float4 v) {
                                  put4<SPLIT>(ch + j * LDN + n,
                                              cl_ + j * LDN + n, v);
                                });
  stage<NT, CL_MAX * N_MAX / 4>(Bg + cb0, (size_t)d.N, d.cl, d.N, cl16, N16,
                                [&](int j, int n, float4 v) {
                                  put4<SPLIT>(bh + j * LDN + n,
                                              bl + j * LDN + n, v);
                                });
  stage_dt<NT, HG>(DT, A, dts, cum, d, b, c, h0, cl16);

  // C B^T on the warp's rows, causal columns only (j <= i0 + 15): in
  // registers for every head of the block
  float cb[CL_MAX / 8][4] = {};
  if (rows) {
    for (int k0 = 0; k0 < N16; k0 += 16) {
      uint32_t a[4], al[4];
      frag_a(a, ch, LDN, i0, k0, g, t);
      if constexpr (SPLIT) frag_a(al, cl_, LDN, i0, k0, g, t);
#pragma unroll
      for (int jt = 0; jt < CL_MAX / 8; ++jt) {
        if (8 * jt > i0 + 15) break;
        uint32_t bb[2];
        frag_b(bb, bh, LDN, k0, 8 * jt, g, t);
        if constexpr (SPLIT) {
          uint32_t bbl[2];
          frag_b(bbl, bl, LDN, k0, 8 * jt, g, t);
          mma(cb[jt], al, bb);
          mma(cb[jt], a, bbl);
        }
        mma(cb[jt], a, bb);
      }
    }
  }

  for (int hh = 0; hh < HG; ++hh) {
    const int h = h0 + hh;
    if (h >= d.H) break;
    __syncthreads();                   // the previous head's operands read
    stage_xt<T, NT>(X, xh, xl, d, b, c, h, cl16, P16);
    // the state entering the chunk, [p][n] as hi + lo (zero for chunk 0)
    stage<NT, P_MAX * N_MAX / 4>(
        S + (((size_t)b * d.nc + c) * d.H + h) * d.P * d.N, (size_t)d.N,
        c > 0 ? d.P : 0, d.N, P16, N16, [&](int p, int n, float4 v) {
          put4<true>(sh + p * LDN + n, sl + p * LDN + n, v);
        });
    __syncthreads();
    if (!rows) continue;
    const float* cu = cum + hh * CL_MAX;
    const float* dh = dts + hh * CL_MAX;

    const int ra = i0 + g, rb = ra + 8;            // the thread's two rows
    float y[P_MAX / 8][4] = {};
    // ---- exp(cum_i) (C state_in^T)[i][p]
    if (c > 0) {
      for (int k0 = 0; k0 < N16; k0 += 16) {
        uint32_t a[4], al[4];
        frag_a(a, ch, LDN, i0, k0, g, t);
        if constexpr (SPLIT) frag_a(al, cl_, LDN, i0, k0, g, t);
#pragma unroll
        for (int pt = 0; pt < P_MAX / 8; ++pt) {
          if (pt >= P8) break;
          uint32_t s1[2], s2[2];
          frag_b(s1, sh, LDN, k0, 8 * pt, g, t);
          frag_b(s2, sl, LDN, k0, 8 * pt, g, t);
          mma(y[pt], a, s2);
          if constexpr (SPLIT) mma(y[pt], al, s1);
          mma(y[pt], a, s1);
        }
      }
      const float ea = expf(cu[ra]), eb = expf(cu[rb]);
#pragma unroll
      for (int pt = 0; pt < P_MAX / 8; ++pt) {
        y[pt][0] *= ea;
        y[pt][1] *= ea;
        y[pt][2] *= eb;
        y[pt][3] *= eb;
      }
    }
    // ---- + M x, M built in registers from C B^T on the causal triangle
    const float ca = cu[ra], cbv = cu[rb];
#pragma unroll
    for (int kk = 0; kk < CL_MAX / 16; ++kk) {
      if (16 * kk > i0) break;
      float mv[8];                     // (ra, j) x4 then (rb, j) x4
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // e: column 16 kk + 2 t + (e & 1) + 8 (e >> 1), from tile 2 kk + e/2
        const int j = 16 * kk + 2 * t + (e & 1) + 8 * (e >> 1);
        const float* f = cb[2 * kk + (e >> 1)];
        const float dj = dh[j], cj = cu[j];
        mv[e] = j <= ra ? f[e & 1] * __expf(ca - cj) * dj : 0.f;
        mv[4 + e] = j <= rb ? f[2 + (e & 1)] * __expf(cbv - cj) * dj : 0.f;
      }
      uint32_t mh[4], ml[4];
      split_pack(mv[0], mv[1], mh[0], ml[0]);      // (ra, 2t..)
      split_pack(mv[4], mv[5], mh[1], ml[1]);      // (rb, 2t..)
      split_pack(mv[2], mv[3], mh[2], ml[2]);      // (ra, 2t+8..)
      split_pack(mv[6], mv[7], mh[3], ml[3]);      // (rb, 2t+8..)
#pragma unroll
      for (int pt = 0; pt < P_MAX / 8; ++pt) {
        if (pt >= P8) break;
        uint32_t x1[2];
        frag_b(x1, xh, LDJ, 16 * kk, 8 * pt, g, t);
        mma(y[pt], ml, x1);
        if constexpr (SPLIT) {
          uint32_t x2[2];
          frag_b(x2, xl, LDJ, 16 * kk, 8 * pt, g, t);
          mma(y[pt], mh, x2);
        }
        mma(y[pt], mh, x1);
      }
    }
    // ---- + D x, written once
    const float dsk = Dg[h];
#pragma unroll
    for (int pt = 0; pt < P_MAX / 8; ++pt) {
      const int p = 8 * pt + 2 * t;
      if (p >= d.P) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? rb : ra;
        if (i >= d.cl) continue;
        float x0 = __bfloat162float(xh[p * LDJ + i]);
        float x1 = __bfloat162float(xh[(p + 1) * LDJ + i]);
        if constexpr (SPLIT) {
          x0 += __bfloat162float(xl[p * LDJ + i]);
          x1 += __bfloat162float(xl[(p + 1) * LDJ + i]);
        }
        *reinterpret_cast<float2*>(
            &Y[(((size_t)b * d.L + c * d.cl + i) * d.H + h) * d.P + p]) =
            make_float2(y[pt][2 * r] + dsk * x0, y[pt][2 * r + 1] + dsk * x1);
      }
    }
  }
}

// Opts `kern` in to `bytes` of dynamic shared memory once per device (the
// call costs microseconds; a served prefill makes 45 calls); `done` is the
// caller's record, one per kernel.
template <typename Kern>
int opt_in(Kern kern, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bytes <= 48 * 1024 || (dev < 64 && done[dev])) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) done[dev] = true;
  return 0;
}

template <typename T>
int launch(const void* x, const float* dt, const void* B_, const void* C_,
           const float* A, const float* D, float* y, float* st,
           float* scratch, int B, int L, int H, int P, int N, int cl,
           cudaStream_t stream) {
  const Dims d{L, H, P, N, cl, L / cl};
  float* S = scratch;
  float* clast = S + (size_t)B * d.nc * H * P * N;
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(B_);
  const T* cp = static_cast<const T*>(C_);
  constexpr int HG = heads<T>();
  const dim3 grid((H + HG - 1) / HG, d.nc, B);
  static bool opted_state[64] = {}, opted_out[64] = {};
  if (int e = opt_in(chunk_state<T>, state_smem<T>(), opted_state)) return e;
  if (int e = opt_in(chunk_out<T>, out_smem<T>(), opted_out)) return e;
  chunk_state<T><<<grid, 32 * NW_STATE, state_smem<T>(), stream>>>(
      xp, dt, bp, A, d, S, clast);
  state_pass<<<dim3((P * N + 255) / 256, H, B), 256, 0, stream>>>(S, clast, d,
                                                                st);
  chunk_out<T><<<grid, 32 * NW_OUT, out_smem<T>(), stream>>>(
      xp, dt, bp, cp, A, D, d, S, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that `ssd_scan` needs: the per-chunk states
// (B, L/cl, H, P, N) and cum_last (B, L/cl, H).
extern "C" long long ssd_scan_scratch(int B, int L, int H, int P, int N,
                                      int cl) {
  const long long nc = cl > 0 ? L / cl : 0;
  return (long long)B * nc * H * ((long long)P * N + 1);
}

// Launches (three kernels) on `stream`, does not synchronise, allocates
// nothing.  x (B,L,H,P), B_/C_ (B,L,N) of one type (is_bf16 selects bf16,
// else fp32); dt (B,L,H), A/D (H,) fp32; y (B,L,H,P) and state (B,H,P,N)
// fp32; all contiguous, x, B_ and C_ 16-byte aligned; scratch of
// ssd_scan_scratch() floats.  cl, P and N must be multiples of 4 with
// cl <= 128, P <= 64, N <= 64, and L a multiple of cl.  Returns
// cudaGetLastError() (or the opt-in's error).
extern "C" int ssd_scan(const void* x, const void* dt, const void* B_,
                        const void* C_, const void* A, const void* D, void* y,
                        void* state, void* scratch, int B, int L, int H, int P,
                        int N, int cl, int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || cl <= 0 ||
      cl % 4 || P % 4 || N % 4 || L % cl || cl > CL_MAX || P > P_MAX ||
      N > N_MAX || B > 65535 || H > 65535 || L / cl > 65535 ||
      scratch == nullptr || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(B_) % 16 ||
      reinterpret_cast<uintptr_t>(C_) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *dtp = static_cast<const float*>(dt),
              *Ap = static_cast<const float*>(A),
              *Dp = static_cast<const float*>(D);
  float *yp = static_cast<float*>(y), *sp = static_cast<float*>(state),
        *wp = static_cast<float*>(scratch);
  return is_bf16 ? launch<__nv_bfloat16>(x, dtp, B_, C_, Ap, Dp, yp, sp, wp, B,
                                         L, H, P, N, cl, s)
                 : launch<float>(x, dtp, B_, C_, Ap, Dp, yp, sp, wp, B, L, H,
                                 P, N, cl, s);
}
