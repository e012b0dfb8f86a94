// RWKV-6 WKV recurrence (data-dependent per-channel decay) for sm_90a: the
// chunks' own states in parallel, a short state pass, then each chunk's
// exact step walk from its true incoming state.
//
// Replaces: the Pallas TPU kernel `_wkv_kernel` / `wkv_scan` of the JAX
// package (src/repro/kernels/rwkv6_wkv/kernel.py).  There the grid is
// (B, H/hb, L/cl) with the chunk axis minor-most and run in order, and the
// (hb, K, V) state stays in VMEM scratch from one chunk to the next.  Blocks
// of a GPU grid run in no order, so here the carried state is taken apart:
// the state entering a chunk is the earlier chunks' own states, decayed and
// summed in order by a short pass.
//
// Semantics kept from the reference body: r/k/v/w (B,L,H,K) fp32, u (H,K)
// fp32; from S = 0, for every step t
//     out_t[v] = sum_k r_t[k] * (S[k][v] + u[k] * k_t[k] * v_t[v])
//     S[k][v]  = w_t[k] * S[k][v] + k_t[k] * v_t[v]
// y (B,L,H,K) and the final state (B,H,K,K) in fp32.
//
// Bound: bytes.  One read of r, k, v, w and one write of y and the state
// is 126 MB at B=1, L=1536, H=64, K=64: 0.038 ms at 3.35 TB/s; the
// operations (4*B*L*H*K*K, 1.6 GFLOP) take 0.024 ms at the fp32 FMA rate.
// The true chain from step t to t+1 is one FMA per state element; what a
// single walk over all L steps pays is its depth (L steps in order, too few
// blocks to fill the card) and the overhead of each step.
//
// The three launches of one call.  C is the kernel's own chunk, a multiple
// of T = 8 steps chosen by the wrapper (the reference's `chunk` only
// shapes the modeled burst list); nc = ceil(L / C):
//   1. `chunk_state`, one block per (column block, head, chunk c < nc-1,
//      batch): the chunk's own state from a zero state,
//      S_c = sum_s (k_s * prod_{t>s in c} w_t) v_s^T, walked backwards, and
//      its total decay W_c = prod of the chunk's w (a K-vector), to scratch;
//   2. `state_pass`, one thread per (batch, head, k, v): from S_in(0) = 0,
//      S_in(c+1) = W_c[k] S_in(c) + S_c, nc-1 steps of one FMA, leaving
//      S_in(c+1) in S_c's slot;
//   3. `chunk_out`, one block per (column block, head, chunk, batch): the
//      reference's step recurrence over the chunk's <= C steps from
//      S_in(c), y written once; the last chunk's blocks write the final
//      state.
// Nothing divides by a decay and no exp(-cumsum log w) is formed: the
// products in W_c are <= 1 and may underflow to 0, which is right.  Only
// S_in is summed in another order than the reference's; y is the
// reference's step arithmetic from there, its output taken as
// sum_k r S + v * sum_k r u k (the same sum regrouped).  Nothing is carried
// from one block to another inside a launch; the stream orders the three.
// Sequential depth: C + (nc-1) + C steps instead of L.  The price is bytes:
// k, w and v are read twice and the chunk states written, passed and read,
// about 240 MB at the shape above with C = 128 (0.072 ms at 3.35 TB/s).
//
// Block: VB = min(K, 64) state columns; a thread holds a register tile of
// 8 consecutive rows x 8 columns (4 x 4 at K = 16, 8 x 4 at K = 32), so
// each r, k and w value read from shared memory serves eight columns and
// each v value eight rows.  Shared memory delivers 128 bytes a clock to an
// SM's registers: a 16 x 2 tile would read 50 floats for 96 FP operations
// a step, past that rate; 8 x 8 reads 32 for 192, about the FP32 pipe's
// own rate.  A step's per-thread partial of out goes to shared memory; each
// run of T steps is then reduced over the row groups once, r.(u*k) of each
// step added, and written with 16-byte stores.  The inputs of run j+1 are
// in flight (cp.async, two buffers) while run j is walked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wkv {

constexpr int T = 8;      // steps of one staged run

// a block's state columns, and a thread's register tile: RK rows x VC
// columns (8 x 8 from K = 64 on)
template <int K>
__host__ __device__ constexpr int VB() { return K < 64 ? K : 64; }
template <int K>
__host__ __device__ constexpr int RK() { return K < 32 ? 4 : 8; }
template <int K>
__host__ __device__ constexpr int VC() { return K < 64 ? 4 : 8; }
template <int K>
__host__ __device__ constexpr int NRG() { return K / RK<K>(); }
template <int K>
__host__ __device__ constexpr int NCG() { return VB<K>() / VC<K>(); }
template <int K>
__host__ __device__ constexpr int NT() { return NRG<K>() * NCG<K>(); }
// floats of one staging buffer: k, w [T][K], v [T][VB], and r [T][K] when
// the launch writes y
template <int K, bool OUT>
__host__ __device__ constexpr int BUF() {
  return T * ((OUT ? 3 : 2) * K + VB<K>());
}
// dynamic shared memory of a launch: two buffers, and for the output launch
// the step partials [T][NRG][VB], r.(u*k) partials [2][T][NRG] and u [K]
template <int K, bool OUT>
__host__ __device__ constexpr size_t smem_bytes() {
  return 4 * (2 * (size_t)BUF<K, OUT>() +
              (OUT ? (size_t)T * NRG<K>() * VB<K>() + 2 * T * NRG<K>() + K
                   : 0));
}

struct Args {
  const float *R, *Kg, *V, *W, *U;
  float *Y, *ST;
  float *S, *WC;      // scratch: (B, nc-1, H, K, K) and (B, nc-1, H, K)
  int L, H, C, nc;
  int vvec;           // v starts on a 16-byte boundary
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(s)),
               "l"(g));
}
__device__ __forceinline__ void cp4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr(s)),
               "l"(g));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N consecutive floats, 16-byte aligned, to and from registers
template <int N>
__device__ __forceinline__ void ld4(float (&x)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    x[i] = q.x, x[i + 1] = q.y, x[i + 2] = q.z, x[i + 3] = q.w;
  }
}
template <int N>
__device__ __forceinline__ void st4(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

// Starts the copies of `nt` steps of `n4` float4s each (row `src`, steps
// `step` apart) into `dst` ([T][4 n4]).
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          size_t step, int nt, int n4,
                                          int tid, int nthreads) {
  for (int idx = tid; idx < nt * n4; idx += nthreads) {
    const int tt = idx / n4, e = 4 * (idx % n4);
    cp16(dst + tt * 4 * n4 + e, src + (size_t)tt * step + e);
  }
}

// Starts the copies of `nt` steps from global offset g0 (step 0 of the run,
// head h's row) into `buf` (k, w [T][K], v [T][VB], r [T][K] if OUT), as
// one commit group.
template <int K, bool OUT>
__device__ __forceinline__ void stage(float* buf, const Args& a, size_t g0,
                                      size_t step, int nt, int v0, int tid) {
  constexpr int K4 = K / 4, VBk = VB<K>(), NTk = NT<K>();
  float* vs = buf + 2 * T * K;
  copy_rows(buf, a.Kg + g0, step, nt, K4, tid, NTk);
  copy_rows(buf + T * K, a.W + g0, step, nt, K4, tid, NTk);
  if (OUT) copy_rows(vs + T * VBk, a.R + g0, step, nt, K4, tid, NTk);
  if (a.vvec) {
    copy_rows(vs, a.V + g0 + v0, step, nt, VBk / 4, tid, NTk);
  } else {
    for (int idx = tid; idx < nt * VBk; idx += NTk) {
      const int tt = idx / VBk, e = idx % VBk;
      cp4(vs + tt * VBk + e, a.V + g0 + (size_t)tt * step + v0 + e);
    }
  }
  cp_commit();
}

// bp[tt][g] = sum over row group g of r u k, for the run's nt steps
template <int K>
__device__ __forceinline__ void bonus(const float* buf, const float* us,
                                      float* bp, int nt, int tid) {
  constexpr int RKk = RK<K>(), NRGk = NRG<K>();
  const float* ks = buf;
  const float* rs = buf + 2 * T * K + T * VB<K>();
  for (int idx = tid; idx < nt * NRGk; idx += NT<K>()) {
    const int tt = idx / NRGk, r0 = (idx % NRGk) * RKk;
    float rr[RKk], kk[RKk], uu[RKk];
    ld4(rr, rs + tt * K + r0);
    ld4(kk, ks + tt * K + r0);
    ld4(uu, us + r0);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < RKk; ++i) s = fmaf(rr[i] * uu[i], kk[i], s);
    bp[idx] = s;
  }
}

// y of a run's nt steps: the row groups' partials plus v * r.(u*k)
template <int K>
__device__ __forceinline__ void reduce(const float* buf, const float* part,
                                       const float* bp, float* y, size_t step,
                                       int nt, int tid) {
  constexpr int VBk = VB<K>(), V4 = VBk / 4, NRGk = NRG<K>();
  const float* vs = buf + 2 * T * K;
  for (int idx = tid; idx < nt * V4; idx += NT<K>()) {
    const int tt = idx / V4, e = 4 * (idx % V4);
    float bon = 0.f;
#pragma unroll
    for (int g = 0; g < NRGk; ++g) bon += bp[tt * NRGk + g];
    const float4 vv = *reinterpret_cast<const float4*>(vs + tt * VBk + e);
    float4 o = make_float4(bon * vv.x, bon * vv.y, bon * vv.z, bon * vv.w);
#pragma unroll
    for (int g = 0; g < NRGk; ++g) {
      const float4 p =
          *reinterpret_cast<const float4*>(part + (tt * NRGk + g) * VBk + e);
      o.x += p.x, o.y += p.y, o.z += p.z, o.w += p.w;
    }
    *reinterpret_cast<float4*>(y + (size_t)tt * step + e) = o;
  }
}

// Where a block works: head h's column block vb (VB state columns from v0)
// of chunk c of batch b; thread tid holds rows row0.. and columns col..
template <int K>
struct Tile {
  int tid, cg, rg, vb, h, c, b, v0, col, row0, n;
  size_t step, base, ncs;
  __device__ Tile(const Args& a) {
    tid = threadIdx.x, cg = tid % NCG<K>(), rg = tid / NCG<K>();
    vb = blockIdx.x % (K / VB<K>()), h = blockIdx.x / (K / VB<K>());
    c = blockIdx.y, b = blockIdx.z;
    v0 = vb * VB<K>(), col = v0 + cg * VC<K>(), row0 = rg * RK<K>();
    n = min(a.C, a.L - c * a.C);               // steps of this chunk
    step = (size_t)a.H * K;                    // stride of one step
    base = ((size_t)b * a.L + (size_t)c * a.C) * step + (size_t)h * K;
    ncs = a.nc - 1;
  }
};

// ------------------------------------------------------------- launch 1
// Chunk c's own state S_c = sum_s (k_s * prod_{t>s in c} w_t) v_s^T and
// total decay W_c.  The walk runs backwards over the chunk (runs and steps
// in reverse) carrying D = the product of the decays after step s, so a
// step costs RK multiplies for k D, RK for D w and RK x VC FMAs, against
// 2 RK VC for the forward walk S = w S + k v: the same sum, each term's
// decays multiplied first.  D <= 1 never overflows.
template <int K>
__global__ void __launch_bounds__(NT<K>()) chunk_state(Args a) {
  constexpr int VBk = VB<K>(), RKk = RK<K>(), VCk = VC<K>();
  constexpr int B1 = BUF<K, false>();
  extern __shared__ __align__(16) float sm[];
  const Tile<K> p(a);
  const int nr = a.C / T;                      // full: c < nc - 1
  float S[RKk][VCk], D[RKk];
#pragma unroll
  for (int i = 0; i < RKk; ++i) {
    D[i] = 1.f;
#pragma unroll
    for (int j = 0; j < VCk; ++j) S[i][j] = 0.f;
  }
  stage<K, false>(sm, a, p.base + (size_t)(nr - 1) * T * p.step, p.step, T,
                  p.v0, p.tid);
  for (int j = 0; j < nr; ++j) {
    const float* ks = sm + (j & 1) * B1;
    const float* ws = ks + T * K;
    const float* vs = ws + T * K;
    cp_wait();
    __syncthreads();   // run j visible; run j-1 walked by every thread
    if (j + 1 < nr)
      stage<K, false>(sm + ((j + 1) & 1) * B1, a,
                      p.base + (size_t)(nr - 2 - j) * T * p.step, p.step, T,
                      p.v0, p.tid);
    for (int tt = T - 1; tt >= 0; --tt) {
      float kk[RKk], ww[RKk], vv[VCk];
      ld4(kk, ks + tt * K + p.row0);
      ld4(ww, ws + tt * K + p.row0);
      ld4(vv, vs + tt * VBk + p.cg * VCk);
#pragma unroll
      for (int i = 0; i < RKk; ++i) {
        const float kd = kk[i] * D[i];
        D[i] *= ww[i];
#pragma unroll
        for (int jj = 0; jj < VCk; ++jj) S[i][jj] = fmaf(kd, vv[jj], S[i][jj]);
      }
    }
  }
  const size_t slot = (p.b * p.ncs + p.c) * a.H + p.h;
  float* dst = a.S + slot * K * K;
#pragma unroll
  for (int i = 0; i < RKk; ++i)
    st4(dst + (size_t)(p.row0 + i) * K + p.col, S[i]);
  if (p.vb == 0 && p.cg == 0) st4(a.WC + slot * K + p.row0, D);
}

// ------------------------------------------------------------- launch 2
// S[b][c][h] (chunk c's own state) -> the state entering chunk c+1, one
// element of one (batch, head) a thread; the loads of 8 chunks are issued
// before their stores.
__global__ void __launch_bounds__(256)
state_pass(float* __restrict__ S, const float* __restrict__ WC, int ncs,
           int H, int K) {
  const int h = blockIdx.y, b = blockIdx.z, KK = K * K;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= KK) return;
  const int row = idx / K;
  float run = 0.f;
  for (int c0 = 0; c0 < ncs; c0 += 8) {
    float own[8], dec[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const size_t bc = (size_t)b * ncs + c0 + u;
      if (c0 + u < ncs) {
        own[u] = S[(bc * H + h) * KK + idx];
        dec[u] = WC[(bc * H + h) * K + row];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < ncs) {
        run = fmaf(dec[u], run, own[u]);
        S[(((size_t)b * ncs + c0 + u) * H + h) * KK + idx] = run;
      }
    }
  }
}

// ------------------------------------------------------------- launch 3
// The reference's step walk over chunk c from S_in(c) (zero for c = 0):
// y of every step, and the final state from the last chunk.
template <int K>
__global__ void __launch_bounds__(NT<K>()) chunk_out(Args a) {
  constexpr int VBk = VB<K>(), RKk = RK<K>(), VCk = VC<K>(), NRGk = NRG<K>();
  constexpr int B1 = BUF<K, true>();
  extern __shared__ __align__(16) float sm[];
  float* part = sm + 2 * B1;                 // [T][NRG][VB]
  float* bp = part + T * NRGk * VBk;         // [2][T][NRG]
  float* us = bp + 2 * T * NRGk;             // [K]
  const Tile<K> p(a);
  const int nr = (p.n + T - 1) / T;
  const size_t KK = (size_t)K * K;

  float S[RKk][VCk];
#pragma unroll
  for (int i = 0; i < RKk; ++i) {
    if (p.c > 0)
      ld4(S[i], a.S + ((p.b * p.ncs + p.c - 1) * a.H + p.h) * KK +
                    (size_t)(p.row0 + i) * K + p.col);
    else
#pragma unroll
      for (int j = 0; j < VCk; ++j) S[i][j] = 0.f;
  }
  for (int i = p.tid; i < K; i += NT<K>()) us[i] = a.U[p.h * K + i];
  float* y = a.Y + p.base + p.v0;

  stage<K, true>(sm, a, p.base, p.step, min(T, p.n), p.v0, p.tid);
  for (int j = 0; j < nr; ++j) {
    const float* cur = sm + (j & 1) * B1;
    const int nt = min(T, p.n - j * T);
    cp_wait();
    __syncthreads();   // run j visible; run j-1 walked by every thread
    bonus<K>(cur, us, bp + (j & 1) * T * NRGk, nt, p.tid);
    if (j > 0)
      reduce<K>(sm + ((j - 1) & 1) * B1, part, bp + ((j - 1) & 1) * T * NRGk,
                y + (size_t)(j - 1) * T * p.step, p.step, T, p.tid);
    __syncthreads();   // part and run j-1's buffer free
    if (j + 1 < nr)
      stage<K, true>(sm + ((j + 1) & 1) * B1, a,
                     p.base + (size_t)(j + 1) * T * p.step, p.step,
                     min(T, p.n - (j + 1) * T), p.v0, p.tid);
    const float* ks = cur;
    const float* ws = ks + T * K;
    const float* vs = ws + T * K;
    const float* rs = vs + T * VBk;
    for (int tt = 0; tt < nt; ++tt) {
      float kk[RKk], ww[RKk], vv[VCk], rr[RKk], o[VCk];
      ld4(kk, ks + tt * K + p.row0);
      ld4(ww, ws + tt * K + p.row0);
      ld4(vv, vs + tt * VBk + p.cg * VCk);
      ld4(rr, rs + tt * K + p.row0);
#pragma unroll
      for (int jj = 0; jj < VCk; ++jj) {       // r . S, before the update
        o[jj] = rr[0] * S[0][jj];
#pragma unroll
        for (int i = 1; i < RKk; ++i) o[jj] = fmaf(rr[i], S[i][jj], o[jj]);
      }
      st4(part + (tt * NRGk + p.rg) * VBk + p.cg * VCk, o);
#pragma unroll
      for (int i = 0; i < RKk; ++i)
#pragma unroll
        for (int jj = 0; jj < VCk; ++jj)
          S[i][jj] = fmaf(ww[i], S[i][jj], kk[i] * vv[jj]);
    }
  }
  __syncthreads();
  const int j = nr - 1;
  reduce<K>(sm + (j & 1) * B1, part, bp + (j & 1) * T * NRGk,
            y + (size_t)j * T * p.step, p.step, p.n - j * T, p.tid);
  if (p.c != a.nc - 1) return;
  float* dst = a.ST + ((size_t)p.b * a.H + p.h) * KK;
#pragma unroll
  for (int i = 0; i < RKk; ++i)
    st4(dst + (size_t)(p.row0 + i) * K + p.col, S[i]);
}

// Opts `kern` in to `bytes` of dynamic shared memory once per device;
// `done` is the caller's record, one per kernel.
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

template <int K>
int launch(const Args& a, int B, cudaStream_t s) {
  constexpr int NVB = K / VB<K>();
  static bool opted_state[64] = {}, opted_out[64] = {};
  if (int e = opt_in(chunk_state<K>, smem_bytes<K, false>(), opted_state))
    return e;
  if (int e = opt_in(chunk_out<K>, smem_bytes<K, true>(), opted_out))
    return e;
  if (a.nc > 1) {
    chunk_state<K><<<dim3(NVB * a.H, a.nc - 1, B), NT<K>(),
                     smem_bytes<K, false>(), s>>>(a);
    state_pass<<<dim3((K * K + 255) / 256, a.H, B), 256, 0, s>>>(
        a.S, a.WC, a.nc - 1, a.H, K);
  }
  chunk_out<K><<<dim3(NVB * a.H, a.nc, B), NT<K>(), smem_bytes<K, true>(),
                 s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wkv
}  // namespace

// Launches (one kernel for L <= C, else three) on `stream`, does not
// synchronise, allocates nothing.  r/k/v/w and y (B,L,H,K), u (H,K), state
// (B,H,K,K), all contiguous fp32 with 16-byte aligned r/k/w; scratch holds
// the chunks' own states (B, nc-1, H, K, K), then their total decays
// (B, nc-1, H, K), nc = ceil(L / C) (null when L <= C).  K must be 16,
// 32, 64 or 128 and C a positive multiple of T = 8.  Returns
// cudaGetLastError() (or the opt-in's error).
extern "C" int wkv_scan(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* y, void* state,
                        void* scratch, int B, int L, int H, int K, int C,
                        void* stream) {
  using wkv::Args;
  if (B <= 0 || L <= 0 || H <= 0 || C <= 0 || C % wkv::T || B > 65535 ||
      (L + C - 1) / C > 65535 || (L > C && scratch == nullptr) ||
      reinterpret_cast<uintptr_t>(r) % 16 ||
      reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (L + C - 1) / C;
  float* S = static_cast<float*>(scratch);
  Args a{static_cast<const float*>(r), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(w),
         static_cast<const float*>(u), static_cast<float*>(y),
         static_cast<float*>(state), S,
         S ? S + (size_t)B * (nc - 1) * H * K * K : nullptr,
         L, H, C, nc, reinterpret_cast<uintptr_t>(v) % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16:  return wkv::launch<16>(a, B, s);
    case 32:  return wkv::launch<32>(a, B, s);
    case 64:  return wkv::launch<64>(a, B, s);
    case 128: return wkv::launch<128>(a, B, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
