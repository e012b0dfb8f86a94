// Mamba-2 SSD chunked scan (state-space dual form, with the D skip) for
// sm_90a.
//
// Replaces: the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` of the JAX
// package (src/repro/kernels/mamba2_scan/kernel.py).  There the grid is
// (B, H/hb, L/cl) with the chunk axis minor-most and run in order, and the
// (hb, P, N) state stays in VMEM scratch between chunks.  Blocks of a GPU
// grid run in no order, so here one thread block owns one (batch, head) and
// walks the chunks in a loop, with the (P, N) state in shared memory for
// the whole walk.
//
// Semantics kept from the reference body, per chunk of cl steps (fp32
// maths on upcast x, B, C; dt, A, D fp32):
//     cum  = cumsum(dt * A)                                  (A < 0: cum falls)
//     M    = (C B^T)[i][j] * exp(cum_i - cum_j) * dt_j        for j <= i, else 0
//     y    = M x + exp(cum) * (C state^T) + D x
//     state = state * exp(cum_last) + (x * dt * exp(cum_last - cum))^T B
// Every exponent is <= 0.  Entries above the diagonal are set to zero
// explicitly and their exponential is never taken, so no sentinel value
// reaches exp().  y (B,L,H,P) and the final state (B,H,P,N) in fp32.
//
// Bound: operations.  At zamba2-2.7b's width (cl=128, P=N=64, H=80) one
// chunk of one head needs cl (cl+1) N (C B^T on the causal triangle) +
// cl (cl+1) P (M x, likewise) + 4 cl P N (C state^T and the state update)
// FLOPs against 48 KB of compulsory traffic in bf16; with fp32 FMAs the
// yardstick is the fp32 FMA rate.  This kernel recomputes C B^T per head
// (the B and C of a chunk are shared by all heads), and skips the
// microtiles above the diagonal of both causal products.
//
// Design: 256 threads; every product is cut into 4x4 output microtiles,
// one per thread per pass, fp32 FMAs from shared memory.  B and C are held
// transposed ([n][step], 16-byte reads along the step axis), x row-major
// ([step][p], 16-byte reads along p), M row-major, the state transposed
// ([n][p]).  Shared memory at cl=128, N=P=64: 188,928 bytes, so one block
// per SM; the grid is (H, B), 80 blocks at the served shape.  The cumulative
// sum is one warp's scan (8 consecutive steps per lane, then a shuffle
// scan of the lane totals).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int SMEM_MAX = 232448;       // what a block may opt into on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Layout {
  int ldt, ldx, ldm, lds;              // row strides (floats), multiples of 4
  size_t bt, ct, xs, ms, st, cum, dts, wts, total;   // offsets (floats)
};

__host__ __device__ inline Layout layout(int cl, int P, int N) {
  Layout g;
  g.ldt = cl + 4;                      // Bt, Ct: [N][cl+4]
  g.ldx = P + 4;                       // Xs: [cl][P+4]
  g.ldm = cl + 4;                      // Ms: [cl][cl+4]
  g.lds = P + 4;                       // St: [N][P+4]  (state transposed)
  g.bt = 0;
  g.ct = g.bt + (size_t)N * g.ldt;
  g.xs = g.ct + (size_t)N * g.ldt;
  g.ms = g.xs + (size_t)cl * g.ldx;
  g.st = g.ms + (size_t)cl * g.ldm;
  g.cum = g.st + (size_t)N * g.lds;
  g.dts = g.cum + cl;
  g.wts = g.dts + cl;
  g.total = g.wts + cl;
  return g;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void unpack(float4 v, float a[4]) {
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ X, const float* __restrict__ DT,
           const T* __restrict__ Bg, const T* __restrict__ Cg,
           const float* __restrict__ A, const float* __restrict__ Dg,
           float* __restrict__ Y, float* __restrict__ ST, int L, int H, int P,
           int N, int cl) {
  extern __shared__ __align__(16) float smem[];
  const Layout g = layout(cl, P, N);
  float* Bt = smem + g.bt;
  float* Ct = smem + g.ct;
  float* Xs = smem + g.xs;
  float* Ms = smem + g.ms;
  float* St = smem + g.st;
  float* cum = smem + g.cum;
  float* dts = smem + g.dts;
  float* wts = smem + g.wts;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a = A[h], dskip = Dg[h];
  const int nt = cl / 4, np4 = P / 4, nn4 = N / 4;

  for (int idx = tid; idx < N * g.lds; idx += NT) St[idx] = 0.f;

  for (int t0 = 0; t0 < L; t0 += cl) {
    __syncthreads();                   // previous chunk's operands consumed
    // ---- stage the chunk: B, C transposed; x row-major; dt
    for (int idx = tid; idx < cl * N; idx += NT) {
      const int i = idx / N, n = idx % N;
      const bool in = t0 + i < L;
      const size_t gi = ((size_t)b * L + t0 + i) * N + n;
      Bt[n * g.ldt + i] = in ? to_f32(Bg[gi]) : 0.f;
      Ct[n * g.ldt + i] = in ? to_f32(Cg[gi]) : 0.f;
    }
    for (int idx = tid; idx < cl * P; idx += NT) {
      const int i = idx / P, p = idx % P;
      Xs[i * g.ldx + p] =
          t0 + i < L ? to_f32(X[(((size_t)b * L + t0 + i) * H + h) * P + p]) : 0.f;
    }
    for (int i = tid; i < cl; i += NT)
      dts[i] = t0 + i < L ? DT[((size_t)b * L + t0 + i) * H + h] : 0.f;
    __syncthreads();

    // ---- cum = cumsum(dt * A): one warp, consecutive steps per lane
    if (tid < 32) {
      const int per = (cl + 31) / 32, lo = tid * per;
      float run = 0.f;
      for (int j = 0; j < per; ++j)
        if (lo + j < cl) { run += dts[lo + j] * a; cum[lo + j] = run; }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, tot, o);
        if (tid >= o) tot += y;
      }
      const float off = tot - run;     // sum over the lanes before this one
      for (int j = 0; j < per; ++j)
        if (lo + j < cl) cum[lo + j] += off;
    }
    __syncthreads();

    // ---- M on the causal triangle, and the state-update weights
    const float c_last = cum[cl - 1];
    for (int i = tid; i < cl; i += NT) wts[i] = dts[i] * expf(c_last - cum[i]);
    for (int tile = tid; tile < nt * nt; tile += NT) {
      const int i0 = (tile / nt) * 4, j0 = (tile % nt) * 4;
      if (j0 > i0 + 3) continue;       // wholly above the diagonal: never read
      float s[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cr[4], br[4];
        unpack(ld4(&Ct[n * g.ldt + i0]), cr);
        unpack(ld4(&Bt[n * g.ldt + j0]), br);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cr[r], br[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + r, j = j0 + c;
          Ms[i * g.ldm + j] =
              j <= i ? s[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();

    // ---- y = M x + exp(cum) * (C state^T) + D x
    for (int tile = tid; tile < nt * np4; tile += NT) {
      const int i0 = (tile / np4) * 4, p0 = (tile % np4) * 4;
      float acc[4][4] = {}, inter[4][4] = {};
      const int jmax = min(cl, i0 + 4);          // M is zero past the diagonal
      for (int j = 0; j < jmax; ++j) {
        float xr[4];
        unpack(ld4(&Xs[j * g.ldx + p0]), xr);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float m = Ms[(i0 + r) * g.ldm + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(m, xr[c], acc[r][c]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float cr[4], sr[4];
        unpack(ld4(&Ct[n * g.ldt + i0]), cr);
        unpack(ld4(&St[n * g.lds + p0]), sr);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) inter[r][c] = fmaf(cr[r], sr[c], inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (t0 + i >= L) continue;
        const float e = expf(cum[i]);
        float xr[4];
        unpack(ld4(&Xs[i * g.ldx + p0]), xr);
        float4 o;
        o.x = acc[r][0] + e * inter[r][0] + dskip * xr[0];
        o.y = acc[r][1] + e * inter[r][1] + dskip * xr[1];
        o.z = acc[r][2] + e * inter[r][2] + dskip * xr[2];
        o.w = acc[r][3] + e * inter[r][3] + dskip * xr[3];
        *reinterpret_cast<float4*>(
            &Y[(((size_t)b * L + t0 + i) * H + h) * P + p0]) = o;
      }
    }
    __syncthreads();                   // every read of the old state done

    // ---- state (transposed, [n][p]) = state * exp(cum_last) + B^T (w x)
    const float decay = expf(c_last);
    for (int tile = tid; tile < nn4 * np4; tile += NT) {
      const int n0 = (tile / np4) * 4, p0 = (tile % np4) * 4;
      float upd[4][4] = {};
      for (int j = 0; j < cl; ++j) {
        float xr[4];
        unpack(ld4(&Xs[j * g.ldx + p0]), xr);
        const float wj = wts[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bb = Bt[(n0 + r) * g.ldt + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) upd[r][c] = fmaf(bb, xr[c] * wj, upd[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* s = &St[(n0 + r) * g.lds + p0 + c];
          *s = *s * decay + upd[r][c];
        }
    }
  }
  __syncthreads();

  float* Sb = ST + ((size_t)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += NT) {
    const int p = idx / N, n = idx % N;
    Sb[idx] = St[n * g.lds + p];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const void* B_, const void* C_,
           const float* A, const float* D, float* y, float* st, int B, int L,
           int H, int P, int N, int cl, cudaStream_t stream) {
  const size_t smem = layout(cl, P, N).total * sizeof(float);
  if (smem > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ssd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(B_),
      static_cast<const T*>(C_), A, D, y, st, L, H, P, N, cl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.
// x (B,L,H,P), B_/C_ (B,L,N) of one type (is_bf16 selects bf16, else fp32);
// dt (B,L,H), A/D (H,) fp32; y (B,L,H,P) and state (B,H,P,N) fp32; all
// contiguous, y 16-byte aligned.  cl, P and N must be multiples of 4, L a
// multiple of cl, and the shared memory of layout(cl, P, N) at most
// 232,448 bytes.  Returns cudaGetLastError() (or the opt-in's error).
extern "C" int ssd_scan(const void* x, const void* dt, const void* B_,
                        const void* C_, const void* A, const void* D, void* y,
                        void* state, int B, int L, int H, int P, int N, int cl,
                        int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0 || cl <= 0 ||
      cl % 4 || P % 4 || N % 4 || L % cl || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *dtp = static_cast<const float*>(dt),
              *Ap = static_cast<const float*>(A), *Dp = static_cast<const float*>(D);
  float *yp = static_cast<float*>(y), *sp = static_cast<float*>(state);
  return is_bf16 ? launch<__nv_bfloat16>(x, dtp, B_, C_, Ap, Dp, yp, sp, B, L,
                                         H, P, N, cl, s)
                 : launch<float>(x, dtp, B_, C_, Ap, Dp, yp, sp, B, L, H, P, N,
                                 cl, s);
}
