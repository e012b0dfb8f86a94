// RWKV-6 WKV recurrence (data-dependent per-channel decay) for sm_90a.
//
// Replaces: the Pallas TPU kernel `_wkv_kernel` / `wkv_scan` of the JAX
// package (src/repro/kernels/rwkv6_wkv/kernel.py).  There the grid is
// (B, H/hb, L/cl) with the chunk axis minor-most and run in order, and the
// (hb, K, V) state stays in VMEM scratch from one chunk to the next.  Blocks
// of a GPU grid run in no order, so here the chunk axis becomes a loop over
// all L steps inside one thread block, and the state stays in registers for
// the whole walk; it never reaches device memory until the final write.
//
// Semantics kept from the reference body: r/k/v/w (B,L,H,K) fp32, u (H,K)
// fp32; from S = 0, for every step t
//     out_t[v] = sum_k r_t[k] * (S[k][v] + u[k] * k_t[k] * v_t[v])
//     S[k][v]  = w_t[k] * S[k][v] + k_t[k] * v_t[v]
// y (B,L,H,K) and the final state (B,H,K,K) in fp32.  The output is taken
// as sum_k r S + v * (sum_k r u k): the same sum regrouped (fp32 FMAs), so
// no K x V temporary `S + u k v` is formed.
//
// Bound: per-step latency.  The compulsory bytes (one read of r, k, v, w,
// one write of y: 126 MB at B=1, L=1536, H=64, K=64, i.e. 0.04 ms at
// 3.35 TB/s) and operations (4*B*L*H*K*K, 1.6 GFLOP, 0.02 ms at the fp32
// FMA rate) are small; what bounds the kernel is that step t+1 needs the
// state of step t, a chain of L dependent updates.
//
// Design: the columns of the state are independent, so one block owns
// (b, h, VS = 8 columns), and the KS = 8 consecutive lanes of one column
// each hold K/8 rows of it (rows q, q+8, ...; interleaved, so the eight
// lanes read eight consecutive shared-memory words) in registers.  At the
// served shape that is B*H*K/8 = 512 blocks of 64 threads for 132 SMs.  The
// recurrence chain per step is one FMA per register; the output of a step
// is off that chain: a partial sum per lane and three xor-shuffles inside
// the column's 8 lanes.  r, k and w of a run of T = 2048/K steps (all K
// rows, which every column needs) and the block's 8 columns of v are staged
// in shared memory with 16-byte loads, and the run's outputs are written
// back from shared memory, 8 consecutive floats per step.  Every load of a
// step past L is masked.
#include <cuda_runtime.h>

namespace {

constexpr int KS = 8;            // lanes per state column
constexpr int VS = 8;            // state columns per block
constexpr int NT = KS * VS;      // 64 threads

template <int K>
__global__ void __launch_bounds__(NT)
wkv_kernel(const float* __restrict__ R, const float* __restrict__ Kg,
           const float* __restrict__ V, const float* __restrict__ W,
           const float* __restrict__ U, float* __restrict__ Y,
           float* __restrict__ ST, int L, int H) {
  constexpr int RK = K / KS;     // state rows per lane
  constexpr int T = 2048 / K;    // steps staged per run
  constexpr int K4 = K / 4;
  __shared__ __align__(16) float rs[T][K];
  __shared__ __align__(16) float ks[T][K];
  __shared__ __align__(16) float ws[T][K];
  __shared__ float vs[T][VS];
  __shared__ float ys[T][VS];

  const int tid = threadIdx.x;
  const int q = tid % KS, c = tid / KS;      // lane in the column, column
  constexpr int NVB = K / VS;
  const int vb = blockIdx.x % NVB;
  const int h = (blockIdx.x / NVB) % H;
  const int b = blockIdx.x / (NVB * H);
  const int v0 = vb * VS;
  const size_t step = (size_t)H * K;         // stride of one time step
  const size_t base = (size_t)b * L * step + (size_t)h * K;

  float S[RK], u[RK];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    S[i] = 0.f;
    u[i] = U[h * K + q + KS * i];
  }

  for (int t0 = 0; t0 < L; t0 += T) {
    const int n = min(T, L - t0);
    __syncthreads();                 // previous run's inputs and ys consumed
    for (int idx = tid; idx < T * K4; idx += NT) {
      const int tt = idx / K4, kk = (idx % K4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), bb = a, cc = a;
      if (tt < n) {
        const size_t g = base + (size_t)(t0 + tt) * step + kk;
        a = *reinterpret_cast<const float4*>(R + g);
        bb = *reinterpret_cast<const float4*>(Kg + g);
        cc = *reinterpret_cast<const float4*>(W + g);
      }
      *reinterpret_cast<float4*>(&rs[tt][kk]) = a;
      *reinterpret_cast<float4*>(&ks[tt][kk]) = bb;
      *reinterpret_cast<float4*>(&ws[tt][kk]) = cc;
    }
    for (int idx = tid; idx < T * VS; idx += NT) {
      const int tt = idx / VS, j = idx % VS;
      vs[tt][j] = tt < n ? V[base + (size_t)(t0 + tt) * step + v0 + j] : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vv = vs[tt][c];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int kk = q + KS * i;
        const float rr = rs[tt][kk], kt = ks[tt][kk];
        acc = fmaf(rr, S[i], acc);                 // r . S (before update)
        bonus = fmaf(rr * u[i], kt, bonus);        // r . (u * k)
        S[i] = fmaf(ws[tt][kk], S[i], kt * vv);    // w * S + k v
      }
      acc = fmaf(vv, bonus, acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (q == 0) ys[tt][c] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < n * VS; idx += NT) {
      const int tt = idx / VS, j = idx % VS;
      Y[base + (size_t)(t0 + tt) * step + v0 + j] = ys[tt][j];
    }
  }

  float* Sb = ST + ((size_t)b * H + h) * K * K;
#pragma unroll
  for (int i = 0; i < RK; ++i)
    Sb[(size_t)(q + KS * i) * K + v0 + c] = S[i];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, float* st, int B, int L, int H,
           cudaStream_t stream) {
  const long long blocks = (long long)B * H * (K / VS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wkv_kernel<K><<<(unsigned)blocks, NT, 0, stream>>>(r, k, v, w, u, y, st,
                                                     L, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.
// r/k/v/w and y (B,L,H,K), u (H,K), state (B,H,K,K), all contiguous fp32 with
// 16-byte aligned r/k/w.  K must be 16, 32, 64 or 128.  Returns
// cudaGetLastError().
extern "C" int wkv_scan(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* y, void* state,
                        int B, int L, int H, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float *R = static_cast<const float*>(r), *Kp = static_cast<const float*>(k),
              *Vp = static_cast<const float*>(v), *Wp = static_cast<const float*>(w),
              *Up = static_cast<const float*>(u);
  float *Y = static_cast<float*>(y), *ST = static_cast<float*>(state);
  switch (K) {
    case 16:  return launch<16>(R, Kp, Vp, Wp, Up, Y, ST, B, L, H, s);
    case 32:  return launch<32>(R, Kp, Vp, Wp, Up, Y, ST, B, L, H, s);
    case 64:  return launch<64>(R, Kp, Vp, Wp, Up, Y, ST, B, L, H, s);
    case 128: return launch<128>(R, Kp, Vp, Wp, Up, Y, ST, B, L, H, s);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
