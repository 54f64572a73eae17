// Mamba-1 selective-scan forward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py:46
// (ssm_scan_fwd / _kernel): for each batch row b and channel c, over
// t = 0..S-1,
//   h[n] <- h[n] e^{dt_t A[c,n]} + (dt_t u_t) B_t[n]      (n < N)
//   y_t   = sum_n h[n] C_t[n] + u_t D[c]
// in float32 from load to store; y is rounded once to u's dtype and the
// final state h_last is float32.
//
// Layout (all contiguous): u, dt [Bb,S,d]; A [d,N] float32; B, C [Bb,S,N];
// D [d] float32; h0 and h_last [Bb,d,N] float32 (h0 may be null: zeros);
// y [Bb,S,d] in u's dtype. u, B and C are float32 or bfloat16 together,
// dt either on its own (the model passes u, B, C in bf16, dt in float32).
//
// Bound. At Bb=1, S=512, d=8192, N=16 (Jamba's prefill) the function moves
// about 34.7 MB (u 8.39 MB bf16, dt 16.8 MB fp32, y 8.39 MB, A and the two
// states 0.52 MB each; B, C, D small): 0.0104 ms at 3.35 TB/s. It does
// about 6 fp32 operations per (t, c, n), 0.40 GFLOP, 0.006 ms at 67
// TFLOP/s. But it also takes one exponential per (t, c, n), 67,108,864,
// and the exp unit (MUFU) gives 16 results a clock per SM: 0.016 ms at 132
// SMs and 1.98 GHz. So the exp unit bounds it, if the loads, the other
// arithmetic and the per-step sums over n keep out of its way. Channels
// are independent; time is a chain of dependent steps.
//
// Design. The TPU kernel gives one program a (batch, 512-channel block),
// keeps the [512, N] state in VMEM and walks time in a fori_loop. On Hopper
// no state crosses channels, so blocks need no order and no exchange:
//   * a channel's N state values are split over L = 8 lanes (two values
//     each at N = 16), so Jamba's 8192 channels give 65,536 threads, each
//     with SPL independent chains;
//   * a block owns 32 channels of one batch row and walks time in chunks
//     of TC steps, double-buffered in shared memory: chunk k + 1's u, dt,
//     B and C are loaded into registers before chunk k is computed and
//     stored to the other buffer after it, so the loads' latency hides
//     behind the compute; y is staged per chunk, double-buffered too, and
//     stored coalesced while the next chunk runs (one __syncthreads a
//     chunk);
//   * u and dt are staged by channel, so that a lane reads a group's 8
//     steps of each as two float4, B and C by step;
//   * the exponentials of a group of L steps are taken first, off the h
//     chain, as ex2.approx of dt (A log2 e) with A log2 e formed once per
//     (c, n): one FMUL and one MUFU op each;
//   * each lane sums its share of y for L steps, and the L lanes of a
//     channel add them with a transpose-reduce (L - 1 shuffles for L
//     steps, against log2 L per step), after which lane i holds step i.
// Any S >= 1 and any d (the ragged channel edge is masked; the Pallas
// kernel asserts d % block_d == 0); N <= 64.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; timed by
// kernels/variants.py, which leaves one part out at a time): ~0.045 ms at
// Jamba's shape, under 3x its exp-unit bound, where the design that
// walked its chunks in sequence with expf and per-step shuffles took
// ~0.126 ms. The exps are not what binds it (an FMA in their place saves
// a few percent); the chunk loads and their staging, the y
// transpose-reduce and the y stores are the largest parts, and the group
// loop's own instruction stream at ~16 warps an SM (8192 channels of 8
// lanes are all the threads the shape offers) runs below its issue rate.
// Four lanes a channel (8 warps an SM) and sixteen (more shuffles) are
// both slower. PERF.md gives the split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "graph_nodes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CH = 32;     // channels per block
constexpr int MAX_N = 64;  // state size the B/C tiles are sized for
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sums acc[i] (step i) over the L lanes of a channel, for L steps at once:
// at level OFF a lane keeps half of its steps (the upper half if its bit
// OFF is set) and adds its partner's share of them, so that after log2 L
// levels lane i holds the sum of step i, for L - 1 shuffles in all.
template <int L, int OFF>
__device__ __forceinline__ void transpose_reduce(float (&acc)[L], int lane) {
  if constexpr (OFF >= 1) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int i = 0; i < OFF; ++i) {
      const float send = upper ? acc[i] : acc[i + OFF];
      const float keep = upper ? acc[i + OFF] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    transpose_reduce<L, OFF / 2>(acc, lane);
  }
}

// v[i] = p[i] for i < L, as L / 4 float4 loads (p 16-byte aligned).
template <int L>
__device__ __forceinline__ void load_steps(const float* p, float (&v)[L]) {
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// L lanes per channel, SPL state values per lane (state n = lane SPL + j);
// time is walked in groups of L steps.
template <int L, int SPL>
struct Tile {
  static constexpr int NP = L * SPL;                 // padded state size
  static constexpr int TC = NP >= 64 ? 16 : 32;      // steps per chunk
  static constexpr int THREADS = L * CH;
  static constexpr int UE = TC * CH / THREADS;       // u, dt loads a thread
  static constexpr int BE = TC * NP / THREADS;       // B, C loads a thread
  static_assert(L % 4 == 0 && TC % L == 0 && THREADS % CH == 0 &&
                    THREADS % NP == 0 && (TC * NP) % THREADS == 0,
                "tile shape");
};

// TU: the dtype of u, B, C and y; TD: dt's. Both fixed at compile time,
// so that a chunk's loads carry no branch and stay in flight together.
template <int L, int SPL, typename TU, typename TD>
__global__ void __launch_bounds__(Tile<L, SPL>::THREADS)
    ssm_scan_kernel(const TU* __restrict__ u, const TD* __restrict__ dt,
                    const float* __restrict__ A, const TU* __restrict__ Bm,
                    const TU* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ h0, TU* __restrict__ y,
                    float* __restrict__ h_last, int S, int d, int N) {
  using T = Tile<L, SPL>;
  constexpr int NP = T::NP, TC = T::TC, THREADS = T::THREADS;
  // u and dt by channel, so that a lane reads the L steps of a group as
  // L / 4 float4 (rows of TC + 4 words stay 16-byte aligned and shift
  // banks); B and C by step; y by step, padded by one word so that the y
  // pass writes [g0 + lane][cl], L rows at once, on distinct banks
  __shared__ __align__(16) float u_s[2][CH][TC + 4];
  __shared__ __align__(16) float dt_s[2][CH][TC + 4];
  __shared__ float y_s[2][TC][CH + 1];
  __shared__ __align__(16) float b_s[2][TC][NP];
  __shared__ __align__(16) float c_s[2][TC][NP];

  const int tid = threadIdx.x;
  const int lane = tid % L;         // lanes of a channel are consecutive
  const int cl = tid / L;           // channel within the block
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const int b = blockIdx.y;
  const bool valid = c < d;

  float a2[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = lane * SPL + j;
    const bool own = valid && n < N;
    a2[j] = own ? A[(int64_t)c * N + n] * LOG2E : 0.f;
    h[j] = (own && h0) ? h0[((int64_t)b * d + c) * N + n] : 0.f;
  }
  const float dc = valid ? D[c] : 0.f;

  // a chunk's inputs in flight, in registers as loaded; zero past S, d
  // and N, so that padded steps leave h unchanged (e^0 = 1, no input).
  // Thread slots: u, dt and y of channel c0 + kc at steps tu + r RU of a
  // chunk; B and C of state nb at steps tb + r RB. Pointers advance a
  // chunk at a time.
  constexpr int RU = THREADS / CH, RB = THREADS / NP;
  const int kc = tid % CH, tu = tid / CH, nb = tid % NP, tb = tid / NP;
  const bool kin = c0 + kc < d, nin = nb < N;
  const int64_t du = (int64_t)RU * d, db = (int64_t)RB * N;
  const int64_t u_at = ((int64_t)b * S + tu) * d + c0 + kc;
  const int64_t b_at = ((int64_t)b * S + tb) * N + nb;
  TU pu[T::UE], pb[T::BE], pc[T::BE];
  TD pdt[T::UE];
  auto fetch = [&](int t0) {
    const int64_t ou = u_at + (int64_t)t0 * d, ob = b_at + (int64_t)t0 * N;
#pragma unroll
    for (int r = 0; r < T::UE; ++r) {
      const bool in = kin && t0 + tu + r * RU < S;
      pu[r] = in ? u[ou + r * du] : TU(0.f);
      pdt[r] = in ? dt[ou + r * du] : TD(0.f);
    }
#pragma unroll
    for (int r = 0; r < T::BE; ++r) {
      const bool in = nin && t0 + tb + r * RB < S;
      pb[r] = in ? Bm[ob + r * db] : TU(0.f);
      pc[r] = in ? Cm[ob + r * db] : TU(0.f);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int r = 0; r < T::UE; ++r) {
      u_s[buf][kc][tu + r * RU] = to_float(pu[r]);
      dt_s[buf][kc][tu + r * RU] = to_float(pdt[r]);
    }
#pragma unroll
    for (int r = 0; r < T::BE; ++r) {
      b_s[buf][tb + r * RB][nb] = to_float(pb[r]);
      c_s[buf][tb + r * RB][nb] = to_float(pc[r]);
    }
  };

  const int chunks = (S + TC - 1) / TC;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * TC, buf = k & 1;
    const int nt = min(TC, S - t0);
    if (k + 1 < chunks) fetch(t0 + TC);

    for (int g0 = 0; g0 < nt; g0 += L) {
      // the decays of the group's L steps first: they do not depend on h,
      // so the exp unit runs ahead of the h chain
      float dtv[L], uv[L], dA[L][SPL];
      load_steps<L>(&dt_s[buf][cl][g0], dtv);
      load_steps<L>(&u_s[buf][cl][g0], uv);
#pragma unroll
      for (int i = 0; i < L; ++i)
#pragma unroll
        for (int j = 0; j < SPL; ++j) dA[i][j] = exp2_approx(dtv[i] * a2[j]);
      float acc[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float dtu = dtv[i] * uv[i];
        const float* bt = &b_s[buf][g0 + i][lane * SPL];
        const float* ct = &c_s[buf][g0 + i][lane * SPL];
        acc[i] = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          h[j] = fmaf(h[j], dA[i][j], dtu * bt[j]);
          acc[i] = fmaf(h[j], ct[j], acc[i]);
        }
      }
      transpose_reduce<L, L / 2>(acc, lane);  // lane i: step g0 + i
      y_s[buf][g0 + lane][cl] = acc[0] + u_s[buf][cl][g0 + lane] * dc;
    }

    if (k + 1 < chunks) stash(buf ^ 1);
    __syncthreads();
    const int64_t oy = u_at + (int64_t)t0 * d;
#pragma unroll
    for (int r = 0; r < T::UE; ++r)
      if (kin && tu + r * RU < nt)
        store_out(y + oy + r * du, y_s[buf][tu + r * RU][kc]);
  }

#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = lane * SPL + j;
    if (valid && n < N) h_last[((int64_t)b * d + c) * N + n] = h[j];
  }
}

template <int L, int SPL, typename TU, typename TD>
int launch(const void* u, const void* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, const float* h0, void* y,
           float* h_last, int Bb, int S, int d, int N, cudaStream_t stream) {
  const dim3 grid((d + CH - 1) / CH, Bb);
  ssm_scan_kernel<L, SPL, TU, TD><<<grid, Tile<L, SPL>::THREADS, 0,
                                    stream>>>(
      static_cast<const TU*>(u), static_cast<const TD*>(dt), A,
      static_cast<const TU*>(Bm), static_cast<const TU*>(Cm), D, h0,
      static_cast<TU*>(y), h_last, S, d, N);
  return cudaGetLastError();
}

template <typename TU, typename TD>
int dispatch(const void* u, const void* dt, const float* A, const void* Bm,
             const void* Cm, const float* D, const float* h0, void* y,
             float* h_last, int Bb, int S, int d, int N,
             cudaStream_t stream) {
  // L lanes a channel, SPL states a lane
  if (N <= 8)
    return launch<8, 1, TU, TD>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d,
                                N, stream);
  if (N <= 16)
    return launch<8, 2, TU, TD>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d,
                                N, stream);
  if (N <= 32)
    return launch<8, 4, TU, TD>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d,
                                N, stream);
  return launch<8, 8, TU, TD>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d,
                              N, stream);
}

}  // namespace

// Returns 0 or a cudaError_t. u_bf16: u, B, C and y are bfloat16 (else
// float32); dt_bf16: dt is bfloat16 (else float32). h0 may be null (a zero
// state).
extern "C" int ssm_scan_fwd(const void* u, const void* dt, const float* A,
                            const void* Bm, const void* Cm, const float* D,
                            const float* h0, void* y, float* h_last, int Bb,
                            int S, int d, int N, int u_bf16, int dt_bf16,
                            void* stream) {
  if (Bb < 1 || Bb > 65535 || S < 1 || d < 1 || N < 1 || N > MAX_N)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_bf16 && dt_bf16)
    return dispatch<bf16, bf16>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d,
                                N, st);
  if (u_bf16)
    return dispatch<bf16, float>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d,
                                 N, st);
  if (dt_bf16)
    return dispatch<float, bf16>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d,
                                 N, st);
  return dispatch<float, float>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d,
                                N, st);
}

// every body kernel, for a captured graph's count (graph_nodes.cuh)
const graph_nodes::GraphEntry kGraphEntries[] = {
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 1, bf16, bf16>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 2, bf16, bf16>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 4, bf16, bf16>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 8, bf16, bf16>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 1, bf16, float>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 2, bf16, float>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 4, bf16, float>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 8, bf16, float>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 1, float, bf16>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 2, float, bf16>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 4, float, bf16>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 8, float, bf16>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 1, float, float>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 2, float, float>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 4, float, float>),
     "ring"},
    {reinterpret_cast<const void*>(ssm_scan_kernel<8, 8, float, float>),
     "ring"},
};

extern "C" int graph_entries(const void** funcs, const char** bodies,
                             int max) {
  return graph_nodes::entries(kGraphEntries, funcs, bodies, max);
}

extern "C" int graph_functions(void* graph, const void** funcs, int max) {
  return graph_nodes::functions(graph, funcs, max);
}
