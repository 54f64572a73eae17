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
// y [Bb,S,d] in u's dtype. u, dt, B and C are each float32 or bfloat16 on
// their own (the model passes u, B, C in bf16 and dt in float32).
//
// Bound. At Bb=1, S=512, d=8192, N=16 (Jamba's prefill) the function moves
// about 34.7 MB (u 8.39 MB bf16, dt 16.8 MB fp32, y 8.39 MB, A and the two
// states 0.52 MB each; B, C, D small): 0.0104 ms at 3.35 TB/s. It does
// about 6 fp32 operations and one exp per (t, c, n), 67,108,864 of each:
// 0.40 GFLOP, 0.006 ms at 67 TFLOP/s. So it is bound by bytes, but only if
// the 67M exps and the per-step reductions over n keep up with the loads:
// channels are independent, time is a chain of dependent steps.
//
// Design. The TPU kernel gives one program a (batch, 512-channel block),
// keeps the [512, N] state in VMEM and walks time in a fori_loop. On Hopper
// no state crosses channels, so blocks need no order and no exchange:
//   * a channel's N state values are split over L lanes (L = 8 at N = 16,
//     two values each), so Jamba's 8192 channels give 65,536 threads
//     (2,048 warps on 132 SMs) instead of 8,192 chains of 16 exps;
//   * a block owns 32 channels of one batch row (L x 32 threads) and walks
//     time in chunks of 32 steps: u and dt of the chunk are staged in
//     shared memory with loads coalesced across the 32 channels, B_t and C_t
//     (shared by every channel of the row) once per block, and y is staged
//     and stored coalesced after the chunk;
//   * each step, a lane updates its state values in registers and forms its
//     share of y; the L lanes of a channel sum it with __shfl_xor_sync.
// Any S >= 1 and any d (the ragged channel edge is masked; the Pallas
// kernel asserts d % block_d == 0); N <= 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int CH = 32;     // channels per block
constexpr int TC = 32;     // time steps staged per chunk
constexpr int MAX_N = 64;  // state size the B/C tiles are sized for

__device__ __forceinline__ float load_as_float(const void* p, int64_t i,
                                               int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// L lanes per channel, SPL state values per lane (state n = lane + j L).
template <int L, int SPL>
__global__ void ssm_scan_kernel(const void* __restrict__ u,
                                const void* __restrict__ dt,
                                const float* __restrict__ A,
                                const void* __restrict__ Bm,
                                const void* __restrict__ Cm,
                                const float* __restrict__ D,
                                const float* __restrict__ h0,
                                void* __restrict__ y,
                                float* __restrict__ h_last, int S, int d,
                                int N, int u_bf16, int dt_bf16, int b_bf16,
                                int c_bf16) {
  __shared__ float u_s[TC][CH];
  __shared__ float dt_s[TC][CH];
  __shared__ float y_s[TC][CH];
  __shared__ float b_s[TC][MAX_N];
  __shared__ float c_s[TC][MAX_N];

  const int tid = threadIdx.x;
  const int lane = tid % L;         // lanes of a channel are consecutive
  const int cl = tid / L;           // channel within the block
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const int b = blockIdx.y;
  const bool valid = c < d;
  constexpr int THREADS = L * CH;

  float a[SPL], h[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = lane + j * L;
    const bool own = valid && n < N;
    a[j] = own ? A[(int64_t)c * N + n] : 0.f;
    h[j] = (own && h0) ? h0[((int64_t)b * d + c) * N + n] : 0.f;
  }
  const float dc = valid ? D[c] : 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int nt = min(TC, S - t0);
    __syncthreads();  // the previous chunk's y_s has been stored
    for (int i = tid; i < nt * CH; i += THREADS) {
      const int t = i / CH, k = i % CH;
      const int64_t g = ((int64_t)b * S + t0 + t) * d + c0 + k;
      const bool in = c0 + k < d;
      u_s[t][k] = in ? load_as_float(u, g, u_bf16) : 0.f;
      dt_s[t][k] = in ? load_as_float(dt, g, dt_bf16) : 0.f;
    }
    for (int i = tid; i < nt * N; i += THREADS) {
      const int t = i / N, n = i % N;
      const int64_t g = ((int64_t)b * S + t0 + t) * N + n;
      b_s[t][n] = load_as_float(Bm, g, b_bf16);
      c_s[t][n] = load_as_float(Cm, g, c_bf16);
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float ut = u_s[t][cl];
      const float dtt = dt_s[t][cl];
      const float dtu = dtt * ut;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int n = lane + j * L;
        if (n < N) {
          h[j] = h[j] * expf(dtt * a[j]) + dtu * b_s[t][n];
          acc += h[j] * c_s[t][n];
        }
      }
      // every lane of the warp takes part, valid channel or not
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) y_s[t][cl] = acc + ut * dc;
    }
    __syncthreads();

    for (int i = tid; i < nt * CH; i += THREADS) {
      const int t = i / CH, k = i % CH;
      if (c0 + k >= d) continue;
      const int64_t g = ((int64_t)b * S + t0 + t) * d + c0 + k;
      if (u_bf16)
        static_cast<bf16*>(y)[g] = __float2bfloat16(y_s[t][k]);
      else
        static_cast<float*>(y)[g] = y_s[t][k];
    }
  }

#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int n = lane + j * L;
    if (valid && n < N) h_last[((int64_t)b * d + c) * N + n] = h[j];
  }
}

template <int L, int SPL>
int launch(const void* u, const void* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, const float* h0, void* y,
           float* h_last, int Bb, int S, int d, int N, const int* bf16_flags,
           cudaStream_t stream) {
  const dim3 grid((d + CH - 1) / CH, Bb);
  ssm_scan_kernel<L, SPL><<<grid, L * CH, 0, stream>>>(
      u, dt, A, Bm, Cm, D, h0, y, h_last, S, d, N, bf16_flags[0],
      bf16_flags[1], bf16_flags[2], bf16_flags[3]);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 or a cudaError_t. bf16_flags: {u, dt, B, C}, 1 for bfloat16 and
// 0 for float32; y takes u's dtype. h0 may be null (a zero state).
extern "C" int ssm_scan_fwd(const void* u, const void* dt, const float* A,
                            const void* Bm, const void* Cm, const float* D,
                            const float* h0, void* y, float* h_last, int Bb,
                            int S, int d, int N, const int* bf16_flags,
                            void* stream) {
  if (Bb < 1 || Bb > 65535 || S < 1 || d < 1 || N < 1 || N > MAX_N)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // L = N rounded up to a power of two, at most 8; SPL = ceil(N / L)
  // rounded up to a power of two
  if (N == 1)
    return launch<1, 1>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d, N,
                        bf16_flags, st);
  if (N == 2)
    return launch<2, 1>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d, N,
                        bf16_flags, st);
  if (N <= 4)
    return launch<4, 1>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d, N,
                        bf16_flags, st);
  if (N <= 8)
    return launch<8, 1>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d, N,
                        bf16_flags, st);
  if (N <= 16)
    return launch<8, 2>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d, N,
                        bf16_flags, st);
  if (N <= 32)
    return launch<8, 4>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d, N,
                        bf16_flags, st);
  return launch<8, 8>(u, dt, A, Bm, Cm, D, h0, y, h_last, Bb, S, d, N,
                      bf16_flags, st);
}
