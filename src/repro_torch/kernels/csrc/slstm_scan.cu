// sLSTM scan forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm_scan.py:76
// (slstm_scan_fwd / _kernel): the fused sLSTM recurrence over S steps,
//   rec[g,b,h,l] = sum_k h_{t-1}[b,h,k] R[g,h,k,l]          (g = i, f, z, o)
//   i = pre_i + rec_i, f = pre_f + rec_f, z = tanh(pre_z + rec_z),
//   o = sigmoid(pre_o + rec_o), logf = log_sigmoid(f),
//   m_t = max(logf + m, i), c_t = c e^{logf + m - m_t} + e^{i - m_t} z,
//   n_t = n e^{logf + m - m_t} + e^{i - m_t}, h_t = o c_t / max(n_t, 1e-6),
// all in float32. m may start at -inf: e^{logf - inf - m_t} is 0.
//
// Layout: pre [B,S,4,d] (float32 or bfloat16, d = H dh), R [4,H,dh,dh]
// float32, c/n/m/h in and out [B,H,dh] float32, hs [B,S,d] in pre's dtype;
// all contiguous.
//
// Bound. At B=1, S=512, H=4, dh=512 the function does 2 S 4 d dh =
// 4,294,967,296 fp32 FLOP (0.0641 ms at 67 TFLOP/s) and moves 27,328,512
// bytes (pre 8,388,608 + R 16,777,216 + hs 2,097,152 + states 65,536;
// 0.0082 ms at 3.35 TB/s), so by the card's peaks it is bound by
// operations. But the S steps are sequential and each needs the whole h of
// its head from the step before: a latency floor of S x (one exchange of h
// between SMs + one 512-long dot product) lies above both bounds.
//
// Design. The TPU kernel keeps one head's R (4 MiB fp32 at dh 512) and the
// state in VMEM for the whole sequence on a (head, time-chunk) grid that
// runs in order. A Hopper block has 227 KB of shared memory, so here R's
// columns are split: one persistent cooperative launch of H x P blocks
// (P = ceil(dh / 16)), block (head, p) owning the 16 columns
// [16p, 16p + 16) of all four gates. It gathers that slice of R once, at
// the start, into shared memory as a [dh][4*16] tile (R is stored [k][l]
// and read by columns; the tile is k-major so that 32 lanes read 32
// neighbouring words), 136 KB at dh 512: 128 blocks on 132 SMs, one each.
// The c/n/m/h state of a column lives in a register of the thread that owns
// (batch row, column) for the whole sequence. Each step a block
//   1. reads its head's h_{t-1} [B,dh] from a ping-pong buffer in global
//      memory (through L2, bypassing L1) into shared memory;
//   2. forms its 64 gate sums per batch row: 8 threads share each sum over
//      interleaved k and reduce it with warp shuffles (fp32 FMA, no tensor
//      cores: TF32 would not hold 1e-5 against the float32 plain version);
//   3. applies the cell to its 16 columns, writes h_t to hs and to the
//      other half of the ping-pong buffer;
//   4. waits at a barrier of the P blocks of its head: a counter per head in
//      global memory, raised once per block and step after a fence, read
//      with ld.acquire. Heads never wait for each other. The cooperative
//      launch guarantees that all blocks are resident, so the spin cannot
//      deadlock; the wrapper refuses grids that do not fit.
// The input preactivations of a step are loaded before the dot product, so
// their latency hides behind it. One launch covers all S steps; S is any
// length >= 1 (the TPU kernel asserts S % chunk == 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int COLS = 16;                  // columns of one head per block
constexpr int OUTS = 4 * COLS;            // gate sums per batch row
constexpr int SPLIT = 8;                  // threads sharing one gate sum
constexpr int THREADS = OUTS * SPLIT;     // 512
constexpr int LANES_PER_K = 32 / SPLIT;   // sums per warp: 4
// R tile row stride: 68 = 4 (mod 32) puts the 8 k rows a warp reads at
// once on distinct banks
constexpr int RSTRIDE = OUTS + LANES_PER_K;
constexpr int MAX_B = THREADS / COLS;     // one state owner per (b, column)
constexpr long long SPIN_LIMIT = 1LL << 24;  // barrier polls before a trap

__device__ __forceinline__ float load_in(const float* p) { return *p; }
__device__ __forceinline__ float load_in(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

template <int BCH>
__host__ __device__ constexpr int padded_rows(int B) {
  return (B + BCH - 1) / BCH * BCH;
}

template <typename T, int BCH>
__global__ void __launch_bounds__(THREADS, 1)
    slstm_scan_kernel(const T* __restrict__ pre, const float* __restrict__ r,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0,
                      const float* __restrict__ h0, T* __restrict__ hs,
                      float* __restrict__ cT, float* __restrict__ nT,
                      float* __restrict__ mT, float* __restrict__ hT,
                      float* hbuf, int* bar, int B, int S, int H, int dh,
                      int P) {
  extern __shared__ float smem[];
  const int K = dh;
  const int Bp = padded_rows<BCH>(B);
  float* rs = smem;                  // [K][RSTRIDE]: R slice, k-major
  float* hsm = rs + K * RSTRIDE;     // [Bp][K]: h_{t-1} of the head
  float* gsum = hsm + Bp * K;        // [Bp][OUTS]: gate sums
  const int head = blockIdx.x / P;
  const int col0 = (blockIdx.x % P) * COLS;
  const int d = H * dh;
  const int tid = threadIdx.x;

  // rs[k][g*COLS + j] = R[g][head][k][col0 + j]; columns past dh are 0
  for (int i = tid; i < K * OUTS; i += THREADS) {
    const int k = i / OUTS, o = i % OUTS;
    const int g = o / COLS, l = col0 + o % COLS;
    rs[k * RSTRIDE + o] =
        l < dh ? r[((static_cast<size_t>(g) * H + head) * dh + k) * dh + l]
               : 0.f;
  }
  for (int i = tid; i < (Bp - B) * K; i += THREADS) hsm[B * K + i] = 0.f;

  // the owner of (batch row cb, column cl) keeps its state in registers
  const int cb = tid / COLS, cj = tid % COLS, cl = col0 + cj;
  const bool owner = cb < B && cl < dh;
  const size_t sidx = (static_cast<size_t>(cb) * H + head) * dh + cl;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;
  if (owner) {
    c = c0[sidx];
    n = n0[sidx];
    m = m0[sidx];
    h = h0[sidx];
  }
  // dot-product role: gate sum o over k = s, s + SPLIT, ...
  const int lane = tid % 32;
  const int s = lane / LANES_PER_K;
  const int o = (tid / 32) * LANES_PER_K + lane % LANES_PER_K;

  for (int t = 0; t < S; ++t) {
    float pi = 0.f, pf = 0.f, pz = 0.f, po = 0.f;
    if (owner) {
      const T* p = pre + (static_cast<size_t>(cb) * S + t) * 4 * d +
                   head * dh + cl;
      pi = load_in(p);
      pf = load_in(p + d);
      pz = load_in(p + 2 * d);
      po = load_in(p + 3 * d);
    }
    const float* hprev =
        t == 0 ? h0 : hbuf + static_cast<size_t>((t - 1) & 1) * B * d;
    for (int i = tid; i < B * K; i += THREADS) {
      const int b = i / K, k = i % K;
      hsm[i] = __ldcg(hprev + (static_cast<size_t>(b) * H + head) * dh + k);
    }
    __syncthreads();

    for (int b0 = 0; b0 < B; b0 += BCH) {
      float acc[BCH];
#pragma unroll
      for (int bb = 0; bb < BCH; ++bb) acc[bb] = 0.f;
#pragma unroll 4
      for (int k = s; k < K; k += SPLIT) {
        const float w = rs[k * RSTRIDE + o];
#pragma unroll
        for (int bb = 0; bb < BCH; ++bb)
          acc[bb] = fmaf(hsm[(b0 + bb) * K + k], w, acc[bb]);
      }
#pragma unroll
      for (int bb = 0; bb < BCH; ++bb) {
        float v = acc[bb];
#pragma unroll
        for (int off = LANES_PER_K; off < 32; off *= 2)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (s == 0) gsum[(b0 + bb) * OUTS + o] = v;
      }
    }
    __syncthreads();

    if (owner) {
      const float* g = gsum + cb * OUTS;
      const float it = pi + g[cj];
      const float ft = pf + g[COLS + cj];
      const float zt = tanhf(pz + g[2 * COLS + cj]);
      const float ot = 1.f / (1.f + expf(-(po + g[3 * COLS + cj])));
      const float lf = log_sigmoid(ft);
      const float m_new = fmaxf(lf + m, it);
      const float fs = expf(lf + m - m_new);
      const float is = expf(it - m_new);
      c = c * fs + is * zt;
      n = n * fs + is;
      h = ot * c / fmaxf(n, 1e-6f);
      m = m_new;
      store_out(hs + (static_cast<size_t>(cb) * S + t) * d + head * dh + cl,
                h);
      __stcg(hbuf + static_cast<size_t>(t & 1) * B * d + sidx, h);
    }
    if (t + 1 < S) {
      // barrier of the P blocks of this head; h_t is visible after it
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        atomicAdd(bar + head, 1);
        const int target = (t + 1) * P;
        // a block that never arrives (a fault elsewhere) ends the launch
        // with an error after some seconds instead of hanging the card
        for (long long spins = 0; load_acquire(bar + head) < target;) {
          if (++spins > SPIN_LIMIT) __trap();
        }
        __threadfence();
      }
      __syncthreads();
    }
  }
  if (owner) {
    cT[sidx] = c;
    nT[sidx] = n;
    mT[sidx] = m;
    hT[sidx] = h;
  }
}

template <typename T, int BCH>
int launch(const void* pre, const float* r, const float* c0, const float* n0,
           const float* m0, const float* h0, void* hs, float* cT, float* nT,
           float* mT, float* hT, float* hbuf, int* bar, int B, int S, int H,
           int dh, int* info, cudaStream_t stream) {
  auto kernel = slstm_scan_kernel<T, BCH>;
  const int P = (dh + COLS - 1) / COLS;
  const int grid = H * P;
  const size_t rows = padded_rows<BCH>(B);
  const size_t smem =
      (static_cast<size_t>(dh) * RSTRIDE + rows * dh + rows * OUTS) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  info[0] = per_sm;
  info[1] = sms;
  info[2] = grid;
  if (!coop || per_sm * sms < grid) return -1;  // cannot be co-resident

  const T* pre_t = static_cast<const T*>(pre);
  T* hs_t = static_cast<T*>(hs);
  void* args[] = {&pre_t, &r,  &c0, &n0,   &m0,  &h0, &hs_t, &cT, &nT,
                  &mT,    &hT, &hbuf, &bar, &B,  &S,  &H,   &dh, (void*)&P};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int dispatch_b(const void* pre, const float* r, const float* c0,
               const float* n0, const float* m0, const float* h0, void* hs,
               float* cT, float* nT, float* mT, float* hT, float* hbuf,
               int* bar, int B, int S, int H, int dh, int* info,
               cudaStream_t stream) {
  if (B == 1)
    return launch<T, 1>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, hbuf, bar,
                        B, S, H, dh, info, stream);
  if (B == 2)
    return launch<T, 2>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, hbuf, bar,
                        B, S, H, dh, info, stream);
  return launch<T, 4>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, hbuf, bar,
                      B, S, H, dh, info, stream);
}

}  // namespace

// Returns 0, a cudaError_t, or -1 when the grid cannot be co-resident
// (info = {blocks per SM, SMs, grid}). hbuf: [2,B,H,dh] float32 scratch;
// bar: H int32 counters, zero at launch.
extern "C" int slstm_scan_fwd(const void* pre, const float* r,
                              const float* c0, const float* n0,
                              const float* m0, const float* h0, void* hs,
                              float* cT, float* nT, float* mT, float* hT,
                              float* hbuf, int* bar, int dtype, int B, int S,
                              int H, int dh, int* info, void* stream) {
  if (B < 1 || B > MAX_B || S < 1 || H < 1 || dh < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_b<float>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, hbuf,
                             bar, B, S, H, dh, info, st);
  if (dtype == 1)
    return dispatch_b<bf16>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, hbuf,
                            bar, B, S, H, dh, info, st);
  return cudaErrorInvalidValue;
}
