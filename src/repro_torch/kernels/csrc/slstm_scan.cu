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
// its head from the step before, so a per-step floor lies above both
// bounds: one exchange of h between SMs through L2, one 512-long dot
// product per gate sum and one cell, in sequence.
//
// Design. The TPU kernel keeps one head's R (4 MiB fp32 at dh 512) and the
// state in VMEM for the whole sequence. No SM holds that, so here R's
// columns are split: one persistent cooperative launch of H x P blocks
// (P = ceil(dh / 16)) of 16 warps, warp w of block (head, p) owning column
// 16p + w of all four gates. The cooperative launch guarantees that all
// blocks are resident, so a block may wait for the others without
// deadlock; the launch refuses grids that cannot be co-resident.
//   * R in registers: lane s of a warp forms all four gate sums of its
//     column over k = 128j + 4s .. 128j + 4s + 3, so its 16 ceil(dh / 128)
//     values of R (64 at dh 512) sit in registers for the whole sequence,
//     loaded once through shared memory (k past dh is zero);
//   * h_{t-1} of the head is staged in shared memory and read as float4,
//     the 32 lanes of a warp on 32 distinct float4: 16 wavefronts a warp a
//     step at dh 512, the least that reads it all;
//   * the four sums are reduced over the 32 lanes with a transpose-reduce
//     (two levels that halve the gates a lane holds, then three xor
//     levels) and written to shared memory; after a second barrier the
//     cells of the block's 16 columns run side by side in the lanes of one
//     warp (lane 16b + j for row b, column j), not in one lane of each of
//     16 warps, where four warps a scheduler would issue every instruction
//     of the float32 cell four times over;
//   * h_t crosses blocks in one round trip: each value is published as a
//     64-bit word {step + 1, h} with a relaxed store, and each reader polls
//     exactly the words it reads until the tag is the step it wants (two
//     buffers by step parity, so a word is never overwritten before every
//     block has read it). No counter and no fences. A wait that outlasts
//     some seconds (a fault elsewhere) traps instead of hanging the card;
//   * the preactivations of step t + 1 are loaded during step t; every
//     address a step uses is formed once, before the loop.
// Any S >= 1 (the TPU kernel asserts S % chunk == 0), B <= 32, dh <= 512.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; timed by
// kernels/variants.py, which leaves one part out of a step at a time):
// ~0.66 ms at xLSTM 1.3B's shape, a fixed ~0.04 ms (R into the registers)
// and ~1.2 us a step, where the design with R in shared memory and a
// per-head barrier took ~3.35 us. The step is a chain of latencies: the
// exchange of h through L2 (~0.45 us, about half of it waiting for the
// last of the head's 32 blocks to publish), the dot product and its
// 32-lane reduction (~0.4 us; the FMA issue floor of 64 FMAs a lane at
// 16 warps an SM is ~0.13 us of it), the float32 cell (~0.2 us), and the
// two barriers, loads and stores around them. The operations bound above
// is an order of magnitude lower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "graph_nodes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int COLS = 16;                  // columns of one head per block
constexpr int THREADS = 32 * COLS;        // one warp per column
constexpr int KJ = 128;                   // k values of one float4 round
constexpr int MAX_B = 32;                 // one state-owning lane per row
constexpr int MAX_DH = 512;
constexpr long long SPIN_LIMIT = 1LL << 24;  // polls before a trap

__device__ __forceinline__ float load_in(const float* p) { return *p; }
__device__ __forceinline__ float load_in(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// NJ: the float4 rounds of a lane (16 NJ registers of R); h rows are
// padded with zeros to K = 128 NJ, past dh.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, 1)
    slstm_regs(const T* __restrict__ pre, const float* __restrict__ r,
               const float* __restrict__ c0, const float* __restrict__ n0,
               const float* __restrict__ m0, const float* __restrict__ h0,
               T* __restrict__ hs, float* __restrict__ cT,
               float* __restrict__ nT, float* __restrict__ mT,
               float* __restrict__ hT, unsigned long long* xbuf, int B,
               int S, int H, int dh, int P) {
  constexpr int K = NJ * KJ;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int head = blockIdx.x / P;
  const int col0 = (blockIdx.x % P) * COLS;
  const int d = H * dh;
  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;

  // R's slice through shared memory, coalesced: rs[k][g*16 + j] =
  // R[g][head][k][col0 + j] (0 past dh); then lane s keeps
  // R[g][head][128j + 4s + i][col] in wr[g][4j + i]
  for (int i = tid; i < dh * 4 * COLS; i += THREADS) {
    const int k = i / (4 * COLS), o = i % (4 * COLS);
    const int g = o / COLS, l = col0 + o % COLS;
    smem[i] = l < dh ? r[((static_cast<size_t>(g) * H + head) * dh + k) *
                             dh + l]
                     : 0.f;
  }
  __syncthreads();
  float wr[4][4 * NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = KJ * j + 4 * lane + i;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        wr[g][4 * j + i] = k < dh ? smem[k * 4 * COLS + g * COLS + w] : 0.f;
    }
  __syncthreads();  // the h buffers below reuse the R tile's space

  // hsm: [2][B][K], h_{t-1} of the head by step parity; thread k < dh
  // gathers column k of every row, the rest stays zero. The words of h_t
  // are xbuf[t & 1][b][head][k]. gsum: [B][4][16], the step's gate sums.
  float* const hsm = smem;
  const int hstride = B * K;
  float* const gsum = hsm + 2 * hstride;
  const size_t xrow = static_cast<size_t>(H) * dh;
  const size_t xstride = B * xrow;
  const bool gatherer = tid < dh;
  for (int i = tid; i < 2 * hstride; i += THREADS) hsm[i] = 0.f;
  __syncthreads();
  if (gatherer)
    for (int b = 0; b < B; ++b)
      hsm[b * K + tid] = h0[b * xrow + head * dh + tid];
  const unsigned long long* const xsrc = xbuf + head * dh + tid;

  // thread cb * 16 + cj runs the cell of (batch row cb, column col0 + cj)
  // and keeps its state: the cells of a block run side by side in one
  // warp (two rows a warp), not one lane in each of 16 warps
  const int cb = tid / COLS, cj = tid % COLS, ccol = col0 + cj;
  const bool owner = cb < B && ccol < dh;
  const size_t sidx = cb * xrow + head * dh + ccol;
  float c = 0.f, n = 0.f, m = 0.f, h = 0.f;
  float pn[4] = {0.f, 0.f, 0.f, 0.f};  // preactivations of the next step
  const T* pre_t = pre + static_cast<size_t>(cb) * S * 4 * d + head * dh +
                   ccol;               // step t's, advanced by 4 d a step
  T* hs_t = hs + static_cast<size_t>(cb) * S * d + head * dh + ccol;
  unsigned long long* const xdst = xbuf + sidx;
  if (owner) {
    c = c0[sidx];
    n = n0[sidx];
    m = m0[sidx];
    h = h0[sidx];
#pragma unroll
    for (int g = 0; g < 4; ++g) pn[g] = load_in(pre_t + g * d);
  }

  for (int t = 0; t < S; ++t) {
    const float* hb = hsm + (t & 1) * hstride;
    if (t > 0 && gatherer) {
      // h_{t-1} was published with tag t into buffer (t - 1) & 1
      const unsigned long long* p = xsrc + ((t - 1) & 1) * xstride;
      float* q = hsm + (t & 1) * hstride + tid;
      for (int b = 0; b < B; ++b, p += xrow, q += K) {
        unsigned long long v;
        for (long long spins = 0;
             static_cast<int>((v = load_word(p)) >> 32) != t;) {
          if (++spins > SPIN_LIMIT) __trap();
        }
        *q = __uint_as_float(static_cast<unsigned>(v));
      }
    }
    float pc[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) pc[g] = pn[g];
    pre_t += 4 * d;
    if (owner && t + 1 < S) {
#pragma unroll
      for (int g = 0; g < 4; ++g) pn[g] = load_in(pre_t + g * d);
    }
    __syncthreads();

    for (int b = 0; b < B; ++b) {
      const float4* hrow = reinterpret_cast<const float4*>(hb + b * K) + lane;
      float4 hv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) hv[j] = hrow[KJ / 4 * j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[g] = fmaf(hv[j].x, wr[g][4 * j], acc[g]);
          acc[g] = fmaf(hv[j].y, wr[g][4 * j + 1], acc[g]);
          acc[g] = fmaf(hv[j].z, wr[g][4 * j + 2], acc[g]);
          acc[g] = fmaf(hv[j].w, wr[g][4 * j + 3], acc[g]);
        }
      // transpose-reduce: lanes with bit 16 set keep gates 2, 3, with bit
      // 8 set the odd gate of the two, so lanes 8g .. 8g + 7 end with
      // gate g; then the sum over the low three lane bits
      const bool hi16 = lane & 16, hi8 = lane & 8;
      const float a0 =
          (hi16 ? acc[2] : acc[0]) +
          __shfl_xor_sync(0xffffffffu, hi16 ? acc[0] : acc[2], 16);
      const float a1 =
          (hi16 ? acc[3] : acc[1]) +
          __shfl_xor_sync(0xffffffffu, hi16 ? acc[1] : acc[3], 16);
      float v = (hi8 ? a1 : a0) +
                __shfl_xor_sync(0xffffffffu, hi8 ? a0 : a1, 8);
#pragma unroll
      for (int off = 4; off >= 1; off /= 2)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if ((lane & 7) == 0) gsum[(b * 4 + lane / 8) * COLS + w] = v;
    }
    __syncthreads();

    if (owner) {
      const float* gs = gsum + cb * 4 * COLS + cj;
      const float it = pc[0] + gs[0];
      const float ft = pc[1] + gs[COLS];
      const float zt = tanhf(pc[2] + gs[2 * COLS]);
      const float ot = 1.f / (1.f + expf(-(pc[3] + gs[3 * COLS])));
      const float lf = log_sigmoid(ft);
      // of e^{lf + m - m_t} and e^{i - m_t} one is e^0 = 1 and the other
      // e^{-|lf + m - i|}, bit for bit: one exp on the chain
      const float lm = lf + m;
      const float e = expf(-fabsf(lm - it));
      const float fs = lm >= it ? 1.f : e;
      const float is = lm >= it ? e : 1.f;
      c = c * fs + is * zt;
      n = n * fs + is;
      m = fmaxf(lm, it);
      h = ot * c / fmaxf(n, 1e-6f);
      if (t + 1 < S)
        store_word(xdst + (t & 1) * xstride,
                   (static_cast<unsigned long long>(t + 1) << 32) |
                       __float_as_uint(h));
      store_out(hs_t, h);
    }
    hs_t += d;
  }
  if (owner) {
    cT[sidx] = c;
    nT[sidx] = n;
    mT[sidx] = m;
    hT[sidx] = h;
  }
}

template <typename T, int NJ>
int launch(const void* pre, const float* r, const float* c0, const float* n0,
           const float* m0, const float* h0, void* hs, float* cT, float* nT,
           float* mT, float* hT, void* xchg, int B, int S, int H, int dh,
           int* info, cudaStream_t stream) {
  auto kernel = slstm_regs<T, NJ>;
  const int P = (dh + COLS - 1) / COLS;
  const int grid = H * P;
  const size_t tile = static_cast<size_t>(dh) * 4 * COLS;
  // [2][B][K] h buffers and [B][4][16] gate sums
  const size_t hbufs = static_cast<size_t>(B) * (2 * NJ * KJ + 4 * COLS);
  const size_t smem = (tile > hbufs ? tile : hbufs) * sizeof(float);
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
  auto* x = static_cast<unsigned long long*>(xchg);
  void* args[] = {&pre_t, &r, &c0, &n0, &m0, &h0, &hs_t, &cT, &nT,
                  &mT,    &hT, &x,  &B,  &S,  &H,  &dh, (void*)&P};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* pre, const float* r, const float* c0,
             const float* n0, const float* m0, const float* h0, void* hs,
             float* cT, float* nT, float* mT, float* hT, void* xchg, int B,
             int S, int H, int dh, int* info, cudaStream_t stream) {
  if (dh <= KJ)
    return launch<T, 1>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, xchg, B,
                        S, H, dh, info, stream);
  if (dh <= 2 * KJ)
    return launch<T, 2>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, xchg, B,
                        S, H, dh, info, stream);
  return launch<T, 4>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, xchg, B,
                      S, H, dh, info, stream);
}

}  // namespace

// Returns 0, a cudaError_t, or -1 when the grid cannot be co-resident
// (info = {blocks per SM, SMs, grid}). xchg: [2,B,H,dh] 64-bit words, zero
// at launch (the tags of h's exchange).
extern "C" int slstm_scan_fwd(const void* pre, const float* r,
                              const float* c0, const float* n0,
                              const float* m0, const float* h0, void* hs,
                              float* cT, float* nT, float* mT, float* hT,
                              void* xchg, int dtype, int B, int S, int H,
                              int dh, int* info, void* stream) {
  if (B < 1 || B > MAX_B || S < 1 || H < 1 || dh < 1 || dh > MAX_DH)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, xchg,
                           B, S, H, dh, info, st);
  if (dtype == 1)
    return dispatch<bf16>(pre, r, c0, n0, m0, h0, hs, cT, nT, mT, hT, xchg, B,
                          S, H, dh, info, st);
  return cudaErrorInvalidValue;
}

// every body kernel, for a captured graph's count (graph_nodes.cuh)
const graph_nodes::GraphEntry kGraphEntries[] = {
    {reinterpret_cast<const void*>(slstm_regs<float, 1>), "regs"},
    {reinterpret_cast<const void*>(slstm_regs<float, 2>), "regs"},
    {reinterpret_cast<const void*>(slstm_regs<float, 4>), "regs"},
    {reinterpret_cast<const void*>(slstm_regs<bf16, 1>), "regs"},
    {reinterpret_cast<const void*>(slstm_regs<bf16, 2>), "regs"},
    {reinterpret_cast<const void*>(slstm_regs<bf16, 4>), "regs"},
};

extern "C" int graph_entries(const void** funcs, const char** bodies,
                             int max) {
  return graph_nodes::entries(kGraphEntries, funcs, bodies, max);
}

extern "C" int graph_functions(void* graph, const void** funcs, int max) {
  return graph_nodes::functions(graph, funcs, max);
}
