// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel): causal, optionally sliding-window and
// softcapped GQA attention, blockwise online softmax with float32 m, l and
// accumulator, masked logits set to -2.3819763e38, l floored at 1e-30.
//
// Layout: q [B,S,Hq,hd], k/v [B,T,Hkv,hd], o [B,S,Hq,hd], read and written
// through their batch, sequence and head strides (head_dim is unit-stride),
// so no transposed copies are made: k and v are views into the serving
// cache [B,L,Hkv,hd]. kv head = q head / (Hq / Hkv).
//
// Design. The TPU kernel walks a sequential (q block, k block) grid with
// 512x512 tiles and an fp32 [block_q, hd] accumulator in VMEM; at hd 128
// that accumulator alone is 256 KB, more than one block's 227 KB of shared
// memory. Here one CTA owns one (batch, q head, 64-row query block) and
// loops over 64-row key blocks inside the block, so nothing is carried
// between CTAs; the accumulator lives in registers. The key loop starts at
// the window's edge and stops at the causal diagonal, so blocks above the
// diagonal or outside the window are never loaded, and query blocks are
// launched longest rows first. Ragged S and T are masked (the TPU kernel
// asserts S % block_q == 0). Three bodies; the caller
// (kernels/flash_attention.py::_body_for) picks one by dtype and shape:
//  - wgmma (bfloat16 at head dims 64 and 128: phi4, Granite, Jamba). Warp-
//    specialised: a producer warp loads Q once and streams the key loop's K
//    and V tiles by TMA (128-byte-swizzled 64 x 64 boxes of a 4-D tensor map
//    per operand, whose extents are T and S, not the cache's L, so rows past
//    the view load as zeros) through two rings of 3 (hd 128) or 4 (hd 64)
//    stages, each stage with its own full/empty mbarriers: a K tile is
//    released as soon as S is computed, a V tile after P V. One TMA round
//    trip takes about as long as a block's math, so two stages were too few.
//    One consumer warpgroup computes S = Q K^T with wgmma m64n64k16 from
//    shared memory; applies scale, softcap, masks (only on blocks at an edge)
//    and the online softmax, in base 2 with the scale folded into one FFMA
//    per exp on interior blocks, to the fp32 fragment in registers (the
//    softmax, not the tensor cores, is most of a block's instructions);
//    rounds P to bf16 in registers; and computes O += P V with wgmma
//    m64n{hd}k16, A (P) from registers and V from shared memory with the
//    transpose bit. As in FA3, block j's S and block j - 1's P V are issued
//    together: O's rescale runs under S, block j's softmax under P V.
//    (Issuing block j + 1's S into a second accumulator before block j's
//    softmax made ptxas serialise the wgmmas, C7515: slower.) 64 query rows
//    per CTA rather than FA3's 128 over two consumer warpgroups: phi4 at S =
//    512 has 8 x 24 = 192 query blocks of 64 for 132 SMs (96 of 128 would
//    leave 36 SMs idle), and 114,792 bytes of shared memory at hd 128 let two
//    CTAs share an SM, so one CTA's softmax overlaps the other's wgmma. The
//    producer is one warp, not a warpgroup: 160 threads and two CTAs an SM
//    leave a consumer thread up to 200 registers (O 64, S 32, P 16 at hd 128)
//    without setmaxnreg; at 256 threads ptxas fit the kernel into 128 and
//    serialised the wgmmas for want of registers. The query block is the
//    slowest grid dimension, reversed, so every head's longest rows start
//    first (this matters once CTAs outnumber the slots: 384 for 264 at S =
//    1000).
//  - mma_sync (bfloat16 at hd 16, 32 and 256): 4 warps, each owning 16
//    query rows, on the tensor cores with mma.sync m16n8k16 (fp32
//    accumulation). Q, K and V tiles are loaded into shared memory with
//    plain 16-byte loads and reach the tensor cores through ldmatrix; the
//    score fragment becomes the A operand of P.V in registers (P rounded
//    to bf16), so P never touches shared memory.
//  - float32: 256 threads as a 16x16 grid on fp32 FMA, tiles staged as
//    float in shared memory, 4 query rows per thread; keeps float32 from
//    load to store.
// In all, the 4 (tensor cores) or 16 (FMA) threads that share a row reduce
// its running max and sum with warp shuffles.
//
// Bound. At the serving path's prefill shapes (S = T <= ~1k, Hq 24, Hkv 8,
// hd 128, bf16) the function moves ~8 MB and does ~1.6 GFLOP per call, so
// on an H100 it is bound by bytes (~2.5 us at 3.35 TB/s) rather than by
// the bf16 tensor-core rate (~1.6 us); the inputs then sit in L2, and what
// limits a call is the critical path of the longest CTA (the last query
// block walks every key block), which the TMA ring and wgmma shorten.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "graph_nodes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // key rows per step (32 for the float32 body at hd 256)
constexpr float NEG_INF = -2.3819763e38f;

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// whether key kpos is visible from query qpos
__device__ __forceinline__ bool visible(int qpos, int kpos, int Tk, int causal,
                                        int window) {
  return kpos < Tk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ float logit(float dot, float scale, float softcap) {
  float x = dot * scale;
  if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
  return x;
}

// ---------------------------------------------------------------------------
// float32 body: CUDA-core FMA
// ---------------------------------------------------------------------------

template <int HD>
struct F32Tile {
  static constexpr int NT = 256;                  // a 16 x 16 thread grid
  static constexpr int BKF = HD >= 256 ? 32 : 64;  // key rows per step
  static constexpr int QP = HD + 1;  // padded pitch of Q/K rows (banks)
  static constexpr int PP = BKF + 1;  // padded pitch of P rows
  static constexpr size_t smem =
      sizeof(float) * (BQ * QP + BKF * QP + BKF * HD + BQ * PP);
};

template <int HD>
__global__ void __launch_bounds__(256)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S,
                  int Tk, int group, Strides st, float scale, int causal,
                  int window, float softcap) {
  using Tile = F32Tile<HD>;
  constexpr int NT = Tile::NT, BKF = Tile::BKF, QP = Tile::QP,
                PP = Tile::PP;
  constexpr int RI = BQ / 16;   // query rows per thread
  constexpr int CJ = BKF / 16;  // score columns per thread
  constexpr int OJ = HD / 16;   // output columns per thread

  extern __shared__ float smem_f[];
  float* Qs = smem_f;         // [BQ][QP]
  float* Ks = Qs + BQ * QP;   // [BKF][QP]
  float* Vs = Ks + BKF * QP;  // [BKF][HD]
  float* Ps = Vs + BKF * HD;  // [BQ][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  q += b * st.qb + h * st.qh;
  k += b * st.kb + hk * st.kh;
  v += b * st.vb + hk * st.vh;
  o += b * st.ob + h * st.oh;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    Qs[r * QP + d] = q0 + r < S ? q[(q0 + r) * st.qs + d] : 0.f;
  }

  float m[RI], l[RI], acc[RI][OJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BKF * BKF : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BKF) {
    __syncthreads();  // the previous step is done with Ks, Vs and Ps
    for (int i = tid; i < BKF * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Tk;
      Ks[r * QP + d] = in ? k[(k0 + r) * st.ks + d] : 0.f;
      Vs[r * HD + d] = in ? v[(k0 + r) * st.vs + d] : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = visible(qpos, kpos, Tk, causal, window)
                      ? logit(s[i][j], scale, softcap)
                      : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half-warp: xor 8..1 stays inside it
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);  // 0 on the first step
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKF; ++c) {
      float pv[RI], vv[OJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + qpos * st.os;
#pragma unroll
    for (int j = 0; j < OJ; ++j) orow[tx + 16 * j] = acc[i][j] / den;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 body: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <int HD>
struct Bf16Tile {
  static constexpr int NT = 128;     // 4 warps x 16 query rows
  static constexpr int P = HD + 8;   // smem row pitch in elements: rows
                                     // land 16 bytes apart mod 128, so
                                     // ldmatrix reads are conflict-free
  static constexpr size_t smem = sizeof(bf16) * (BQ + 2 * BK) * P;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a [rows, HD] matrix with row stride `stride`
// into shared memory (pitch P), 16 bytes per thread per step; rows at or
// past `valid` are zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int valid, int tid) {
  constexpr int P = Bf16Tile<HD>::P, CH = HD / 8;
  for (int i = tid; i < 64 * CH; i += Bf16Tile<HD>::NT) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      x = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = x;
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                   int Tk, int group, Strides st, float scale, int causal,
                   int window, float softcap) {
  constexpr int P = Bf16Tile<HD>::P;
  constexpr int KC = HD / 16;  // 16-wide head-dim chunks of Q.K^T
  constexpr int SN = BK / 8;   // 8-key column tiles of the score block
  constexpr int ON = HD / 8;   // 8-wide column tiles of the output

  extern __shared__ uint4 smem_v[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_v);  // [BQ][P]
  bf16* Ks = Qs + BQ * P;                      // [BK][P]
  bf16* Vs = Ks + BK * P;                      // [BK][P]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // long rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  q += b * st.qb + h * st.qh;
  k += b * st.kb + hk * st.kh;
  v += b * st.vb + hk * st.vh;
  o += b * st.ob + h * st.oh;

  load_tile<HD>(Qs, q, st.qs, q0, S, tid);

  // ldmatrix: lane l addresses row (l & 7) of 8x8 matrix (l >> 3)
  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t qa = smem_addr(Qs + (warp * 16 + lr + (lm & 1) * 8) * P +
                                (lm >> 1) * 8);
  const uint32_t ka = smem_addr(Ks + (lr + (lm >> 1) * 8) * P + (lm & 1) * 8);
  const uint32_t va = smem_addr(Vs + (lr + (lm & 1) * 8) * P + (lm >> 1) * 8);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous step is done with Ks and Vs
    load_tile<HD>(Ks, k, st.ks, k0, Tk, tid);
    load_tile<HD>(Vs, v, st.vs, k0, Tk, tid);
    __syncthreads();

    // scores: this warp's 16 rows x 64 keys, fp32 fragments
    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      ldsm_x4(a, qa + kc * 16 * sizeof(bf16));
#pragma unroll
      for (int j = 0; j < SN; j += 2) {
        uint32_t bk[4];  // key tiles j and j+1, head-dim chunk kc
        ldsm_x4(bk, ka + (j * 8 * P + kc * 16) * sizeof(bf16));
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // online softmax; fragment element e sits in row[e >> 1]
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + t4 * 2 + (e & 1);
        s[j][e] = visible(row[e >> 1], kpos, Tk, causal, window)
                      ? logit(s[j][e], scale, softcap)
                      : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the 4 threads of a row are one quad: xor 1, 2 stays inside it
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);  // 0 on the first step
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < ON; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P.V: the score fragments of key tiles 2c, 2c+1 are the A
    // fragment of the 16-key chunk c
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int j = 0; j < ON; j += 2) {
        uint32_t bv[4];  // output tiles j and j+1, keys 16c..16c+15
        ldsm_x4_trans(bv, va + (c * 16 * P + j * 8) * sizeof(bf16));
        mma_bf16(acc[j], a, bv[0], bv[1]);
        mma_bf16(acc[j + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* orow = o + row[i] * st.os + t4 * 2;
#pragma unroll
    for (int j = 0; j < ON; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 body at head dims 64 and 128: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int THREADS = 160;       // a consumer warpgroup and a producer warp
constexpr int BOX = 64 * 64 * 2;   // one 64-row x 64-head-dim box, bytes
constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU op (relative error ~2^-22; P is rounded to bf16 anyway);
// 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Cfg {
  static constexpr int NB = HD / 64;      // boxes across the head dim
  static constexpr int TILE = NB * BOX;   // a [64][HD] tile
  // stages of K and of V each: as many as leave two CTAs an SM (2 x 114,792
  // bytes at hd 128, with the SM's 1 KB a CTA)
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int SMEM = TILE + STAGES * 2 * TILE + (1 + 4 * STAGES) * 8;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)  // <= 200 registers a thread
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    bf16* __restrict__ o, int S, int Tk, int group,
                    long long ob, long long os, long long oh, float scale,
                    int causal, int window, float softcap) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* Qs = smem_raw;
  uint8_t* Kst = Qs + C::TILE;                  // K ring
  uint8_t* Vst = Kst + C::STAGES * C::TILE;     // V ring
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vst + C::STAGES * C::TILE);
  uint64_t* kfull = qbar + 1;
  uint64_t* kempty = kfull + C::STAGES;
  uint64_t* vfull = kempty + C::STAGES;
  uint64_t* vempty = vfull + C::STAGES;

  // the query block is the slowest grid dimension, reversed: the longest
  // rows of every head start first, the short ones fill in behind them
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int nblk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  check_align1024(smem_raw);
  if (threadIdx.x == 128) {
    prefetch_tensor_map(&qmap);
    prefetch_tensor_map(&kmap);
    prefetch_tensor_map(&vmap);
  }
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 128);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: one thread loads Q, then keeps the K and V rings full
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(qbar, C::TILE);
#pragma unroll
      for (int nb = 0; nb < C::NB; ++nb)
        tma_load_4d(Qs + nb * BOX, &qmap, qbar, 64 * nb, h, q0, b);
      for (int j = 0; j < nblk; ++j) {
        const int s = j % C::STAGES, k0 = k_begin + j * BK;
        const uint32_t free = ((j / C::STAGES) & 1) ^ 1;
        mbar_wait(&kempty[s], free);
        mbar_arrive_expect_tx(&kfull[s], C::TILE);
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
          tma_load_4d(Kst + s * C::TILE + nb * BOX, &kmap, &kfull[s],
                      64 * nb, hk, k0, b);
        mbar_wait(&vempty[s], free);
        mbar_arrive_expect_tx(&vfull[s], C::TILE);
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
          tma_load_4d(Vst + s * C::TILE + nb * BOX, &vmap, &vfull[s],
                      64 * nb, hk, k0, b);
      }
    }
  } else {
    // consumer: warp w owns query rows 16 w .. 16 w + 15 of the block
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float sacc[32];
    uint32_t pa[4][4];  // P of the previous block, the A of its P V
    const uint32_t qa = smem_u32(Qs);
    const float scale2 = scale * kLog2e;

    // S = Q K^T of block j into sacc: both K-major; a k16 step is 32
    // bytes along a 128-byte row, four steps a box
    auto issue_s = [&](int j) {
      const int s = j % C::STAGES;
      mbar_wait(&kfull[s], (j / C::STAGES) & 1);
      const uint32_t ka = smem_u32(Kst + s * C::TILE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        wgmma_ss<0, 0>(sacc, desc_sw128(qa + off, 16, 1024),
                       desc_sw128(ka + off, 16, 1024), kk);
      }
      wgmma_commit();
    };
    // O += P V of block j: P from registers; V is N-contiguous
    // (transposed), a k16 step is 16 rows down, its 64-wide head-dim
    // boxes BOX apart
    auto issue_pv = [&](int j) {
      const int s = j % C::STAGES;
      mbar_wait(&vfull[s], (j / C::STAGES) & 1);
      const uint32_t va = smem_u32(Vst + s * C::TILE);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_rs<1>(oacc, pa[c], desc_sw128(va + c * 2048, BOX, 1024), 1);
      wgmma_commit();
    };
    // online softmax of block j in base 2 (logits times log2 e, so each
    // exp is one ex2); sacc element e is row[(e >> 1) & 1], key
    // k0 + 8 (e >> 2) + 2 t4 + (e & 1). Only blocks on the T edge, the
    // causal diagonal or the window's edge are masked. Leaves P in sacc
    // (float) and the rows' rescale factors in alpha.
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int k0 = k_begin + j * BK;
      const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
      const bool plain = softcap <= 0.f && !edge;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      if (plain) {
        // the common block (inside T, below the diagonal, no cap): the max
        // of the raw scores, the scale folded into each exp's FFMA below
#pragma unroll
        for (int e = 0; e < 32; ++e)
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
        mx[0] *= scale2;
        mx[1] *= scale2;
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          float x = softcap > 0.f ? logit(sacc[e], scale, softcap) * kLog2e
                                  : sacc[e] * scale2;
          if (edge && !visible(row[(e >> 1) & 1],
                               k0 + (e >> 2) * 8 + t4 * 2 + (e & 1), Tk,
                               causal, window))
            x = NEG_INF;
          sacc[e] = x;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
        }
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = ex2(m[i] - m_new);  // 0 on the first block
        m[i] = m_new;
      }
      if (plain) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          sacc[e] = ex2(fmaf(sacc[e], scale2, -m[(e >> 1) & 1]));
          sum[(e >> 1) & 1] += sacc[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          sacc[e] = ex2(sacc[e] - m[(e >> 1) & 1]);
          sum[(e >> 1) & 1] += sacc[e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
    };
    // the fragments of key tiles 2c and 2c + 1 are the A registers of the
    // 16-key step c
    auto pack_p = [&]() {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pa[c][0] = pack_bf16(sacc[8 * c], sacc[8 * c + 1]);
        pa[c][1] = pack_bf16(sacc[8 * c + 2], sacc[8 * c + 3]);
        pa[c][2] = pack_bf16(sacc[8 * c + 4], sacc[8 * c + 5]);
        pa[c][3] = pack_bf16(sacc[8 * c + 6], sacc[8 * c + 7]);
      }
    };

    // rescales O by block j's alpha before block j's P V
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    };

    mbar_wait(qbar, 0);
    if (nblk > 0) {
      float alpha[2];
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sacc);
      mbar_arrive(&kempty[0]);
      softmax(0, alpha);
      pack_p();
      // block j's S and block j - 1's P V go to the tensor cores together;
      // O's rescale runs under S, block j's softmax under P V
      for (int j = 1; j < nblk; ++j) {
        issue_s(j);
        rescale(alpha);
        issue_pv(j - 1);
        wgmma_wait<1>();  // S of block j is done
        fence_regs(sacc);
        mbar_arrive(&kempty[j % C::STAGES]);
        softmax(j, alpha);
        wgmma_wait<0>();  // P V of block j - 1 is done
        fence_regs(oacc);
        mbar_arrive(&vempty[(j - 1) % C::STAGES]);
        pack_p();
      }
      rescale(alpha);
      issue_pv(nblk - 1);
      wgmma_wait<0>();
      fence_regs(oacc);
      mbar_arrive(&vempty[(nblk - 1) % C::STAGES]);
    }

    o += b * ob + h * oh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= S) continue;
      const float den = fmaxf(l[i], 1e-30f);
      bf16* orow = o + row[i] * os + t4 * 2;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(orow + jj * 8) =
            __floats2bfloat162_rn(oacc[4 * jj + 2 * i] / den,
                                  oacc[4 * jj + 2 * i + 1] / den);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int Hq, int Hkv, const Strides& st, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  using C = Cfg<HD>;
  // 4-D maps [B, rows, heads, hd], innermost first, over each view's own
  // strides and extents (S for q, T for k and v)
  const uint32_t box[4] = {64, 1, 64, 1};
  const uint64_t qd[4] = {HD, uint64_t(Hq), uint64_t(S), uint64_t(B)};
  const uint64_t kd[4] = {HD, uint64_t(Hkv), uint64_t(Tk), uint64_t(B)};
  const uint64_t qs[3] = {uint64_t(st.qh), uint64_t(st.qs), uint64_t(st.qb)};
  const uint64_t ks[3] = {uint64_t(st.kh), uint64_t(st.ks), uint64_t(st.kb)};
  const uint64_t vs[3] = {uint64_t(st.vh), uint64_t(st.vs), uint64_t(st.vb)};
  CUtensorMap qm, km, vm;
  int err = make_tensor_map_bf16(&qm, q, 4, qd, qs, box);
  if (err == 0) err = make_tensor_map_bf16(&km, k, 4, kd, ks, box);
  if (err == 0) err = make_tensor_map_bf16(&vm, v, 4, kd, vs, box);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(Hq, B, (S + BQ - 1) / BQ);
  flash_fwd_wgmma<HD><<<grid, THREADS, C::SMEM, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), S, Tk, Hq / Hkv, st.ob, st.os, st.oh,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int Hq, int Hkv, const Strides& st,
                   float scale, int causal, int window, float softcap,
                   cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  using F32 = F32Tile<HD>;
  using Bf = Bf16Tile<HD>;
  auto kernel = kBf16 ? reinterpret_cast<const void*>(flash_fwd_bf16<HD>)
                      : reinterpret_cast<const void*>(flash_fwd_f32<HD>);
  const size_t smem = kBf16 ? Bf::smem : F32::smem;
  const int threads = kBf16 ? Bf::NT : F32::NT;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  if constexpr (kBf16)
    flash_fwd_bf16<HD><<<grid, threads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Tk, Hq / Hkv,
        st, scale, causal, window, softcap);
  else
    flash_fwd_f32<HD><<<grid, threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, Tk,
        Hq / Hkv, st, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int S, int Tk, int Hq, int Hkv,
                        const Strides& st, float scale, int causal,
                        int window, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, Tk, Hq, Hkv, st, scale, causal,
                           window, softcap, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, Tk, Hq, Hkv, st, scale, causal,
                           window, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, Tk, Hq, Hkv, st, scale, causal,
                           window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, Tk, Hq, Hkv, st, scale, causal,
                            window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, Tk, Hq, Hkv, st, scale, causal,
                            window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, seq, head) for q, k, v, o. For bfloat16 every pointer must be
// 16-byte aligned and every stride a multiple of 8 (the caller checks).
// body: 0 = the dtype's mma_sync / FMA body, 1 = the TMA + wgmma body
// (bfloat16 at hd 64 or 128; anything else is refused). Returns
// cudaGetLastError() after the launch (0 on success), or
// hopper::kTensorMapError + the CUresult if a tensor map is refused.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int Tk, int Hq, int Hkv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss, long long osh,
    float scale, int causal, int window, float softcap, int body,
    void* stream) {
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    if (hd == 64)
      return wg::launch<64>(q, k, v, o, B, S, Tk, Hq, Hkv, st, scale, causal,
                            window, softcap, s);
    if (hd == 128)
      return wg::launch<128>(q, k, v, o, B, S, Tk, Hq, Hkv, st, scale,
                             causal, window, softcap, s);
    return cudaErrorInvalidValue;
  }
  if (body != 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, S, Tk, Hq, Hkv, st, scale,
                              causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<bf16>(hd, q, k, v, o, B, S, Tk, Hq, Hkv, st, scale,
                             causal, window, softcap, s);
  return cudaErrorInvalidValue;
}

// every body kernel, for a captured graph's count (graph_nodes.cuh)
const graph_nodes::GraphEntry kGraphEntries[] = {
    {reinterpret_cast<const void*>(flash_fwd_f32<16>), "fma"},
    {reinterpret_cast<const void*>(flash_fwd_f32<32>), "fma"},
    {reinterpret_cast<const void*>(flash_fwd_f32<64>), "fma"},
    {reinterpret_cast<const void*>(flash_fwd_f32<128>), "fma"},
    {reinterpret_cast<const void*>(flash_fwd_f32<256>), "fma"},
    {reinterpret_cast<const void*>(flash_fwd_bf16<16>), "mma_sync"},
    {reinterpret_cast<const void*>(flash_fwd_bf16<32>), "mma_sync"},
    {reinterpret_cast<const void*>(flash_fwd_bf16<64>), "mma_sync"},
    {reinterpret_cast<const void*>(flash_fwd_bf16<128>), "mma_sync"},
    {reinterpret_cast<const void*>(flash_fwd_bf16<256>), "mma_sync"},
    {reinterpret_cast<const void*>(wg::flash_fwd_wgmma<64>), "wgmma"},
    {reinterpret_cast<const void*>(wg::flash_fwd_wgmma<128>), "wgmma"},
};

extern "C" int graph_entries(const void** funcs, const char** bodies,
                             int max) {
  return graph_nodes::entries(kGraphEntries, funcs, bodies, max);
}

extern "C" int graph_functions(void* graph, const void** funcs, int max) {
  return graph_nodes::functions(graph, funcs, max);
}
