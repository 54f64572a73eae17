// Flash attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel): causal, optionally sliding-window and
// softcapped GQA attention, blockwise online softmax with float32 m, l and
// accumulator, masked logits set to -2.3819763e38, l floored at 1e-30.
//
// Layout: q [B,S,Hq,hd], k/v [B,T,Hkv,hd], o [B,S,Hq,hd], read and written
// through their batch, sequence and head strides (head_dim is unit-stride),
// so no transposed copies are made. kv head = q head / (Hq / Hkv).
//
// Design. The TPU kernel walks a sequential (q block, k block) grid with
// 512x512 tiles and an fp32 [block_q, hd] accumulator in VMEM; at hd 128
// that accumulator alone is 256 KB, more than one block's 227 KB of shared
// memory. Here one CTA owns one (batch, q head, 64-row query block) and
// loops over 64-row key blocks inside the block, so nothing is carried
// between CTAs; the accumulator lives in registers. The key loop starts at
// the window's edge and stops at the causal diagonal, so blocks above the
// diagonal or outside the window are never loaded. Ragged S and T are
// masked (the TPU kernel asserts S % block_q == 0). Two bodies, chosen by
// dtype:
//  - bfloat16 (the serving path): 4 warps, each owning 16 query rows, on
//    the tensor cores with mma.sync m16n8k16 (fp32 accumulation). Q, K and
//    V tiles sit in shared memory and reach the tensor cores through
//    ldmatrix; the score fragment becomes the A operand of P.V in
//    registers (P rounded to bf16), so P never touches shared memory.
//  - float32: 256 threads as a 16x16 grid on fp32 FMA, tiles staged as
//    float in shared memory, 4 query rows per thread; keeps float32 from
//    load to store.
// In both, the 4 (mma) or 16 (FMA) threads that share a row reduce its
// running max and sum with warp shuffles.
//
// Bound. At the serving path's prefill shapes (S = T <= ~1k, Hq 24, Hkv 8,
// hd 128, bf16) the function moves ~8 MB and does ~1.6 GFLOP per call, so
// on an H100 it is bound by bytes (~2.5 us at 3.35 TB/s) rather than by
// the bf16 tensor-core rate (~1.6 us). These bodies load tiles without
// overlapping copies and compute (no cp.async/TMA pipeline) and use
// mma.sync rather than wgmma; both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int Tk, int Hq, int Hkv, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss, long long osh,
    float scale, int causal, int window, float softcap, void* stream) {
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, S, Tk, Hq, Hkv, st, scale,
                              causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<bf16>(hd, q, k, v, o, B, S, Tk, Hq, Hkv, st, scale,
                             causal, window, softcap, s);
  return cudaErrorInvalidValue;
}
