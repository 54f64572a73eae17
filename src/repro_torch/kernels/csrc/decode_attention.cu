// Decode attention for NVIDIA Hopper (sm_90a), plain C interface: one query
// token a lane against that lane's keys and values in the serving cache.
//
// Replaces no TPU kernel. The reference's decode attention
// (repro/models/attention.py::decode_attention) is plain jnp; this kernel was
// added for the port's decode step, whose plain version permuted every
// lane's whole cache into contiguous copies for two batched GEMMs and then
// masked most of it away.
//
// Function: for lane b and query head h (kv head h / G, G = Hq / Hkv), the
// softmax over positions t in [lo, hi) of q.k_t * scale (softcapped when
// softcap > 0: tanh(x / softcap) * softcap), applied to v_t; hi =
// min(index[b], L - 1) + 1 and lo = max(0, index[b] - window + 1) with a
// sliding window, else 0. Positions outside [lo, hi) are never read. Softmax
// and sums in float32; the output in q's dtype. index[b] lies in [0, L).
//
// Layout: q [B,1,Hq,hd], k/v [B,L,Hkv,hd] read through their batch, position
// and head strides (head_dim unit-stride): k and v are the engine's per-layer
// cache views, not copies. o [B,1,Hq,hd] contiguous. index [B] int64.
//
// Bound. Per position and kv head the function reads 2 * hd elements of k
// and v and does 4 * G * hd FLOP on them: at phi4's G = 3 in bf16, 3 FLOP
// a byte, against the ~295 at which the card's tensor cores would become
// the limit. So it is bound by bytes: a lane's valid k and v read once
// (32 lanes at ~3,460 positions, 8 kv heads, hd 128: 0.45 GB a layer, 0.14
// ms at 3.35 TB/s). Every choice below serves the bytes:
//  - split-KV ("flash-decoding"): one CTA per (split of `split` positions,
//    kv head and 16-row group of its query heads, lane). A CTA whose split
//    starts at or past its lane's hi exits at once, so a lane costs in
//    proportion to its length, and B * Hkv * splits CTAs fill the card where
//    B * Hkv alone (256) would leave SMs idle through a long lane. A second
//    kernel (decode_attn_merge) merges the splits' float32 partials (m, l,
//    unnormalised o), ~0.6% of the bytes at phi4's shapes.
//  - k and v are read once, by the CTA that owns the kv head, for all G
//    query heads of the group together.
//  - bf16 body (mma): 4 warps, each streaming its own 16-position chunks
//    (chunk c of the split to warp c mod 4) through its own 3-stage ring of
//    cp.async copies (16 bytes a thread, L2 only), so a warp waits only for
//    its own data and each SM keeps ~140 KB of k and v in flight at two
//    CTAs an SM (hd 128). Rows past hi are zero-filled by cp.async's
//    src-size 0, which reads nothing. The G query rows (padded to 16) sit
//    in registers as the m16n8k16 A fragment; S = Q K^T and O += P V run
//    on the tensor cores
//    with mma.sync (P rounded to bf16, as the plain version rounds its
//    probabilities to q's dtype), the online softmax on the fp32 fragments
//    in base 2. The tensor cores do 16 rows where G are useful; they have
//    ~100 times the rate this needs. The four warps' partials merge through
//    shared memory, each warp writing its own slice and one pass summing
//    them: float atomics on one shared slice (a compare-and-swap loop under
//    contention) cost ~28 us a CTA, which doubled the kernel's time at
//    phi4's serving shapes on an H100 (0.344 against 0.169 ms).
//  - float32 body (fma): a plain CUDA-core version for float32 models
//    (Gemma's examples); right, not fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include "graph_nodes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 16;   // query rows of a CTA (one mma row tile)
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  int L, Hq, Hkv, G, RT, split, ns;  // RT: 16-row tiles a kv head's group
  long long qb, qh, kb, ks, kh, vb, vs, vh;
  float scale, softcap;
  int window;
};

// the positions [lo, hi) lane b attends
__device__ __forceinline__ void span_of(const long long* index, int b, int L,
                                        int window, int& lo, int& hi) {
  const long long i = index[b];
  hi = static_cast<int>(min(i, static_cast<long long>(L) - 1)) + 1;
  lo = window > 0 ? static_cast<int>(max(0ll, i - window + 1)) : 0;
}

// a raw dot product as a logit in base 2 (scaled, softcapped, times log2 e)
__device__ __forceinline__ float logit2(float dot, float scale,
                                        float softcap) {
  float x = dot * scale;
  if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
  return x * kLog2e;
}

// ---------------------------------------------------------------------------
// bf16 body: cp.async rings, mma.sync m16n8k16
// ---------------------------------------------------------------------------

template <int HD>
struct Mma {
  static constexpr int WARPS = 4, NT = 32 * WARPS;
  static constexpr int STAGES = 3;
  static constexpr int CH = 16;        // positions a chunk (the k of P V)
  static constexpr int P = HD + 8;     // smem pitch in elements: rows land
                                       // 16 bytes apart mod 128, so the
                                       // ldmatrix reads are conflict-free
  static constexpr int STAGE = 2 * CH * P;  // a chunk's k and v rows
  static constexpr size_t ring = sizeof(bf16) * WARPS * STAGES * STAGE;
  // Q, then the rings; the warps' merge reuses the rings. Two CTAs an SM
  // at hd 128 (2 x 108,800 bytes)
  static constexpr size_t smem = sizeof(bf16) * ROWS * P + ring;
  static_assert(sizeof(float) * WARPS * ROWS * (HD + 2) <= ring,
                "the merge scratch must fit in the rings");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, through L2 only; `bytes` 0 writes zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// chunk [p0, p0 + 16) of k and v into one ring stage of a warp; rows at or
// past hi are zero-filled without a read
template <int HD>
__device__ __forceinline__ void load_chunk(bf16* stage, const bf16* k,
                                           const bf16* v, long long ks,
                                           long long vs, int p0, int hi,
                                           int lane) {
  constexpr int P = Mma<HD>::P, CPR = HD / 8;  // 16-byte pieces a row
  bf16* vst = stage + Mma<HD>::CH * P;
#pragma unroll
  for (int it = 0; it < Mma<HD>::CH * CPR / 32; ++it) {
    const int i = lane + 32 * it, r = i / CPR, c = (i % CPR) * 8;
    const bool in = p0 + r < hi;
    const long long p = in ? p0 + r : p0;  // p0 < hi: a valid address
    cp_async16(smem_addr(stage + r * P + c), k + p * ks + c, in ? 16 : 0);
    cp_async16(smem_addr(vst + r * P + c), v + p * vs + c, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(Mma<HD>::NT)
    decode_attn_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const long long* __restrict__ index,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    Args a) {
  using C = Mma<HD>;
  constexpr int P = C::P, KC = HD / 16, ON = HD / 8, ST = C::STAGES;
  const int sp = blockIdx.x, hy = blockIdx.y, b = blockIdx.z;
  const int kvh = hy / a.RT, g0 = hy % a.RT * ROWS;
  const int rows = min(ROWS, a.G - g0);
  int lo, hi;
  span_of(index, b, a.L, a.window, lo, hi);
  const int s0 = lo + sp * a.split;
  if (s0 >= hi) return;  // past the lane's position: nothing to read
  const int s1 = min(hi, s0 + a.split);

  extern __shared__ uint4 smem_v[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_v);  // [ROWS][P]
  bf16* ring = Qs + ROWS * P;                  // [WARPS][ST][STAGE]
  // after the loop the rings hold each warp's rows of O, then its m and l
  float* Os = reinterpret_cast<float*>(ring);  // [WARPS][ROWS][HD]
  float* Wm = Os + C::WARPS * ROWS * HD;       // [WARPS][ROWS]
  float* Wl = Wm + C::WARPS * ROWS;            // [WARPS][ROWS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  q += b * a.qb + (kvh * a.G + g0) * a.qh;
  k += b * a.kb + kvh * a.kh;
  v += b * a.vb + kvh * a.vh;

  // this warp's chunks: c = warp, warp + 4, ... of the split's nc
  bf16* mine = ring + warp * ST * C::STAGE;
  const int nc = (s1 - s0 + C::CH - 1) / C::CH;
  const int n = nc > warp ? (nc - warp + C::WARPS - 1) / C::WARPS : 0;
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < n)
      load_chunk<HD>(mine + i * C::STAGE, k, v, a.ks, a.vs,
                     s0 + (warp + i * C::WARPS) * C::CH, s1, lane);
    cp_commit();
  }

  // the group's query rows, zero past G, then their A fragments
  for (int i = tid; i < ROWS * HD / 8; i += C::NT) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) x = *reinterpret_cast<const uint4*>(q + r * a.qh + c);
    *reinterpret_cast<uint4*>(Qs + r * P + c) = x;
  }
  __syncthreads();
  // ldmatrix: lane l addresses row (l & 7) of 8x8 matrix (l >> 3)
  const int lr = lane & 7, lm = lane >> 3;
  uint32_t qf[KC][4];
  {
    const uint32_t qa =
        smem_addr(Qs + (lr + (lm & 1) * 8) * P + (lm >> 1) * 8);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm_x4(qf[kc], qa + kc * 16 * sizeof(bf16));
  }
  const uint32_t ka = (lr + (lm >> 1) * 8) * P + (lm & 1) * 8;  // elements
  const uint32_t va = (lr + (lm & 1) * 8) * P + (lm >> 1) * 8;

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float acc[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_wait<ST - 2>();  // chunk i has landed (this thread's copies) ...
    __syncwarp();       // ... and every lane's
    if (i + ST - 1 < n)  // into the stage chunk i - 1 left
      load_chunk<HD>(mine + (i + ST - 1) % ST * C::STAGE, k, v, a.ks, a.vs,
                     s0 + (warp + (i + ST - 1) * C::WARPS) * C::CH, s1, lane);
    cp_commit();
    const bf16* kst = mine + i % ST * C::STAGE;
    const uint32_t kaddr = smem_addr(kst + ka);
    const uint32_t vaddr = smem_addr(kst + C::CH * P + va);
    const int p0 = s0 + (warp + i * C::WARPS) * C::CH;

    // scores of 16 rows x 16 positions (two 8-position tiles)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t bk[4];
      ldsm_x4(bk, kaddr + kc * 16 * sizeof(bf16));
      mma_bf16(s[0], qf[kc], bk[0], bk[1]);
      mma_bf16(s[1], qf[kc], bk[2], bk[3]);
    }

    // online softmax in base 2; element e of a tile sits in row g + 8 (e >> 1)
    // (a chunk holds at least one valid position, so m stays finite)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + j * 8 + t4 * 2 + (e & 1);
        s[j][e] = pos < s1 ? logit2(s[j][e], a.scale, a.softcap)
                           : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a row are one quad: xor 1, 2 stays inside it
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);  // 0 on the first chunk
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];  // this thread's columns; the quad sums later
      }
#pragma unroll
    for (int j = 0; j < ON; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    // O += P V: the two score tiles are the A fragment of the 16 positions
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < ON; j += 2) {
      uint32_t bv[4];  // output tiles j and j + 1
      ldsm_x4_trans(bv, vaddr + j * 8 * sizeof(bf16));
      mma_bf16(acc[j], pa, bv[0], bv[1]);
      mma_bf16(acc[j + 1], pa, bv[2], bv[3]);
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // merge the warps: each warp's rows into its own slice, then summed,
  // each scaled to the CTA's max (a warp without a chunk has m = -inf)
  float* Ow = Os + warp * ROWS * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t4 == 0) {
      Wm[warp * ROWS + g + 8 * r] = m[r];
      Wl[warp * ROWS + g + 8 * r] = l[r];
    }
    if (g + 8 * r < rows && n > 0) {
#pragma unroll
      for (int j = 0; j < ON; ++j)
        *reinterpret_cast<float2*>(Ow + (g + 8 * r) * HD + j * 8 + t4 * 2) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
  __syncthreads();
  // the split's partial of each real row: o, then (m, l)
  const long long row0 =
      (static_cast<long long>(b) * a.Hq + kvh * a.G + g0) * a.ns + sp;
  for (int i = tid; i < rows * HD; i += C::NT) {
    const int r = i / HD;
    float mm = -CUDART_INF_F, o = 0.f;
#pragma unroll
    for (int w = 0; w < C::WARPS; ++w) mm = fmaxf(mm, Wm[w * ROWS + r]);
#pragma unroll
    for (int w = 0; w < C::WARPS; ++w) {
      const float wm = Wm[w * ROWS + r];
      if (wm > -CUDART_INF_F) o += Os[w * ROWS * HD + i] * exp2f(wm - mm);
    }
    part_o[(row0 + static_cast<long long>(r) * a.ns) * HD + i % HD] = o;
  }
  if (tid < rows) {
    float mm = -CUDART_INF_F, ll = 0.f;
    for (int w = 0; w < C::WARPS; ++w) mm = fmaxf(mm, Wm[w * ROWS + tid]);
    for (int w = 0; w < C::WARPS; ++w) {
      const float wm = Wm[w * ROWS + tid];
      if (wm > -CUDART_INF_F) ll += Wl[w * ROWS + tid] * exp2f(wm - mm);
    }
    part_ml[(row0 + static_cast<long long>(tid) * a.ns) * 2] = mm;
    part_ml[(row0 + static_cast<long long>(tid) * a.ns) * 2 + 1] = ll;
  }
}

// ---------------------------------------------------------------------------
// float32 body: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int FMA_NT = 128;
constexpr int FMA_SPLIT = 128;  // positions a CTA at most

template <int HD>
__global__ void __launch_bounds__(FMA_NT)
    decode_attn_fma(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const long long* __restrict__ index,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    Args a) {
  __shared__ float Qs[ROWS][HD];
  __shared__ float Ps[ROWS][FMA_SPLIT];
  const int sp = blockIdx.x, hy = blockIdx.y, b = blockIdx.z;
  const int kvh = hy / a.RT, g0 = hy % a.RT * ROWS;
  const int rows = min(ROWS, a.G - g0);
  int lo, hi;
  span_of(index, b, a.L, a.window, lo, hi);
  const int s0 = lo + sp * a.split;
  if (s0 >= hi) return;
  const int n = min(hi, s0 + a.split) - s0;
  const int tid = threadIdx.x;
  q += b * a.qb + (kvh * a.G + g0) * a.qh;
  k += b * a.kb + kvh * a.kh + s0 * a.ks;
  v += b * a.vb + kvh * a.vh + s0 * a.vs;

  for (int i = tid; i < rows * HD; i += FMA_NT)
    Qs[i / HD][i % HD] = q[(i / HD) * a.qh + i % HD];
  __syncthreads();
  for (int i = tid; i < rows * n; i += FMA_NT) {
    const int r = i / n, t = i % n;
    const float* kt = k + t * a.ks;
    float dot = 0.f;
#pragma unroll 8
    for (int h = 0; h < HD; ++h) dot = fmaf(Qs[r][h], kt[h], dot);
    Ps[r][t] = logit2(dot, a.scale, a.softcap);
  }
  __syncthreads();
  __shared__ float Ms[ROWS], Ls[ROWS];
  if (tid < rows) {
    float mm = -CUDART_INF_F, ll = 0.f;
    for (int t = 0; t < n; ++t) mm = fmaxf(mm, Ps[tid][t]);
    for (int t = 0; t < n; ++t) {
      const float p = exp2f(Ps[tid][t] - mm);
      Ps[tid][t] = p;
      ll += p;
    }
    Ms[tid] = mm;
    Ls[tid] = ll;
  }
  __syncthreads();
  const long long row0 =
      (static_cast<long long>(b) * a.Hq + kvh * a.G + g0) * a.ns + sp;
  for (int i = tid; i < rows * HD; i += FMA_NT) {
    const int r = i / HD, h = i % HD;
    float o = 0.f;
    for (int t = 0; t < n; ++t) o = fmaf(Ps[r][t], v[t * a.vs + h], o);
    part_o[(row0 + static_cast<long long>(r) * a.ns) * HD + h] = o;
  }
  if (tid < rows) {
    part_ml[(row0 + static_cast<long long>(tid) * a.ns) * 2] = Ms[tid];
    part_ml[(row0 + static_cast<long long>(tid) * a.ns) * 2 + 1] = Ls[tid];
  }
}

// ---------------------------------------------------------------------------
// merge of the splits: one CTA per (query head, lane), a thread per column
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(bf16* o, float x) {
  *o = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void decode_attn_merge(const float* __restrict__ part_o,
                                  const float* __restrict__ part_ml,
                                  const long long* __restrict__ index,
                                  T* __restrict__ o, int hd, Args a) {
  const int h = blockIdx.x, b = blockIdx.y, col = threadIdx.x;
  int lo, hi;
  span_of(index, b, a.L, a.window, lo, hi);
  const int nsp = hi > lo ? (hi - lo + a.split - 1) / a.split : 0;
  const long long row = static_cast<long long>(b) * a.Hq + h;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + row * a.ns;
  const float* po = part_o + row * a.ns * hd + col;
  // one pass, rescaling to a running max (every split has a finite m)
  float mm = -CUDART_INF_F, num = 0.f, den = 0.f;
#pragma unroll 4
  for (int s = 0; s < nsp; ++s) {
    const float2 x = ml[s];
    const float ov = po[s * hd];
    const float m_new = fmaxf(mm, x.x);
    const float alpha = exp2f(mm - m_new), w = exp2f(x.x - m_new);
    den = den * alpha + w * x.y;
    num = num * alpha + w * ov;
    mm = m_new;
  }
  store(o + row * hd + col, den > 0.f ? num / den : 0.f);
}

// both kernels of one call at head dim HD: dtype 1 the bf16 body, else the
// float32 body, then the merge
template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v,
           const long long* index, void* o, float* part_o, float* part_ml,
           int B, const Args& a, cudaStream_t s) {
  const dim3 grid(a.ns, a.Hkv * a.RT, B);  // (split, head group, lane)
  const dim3 merge(a.Hq, B);
  cudaError_t e;
  if (dtype == 1) {
    constexpr int smem = static_cast<int>(Mma<HD>::smem);
    e = cudaFuncSetAttribute(decode_attn_mma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    decode_attn_mma<HD><<<grid, Mma<HD>::NT, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), index, part_o, part_ml, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    decode_attn_merge<bf16><<<merge, HD, 0, s>>>(
        part_o, part_ml, index, static_cast<bf16*>(o), HD, a);
  } else {
    decode_attn_fma<HD><<<grid, FMA_NT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), index, part_o, part_ml, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    decode_attn_merge<float><<<merge, HD, 0, s>>>(
        part_o, part_ml, index, static_cast<float*>(o), HD, a);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (the fma body), 1 bfloat16 (the mma body). part_o
// [B,Hq,ns,hd] and part_ml [B,Hq,ns,2] float32 scratch; ns * split must
// cover the longest span a lane can attend (L, or the window). Returns 0 or
// a cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const long long* index,
    void* o, float* part_o, float* part_ml, int dtype, int B, int L, int Hq,
    int Hkv, int hd, long long qsb, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale, int window, float softcap, int split, int ns,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || split <= 0 || ns <= 0)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const Args a{L,   Hq,  Hkv, G,   (G + ROWS - 1) / ROWS, split, ns,
               qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, scale, softcap, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 ? split % Mma<16>::CH != 0
                 : (dtype != 0 || split > FMA_SPLIT))
    return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, index, o, part_o, part_ml,
                               B, a, s);
    case 32: return launch<32>(dtype, q, k, v, index, o, part_o, part_ml,
                               B, a, s);
    case 64: return launch<64>(dtype, q, k, v, index, o, part_o, part_ml,
                               B, a, s);
    case 128: return launch<128>(dtype, q, k, v, index, o, part_o,
                                 part_ml, B, a, s);
    case 256: return launch<256>(dtype, q, k, v, index, o, part_o,
                                 part_ml, B, a, s);
  }
  return cudaErrorInvalidValue;
}

// every body kernel, for a captured graph's count (graph_nodes.cuh); the
// merge runs in the same call as either body
const graph_nodes::GraphEntry kGraphEntries[] = {
    {reinterpret_cast<const void*>(decode_attn_mma<16>), "mma"},
    {reinterpret_cast<const void*>(decode_attn_mma<32>), "mma"},
    {reinterpret_cast<const void*>(decode_attn_mma<64>), "mma"},
    {reinterpret_cast<const void*>(decode_attn_mma<128>), "mma"},
    {reinterpret_cast<const void*>(decode_attn_mma<256>), "mma"},
    {reinterpret_cast<const void*>(decode_attn_fma<16>), "fma"},
    {reinterpret_cast<const void*>(decode_attn_fma<32>), "fma"},
    {reinterpret_cast<const void*>(decode_attn_fma<64>), "fma"},
    {reinterpret_cast<const void*>(decode_attn_fma<128>), "fma"},
    {reinterpret_cast<const void*>(decode_attn_fma<256>), "fma"},
};

extern "C" int graph_entries(const void** funcs, const char** bodies,
                             int max) {
  return graph_nodes::entries(kGraphEntries, funcs, bodies, max);
}

extern "C" int graph_functions(void* graph, const void** funcs, int max) {
  return graph_nodes::functions(graph, funcs, max);
}
