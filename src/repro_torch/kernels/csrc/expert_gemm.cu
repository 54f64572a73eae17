// Grouped expert GEMM for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gemm.py::expert_gemm
// (body _kernel): out[e] = x[e] @ w[e] for every expert e, with x
// [E,M,K], w [E,K,N] and out [E,M,N] row-major and contiguous. Both
// inputs are taken as float32, the sum over K is float32, and the output
// is rounded to x's dtype once, as the Pallas kernel does after its
// astype(float32).
//
// Bound. Every shape the MoE prefill gives it has far fewer operations
// per byte than the card's ~295 (bf16): Jamba's up/gate product (E 16,
// M 80, K 4096, N 14336) moves 1.93 GB, almost all of it the expert
// weights, for 0.15 ms of tensor-core work, so it is bound by reading w
// once (0.575 ms at 3.35 TB/s); Granite's (E 32, M 160, K 1024, N 512)
// likewise (0.0147 ms). Everything below aims at reading each weight byte
// from HBM once, with enough bytes in flight to keep HBM busy.
//
// The TPU kernel walks a sequential (expert, m, n, k) grid, carries an
// fp32 [block_m, block_n] accumulator in VMEM across the k steps, and
// asserts that its blocks divide M, N and K. Here the k loop runs inside
// a CTA with the accumulator in registers, nothing crosses CTAs, and
// ragged M, N and K are zero-filled on load and masked on store. Three
// bodies; the caller (kernels/expert_gemm.py::_body_for) picks one by
// dtype and shape:
//
//  - wgmma (bfloat16, K and N multiples of 8, 16-byte aligned bases: every
//    shape of the serving path). Swap A and B: a CTA computes
//    out^T[N tile, m] = w^T[N tile, K] . x^T[K, m], so an expert's
//    capacity rows (m, up to 256) are wgmma's N side and a weight tile is
//    read once for all of them: M = 80 is one 80-wide wgmma, M = 4 pads to
//    8 (a 64-row M tile would need two tiles at 80, the second reading w
//    again, and pad 4 to 64). w's [K, N] tile, N-contiguous, is the A
//    operand with the transpose bit; x's [m, K] tile, K-contiguous, is the
//    plain B operand. Capacities above 256 (320 at a 2,048-token Jamba
//    prompt) are cut into chunks of at most 256 rows, each its own tile
//    (a second CTA): the chunks of one weight tile are adjacent in the
//    tile order, so the second reads w from L2. Warp-specialised and
//    persistent: one CTA per SM walks the (expert, N tile, m chunk) tiles;
//    a producer warp issues TMA loads (w as 64 x 64 boxes, x as one 64 x m
//    box, 128-byte swizzled) into a ring of 3-8 stages (as many as fit
//    beside the epilogue buffers: 4 of 42 KB at M = 80 with 256-column
//    tiles, 5 of 36 KB at M = 160), tracked by full/empty mbarriers, and
//    runs ahead across tile borders, so one tile's epilogue overlaps the
//    next one's loads. Two consumer warpgroups, 64 or 128 N rows each,
//    wait on a stage's full barrier, issue four (or eight) wgmma m64nMk16
//    on it, wait for them and release the stage: the tensor work of a step
//    is a fraction of the time its bytes take to arrive, so the ring, not
//    the wgmma queue, hides the latency (leaving a group in flight across
//    the loop's back edge let the compiler copy accumulators the wgmma was
//    still writing: wrong sums). setmaxnreg moves registers from the
//    producer warpgroup (40) to the consumers (232): a consumer holds up to
//    128 fp32 accumulators. The epilogue rounds once to bf16, transposes
//    through shared memory and writes 16-byte rows of out, masked to M and
//    N. Tiles are 256 columns wide (512 contiguous bytes of each weight
//    row, x's tile read half as often) where m <= 128 and that still gives
//    a tile for every SM, else 128: Jamba up/gate 896 tiles (6.8 per SM),
//    down 256 (1.9), the decode shape 896; Granite (m = 160) 128 tiles of
//    128 columns for its up/gate product, one wave on 132 SMs (64-column
//    tiles would reach all 132 SMs but read x twice as often for 3% more
//    SMs). Grid: min(tiles, SMs). Weights that fit in 64 MB (Granite's 32
//    MB a product) load with an L2 evict-first hint, so that x, read once
//    per N tile, stays in L2.
//  - mma_sync (bfloat16 shapes TMA cannot take: rows that are not 16-byte
//    multiples): 64 x 128 output tiles, K steps of 64, 8 warps each owning
//    32 x 32 of the tile, on mma.sync m16n8k16 (fp32 accumulation), x
//    through ldmatrix and the row-major [K, N] weight tile through
//    ldmatrix.trans, the next step's tiles prefetched into registers;
//    rows whose length is not a multiple of 8 are loaded element by
//    element. M tiles are the fastest grid dimension, so the second M
//    tile's reads of w hit L2.
//  - float32: 64 x 64 output tiles, K steps of 16, 256 threads as a
//    16 x 16 grid of 4 x 4 outputs on fp32 FMA. No TF32: the Pallas kernel
//    and the plain version are full float32.
// bf16 x bf16 products are exact in fp32, so the bf16 bodies compute the
// Pallas kernel's function up to the order of the sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "graph_nodes.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;  // output rows per CTA (both bodies)

struct Dims {
  int M, N, K;
  int x_vec, w_vec;  // rows of x / w may be read 16 bytes at a time
};

// ---------------------------------------------------------------------------
// bfloat16 body: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int H_BN = 128;      // output columns per CTA
constexpr int H_BK = 64;       // K per step
constexpr int H_NT = 256;      // 8 warps as 2 (M) x 4 (N), 32 x 32 each
constexpr int H_XP = H_BK + 8;  // smem pitches in elements: rows land 16
constexpr int H_WP = H_BN + 8;  // bytes apart mod 128 (conflict-free ldmatrix)
constexpr int H_XCH = BM * H_BK / 8 / H_NT;    // x chunks per thread (2)
constexpr int H_WCH = H_BK * H_BN / 8 / H_NT;  // w chunks per thread (4)

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

// 8 elements [c, c + 8) of row r of a row-major [rows, cols] bf16 matrix
// with row stride ld; out-of-range elements are zero
__device__ __forceinline__ uint4 load8(const bf16* base, long long ld,
                                       int rows, int cols, int r, int c,
                                       int vec) {
  if (r >= rows || c >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* p = base + r * ld + c;
  if (vec && c + 8 <= cols) return *reinterpret_cast<const uint4*>(p);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (c + i < cols) v[i >> 1] |= uint32_t(h[i]) << (16 * (i & 1));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(H_NT)
    expert_gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     bf16* __restrict__ out, Dims d) {
  __shared__ uint4 xs_raw[BM * H_XP / 8];
  __shared__ uint4 ws_raw[H_BK * H_WP / 8];
  bf16* Xs = reinterpret_cast<bf16*>(xs_raw);  // [BM][H_XP]
  bf16* Ws = reinterpret_cast<bf16*>(ws_raw);  // [H_BK][H_WP]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int wm = warp >> 2, wn = warp & 3;  // this warp's 32 x 32 sub-tile
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * H_BN;
  const long long e = blockIdx.z;
  x += e * d.M * d.K;
  w += e * d.K * d.N;
  out += e * d.M * d.N;

  // ldmatrix: lane l addresses row (l & 7) of 8x8 matrix (l >> 3)
  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t xa = smem_addr(Xs + (wm * 32 + lr + (lm & 1) * 8) * H_XP +
                                (lm >> 1) * 8);
  const uint32_t wa = smem_addr(Ws + (lr + (lm & 1) * 8) * H_WP + wn * 32 +
                                (lm >> 1) * 8);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  uint4 xr[H_XCH], wr[H_WCH];
  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < H_XCH; ++s) {
      const int i = tid + s * H_NT;
      const int r = i / (H_BK / 8), c = (i % (H_BK / 8)) * 8;
      xr[s] = load8(x, d.K, d.M, d.K, m0 + r, k0 + c, d.x_vec);
    }
#pragma unroll
    for (int s = 0; s < H_WCH; ++s) {
      const int i = tid + s * H_NT;
      const int r = i / (H_BN / 8), c = (i % (H_BN / 8)) * 8;
      wr[s] = load8(w, d.N, d.K, d.N, k0 + r, n0 + c, d.w_vec);
    }
  };

  load(0);
  for (int k0 = 0; k0 < d.K; k0 += H_BK) {
    __syncthreads();  // the previous step is done with Xs and Ws
#pragma unroll
    for (int s = 0; s < H_XCH; ++s) {
      const int i = tid + s * H_NT;
      *reinterpret_cast<uint4*>(Xs + (i / (H_BK / 8)) * H_XP +
                                (i % (H_BK / 8)) * 8) = xr[s];
    }
#pragma unroll
    for (int s = 0; s < H_WCH; ++s) {
      const int i = tid + s * H_NT;
      *reinterpret_cast<uint4*>(Ws + (i / (H_BN / 8)) * H_WP +
                                (i % (H_BN / 8)) * 8) = wr[s];
    }
    __syncthreads();
    if (k0 + H_BK < d.K) load(k0 + H_BK);  // in flight during the math

#pragma unroll
    for (int kc = 0; kc < H_BK / 16; ++kc) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], xa + (i * 16 * H_XP + kc * 16) * sizeof(bf16));
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];  // n tiles j and j+1, k rows 16kc..16kc+15
        ldsm_x4_trans(b, wa + (kc * 16 * H_WP + j * 8) * sizeof(bf16));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // fragment element q of tile (i, j): row g + (q >> 1) * 8, column
  // t4 * 2 + (q & 1)
  const bool pairs = (d.N & 1) == 0;  // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + i * 16 + g + h * 8;
      if (row >= d.M) continue;
      bf16* orow = out + static_cast<long long>(row) * d.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + t4 * 2;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && col + 1 < d.N) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < d.N) orow[col] = __float2bfloat16_rn(v0);
          if (col + 1 < d.N) orow[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// bfloat16 body: TMA + wgmma, warp-specialised, persistent (swap A and B)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BK = 64;              // K per stage
constexpr int NC = 2;               // consumer warpgroups
constexpr int THREADS = 128 * (NC + 1);
constexpr int W_BOX = BK * 64 * 2;  // one 64 (K) x 64 (N) weight box, bytes
constexpr int SMEM_MAX = 232448;    // a block's shared memory on sm_90

// MN = wgmma's N: the x rows (capacity chunk) of one tile; NB = 64-column
// weight boxes per consumer warpgroup, so a tile has BN = 64 NC NB columns
template <int MN, int NB>
struct Cfg {
  static constexpr int BN = 64 * NC * NB;
  static constexpr int X_BYTES = MN * BK * 2;
  static constexpr int STAGE = NC * NB * W_BOX + X_BYTES;  // a multiple of 1 KB
  static constexpr int EPI_P = 64 * NB + 8;  // epilogue row pitch, elements
  static constexpr int EPI = NC * MN * EPI_P * 2;
  static constexpr int FIT = (SMEM_MAX - EPI - 16 * 8) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int SMEM = STAGES * STAGE + EPI + 2 * STAGES * 8;
  static_assert(STAGES >= 3, "too few pipeline stages");
};

template <int MN, int NB>
__global__ void __launch_bounds__(THREADS, 1)
    expert_gemm_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      bf16* __restrict__ out, int M, int K, int N,
                      int mchunks, int ntiles, int tiles, int w_once) {
  using C = Cfg<MN, NB>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* stages = smem_raw;
  bf16* epi = reinterpret_cast<bf16*>(stages + C::STAGES * C::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + C::STAGES * C::STAGE +
                                               C::EPI);
  uint64_t* empty = full + C::STAGES;
  const int wgi = threadIdx.x / 128;
  const int ksteps = (K + BK - 1) / BK;

  check_align1024(smem_raw);
  if (threadIdx.x == NC * 128) {
    prefetch_tensor_map(&xmap);
    prefetch_tensor_map(&wmap);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == NC) {
    // producer: one thread keeps the ring full, across tile borders
    setmaxnreg_dec<40>();
    if (threadIdx.x == NC * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int mc = t % mchunks, r = t / mchunks;
        const int n0 = (r % ntiles) * C::BN, e = r / ntiles, m0 = mc * MN;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], C::STAGE);
          uint8_t* st = stages + s * C::STAGE;
#pragma unroll
          for (int c = 0; c < NC * NB; ++c)
            if (w_once)
              tma_load_3d_evict_first(st + c * W_BOX, &wmap, &full[s],
                                      n0 + 64 * c, ks * BK, e);
            else
              tma_load_3d(st + c * W_BOX, &wmap, &full[s], n0 + 64 * c,
                          ks * BK, e);
          tma_load_3d(st + NC * NB * W_BOX, &xmap, &full[s], ks * BK, m0, e);
        }
      }
    }
  } else {
    // consumers: warpgroup wgi owns N columns [64 NB wgi, 64 NB (wgi + 1))
    // of a tile
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    bf16* my_epi = epi + wgi * MN * C::EPI_P;
    float acc[NB][MN / 2];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < MN / 2; ++i) acc[b][i] = 0.f;  // tiles overwrite
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int mc = t % mchunks, r = t / mchunks;
      const int n0 = (r % ntiles) * C::BN + 64 * NB * wgi, e = r / ntiles;
      const int m0 = mc * MN;
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % C::STAGES;
        mbar_wait(&full[s], (it / C::STAGES) & 1);
        const uint32_t a =
            smem_u32(stages + s * C::STAGE + wgi * NB * W_BOX);
        const uint32_t bx = smem_u32(stages + s * C::STAGE + NC * NB * W_BOX);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int b = 0; b < NB; ++b)
            // A: w^T, N-contiguous (transposed), a k16 step is 16 rows
            // down (one 64-wide N block, so LBO is unused); B: x^T,
            // K-contiguous, a k16 step is 32 bytes along the row
            wgmma_ss<1, 0>(acc[b],
                           desc_sw128(a + b * W_BOX + kk * 2048, 1024, 1024),
                           desc_sw128(bx + kk * 32, 16, 1024), ks | kk);
        wgmma_commit();
        // the step's products are done before the stage is released: a
        // group left in flight across the loop's back edge let the
        // compiler copy accumulators the wgmma was still writing (wrong
        // sums on the card); the ring, not the wgmma queue, hides latency
        wgmma_wait<0>();
#pragma unroll
        for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
        mbar_arrive(&empty[s]);
      }

      // acc[b] element 4j + 2h + c is out^T row (n) 64 b + 16 warp + g +
      // 8h, column (m) 8j + 2 t4 + c; stage it as out rows [m][n] in
      // shared memory
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < MN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              my_epi[(8 * j + 2 * t4 + c) * C::EPI_P + 64 * b + 16 * warp +
                     g + 8 * h] = __float2bfloat16_rn(acc[b][4 * j + 2 * h + c]);
      named_barrier(1 + wgi, 128);
      for (int i = tid; i < MN * 8 * NB; i += 128) {
        const int row = i / (8 * NB), cc = (i % (8 * NB)) * 8;
        const int col = n0 + cc, m = m0 + row;
        if (m < M && col < N)
          *reinterpret_cast<uint4*>(
              out + (static_cast<long long>(e) * M + m) * N + col) =
              *reinterpret_cast<const uint4*>(my_epi + row * C::EPI_P + cc);
      }
      named_barrier(1 + wgi, 128);  // the buffer is free for the next tile
    }
  }
}

// the wgmma N (capacity chunk) for M rows: chunks of at most 256 rows,
// each rounded up to one of the instantiated widths
constexpr int kWidths[] = {8, 16, 32, 64, 80, 96, 128, 160, 192, 256};

int chunk_rows(int M) {
  const int chunks = (M + 255) / 256;
  const int per = (M + chunks - 1) / chunks;
  for (int n : kWidths)
    if (n >= per) return n;
  return 256;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int MN, int NB>
int launch(const bf16* x, const bf16* w, bf16* out, int E, int M, int K,
           int N, cudaStream_t s) {
  using C = Cfg<MN, NB>;
  CUtensorMap xmap, wmap;
  // x [E, M, K] and w [E, K, N], innermost first; the extents are M, K
  // and N themselves, so rows, columns and k past them load as zeros
  const uint64_t xdims[3] = {uint64_t(K), uint64_t(M), uint64_t(E)};
  const uint64_t xstr[2] = {uint64_t(K), uint64_t(M) * K};
  const uint32_t xbox[3] = {BK, MN, 1};
  const uint64_t wdims[3] = {uint64_t(N), uint64_t(K), uint64_t(E)};
  const uint64_t wstr[2] = {uint64_t(N), uint64_t(K) * N};
  const uint32_t wbox[3] = {64, BK, 1};
  int err = make_tensor_map_bf16(&xmap, x, 3, xdims, xstr, xbox);
  if (err == 0) err = make_tensor_map_bf16(&wmap, w, 3, wdims, wstr, wbox);
  if (err != 0) return err;
  const int mchunks = (M + MN - 1) / MN, ntiles = (N + C::BN - 1) / C::BN;
  const long long tiles = static_cast<long long>(E) * ntiles * mchunks;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  const cudaError_t attr = cudaFuncSetAttribute(
      expert_gemm_wgmma<MN, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  // weights small enough to share L2 with x (Granite's 32 MB a product)
  // load evict-first, so that x's tile, read once per N tile, stays in L2;
  // a stream of gigabytes (Jamba) ran slower with the hint and keeps the
  // default policy
  const int w_once = static_cast<long long>(E) * K * N * 2 <= (64LL << 20);
  expert_gemm_wgmma<MN, NB><<<grid, THREADS, C::SMEM, s>>>(
      xmap, wmap, out, M, K, N, mchunks, ntiles, static_cast<int>(tiles),
      w_once);
  return cudaGetLastError();
}

// 256-column tiles (four boxes side by side: 512 contiguous bytes of each
// weight row, and x's tile read half as often) where the accumulators fit
// (m <= 128) and there is still a tile for every SM; otherwise 128
// columns (Granite's m = 160, and its 128 tiles would shrink to 64)
template <int MN>
int launch_width(const bf16* x, const bf16* w, bf16* out, int E, int M,
                 int K, int N, cudaStream_t s) {
  if constexpr (MN <= 128) {
    const long long wide = static_cast<long long>(E) * ((N + 255) / 256) *
                           ((M + MN - 1) / MN);
    if (wide >= sm_count())
      return launch<MN, 2>(x, w, out, E, M, K, N, s);
  }
  return launch<MN, 1>(x, w, out, E, M, K, N, s);
}

int dispatch(const bf16* x, const bf16* w, bf16* out, int E, int M, int K,
             int N, cudaStream_t s) {
  switch (chunk_rows(M)) {
    case 8: return launch_width<8>(x, w, out, E, M, K, N, s);
    case 16: return launch_width<16>(x, w, out, E, M, K, N, s);
    case 32: return launch_width<32>(x, w, out, E, M, K, N, s);
    case 64: return launch_width<64>(x, w, out, E, M, K, N, s);
    case 80: return launch_width<80>(x, w, out, E, M, K, N, s);
    case 96: return launch_width<96>(x, w, out, E, M, K, N, s);
    case 128: return launch_width<128>(x, w, out, E, M, K, N, s);
    case 160: return launch_width<160>(x, w, out, E, M, K, N, s);
    case 192: return launch_width<192>(x, w, out, E, M, K, N, s);
    default: return launch_width<256>(x, w, out, E, M, K, N, s);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32 body: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int F_BN = 64;       // output columns per CTA
constexpr int F_BK = 16;       // K per step
constexpr int F_NT = 256;      // a 16 x 16 thread grid, 4 x 4 outputs each
constexpr int F_XP = F_BK + 1;  // padded pitch of x rows (banks)

// 4 elements [c, c + 4) of row r of a row-major [rows, cols] float matrix
// with row stride ld; out-of-range elements are zero
__device__ __forceinline__ float4 load4(const float* base, long long ld,
                                        int rows, int cols, int r, int c,
                                        int vec) {
  if (r >= rows || c >= cols) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = base + r * ld + c;
  if (vec && c + 4 <= cols) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], c + 1 < cols ? p[1] : 0.f,
                     c + 2 < cols ? p[2] : 0.f, c + 3 < cols ? p[3] : 0.f);
}

__global__ void __launch_bounds__(F_NT)
    expert_gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, Dims d) {
  __shared__ float Xs[BM * F_XP];                  // [BM][F_XP]
  __shared__ __align__(16) float Ws[F_BK * F_BN];  // [F_BK][F_BN]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * F_BN;
  const long long e = blockIdx.z;
  x += e * d.M * d.K;
  w += e * d.K * d.N;
  out += e * d.M * d.N;

  // one 4-float chunk of each tile per thread
  const int xrow = tid / (F_BK / 4), xcol = (tid % (F_BK / 4)) * 4;
  const int wrow = tid / (F_BN / 4), wcol = (tid % (F_BN / 4)) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float4 xv = load4(x, d.K, d.M, d.K, m0 + xrow, xcol, d.x_vec);
  float4 wv = load4(w, d.N, d.K, d.N, wrow, n0 + wcol, d.w_vec);
  for (int k0 = 0; k0 < d.K; k0 += F_BK) {
    __syncthreads();  // the previous step is done with Xs and Ws
    float* xs = Xs + xrow * F_XP + xcol;
    xs[0] = xv.x;
    xs[1] = xv.y;
    xs[2] = xv.z;
    xs[3] = xv.w;
    *reinterpret_cast<float4*>(Ws + wrow * F_BN + wcol) = wv;
    __syncthreads();
    if (k0 + F_BK < d.K) {  // in flight during the math
      xv = load4(x, d.K, d.M, d.K, m0 + xrow, k0 + F_BK + xcol, d.x_vec);
      wv = load4(w, d.N, d.K, d.N, k0 + F_BK + wrow, n0 + wcol, d.w_vec);
    }
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[(ty + 16 * i) * F_XP + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[k * F_BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= d.M) continue;
    float* orow = out + static_cast<long long>(row) * d.N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < d.N) orow[col] = acc[i][j];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// out[e] = x[e] @ w[e]: x [E,M,K], w [E,K,N], out [E,M,N], all contiguous
// and of one dtype (0 = float32, 1 = bfloat16). body: 0 = the dtype's
// mma_sync / FMA body, 1 = the TMA + wgmma body (bfloat16, K and N
// multiples of 8, 16-byte aligned x and w; anything else is refused).
// E <= 65535 and ceil(N / tile) <= 65535 (the caller checks). Launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success),
// or hopper::kTensorMapError + the CUresult if a tensor map is refused.
extern "C" int expert_gemm_fwd(const void* x, const void* w, void* out,
                               int dtype, int E, int M, int K, int N,
                               int body, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  if (body == 1) {
    if (dtype != 1 || K % 8 || N % 8 || !aligned16(x) || !aligned16(w) ||
        !aligned16(out))
      return cudaErrorInvalidValue;
    return wg::dispatch(static_cast<const bf16*>(x),
                        static_cast<const bf16*>(w), static_cast<bf16*>(out),
                        E, M, K, N, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
  const int lanes = dtype == 1 ? 8 : 4;  // elements per 16-byte load
  const Dims d{M, N, K, K % lanes == 0 && aligned16(x),
               N % lanes == 0 && aligned16(w)};
  const int mt = (M + BM - 1) / BM;
  if (dtype == 1) {
    const dim3 grid(mt, (N + H_BN - 1) / H_BN, E);
    expert_gemm_bf16<<<grid, H_NT, 0, s>>>(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(w),
                                           static_cast<bf16*>(out), d);
  } else if (dtype == 0) {
    const dim3 grid(mt, (N + F_BN - 1) / F_BN, E);
    expert_gemm_f32<<<grid, F_NT, 0, s>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(w),
                                          static_cast<float*>(out), d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// every body kernel, for a captured graph's count (graph_nodes.cuh): the
// wgmma body at each row chunk, and at 256-column tiles where
// wg::launch_width takes them
const graph_nodes::GraphEntry kGraphEntries[] = {
    {reinterpret_cast<const void*>(expert_gemm_f32), "fma"},
    {reinterpret_cast<const void*>(expert_gemm_bf16), "mma_sync"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<8, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<16, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<32, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<64, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<80, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<96, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<128, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<160, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<192, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<256, 1>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<8, 2>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<16, 2>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<32, 2>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<64, 2>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<80, 2>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<96, 2>), "wgmma"},
    {reinterpret_cast<const void*>(wg::expert_gemm_wgmma<128, 2>), "wgmma"},
};

extern "C" int graph_entries(const void** funcs, const char** bodies,
                             int max) {
  return graph_nodes::entries(kGraphEntries, funcs, bodies, max);
}

extern "C" int graph_functions(void* graph, const void** funcs, int max) {
  return graph_nodes::functions(graph, funcs, max);
}
