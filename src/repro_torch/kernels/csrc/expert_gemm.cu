// Grouped expert GEMM for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gemm.py::expert_gemm
// (body _kernel): out[e] = x[e] @ w[e] for every expert e, with x
// [E,M,K], w [E,K,N] and out [E,M,N] row-major and contiguous. Both
// inputs are taken as float32, the sum over K is float32, and the output
// is rounded to x's dtype once, as the Pallas kernel does after its
// astype(float32).
//
// Design. The TPU kernel walks a sequential (expert, m, n, k) grid and
// carries an fp32 [block_m, block_n] accumulator in VMEM across the k
// steps, and asserts that its blocks divide M, N and K. Here one CTA owns
// one (expert, 64-row M tile, N tile) and loops over K tiles inside the
// block, with its accumulator in registers, so nothing crosses CTAs. M
// tiles are the fastest-varying grid dimension (blockIdx.x): the CTAs
// that read the same weight tile are launched next to each other, so the
// second M tile's reads of w hit L2 rather than HBM. Each K step stages
// an x tile and a w tile in shared memory, loaded with 16-byte loads,
// neighbouring threads on neighbouring addresses; the next step's tiles
// are loaded into registers while the current step computes. Ragged M, N
// and K edges are zero-filled on load and masked on store, so any M, N,
// K >= 1 works (M may be below 16: the decode shape has M = 4); rows whose
// length is not a multiple of the vector width are loaded element by
// element. Two bodies, chosen by dtype:
//  - bfloat16 (the serving path): 64 x 128 output tiles, K steps of 64,
//    8 warps each owning 32 x 32 of the tile, on the tensor cores with
//    mma.sync m16n8k16 (fp32 accumulation). x reaches them through
//    ldmatrix, the row-major [K, N] weight tile through ldmatrix.trans.
//    bf16 x bf16 products are exact in fp32, so this is the Pallas
//    kernel's function up to the order of the sum.
//  - float32: 64 x 64 output tiles, K steps of 16, 256 threads as a
//    16 x 16 grid of 4 x 4 outputs on fp32 FMA. No TF32: the Pallas kernel
//    and the plain version are full float32.
//
// Bound. Every shape the MoE prefill gives it has far fewer operations
// per byte than the card's ~295 (bf16): Jamba's up/gate product (E 16,
// M 80, K 4096, N 14336) moves 1.93 GB, almost all of it the expert
// weights, for 0.15 ms of tensor-core work, so it is bound by reading w
// once (0.575 ms at 3.35 TB/s); Granite's (E 32, M 160, K 1024, N 512)
// likewise (0.0147 ms). What the design does about it: w is read from
// HBM once (M tiles of one weight tile share it through L2), x is small
// and stays in L2, and the register prefetch keeps a step's loads in
// flight during its math. There is no cp.async/TMA pipeline, no wgmma
// and no persistent CTA; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// and of one dtype (0 = float32, 1 = bfloat16). E <= 65535 and
// ceil(N / tile) <= 65535 (the caller checks). Launches on `stream` and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int expert_gemm_fwd(const void* x, const void* w, void* out,
                               int dtype, int E, int M, int K, int N,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
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
