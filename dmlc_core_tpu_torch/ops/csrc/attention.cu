// Flash attention for Hopper (sm_90a): forward, dK/dV backward, dQ backward.
//
// Replaces the three pallas_calls of the library kernel that
// dmlc_core_tpu/ops/attention.py:61-68 reaches
// (jax/experimental/pallas/ops/tpu/flash_attention.py of jax 0.9.0):
//
//   flash_fwd      <- _flash_attention_kernel      (:331, pallas_call :758)
//   flash_bwd_dkv  <- _flash_attention_dkv_kernel  (:796, pallas_call :1121)
//   flash_bwd_dq   <- _flash_attention_dq_kernel   (:1146, pallas_call :1456)
//
// What they compute, over q, k, v, dO of shape [B, S, H, D] (bf16, read
// through their strides: the last dim contiguous, no transpose copies),
// with s = scale * q k^T and, under `causal`, keys after the query masked:
//
//   forward  o = softmax(s) v (bf16) and lse = m + log(l) (f32 [B, H, S]),
//            the online softmax's running max m and sum l in one residual;
//   dK/dV    P = exp(s - lse), dV = P^T dO, dS = P * (dO v^T - di),
//            dK = scale * dS^T q, with di = rowsum(o * dO) (f32 [B, H, S]);
//   dQ       dQ = scale * dS k.
//
// Design.  One block of 4 warps per (64-row tile, head, batch); each warp
// owns 16 rows of the tile.  The block's fixed operand tile (Q in the
// forward and dQ kernels, K and V in dK/dV) is loaded once; the other
// operand streams through shared memory in 64-row tiles.  Tile products
// run on the tensor cores through nvcuda::wmma (bf16 16x16x16 fragments,
// f32 accumulators); the softmax and the dS elementwise step run on an f32
// score tile in shared memory, two lanes per row.  Every block owns its
// outputs' rows (the forward's o/lse rows, dK/dV's key rows, dQ's query
// rows), so there are no atomics and every kernel is deterministic run to
// run.  Rows past S are zero-filled on load and masked; under `causal`
// the tiles wholly above the diagonal are skipped and the diagonal tile
// is masked with the library's finite DEFAULT_MASK_VALUE (-0.7 f32max).
//
// Bound on the card (BERT-base, B 8, S 512, H 12, D 64): the forward moves
// ~25 MB and does 6.4 GFLOP, so its bytes bound it (~7.6 us at 3.35
// TB/s); dK/dV (12.9 GFLOP) and dQ (9.7 GFLOP) are bound by the bf16
// tensor-core rate.  These kernels are the simple route (wmma, shared
// memory staging, no TMA or wgmma pipelining) and run well above that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;              // rows of a query tile and of a key tile
constexpr int WARPS = 4;              // 16 rows of a tile per warp
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;                // bf16 pad of a shared row (16 bytes)
constexpr int LDT = TILE + 4;         // f32 score tile row (floats)
constexpr int LDP = TILE + PAD;       // bf16 probability tile row
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

// element strides of a [B, S, H, D] tensor whose last dim is contiguous
struct Strides {
  long long b, s, h;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// rows [row0, row0 + TILE) of head h, batch b into a shared [TILE][D + PAD]
// tile, 16 bytes a thread; rows past S are zeros
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          Strides st, int b, int h,
                                          int row0, int S) {
  constexpr int LD = D + PAD, VEC = D / 8;
  const bf16* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < TILE * VEC; i += THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8, s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(base + s * st.s + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// a warp's 16 rows of X (fragments `a`, D wide) times Y^T for a shared
// [TILE][D + PAD] tile Y: a 16 x TILE f32 tile stored at `out` (row LDT)
template <int D>
__device__ __forceinline__ void rows_times_tile_t(const FragA (&a)[D / 16],
                                                  const bf16* Y, float* out) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBCol bfr;
      wmma::load_matrix_sync(bfr, Y + j * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc, a[kk], bfr, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, LDT, wmma::mem_row_major);
  }
}

// acc (16 x D) += P (a warp's 16 x TILE bf16 rows, row LDP) times the
// shared [TILE][D + PAD] tile Z
template <int D>
__device__ __forceinline__ void accumulate_rows(FragC (&acc)[D / 16],
                                                const bf16* P, const bf16* Z) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, P + kk * 16, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragBRow bfr;
      wmma::load_matrix_sync(bfr, Z + kk * 16 * LD + j * 16, LD);
      wmma::mma_sync(acc[j], a, bfr, acc[j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void load_rows(FragA (&a)[D / 16], const bf16* X) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(a[kk], X + kk * 16, D + PAD);
}

// a warp's accumulators (16 x D, times `mul`) through the f32 staging rows
// `stage` (row D + 4) into rows [row0, row0 + 16) of the bf16 output;
// lane pairs write one row each, a half of it per lane
template <int D>
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16], float mul,
                                           float* stage, bf16* out,
                                           Strides st, int b, int h, int row0,
                                           int S) {
  constexpr int LDO = D + 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    for (int i = 0; i < acc[j].num_elements; ++i) acc[j].x[i] *= mul;
    wmma::store_matrix_sync(stage + j * 16, acc[j], LDO, wmma::mem_row_major);
  }
  __syncwarp();
  const int r = lane >> 1, half = lane & 1, s = row0 + r;
  if (s < S) {
    const float* src = stage + r * LDO + half * (D / 2);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + b * st.b + s * st.s + h * st.h + half * (D / 2));
#pragma unroll
    for (int c = 0; c < D / 2; c += 2)
      dst[c / 2] = __floats2bfloat162_rn(src[c], src[c + 1]);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o,
          float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
          Strides so, int S, int H, float scale, int causal) {
  constexpr int LD = D + PAD, LDO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  bf16* Ps = Vs + TILE * LD;
  float* Ss = reinterpret_cast<float*>(Ps + TILE * LDP);
  float* Os = Ss + TILE * LDT;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * TILE;

  load_tile<D>(Qs, q, sq, b, h, q0, S);
  for (int i = threadIdx.x; i < TILE * LDO; i += THREADS) Os[i] = 0.f;
  __syncthreads();
  FragA qa[D / 16];
  load_rows<D>(qa, Qs + warp * 16 * LD);

  // lanes 2r, 2r+1 of a warp hold row r's softmax state and each its half
  const int r = warp * 16 + (lane >> 1), half = lane & 1, qi = q0 + r;
  float* srow = Ss + r * LDT + half * 32;
  bf16* prow = Ps + r * LDP + half * 32;
  float* orow = Os + r * LDO + half * (D / 2);
  float m = -INFINITY, l = 0.f;
  const int n_k = (S + TILE - 1) / TILE;
  const int n_kt = causal ? min(qt + 1, n_k) : n_k;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, k, sk, b, h, kt * TILE, S);
    load_tile<D>(Vs, v, sv, b, h, kt * TILE, S);
    __syncthreads();
    rows_times_tile_t<D>(qa, Ks, Ss + warp * 16 * LDT);
    __syncwarp();
    const int key0 = kt * TILE + half * 32;
    float mx = MASK_VALUE;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = key0 + c;
      const bool masked = key >= S || (causal && key > qi);
      const float s = masked ? MASK_VALUE : srow[c] * scale;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);  // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = key0 + c;
      const bool masked = key >= S || (causal && key > qi);
      const float p = masked ? 0.f : expf(srow[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] *= corr;
    __syncwarp();
    FragC acc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::load_matrix_sync(acc[j], Os + warp * 16 * LDO + j * 16, LDO,
                             wmma::mem_row_major);
    accumulate_rows<D>(acc, Ps + warp * 16 * LDP, Vs);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(Os + warp * 16 * LDO + j * 16, acc[j], LDO,
                              wmma::mem_row_major);
    __syncwarp();
  }
  if (qi < S) {
    const float inv = 1.f / l;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        o + b * so.b + qi * so.s + h * so.h + half * (D / 2));
#pragma unroll
    for (int c = 0; c < D / 2; c += 2)
      dst[c / 2] = __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
    if (half == 0) lse[((long long)b * H + h) * S + qi] = m + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
              Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
              int S, int H, float scale, int causal) {
  constexpr int LD = D + PAD, LDO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE * LD;
  bf16* Qs = Vs + TILE * LD;
  bf16* dOs = Qs + TILE * LD;
  bf16* Ps = dOs + TILE * LD;
  bf16* dSs = Ps + TILE * LDP;
  float* Ss = reinterpret_cast<float*>(dSs + TILE * LDP);
  float* lse_s = Ss + TILE * LDT;
  float* di_s = lse_s + TILE;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = kt * TILE;
  const float* lse_bh = lse + ((long long)b * H + h) * S;
  const float* di_bh = di + ((long long)b * H + h) * S;

  load_tile<D>(Ks, k, sk, b, h, k0, S);
  load_tile<D>(Vs, v, sv, b, h, k0, S);
  __syncthreads();
  FragA ka[D / 16], va[D / 16];
  load_rows<D>(ka, Ks + warp * 16 * LD);
  load_rows<D>(va, Vs + warp * 16 * LD);
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  // lanes 2r, 2r+1 hold key row r of the transposed tiles, a half each
  const int r = warp * 16 + (lane >> 1), half = lane & 1, key = k0 + r;
  float* srow = Ss + r * LDT + half * 32;
  bf16* prow = Ps + r * LDP + half * 32;
  bf16* dsrow = dSs + r * LDP + half * 32;
  const int n_q = (S + TILE - 1) / TILE;
  for (int qt = causal ? kt : 0; qt < n_q; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D>(Qs, q, sq, b, h, q0, S);
    load_tile<D>(dOs, dout, sdo, b, h, q0, S);
    if (threadIdx.x < TILE) {
      const int i = q0 + threadIdx.x;
      lse_s[threadIdx.x] = i < S ? lse_bh[i] : 0.f;
      di_s[threadIdx.x] = i < S ? di_bh[i] : 0.f;
    }
    __syncthreads();
    rows_times_tile_t<D>(ka, Qs, Ss + warp * 16 * LDT);  // S^T = K Q^T
    __syncwarp();
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int qc = half * 32 + c, qi = q0 + qc;
      const bool masked = key >= S || qi >= S || (causal && key > qi);
      p[c] = masked ? 0.f : expf(srow[c] * scale - lse_s[qc]);
      prow[c] = __float2bfloat16(p[c]);
    }
    __syncwarp();
    accumulate_rows<D>(dv_acc, Ps + warp * 16 * LDP, dOs);  // dV += P^T dO
    rows_times_tile_t<D>(va, dOs, Ss + warp * 16 * LDT);    // dP^T = V dO^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c)
      dsrow[c] = __float2bfloat16(p[c] * (srow[c] - di_s[half * 32 + c]));
    __syncwarp();
    accumulate_rows<D>(dk_acc, dSs + warp * 16 * LDP, Qs);  // dK += dS^T Q
  }
  __syncthreads();  // the Q/dO tiles become the f32 staging rows
  float* stage = reinterpret_cast<float*>(Qs) + warp * 16 * LDO;
  store_rows<D>(dv_acc, 1.f, stage, dv, sdv, b, h, k0 + warp * 16, S);
  store_rows<D>(dk_acc, scale, stage, dk, sdk, b, h, k0 + warp * 16, S);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
             Strides sdo, Strides sdq, int S, int H, float scale,
             int causal) {
  constexpr int LD = D + PAD, LDO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  bf16* dSs = Vs + TILE * LD;
  float* Ss = reinterpret_cast<float*>(dSs + TILE * LDP);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * TILE;

  load_tile<D>(Qs, q, sq, b, h, q0, S);
  load_tile<D>(dOs, dout, sdo, b, h, q0, S);
  __syncthreads();
  FragA qa[D / 16], doa[D / 16];
  load_rows<D>(qa, Qs + warp * 16 * LD);
  load_rows<D>(doa, dOs + warp * 16 * LD);
  FragC dq_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.f);

  const int r = warp * 16 + (lane >> 1), half = lane & 1, qi = q0 + r;
  const long long bh = ((long long)b * H + h) * S;
  const float lse_r = qi < S ? lse[bh + qi] : 0.f;
  const float di_r = qi < S ? di[bh + qi] : 0.f;
  float* srow = Ss + r * LDT + half * 32;
  bf16* dsrow = dSs + r * LDP + half * 32;
  const int n_k = (S + TILE - 1) / TILE;
  const int n_kt = causal ? min(qt + 1, n_k) : n_k;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, k, sk, b, h, kt * TILE, S);
    load_tile<D>(Vs, v, sv, b, h, kt * TILE, S);
    __syncthreads();
    rows_times_tile_t<D>(qa, Ks, Ss + warp * 16 * LDT);  // S = Q K^T
    __syncwarp();
    float p[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int key = kt * TILE + half * 32 + c;
      const bool masked = key >= S || qi >= S || (causal && key > qi);
      p[c] = masked ? 0.f : expf(srow[c] * scale - lse_r);
    }
    __syncwarp();
    rows_times_tile_t<D>(doa, Vs, Ss + warp * 16 * LDT);  // dP = dO V^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c)
      dsrow[c] = __float2bfloat16(p[c] * (srow[c] - di_r));
    __syncwarp();
    accumulate_rows<D>(dq_acc, dSs + warp * 16 * LDP, Ks);  // dQ += dS K
  }
  __syncthreads();  // the K/V tiles become the f32 staging rows
  float* stage = reinterpret_cast<float*>(Ks) + warp * 16 * LDO;
  store_rows<D>(dq_acc, scale, stage, dq, sdq, b, h, q0 + warp * 16, S);
}

template <int D>
constexpr int fwd_smem() {
  return 3 * TILE * (D + PAD) * 2 + TILE * LDP * 2 + TILE * LDT * 4 +
         TILE * (D + 4) * 4;
}

template <int D>
constexpr int dkv_smem() {
  return 4 * TILE * (D + PAD) * 2 + 2 * TILE * LDP * 2 + TILE * LDT * 4 +
         2 * TILE * 4;
}

template <int D>
constexpr int dq_smem() {
  return 4 * TILE * (D + PAD) * 2 + TILE * LDP * 2 + TILE * LDT * 4;
}

// the kernel's dynamic shared memory above the 48 KB default, then the
// launch's own error
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

inline dim3 grid_of(int B, int S, int H) {
  return dim3((S + TILE - 1) / TILE, H, B);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, Strides sq, Strides sk,
               Strides sv, Strides so, float scale, int causal,
               cudaStream_t stream) {
  constexpr int smem = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd<D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd<D><<<grid_of(B, S, H), THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      sq, sk, sv, so, S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int B,
               int S, int H, Strides sq, Strides sk, Strides sv, Strides sdo,
               Strides sdk, Strides sdv, float scale, int causal,
               cudaStream_t stream) {
  constexpr int smem = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv<D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv<D><<<grid_of(B, S, H), THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)di, (bf16*)dk, (bf16*)dv, sq, sk, sv,
      sdo, sdk, sdv, S, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dq, int B, int S, int H,
              Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
              float scale, int causal, cudaStream_t stream) {
  constexpr int smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq<D>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<D><<<grid_of(B, S, H), THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)di, (bf16*)dq, sq, sk, sv, sdo, sdq, S,
      H, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Head dims the kernels are instantiated for: 64..128 in steps of 16.
#define DMLC_FOR_HEAD_DIMS(D, CALL)   \
  switch (D) {                        \
    case 64: return CALL(64);         \
    case 80: return CALL(80);         \
    case 96: return CALL(96);         \
    case 112: return CALL(112);       \
    case 128: return CALL(128);       \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// o [B, S, H, D] bf16 and lse [B, H, S] f32 from q, k, v; strides in
// elements (batch, sequence, head) of each [B, S, H, D] tensor
int dmlc_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int D, long long qb,
                   long long qs, long long qh, long long kb, long long ks,
                   long long kh, long long vb, long long vs, long long vh,
                   long long ob, long long os, long long oh, float scale,
                   int causal, void* stream) {
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh}, so{ob, os, oh};
#define DMLC_FWD(DIM)                                                    \
  launch_fwd<DIM>(q, k, v, o, lse, B, S, H, sq, sk, sv, so, scale, causal, \
                  (cudaStream_t)stream)
  DMLC_FOR_HEAD_DIMS(D, DMLC_FWD)
#undef DMLC_FWD
}

// dk, dv [B, S, H, D] bf16 from q, k, v, dO and the f32 [B, H, S] lse, di
int dmlc_flash_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, int B, int S, int H, int D,
                       long long qb, long long qs, long long qh, long long kb,
                       long long ks, long long kh, long long vb, long long vs,
                       long long vh, long long dob, long long dos,
                       long long doh, long long dkb, long long dks,
                       long long dkh, long long dvb, long long dvs,
                       long long dvh, float scale, int causal, void* stream) {
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh},
      sdo{dob, dos, doh}, sdk{dkb, dks, dkh}, sdv{dvb, dvs, dvh};
#define DMLC_DKV(DIM)                                                       \
  launch_dkv<DIM>(q, k, v, dout, lse, di, dk, dv, B, S, H, sq, sk, sv, sdo, \
                  sdk, sdv, scale, causal, (cudaStream_t)stream)
  DMLC_FOR_HEAD_DIMS(D, DMLC_DKV)
#undef DMLC_DKV
}

// dq [B, S, H, D] bf16 from q, k, v, dO and the f32 [B, H, S] lse, di
int dmlc_flash_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, int B, int S, int H, int D, long long qb,
                      long long qs, long long qh, long long kb, long long ks,
                      long long kh, long long vb, long long vs, long long vh,
                      long long dob, long long dos, long long doh,
                      long long dqb, long long dqs, long long dqh,
                      float scale, int causal, void* stream) {
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh},
      sdo{dob, dos, doh}, sdq{dqb, dqs, dqh};
#define DMLC_DQ(DIM)                                                    \
  launch_dq<DIM>(q, k, v, dout, lse, di, dq, B, S, H, sq, sk, sv, sdo, sdq, \
                 scale, causal, (cudaStream_t)stream)
  DMLC_FOR_HEAD_DIMS(D, DMLC_DQ)
#undef DMLC_DQ
}

}  // extern "C"
