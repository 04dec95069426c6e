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
// Every block owns its outputs' rows (the forward's o/lse rows, dK/dV's
// key rows, dQ's query rows), so there are no atomics and every kernel is
// deterministic run to run.  Rows past S are zero-filled on load and
// masked; under `causal` the tiles wholly above the diagonal are skipped
// and the diagonal tiles are masked with the library's finite
// DEFAULT_MASK_VALUE (-0.7 f32max).  P and dS are rounded to bf16 before
// their products, as the plain versions' tolerances assume.
//
// Bounds on the card at BERT-base (B 8, S 512, H 12, D 64), non-causal:
// the forward moves ~25 MB (q, k, v read, o written once) and does 6.4
// GFLOP, so its bytes bound it, 0.0076 ms at 3.35 TB/s; dK/dV does 12.9
// GFLOP, bound by the bf16 tensor-core rate, 0.0130 ms at 989 TFLOP/s;
// dQ 9.7 GFLOP, 0.0098 ms.
//
// All three kernels are one design and keep every score tile and
// accumulator in registers.  One block is one warpgroup of 4 warps over 64
// rows; each tile product is `wgmma.mma_async` (bf16 -> f32).  Its B
// operand, and its A where that is a loaded tile (Q; K and V; Q and dO),
// are read from shared memory by the tensor cores, once per warpgroup; its
// A is in registers where it is computed (P, dS), in the layout of
// mma.sync's A fragments.  The score tile never leaves the accumulator
// registers, whose layout is mma.sync's m16n8 one: row max and row sum are
// taken across the four lanes that share a row, and P (dS) rounded to bf16
// is repacked in registers into the A fragments of the next product (two
// adjacent n8 accumulator tiles make one k16 fragment).  The forward's O,
// dK/dV's and dQ's accumulators stay in registers across the whole loop,
// and so do each lane's lse and di where its rows are fixed (dQ).  The
// streamed operand (K/V in the forward and in dQ, Q/dO/lse/di in dK/dV)
// runs through a two-stage ring filled by `cp.async`: tile t+1 loads while
// tile t computes, behind one barrier per tile.  Tiles sit in the 128-byte
// swizzled layout wgmma reads at full rate (D 64 and 128; other D in the
// plain core-matrix layout); each thread's copy offsets are computed once
// per kernel, and the exponentials are one `ex2.approx` each, with the
// scale folded into one FMA.
//
// Per K/V tile, dQ does three products (S = Q K^T and dP = dO V^T from
// shared memory, then dQ += bf16(dS) K with dS in registers and K read
// MN-major) to dK/dV's four, behind the same ring.  At D 64 its shared
// memory (Q, dO and two stages of K and V, 49 KB) lets four blocks share
// an SM; registers are capped for three, as in dK/dV.
//
// Against the forward's bytes bound the design reads each K/V tile into
// shared memory once per 64 query rows and writes o through 16-byte
// stores; against the backward's operations bound it feeds the tensor
// cores from shared memory without a per-warp register copy.  What holds
// them back is the work around the products (exponentials, integer
// addressing, the wait for each product), not bytes or tensor-core
// operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;              // rows of a query tile and of a key tile
constexpr int WARPS = 4;              // 16 rows of a tile per warp
constexpr int THREADS = WARPS * 32;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

// element strides of a [B, S, H, D] tensor whose last dim is contiguous
struct Strides {
  long long b, s, h;
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the block's dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle repeats every 1024 bytes)
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
}

// An R x D bf16 tile in shared memory, in a layout wgmma reads either
// way: K-major (the tile's rows are M or N, D is K) or MN-major (its rows
// are K, D is N).  At D 64 and 128 rows of 64 columns are 128 bytes whose
// 16-byte chunks are XOR-swizzled by row (the 128-byte swizzle; 64-column
// blocks one after another, each 1024-byte aligned), so that neither the
// tensor cores nor the cp.async writes meet a bank conflict.  Other D take
// 8 x 8 core matrices of 16-byte rows, column block after column block
// (no swizzle), each block R * 16 bytes and 16 more apart.
template <int R, int D>
struct Tile {
  static constexpr bool SW = D % 64 == 0;
  static constexpr int CB = R * 16 + 16;  // no-swizzle column block
  static constexpr int BYTES = SW ? R * D * 2 : D / 8 * CB;

  // byte offset of element (r, c)
  __device__ static int off(int r, int c) {
    if constexpr (SW)
      return (c >> 6) * (R * 128) + r * 128 +
             ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
    else
      return (c >> 3) * CB + (r >> 3) * 128 + (r & 7) * 16 + (c & 7) * 2;
  }

  // K-major operand: K columns [16 kk, 16 kk + 16), rows from row0 (a
  // multiple of 16)
  __device__ static uint64_t desc_k(const unsigned char* base, int kk,
                                    int row0) {
    if constexpr (SW)
      return desc(base + (kk >> 2) * (R * 128) + row0 * 128 + (kk & 3) * 32,
                  16, 1024, 1);
    else
      return desc(base + (row0 >> 3) * 128 + 2 * kk * CB, CB, 128, 0);
  }

  // MN-major operand: K rows [16 kk, 16 kk + 16), N columns from n0 (a
  // multiple of 64 when swizzled, else of 16)
  __device__ static uint64_t desc_mn(const unsigned char* base, int kk,
                                     int n0) {
    if constexpr (SW)
      return desc(base + (n0 >> 6) * (R * 128) + kk * 2048, R * 128, 1024,
                  1);
    else
      return desc(base + 2 * kk * 128 + (n0 >> 3) * CB, 128, CB, 0);
  }

  // wgmma's shared-memory matrix descriptor: start address, leading byte
  // offset, stride byte offset (16-byte units), layout (0 none, 1 the
  // 128-byte swizzle)
  __device__ static uint64_t desc(const unsigned char* p, int lbo, int sbo,
                                  int layout) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
           ((uint64_t)layout << 62);
  }
};

// 16 bytes global -> shared without passing through registers; `bytes`
// of them read (0 or 16), the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// one f32 global -> shared (0 bytes read: a zero)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed, and are ordered before the async
// proxy's (wgmma's) reads of shared memory; a barrier then publishes them
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile(
      "cp.async.wait_group 0;\n"
      "fence.proxy.async.shared::cta;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;\n" ::
          : "memory");
}

// d (the warpgroup's 64 x 16 f32 tile) += a (64 x 16 bf16 in registers,
// each warp its 16 rows as an mma.sync A fragment) times B (16 x 16 at
// `desc`, read MN-major: its N dim contiguous).  Lane l = 4g + t of warp w
// holds d's rows 16w + g, 16w + g + 8 at columns 8j + 2t, +1 in
// d[4j .. 4j + 3], the layout of mma.sync m16n8's accumulators
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the same, 64 x 64
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 16) += A (64 x 16 at `da`) times B (16 x 16 at `db`), both
// read from shared memory with their K dim contiguous
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// the same, 64 x 64
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// acc (the warpgroup's 64 rows x N) += X Y^T for the shared 64-row tile X
// and the shared N-row tile Y, both D wide: Y's rows are the product's
// columns, and both are read K-major (K = D)
template <int D, int N>
__device__ __forceinline__ void gemm_rows_t(float (&acc)[N / 8][4],
                                            const unsigned char* X,
                                            const unsigned char* Y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = Tile<TILE, D>::desc_k(X, kk, 0);
    if constexpr (N % 64 == 0) {
#pragma unroll
      for (int j = 0; j < N / 64; ++j)
        wgmma_ss_n64(&acc[8 * j][0], da, Tile<N, D>::desc_k(Y, kk, 64 * j));
    } else {
#pragma unroll
      for (int j = 0; j < N / 16; ++j)
        wgmma_ss_n16(&acc[2 * j][0], da, Tile<N, D>::desc_k(Y, kk, 16 * j));
    }
  }
}

// acc (64 rows x D) += P Z for P the f32 accumulator tiles `p` (64 x R),
// rounded to bf16 and repacked in registers as A fragments (two adjacent
// n8 tiles make one k16 fragment), and the shared R-row tile Z: the
// product runs over Z's rows (MN-major B)
template <int D, int R>
__device__ __forceinline__ void gemm_p_rows(float (&acc)[D / 8][4],
                                            const float (&p)[R / 8][4],
                                            const unsigned char* Z) {
  uint32_t a[R / 16][4];
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    if constexpr (D % 64 == 0) {
#pragma unroll
      for (int j = 0; j < D / 64; ++j)
        wgmma_n64(&acc[8 * j][0], a[kk],
                     Tile<R, D>::desc_mn(Z, kk, 64 * j));
    } else {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wgmma_n16(&acc[2 * j][0], a[kk],
                     Tile<R, D>::desc_mn(Z, kk, 16 * j));
    }
  }
  wgmma_commit_wait();
}

// rows [row0, row0 + ROWS) of one (batch, head) slice (`base`, row stride
// `ld_g` elements) into a shared Tile by cp.async, 16 bytes a thread:
// eight lanes on one 16-byte column of eight rows (no bank conflict), four
// on a row's 64 contiguous bytes; rows past S are zero-filled.  The loop
// has a fixed trip count, so a thread's offsets, the same for every tile,
// are computed once per kernel.
template <int D, int ROWS>
__device__ __forceinline__ void async_tile(unsigned char* dst,
                                           const bf16* base,
                                           long long ld_g, int row0,
                                           int S) {
  constexpr int VEC = D / 8, N = ROWS * VEC;
  const bf16* src = base + row0 * ld_g;
#pragma unroll
  for (int j = 0; j < (N + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (N % THREADS == 0 || i < N) {
      const int rest = i >> 3, c = (rest % VEC) * 8;
      const int r = (rest / VEC) * 8 + (i & 7);
      const bool in = row0 + r < S;
      cp_async16(dst + Tile<ROWS, D>::off(r, c),
                 in ? src + r * ld_g + c : base, in ? 16 : 0);
    }
  }
}

// 2^x on the special-function unit, one instruction (results below
// 2^-126 flush to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D][4]) {
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// a warp's accumulators (its 16 rows x D, rows g and g + 8 scaled by mul0
// / mul1) as bf16 through its own rows of the R-row core-matrix tile
// `stage` into rows [row0, row0 + 16) of `out` (row stride ld_g), 16 bytes
// a lane
template <int D, int R>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4],
                                          float mul0, float mul1,
                                          unsigned char* st, int srow0,
                                          bf16* out,
                                          long long ld_g, int row0, int S) {
  constexpr int VEC = D / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(st + Tile<R, D>::off(srow0 + g,
                                                      dt * 8 + 2 * t)) =
        pack_bf16(acc[dt][0] * mul0, acc[dt][1] * mul0);
    *reinterpret_cast<uint32_t*>(st + Tile<R, D>::off(srow0 + g + 8,
                                                dt * 8 + 2 * t)) =
        pack_bf16(acc[dt][2] * mul1, acc[dt][3] * mul1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * VEC; i += 32) {
    const int rest = i >> 3, c = (rest % VEC) * 8;
    const int r = (rest / VEC) * 8 + (i & 7);
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(out + (row0 + r) * ld_g + c) =
          *reinterpret_cast<const uint4*>(st + Tile<R, D>::off(srow0 + r, c));
  }
}

// One block, one warpgroup of 4 warps, per (64-row query tile, head,
// batch); warp w owns query rows 16w..16w+15 and keeps their scores,
// softmax state and O accumulators in registers; Q stays in shared memory
// as the A operand of S = Q K^T; K/V tiles stream through a two-stage
// cp.async ring.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o,
          float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
          Strides so, int S, int H, float scale, int causal) {
  constexpr int NT = TILE / 8, DT = D / 8, T = Tile<TILE, D>::BYTES;
  unsigned char* Qs = aligned_smem();
  unsigned char* Ks = Qs + T;      // two stages
  unsigned char* Vs = Ks + 2 * T;  // two stages
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * TILE;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int n_k = (S + TILE - 1) / TILE;
  const int n_kt = causal ? min(qt + 1, n_k) : n_k;
  // scores in log2 units: exp(s - m) = exp2(s2 - m2)
  const float scale2 = scale * LOG2E;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows

  async_tile<D, TILE>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  async_tile<D, TILE>(Ks, kb, sk.s, 0, S);
  async_tile<D, TILE>(Vs, vb, sv.s, 0, S);
  cp_async_commit();

  float acc_o[DT][4];
  zero<DT>(acc_o);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // per lane
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < n_kt) {  // the next tile into the other stage
      const int st = (kt + 1) & 1;
      async_tile<D, TILE>(Ks + st * T, kb, sk.s, (kt + 1) * TILE, S);
      async_tile<D, TILE>(Vs + st * T, vb, sv.s, (kt + 1) * TILE, S);
      cp_async_commit();
    }
    const unsigned char* Kt = Ks + (kt & 1) * T;
    const unsigned char* Vt = Vs + (kt & 1) * T;

    float s[NT][4];
    zero<NT>(s);
    wgmma_fence();
    gemm_rows_t<D, TILE>(s, Qs, Kt);  // S = Q K^T
    wgmma_commit_wait();

    const int key0 = kt * TILE;
    const bool edge = key0 + TILE > S || (causal && key0 + TILE - 1 > q0);
    if (edge) {  // masked scores: MASK_VALUE (the unscaled product's)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + nt * 8 + 2 * t + e;
          if (key >= S || (causal && key > r0)) s[nt][e] = MASK_VALUE;
          if (key >= S || (causal && key > r1)) s[nt][2 + e] = MASK_VALUE;
        }
      }
    }
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the running max in log2 units: exp(scale (s - m)) = exp2(s2 - m2)
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale2);
    const float c0 = exp2_fast(m0 - mn0), c1 = exp2_fast(m1 - mn1);  // 0 first
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a masked score lands ~2^125 below a real max: exp2 gives 0
        const float p0 = exp2_fast(fmaf(s[nt][e], scale2, -mn0));
        const float p1 = exp2_fast(fmaf(s[nt][2 + e], scale2, -mn1));
        s[nt][e] = p0;
        s[nt][2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    l0 = l0 * c0 + sum0;  // this lane's share; the quad's sum at the end
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc_o[dt][0] *= c0;
      acc_o[dt][1] *= c0;
      acc_o[dt][2] *= c1;
      acc_o[dt][3] *= c1;
    }
    gemm_p_rows<D, TILE>(acc_o, s, Vt);  // O += bf16(P) V
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // the warp's own Q rows, read only by it, stage its output
  store_acc<D, TILE>(acc_o, 1.f / l0, 1.f / l1, Qs, warp * 16,
                     o + b * so.b + h * so.h, so.s, q0 + warp * 16, S);
  if (t == 0) {
    float* lrow = lse + ((long long)b * H + h) * S;
    if (r0 < S) lrow[r0] = m0 * LN2 + logf(l0);
    if (r1 < S) lrow[r1] = m1 * LN2 + logf(l1);
  }
}

// query rows of the tile dK/dV streams: 64 at D 64, 32 above (the
// registers of the dK/dV accumulators grow with D)
template <int D>
__host__ __device__ constexpr int dkv_rows() {
  return D <= 64 ? 64 : 32;
}

// One block, one warpgroup of 4 warps, per (64-row key tile, head,
// batch); warp w owns key rows 16w..16w+15 and their dK/dV accumulators in
// registers; K and V stay in shared memory as the A operands of S^T = K Q^T
// and dP^T = V dO^T; Q, dO, lse and di stream through a two-stage cp.async
// ring, query tile by query tile.  Registers are capped for three blocks
// an SM (at most 168 a thread).
template <int D>
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
              Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
              int S, int H, float scale, int causal) {
  constexpr int BQ = dkv_rows<D>(), NT = BQ / 8, DT = D / 8;
  constexpr int T = Tile<TILE, D>::BYTES, TQ = Tile<BQ, D>::BYTES;
  unsigned char* Ks = aligned_smem();
  unsigned char* Vs = Ks + T;
  unsigned char* ring = Vs + T;        // two stages of Q, dO tiles
  float* ring_f = reinterpret_cast<float*>(ring + 4 * TQ);  // lse, di
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * TILE;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_bh = lse + ((long long)b * H + h) * S;
  const float* di_bh = di + ((long long)b * H + h) * S;
  const float scale2 = scale * LOG2E;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this lane's keys

  // Q, dO [BQ rows] bf16, then lse, di [BQ] f32, of query tile qt
  auto load_query_tile = [&](int stage, int qt) {
    unsigned char* Qd = ring + stage * 2 * TQ;
    unsigned char* dOd = Qd + TQ;
    float* ld = ring_f + stage * 2 * BQ;
    const int q0 = qt * BQ;
    async_tile<D, BQ>(Qd, qb, sq.s, q0, S);
    async_tile<D, BQ>(dOd, dob, sdo.s, q0, S);
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const int c = i % BQ, qi = q0 + c;
      const float* src = (i < BQ ? lse_bh : di_bh);
      cp_async4(ld + i, qi < S ? src + qi : src, qi < S ? 4 : 0);
    }
    cp_async_commit();
  };

  async_tile<D, TILE>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, S);
  async_tile<D, TILE>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, S);
  const int n_q = (S + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  load_query_tile(0, qt0);  // one group: K, V and the first query tile

  float acc_dk[DT][4], acc_dv[DT][4];
  zero<DT>(acc_dk);
  zero<DT>(acc_dv);
  for (int qt = qt0; qt < n_q; ++qt) {
    const int it = qt - qt0;
    cp_async_wait_all();
    __syncthreads();  // tile qt landed; every warp is done with qt - 1
    if (qt + 1 < n_q) load_query_tile((it + 1) & 1, qt + 1);
    const unsigned char* Qt = ring + (it & 1) * 2 * TQ;
    const unsigned char* dOt = Qt + TQ;
    const float* lse_t = ring_f + (it & 1) * 2 * BQ;
    const float* di_t = lse_t + BQ;
    const int q0 = qt * BQ;

    float p[NT][4], ds[NT][4];
    zero<NT>(p);
    zero<NT>(ds);
    wgmma_fence();
    gemm_rows_t<D, BQ>(p, Ks, Qt);    // S^T = K Q^T
    gemm_rows_t<D, BQ>(ds, Vs, dOt);  // dP^T = V dO^T
    wgmma_commit_wait();
    const bool edge = q0 + BQ > S || k0 + TILE > S ||
                      (causal && q0 < k0 + TILE - 1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = nt * 8 + 2 * t + e;
        const float l2 = lse_t[qc] * LOG2E, d = di_t[qc];
        float p0 = exp2_fast(fmaf(p[nt][e], scale2, -l2));
        float p1 = exp2_fast(fmaf(p[nt][2 + e], scale2, -l2));
        if (edge) {
          const int qi = q0 + qc;
          if (key0 >= S || qi >= S || (causal && key0 > qi)) p0 = 0.f;
          if (key1 >= S || qi >= S || (causal && key1 > qi)) p1 = 0.f;
        }
        p[nt][e] = p0;
        p[nt][2 + e] = p1;
        ds[nt][e] = p0 * (ds[nt][e] - d);
        ds[nt][2 + e] = p1 * (ds[nt][2 + e] - d);
      }
    }
    gemm_p_rows<D, BQ>(acc_dv, p, dOt);  // dV += bf16(P^T) dO
    gemm_p_rows<D, BQ>(acc_dk, ds, Qt);  // dK += bf16(dS^T) Q
  }
  __syncwarp();  // the warp's own K/V rows, read only by it, stage dK/dV
  store_acc<D, TILE>(acc_dv, 1.f, 1.f, Vs, warp * 16,
                     dv + b * sdv.b + h * sdv.h, sdv.s, k0 + warp * 16, S);
  store_acc<D, TILE>(acc_dk, scale, scale, Ks, warp * 16,
                     dk + b * sdk.b + h * sdk.h, sdk.s, k0 + warp * 16, S);
}

// One block, one warpgroup of 4 warps, per (64-row query tile, head,
// batch); warp w owns query rows 16w..16w+15 and keeps their scores, lse
// and di and their dQ accumulators in registers; Q and dO stay in shared
// memory as the A operands of S = Q K^T and dP = dO V^T; K/V tiles stream
// through a two-stage cp.async ring, and each K tile is also the B operand
// (read MN-major) of dQ += dS K.  Registers are capped for three blocks an
// SM (at most 168 a thread).
template <int D>
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
             Strides sdo, Strides sdq, int S, int H, float scale,
             int causal) {
  constexpr int NT = TILE / 8, DT = D / 8, T = Tile<TILE, D>::BYTES;
  unsigned char* Qs = aligned_smem();
  unsigned char* dOs = Qs + T;
  unsigned char* Ks = dOs + T;     // two stages
  unsigned char* Vs = Ks + 2 * T;  // two stages
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * TILE;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int n_k = (S + TILE - 1) / TILE;
  const int n_kt = causal ? min(qt + 1, n_k) : n_k;
  const float scale2 = scale * LOG2E;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this lane's two rows

  async_tile<D, TILE>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  async_tile<D, TILE>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  async_tile<D, TILE>(Ks, kb, sk.s, 0, S);
  async_tile<D, TILE>(Vs, vb, sv.s, 0, S);
  cp_async_commit();
  // rows past S: lse 0 and di 0, and their dQ rows are never stored
  const long long bh = ((long long)b * H + h) * S;
  const float l2_0 = r0 < S ? lse[bh + r0] * LOG2E : 0.f;
  const float l2_1 = r1 < S ? lse[bh + r1] * LOG2E : 0.f;
  const float di0 = r0 < S ? di[bh + r0] : 0.f;
  const float di1 = r1 < S ? di[bh + r1] : 0.f;

  float acc[DT][4];
  zero<DT>(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < n_kt) {  // the next tile into the other stage
      const int st = (kt + 1) & 1;
      async_tile<D, TILE>(Ks + st * T, kb, sk.s, (kt + 1) * TILE, S);
      async_tile<D, TILE>(Vs + st * T, vb, sv.s, (kt + 1) * TILE, S);
      cp_async_commit();
    }
    const unsigned char* Kt = Ks + (kt & 1) * T;
    const unsigned char* Vt = Vs + (kt & 1) * T;

    float p[NT][4], ds[NT][4];
    zero<NT>(p);
    zero<NT>(ds);
    wgmma_fence();
    gemm_rows_t<D, TILE>(p, Qs, Kt);    // S = Q K^T
    gemm_rows_t<D, TILE>(ds, dOs, Vt);  // dP = dO V^T
    wgmma_commit_wait();

    const int key0 = kt * TILE;
    const bool edge = key0 + TILE > S || (causal && key0 + TILE - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = exp2_fast(fmaf(p[nt][e], scale2, -l2_0));
        float p1 = exp2_fast(fmaf(p[nt][2 + e], scale2, -l2_1));
        if (edge) {  // keys past S, and under causal keys after the row
          const int key = key0 + nt * 8 + 2 * t + e;
          if (key >= S || (causal && key > r0)) p0 = 0.f;
          if (key >= S || (causal && key > r1)) p1 = 0.f;
        }
        ds[nt][e] = p0 * (ds[nt][e] - di0);
        ds[nt][2 + e] = p1 * (ds[nt][2 + e] - di1);
      }
    }
    gemm_p_rows<D, TILE>(acc, ds, Kt);  // dQ += bf16(dS) K
  }
  // the warp's own Q rows, read only by it, stage its output
  store_acc<D, TILE>(acc, scale, scale, Qs, warp * 16,
                     dq + b * sdq.b + h * sdq.h, sdq.s, q0 + warp * 16, S);
}

// Q, then two stages of K and V
// (the kernels align their base to 1024 bytes: 1024 more)
template <int D>
constexpr int fwd_smem() {
  return 1024 + 5 * Tile<TILE, D>::BYTES;
}

// K and V, then two stages of Q, dO (bf16) and lse, di (f32)
template <int D>
constexpr int dkv_smem() {
  return 1024 + 2 * Tile<TILE, D>::BYTES + 4 * Tile<dkv_rows<D>(), D>::BYTES +
         4 * dkv_rows<D>() * 4;
}

// Q and dO, then two stages of K and V
template <int D>
constexpr int dq_smem() {
  return 1024 + 6 * Tile<TILE, D>::BYTES;
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
