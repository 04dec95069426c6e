// Histogram-floor measurement kernels for Hopper (sm_90a): the one-hot
// matrix-product histogram on the tensor cores, in the variants that
// attribute its cost to construction, product and accumulation.  Bound
// through a plain C interface (ops/_build.py loads this file's shared
// library with ctypes); the wrapper and the plain versions are in
// dmlc_core_tpu_torch/tools/spike_hist_floor.py.
//
// Replaces the Pallas TPU kernel _kernel_variant of
// scripts/spike_hist_floor.py (pallas_call in one_pass, driven by
// _run_level and main).  What it computes, for a tile of T rows at a
// time (rows past the last whole tile are not read, as the TPU grid
// n // T leaves them):
//
//   out[F, 2*nh, lo] f32, nh = n_build * hi, bin = hi_part * lo + lo_part
//   out[f, plane*nh + node*hi + bin/lo, bin%lo] += sum of the plane's
//   value (g or h, rounded to bf16) of the rows in that cell; rows whose
//   node < 0 or node >= n_build add nothing.
//
// as the product [A, T] x [T, lo] of two one-hot matrices per tile and
// feature (A = 2*nh: the g plane's rows, then the h plane's), summed in
// f32.  The variants:
//
//   shipped   a warp per (feature, 16 LHS rows) runs the tile's rows and
//             stores its [16, lo] product for the tile.
//   grpacc    a warp keeps the accumulators of a group of 8 features (the
//             TPU variant carries the group's [8, A, lo] in VMEM values):
//             node, g and h are loaded and converted once per k-step for
//             the 8, and the group's block leaves through a shared-memory
//             slab in ONE coalesced store.
//   nodot     construction only: the one-hot fragments are built exactly
//             as above, then summed instead of multiplied.  Per tile and
//             feature, d[r, :] = bf16(bf16(rowsum(lhs)[r]) +
//             bf16(rowsum(rhs)[r])), the TPU variant's function (its
//             rowsums are f32 sums rounded once to bf16; needs A <= lo).
//   noconstr  the product of one fixed pair per tile: the LHS holds the
//             node-only one-hots (row plane*nh + node*hi) scaled by g/h,
//             the RHS is lo_iota == 0, a constant fragment; no bin is
//             read.  Every feature gets the same [A, lo] block, column 0
//             filled.
//   pack4/8   S features share ONE product [S*A, T] x [T, S*lo]: the
//             warp computes all S*S blocks and keeps the S diagonal ones;
//             the off-diagonal blocks are computed and thrown away (that
//             waste is what the variant measures), into accumulators kept
//             alive only by a store the caller never asks for.
//
// What bounds it on an H100: the useful tensor-core work, 2*A*lo*T*F
// bf16 FLOP a tile (0.249 / 0.497 ms at 10M x 24 with n_build 1 / 2 at
// 989 TFLOP/s), against 0.107 ms for the bytes (the bins once, node and
// g/h once).  In practice the construction of the one-hots in registers
// (~70 integer instructions per lane per 16-row k-step and feature) is
// the larger cost; the variants exist to say how much larger.
//
// Design:
//  * mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate), both one-hot
//    fragments built in registers from the documented lane layout: lane
//    (gid = lane/4, t = lane%4) holds LHS rows gid and gid+8 and RHS
//    column gid, at k-slots 2t, 2t+1, 2t+8, 2t+9.  The product sums over
//    k, so any bijection of data rows onto k-slots is the same product:
//    the lane's four slots take the four consecutive data rows 4t..4t+3
//    of the 16-row k-step, read as one int4 of node, one float4 each of
//    g and h and one 32-bit word of bins.  lo = 32 is 4 n-tiles of 8.
//  * A warp owns 16 LHS rows (one m-tile: the whole A = 16 at n_build 1;
//    the g or the h plane at n_build 2) and runs all T rows of its tile,
//    so its accumulators (16 registers a feature) need no reduction.
//  * Cross-tile accumulation is a fixed-order reduce: every tile stores
//    its [F, A, lo] block into a partial buffer, then one thread per
//    output cell adds the tiles in order, 0 + d0 + d1 + ..., the TPU
//    grid's order.  No atomics, so the bytes are the same run to run.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLo = 32;            // lo_part width: 4 n-tiles of 8 columns
constexpr int kNT = kLo / 8;
constexpr int kGroup = 8;          // features per block
constexpr uint32_t kOne = 0x3F80u;    // bf16 1.0

enum Variant {
  kShipped = 0, kGrpacc = 1, kNodot = 2, kNoconstr = 3, kPack4 = 4,
  kPack8 = 5
};

// D = A * B + D, one m16n8k16 bf16 product with f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ float bf16_value(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One lane's four data rows of a k-step: t0 base (node * hi, or far below
// every LHS row for rows that add nothing) and, for each of the lane's two
// LHS rows, the bf16 bits of the value that row takes (g or h: its plane).
struct Rows {
  int nb[4];
  uint32_t val[2][4];
};

__device__ __forceinline__ void load_rows(const int32_t* __restrict__ node,
                                          const float* __restrict__ g,
                                          const float* __restrict__ h,
                                          long long r, int n_build, int hi,
                                          const int (&plane)[2], Rows& R) {
  const int4 nd = *reinterpret_cast<const int4*>(node + r);
  const float4 gv = *reinterpret_cast<const float4*>(g + r);
  const float4 hv = *reinterpret_cast<const float4*>(h + r);
  const int n4[4] = {nd.x, nd.y, nd.z, nd.w};
  const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
  const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    R.nb[i] = (n4[i] >= 0 && n4[i] < n_build) ? n4[i] * hi : -(1 << 20);
    const uint32_t gb = bf16_bits(g4[i]);
    const uint32_t hb = bf16_bits(h4[i]);
    R.val[0][i] = plane[0] ? hb : gb;
    R.val[1][i] = plane[1] ? hb : gb;
  }
}

// LHS fragment: element (row tgt_j, data row i) = val if t0[i] == tgt_j.
// a[0]: row gid, slots 2t, 2t+1 (data rows 0, 1); a[1]: row gid+8, same
// slots; a[2]: row gid, slots 2t+8, 2t+9 (data rows 2, 3); a[3]: row gid+8.
__device__ __forceinline__ void lhs_fragment(const Rows& R, const int (&t0)[4],
                                             const int (&tgt)[2],
                                             uint32_t (&a)[4]) {
  uint32_t e[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) e[j][i] = t0[i] == tgt[j] ? R.val[j][i] : 0u;
  a[0] = e[0][0] | (e[0][1] << 16);
  a[1] = e[1][0] | (e[1][1] << 16);
  a[2] = e[0][2] | (e[0][3] << 16);
  a[3] = e[1][2] | (e[1][3] << 16);
}

// RHS fragment of one n-tile: element (data row i, column col) = 1 if the
// row's lo_part == col.  b0: slots 2t, 2t+1 (data rows 0, 1); b1: slots
// 2t+8, 2t+9 (data rows 2, 3).
__device__ __forceinline__ void rhs_fragment(uint32_t word, int col,
                                             uint32_t& b0, uint32_t& b1) {
  const int l0 = word & (kLo - 1), l1 = (word >> 8) & (kLo - 1);
  const int l2 = (word >> 16) & (kLo - 1), l3 = (word >> 24) & (kLo - 1);
  b0 = (l0 == col ? kOne : 0u) | (l1 == col ? kOne << 16 : 0u);
  b1 = (l2 == col ? kOne : 0u) | (l3 == col ? kOne << 16 : 0u);
}

__device__ __forceinline__ void t0_of(const Rows& R, uint32_t word,
                                      int (&t0)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    t0[i] = R.nb[i] + static_cast<int>((word >> (8 * i)) & 0xffu) / kLo;
}

// A block: (tile, group of 8 features, m-tile).  8 / S warps, warp w
// owning features group*8 + w*S .. + S-1 and the m-tile's 16 LHS rows
// (S = 1: shipped, nodot, noconstr; 8: grpacc, pack8; 4: pack4).
// partial: [n_tiles, F, A, lo] f32.
template <int V, int S>
__global__ void __launch_bounds__(32 * kGroup / S)
hist_floor_kernel(const uint8_t* __restrict__ bins, long long ld,
                  const int32_t* __restrict__ node,
                  const float* __restrict__ g, const float* __restrict__ h,
                  int tile_rows, int n_features, int n_build, int hi,
                  int a_rows, int never, float* __restrict__ partial) {
  __shared__ float slab[V == kGrpacc ? kGroup * 16 * kLo : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, gid = lane >> 2;
  const int tile = blockIdx.x, m = blockIdx.z;
  const int f0 = blockIdx.y * kGroup + warp * S;
  const int nh = a_rows / 2;
  int tgt[2], plane[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = 16 * m + gid + 8 * j;
    plane[j] = r / nh;
    tgt[j] = r % nh;
  }
  const long long row0 = static_cast<long long>(tile) * tile_rows;
  float acc[S][kNT][4];
  float waste[kNT][4];
  float sa[2] = {0.f, 0.f}, sb[kNT];
#pragma unroll
  for (int q = 0; q < kNT; ++q) {
    sb[q] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      waste[q][c] = 0.f;
#pragma unroll
      for (int k = 0; k < S; ++k) acc[k][q][c] = 0.f;
    }
  }
  for (int ks = 0; ks < tile_rows; ks += 16) {
    const long long r = row0 + ks + 4 * t;
    Rows R;
    load_rows(node, g, h, r, n_build, hi, plane, R);
    if (V == kNoconstr) {
      uint32_t a[4];
      lhs_fragment(R, R.nb, tgt, a);
      const uint32_t b = gid == 0 ? (kOne | (kOne << 16)) : 0u;
#pragma unroll
      for (int q = 0; q < kNT; ++q)
        mma(acc[0][q], a, q == 0 ? b : 0u, q == 0 ? b : 0u);
      continue;
    }
    uint32_t word[S];
    uint32_t a[S][4];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      word[k] = *reinterpret_cast<const uint32_t*>(
          bins + static_cast<long long>(f0 + k) * ld + r);
      int t0[4];
      t0_of(R, word[k], t0);
      lhs_fragment(R, t0, tgt, a[k]);
    }
    if (V == kNodot) {
      // the LHS row sums of the lane's two rows and the RHS column sums
      // of its column in each n-tile, in f32 (exact while they stay
      // below 2^24 in units of the smallest value)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t lo_half = a[0][j], hi_half = a[0][2 + j];
        sa[j] += bf16_value(lo_half & 0xffffu) + bf16_value(lo_half >> 16) +
                 bf16_value(hi_half & 0xffffu) + bf16_value(hi_half >> 16);
      }
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        uint32_t b0, b1;
        rhs_fragment(word[0], 8 * q + gid, b0, b1);
        sb[q] += bf16_value(b0 & 0xffffu) + bf16_value(b0 >> 16) +
                 bf16_value(b1 & 0xffffu) + bf16_value(b1 >> 16);
      }
      continue;
    }
#pragma unroll
    for (int k2 = 0; k2 < S; ++k2) {
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        uint32_t b0, b1;
        rhs_fragment(word[k2], 8 * q + gid, b0, b1);
        if (V == kGrpacc) {      // each feature's own product only
          mma(acc[k2][q], a[k2], b0, b1);
          continue;
        }
#pragma unroll
        for (int k1 = 0; k1 < S; ++k1) {
          if (k1 == k2) {
            mma(acc[k1][q], a[k1], b0, b1);
          } else {
            mma(waste[q], a[k1], b0, b1);
          }
        }
      }
    }
  }

  // ---- the tile's [A, lo] blocks into the partial buffer ----
  const long long fstride = static_cast<long long>(a_rows) * kLo;
  float* tile_out = partial + static_cast<long long>(tile) * n_features * fstride;
  if (V == kNodot) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j) sa[j] += __shfl_xor_sync(0xffffffffu, sa[j], off);
#pragma unroll
      for (int q = 0; q < kNT; ++q) sb[q] += __shfl_xor_sync(0xffffffffu, sb[q], off);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // rowsum(rhs)[r] for LHS row r = 16m + gid + 8j: column r, held by
      // this lane (gid = r % 8) in n-tile r / 8 = 2m + j
      const float rs = m == 0 ? sb[j] : sb[2 + j];
      const float d = round_bf16(round_bf16(sa[j]) + round_bf16(rs));
      float4* dst = reinterpret_cast<float4*>(
          tile_out + f0 * fstride + (16 * m + gid + 8 * j) * kLo + 8 * t);
      dst[0] = make_float4(d, d, d, d);
      dst[1] = make_float4(d, d, d, d);
    }
    return;
  }
  if (V == kGrpacc) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        float* s = slab + k * 16 * kLo + gid * kLo + 8 * q + 2 * t;
        s[0] = acc[k][q][0];
        s[1] = acc[k][q][1];
        s[8 * kLo] = acc[k][q][2];
        s[8 * kLo + 1] = acc[k][q][3];
      }
    }
    __syncthreads();
    const int per_feat = 16 * kLo;
    for (int i = 4 * threadIdx.x; i < kGroup * per_feat; i += 4 * blockDim.x) {
      const int k = i / per_feat, rem = i - k * per_feat;
      *reinterpret_cast<float4*>(tile_out + (blockIdx.y * kGroup + k) * fstride +
                                 16 * m * kLo + rem) =
          *reinterpret_cast<const float4*>(slab + i);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    float* base = tile_out + (f0 + k) * fstride + (16 * m + gid) * kLo + 2 * t;
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      *reinterpret_cast<float2*>(base + 8 * q) =
          make_float2(acc[k][q][0], acc[k][q][1]);
      *reinterpret_cast<float2*>(base + 8 * kLo + 8 * q) =
          make_float2(acc[k][q][2], acc[k][q][3]);
    }
  }
  if (S > 1 && never) {
    // keeps the discarded off-diagonal products alive; never taken
    float w = 0.f;
#pragma unroll
    for (int q = 0; q < kNT; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) w += waste[q][c];
    partial[0] = w;
  }
}

// out[e] = 0 + partial[0][e] + partial[1][e] + ..., tiles in order
__global__ void tile_sum_kernel(const float* __restrict__ partial,
                                long long per_tile, int n_tiles,
                                float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= per_tile) return;
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < n_tiles; ++i) s = __fadd_rn(s, partial[i * per_tile + e]);
  out[e] = s;
}

template <int V, int S>
cudaError_t launch(dim3 grid, cudaStream_t s, const uint8_t* bins,
                   long long ld, const int32_t* node, const float* g,
                   const float* h, int tile_rows, int n_features, int n_build,
                   int hi, int a_rows, float* partial) {
  hist_floor_kernel<V, S><<<grid, 32 * kGroup / S, 0, s>>>(
      bins, ld, node, g, h, tile_rows, n_features, n_build, hi, a_rows, 0,
      partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bins: [F, >= n_tiles * tile_rows] uint8, row stride ld (a multiple of 4);
// node int32, g, h f32: [>= n_tiles * tile_rows], 16-byte aligned.
// partial: [n_tiles, F, 2*n_build*hi, 32] f32 scratch; out: [F,
// 2*n_build*hi, 32] f32.  lo is 32: 2*n_build*hi must be 16 or 32, F a
// multiple of 8, tile_rows a multiple of 16.
int dmlc_hist_floor(const void* bins, long long ld, const void* node,
                    const void* g, const void* h, int n_tiles, int tile_rows,
                    int n_features, int n_build, int hi, int variant,
                    void* partial, void* out, void* stream) {
  const int a_rows = 2 * n_build * hi;
  if (n_tiles <= 0 || tile_rows <= 0 || tile_rows % 16 != 0 ||
      n_features <= 0 || n_features % kGroup != 0 ||
      (a_rows != 16 && a_rows != 32) || ld % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(n_features / kGroup),
                  static_cast<unsigned>(a_rows / 16));
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* nd = static_cast<const int32_t*>(node);
  const auto* gp = static_cast<const float*>(g);
  const auto* hp = static_cast<const float*>(h);
  auto* p = static_cast<float*>(partial);
  cudaError_t e;
  switch (variant) {
    case kShipped:
      e = launch<kShipped, 1>(grid, s, b, ld, nd, gp, hp, tile_rows,
                              n_features, n_build, hi, a_rows, p);
      break;
    case kGrpacc:
      e = launch<kGrpacc, kGroup>(grid, s, b, ld, nd, gp, hp, tile_rows,
                                  n_features, n_build, hi, a_rows, p);
      break;
    case kNodot:
      if (a_rows > kLo) return cudaErrorInvalidValue;
      e = launch<kNodot, 1>(grid, s, b, ld, nd, gp, hp, tile_rows,
                            n_features, n_build, hi, a_rows, p);
      break;
    case kNoconstr:
      e = launch<kNoconstr, 1>(grid, s, b, ld, nd, gp, hp, tile_rows,
                               n_features, n_build, hi, a_rows, p);
      break;
    case kPack4:
      e = launch<kPack4, 4>(grid, s, b, ld, nd, gp, hp, tile_rows,
                            n_features, n_build, hi, a_rows, p);
      break;
    case kPack8:
      e = launch<kPack8, 8>(grid, s, b, ld, nd, gp, hp, tile_rows,
                            n_features, n_build, hi, a_rows, p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  const long long per_tile = static_cast<long long>(n_features) * a_rows * kLo;
  const int threads = 256;
  tile_sum_kernel<<<static_cast<unsigned>((per_tile + threads - 1) / threads),
                    threads, 0, s>>>(p, per_tile, n_tiles,
                                     static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
