// Histogram-floor measurement kernels for Hopper (sm_90a): the one-hot
// matrix-product histogram on the tensor cores, in the variants that
// attribute its cost to construction, product and accumulation.  Bound
// through a plain C interface (ops/_build.py loads this file's shared
// library with ctypes); the wrapper, the host plan of tile runs and the
// plain versions are in dmlc_core_tpu_torch/tools/spike_hist_floor.py.
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
// with lo = 32 (hi = 8), the TPU's [A, T] x [T, lo] one-hot product per
// tile and feature (A = 2*nh).  The variants (each its plain version's
// function):
//
//   shipped   the histogram, one product per feature and k-step.
//   grpacc    the same products; the group's 8 features leave through a
//             shared-memory slab in one coalesced store.
//   nodot     construction only: the operands are built exactly as for
//             the products, which are not issued; per tile and feature
//             d[r, :] = bf16(bf16(rowsum(lhs)[r]) + bf16(rowsum(rhs)[r]))
//             over the TPU's factors (the lhs row sums in f32, rounded
//             once; rowsum(rhs)[r] counts the tile's rows, all of them,
//             whose bin % lo == r; needs A <= lo), kept by each thread in
//             private shared-memory sums and reduced in a fixed order.
//   noconstr  the products of one fixed pair a k-step: the one-hot side
//             is the constant "bin 0", the row side is built once a
//             k-step for all features and no bin is read.  Every feature
//             gets the same [A, lo] block, column 0 filled.
//   pack4/8   S features share ONE product: per k-step the S x S blocks
//             of [S one-hots] x [S row sides], the diagonal ones into the
//             features' sums and the off-diagonal ones computed and thrown
//             away (that waste is what the variant measures), into an
//             accumulator kept alive only by a store the caller never
//             asks for.
//
// What bounds it on an H100: the useful tensor-core work, 2*A*lo*T*F
// bf16 FLOP a tile (0.249 / 0.497 ms at 10M x 24 with n_build 1 / 2 at
// 989 TFLOP/s), against 0.107 ms for the bytes (the bins once, node and
// g/h once).  A design whose warps each rebuild the row side (node,
// plane, bf16 g/h) for every feature and k-step, chain synchronous
// mma.sync products and write every tile's block for a second pass spends
// most of its time building one-hots (3.64 ms, 3.07 of it without the
// products; PERF.md).
//
// Design (one warpgroup a block, a group of 8 features, a run of
// consecutive tiles from the host plan):
//  * The product is wgmma.mma_async m64nNk16 with both operands in shared
//    memory.  Its M of 64 is the one-hot side: internally bin = hi' * 64 +
//    lo' (hi' < 4), M the lo' one-hot [64, 16 rows], N = 2 * n_build * 4
//    the row side [16 rows, (plane, node, hi')] holding the row's bf16 g
//    or h in its two cells: 64 x N is exactly a feature's 2 * n_build *
//    256 cells, so nothing issued is padding (the product's issued FLOP
//    is the useful 2*A*lo*T*F), and the cell (lo', (plane, node, hi'))
//    is out[f, plane*nh + node*hi + (hi'*64 + lo')/lo, lo' % lo].
//  * Construction is stores: a thread owns (feature, row) of each k-step;
//    the one-hot tile stays zero but for 16 ones, so the thread clears the
//    one it set in that stage two k-steps before and sets the new one (two
//    16-bit stores), and writes its row-side row (N bf16, 16 or 32 bytes).
//    Node, g and h are read and rounded once a k-step for the block (16
//    threads, one k-step ahead) into a row-side buffer every feature reads.
//  * Two stages: the products of k-step i run while k-step i + 1 is built;
//    wgmma.wait_group 1 keeps a stage's readers ahead of its next writer.
//  * The sums stay in registers over the block's run of tiles, added in
//    tile order, and one partial a run leaves; a second small kernel adds
//    the runs in order (no atomics: the bytes are the same run to run).
//    On order-exact g/h every sum is exact, so every order agrees with the
//    plain version's tile-by-tile sums bit for bit.
//  * The one-hot tile is 2 KB a product: the tensor cores read it from
//    shared memory at the SM's shared-memory rate, which, and not the
//    construction, is this design's expected floor (~1.2 ms at 10M x 24).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLo = 32;            // the output's lo_part width (hi = 8)
constexpr int kHi = 8;
constexpr int kGroup = 8;          // features a block
constexpr int kThreads = 128;      // one warpgroup
constexpr int kRows = 16;          // rows a k-step
constexpr int kAhead = 4;          // k-steps whose loads are in flight
constexpr uint32_t kOne = 0x3F80u; // bf16 1.0
// the one-hot tile: 64 (lo') x 16 (rows) bf16, K-major, 8 x 8 core
// matrices (16-byte rows), the two K halves a column block apart
constexpr int kACB = 64 * 16 + 16;
constexpr int kABytes = 2 * kACB;
// the row-side tile: 16 (rows, K) x N bf16, MN-major, core matrices of 8
// rows x 8 columns, column blocks kBCB apart
constexpr int kBCB = kRows * 16 + 16;

enum Variant {
  kShipped = 0, kGrpacc = 1, kNodot = 2, kNoconstr = 3, kPack4 = 4,
  kPack8 = 5
};

template <int N>
struct Layout {
  static constexpr int kBBytes = N / 8 * kBCB;
  static constexpr int kFeat = kABytes + kBBytes;     // a feature's tiles
  static constexpr int kStage = kGroup * kFeat;
  static constexpr int kRowSide = 2 * kRows * 8;      // two k-steps, int2
  // nodot: each thread's row sums (lhs [32][128] f32, thread-minor:
  // conflict-free) and each feature's counts (rhs [8][32] int)
  static constexpr int kPrivate = 32 * kThreads * 4 + kGroup * kLo * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address,
// leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(const unsigned char* p, int lbo,
                                         int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// byte offset of element (lo' m, row k) of a one-hot tile (K-major) and
// of (row k, column n) of a row-side tile (MN-major)
__device__ __forceinline__ int a_off(int m, int k) {
  return (k >> 3) * kACB + (m >> 3) * 128 + (m & 7) * 16 + (k & 7) * 2;
}
__device__ __forceinline__ int b_off(int k, int n) {
  return (n >> 3) * kBCB + (k >> 3) * 128 + (k & 7) * 16 + (n & 7) * 2;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
// this thread's shared-memory stores, before the tensor cores (the async
// proxy) read them; a barrier then publishes them to the warpgroup
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N f32, mma.sync's m16n8 accumulator layout per warp) += A (64 x
// 16 at da, K-major) times B (16 x N at db, MN-major), both from shared
// memory
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A block: (run of tiles, group of 8 features).  Thread t owns feature f =
// t / 16 of the group and row k = t % 16 of every k-step.  partial:
// [runs, F, A, lo] f32, one [F, A, lo] block a run.
template <int V, int N>
__global__ void __launch_bounds__(kThreads)
hist_floor_kernel(const uint8_t* __restrict__ bins, long long ld,
                  const int32_t* __restrict__ node,
                  const float* __restrict__ g, const float* __restrict__ h,
                  int tile_rows, int n_tiles, int tiles_per_run,
                  int n_features, int never, float* __restrict__ partial) {
  typedef Layout<N> L;
  constexpr int n_build = N / 8;
  constexpr int nh = n_build * kHi;
  constexpr int A = 2 * nh;
  constexpr bool kProduct = V != kNodot;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* stages = smem;
  int2* rowside = reinterpret_cast<int2*>(smem + 2 * L::kStage);
  float* lhs = reinterpret_cast<float*>(smem + 2 * L::kStage + L::kRowSide);
  int* cnt = reinterpret_cast<int*>(lhs + 32 * kThreads);     // [8][lo]

  const int tid = threadIdx.x;
  const int f = tid >> 4, k = tid & 15;
  const int run = blockIdx.x;
  const int feat0 = blockIdx.y * kGroup;
  const int t0 = run * tiles_per_run;
  const int t1 = min(n_tiles, t0 + tiles_per_run);
  const long long row0 = static_cast<long long>(t0) * tile_rows;
  const int steps = (t1 - t0) * (tile_rows / kRows);
  const int steps_a_tile = tile_rows / kRows;
  const uint8_t* brow = bins + static_cast<long long>(feat0 + f) * ld;

  // both stages zero; noconstr's one-hot is "bin 0" for every row, in
  // feature 0's tile (all its products read that pair)
  for (int i = tid; i < 2 * L::kStage / 16; i += kThreads)
    reinterpret_cast<uint4*>(stages)[i] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (V == kNodot) {
    for (int i = 0; i < 32; ++i) lhs[i * kThreads + tid] = 0.f;
    for (int i = tid; i < kGroup * kLo; i += kThreads) cnt[i] = 0;
  }
  __syncthreads();
  if constexpr (V == kNoconstr) {
    if (tid < 2 * kRows) {
      unsigned char* a = stages + (tid / kRows) * L::kStage;
      *reinterpret_cast<uint16_t*>(a + a_off(0, tid % kRows)) = kOne;
    }
  }
  // the row side of a k-step: (node * 4, or -1 where the row adds
  // nothing; bf16 g | bf16 h << 16), built by 16 threads a k-step ahead
  // from loads issued kAhead k-steps ahead (as is each thread's bin byte),
  // so no k-step waits for device memory
  auto row_side = [&](int nd, float gv, float hv) {
    const bool in = nd >= 0 && nd < n_build;
    return make_int2(in ? 4 * nd : -1,
                     static_cast<int>(bf16_bits(gv) | (bf16_bits(hv) << 16)));
  };
  int bq[kAhead], nq[kAhead];
  float gq[kAhead], hq[kAhead];
  auto fetch = [&](int j, int i) {
    const long long r = row0 + static_cast<long long>(i) * kRows;
    const bool ok = i < steps;
    bq[j] = (V != kNoconstr && ok) ? brow[r + k] : 0;
    const bool side = ok && tid < kRows;
    nq[j] = side ? node[r + tid] : -1;
    gq[j] = side ? g[r + tid] : 0.f;
    hq[j] = side ? h[r + tid] : 0.f;
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j) fetch(j, j);
  if (tid < kRows) rowside[tid] = row_side(nq[0], gq[0], hq[0]);

  float acc[kGroup][N / 2];
  float waste[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    waste[j] = 0.f;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) acc[q][j] = 0.f;
  }
  float run_d[2] = {0.f, 0.f};   // nodot: this thread's two (f, r) sums
  int set0 = -1, set1 = -1;       // the one-hot element set in each stage
  __syncthreads();

  // slot s of the ring holds the loads of k-step i0 + s: the loop is
  // unrolled over the slots, so a slot is read where it is consumed and
  // reloaded in place (a register copy would wait for the load)
  static_assert(kAhead % 2 == 0, "the stage of slot s is s & 1");
  for (int i0 = 0; i0 < steps; i0 += kAhead) {
#pragma unroll
   for (int slot = 0; slot < kAhead; ++slot) {
    const int i = i0 + slot;
    if (i >= steps) break;
    const int st = slot & 1;
    const int b = bq[slot];
    const int nx = (slot + 1) % kAhead;
    const int2 rs_next = row_side(nq[nx], gq[nx], hq[nx]);
    fetch(slot, i + kAhead);
    if (tid < kRows && i + 1 < steps)
      rowside[(st ^ 1) * kRows + tid] = rs_next;
    // the products that read this stage (k-step i - 2) are done
    if constexpr (kProduct) wgmma_wait<1>();
    unsigned char* stage = stages + st * L::kStage;
    const int2 rs = rowside[st * kRows + k];
    const int hv = b >> 6;
    if constexpr (V != kNoconstr) {
      unsigned char* a = stage + f * L::kFeat;
      const int off = a_off(b & 63, k);
      const int prev = st ? set1 : set0;
      if (prev >= 0 && prev != off) *reinterpret_cast<uint16_t*>(a + prev) = 0;
      *reinterpret_cast<uint16_t*>(a + off) = static_cast<uint16_t>(kOne);
      if (st) set1 = off; else set0 = off;
    }
    if (V != kNoconstr || f == 0) {
      // the row side's row k: the row's g at column (g plane, node, hi'),
      // its h at (h plane, node, hi') (noconstr: hi' 0)
      const int c_g = rs.x < 0 ? -1 : rs.x + (V == kNoconstr ? 0 : hv);
      const int c_h = rs.x < 0 ? -1 : N / 2 + c_g;
      const uint32_t gb = static_cast<uint32_t>(rs.y) & 0xffffu;
      const uint32_t hb = static_cast<uint32_t>(rs.y) >> 16;
      uint32_t w[N / 2];
#pragma unroll
      for (int j = 0; j < N / 2; ++j)
        w[j] = ((c_g >> 1) == j ? gb << (16 * (c_g & 1)) : 0u) |
               ((c_h >> 1) == j ? hb << (16 * (c_h & 1)) : 0u);
      unsigned char* bt = stage + f * L::kFeat + kABytes;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<uint4*>(bt + b_off(k, 8 * j)) =
            make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
    }
    if constexpr (V == kNodot) {
      // the TPU factors' row sums (valid rows; this thread's own, in
      // order) and bin % lo counts (all rows; integers, any order)
      if (rs.x >= 0) {
        float* pg = lhs + ((rs.x >> 2) * kHi + (b >> 5)) * kThreads + tid;
        float* ph = pg + nh * kThreads;
        const float a0 = *pg, a1 = *ph;
        *pg = a0 + __uint_as_float((static_cast<uint32_t>(rs.y) & 0xffffu) << 16);
        *ph = a1 + __uint_as_float(static_cast<uint32_t>(rs.y) & 0xffff0000u);
      }
      atomicAdd(cnt + f * kLo + (b & (kLo - 1)), 1);
    }
    if constexpr (kProduct) fence_async_shared();
    __syncthreads();
    if constexpr (kProduct) {
      wgmma_fence();
      auto da = [&](int q) {
        return desc(stage + q * L::kFeat, kACB, 128);
      };
      auto db = [&](int q) {
        return desc(stage + q * L::kFeat + kABytes, 128, kBCB);
      };
      if constexpr (V == kNoconstr) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) wgmma<N>(acc[q], da(0), db(0));
      } else if constexpr (V == kPack4 || V == kPack8) {
        constexpr int S = V == kPack4 ? 4 : 8;
#pragma unroll
        for (int q0 = 0; q0 < kGroup; q0 += S)
#pragma unroll
          for (int k1 = 0; k1 < S; ++k1)
#pragma unroll
            for (int k2 = 0; k2 < S; ++k2) {
              if (k1 == k2)
                wgmma<N>(acc[q0 + k1], da(q0 + k1), db(q0 + k2));
              else
                wgmma<N>(waste, da(q0 + k1), db(q0 + k2));
            }
      } else {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) wgmma<N>(acc[q], da(q), db(q));
      }
      wgmma_commit();
    }
    if constexpr (V == kNodot) {
      if ((i + 1) % steps_a_tile == 0) {
        // the tile's d, reduced over the feature's 16 threads in order,
        // added to the run's sums in tile order; then each thread's sums
        // start again
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int rr = k + 16 * j;
          if (rr < A) {
            float s = 0.f;
            for (int u = 0; u < kRows; ++u)
              s += lhs[rr * kThreads + f * kRows + u];
            const int c = cnt[f * kLo + rr];
            run_d[j] += round_bf16(round_bf16(s) +
                                   round_bf16(static_cast<float>(c)));
          }
        }
        __syncthreads();
        for (int c = 0; c < 32; ++c) lhs[c * kThreads + tid] = 0.f;
        for (int c = tid; c < kGroup * kLo; c += kThreads) cnt[c] = 0;
        __syncthreads();
      }
    }
   }
  }
  if constexpr (kProduct) wgmma_wait<0>();

  // ---- the run's [8, A, lo] block into the partial buffer ----
  const long long fstride = static_cast<long long>(A) * kLo;
  float* run_out = partial + static_cast<long long>(run) * n_features * fstride;
  if constexpr (V == kNodot) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int rr = k + 16 * j;
      if (rr >= A) continue;
      float4* dst = reinterpret_cast<float4*>(
          run_out + (feat0 + f) * fstride + rr * kLo);
      const float d = run_d[j];
#pragma unroll
      for (int c = 0; c < kLo / 4; ++c) dst[c] = make_float4(d, d, d, d);
    }
    return;
  }
  // lane (w, g8 = lane / 4, t = lane % 4) holds rows 16w + g8 (+8) at
  // columns 8j + 2t (+1) of each feature's 64 x N sums
  const int lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t = lane & 3;
  auto cell = [&](int m, int n) {
    const int plane = n / (N / 2);
    const int nd = (n >> 2) % n_build;
    const int bin = (n & 3) * 64 + m;
    return (plane * nh + nd * kHi + bin / kLo) * kLo + bin % kLo;
  };
  if constexpr (V == kGrpacc) {
    // through a slab of the group's block, then one coalesced store
    __syncthreads();
    float* slab = reinterpret_cast<float*>(stages);
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const int m = 16 * warp + g8 + 8 * ((j >> 1) & 1);
        const int n = 8 * (j >> 2) + 2 * t + (j & 1);
        slab[q * fstride + cell(m, n)] = acc[q][j];
      }
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(run_out + feat0 * fstride);
    const float4* src = reinterpret_cast<const float4*>(slab);
    for (int i = tid; i < kGroup * fstride / 4; i += kThreads) dst[i] = src[i];
    return;
  }
#pragma unroll
  for (int q = 0; q < kGroup; ++q)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const int m = 16 * warp + g8 + 8 * ((j >> 1) & 1);
      const int n = 8 * (j >> 2) + 2 * t + (j & 1);
      run_out[(feat0 + q) * fstride + cell(m, n)] = acc[q][j];
    }
  if ((V == kPack4 || V == kPack8) && never) {
    // keeps the discarded off-diagonal products alive; never taken
    float w = 0.f;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) w += waste[j];
    partial[0] = w;
  }
}

// out[e] = 0 + partial[0][e] + partial[1][e] + ..., runs in order
__global__ void run_sum_kernel(const float* __restrict__ partial,
                               long long per_run, int runs,
                               float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= per_run) return;
  float s = 0.f;
#pragma unroll 8
  for (int i = 0; i < runs; ++i) s = __fadd_rn(s, partial[i * per_run + e]);
  out[e] = s;
}

template <int V, int N>
cudaError_t launch(dim3 grid, cudaStream_t s, const uint8_t* bins,
                   long long ld, const int32_t* node, const float* g,
                   const float* h, int tile_rows, int n_tiles,
                   int tiles_per_run, int n_features, float* partial) {
  typedef Layout<N> L;
  const int smem =
      2 * L::kStage + L::kRowSide + (V == kNodot ? L::kPrivate : 0);
  auto kernel = hist_floor_kernel<V, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, s>>>(bins, ld, node, g, h, tile_rows,
                                      n_tiles, tiles_per_run, n_features, 0,
                                      partial);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_variant(int variant, dim3 grid, cudaStream_t s,
                           const uint8_t* b, long long ld, const int32_t* nd,
                           const float* gp, const float* hp, int tile_rows,
                           int n_tiles, int tiles_per_run, int n_features,
                           float* p) {
#define DMLC_FLOOR_CASE(V)                                                  \
  case V:                                                                   \
    return launch<V, N>(grid, s, b, ld, nd, gp, hp, tile_rows, n_tiles,     \
                        tiles_per_run, n_features, p);
  switch (variant) {
    DMLC_FLOOR_CASE(kShipped)
    DMLC_FLOOR_CASE(kGrpacc)
    DMLC_FLOOR_CASE(kNodot)
    DMLC_FLOOR_CASE(kNoconstr)
    DMLC_FLOOR_CASE(kPack4)
    DMLC_FLOOR_CASE(kPack8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DMLC_FLOOR_CASE
}

}  // namespace

extern "C" {

// bins: [F, >= n_tiles * tile_rows] uint8, row stride ld; node int32, g,
// h f32: [>= n_tiles * tile_rows].  A block per (run of tiles_per_run
// consecutive tiles, group of 8 features); partial: [runs, F,
// 2*n_build*hi, 32] f32 scratch, runs = ceil(n_tiles / tiles_per_run);
// out: [F, 2*n_build*hi, 32] f32.  lo is 32 (hi 8), n_build 1 or 2, F a
// multiple of 8, tile_rows a multiple of 16.
int dmlc_hist_floor(const void* bins, long long ld, const void* node,
                    const void* g, const void* h, int n_tiles, int tile_rows,
                    int n_features, int n_build, int hi, int variant,
                    int tiles_per_run, void* partial, void* out,
                    void* stream) {
  if (n_tiles <= 0 || tile_rows <= 0 || tile_rows % kRows != 0 ||
      n_features <= 0 || n_features % kGroup != 0 || hi != kHi ||
      (n_build != 1 && n_build != 2) || tiles_per_run <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int runs = (n_tiles + tiles_per_run - 1) / tiles_per_run;
  const dim3 grid(static_cast<unsigned>(runs),
                  static_cast<unsigned>(n_features / kGroup));
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* nd = static_cast<const int32_t*>(node);
  const auto* gp = static_cast<const float*>(g);
  const auto* hp = static_cast<const float*>(h);
  auto* p = static_cast<float*>(partial);
  cudaError_t e =
      n_build == 1
          ? launch_variant<8>(variant, grid, s, b, ld, nd, gp, hp, tile_rows,
                              n_tiles, tiles_per_run, n_features, p)
          : launch_variant<16>(variant, grid, s, b, ld, nd, gp, hp,
                               tile_rows, n_tiles, tiles_per_run, n_features,
                               p);
  if (e != cudaSuccess) return e;
  const long long per_run =
      static_cast<long long>(n_features) * 2 * n_build * hi * kLo;
  const int threads = 256;
  run_sum_kernel<<<static_cast<unsigned>((per_run + threads - 1) / threads),
                   threads, 0, s>>>(p, per_run, runs,
                                    static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
