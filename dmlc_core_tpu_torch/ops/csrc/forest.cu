// Forest prediction for Hopper (sm_90a), bound through a plain C interface
// (ops/_build.py loads this file's shared library with ctypes).
//
// Replaces, for prediction, the per-level use of B2's descend
// (descend_kernel in histogram.cu, one launch a tree level, then a gather
// and an add a tree): the counterpart of the JAX package's compiled
// _predict_trees and _leaf_indices (dmlc_core_tpu/models/histgbt.py:2962,
// :2989), which XLA builds into one program a chunk of 64 trees.  One
// launch here walks EVERY tree of a forest, all chunks and, under
// multi:softmax, all classes:
//
//   margins mode: margin[r, c] = init[r, c] + leaf_0[node_0(r)] + ... in
//                 tree order, each add rounded once in f32 (no multiply:
//                 -fmad=false changes nothing here, __fadd_rn pins it),
//                 then + 0.0 when the forest's last 64-tree chunk is short
//                 (the JAX package pads it with all-zero trees, whose
//                 +0.0 turns a margin of -0.0 into +0.0);
//   leaves mode:  leaf[r, t, c] = the leaf position of row r in tree t of
//                 class c (predict_leaf).
//
// A row walks from the root by node = 2*node + (bin > thr), the rule of
// descend_plain (ops/histogram.py); with a direction table (missing mode)
// a row whose bin is miss_bin goes right iff its node's direction is 0.
//
// The forest arrives packed (ops/forest.py, pack_forest): a fixed-size,
// 16-byte-aligned record a tree, trees class-major (class c's trees in
// round order, then class c+1's):
//
//   leaves   f32 [2^depth]
//   dirs     u32 [ceil((2^depth - 1) / 32)]: bit h = 1 where heap node h
//            sends its missing rows right (missing mode only, else none)
//   records  [2^depth - 1] in heap order (level by level, node by node),
//            each naming its split feature by its place in the block's
//            tile: slot u (an index into used[], the forest's distinct
//            split features, the bin matrix rows the kernel reads) as
//            quad q = u / 4 and byte k = u % 4.  u16 (q << 10 | k << 8 |
//            thr) when the forest splits on at most 256 distinct features
//            with every threshold in [0, 255]; else u32 (off << 9 | thr +
//            1) with off = 128 q + k, the feature's byte offset in a
//            warp's tile, and thr clamped to [-1, 255] (bins are bytes, so
//            the clamp changes no comparison).
//
// What bounds it on an H100: the lookups.  Each row reads its bytes once
// (n_used + 4 + 4K bytes a row in, 4K out: 10M x 28 is 0.107 ms at 3.35
// TB/s), but walks trees x depth nodes, each a dependent pair of shared
// memory reads (the node's record, then the row's byte); at 100 trees of
// depth 6 that is 600 lookups a row, 6e9 over 10M rows, against the
// card's 132 SMs x 32 lanes x ~1.98 GHz shared-memory rate (~0.72 ms).
// The design keeps every lookup in shared memory:
//
//   * a block takes a tile of R = 4 x threads rows and loads their bytes
//     of the used features ONCE, with coalesced 16-byte loads from the
//     feature-major [F, n] matrix (16 rows of 4 features a thread,
//     transposed with byte permutes), into a tile of words [R / 32][quad]
//     [32]: word (w, q, l) holds features 4q..4q+3 of row 32 w + l, so
//     the 32 threads of a warp, 32 consecutive rows, read 32 consecutive
//     words whatever feature each needs (no bank conflict), one byte load
//     at the row's base plus the record's offset;
//   * the trees' records are staged in shared memory a group at a time
//     (as many trees as the budget holds; the whole forest of a served
//     model or of 100 depth-6 trees is one group), the next group copied
//     with cp.async while the current one is walked (two buffers);
//   * each thread walks four rows side by side (four independent chains
//     of dependent loads: a level is a record load, an add, a byte load,
//     a compare) through every tree, the margin in a register, written
//     once at the end of its class.
//
// The wrapper (ops/forest.py, forest_plan) picks the threads and the
// group size from the card's shared memory, three blocks an SM where they
// fit (72-76 registers a thread).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kRowsPerThread = 4;
constexpr int kMaxThreads = 256;

struct Forest {
  const uint8_t* bins;   // [F, n] feature-major bins
  long long n;
  const int32_t* used;   // [n_used]: the bins row of each record slot
  int n_used;
  int quads;             // ceil(n_used / 4): words a row in the tile
  const uint8_t* blob;   // [n_trees, tree_bytes]
  int tree_bytes, dir_off, rec_off;
  int n_trees, per_class, n_class, depth;
  int missing, miss_bin, add_zero;
  int group_trees, n_groups;
  const float* init;     // [n, n_class] (margins mode)
  float* margin;         // [n, n_class], or null in leaves mode
  int32_t* leaf;         // [n, per_class, n_class] in leaves mode
};

template <typename Rec>
struct Codec;

// A record's byte offset in a warp's tile (128 q + k) and its rule:
// right iff the row's byte is above the threshold.
template <>
struct Codec<uint16_t> {
  __device__ static uint32_t off(uint32_t r) {
    return ((r >> 3) & 0x1F80u) | ((r >> 8) & 3u);
  }
  __device__ static bool right(uint32_t b, uint32_t r) {
    return b > (r & 0xFFu);
  }
};

template <>
struct Codec<uint32_t> {
  __device__ static uint32_t off(uint32_t r) { return r >> 9; }
  __device__ static bool right(uint32_t b, uint32_t r) {  // b > thr
    return b >= (r & 0x1FFu);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of group g's records into dst (cp.async, 16 bytes a
// thread a step; tree_bytes is a multiple of 16).
__device__ void stage_group(const Forest& f, int g, uint8_t* dst) {
  const int j0 = g * f.group_trees;
  const int jn = min(f.group_trees, f.n_trees - j0);
  const long long bytes = static_cast<long long>(jn) * f.tree_bytes;
  const uint8_t* src = f.blob + static_cast<long long>(j0) * f.tree_bytes;
  for (long long o = 16LL * threadIdx.x; o < bytes; o += 16LL * blockDim.x)
    cp_async16(dst + o, src + o);
  cp_commit();
}

// Four words of four features, each word four consecutive rows (byte i =
// row i), into four words of four rows, each word four features (byte k =
// feature k).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d,
                                           uint32_t* w) {
  const uint32_t lo01 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t hi01 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t lo23 = __byte_perm(c, d, 0x5140);
  const uint32_t hi23 = __byte_perm(c, d, 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);           // a0 b0 c0 d0
  w[1] = __byte_perm(lo01, lo23, 0x7632);           // a1 b1 c1 d1
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The block's rows [r0, r0 + R) of the used features into tile[R / 32]
// [quad][32] (rows past n and slots past n_used read as 0).  A work item
// is 16 rows of one quad of features: four 16-byte loads where the run is
// whole and aligned, else byte loads.
__device__ void load_tile(const Forest& f, uint32_t* tile, long long r0,
                          int R) {
  const int runs = R >> 4;
  const int items = f.quads * runs;
  const bool vec = (f.n & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(f.bins) & 15) == 0;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q = it / runs;
    const int s = it - q * runs;
    const long long row = r0 + 16LL * s;
    uint32_t w[16];
    if (vec && row + 16 <= f.n) {
      uint4 x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = 4 * q + k;
        x[k] = u < f.n_used
                   ? __ldg(reinterpret_cast<const uint4*>(
                         f.bins + static_cast<long long>(f.used[u]) * f.n +
                         row))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
      transpose4(x[0].x, x[1].x, x[2].x, x[3].x, w + 0);
      transpose4(x[0].y, x[1].y, x[2].y, x[3].y, w + 4);
      transpose4(x[0].z, x[1].z, x[2].z, x[3].z, w + 8);
      transpose4(x[0].w, x[1].w, x[2].w, x[3].w, w + 12);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t v = 0;
        const long long r = row + j;
        if (r < f.n) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int u = 4 * q + k;
            if (u < f.n_used)
              v |= static_cast<uint32_t>(
                       f.bins[static_cast<long long>(f.used[u]) * f.n + r])
                   << (8 * k);
          }
        }
        w[j] = v;
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(
        tile + ((s >> 1) * f.quads + q) * 32 + 16 * (s & 1));
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    dst[2] = make_uint4(w[8], w[9], w[10], w[11]);
    dst[3] = make_uint4(w[12], w[13], w[14], w[15]);
  }
}

// Every pointer below is an offset from smem, so that the compiler emits
// shared-memory loads (a pointer picked from an array would be a generic
// one, each load paying the generic path).
template <typename Rec, bool kMissing>
__global__ void __launch_bounds__(kMaxThreads, 3)
    forest_kernel(const Forest f) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int R = blockDim.x * kRowsPerThread;
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);
  uint8_t* const buf0 = smem + static_cast<size_t>(f.quads) * R * 4;
  const int group_bytes = f.group_trees * f.tree_bytes;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;

  stage_group(f, 0, buf0);   // overlaps the tile's loads
  load_tile(f, tile, r0, R);

  const bool margins = f.margin != nullptr;
  const int K = f.n_class;
  const uint8_t* const tile8 = smem;
  uint32_t base[kRowsPerThread];   // the row's first byte in the tile
  long long row[kRowsPerThread];
  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int lr = threadIdx.x + k * blockDim.x;
    base[k] = (lr >> 5) * f.quads * 128 + (lr & 31) * 4;
    row[k] = r0 + lr;
    acc[k] = (margins && row[k] < f.n) ? f.init[row[k] * K] : 0.0f;
  }
  int cls = 0, t = 0;   // the tree's class, and its place in the class
  const int first_leaf = (1 << f.depth) - 1;

  for (int g = 0; g < f.n_groups; ++g) {
    if (g + 1 < f.n_groups) {
      stage_group(f, g + 1, buf0 + ((g + 1) & 1) * group_bytes);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();   // group g's records and the tile, from every thread
    const uint8_t* cur = buf0 + (g & 1) * group_bytes;
    const int j0 = g * f.group_trees;
    const int jn = min(f.group_trees, f.n_trees - j0);
    for (int i = 0; i < jn; ++i) {
      const uint8_t* tb = cur + static_cast<size_t>(i) * f.tree_bytes;
      const float* leaves = reinterpret_cast<const float*>(tb);
      const uint32_t* dirs = reinterpret_cast<const uint32_t*>(tb + f.dir_off);
      const Rec* recs = reinterpret_cast<const Rec*>(tb + f.rec_off);
      if (t == f.per_class) {   // class cls is done: write it
        if (margins) {
#pragma unroll
          for (int k = 0; k < kRowsPerThread; ++k) {
            if (row[k] < f.n) {
              f.margin[row[k] * K + cls] =
                  f.add_zero ? __fadd_rn(acc[k], 0.0f) : acc[k];
              acc[k] = f.init[row[k] * K + cls + 1];
            }
          }
        }
        ++cls;
        t = 0;
      }
      int h[kRowsPerThread];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) h[k] = 0;
#pragma unroll 2
      for (int d = 0; d < f.depth; ++d) {
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) {
          const uint32_t r = recs[h[k]];
          const uint32_t b = tile8[base[k] + Codec<Rec>::off(r)];
          int right = Codec<Rec>::right(b, r) ? 1 : 0;
          if (kMissing && static_cast<int>(b) == f.miss_bin)
            right = (dirs[h[k] >> 5] >> (h[k] & 31)) & 1;
          h[k] = 2 * h[k] + 1 + right;
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int node = h[k] - first_leaf;
        if (margins) {
          acc[k] = __fadd_rn(acc[k], leaves[node]);
        } else if (row[k] < f.n) {
          f.leaf[(row[k] * f.per_class + t) * K + cls] = node;
        }
      }
      ++t;
    }
    __syncthreads();   // every thread is done with group g's buffer
  }
  if (margins) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k)
      if (row[k] < f.n)
        f.margin[row[k] * K + cls] =
            f.add_zero ? __fadd_rn(acc[k], 0.0f) : acc[k];
  }
}

}  // namespace

extern "C" {

// bins [F, n] uint8; used [n_used] int32; blob [n_trees, tree_bytes]
// (tree_bytes a multiple of 16, dir_off and rec_off its sections); wide:
// u32 records, else u16; n_trees = per_class * n_class, class-major;
// init and margin [n, n_class] f32 (margins mode), or init and margin
// null and leaf [n, per_class, n_class] int32 (leaves mode); threads a
// multiple of 32 up to 512, group_trees records a stage, smem the block's
// dynamic shared bytes (the tile, then one or two groups).
int dmlc_predict_forest(const void* bins, long long n, const void* used,
                        int n_used, const void* blob, int tree_bytes,
                        int dir_off, int rec_off, int wide, int n_trees,
                        int per_class, int n_class, int depth, int missing,
                        int miss_bin, int add_zero, const void* init,
                        void* margin, void* leaf, int threads,
                        int group_trees, int smem, void* stream) {
  if (n <= 0 || n_used <= 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0 || tree_bytes <= 0 || tree_bytes % 16 != 0 ||
      n_trees <= 0 || per_class <= 0 || n_class <= 0 ||
      per_class * n_class != n_trees || depth < 1 || depth > 15 ||
      group_trees <= 0 || (margin == nullptr) == (leaf == nullptr) ||
      (margin != nullptr && init == nullptr))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(threads) * kRowsPerThread;
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  Forest f;
  f.bins = static_cast<const uint8_t*>(bins);
  f.n = n;
  f.used = static_cast<const int32_t*>(used);
  f.n_used = n_used;
  f.quads = (n_used + 3) / 4;
  f.blob = static_cast<const uint8_t*>(blob);
  f.tree_bytes = tree_bytes;
  f.dir_off = dir_off;
  f.rec_off = rec_off;
  f.n_trees = n_trees;
  f.per_class = per_class;
  f.n_class = n_class;
  f.depth = depth;
  f.missing = missing;
  f.miss_bin = miss_bin;
  f.add_zero = add_zero;
  f.group_trees = group_trees;
  f.n_groups = (n_trees + group_trees - 1) / group_trees;
  f.init = static_cast<const float*>(init);
  f.margin = static_cast<float*>(margin);
  f.leaf = static_cast<int32_t*>(leaf);
  void (*kernel)(const Forest) =
      wide ? (missing ? forest_kernel<uint32_t, true>
                      : forest_kernel<uint32_t, false>)
           : (missing ? forest_kernel<uint16_t, true>
                      : forest_kernel<uint16_t, false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<static_cast<int>(blocks), threads, smem, s>>>(f);
  return cudaGetLastError();
}

}  // extern "C"
