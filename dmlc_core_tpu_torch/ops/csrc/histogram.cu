// Gradient-histogram kernels for Hopper (sm_90a), bound through a plain C
// interface (ops/_build.py loads this file's shared library with ctypes).
//
// Replaces three Pallas TPU kernels of dmlc_core_tpu/ops/histogram.py
// (the first two in both of their modes):
//
//   hist        <- _hist_pallas_kernel + _accum_hist (via _hist_pallas):
//                  hist[2, N, S, Bs] = sum of grad (plane 0) and hess
//                  (plane 1) of the rows in each (node, storage feature,
//                  bin); rows with node < 0 add nothing.
//                  dmlc_hist_accum, then dmlc_hist_epilogue.
//   fused_round <- _fused_round_kernel (via fused_round): one tree level —
//                  new_node = 2*node + (bin of feat[node] > thr[node]),
//                  left-child histograms over rows with even new_node,
//                  right = prev - left, children interleaved 2p / 2p+1.
//                  dmlc_descend, dmlc_hist_accum with left_only=1,
//                  dmlc_hist_epilogue with prev.
//   fused_descend <- _fused_kernel (via _fused_pallas /
//                  fused_descend_histogram(fuse=True)): the same descend
//                  and left-child histograms in ONE pass over the bins,
//                  no subtraction — the data-parallel path, where the
//                  left children are summed over ranks before the
//                  parent's subtraction.  dmlc_fused_descend, then
//                  dmlc_hist_epilogue without prev after the caller's
//                  sync of the int64 sums.  The plain [F, n] matrix only
//                  (the TPU kernel has no layout mode).
//
// The input is a physical uint8 matrix [P, n] described by two small
// tables (ops/binlayout.py builds both):
//
//   slots[P, 3]  (storage_lo, storage_hi, runs) per physical row: (a, b) a
//                nibble-packed row feeding storage features a (low nibble)
//                and b (high nibble) — _accum_hist's packed branch,
//                histogram.py:450-462; (s, -1) a row holding storage
//                feature s at the full byte; (-1, -1) a padding row, which
//                writes nothing.  runs: 1 where the row's features are
//                skewed (narrow or bundled), see CellRun.
//   dec[F, kDec] per ORIGINAL feature: its physical row, nibble, bundle
//                segment and compact remap, decoded back to the original
//                bin id before the threshold compare —
//                _fused_round_kernel's with_layout decode,
//                histogram.py:587-602.
//
// Without a layout the matrix is the feature-major [F, n] bin matrix and
// the tables are the identity: slots[f] = (f, -1, 0), dec[f] = (f, -1, 0,
// 0, 0, 0, ...).  One code path serves both modes.
//
// What bounds them on an H100: bytes.  The root histogram reads the bin
// matrix once (P*n bytes) plus node and g/h (12*n bytes) and does a
// handful of integer operations per byte, far below the card's operation
// rate; a fused round adds the descend's node read and new_node write.
//
// Design:
//  * Order-independent accumulation.  The TPU grid runs its row tiles in
//    order into one VMEM block; CUDA blocks run concurrently, and f32
//    atomics would sum in a different order on every run (near-tie splits
//    would flip run to run).  Here every row's g/h is quantised to int64
//    fixed point, q = rint(v * 2^k), with one power-of-two scale per plane
//    chosen by the caller so that n * max|q| < 2^53.  Integer addition is
//    associative, so any order of atomics gives the same bytes, and the
//    sums convert to double exactly; the epilogue rounds once to f32.  On
//    bf16-exact inputs every sum is exact, like the TPU kernel's.
//  * One block per (row chunk, physical row), its shared histogram sized
//    for that row: [2, 2, N, 16] for a packed row (two features of at most
//    16 bins), [2, N, Bs] for a single — never [2, N, S, Bs] (221 KB per
//    node at S = 54, Bs = 256).  Threads stride over the chunk's rows so
//    each warp reads consecutive bytes (8 rows per thread in flight), each
//    64-bit add done as two native 32-bit shared atomics with a carry,
//    then one global int64 atomic per nonzero cell.  Above the
//    shared-memory limit the same kernel adds straight into the global
//    histogram.
//  * Skewed rows (a one-hot column puts ~95% of its rows in one bin): on
//    the physical rows the slot table marks, each thread sums its rows in
//    registers while they hit the same cell and adds the run with one
//    atomic (CellRun); 32 lanes on one shared address otherwise
//    serialise.
//  * The TPU's hi*lo one-hot factorisation, its 16384-row tile and the bf16
//    rounding of g/h are MXU/VMEM artifacts and are not carried over: g/h
//    are read in f32.
//  * The descend takes per-node split tables (feat[node], thr[node]) or
//    per-row arrays; the decode rows are read through the read-only cache
//    (a level touches at most a few of them), so any F works.
//  * fused_descend: bound by bytes too — the bins (F*n), node in (4n),
//    new_node out (4n) and g/h (8n): 44 bytes a row at F = 28, 0.131 ms
//    at 10M rows on 3.35 TB/s.  The fused round's descend launch writes
//    new_node and its accumulation reads it back; here a thread computes
//    its rows' new node in registers (node -> the node's split through
//    the read-only cache -> the selected byte) and the blocks of the
//    first feature group store it.  That chain is three dependent loads
//    a row, so it is paid once per block for a GROUP of features, not
//    once per feature: a block holds the histograms of as many features
//    as fit in shared memory (all 28 at n_prev 1) and reads node and g/h
//    once for all of them.  (A first version, a mode of the accumulation
//    kernel with its one feature per block, repeated the chain 28 times
//    and was slower than the unfused descend + histogram at every level.)
//    The chain's byte gather still repeats once per feature group: from
//    n_prev 8 (7 features per block, 4 groups) the kernel is slower than
//    the fused round (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 8;
// widest storage feature a packed nibble carries (binlayout.PACK_WIDTH)
constexpr int kPackWidth = 16;
// int32 per original feature in the descend's decode table: physical row,
// nibble (-1 byte / 0 low / 1 high), bundled, segment offset, segment
// width, remapped, the 16 entries of the compact remap, and 2 of padding
// (binlayout.DEC_WIDTH: rows 16-byte aligned, read as int4 + int2)
constexpr int kDec = 6 + kPackWidth + 2;

__device__ __forceinline__ unsigned long long quantize(float v, float scale) {
  // v * 2^k is exact in f32; round half to even like torch.round
  return static_cast<unsigned long long>(__float2ll_rn(v * scale));
}

// 64-bit add as two 32-bit shared-memory atomics (the carry of the low
// word goes into the high word): shared-memory 64-bit atomics are slow
// on NVIDIA parts, 32-bit ones are native.  Still exact integer
// arithmetic mod 2^64, so the order of the adds does not matter.
__device__ __forceinline__ void shared_add_u64(unsigned long long* dst,
                                               unsigned long long v) {
  unsigned int* w = reinterpret_cast<unsigned int*>(dst);
  const unsigned int lo = static_cast<unsigned int>(v);
  const unsigned int hi = static_cast<unsigned int>(v >> 32);
  const unsigned int old = atomicAdd(w, lo);
  const unsigned int carry = old > 0xffffffffu - lo ? 1u : 0u;
  atomicAdd(w + 1, hi + carry);
}

// A thread's run of equal cells: it adds its rows' fixed-point values
// into registers while they land in the same cell and flushes the run's
// sum with one atomic when the cell changes.  Integer sums: the result
// does not depend on how the adds are grouped.  Used on the physical rows
// the slot table marks skewed (narrow or bundled features); on a
// feature whose rows spread over its quantile bins every row would start
// a new run, and the bookkeeping costs ~10% (PERF.md).
struct CellRun {
  int cell = -1;
  unsigned long long g = 0ull, h = 0ull;
};

// Where a block's cells go: cell = slot * N * width + node * width + bin
// of the block's [2, slots, N, width] histogram, slot 0 storage feature
// s_lo, slot 1 s_hi.
struct BlockCells {
  int width, per_slot, cells, s_lo, s_hi, n_nodes, n_storage, n_bins;
  long long plane;                     // N * S * Bs: the global hess plane

  __device__ long long global_index(int plane_index, int cell) const {
    const int s = cell / per_slot ? s_hi : s_lo;
    const int v = (cell % per_slot) / width;
    const int bin = cell % width;
    return plane_index * this->plane +
           (static_cast<long long>(v) * n_storage + s) * n_bins + bin;
  }
};

// Flush one run: into the block's shared histogram, or straight into the
// global [2, N, S, Bs] one.
template <bool kShared>
__device__ __forceinline__ void flush_run(CellRun& run, const BlockCells& bc,
                                          unsigned long long* smem,
                                          unsigned long long* out) {
  if (run.cell < 0) return;
  if (kShared) {
    shared_add_u64(&smem[run.cell], run.g);
    shared_add_u64(&smem[bc.cells + run.cell], run.h);
  } else {
    atomicAdd(&out[bc.global_index(0, run.cell)], run.g);
    atomicAdd(&out[bc.global_index(1, run.cell)], run.h);
  }
  run.cell = -1;
}

// One row of a single (slot 0) added at once, without a run.
template <bool kShared>
__device__ __forceinline__ void add_row(int v, int bin, unsigned long long qg,
                                        unsigned long long qh,
                                        const BlockCells& bc,
                                        unsigned long long* smem,
                                        unsigned long long* out) {
  if (kShared) {
    const int c = v * bc.width + bin;
    shared_add_u64(&smem[c], qg);
    shared_add_u64(&smem[bc.cells + c], qh);
  } else {
    const long long c =
        (static_cast<long long>(v) * bc.n_storage + bc.s_lo) * bc.n_bins + bin;
    atomicAdd(&out[c], qg);
    atomicAdd(&out[bc.plane + c], qh);
  }
}

template <bool kShared>
__device__ __forceinline__ void run_add(CellRun& run, int cell,
                                        unsigned long long qg,
                                        unsigned long long qh,
                                        const BlockCells& bc,
                                        unsigned long long* smem,
                                        unsigned long long* out) {
  if (cell != run.cell) {
    flush_run<kShared>(run, bc, smem, out);
    run.cell = cell;
    run.g = 0ull;
    run.h = 0ull;
  }
  run.g += qg;
  run.h += qh;
}

// A block's rows [r0, r1) of one physical row into its histogram.
// kPacked: two nibbles feed slots 0 and 1, each through a run; otherwise
// the whole byte feeds slot 0 (a single, or a feature of the plain
// [F, n] matrix), through a run when kRuns.
template <bool kShared, bool kPacked, bool kRuns>
__device__ __forceinline__ void accumulate_rows(
    const uint8_t* __restrict__ row, const int32_t* __restrict__ node,
    const float* __restrict__ grad, const float* __restrict__ hess,
    long long r0, long long r1, float scale_g, float scale_h, int left_only,
    const BlockCells& bc, unsigned long long* smem,
    unsigned long long* __restrict__ out) {
  CellRun lo_run, hi_run;
  // kUnroll rows per thread per step, all loads issued before any use:
  // one row at a time leaves each thread waiting on one dependent chain
  // of loads, and the loop runs at memory latency, not bandwidth
  const long long step = static_cast<long long>(kUnroll) * blockDim.x;
  for (long long base = r0 + threadIdx.x; base < r1; base += step) {
    int nd[kUnroll], b[kUnroll];
    float gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + static_cast<long long>(u) * blockDim.x;
      const bool in = r < r1;
      nd[u] = in ? node[r] : -1;
      b[u] = in ? row[r] : 0;
      gv[u] = in ? grad[r] : 0.f;
      hv[u] = in ? hess[r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int v = nd[u];
      if (left_only) {      // left children only: even ids -> parent index
        if (v < 0 || (v & 1)) continue;
        v >>= 1;
      } else if (v < 0) {
        continue;
      }
      if (v >= bc.n_nodes) continue;
      const unsigned long long qg = quantize(gv[u], scale_g);
      const unsigned long long qh = quantize(hv[u], scale_h);
      if (kPacked) {        // low nibble -> slot 0, high nibble -> slot 1
        if ((b[u] & 15) < bc.n_bins)
          run_add<kShared>(lo_run, v * bc.width + (b[u] & 15), qg, qh, bc,
                           smem, out);
        if ((b[u] >> 4) < bc.n_bins)
          run_add<kShared>(hi_run, bc.per_slot + v * bc.width + (b[u] >> 4),
                           qg, qh, bc, smem, out);
      } else if (b[u] < bc.n_bins) {
        if (kRuns) {
          run_add<kShared>(lo_run, v * bc.width + b[u], qg, qh, bc, smem,
                           out);
        } else {
          add_row<kShared>(v, b[u], qg, qh, bc, smem, out);
        }
      }
    }
  }
  if (kRuns) flush_run<kShared>(lo_run, bc, smem, out);
  if (kPacked) flush_run<kShared>(hi_run, bc, smem, out);
}

// At most 64 registers, so two 512-thread blocks fit on an SM: the three
// row loops inlined below would otherwise take 84 in the global-atomic
// instantiation, one block per SM, and run 15% slower (PERF.md).
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 2)
hist_accum_kernel(const uint8_t* __restrict__ bins,    // [P, n]
                  const int32_t* __restrict__ node,    // [n]
                  const float* __restrict__ grad,      // [n]
                  const float* __restrict__ hess,      // [n]
                  const int32_t* __restrict__ slots,   // [P, 3]
                  long long n, int n_storage, int n_nodes, int n_bins,
                  float scale_g, float scale_h, int left_only,
                  long long rows_per_chunk,
                  unsigned long long* __restrict__ out) {  // [2, N, S, Bs]
  extern __shared__ unsigned long long smem[];   // [2, slots, N, width]
  const int p = blockIdx.y;
  const int s_lo = slots[3 * p];
  const int s_hi = slots[3 * p + 1];
  const bool runs = slots[3 * p + 2] != 0;
  if (s_lo < 0) return;          // padding row of the packed region
  const bool packed = s_hi >= 0;
  BlockCells bc;
  bc.width = packed ? kPackWidth : n_bins;
  bc.per_slot = n_nodes * bc.width;
  bc.cells = (packed ? 2 : 1) * bc.per_slot;                // per plane
  bc.s_lo = s_lo;
  bc.s_hi = s_hi;
  bc.n_nodes = n_nodes;
  bc.n_storage = n_storage;
  bc.n_bins = n_bins;
  bc.plane = static_cast<long long>(n_nodes) * n_storage * n_bins;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  if (kShared) {
    for (int i = threadIdx.x; i < 2 * bc.cells; i += blockDim.x) smem[i] = 0ull;
    __syncthreads();
  }
  const uint8_t* row = bins + static_cast<long long>(p) * n;
  if (packed) {
    accumulate_rows<kShared, true, true>(row, node, grad, hess, r0, r1,
                                         scale_g, scale_h, left_only, bc,
                                         smem, out);
  } else if (runs) {
    accumulate_rows<kShared, false, true>(row, node, grad, hess, r0, r1,
                                          scale_g, scale_h, left_only, bc,
                                          smem, out);
  } else {
    accumulate_rows<kShared, false, false>(row, node, grad, hess, r0, r1,
                                           scale_g, scale_h, left_only, bc,
                                           smem, out);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * bc.cells; i += blockDim.x) {
      const unsigned long long val = smem[i];
      if (val != 0ull)
        atomicAdd(&out[bc.global_index(i / bc.cells, i % bc.cells)], val);
    }
  }
}

// The fused descend: a block takes the rows [r0, r1) of its chunk and the
// kf features [f0, f0 + nf) of the plain [F, n] matrix.  Per step each
// thread descends kUnroll rows (all loads before any store, so the rows'
// load chains overlap), the first feature group's blocks store new_node,
// and then each feature's byte of those rows goes into the left-child
// histogram [2, kf, N, B] (shared) or straight into the global one.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 2)
fused_descend_kernel(const uint8_t* __restrict__ bins,   // [F, n]
                     const int32_t* __restrict__ node,   // [n]
                     const int32_t* __restrict__ feat,   // [N] or [n]
                     const int32_t* __restrict__ thr,    // [N] or [n]
                     int by_node, const float* __restrict__ grad,
                     const float* __restrict__ hess, long long n,
                     int n_features, int n_prev, int n_bins, float scale_g,
                     float scale_h, int kf, long long rows_per_chunk,
                     unsigned long long* __restrict__ out,  // [2, N, F, B]
                     int32_t* __restrict__ new_node) {      // [n]
  extern __shared__ unsigned long long smem[];   // [2, kf, N, B]
  const int f0 = blockIdx.y * kf;
  const int nf = min(kf, n_features - f0);
  const int per_feat = n_prev * n_bins;
  const int cells = nf * per_feat;                            // per plane
  const long long plane = static_cast<long long>(n_prev) * n_features * n_bins;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  if (kShared) {
    for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) smem[i] = 0ull;
    __syncthreads();
  }
  const bool store = blockIdx.y == 0;
  const long long step = static_cast<long long>(kUnroll) * blockDim.x;
  for (long long base = r0 + threadIdx.x; base < r1; base += step) {
    int v[kUnroll];
    float gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = base + static_cast<long long>(u) * blockDim.x;
      const bool in = r < r1;
      const int parent = in ? node[r] : -1;
      int nn = -1;
      if (parent >= 0) {
        const long long k = by_node ? parent : r;
        const int f = __ldg(feat + k);
        const int t = __ldg(thr + k);
        nn = 2 * parent +
             (__ldg(bins + static_cast<long long>(f) * n + r) > t ? 1 : 0);
      }
      v[u] = nn;
      gv[u] = in ? grad[r] : 0.f;
      hv[u] = in ? hess[r] : 0.f;
    }
    if (store) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = base + static_cast<long long>(u) * blockDim.x;
        if (r < r1) new_node[r] = v[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // left children: parent index
      v[u] = (v[u] >= 0 && !(v[u] & 1) && (v[u] >> 1) < n_prev) ? v[u] >> 1
                                                               : -1;
    }
    for (int j = 0; j < nf; ++j) {
      const uint8_t* row = bins + static_cast<long long>(f0 + j) * n;
      int b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = base + static_cast<long long>(u) * blockDim.x;
        b[u] = r < r1 ? row[r] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v[u] < 0 || b[u] >= n_bins) continue;
        const unsigned long long qg = quantize(gv[u], scale_g);
        const unsigned long long qh = quantize(hv[u], scale_h);
        if (kShared) {
          const int c = j * per_feat + v[u] * n_bins + b[u];
          shared_add_u64(&smem[c], qg);
          shared_add_u64(&smem[cells + c], qh);
        } else {
          const long long c =
              (static_cast<long long>(v[u]) * n_features + f0 + j) * n_bins +
              b[u];
          atomicAdd(&out[c], qg);
          atomicAdd(&out[plane + c], qh);
        }
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) {
      const unsigned long long val = smem[i];
      if (val == 0ull) continue;
      const int c = i % cells;
      const int j = c / per_feat;
      const int rem = c - j * per_feat;
      const int nd = rem / n_bins;
      const int bin = rem - nd * n_bins;
      atomicAdd(&out[(i / cells) * plane +
                     (static_cast<long long>(nd) * n_features + f0 + j) *
                         n_bins + bin], val);
    }
  }
}

// Route rows one level down: the byte of the selected ORIGINAL feature's
// physical row, then nibble, bundle segment and compact remap decoded back
// to the original bin id (binlayout.select_bins), then the threshold
// compare in the original bin space.  One row per thread: at full
// occupancy the chain node -> split table -> decode row -> byte hides its
// latency (the decode rows a level touches stay in L1).
__global__ void descend_kernel(const uint8_t* __restrict__ bins,   // [P, n]
                               const int32_t* __restrict__ node,   // [n]
                               const int32_t* __restrict__ feat,
                               const int32_t* __restrict__ thr,
                               int by_node, long long n,
                               const int32_t* __restrict__ dec,    // [F, kDec]
                               int32_t* __restrict__ new_node) {   // [n]
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    const int nd = node[r];
    int out = -1;
    if (nd >= 0) {
      const long long k = by_node ? nd : r;
      const int32_t* d = dec + static_cast<long long>(feat[k]) * kDec;
      // hd: physical row, nibble, bundled, offset; tl: width, remapped
      const int4 hd = __ldg(reinterpret_cast<const int4*>(d));
      const int2 tl = __ldg(reinterpret_cast<const int2*>(d + 4));
      int v = bins[static_cast<long long>(hd.x) * n + r];
      if (hd.y == 1) {
        v >>= 4;
      } else if (hd.y == 0) {
        v &= 15;
      }
      if (hd.z) {                        // bundle member: segment decode
        const int off = hd.w, wid = tl.x;
        v = (v >= off && v < off + wid - 1) ? v - off + 1 : 0;
      }
      if (tl.y)                          // compact remap
        v = (v >= 0 && v < kPackWidth) ? __ldg(d + 6 + v) : 0;
      out = 2 * nd + (v > thr[k] ? 1 : 0);
    }
    new_node[r] = out;
  }
}

// acc [2, N, S*Bs] int64 -> f32.  Without prev: out [2, N, S*Bs].  With
// prev [2, N, S*Bs]: out [2, 2N, S*Bs], out[:, 2p] = left, out[:, 2p+1] =
// prev - left (f32, as the TPU kernel's sibling subtraction).
__global__ void hist_epilogue_kernel(const long long* __restrict__ acc,
                                     const float* __restrict__ prev,
                                     float* __restrict__ out, int n_nodes,
                                     long long fb, double inv_g,
                                     double inv_h) {
  const long long per_plane = static_cast<long long>(n_nodes) * fb;
  const long long total = 2 * per_plane;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int p = static_cast<int>(i / per_plane);
    // |acc| < 2^53: the conversion to double is exact, the scale a power
    // of two, so the one rounding is the final one to f32
    const float left = __double2float_rn(__ll2double_rn(acc[i]) *
                                         (p ? inv_h : inv_g));
    if (prev == nullptr) {
      out[i] = left;
      continue;
    }
    const long long rem = i - p * per_plane;
    const long long nd = rem / fb;
    const long long j = rem - nd * fb;
    const long long base = (static_cast<long long>(p) * 2 * n_nodes + 2 * nd) * fb + j;
    out[base] = left;
    out[base + fb] = __fsub_rn(prev[i], left);
  }
}

int grid_for(long long work, int threads) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (work + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * 8;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

extern "C" {

// out: zeroed [2, n_nodes, n_storage, n_bins] int64; slots: [n_phys, 3]
// int32 (storage_lo, storage_hi, runs) per physical row of bins
// [n_phys, n].
int dmlc_hist_accum(const void* bins, const void* node, const void* grad,
                    const void* hess, long long n, int n_phys,
                    const void* slots, int n_storage, int n_nodes,
                    int n_bins, float scale_g, float scale_h, int left_only,
                    void* out, void* stream) {
  if (n_phys <= 0 || n_storage <= 0 || n_nodes <= 0 || n_bins <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // about four blocks per SM in all, split over the physical rows
  long long chunks = (4LL * sms + n_phys - 1) / n_phys;
  const long long max_chunks = (n + kThreads - 1) / kThreads;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const long long rows_per_chunk = (n + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(n_phys));
  // the widest block: a packed row's two 16-bin features or a single's
  // n_bins
  const int width = n_bins > 2 * kPackWidth ? n_bins : 2 * kPackWidth;
  const size_t smem = 2ull * n_nodes * width * sizeof(unsigned long long);
  auto* o = static_cast<unsigned long long*>(out);
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* nd = static_cast<const int32_t*>(node);
  const auto* g = static_cast<const float*>(grad);
  const auto* h = static_cast<const float*>(hess);
  const auto* sl = static_cast<const int32_t*>(slots);
  if (smem <= static_cast<size_t>(max_smem)) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_accum_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    hist_accum_kernel<true><<<grid, kThreads, smem, s>>>(
        b, nd, g, h, sl, n, n_storage, n_nodes, n_bins, scale_g, scale_h,
        left_only, rows_per_chunk, o);
  } else {
    hist_accum_kernel<false><<<grid, kThreads, 0, s>>>(
        b, nd, g, h, sl, n, n_storage, n_nodes, n_bins, scale_g, scale_h,
        left_only, rows_per_chunk, o);
  }
  return cudaGetLastError();
}

// The fused descend: new_node[r] = node[r] < 0 ? -1 : 2*node[r] +
// (bins[feat[k], r] > thr[k]), k = node[r] (by_node) or r, and the
// left-child sums of new_node into out, a zeroed [2, n_prev, F, n_bins]
// int64; bins is the plain [F, n] matrix.
int dmlc_fused_descend(const void* bins, const void* node, const void* feat,
                       const void* thr, int by_node, const void* grad,
                       const void* hess, long long n, int n_features,
                       int n_prev, int n_bins, float scale_g, float scale_h,
                       void* out, void* new_node, void* stream) {
  if (n_features <= 0 || n_prev <= 0 || n_bins <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // features per block: two blocks per SM (half the shared memory each)
  // while that holds a quarter of the features, else one block holding
  // as many histograms as fit; where that is fewer than two, the
  // global-atomic instantiation over every feature, so each row descends
  // once per block.  (On 10M x 28 x 256, H100: two blocks were faster at
  // n_prev 2 and 4, one at 8 and 16; at 32 a block of one feature was
  // slower than global atomics over all 28.)
  const size_t per_feat = 2ull * n_prev * n_bins * sizeof(unsigned long long);
  const size_t whole = static_cast<size_t>(max_smem);
  const size_t half = whole / 2;
  const size_t quarter = (static_cast<size_t>(n_features) + 3) / 4;
  const bool shared = 2 * per_feat <= whole;
  const size_t fit = !shared ? n_features
                     : per_feat * quarter <= half ? half / per_feat
                                                  : whole / per_feat;
  const int kf = static_cast<int>(
      fit < static_cast<size_t>(n_features) ? fit : n_features);
  const int groups = (n_features + kf - 1) / kf;
  // about two blocks per SM in all, split over the feature groups
  long long chunks = (2LL * sms + groups - 1) / groups;
  const long long max_chunks = (n + kThreads - 1) / kThreads;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const long long rows_per_chunk = (n + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(groups));
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* nd = static_cast<const int32_t*>(node);
  const auto* f = static_cast<const int32_t*>(feat);
  const auto* t = static_cast<const int32_t*>(thr);
  const auto* g = static_cast<const float*>(grad);
  const auto* h = static_cast<const float*>(hess);
  auto* o = static_cast<unsigned long long*>(out);
  auto* nn = static_cast<int32_t*>(new_node);
  if (shared) {
    const size_t smem = kf * per_feat;
    cudaError_t e = cudaFuncSetAttribute(
        fused_descend_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    fused_descend_kernel<true><<<grid, kThreads, smem, s>>>(
        b, nd, f, t, by_node, g, h, n, n_features, n_prev, n_bins, scale_g,
        scale_h, kf, rows_per_chunk, o, nn);
  } else {
    fused_descend_kernel<false><<<grid, kThreads, 0, s>>>(
        b, nd, f, t, by_node, g, h, n, n_features, n_prev, n_bins, scale_g,
        scale_h, kf, rows_per_chunk, o, nn);
  }
  return cudaGetLastError();
}

// new_node[r] = node[r] < 0 ? -1 : 2*node[r] + (decoded bin > thr[k]),
// k = node[r] (by_node) or r; dec: [F, kDec] int32 decode table.
int dmlc_descend(const void* bins, const void* node, const void* feat,
                 const void* thr, int by_node, long long n, const void* dec,
                 void* new_node, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  descend_kernel<<<grid_for(n, 256), 256, 0, s>>>(
      static_cast<const uint8_t*>(bins), static_cast<const int32_t*>(node),
      static_cast<const int32_t*>(feat), static_cast<const int32_t*>(thr),
      by_node, n, static_cast<const int32_t*>(dec),
      static_cast<int32_t*>(new_node));
  return cudaGetLastError();
}

// prev may be null (root level).
int dmlc_hist_epilogue(const void* acc, const void* prev, void* out,
                       int n_nodes, long long fb, double inv_g, double inv_h,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  hist_epilogue_kernel<<<grid_for(2LL * n_nodes * fb, 256), 256, 0, s>>>(
      static_cast<const long long*>(acc), static_cast<const float*>(prev),
      static_cast<float*>(out), n_nodes, fb, inv_g, inv_h);
  return cudaGetLastError();
}

}  // extern "C"
