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
// tables (ops/binlayout.py builds both, and from slots the accumulation's
// feature groups, binlayout.hist_groups: per physical row its slot entry
// and first cell in its group's shared histogram, per group its rows
// [p0, p1) and cells):
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
// rate: B1's bound is 0.119 ms at 10M x 28 (400 MB at 3.35 TB/s); a fused
// round adds the descend's node read and new_node write, 0.131 ms at
// n_prev 1 (chip_smoke.py's bounds).
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
//  * The accumulation (hist_accum_kernel: B1, and B2's left children).
//    The first port took one block per (row chunk, physical row) and each
//    64-bit shared add as two 32-bit atomics with a carry: 1.09-1.14 ms at
//    10M x 28 x 256 (PERF.md), 9x its bound.  Measured on the
//    H100 (PERF.md), what held it back, in order: the carry — the
//    high word's add waits for the low word's returned value, so every
//    (row, feature) stalls on a shared atomic's round trip (the same
//    kernel with the returned value unused ran in half the time); node
//    and g/h loaded and quantised again for every feature (13 bytes of
//    loads per one-byte bin); one-byte bin loads; interleaved uint64
//    cells, whose low words meet only the 16 even banks.
//    Now one block per (feature group, row chunk): a group is a run of
//    physical rows whose cells fill a block's shared memory (all 28
//    features at n_prev 1 and 256 bins, 112 KB; three at n_prev 16), so
//    node and g/h are loaded once a group (16 bytes a quad of rows) and
//    quantised once; a chunk's groups are the grid's fast dimension, so
//    they run side by side and their re-reads come from L2.  Bins load as
//    one 32-bit word per 4 rows (shifted from two aligned words where n %
//    4 != 0), two physical rows ahead.  Each q is split into two digits,
//    q = lo + hi * 2^shift (lo unsigned below 2^shift, hi signed): a block
//    of at most 2^(32 - shift) rows, each |q| < 2^qbits with qbits + 2 (32
//    - shift) <= 63, sums each digit in its own 32-bit word without
//    overflow, so every add is a plain atomic whose old value nobody waits
//    for (4 a row and feature).  The planes are separate (g lo, g hi, h
//    lo, h hi), so a warp's adds spread over all 32 banks.  A row whose
//    |q| reaches 2^qbits (scales larger than hist_scales gives) adds its
//    int64 straight into the global histogram, so any scale is exact.
//    A native 64-bit shared atomicAdd compiles to a compare-and-swap loop on
//    sm_90a (ATOMS.CAST.SPIN.64) and ran 1.6x slower at the root.  A node's
//    cells are width + 1 apart, so a skewed row's dominant bin falls in
//    another bank node after node (16 words apart, a packed row's 16 nodes met
//    two banks).  The flush is one global int64 atomic per nonzero cell; at
//    deep levels the row limit multiplies the flushes (79 chunks x 115,136
//    cells at n_prev 16).  Where one physical row's cells exceed the shared
//    memory (n_prev >= 57 at 256 bins) one group of every row adds straight
//    into the global histogram.
//    Grid: one block of 512 threads an SM (up to 128 registers a thread),
//    the fewest groups, and one wave of chunks where the row limit
//    allows; measured (PERF.md): 1024 threads at 64 registers
//    spill and ran 1.3x slower, 256 threads 1.7x, four quads a thread
//    1.4x, and groups capped at 1 to 8 physical rows 1.2-2.5x slower at
//    the root.  The plan is the host's (histogram.py, _accum_plan).
//    Result at 10M x 28 x 256: 0.61 ms (B1, 0.55x the first port) and
//    0.67 ms for the whole fused round at n_prev 1 (0.79x); the
//    accumulation takes about as long when half the rows add, so the
//    work around the adds (loads, digit and cell arithmetic), not the
//    adds, now bounds it.
//  * Skewed rows (a one-hot column puts ~95% of its rows in one bin): on
//    the physical rows the slot table marks, each thread sums its rows in
//    registers while they hit the same cell and adds the run with one
//    atomic (CellRun), and a warp whose runs all end on one cell adds
//    them once; 32 lanes on one shared address otherwise serialise.
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
// hist_accum_kernel: threads a block (one block an SM, up to 128
// registers a thread), quads of 4 consecutive rows a thread takes a step,
// physical rows whose bin words are in flight
constexpr int kAccumThreads = 512;
constexpr int kQuads = 2;
constexpr int kDepth = 2;
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

// ---------------------------------------------------------------------------
// hist_accum_kernel: the root histogram and the fused round's left children
// ---------------------------------------------------------------------------

// A row's g and h in fixed point as two digits each: q = lo + hi * 2^shift
// with lo in [0, 2^shift) and hi = q >> shift (signed).  A block adds at
// most 2^(32 - shift) rows (binlayout.hist_groups' caller sizes the row
// chunks so), every row it takes has |q| < 2^qbits with qbits + 2 (32 -
// shift) <= 63, so a cell's lo digits sum below 2^32 and its hi digits
// within int32: two 32-bit words a value, summed with plain atomic adds
// whose old value nobody waits for, and exact.
struct Digits {
  uint32_t g_lo, g_hi, h_lo, h_hi;
};

__device__ __forceinline__ unsigned long long undigit(uint32_t lo, uint32_t hi,
                                                      int shift) {
  // lo + (int32) hi * 2^shift, mod 2^64
  return static_cast<unsigned long long>(lo) +
         (static_cast<unsigned long long>(
              static_cast<long long>(static_cast<int32_t>(hi)))
          << shift);
}

// One physical row of a group (binlayout.hist_groups): storage features of
// its low / high nibble (-1: a single, or padding), runs, its first cell.
// Its cells are [slot, node, width + 1]: the pad cell a node puts the
// nodes' same bin in different banks (a skewed row's dominant bin,
// node after node).
struct GroupRow {
  int s_lo, s_hi, runs, off;
};

// Where a run or a row's digits go: the block's shared histogram, four
// planes of C 32-bit words (g lo, g hi, h lo, h hi), so that a warp's 32
// adds to 32 cells meet 32 banks; or straight into the global [2, N, S,
// Bs] one as int64.
template <bool kShared>
struct Sink;

template <>
struct Sink<true> {
  typedef int Index;
  uint32_t* planes;
  int C;

  __device__ __forceinline__ void add(Index c, const Digits& d) const {
    atomicAdd(planes + c, d.g_lo);
    atomicAdd(planes + C + c, d.g_hi);
    atomicAdd(planes + 2 * C + c, d.h_lo);
    atomicAdd(planes + 3 * C + c, d.h_hi);
  }
};

template <>
struct Sink<false> {
  typedef long long Index;
  unsigned long long* out;
  long long plane;
  int shift;

  __device__ __forceinline__ void add(Index c, const Digits& d) const {
    atomicAdd(out + c, undigit(d.g_lo, d.g_hi, shift));
    atomicAdd(out + plane + c, undigit(d.h_lo, d.h_hi, shift));
  }
};

// A thread's run of equal cells: it sums its rows' digits in registers
// while they land in the same cell and flushes the run with one add when
// the cell changes.  Integer sums: the result does not depend on how the
// adds are grouped, and a run's digits are part of its cell's sum, which
// stays in range.  Used on the physical rows the slot table marks skewed
// (narrow or bundled features; a one-hot column puts ~95% of its rows in
// one bin, and 32 lanes on one shared address serialise); on a feature
// whose rows spread over its quantile bins every row would start a new
// run, and the bookkeeping costs ~10% (PERF.md).
template <typename Index>
struct CellRun {
  Index cell = -1;
  Digits d = {0u, 0u, 0u, 0u};
};

template <bool kShared>
__device__ __forceinline__ void run_add(
    CellRun<typename Sink<kShared>::Index>& run,
    typename Sink<kShared>::Index cell, const Digits& d,
    const Sink<kShared>& sink) {
  if (cell != run.cell) {
    if (run.cell >= 0) sink.add(run.cell, run.d);
    run.cell = cell;
    run.d = {0u, 0u, 0u, 0u};
  }
  run.d.g_lo += d.g_lo;
  run.d.g_hi += d.g_hi;
  run.d.h_lo += d.h_lo;
  run.d.h_hi += d.h_hi;
}

// A row's last run, added once for the warp where every lane's run ends
// on one cell (a skewed row: most runs end in its dominant bin), else
// lane by lane: 32 adds to one shared address would serialise.  The
// warp's digit sums are part of the cell's, so they stay in range.
template <bool kShared>
__device__ __forceinline__ void flush_run(
    const CellRun<typename Sink<kShared>::Index>& run,
    const Sink<kShared>& sink) {
  const unsigned lanes = __activemask();
  const unsigned with = __ballot_sync(lanes, run.cell >= 0);
  if (with == 0u) return;
  const int first = __ffs(with) - 1;
  const auto c0 = __shfl_sync(lanes, run.cell, first);
  if (__all_sync(lanes, run.cell < 0 || run.cell == c0)) {
    const Digits sum = {__reduce_add_sync(lanes, run.d.g_lo),
                        __reduce_add_sync(lanes, run.d.g_hi),
                        __reduce_add_sync(lanes, run.d.h_lo),
                        __reduce_add_sync(lanes, run.d.h_hi)};
    if (static_cast<int>(threadIdx.x & 31) == first) sink.add(c0, sum);
  } else if (run.cell >= 0) {
    sink.add(run.cell, run.d);
  }
}

// The bytes of rows r .. r + 3 of one physical row (r a multiple of 4)
// in one 32-bit word, row r in the low byte.  Where n % 4 != 0 the row's
// start p * n is not 4-byte aligned: two aligned words, shifted together;
// the second only where it holds a byte of a row below r1.  An aligned
// word that holds one byte of the matrix lies inside its allocation.
__device__ __forceinline__ uint32_t load_quad(const uint8_t* row, long long r,
                                              long long r1) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + r);
  const int off = static_cast<int>(a & 3);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a - off);
  const uint32_t w0 = *w;
  if (off == 0) return w0;
  const uint32_t w1 = r + 4 - off < r1 ? w[1] : 0u;
  return __funnelshift_r(w0, w1, 8 * off);
}

// The adds of one physical row (entry gr) for a thread's kQuads quads:
// their bin words w, parent indices v (-1: adds nothing) and digits.
template <bool kShared>
__device__ __forceinline__ void add_row(
    const GroupRow& gr, const uint32_t (&w)[kQuads], const int (&v)[kQuads][4],
    const Digits (&dg)[kQuads][4], int n_storage, int n_nodes, int n_bins,
    const Sink<kShared>& sink) {
  typedef typename Sink<kShared>::Index Index;
  if (gr.s_lo < 0) return;  // padding row of the packed region
  if (gr.s_hi >= 0) {
    // packed: low nibble -> storage feature s_lo, high -> s_hi, each
    // through a run where runs (the shared cells: [slot, node, 16 bins]
    // from off)
    CellRun<Index> lo_run, hi_run;
#pragma unroll
    for (int u = 0; u < kQuads; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (v[u][i] < 0) continue;
        const int b = (w[u] >> (8 * i)) & 255;
        const int lo = b & 15, hi = b >> 4;
        Index c_lo, c_hi;
        if constexpr (kShared) {
          c_lo = gr.off + v[u][i] * (kPackWidth + 1) + lo;
          c_hi = c_lo + n_nodes * (kPackWidth + 1) + hi - lo;
        } else {
          const long long vs = static_cast<long long>(v[u][i]) * n_storage;
          c_lo = (vs + gr.s_lo) * n_bins + lo;
          c_hi = (vs + gr.s_hi) * n_bins + hi;
        }
        if (gr.runs) {
          if (lo < n_bins) run_add<kShared>(lo_run, c_lo, dg[u][i], sink);
          if (hi < n_bins) run_add<kShared>(hi_run, c_hi, dg[u][i], sink);
        } else {
          if (lo < n_bins) sink.add(c_lo, dg[u][i]);
          if (hi < n_bins) sink.add(c_hi, dg[u][i]);
        }
      }
    flush_run<kShared>(lo_run, sink);
    flush_run<kShared>(hi_run, sink);
    return;
  }
  // a single (or a feature of the plain [F, n] matrix): the whole byte
  CellRun<Index> run;
#pragma unroll
  for (int u = 0; u < kQuads; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = (w[u] >> (8 * i)) & 255;
      if (v[u][i] < 0 || b >= n_bins) continue;
      Index c;
      if constexpr (kShared)
        c = gr.off + v[u][i] * (n_bins + 1) + b;
      else
        c = (static_cast<long long>(v[u][i]) * n_storage + gr.s_lo) * n_bins +
            b;
      if (gr.runs)
        run_add<kShared>(run, c, dg[u][i], sink);
      else
        sink.add(c, dg[u][i]);
    }
  if (gr.runs) flush_run<kShared>(run, sink);
}

// A block takes the rows [r0, r1) of its chunk (r0 a multiple of 4, at
// most 2^(32 - shift) rows) and the physical rows [p0, p1) of its group,
// whose table entries it first copies to shared memory.  Per step each
// thread takes kQuads quads of 4 consecutive rows: it loads their nodes
// (16 bytes a quad), keeps the rows that add (node in [0, N), or with
// left_only an even node at its parent's index), loads g/h (none where
// no row of the quad adds) and splits each into digits ONCE for all of
// the group's physical rows; then for each physical row it adds the 4
// bins of a quad, loaded as one word kDepth physical rows ahead.  A row
// whose |q| reaches 2^qbits (scales not from hist_scales) skips the
// digits and adds its int64 straight into the global histogram.
template <bool kShared>
__global__ void __launch_bounds__(kAccumThreads, 1)
hist_accum_kernel(const uint8_t* __restrict__ bins,    // [P, n]
                  const int32_t* __restrict__ node,    // [n]
                  const float* __restrict__ grad,      // [n]
                  const float* __restrict__ hess,      // [n]
                  const int32_t* __restrict__ rows,    // [P, 4]
                  const int32_t* __restrict__ groups,  // [G, 4]
                  long long n, int n_storage, int n_nodes, int n_bins,
                  float scale_g, float scale_h, int left_only,
                  long long rows_per_chunk, int shift, int qbits,
                  unsigned long long* __restrict__ out) {  // [2, N, S, Bs]
  // the group's table entries, then four planes of C words
  extern __shared__ __align__(16) uint32_t smem_words[];
  const int4 grp = __ldg(reinterpret_cast<const int4*>(groups) + blockIdx.x);
  const int p0 = grp.x, p1 = grp.y, C = grp.z;
  int4* table = reinterpret_cast<int4*>(smem_words);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x)
    table[p - p0] = __ldg(reinterpret_cast<const int4*>(rows) + p);
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  const long long plane = static_cast<long long>(n_nodes) * n_storage * n_bins;
  Sink<kShared> sink;
  if constexpr (kShared) {
    sink.planes = smem_words + 4 * (p1 - p0);
    sink.C = C;
    for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) sink.planes[i] = 0u;
  } else {
    sink = {out, plane, shift};
  }
  __syncthreads();
  const uint32_t lo_mask = (1u << shift) - 1u;
  const bool vec = ((reinterpret_cast<uintptr_t>(node) |
                     reinterpret_cast<uintptr_t>(grad) |
                     reinterpret_cast<uintptr_t>(hess)) & 15) == 0;
  const long long step = 4LL * kQuads * blockDim.x;
  for (long long base = r0 + 4LL * threadIdx.x; base < r1; base += step) {
    int v[kQuads][4], slow[kQuads][4];
    Digits dg[kQuads][4];
    bool act[kQuads];
    bool any = false, any_slow = false;
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const long long r = base + 4LL * u * blockDim.x;
      const bool whole = vec && r + 3 < r1;
      int nd[4] = {-1, -1, -1, -1};
      if (whole) {
        const int4 t = *reinterpret_cast<const int4*>(node + r);
        nd[0] = t.x; nd[1] = t.y; nd[2] = t.z; nd[3] = t.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (r + i < r1) nd[i] = node[r + i];
      }
      act[u] = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int x = nd[i];
        if (left_only) x = (x >= 0 && !(x & 1)) ? x >> 1 : -1;
        if (x >= n_nodes) x = -1;
        v[u][i] = x;
        act[u] |= x >= 0;
      }
      float gv[4] = {0.f, 0.f, 0.f, 0.f}, hv[4] = {0.f, 0.f, 0.f, 0.f};
      if (act[u]) {
        if (whole) {
          const float4 a = *reinterpret_cast<const float4*>(grad + r);
          const float4 b = *reinterpret_cast<const float4*>(hess + r);
          gv[0] = a.x; gv[1] = a.y; gv[2] = a.z; gv[3] = a.w;
          hv[0] = b.x; hv[1] = b.y; hv[2] = b.z; hv[3] = b.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (v[u][i] >= 0) {
              gv[i] = grad[r + i];
              hv[i] = hess[r + i];
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long qg = static_cast<long long>(quantize(gv[i], scale_g));
        const long long qh = static_cast<long long>(quantize(hv[i], scale_h));
        // |q| < 2^qbits, as an unsigned compare of q + 2^qbits
        const unsigned long long lim = 1ull << qbits;
        slow[u][i] = v[u][i];
        if (static_cast<unsigned long long>(qg) + lim < 2 * lim &&
            static_cast<unsigned long long>(qh) + lim < 2 * lim) {
          slow[u][i] = -1;
        } else {
          v[u][i] = -1;
          any_slow |= slow[u][i] >= 0;
        }
        dg[u][i] = {static_cast<uint32_t>(qg) & lo_mask,
                    static_cast<uint32_t>(qg >> shift),
                    static_cast<uint32_t>(qh) & lo_mask,
                    static_cast<uint32_t>(qh >> shift)};
      }
      any |= act[u];
    }
    if (!any) continue;

    // kDepth physical rows' bin words in flight
    auto load_words = [&](int p, uint32_t (&w)[kQuads]) {
      const uint8_t* row = bins + static_cast<long long>(p) * n;
#pragma unroll
      for (int u = 0; u < kQuads; ++u)
        w[u] = act[u] ? load_quad(row, base + 4LL * u * blockDim.x, r1) : 0u;
    };
    uint32_t w[kDepth][kQuads];
#pragma unroll
    for (int d = 0; d < kDepth; ++d)
      if (p0 + d < p1) load_words(p0 + d, w[d]);
    for (int p = p0; p < p1; p += kDepth) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (p + d < p1) {
          const int4 e = table[p + d - p0];
          add_row<kShared>({e.x, e.y, e.z, e.w}, w[d], v, dg, n_storage,
                           n_nodes, n_bins, sink);
          if (p + d + kDepth < p1) load_words(p + d + kDepth, w[d]);
        }
      }
    }
    if (any_slow) {
      // rows beyond the digits' range: their full int64, straight into
      // the global histogram
      Digits full[kQuads][4];
#pragma unroll
      for (int u = 0; u < kQuads; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (slow[u][i] < 0) continue;
          const long long r = base + 4LL * u * blockDim.x + i;
          const unsigned long long qg = quantize(grad[r], scale_g);
          const unsigned long long qh = quantize(hess[r], scale_h);
          full[u][i] = {static_cast<uint32_t>(qg),
                        static_cast<uint32_t>(qg >> 32),
                        static_cast<uint32_t>(qh),
                        static_cast<uint32_t>(qh >> 32)};
        }
      // (whole 32-bit words, so no runs: their sums would carry)
      const Sink<false> wide{out, plane, 32};
      for (int p = p0; p < p1; ++p) {
        uint32_t ws[kQuads];
        load_words(p, ws);
        const int4 e = table[p - p0];
        add_row<false>({e.x, e.y, 0, e.w}, ws, slow, full, n_storage,
                       n_nodes, n_bins, wide);
      }
    }
  }
  if constexpr (kShared) {
    // one global int64 atomic per nonzero cell, row by row of the group
    __syncthreads();
    const uint32_t* pl = sink.planes;
    for (int p = p0; p < p1; ++p) {
      const int4 e = table[p - p0];
      if (e.x < 0) continue;
      const int width = e.y >= 0 ? kPackWidth : n_bins;
      const int slot_cells = n_nodes * (width + 1);
      const int cells = (e.y >= 0 ? 2 : 1) * slot_cells;
      for (int c = threadIdx.x; c < cells; c += blockDim.x) {
        const int sc = e.w + c;
        const unsigned long long g = undigit(pl[sc], pl[C + sc], shift);
        const unsigned long long h =
            undigit(pl[2 * C + sc], pl[3 * C + sc], shift);
        if ((g | h) == 0ull) continue;
        const int slot = c >= slot_cells;
        const int rem = c - slot * slot_cells;
        const int nd = rem / (width + 1);
        const int bin = rem - nd * (width + 1);  // < width: nothing adds
                                                 // to the pad cell
        const long long idx =
            (static_cast<long long>(nd) * n_storage + (slot ? e.y : e.x)) *
                n_bins + bin;
        if (g) atomicAdd(out + idx, g);
        if (h) atomicAdd(out + plane + idx, h);
      }
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

// out: int32[4], this card's SMs, shared memory a block may opt in to,
// shared memory of an SM, and what the system reserves of it per block:
// the host sizes the accumulation's feature groups by them.
int dmlc_device_limits(void* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* o = static_cast<int*>(out);
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 4; ++i) {
    e = cudaDeviceGetAttribute(o + i, attrs[i], dev);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// out: zeroed [2, n_nodes, n_storage, n_bins] int64; rows [n_phys, 4] and
// groups [n_groups, 4] int32, the feature groups of binlayout.hist_groups;
// a block per (group, row chunk of rows_per_chunk rows, a multiple of 4),
// smem bytes each (the group's table entries, then its cells; shared 0:
// the global-atomic instantiation); digits split at shift, rows with
// |q| >= 2^qbits added whole (histogram.py's _accum_plan).
int dmlc_hist_accum(const void* bins, const void* node, const void* grad,
                    const void* hess, long long n, const void* rows,
                    const void* groups, int n_groups, int shared, int smem,
                    int chunks, long long rows_per_chunk, int shift,
                    int qbits, int n_storage, int n_nodes, int n_bins,
                    float scale_g, float scale_h, int left_only, void* out,
                    void* stream) {
  if (n_groups <= 0 || chunks <= 0 || n_storage <= 0 || n_nodes <= 0 ||
      n_bins <= 0 || smem < 0 || shift < 1 || shift > 31 || qbits < 1 ||
      qbits > 62 || rows_per_chunk % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_groups),
                  static_cast<unsigned>(chunks));
  auto* o = static_cast<unsigned long long*>(out);
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* nd = static_cast<const int32_t*>(node);
  const auto* g = static_cast<const float*>(grad);
  const auto* h = static_cast<const float*>(hess);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* gr = static_cast<const int32_t*>(groups);
  auto kernel = shared ? hist_accum_kernel<true> : hist_accum_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kAccumThreads, smem, s>>>(
      b, nd, g, h, r, gr, n, n_storage, n_nodes, n_bins, scale_g, scale_h,
      left_only, rows_per_chunk, shift, qbits, o);
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
