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
//    at 10M rows on 3.35 TB/s.  The unfused chain (descend_kernel, then
//    the accumulation over left children) writes new_node and reads it
//    back; the fused descend is the accumulation kernel with a descend
//    prologue (Prologue below): a step's rows are descended in registers
//    (parent -> its split, from a per-node table in shared memory or the
//    per-row arrays -> the selected byte, one 32-bit word for four rows
//    that select the same feature) and their left-child parent ids feed
//    the same grouped digit adds (a kernel of its own, with carry adds,
//    g/h quantised per feature and byte loads, took 0.76-2.58 ms at
//    n_prev 1..16 and lost to the chain from 16; PERF.md).  Two ways to
//    descend a row once per
//    group or less: every feature group's block descends its rows again
//    (the gather's bytes come from L2, as a chunk's groups run side by
//    side; group 0 stores new_node), or a thread-block cluster of a
//    chunk's groups shares each step's descend: each block descends a
//    contiguous 1/c of the step's quads into its shared memory and every
//    block reads the step's ids from its peers (distributed shared
//    memory), so each row's byte is gathered once a cluster.  Measured
//    (PERF.md): the g/h and bin-word loads must not wait for the descend
//    (issued first, for every quad: 0.64 -> 0.57 ms at n_prev 1); a
//    cluster barrier a step kept the 16 warps in lock-step (split into
//    arrive / wait a step apart instead); clusters of 3 to 7 blocks left
//    SMs of a GPC idle and lost to every block descending, pairs gain
//    where the groups are many (n_prev 16: 1.12 -> 1.05 ms).  The host
//    plan (histogram.py, _descend_plan) balances the groups and pairs
//    them where their number is even.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// hist_accum_kernel: threads a block (one block an SM, up to 128
// registers a thread), quads of 4 consecutive rows a thread takes a step,
// physical rows whose bin words are in flight
constexpr int kAccumThreads = 512;
constexpr int kQuads = 2;
constexpr int kDepth = 2;
// quads of one step of a block
constexpr int kStepQuads = kQuads * kAccumThreads;
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

// What the accumulation kernel does before its adds.  kNodeIds: node
// holds the ids of the rows' nodes (with left_only the next level's, of
// which the even ones add at their parent's index).  The fused descend
// (node holds the parents; the rows descend first and their left children
// add at the parent's index): kDescendEach, every block descends the rows
// of its step; kDescendCluster, the blocks of a cluster (a run of a
// chunk's feature groups) share the step's quads, each descending 1/c of
// them into its shared memory, and read the others' from their peers.
enum Prologue { kNodeIds = 0, kDescendEach = 1, kDescendCluster = 2 };

// The fused descend's split tables, per node [N] (by_node) or per row [n],
// in the original feature and bin space of the plain [F, n] matrix, and
// its new_node output [n].
struct Descend {
  const int32_t* feat;
  const int32_t* thr;
  int32_t* new_node;
  int by_node;
};

// new_node of rows r .. r + 3 (those below r1): 2 * parent + (the byte of
// the parent's feature > its threshold), -1 where the parent is < 0 (or,
// with per-node tables, not one of the level's n_prev).  Per-node tables
// are read from shared memory (split), per-row ones as one int4 each where
// aligned.  Where the quad's rows select one feature (every row at n_prev
// 1) their bytes are one 32-bit word, else one byte each through the
// read-only cache.
__device__ __forceinline__ void descend_quad(
    const uint8_t* __restrict__ bins, long long n,
    const int32_t* __restrict__ node, const Descend& d,
    const int2* __restrict__ split, int n_prev, long long r, long long r1,
    bool whole, int (&nn)[4]) {
  int nd[4] = {-1, -1, -1, -1};
  if (whole) {
    const int4 t = *reinterpret_cast<const int4*>(node + r);
    nd[0] = t.x; nd[1] = t.y; nd[2] = t.z; nd[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r + i < r1) nd[i] = node[r + i];
  }
  int f[4] = {0, 0, 0, 0}, t[4] = {0, 0, 0, 0};
  if (d.by_node) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (nd[i] >= n_prev) nd[i] = -1;
      if (nd[i] >= 0) {
        const int2 s = split[nd[i]];
        f[i] = s.x;
        t[i] = s.y;
      }
    }
  } else if (whole) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(d.feat + r));
    const int4 b = __ldg(reinterpret_cast<const int4*>(d.thr + r));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    t[0] = b.x; t[1] = b.y; t[2] = b.z; t[3] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (nd[i] >= 0) {
        f[i] = __ldg(d.feat + r + i);
        t[i] = __ldg(d.thr + r + i);
      }
  }
  int f0 = -1;
  bool same = true;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (nd[i] >= 0) {
      if (f0 < 0) f0 = f[i];
      same &= f[i] == f0;
    }
  uint32_t w = 0u;
  if (f0 >= 0 && same) {
    w = load_quad(bins + static_cast<long long>(f0) * n, r, r1);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (nd[i] >= 0)
        w |= static_cast<uint32_t>(
                 __ldg(bins + static_cast<long long>(f[i]) * n + r + i))
             << (8 * i);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    nn[i] = nd[i] >= 0
                ? 2 * nd[i] + (static_cast<int>((w >> (8 * i)) & 255u) > t[i])
                : -1;
}

__device__ __forceinline__ void store_quad(int32_t* __restrict__ out,
                                           long long r, long long r1,
                                           bool whole, const int (&v)[4]) {
  if (whole) {
    *reinterpret_cast<int4*>(out + r) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r + i < r1) out[r + i] = v[i];
  }
}

// a left child's parent index (its even id >> 1) where it is one of the
// level's n_prev parents, else -1 (right children, rows out of the tree)
__device__ __forceinline__ int left_parent(int id, int n_prev) {
  return (id >= 0 && !(id & 1) && (id >> 1) < n_prev) ? id >> 1 : -1;
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
//
// Under a descend prologue (kMode, the fused descend; node holds the
// parents, n_nodes is n_prev) each quad is descended (descend_quad) and
// its left children's parent ids take the place of the node ids; the
// quads' g/h and first bin words load before it, for every quad.
// kDescendEach: every block descends its own quads, group 0's blocks
// store new_node.  kDescendCluster: block rank k of a cluster of c
// descends the quads [k * share, (k + 1) * share) of each step into the
// step's half of a two-step buffer of ids at the start of its shared
// memory (and, in the first cluster, stores their new_node); each thread
// reads its quads' ids from the rank that descended them.  The cluster
// barrier is split: a thread waits for step s's ids, reads them,
// descends its share of step s + 1 and arrives, so warps run up to a
// step apart and a buffer half is rewritten only after every peer has
// arrived past its reads.  Both read per-node split tables from shared
// memory.
template <bool kShared, int kMode>
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
                  Descend dsc,
                  unsigned long long* __restrict__ out) {  // [2, N, S, Bs]
  // in a cluster the two steps' ids first (at the same offset in every
  // block, where its peers read them); the group's table entries; under a
  // descend prologue the per-node split table (n_nodes int2, 16-byte
  // aligned); then four planes of C words
  extern __shared__ __align__(16) uint32_t smem_words[];
  uint32_t* next = smem_words;
  short4* ids = nullptr;
  int rank = 0, csize = 1;
  bool store = false;
  if constexpr (kMode == kDescendCluster) {
    ids = reinterpret_cast<short4*>(next);
    next += 2 * 2 * kStepQuads;   // two steps of short4
    const cg::cluster_group cl = cg::this_cluster();
    rank = static_cast<int>(cl.block_rank());
    csize = static_cast<int>(cl.num_blocks());
  }
  // quads of a step each block of a cluster descends
  const int share = (kStepQuads + csize - 1) / csize;
  const int4 grp = __ldg(reinterpret_cast<const int4*>(groups) + blockIdx.x);
  const int p0 = grp.x, p1 = grp.y, C = grp.z;
  int4* table = reinterpret_cast<int4*>(next);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x)
    table[p - p0] = __ldg(reinterpret_cast<const int4*>(rows) + p);
  next += 4 * (p1 - p0);
  int2* split = reinterpret_cast<int2*>(next);
  if constexpr (kMode != kNodeIds) {
    if (dsc.by_node)
      for (int i = threadIdx.x; i < n_nodes; i += blockDim.x)
        split[i] = make_int2(__ldg(dsc.feat + i), __ldg(dsc.thr + i));
    next += 2 * ((n_nodes + 1) & ~1);
    // the blocks of group 0, or of the first cluster, store new_node
    store = static_cast<int>(blockIdx.x) < csize;
  }
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  const long long plane = static_cast<long long>(n_nodes) * n_storage * n_bins;
  Sink<kShared> sink;
  if constexpr (kShared) {
    sink.planes = next;
    sink.C = C;
    for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) sink.planes[i] = 0u;
  } else {
    sink = {out, plane, shift};
  }
  __syncthreads();
  const uint32_t lo_mask = (1u << shift) - 1u;
  uintptr_t addr = reinterpret_cast<uintptr_t>(node) |
                   reinterpret_cast<uintptr_t>(grad) |
                   reinterpret_cast<uintptr_t>(hess);
  if constexpr (kMode != kNodeIds) {
    addr |= reinterpret_cast<uintptr_t>(dsc.new_node);
    if (!dsc.by_node)
      addr |= reinterpret_cast<uintptr_t>(dsc.feat) |
              reinterpret_cast<uintptr_t>(dsc.thr);
  }
  const bool vec = (addr & 15) == 0;
  // every thread runs every step (a cluster's barrier needs them all)
  const long long step = 4LL * kStepQuads;
  // kDescendCluster: this block's share of a step's quads, descended into
  // the ids buffer of the step's parity
  auto descend_share = [&](long long s0, int parity) {
    const int q = rank * share + static_cast<int>(threadIdx.x);
    if (static_cast<int>(threadIdx.x) < share && q < kStepQuads) {
      const long long r = s0 + 4LL * q;
      const bool whole = vec && r + 3 < r1;
      int nn[4];
      descend_quad(bins, n, node, dsc, split, n_nodes, r, r1, whole, nn);
      if (store) store_quad(dsc.new_node, r, r1, whole, nn);
      ids[parity * kStepQuads + q] =
          make_short4(static_cast<short>(left_parent(nn[0], n_nodes)),
                      static_cast<short>(left_parent(nn[1], n_nodes)),
                      static_cast<short>(left_parent(nn[2], n_nodes)),
                      static_cast<short>(left_parent(nn[3], n_nodes)));
    }
  };
  if constexpr (kMode == kDescendCluster) {
    // step 0's ids, then the cluster barrier's first arrival: per step a
    // thread waits for the step's ids, reads them, descends the next
    // step's share and arrives, so its warps run up to a step apart
    // instead of in lock-step, and a buffer is written again only after
    // every peer has arrived past its reads
    descend_share(r0, 0);
    __cluster_barrier_arrive();
  }
  int parity = 0;
  for (long long s0 = r0; s0 < r1; s0 += step, parity ^= 1) {
    const long long base = s0 + 4LL * threadIdx.x;
    int v[kQuads][4], slow[kQuads][4];
    Digits dg[kQuads][4];
    float gv[kQuads][4] = {}, hv[kQuads][4] = {};
    // the quads whose g/h and bin words load: those with a row that adds
    bool act[kQuads], on[kQuads];
    bool any = false, any_slow = false;
    uint32_t w[kDepth][kQuads];
    auto load_words = [&](int p, uint32_t (&wp)[kQuads]) {
      const uint8_t* row = bins + static_cast<long long>(p) * n;
#pragma unroll
      for (int u = 0; u < kQuads; ++u)
        wp[u] = on[u] ? load_quad(row, base + 4LL * u * blockDim.x, r1) : 0u;
    };
    // g/h of quad u's rows where keep >= 0
    auto load_gh = [&](int u, const int (&keep)[4]) {
      const long long r = base + 4LL * u * blockDim.x;
      if (vec && r + 3 < r1) {
        const float4 a = *reinterpret_cast<const float4*>(grad + r);
        const float4 b = *reinterpret_cast<const float4*>(hess + r);
        gv[u][0] = a.x; gv[u][1] = a.y; gv[u][2] = a.z; gv[u][3] = a.w;
        hv[u][0] = b.x; hv[u][1] = b.y; hv[u][2] = b.z; hv[u][3] = b.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (keep[i] >= 0) {
            gv[u][i] = grad[r + i];
            hv[u][i] = hess[r + i];
          }
      }
    };
    if constexpr (kMode != kNodeIds) {
      // under a descend prologue the loads that need no node id go first,
      // for every quad in the chunk, so that they do not wait for the
      // descend's gather (below the root a quad where no row adds is rare)
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const long long r = base + 4LL * u * blockDim.x;
        on[u] = r < r1;
        const int in[4] = {r < r1 ? 0 : -1, r + 1 < r1 ? 0 : -1,
                           r + 2 < r1 ? 0 : -1, r + 3 < r1 ? 0 : -1};
        if (on[u]) load_gh(u, in);
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d)
        if (p0 + d < p1) load_words(p0 + d, w[d]);
    }
    short4 peer[kQuads];
    if constexpr (kMode == kDescendCluster) {
      __cluster_barrier_wait();
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int q = static_cast<int>(threadIdx.x) + u * kAccumThreads;
        peer[u] = *cg::this_cluster().map_shared_rank(
            ids + parity * kStepQuads + q, q / share);
      }
      descend_share(s0 + step, parity ^ 1);
      __cluster_barrier_arrive();
    }
#pragma unroll
    for (int u = 0; u < kQuads; ++u) {
      const long long r = base + 4LL * u * blockDim.x;
      const bool whole = vec && r + 3 < r1;
      int nd[4] = {-1, -1, -1, -1};
      if constexpr (kMode == kNodeIds) {
        if (whole) {
          const int4 t = *reinterpret_cast<const int4*>(node + r);
          nd[0] = t.x; nd[1] = t.y; nd[2] = t.z; nd[3] = t.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r + i < r1) nd[i] = node[r + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (left_only) nd[i] = (nd[i] >= 0 && !(nd[i] & 1)) ? nd[i] >> 1 : -1;
          if (nd[i] >= n_nodes) nd[i] = -1;
        }
      } else if constexpr (kMode == kDescendEach) {
        int nn[4];
        descend_quad(bins, n, node, dsc, split, n_nodes, r, r1, whole, nn);
        if (store) store_quad(dsc.new_node, r, r1, whole, nn);
#pragma unroll
        for (int i = 0; i < 4; ++i) nd[i] = left_parent(nn[i], n_nodes);
      } else {
        nd[0] = peer[u].x; nd[1] = peer[u].y; nd[2] = peer[u].z;
        nd[3] = peer[u].w;
      }
      act[u] = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[u][i] = nd[i];
        act[u] |= nd[i] >= 0;
      }
      if constexpr (kMode == kNodeIds) {
        on[u] = act[u];
        if (act[u]) load_gh(u, v[u]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long qg =
            static_cast<long long>(quantize(gv[u][i], scale_g));
        const long long qh =
            static_cast<long long>(quantize(hv[u][i], scale_h));
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
    if constexpr (kMode == kNodeIds) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d)
        if (p0 + d < p1) load_words(p0 + d, w[d]);
    }
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
  // a block's ids stay readable until its peers have read the last step's
  if constexpr (kMode == kDescendCluster) __cluster_barrier_wait();
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

// The plan of one accumulation launch (histogram.py's _accum_plan /
// _descend_plan): the feature groups, row chunks, digit split and each
// block's shared bytes, and the cluster of a descend (blocks a cluster
// along the groups, a divisor of n_groups).
struct Plan {
  const int32_t* rows;
  const int32_t* groups;
  int n_groups, shared, smem, chunks;
  long long rows_per_chunk;
  int shift, qbits, cluster;
};

template <bool kShared, int kMode>
cudaError_t launch_accum(const Plan& pl, cudaStream_t s, const uint8_t* bins,
                         const int32_t* node, const float* g, const float* h,
                         long long n, int n_storage, int n_nodes, int n_bins,
                         float scale_g, float scale_h, int left_only,
                         const Descend& dsc, unsigned long long* out) {
  auto kernel = hist_accum_kernel<kShared, kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pl.n_groups),
                     static_cast<unsigned>(pl.chunks));
  cfg.blockDim = dim3(kAccumThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(pl.smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(pl.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kMode == kDescendCluster ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, bins, node, g, h, pl.rows, pl.groups,
                         n, n_storage, n_nodes, n_bins, scale_g, scale_h,
                         left_only, pl.rows_per_chunk, pl.shift, pl.qbits,
                         dsc, out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool plan_ok(const Plan& pl) {
  return pl.n_groups > 0 && pl.chunks > 0 && pl.smem >= 0 && pl.shift >= 1 &&
         pl.shift <= 31 && pl.qbits >= 1 && pl.qbits <= 62 &&
         pl.rows_per_chunk % 4 == 0 && pl.cluster >= 1 &&
         pl.n_groups % pl.cluster == 0;
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
  const Plan pl = {static_cast<const int32_t*>(rows),
                   static_cast<const int32_t*>(groups), n_groups, shared,
                   smem, chunks, rows_per_chunk, shift, qbits, 1};
  if (!plan_ok(pl) || n_storage <= 0 || n_nodes <= 0 || n_bins <= 0)
    return cudaErrorInvalidValue;
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* nd = static_cast<const int32_t*>(node);
  const auto* g = static_cast<const float*>(grad);
  const auto* h = static_cast<const float*>(hess);
  auto* o = static_cast<unsigned long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Descend none = {nullptr, nullptr, nullptr, 0};
  return shared ? launch_accum<true, kNodeIds>(
                      pl, s, b, nd, g, h, n, n_storage, n_nodes, n_bins,
                      scale_g, scale_h, left_only, none, o)
                : launch_accum<false, kNodeIds>(
                      pl, s, b, nd, g, h, n, n_storage, n_nodes, n_bins,
                      scale_g, scale_h, left_only, none, o);
}

// The fused descend: new_node[r] = node[r] < 0 ? -1 : 2*node[r] +
// (bins[feat[k], r] > thr[k]), k = node[r] (by_node; a parent past the
// n_prev tables stays -1) or r, and the left-child sums of new_node into
// out, a zeroed [2, n_prev, F, n_bins] int64; bins is the plain [F, n]
// matrix.  The plan is histogram.py's _descend_plan (that of
// dmlc_hist_accum, with each block's shared bytes holding the per-node
// split table and, with cluster > 1, the cluster's ids of two steps).
int dmlc_fused_descend(const void* bins, const void* node, const void* feat,
                       const void* thr, int by_node, const void* grad,
                       const void* hess, long long n, const void* rows,
                       const void* groups, int n_groups, int shared, int smem,
                       int chunks, long long rows_per_chunk, int shift,
                       int qbits, int cluster, int n_features, int n_prev,
                       int n_bins, float scale_g, float scale_h, void* out,
                       void* new_node, void* stream) {
  const Plan pl = {static_cast<const int32_t*>(rows),
                   static_cast<const int32_t*>(groups), n_groups, shared,
                   smem, chunks, rows_per_chunk, shift, qbits, cluster};
  if (!plan_ok(pl) || n_features <= 0 || n_prev <= 0 || n_prev > 32767 ||
      n_bins <= 0 || (cluster > 1 && !shared))
    return cudaErrorInvalidValue;
  const Descend dsc = {static_cast<const int32_t*>(feat),
                       static_cast<const int32_t*>(thr),
                       static_cast<int32_t*>(new_node), by_node};
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* nd = static_cast<const int32_t*>(node);
  const auto* g = static_cast<const float*>(grad);
  const auto* h = static_cast<const float*>(hess);
  auto* o = static_cast<unsigned long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shared)
    return launch_accum<false, kDescendEach>(pl, s, b, nd, g, h, n,
                                             n_features, n_prev, n_bins,
                                             scale_g, scale_h, 1, dsc, o);
  if (cluster > 1)
    return launch_accum<true, kDescendCluster>(pl, s, b, nd, g, h, n,
                                               n_features, n_prev, n_bins,
                                               scale_g, scale_h, 1, dsc, o);
  return launch_accum<true, kDescendEach>(pl, s, b, nd, g, h, n, n_features,
                                          n_prev, n_bins, scale_g, scale_h, 1,
                                          dsc, o);
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
