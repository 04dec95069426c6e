// Gradient-histogram kernels for Hopper (sm_90a), bound through a plain C
// interface (ops/_build.py loads this file's shared library with ctypes).
//
// Replaces two Pallas TPU kernels of dmlc_core_tpu/ops/histogram.py:
//
//   hist        <- _hist_pallas_kernel + _accum_hist (via _hist_pallas):
//                  hist[2, N, F, B] = sum of grad (plane 0) and hess
//                  (plane 1) of the rows in each (node, feature, bin);
//                  rows with node < 0 add nothing.
//   fused_round <- _fused_round_kernel (via fused_round): one tree level —
//                  new_node = 2*node + (bins[feat[node], r] > thr[node]),
//                  left-child histograms over rows with even new_node,
//                  right = prev - left, children interleaved 2p / 2p+1.
//                  Three launches: dmlc_descend, dmlc_hist_accum with
//                  left_only=1, dmlc_hist_epilogue with prev.
//
// What bounds them on an H100: bytes.  The root histogram reads the
// feature-major uint8 bin matrix once (F*n bytes) plus node and g/h
// (12*n bytes) and does a handful of integer operations per byte, far
// below the card's operation rate; a fused round adds the descend's
// node read and new_node write.
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
//  * One block per (row chunk, feature): a [2, N, B] int64 histogram in
//    dynamic shared memory (8 KB at N = 1, 64 KB at N = 16 with B = 256),
//    threads striding over the chunk's rows so each warp reads consecutive
//    bytes of the feature's row (8 rows per thread in flight at a time),
//    each 64-bit add done as two native 32-bit
//    shared atomics with a carry, then one global int64 atomic per nonzero
//    cell.  Above the shared-memory limit the same kernel adds straight
//    into the global histogram.
//  * The TPU's hi*lo one-hot factorisation, its 16384-row tile and the bf16
//    rounding of g/h are MXU/VMEM artifacts and are not carried over: g/h
//    are read in f32.
//  * The descend takes per-node split tables (feat[node], thr[node]) or
//    per-row arrays; bins[feat, r] is a gather across the rows of the
//    [F, n] matrix, one byte per row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 8;

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

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
hist_accum_kernel(const uint8_t* __restrict__ bins,     // [F, n]
                  const int32_t* __restrict__ node,     // [n]
                  const float* __restrict__ grad,       // [n]
                  const float* __restrict__ hess,       // [n]
                  long long n, int n_features, int n_nodes, int n_bins,
                  float scale_g, float scale_h, int left_only,
                  long long rows_per_chunk,
                  unsigned long long* __restrict__ out) {  // [2, N, F, B]
  extern __shared__ unsigned long long smem[];           // [2, N, B]
  const int f = blockIdx.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  const int cells = n_nodes * n_bins;
  if (kShared) {
    for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) smem[i] = 0ull;
    __syncthreads();
  }
  const uint8_t* row = bins + static_cast<long long>(f) * n;
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
      if (v >= n_nodes || b[u] >= n_bins) continue;
      const unsigned long long qg = quantize(gv[u], scale_g);
      const unsigned long long qh = quantize(hv[u], scale_h);
      if (kShared) {
        const int c = v * n_bins + b[u];
        shared_add_u64(&smem[c], qg);
        shared_add_u64(&smem[cells + c], qh);
      } else {
        const long long c =
            (static_cast<long long>(v) * n_features + f) * n_bins + b[u];
        const long long plane = static_cast<long long>(cells) * n_features;
        atomicAdd(&out[c], qg);
        atomicAdd(&out[plane + c], qh);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) {
      const unsigned long long v = smem[i];
      if (v == 0ull) continue;
      const int p = i / cells;
      const int nd = (i % cells) / n_bins;
      const int b = i % n_bins;
      atomicAdd(&out[((static_cast<long long>(p) * n_nodes + nd) * n_features +
                      f) * n_bins + b],
                v);
    }
  }
}

__global__ void descend_kernel(const uint8_t* __restrict__ bins,   // [F, n]
                               const int32_t* __restrict__ node,   // [n]
                               const int32_t* __restrict__ feat,
                               const int32_t* __restrict__ thr,
                               int by_node, long long n,
                               int32_t* __restrict__ new_node) {    // [n]
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    const int nd = node[r];
    int out = -1;
    if (nd >= 0) {
      const long long k = by_node ? nd : r;
      const int b = bins[static_cast<long long>(feat[k]) * n + r];
      out = 2 * nd + (b > thr[k] ? 1 : 0);
    }
    new_node[r] = out;
  }
}

// acc [2, N, F*B] int64 -> f32.  Without prev: out [2, N, F*B].  With
// prev [2, N, F*B]: out [2, 2N, F*B], out[:, 2p] = left, out[:, 2p+1] =
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

// out: zeroed [2, n_nodes, n_features, n_bins] int64.
int dmlc_hist_accum(const void* bins, const void* node, const void* grad,
                    const void* hess, long long n, int n_features,
                    int n_nodes, int n_bins, float scale_g, float scale_h,
                    int left_only, void* out, void* stream) {
  if (n_features <= 0 || n_nodes <= 0 || n_bins <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // about four blocks per SM in all, split over the features' rows
  long long chunks = (4LL * sms + n_features - 1) / n_features;
  const long long max_chunks = (n + kThreads - 1) / kThreads;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const long long rows_per_chunk = (n + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(n_features));
  const size_t smem = 2ull * n_nodes * n_bins * sizeof(unsigned long long);
  auto* o = static_cast<unsigned long long*>(out);
  const auto* b = static_cast<const uint8_t*>(bins);
  const auto* nd = static_cast<const int32_t*>(node);
  const auto* g = static_cast<const float*>(grad);
  const auto* h = static_cast<const float*>(hess);
  if (smem <= static_cast<size_t>(max_smem)) {
    cudaError_t e = cudaFuncSetAttribute(
        hist_accum_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    hist_accum_kernel<true><<<grid, kThreads, smem, s>>>(
        b, nd, g, h, n, n_features, n_nodes, n_bins, scale_g, scale_h,
        left_only, rows_per_chunk, o);
  } else {
    hist_accum_kernel<false><<<grid, kThreads, 0, s>>>(
        b, nd, g, h, n, n_features, n_nodes, n_bins, scale_g, scale_h,
        left_only, rows_per_chunk, o);
  }
  return cudaGetLastError();
}

// new_node[r] = node[r] < 0 ? -1 : 2*node[r] + (bins[feat[k], r] > thr[k]),
// k = node[r] (by_node) or r.
int dmlc_descend(const void* bins, const void* node, const void* feat,
                 const void* thr, int by_node, long long n, void* new_node,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  descend_kernel<<<grid_for(n, 256), 256, 0, s>>>(
      static_cast<const uint8_t*>(bins), static_cast<const int32_t*>(node),
      static_cast<const int32_t*>(feat), static_cast<const int32_t*>(thr),
      by_node, n, static_cast<int32_t*>(new_node));
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
