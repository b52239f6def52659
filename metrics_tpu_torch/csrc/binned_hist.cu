// Binned per-threshold counts for the precision-recall curve family.
//
// Replaces: metrics_tpu/ops/binned_hist.py::binned_counts_pallas (Pallas body
// `_kernel`). For each class c and ascending threshold t it returns
//   tp[c, t] = #(valid & target == 1 & score >= thr[t]),
//   fp[c, t] = the same over target == 0,
// and the per-class positive and negative totals, all int32. A NaN score
// meets no threshold, and a NaN threshold (sorted to the end) is met by none.
//
// Bound on the H100: bytes. Each (N, C) element is read once (4 B score, 4 B
// target, 1 B mask) and needs about log2(T + 1) compares, far below the card's
// rate, so the floor is 9 B x N x C over 3.35 TB/s.
//
// Design: the TPU kernel compared every score with every threshold (O(N C T)
// work) and carried accumulators across its sequential grid. Blocks on Hopper
// run in no order, so instead:
//   1. each block copies the thresholds into shared memory and clears a
//      shared int32 histogram of shape (2, C, T + 1);
//   2. each thread reads four elements at a time (16-byte loads where the
//      inputs are aligned), binary-searches each score into a bucket
//      (#thresholds <= score) and adds one to its (class, bucket) cell with a
//      shared atomic: O(N C log T) work. The class of an element is tracked
//      by increments, with no integer division in the loop;
//   3. each block adds its non-zero cells to one global histogram;
//   4. a second small kernel, one warp per (positive|negative, class), turns
//      each histogram row into suffix sums with warp scans: the tp/fp rows and
//      the totals.
// Int32 counts are exact up to 2^31 - 1 rows, which removes the TPU kernel's
// f32 bound of 2^24. Where the shared histogram does not fit one block's shared
// memory, the same kernel adds straight into the global histogram.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// #thresholds <= p over an ascending array; NaN thresholds at the end compare false.
__device__ __forceinline__ int bucket_of(float p, const float* thr, int t) {
  if (isnan(p)) return 0;
  int lo = 0, hi = t;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (thr[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct Histogram {
  const float* thr;
  int* cells;  // [0, C (T+1)) positives, [C (T+1), 2 C (T+1)) negatives
  int t;
  int bins;

  __device__ __forceinline__ void add(float p, int y, bool ok, int c) const {
    if (!ok || (y != 0 && y != 1)) return;
    atomicAdd(&cells[(1 - y) * bins + c * (t + 1) + bucket_of(p, thr, t)], 1);
  }
};

__device__ __forceinline__ int next_class(int c, int num_c) { return c + 1 == num_c ? 0 : c + 1; }

template <bool kShared, bool kVec>
__global__ void __launch_bounds__(kThreads) binned_hist_kernel(const float* __restrict__ preds,
                                                               const int32_t* __restrict__ target,
                                                               const uint8_t* __restrict__ valid,
                                                               const float* __restrict__ thr, long long total,
                                                               int num_c, int t, int* __restrict__ hist) {
  extern __shared__ int smem[];
  Histogram hg{thr, hist, t, num_c * (t + 1)};
  if constexpr (kShared) {
    float* s_thr = reinterpret_cast<float*>(smem);
    int* s_hist = smem + t;
    for (int i = threadIdx.x; i < t; i += blockDim.x) s_thr[i] = thr[i];
    for (int i = threadIdx.x; i < 2 * hg.bins; i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    hg.thr = s_thr;
    hg.cells = s_hist;
  }
  constexpr int kPer = kVec ? 4 : 1;
  const long long items = total / kPer;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int c = static_cast<int>((first * kPer) % num_c);  // class of the item's first element
  const int c_step = static_cast<int>((stride * kPer) % num_c);
  for (long long q = first; q < items; q += stride) {
    if constexpr (kVec) {
      const float4 p = reinterpret_cast<const float4*>(preds)[q];
      const int4 y = reinterpret_cast<const int4*>(target)[q];
      const uchar4 ok = reinterpret_cast<const uchar4*>(valid)[q];
      int cc = c;
      hg.add(p.x, y.x, ok.x, cc);
      cc = next_class(cc, num_c);
      hg.add(p.y, y.y, ok.y, cc);
      cc = next_class(cc, num_c);
      hg.add(p.z, y.z, ok.z, cc);
      cc = next_class(cc, num_c);
      hg.add(p.w, y.w, ok.w, cc);
    } else {
      hg.add(preds[q], target[q], valid[q], c);
    }
    c += c_step;
    if (c >= num_c) c -= num_c;
  }
  if (kVec && first < total - items * kPer) {  // the last total % 4 elements
    const long long e = items * kPer + first;
    hg.add(preds[e], target[e], valid[e], static_cast<int>(e % num_c));
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * hg.bins; i += blockDim.x) {
      const int v = hg.cells[i];
      if (v != 0) atomicAdd(&hist[i], v);
    }
  }
}

// One warp per (positive|negative, class): suffix sums of the row's T + 1
// buckets, 32 buckets at a time from the top, with an inclusive warp scan.
__global__ void binned_finalize_kernel(const int* __restrict__ hist, int num_c, int t, int* __restrict__ tp,
                                       int* __restrict__ fp, int* __restrict__ pos_tot, int* __restrict__ neg_tot) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 2 * num_c) return;
  const int which = warp / num_c;
  const int c = warp % num_c;
  const int* row = hist + static_cast<long long>(warp) * (t + 1);
  int* out = (which == 0 ? tp : fp) + static_cast<long long>(c) * t;
  int carry = 0;
  for (int top = t; top >= 0; top -= 32) {
    const int b = top - lane;  // lane 0 takes the highest bucket of this chunk
    int s = b >= 0 ? row[b] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += up;
    }
    if (b >= 1) out[b - 1] = carry + s;  // #(bucket >= b): scores that meet threshold b - 1
    carry += __shfl_sync(0xffffffffu, s, 31);
  }
  if (lane == 0) (which == 0 ? pos_tot : neg_tot)[c] = carry;
}

template <bool kVec>
cudaError_t launch_hist(const float* preds, const int32_t* target, const uint8_t* valid, const float* thr,
                        long long total, int num_c, int t, int* hist, cudaStream_t stream) {
  int device = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const size_t smem = sizeof(float) * static_cast<size_t>(t) + sizeof(int) * 2 * static_cast<size_t>(num_c) * (t + 1);
  const long long want = (total / (kVec ? 4 : 1) + kThreads - 1) / kThreads;
  if (smem <= static_cast<size_t>(max_smem)) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(binned_hist_kernel<true, kVec>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, binned_hist_kernel<true, kVec>, kThreads, smem);
    const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
    binned_hist_kernel<true, kVec><<<grid, kThreads, smem, stream>>>(preds, target, valid, thr, total, num_c, t, hist);
  } else {
    const long long cap = static_cast<long long>(sms) * 8;
    const int grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
    binned_hist_kernel<false, kVec><<<grid, kThreads, 0, stream>>>(preds, target, valid, thr, total, num_c, t, hist);
  }
  return cudaGetLastError();
}

}  // namespace

// preds (N, C) f32, target (N, C) int32, valid (N, C) bool, thr (T,) f32 ascending,
// all contiguous on one device. hist (2, C, T + 1) int32 must be zeroed by the caller.
// Outputs tp, fp (C, T) and pos_tot, neg_tot (C,), int32. Returns cudaGetLastError().
extern "C" int binned_counts_launch(const float* preds, const int32_t* target, const uint8_t* valid, const float* thr,
                                    long long n_rows, int num_c, int t, int* hist, int* tp, int* fp, int* pos_tot,
                                    int* neg_tot, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const long long total = n_rows * num_c;
  if (total > 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(preds) | reinterpret_cast<uintptr_t>(target)) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(valid) % 4 == 0;
    const cudaError_t err = aligned ? launch_hist<true>(preds, target, valid, thr, total, num_c, t, hist, stream)
                                    : launch_hist<false>(preds, target, valid, thr, total, num_c, t, hist, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 128;  // four warps, one (positive|negative, class) row each
  const int rows = 2 * num_c;
  binned_finalize_kernel<<<(rows + 3) / 4, threads, 0, stream>>>(hist, num_c, t, tp, fp, pos_tot, neg_tot);
  return static_cast<int>(cudaGetLastError());
}
