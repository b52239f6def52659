// Binned per-threshold counts for the precision-recall curve family.
//
// Replaces: metrics_tpu/ops/binned_hist.py::binned_counts_pallas (Pallas body
// `_kernel`). For each class c and ascending threshold t it returns
//   tp[c, t] = #(valid & target == 1 & score >= thr[t]),
//   fp[c, t] = the same over target == 0,
// and the per-class positive and negative totals, all int32. A NaN score
// meets no threshold, and a NaN threshold (sorted to the end) is met by none.
// Two input modes: (N, C) scores with (N, C) int32 0/1 targets and a bool
// mask; or (N, C) scores with (N,) int32 labels, where target = (label == c)
// and valid = (label >= 0), so a multiclass caller never builds the one-hot.
//
// Bound on the H100: bytes. Each score is read once with its target and mask
// (9 B per element) or with its row's label (4 B + 4 B / C), and needs a few
// compares, far below the card's rate.
//
// Design. The TPU kernel compared every score with every threshold (O(N C T)
// work) and carried accumulators across its sequential grid. Blocks on Hopper
// run in no order, so instead:
//   1. One launch per call. Thread-block clusters of 8 blocks walk the input
//      with 16-byte loads; a thread keeps the next load of each input in
//      flight while it buckets the current one (two or three in flight
//      measured slower: more registers, fewer threads).
//   2. Bucket b = #(thresholds <= score), guessed by interpolation between the
//      first and last threshold (exact up to one step on a linspace grid) and
//      settled with the `thr <= score` predicate against guard values at both
//      ends; a wrong guess falls back to a binary search, so the bucket is
//      exact for any sorted thresholds. The four elements of a load are
//      guessed, then probed, together.
//   3. Each block counts into one (2, C, T + 1) histogram in shared memory
//      with shared atomics. Measured on the H100, a variant that counted
//      nothing took as long as this one, and copies of the histogram (one per
//      warp group, or one per lane, interleaved) made it slower: shared-atomic
//      contention does not bound the kernel, so there is one copy.
//   4. The 8 blocks of a cluster add their histograms through distributed
//      shared memory, each block one eighth of the cells, and store that
//      eighth with plain stores into a (clusters, 2, C, T+1) scratch from
//      torch.empty: no global atomics, nothing to zero but the tickets.
//   5. An atomic ticket per class chunk (after __threadfence) finds the last
//      cluster; its blocks add up the clusters' partial histograms, and one
//      warp per (positive|negative, class) row turns a row into suffix sums:
//      tp/fp and the totals. The tickets are zeroed by a 4-byte-per-chunk
//      memset on the caller's stream before the launch.
//   Where a (2, C, T+1) histogram does not fit a block's shared memory, the
//   classes are tiled over blockIdx.y, and where one class's row does not fit
//   either, the buckets too; thresholds beyond 12K stay in global memory.
// Int32 counts are exact up to 2^31 - 1 rows, which removes the TPU kernel's
// f32 bound of 2^24.
// What still holds it back (H100, cold L2, CUDA events): a call of 1,024 rows
// takes about 0.0145 ms, a trivial kernel 0.0053 ms, so about 0.009 ms of
// every call is the ticket memset, the cluster launch and the tail after the
// histogram; the rest streams at 1.9-2.3 TB/s (binary: 37.7 MB in about
// 0.031 ms). torch.sum over the binary call's scores alone (16.8 MB) takes
// 0.0186 ms the same way.
#include <cooperative_groups.h>
#include <math_constants.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kBlocksPerSm = 2;          // 64 registers a thread
constexpr int kHistBudget = 64 * 1024;   // bytes of histogram per block: two blocks fit an SM
constexpr int kThrInSmem = 12 * 1024;    // thresholds kept in shared memory up to this many
constexpr int kMinUnitsPerThread = 4;    // 16-byte loads per thread before another cluster is added

struct Plan {
  int cc, class_chunks;   // classes per chunk, chunks over blockIdx.y
  int bw, bucket_chunks;  // buckets per chunk (of T + 1), chunks over blockIdx.y
  int clusters_x;         // clusters along x
  int thr_smem;           // thresholds (with guards) in shared memory
  int hist_ints;          // 2 x cc x bw
  size_t smem;
  long long workspace_ints;  // tickets (class_chunks, padded to 4) + partials (clusters_x, 2, C, T + 1)
};

struct Args {
  const float* preds;
  const int32_t* target;  // (N, C) 0/1 targets, or (N,) labels
  const uint8_t* valid;   // (N, C), unused with labels
  const float* thr;
  long long n_rows;
  int num_c, t;
  Plan plan;
  int* tickets;
  int* partial;
  int *tp, *fp, *pos_tot, *neg_tot;
};

// #thresholds <= p: a guess, probed against thr[b - 1] and thr[b]. A wrong
// guess ends in a binary search over what the probes left open.
struct Guess {  // bucket ~ (score - lo) * scale + 1 on an evenly spaced grid
  float lo, scale;
  int t;
  __device__ Guess(const float* thr, int t_) : t(t_) {
    lo = thr[0];
    const float span = thr[t - 1] - lo;
    scale = (t > 1 && span > 0.f && span < CUDART_INF_F) ? static_cast<float>(t - 1) / span : 0.f;
  }
  __device__ __forceinline__ int operator()(float p) const {
    const float g = (p - lo) * scale + 1.0f;
    return g > 0.f ? (g < static_cast<float>(t) ? static_cast<int>(g) : t) : 0;  // NaN -> 0
  }
};

// First b in [lo, hi) with !(thr[b] <= p), else hi.
__device__ __noinline__ int search(float p, const float* thr, int lo, int hi) {
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

// The bucket from its guess b and the thresholds just below and at it (thr[b - 1], thr[b]).
__device__ __forceinline__ int settle(float p, int b, float below_thr, float at_thr, const float* thr, int t) {
  const bool below = !(below_thr <= p);  // the answer is < b
  const bool above = at_thr <= p;        // the answer is > b
  if (!(below || above)) return b;
  return above ? search(p, thr, b + 1, t) : search(p, thr, 0, b - 1);
}

struct Counter {
  int* cells;  // [2][cc][bw]
  int cc, bw, b0;
  __device__ __forceinline__ void add(int b, int y, bool ok, int ci) const {
    const unsigned local = static_cast<unsigned>(b - b0);
    if (!ok || (y != 0 && y != 1) || local >= static_cast<unsigned>(bw)) return;
    atomicAdd(&cells[((1 - y) * cc + ci) * bw + static_cast<int>(local)], 1);
  }
};

template <bool kSmemThr, int kN>
__device__ __forceinline__ void buckets(const float (&p)[kN], int (&b)[kN], const float* ext, const Guess& guess,
                                        const Args& a) {
  float below[kN], at[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) b[j] = guess(p[j]);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if constexpr (kSmemThr) {  // guards at both ends: both probes always load
      below[j] = ext[b[j]];
      at[j] = ext[b[j] + 1];
    } else {
      below[j] = b[j] > 0 ? __ldg(a.thr + b[j] - 1) : -CUDART_INF_F;
      at[j] = b[j] < a.t ? __ldg(a.thr + b[j]) : CUDART_NAN_F;
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) b[j] = settle(p[j], b[j], below[j], at[j], kSmemThr ? ext + 1 : a.thr, a.t);
}

// (row, class-in-chunk) of a flat position, advanced by a fixed stride without division.
struct RowClass {
  long long row;
  int ci;
  __device__ __forceinline__ void advance(long long d_row, int d_ci, int cc) {
    row += d_row;
    ci += d_ci;
    if (ci >= cc) {
      ci -= cc;
      ++row;
    }
  }
};

// Four consecutive elements of the flat (N, C) array and what they are counted with.
struct Unit {
  float4 p;
  int4 y;       // (N, C) mode: targets
  uchar4 v;     // (N, C) mode: validity
  int lab0, lab1;  // labels mode: the labels of the unit's first row and the next
};

template <bool kLabels>
__device__ __forceinline__ void load_unit(Unit& u, long long q, long long row, const Args& a) {
  u.p = __ldcs(reinterpret_cast<const float4*>(a.preds) + q);
  if constexpr (kLabels) {
    u.lab0 = __ldg(a.target + row);
    u.lab1 = row + 1 < a.n_rows ? __ldg(a.target + row + 1) : -1;
  } else {
    u.y = __ldcs(reinterpret_cast<const int4*>(a.target) + q);
    u.v = reinterpret_cast<const uchar4*>(a.valid)[q];
  }
}

template <bool kLabels, bool kVec, bool kSmemThr>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kBlocksPerSm)
    binned_counts_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int s_last;
  const Plan& pl = a.plan;
  const int cchunk = blockIdx.y / pl.bucket_chunks;
  const int bchunk = blockIdx.y - cchunk * pl.bucket_chunks;
  const int c_lo = cchunk * pl.cc;
  const int cc = min(pl.cc, a.num_c - c_lo);
  const int b0 = bchunk * pl.bw;
  const int bw = min(pl.bw, a.t + 1 - b0);

  float* ext = reinterpret_cast<float*>(smem);  // t + 2 floats when kSmemThr
  int* hist = smem + (kSmemThr ? ((a.t + 2 + 3) & ~3) : 0);
  if constexpr (kSmemThr) {
    for (int i = threadIdx.x; i < a.t + 2; i += kThreads) {
      ext[i] = i == 0 ? -CUDART_INF_F : (i <= a.t ? a.thr[i - 1] : CUDART_NAN_F);
    }
  }
  for (int i = threadIdx.x; i < pl.hist_ints; i += kThreads) hist[i] = 0;
  __syncthreads();
  const Guess guess(kSmemThr ? ext + 1 : a.thr, a.t);

  const Counter counter{hist, pl.cc, pl.bw, b0};
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int num_c = a.num_c;

  if constexpr (kVec) {  // cc == num_c: the flat (N, C) array, four elements per 16-byte load
    const long long total = a.n_rows * num_c;
    const long long units = total / 4;
    const long long d_row = (stride * 4) / num_c;
    const int d_ci = static_cast<int>((stride * 4) % num_c);
    RowClass rc{(first * 4) / num_c, static_cast<int>((first * 4) % num_c)};
    Unit cur, nxt;
    if (first < units) load_unit<kLabels>(cur, first, rc.row, a);
    for (long long q = first; q < units; q += stride) {
      RowClass rn = rc;
      rn.advance(d_row, d_ci, num_c);
      if (q + stride < units) load_unit<kLabels>(nxt, q + stride, rn.row, a);  // in flight while this is bucketed
      const float p[4] = {cur.p.x, cur.p.y, cur.p.z, cur.p.w};
      int b[4];
      buckets<kSmemThr>(p, b, ext, guess, a);
      // element k's class: a unit's four classes wrap at most once past num_c, for num_c >= 2 (a unit
      // starts at a multiple of 4, so at class 0 when num_c == 2); with one class it is always 0
      if constexpr (kLabels) {  // num_c >= 2: a unit spans at most two rows
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool wrap = rc.ci + k >= num_c;
          const int ci = wrap ? rc.ci + k - num_c : rc.ci + k;
          const int lab = wrap ? cur.lab1 : cur.lab0;
          counter.add(b[k], lab == ci, lab >= 0, ci);
        }
      } else {
        const int y[4] = {cur.y.x, cur.y.y, cur.y.z, cur.y.w};
        const bool ok[4] = {cur.v.x != 0, cur.v.y != 0, cur.v.z != 0, cur.v.w != 0};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int ci = num_c == 1 ? 0 : (rc.ci + k >= num_c ? rc.ci + k - num_c : rc.ci + k);
          counter.add(b[k], y[k], ok[k], ci);
        }
      }
      rc = rn;
      cur = nxt;
    }
    if (first < total - units * 4) {  // the last total % 4 elements
      const long long el = units * 4 + first;
      const long long row = el / num_c;
      const int ci = static_cast<int>(el - row * num_c);
      const float p[1] = {a.preds[el]};
      int b[1];
      buckets<kSmemThr>(p, b, ext, guess, a);
      if constexpr (kLabels) {
        const int lab = a.target[row];
        counter.add(b[0], lab == ci, lab >= 0, ci);
      } else {
        counter.add(b[0], a.target[el], a.valid[el] != 0, ci);
      }
    }
  } else {  // one element at a time over (rows, classes of this chunk)
    const long long total = a.n_rows * cc;
    RowClass rc{first / cc, static_cast<int>(first % cc)};
    const long long d_row = stride / cc;
    const int d_ci = static_cast<int>(stride % cc);
    for (long long q = first; q < total; q += stride) {
      const long long el = rc.row * num_c + c_lo + rc.ci;
      const float p[1] = {a.preds[el]};
      int b[1];
      buckets<kSmemThr>(p, b, ext, guess, a);
      if constexpr (kLabels) {
        const int lab = a.target[rc.row];
        counter.add(b[0], lab == c_lo + rc.ci, lab >= 0, rc.ci);
      } else {
        counter.add(b[0], a.target[el], a.valid[el] != 0, rc.ci);
      }
      rc.advance(d_row, d_ci, cc);
    }
  }
  // the cluster's eight histograms, one eighth of the cells per block, stored into this cluster's partial
  const int hist_ints = pl.hist_ints;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the cluster has counted
  const int rank = static_cast<int>(cluster.block_rank());
  const int cluster_x = blockIdx.x / kCluster;
  const int per = (hist_ints + kCluster - 1) / kCluster;
  const int cell_end = min(hist_ints, (rank + 1) * per);
  const int plane_cells = pl.cc * pl.bw;
  int* partial = a.partial + static_cast<long long>(cluster_x) * 2 * num_c * (a.t + 1);
  for (int i = rank * per + threadIdx.x; i < cell_end; i += kThreads) {
    int s = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(hist, r)[i];
    const int which = i / plane_cells;
    const int rem = i - which * plane_cells;
    const int ci = rem / pl.bw;
    const int bi = rem - ci * pl.bw;
    if (ci < cc && bi < bw) partial[static_cast<long long>(which * num_c + c_lo + ci) * (a.t + 1) + b0 + bi] = s;
  }
  __threadfence();
  cluster.sync();

  // the last cluster of this class chunk finishes it
  if (rank == 0 && threadIdx.x == 0) {
    const int prev = atomicAdd(a.tickets + cchunk, 1);
    const int last = prev == pl.clusters_x * pl.bucket_chunks - 1;
    for (int r = 0; r < kCluster; ++r) *cluster.map_shared_rank(&s_last, r) = last;
  }
  cluster.sync();
  if (!s_last) return;
  __threadfence();

  // every cluster's partial into cluster 0's: the chunk's cells spread over the cluster's threads, the
  // clusters' loads of a cell issued together
  const int row_cells = a.t + 1;
  const int cells = 2 * cc * row_cells;
  const long long cluster_stride = 2LL * num_c * row_cells;
  for (int i = rank * kThreads + threadIdx.x; i < cells; i += kCluster * kThreads) {
    const int row = i / row_cells;
    const int which = row / cc;
    int* cell = a.partial + static_cast<long long>(which * num_c + c_lo + row - which * cc) * row_cells +
                (i - row * row_cells);
    int s = 0;
    int x = 0;
    for (; x + 8 <= pl.clusters_x; x += 8) {
      int v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __ldcg(cell + (x + j) * cluster_stride);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
    for (; x < pl.clusters_x; ++x) s += __ldcg(cell + x * cluster_stride);
    *cell = s;
  }
  __threadfence();
  cluster.sync();

  // one warp per (positive|negative, class) row: suffix sums of the T + 1 buckets, 32 at a time from the
  // top, the loads of eight such chunks issued together
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = rank * kWarps + warp; row < 2 * cc; row += kCluster * kWarps) {
    const int which = row / cc;
    const int c = c_lo + row - which * cc;
    const int* src = a.partial + static_cast<long long>(which * num_c + c) * row_cells;
    int* out = (which == 0 ? a.tp : a.fp) + static_cast<long long>(c) * a.t;
    int carry = 0;
    for (int top0 = a.t; top0 >= 0; top0 -= 8 * 32) {
      int v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bkt = top0 - 32 * j - lane;  // lane 0 takes the highest bucket of its chunk
        v[j] = bkt >= 0 ? __ldcg(src + bkt) : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bkt = top0 - 32 * j - lane;
        int s = v[j];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(0xffffffffu, s, d);
          if (lane >= d) s += up;
        }
        if (bkt >= 1) out[bkt - 1] = carry + s;  // #(bucket >= bkt): scores that meet threshold bkt - 1
        carry += __shfl_sync(0xffffffffu, s, 31);
      }
    }
    if (lane == 0) (which == 0 ? a.pos_tot : a.neg_tot)[c] = carry;
  }
}

template <bool kLabels, bool kVec, bool kSmemThr>
cudaError_t launch_kernel(const Args& a, cudaStream_t stream) {
  auto kernel = binned_counts_kernel<kLabels, kVec, kSmemThr>;
  if (a.plan.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(a.plan.smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.plan.clusters_x * kCluster, a.plan.class_chunks * a.plan.bucket_chunks);
  kernel<<<grid, kThreads, a.plan.smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t make_plan(long long n_rows, int num_c, int t, Plan* pl) {
  const long long row_bytes = 2LL * (t + 1) * 4;
  Plan p = {};
  if (row_bytes * num_c <= kHistBudget) {
    p.cc = num_c;
    p.bw = t + 1;
  } else if (row_bytes <= kHistBudget) {
    p.cc = static_cast<int>(kHistBudget / row_bytes);
    p.bw = t + 1;
  } else {
    p.cc = 1;
    p.bw = kHistBudget / 8;
  }
  p.class_chunks = (num_c + p.cc - 1) / p.cc;
  p.bucket_chunks = (t + 1 + p.bw - 1) / p.bw;
  p.hist_ints = 2 * p.cc * p.bw;
  p.thr_smem = t <= kThrInSmem;
  p.smem = (p.thr_smem ? 4 * static_cast<size_t>((t + 2 + 3) & ~3) : 0) + 4 * static_cast<size_t>(p.hist_ints);

  // clusters: as many as stay resident, but no more than the work needs
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = p.smem;
  auto probe = binned_counts_kernel<false, true, true>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
  }
  int resident = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&resident, probe, &config);
  if (err != cudaSuccess) return err;
  const long long chunks = static_cast<long long>(p.class_chunks) * p.bucket_chunks;
  long long cap = resident / chunks;
  if (cap < 1) cap = 1;
  const long long units = (n_rows * p.cc + 3) / 4;
  long long want = (units + kCluster * kThreads * kMinUnitsPerThread - 1) / (kCluster * kThreads * kMinUnitsPerThread);
  if (want < 1) want = 1;
  p.clusters_x = static_cast<int>(want < cap ? want : cap);
  p.workspace_ints = ((p.class_chunks + 3) & ~3) + static_cast<long long>(p.clusters_x) * 2 * num_c * (t + 1);
  *pl = p;
  return cudaSuccess;
}

}  // namespace

// The int32 workspace a call with these sizes needs, or -(CUDA error) if the plan failed.
extern "C" long long binned_counts_workspace(long long n_rows, int num_c, int t) {
  Plan p;
  const cudaError_t err = make_plan(n_rows, num_c, t, &p);
  return err == cudaSuccess ? p.workspace_ints : -static_cast<long long>(err);
}

// preds (N, C) f32; with labels == 0, target (N, C) int32 and valid (N, C) bool;
// with labels != 0, target (N,) int32 labels and valid unused. thr (T,) f32
// ascending; all contiguous on one device. workspace: binned_counts_workspace()
// int32s, any contents. Outputs tp, fp (C, T) and pos_tot, neg_tot (C,), int32.
// Returns cudaGetLastError() of the launch.
extern "C" int binned_counts_launch(const float* preds, const int32_t* target, const uint8_t* valid, const float* thr,
                                    long long n_rows, int num_c, int t, int labels, int* workspace,
                                    long long workspace_ints, int* tp, int* fp, int* pos_tot, int* neg_tot,
                                    void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  Args a = {};
  cudaError_t err = make_plan(n_rows, num_c, t, &a.plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (workspace_ints < a.plan.workspace_ints) return static_cast<int>(cudaErrorInvalidValue);
  a.preds = preds;
  a.target = target;
  a.valid = valid;
  a.thr = thr;
  a.n_rows = n_rows;
  a.num_c = num_c;
  a.t = t;
  a.tickets = workspace;
  a.partial = workspace + ((a.plan.class_chunks + 3) & ~3);
  a.tp = tp;
  a.fp = fp;
  a.pos_tot = pos_tot;
  a.neg_tot = neg_tot;
  err = cudaMemsetAsync(a.tickets, 0, sizeof(int) * a.plan.class_chunks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t p_addr = reinterpret_cast<uintptr_t>(preds), y_addr = reinterpret_cast<uintptr_t>(target),
                  v_addr = reinterpret_cast<uintptr_t>(valid);
  const bool vec =
      a.plan.cc == num_c && p_addr % 16 == 0 && (labels ? num_c >= 2 : y_addr % 16 == 0 && v_addr % 4 == 0);
  const bool smem_thr = a.plan.thr_smem != 0;
  if (labels) {
    if (vec) {
      err = smem_thr ? launch_kernel<true, true, true>(a, stream) : launch_kernel<true, true, false>(a, stream);
    } else {
      err = smem_thr ? launch_kernel<true, false, true>(a, stream) : launch_kernel<true, false, false>(a, stream);
    }
  } else {
    if (vec) {
      err = smem_thr ? launch_kernel<false, true, true>(a, stream) : launch_kernel<false, true, false>(a, stream);
    } else {
      err = smem_thr ? launch_kernel<false, false, true>(a, stream) : launch_kernel<false, false, false>(a, stream);
    }
  }
  return static_cast<int>(err);
}
