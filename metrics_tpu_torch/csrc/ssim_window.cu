// Separable VALID windowed sum over image planes, the window pass of 2-D SSIM.
//
// Replaces: metrics_tpu/ops/ssim_window.py::ssim_window_pallas (Pallas body
// `_window_kernel`). Input (N, H + Kh - 1, W + Kw - 1) f32 planes, output
// (N, H, W) f32: Kh vertical taps, then Kw horizontal taps.
//
// Bound on the H100: bytes. Each input element is read once and each output
// written once (8 B per output pixel, about), against 2 (Kh + Kw) flops per
// output: 44 for the default 11-tap gaussian. Every product and sum is rounded
// on its own (__fmul_rn, __fadd_rn) in the order of the plain PyTorch cascade,
// so no fused multiply-add changes the result and the CPU and card results
// stay bit-equal; that is about 45 FP32 instructions per output with the halo.
//
// Design. The TPU kernel held a whole plane in VMEM, one grid step per plane.
// A Hopper block has at most 227 KB of shared memory, so here:
//   * Tiles of 64 x 64 outputs, read as 74 x 74 inputs for 11 taps (1.34x the
//     output's bytes; a 32 x 32 tile reads 1.72x). Shared memory per block is
//     two input buffers, 2 x 74 x 74 floats, and the vertical result stored
//     transposed, 74 x 65 floats: 63 KB, so three blocks fit on an SM.
//   * A persistent grid: three blocks per SM walk the (plane, tile) pairs, so
//     the plane index never rides gridDim.z and any number of planes works.
//   * Overlapped loads: while a block computes one tile, cp.async copies the
//     next tile's inputs into the other buffer. No TMA: a tensor map needs a
//     row pitch that is a multiple of 16 bytes, and the main path's rows are
//     266 floats (1,064 B), so every other row starts only 8-byte aligned.
//     cp.async takes 8-byte copies where the row width is even (every row
//     and the tile's first column, a multiple of 64, are then 8-byte aligned)
//     and 4-byte copies otherwise; the five-plane stack keeps its layout.
//   * Register strips: the tap counts are template parameters (11 x 11, the
//     default gaussian), and a thread owns a strip of 8 (vertical) or 16
//     (horizontal) outputs along the pass's axis. It reads its strip + K - 1
//     inputs from shared memory once, into statically indexed registers, and
//     emits the strip's sums: 2.25 and 1.6 shared reads per output instead of
//     K. The 11-tap instantiation also has its shared-memory pitch as a
//     constant, so the reads take immediate offsets. Other windows, up to 64
//     taps, run the same tiling through a generic instantiation that reads
//     each tap from shared memory.
//   * Conflict-free shared memory: the vertical pass runs its lanes along
//     columns and writes its result transposed with an odd pitch (65), so the
//     horizontal pass runs its lanes along rows; it stages the output tile in
//     the finished input buffer (odd pitch again) and the block writes it out
//     in coalesced rows.
//   * No division by a runtime width per element: each thread's work items
//     are the same for every tile and are walked by increments.
// What still holds it back (H100, 300 planes of 266 x 266): the tile's
// arithmetic alone, with no loads or stores, takes about 0.062 ms and the
// loads and stores alone about 0.070 ms; the two overlap only in part, for
// about 0.107 ms. A third input buffer (two blocks per SM), 32-row tiles,
// 128-column tiles and 128 or 320 threads were no faster.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 64;
constexpr int kTileH = 64;
constexpr int kTileW = 64;
constexpr int kStripV = 8;                  // outputs per thread, vertical pass
constexpr int kStripH = 16;                 // outputs per thread, horizontal pass: 256 items, one round
constexpr int kStripsV = kTileH / kStripV;  // strips per column, vertical pass
constexpr int kStripsH = kTileW / kStripH;  // strips per row, horizontal pass
constexpr int kPitchT = kTileH + 1;         // transposed vertical result, odd pitch
constexpr int kPitchOut = kTileW + 1;       // staged output tile, odd pitch
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;
constexpr int kStages = 2;  // input buffers: tiles in flight while one computes, plus that one

struct Taps {
  float v[kMaxTaps];
  float h[kMaxTaps];
};

struct Shape {
  long long tiles;  // planes x tiles_y x tiles_x
  int hp, wp, h, w, kh, kw;
  int tiles_x, tiles_per_plane;
  int in_h, in_w, in_pitch, buf_floats;
};

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes8) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}
// The input buffer's row pitch: even, so 8-byte copies land 8-byte aligned.
__host__ __device__ constexpr int in_pitch_of(int kw) { return (kTileW + kw - 1 + 1) & ~1; }

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// all but the newest kStages - 1 groups have landed: the oldest tile in flight is complete
__device__ __forceinline__ void cp_async_wait_oldest() { asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1)); }

// Walks the items [start, count) of a (fast, slow) grid with kThreads between
// consecutive items, by increments only.
struct Walk {
  int fast, slow, d_fast, d_slow, width;
  __device__ Walk(int width_, int start) : width(width_) {
    fast = start % width;
    slow = start / width;
    d_fast = kThreads % width;
    d_slow = kThreads / width;
  }
  __device__ __forceinline__ void step(int& f, int& s) const {
    f += d_fast;
    s += d_slow;
    if (f >= width) {
      f -= width;
      ++s;
    }
  }
};

template <bool kPair>
__device__ __forceinline__ void issue_tile_loads(const float* __restrict__ x, const Shape& g, long long tile,
                                                 float* buf, const Walk& walk) {
  const long long plane = tile / g.tiles_per_plane;
  const int rest = static_cast<int>(tile - plane * g.tiles_per_plane);
  const int r0 = (rest / g.tiles_x) * kTileH;
  const int c0 = (rest - (rest / g.tiles_x) * g.tiles_x) * kTileW;
  const int rows = min(g.in_h, g.hp - r0);
  const int cols = min(g.in_w, g.wp - c0);
  const float* src = x + (plane * g.hp + r0) * g.wp + c0;
  constexpr int kPer = kPair ? 2 : 1;
  for (int u = walk.fast, r = walk.slow; r < rows; walk.step(u, r)) {
    const int c = u * kPer;
    if (c < cols) cp_async(buf + r * g.in_pitch + c, src + static_cast<long long>(r) * g.wp + c, kPair);
  }
}

template <int KH, int KW, bool kPair>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    ssim_window_kernel(const float* __restrict__ x, float* __restrict__ out, Shape g, Taps taps) {
  extern __shared__ __align__(16) float smem[];
  float* s_vt = smem + kStages * g.buf_floats;  // in_w x kPitchT: the vertical result, transposed
  const int kh = KH > 0 ? KH : g.kh;
  const int kw = KW > 0 ? KW : g.kw;
  (void)kh;  // read only by the generic instantiation
  (void)kw;
  const int in_pitch = KW > 0 ? in_pitch_of(KW) : g.in_pitch;  // a constant where the taps are: immediate offsets
  constexpr int kPer = kPair ? 2 : 1;

  const Walk load_walk((g.in_w + kPer - 1) / kPer, threadIdx.x);  // (unit in row, row)
  const Walk vert_walk(g.in_w, threadIdx.x);                      // (column, strip)

  // a ring of kStages input buffers: tiles i + 1 .. i + kStages - 1 load while tile i computes
  long long tile = blockIdx.x;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    const long long ahead = tile + static_cast<long long>(k) * gridDim.x;
    if (ahead < g.tiles) issue_tile_loads<kPair>(x, g, ahead, smem + k * g.buf_floats, load_walk);
    cp_async_commit();
  }
  int slot = 0;
  for (; tile < g.tiles; tile += gridDim.x) {
    float* cur = smem + slot * g.buf_floats;
    const int last = slot == 0 ? kStages - 1 : slot - 1;  // the buffer freed by the previous tile
    const long long ahead = tile + static_cast<long long>(kStages - 1) * gridDim.x;
    if (ahead < g.tiles) issue_tile_loads<kPair>(x, g, ahead, smem + last * g.buf_floats, load_walk);
    cp_async_commit();
    cp_async_wait_oldest();  // this thread's copies of the current tile have landed
    __syncthreads();         // and everyone's

    // vertical pass: lanes along columns, a strip of kStripV rows each
    for (int c = vert_walk.fast, s = vert_walk.slow; s < kStripsV; vert_walk.step(c, s)) {
      const float* col = cur + s * kStripV * in_pitch + c;
      float* dst = s_vt + c * kPitchT + s * kStripV;
      if constexpr (KH > 0) {
        float v[kStripV + KH - 1];
#pragma unroll
        for (int j = 0; j < kStripV + KH - 1; ++j) v[j] = col[j * in_pitch];
#pragma unroll
        for (int i = 0; i < kStripV; ++i) {
          float acc = __fmul_rn(v[i], taps.v[0]);
#pragma unroll
          for (int k = 1; k < KH; ++k) acc = __fadd_rn(acc, __fmul_rn(v[i + k], taps.v[k]));
          dst[i] = acc;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kStripV; ++i) {
          const float* p = col + i * in_pitch;
          float acc = __fmul_rn(p[0], taps.v[0]);
          for (int k = 1; k < kh; ++k) acc = __fadd_rn(acc, __fmul_rn(p[k * in_pitch], taps.v[k]));
          dst[i] = acc;
        }
      }
    }
    __syncthreads();

    // horizontal pass: lanes along rows, a strip of kStripH columns each; the
    // result is staged in `cur`, whose inputs are no longer needed
    for (int item = threadIdx.x; item < kTileH * kStripsH; item += kThreads) {
      const int r = item % kTileH;  // constant divisor: a shift
      const int s = item / kTileH;
      const float* row = s_vt + s * kStripH * kPitchT + r;
      float* dst = cur + r * kPitchOut + s * kStripH;
      if constexpr (KW > 0) {
        float v[kStripH + KW - 1];
#pragma unroll
        for (int j = 0; j < kStripH + KW - 1; ++j) v[j] = row[j * kPitchT];
#pragma unroll
        for (int i = 0; i < kStripH; ++i) {
          float acc = __fmul_rn(v[i], taps.h[0]);
#pragma unroll
          for (int k = 1; k < KW; ++k) acc = __fadd_rn(acc, __fmul_rn(v[i + k], taps.h[k]));
          dst[i] = acc;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kStripH; ++i) {
          const float* p = row + i * kPitchT;
          float acc = __fmul_rn(p[0], taps.h[0]);
          for (int k = 1; k < kw; ++k) acc = __fadd_rn(acc, __fmul_rn(p[k * kPitchT], taps.h[k]));
          dst[i] = acc;
        }
      }
    }
    __syncthreads();

    // coalesced stores of the staged tile
    const long long plane = tile / g.tiles_per_plane;
    const int rest = static_cast<int>(tile - plane * g.tiles_per_plane);
    const int r0 = (rest / g.tiles_x) * kTileH;
    const int c0 = (rest - (rest / g.tiles_x) * g.tiles_x) * kTileW;
    const int rows = min(kTileH, g.h - r0);
    const int cols = min(kTileW, g.w - c0);
    float* op = out + (plane * g.h + r0) * g.w + c0;
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int r = i / kTileW;  // constant divisor: a shift
      const int c = i % kTileW;
      if (r < rows && c < cols) op[static_cast<long long>(r) * g.w + c] = cur[r * kPitchOut + c];
    }
    __syncthreads();  // the staged tile is read before the next loads overwrite it
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
}

template <int KH, int KW, bool kPair>
cudaError_t launch(const float* x, float* out, const Shape& g, const Taps& taps, size_t smem, cudaStream_t stream) {
  auto kernel = ssim_window_kernel<KH, KW, kPair>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(g.tiles < cap ? g.tiles : cap);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, g, taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssim_window_max_taps() { return kMaxTaps; }

// x (n, hp, wp) f32 contiguous; out (n, hp - kh + 1, wp - kw + 1) f32 contiguous;
// taps_v/taps_h are host arrays of kh/kw floats. Any n >= 0. Returns cudaGetLastError().
extern "C" int ssim_window_launch(const float* x, float* out, long long n, int hp, int wp, const float* taps_v,
                                  int kh, const float* taps_h, int kw, void* stream_handle) {
  if (kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  Shape g = {};
  g.hp = hp;
  g.wp = wp;
  g.h = hp - kh + 1;
  g.w = wp - kw + 1;
  g.kh = kh;
  g.kw = kw;
  if (n == 0 || g.h <= 0 || g.w <= 0) return static_cast<int>(cudaSuccess);
  Taps taps = {};
  for (int k = 0; k < kh; ++k) taps.v[k] = taps_v[k];
  for (int k = 0; k < kw; ++k) taps.h[k] = taps_h[k];
  g.tiles_x = (g.w + kTileW - 1) / kTileW;
  g.tiles_per_plane = g.tiles_x * ((g.h + kTileH - 1) / kTileH);
  g.tiles = n * g.tiles_per_plane;
  g.in_h = kTileH + kh - 1;
  g.in_w = kTileW + kw - 1;
  g.in_pitch = in_pitch_of(kw);
  g.buf_floats = g.in_h * g.in_pitch > kTileH * kPitchOut ? g.in_h * g.in_pitch : kTileH * kPitchOut;
  g.buf_floats = (g.buf_floats + 3) & ~3;
  const size_t smem =
      sizeof(float) * (kStages * static_cast<size_t>(g.buf_floats) + static_cast<size_t>(g.in_w) * kPitchT);
  const bool pair = wp % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  cudaError_t err;
  if (kh == 11 && kw == 11) {
    err = pair ? launch<11, 11, true>(x, out, g, taps, smem, stream)
               : launch<11, 11, false>(x, out, g, taps, smem, stream);
  } else {
    err = pair ? launch<0, 0, true>(x, out, g, taps, smem, stream) : launch<0, 0, false>(x, out, g, taps, smem, stream);
  }
  return static_cast<int>(err);
}
