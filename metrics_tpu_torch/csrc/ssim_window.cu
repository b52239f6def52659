// Separable VALID windowed sum over image planes, the window pass of 2-D SSIM.
//
// Replaces: metrics_tpu/ops/ssim_window.py::ssim_window_pallas (Pallas body
// `_window_kernel`). Input (N, H + Kh - 1, W + Kw - 1) f32 planes, output
// (N, H, W) f32: Kh vertical taps, then Kw horizontal taps.
//
// Bound on the H100: bytes. Each input element is read once and each output
// written once (8 B per output pixel, about), against 2 (Kh + Kw) flops per
// output: 44 for the default 11-tap gaussian, well under the f32 rate per byte.
//
// Design: the TPU kernel held a whole plane in VMEM, one grid step per plane.
// A Hopper block has at most 227 KB of shared memory, so here one block takes
// one 32 x 32 output tile of one plane: it loads the tile and its K - 1 halo
// into shared memory with coalesced row loads, runs the vertical pass into a
// second shared buffer, then the horizontal pass, and writes the output once.
// The taps travel by value in the kernel's parameters, so launches with
// different windows never share mutable state. Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn) in the order of the plain PyTorch
// cascade, so no fused multiply-add changes the result.
#include "common.cuh"

namespace {

constexpr int kMaxTaps = 64;
constexpr int kTile = 32;
constexpr int kThreads = 256;

struct Taps {
  float v[kMaxTaps];
  float h[kMaxTaps];
};

__global__ void __launch_bounds__(kThreads) ssim_window_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                               int hp, int wp, int h, int w, int kh, int kw,
                                                               Taps taps) {
  extern __shared__ float smem[];
  const int in_w = kTile + kw - 1;
  const int in_h = kTile + kh - 1;
  float* s_in = smem;               // in_h x in_w
  float* s_v = smem + in_h * in_w;  // kTile x in_w
  const long long plane = blockIdx.z;
  const float* xp = x + plane * hp * wp;
  float* op = out + plane * h * w;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;

  for (int i = threadIdx.x; i < in_h * in_w; i += blockDim.x) {
    const int r = r0 + i / in_w;
    const int c = c0 + i % in_w;
    s_in[i] = (r < hp && c < wp) ? xp[static_cast<long long>(r) * wp + c] : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * in_w; i += blockDim.x) {
    const float* col = s_in + i;  // row i / in_w, column i % in_w of the tile
    float acc = __fmul_rn(col[0], taps.v[0]);
    for (int k = 1; k < kh; ++k) acc = __fadd_rn(acc, __fmul_rn(col[k * in_w], taps.v[k]));
    s_v[i] = acc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile;
    const int c = i % kTile;
    if (r0 + r >= h || c0 + c >= w) continue;
    const float* row = s_v + r * in_w + c;
    float acc = __fmul_rn(row[0], taps.h[0]);
    for (int k = 1; k < kw; ++k) acc = __fadd_rn(acc, __fmul_rn(row[k], taps.h[k]));
    op[static_cast<long long>(r0 + r) * w + c0 + c] = acc;
  }
}

}  // namespace

extern "C" int ssim_window_max_taps() { return kMaxTaps; }

// x (n, hp, wp) f32 contiguous; out (n, hp - kh + 1, wp - kw + 1) f32 contiguous;
// taps_v/taps_h are host arrays of kh/kw floats. Returns cudaGetLastError().
extern "C" int ssim_window_launch(const float* x, float* out, int n, int hp, int wp, const float* taps_v, int kh,
                                  const float* taps_h, int kw, void* stream_handle) {
  if (kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  const int h = hp - kh + 1;
  const int w = wp - kw + 1;
  if (n == 0 || h <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  Taps taps = {};
  for (int k = 0; k < kh; ++k) taps.v[k] = taps_v[k];
  for (int k = 0; k < kw; ++k) taps.h[k] = taps_h[k];
  const size_t smem = sizeof(float) * static_cast<size_t>(kTile + kw - 1) * (2 * kTile + kh - 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(ssim_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  ssim_window_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_handle)>>>(x, out, hp, wp, h, w, kh, kw,
                                                                                        taps);
  return static_cast<int>(cudaGetLastError());
}
