// B5: bilinear warp along a per-sample pixel-space affine, zero padding.
//
//   fx = ax * i + bx * j + cx,   fy = ay * i + by * j + cy
//   y[n, c, j, i] = sum over the 4 corners (x0 + u, y0 + v), u, v in {0, 1},
//                   x0 = floor(fx), y0 = floor(fy), of
//                   img[n, c, y0 + v, x0 + u] * (u ? fx - x0 : 1 - (fx - x0))
//                                             * (v ? fy - y0 : 1 - (fy - y0))
//   where a corner outside [0, W-1] x [0, H-1] contributes zero.
//
// This is F.grid_sample(mode="bilinear", padding_mode="zeros",
// align_corners=False) on the grid of an affine, with the affine given as the
// six pixel-space coefficients coef[n] = [ax, bx, cx, ay, by, cy] (output
// column i, row j). Replaces affine_warp_bilinear_pallas / _affine_warp_kernel
// (vtoonify_tpu/ops/pallas_kernels.py). The TPU kernel had no gather, so it
// rebuilt the warp as one-hot lerp matrices contracted on the MXU over an
// input box DMA'd per tile, with a static bound on the affine's scale and
// 128-lane alignment; none of that is needed here. On the main path it is the
// training augment's warp: (2, 6, 4120, 4120) -> (2, 6, 2060, 2060).
//
// What bounds it on the H100: about 8 FLOPs per output value against up to
// 4 gathered input values and one stored value, so device memory; the
// affine's footprint is read about once (neighbouring outputs share corners
// through L1/L2). The design is one thread per output pixel (n, j, i), with
// consecutive threads on consecutive output columns: the coordinates and the
// four bilinear weights are computed once in float32 and reused for every
// channel, each channel's store is coalesced, and the gathers of neighbouring
// threads hit neighbouring addresses. Validity is decided in float before any
// float-to-int conversion, so affines of any scale (or non-finite
// coefficients) read nothing out of bounds. Reads float32 or bfloat16,
// accumulates in float32, writes the input's dtype.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
affine_warp_kernel(const T* __restrict__ img, const float* __restrict__ coef,
                   T* __restrict__ y, size_t total, int c, int h, int w, int ho,
                   int wo) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int i = (int)(t % wo);
  const int j = (int)((t / wo) % ho);
  const size_t n = t / ((size_t)wo * ho);

  const float* cf = coef + n * 6;
  const float fi = (float)i, fj = (float)j;
  const float fx = __ldg(cf + 0) * fi + __ldg(cf + 1) * fj + __ldg(cf + 2);
  const float fy = __ldg(cf + 3) * fi + __ldg(cf + 4) * fj + __ldg(cf + 5);
  const float x0f = floorf(fx), y0f = floorf(fy);
  const float wx1 = fx - x0f, wy1 = fy - y0f;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;

  // per-axis corner validity; float compares, so NaN/inf read nothing
  const bool vx0 = x0f >= 0.f && x0f <= (float)(w - 1);
  const bool vx1 = x0f >= -1.f && x0f <= (float)(w - 2);
  const bool vy0 = y0f >= 0.f && y0f <= (float)(h - 1);
  const bool vy1 = y0f >= -1.f && y0f <= (float)(h - 2);
  const int x0 = (vx0 || vx1) ? (int)x0f : 0;
  const int y0 = (vy0 || vy1) ? (int)y0f : 0;
  const float w00 = (vy0 && vx0) ? wy0 * wx0 : 0.f;
  const float w01 = (vy0 && vx1) ? wy0 * wx1 : 0.f;
  const float w10 = (vy1 && vx0) ? wy1 * wx0 : 0.f;
  const float w11 = (vy1 && vx1) ? wy1 * wx1 : 0.f;
  // may be negative (x0 or y0 = -1); only valid corners are read
  const long long o00 = (long long)y0 * w + x0;

  const size_t plane = (size_t)h * w;
  const size_t oplane = (size_t)ho * wo;
  const T* src = img + n * c * plane;
  T* dst = y + n * c * oplane + (size_t)j * wo + i;
  for (int ch = 0; ch < c; ++ch, src += plane, dst += oplane) {
    float acc = 0.f;
    if (w00 != 0.f) acc = fmaf(w00, vt::to_float(src[o00]), acc);
    if (w01 != 0.f) acc = fmaf(w01, vt::to_float(src[o00 + 1]), acc);
    if (w10 != 0.f) acc = fmaf(w10, vt::to_float(src[o00 + w]), acc);
    if (w11 != 0.f) acc = fmaf(w11, vt::to_float(src[o00 + w + 1]), acc);
    *dst = vt::from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* img, const float* coef, void* y, int n, int c,
                   int h, int w, int ho, int wo, cudaStream_t stream) {
  const size_t total = (size_t)n * ho * wo;
  const size_t blocks = (total + THREADS - 1) / THREADS;
  affine_warp_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(img), coef, static_cast<T*>(y), total, c, h, w, ho,
      wo);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vt_affine_warp(const void* img, const void* coef, void* y,
                              int n, int c, int h, int w, int ho, int wo,
                              int dtype, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || ho < 1 || wo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(coef);
  if (dtype == vt::kFloat32)
    return launch<float>(img, cf, y, n, c, h, w, ho, wo, st);
  if (dtype == vt::kBFloat16)
    return launch<__nv_bfloat16>(img, cf, y, n, c, h, w, ho, wo, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
