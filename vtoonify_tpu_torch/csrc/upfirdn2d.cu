// B3: upfirdn2d — zero-stuff by `up`, pad (signed), 2-D FIR, keep every
// `down`-th sample, per (batch, channel) plane:
//
//   y[p, oy, ox] = sum_{ty < kh, tx < kw} k[kh-1-ty, kw-1-tx]
//                  * X(p, oy*down_y + ty - pad_y0, ox*down_x + tx - pad_x0)
//   X(p, i, j)   = x[p, i/up_y, j/up_x] if i, j >= 0, i % up_y == 0,
//                  j % up_x == 0 and in range, else 0
//
// Replaces blur_same_pallas / _blur_kernel (vtoonify_tpu/ops/pallas_kernels.py)
// and generalises it from up = down = 1 to up, down in {1, 2} and taps up to
// 8 x 8 with signed pads. On the main path it is ToRGB's x2 skip upsample
// of the RGB image: (B, 3, r, r) -> (B, 3, 2r, 2r), r = 32..512, taps
// outer([1,3,3,1]) / 16, pad (2, 1).
//
// What bounds it on the H100: with 3 channels it moves 12 bytes in and
// 48 bytes out per input pixel (f32) and does at most 64 multiply-adds per
// output, so it is bound by device memory and launch latency, not FLOPs. The
// design is one thread per output element, with consecutive threads on
// consecutive output columns, so stores are coalesced and the up to
// ceil(kh/up) x ceil(kw/up) input reads of neighbouring threads hit the same
// cache lines. The whole 2-D FIR runs in one pass in float32: no
// intermediate plane between the two separable passes goes to memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TAPS = 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
upfirdn2d_kernel(const T* __restrict__ x, const float* __restrict__ k,
                 T* __restrict__ y, size_t total, int h, int w, int oh, int ow,
                 int up_x, int up_y, int down_x, int down_y, int pad_x0,
                 int pad_y0, int kh, int kw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ox = (int)(i % ow);
  const int oy = (int)((i / ow) % oh);
  const size_t p = i / ((size_t)ow * oh);
  const T* xp = x + p * h * w;

  float acc = 0.f;
  for (int ty = 0; ty < kh; ++ty) {
    const int sy = oy * down_y + ty - pad_y0;
    if (sy < 0 || sy % up_y != 0) continue;
    const int iy = sy / up_y;
    if (iy >= h) continue;
    for (int tx = 0; tx < kw; ++tx) {
      const int sx = ox * down_x + tx - pad_x0;
      if (sx < 0 || sx % up_x != 0) continue;
      const int ix = sx / up_x;
      if (ix >= w) continue;
      acc = fmaf(__ldg(&k[(kh - 1 - ty) * kw + (kw - 1 - tx)]),
                 vt::to_float(xp[(size_t)iy * w + ix]), acc);
    }
  }
  y[i] = vt::from_float<T>(acc);
}

template <typename T>
cudaError_t launch(const void* x, const float* k, void* y, int planes, int h,
                   int w, int oh, int ow, int up_x, int up_y, int down_x,
                   int down_y, int pad_x0, int pad_y0, int kh, int kw,
                   cudaStream_t stream) {
  const size_t total = (size_t)planes * oh * ow;
  const size_t blocks = (total + THREADS - 1) / THREADS;
  upfirdn2d_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), k, static_cast<T*>(y), total, h, w, oh, ow,
      up_x, up_y, down_x, down_y, pad_x0, pad_y0, kh, kw);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vt_upfirdn2d(const void* x, const void* k, void* y, int planes,
                            int h, int w, int oh, int ow, int up_x, int up_y,
                            int down_x, int down_y, int pad_x0, int pad_y0,
                            int kh, int kw, int dtype, void* stream) {
  if (kh < 1 || kw < 1 || kh > MAX_TAPS || kw > MAX_TAPS || up_x < 1 ||
      up_y < 1 || down_x < 1 || down_y < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  if (dtype == vt::kFloat32)
    return launch<float>(x, kf, y, planes, h, w, oh, ow, up_x, up_y, down_x,
                         down_y, pad_x0, pad_y0, kh, kw, st);
  if (dtype == vt::kBFloat16)
    return launch<__nv_bfloat16>(x, kf, y, planes, h, w, oh, ow, up_x, up_y,
                                 down_x, down_y, pad_x0, pad_y0, kh, kw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
