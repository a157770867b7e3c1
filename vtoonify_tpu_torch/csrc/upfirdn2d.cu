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
// 12 x 12 with signed pads. On the main paths it is ToRGB's x2 skip upsample
// (outer([1,3,3,1]) taps, pad (2, 1)), the training data's x2 downsample and
// the discriminator's blur (same taps), and the augment's 12-tap SYM6 wavelet
// passes, one axis at a time ((1, 12) / (12, 1) taps, x2 up with pads (6, 5),
// x2 down with pads (-1, -1)) on images up to 4120 x 4120.
//
// What bounds it on the H100: at most 6 x 6 live taps per output for up = 2
// (144 multiply-adds for 12 x 12 at up = down = 1) against 2 or 4 bytes read
// and written per element, so device memory and launch latency, not FLOPs.
// The design is one thread per output element, with consecutive threads on
// consecutive output columns, so stores are coalesced and the input reads of
// neighbouring threads hit the same cache lines. Each thread walks only the
// input pixels its taps land on: for up = 2 the taps on the zero-stuffed
// grid's other parity are skipped by the loop bounds, not tested one by one.
// The whole 2-D FIR runs in one pass in float32: no intermediate plane
// between the two separable passes goes to memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TAPS = 12;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

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

  // stuffed-grid rows by .. by + kh - 1 hold input rows iy with
  // iy * up_y in that window; tap ty = iy * up_y - by
  const int by = oy * down_y - pad_y0;
  const int bx = ox * down_x - pad_x0;
  const int iy0 = max(0, -floor_div(-by, up_y));
  const int iy1 = min(h - 1, floor_div(by + kh - 1, up_y));
  const int ix0 = max(0, -floor_div(-bx, up_x));
  const int ix1 = min(w - 1, floor_div(bx + kw - 1, up_x));

  float acc = 0.f;
  for (int iy = iy0; iy <= iy1; ++iy) {
    const float* krow = k + (kh - 1 - (iy * up_y - by)) * kw + (kw - 1);
    const T* xrow = xp + (size_t)iy * w;
    for (int ix = ix0; ix <= ix1; ++ix)
      acc = fmaf(__ldg(krow - (ix * up_x - bx)), vt::to_float(xrow[ix]), acc);
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
