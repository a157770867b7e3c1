// B1: styled 3x3 convolution with a fused epilogue.
//
//   y[b, o] = act(d[b, o] * sum_{i, dy, dx} x[b, i, h+dy-1, w+dx-1] * s[b, i]
//                                            * w[dy, dx, i, o] + bias[o])
//   act(v)  = leaky_relu(v, slope) * gain      (only when bias is given)
//
// Replaces modconv3x3_fused_pallas / _modconv3x3_kernel
// (vtoonify_tpu/ops/pallas_kernels.py). Stride 1, zero "same" padding,
// NCHW activations, HWIO weights flattened to (9, Cin, Cout). s (B, Cin) and
// d (B, Cout) are optional: without them this is the folded shared-style form
// whose modulation and demodulation already sit in w.
//
// What bounds it on the H100: at the main-path shapes (Cin x Cout up to
// 512 x 2048, 32..1024 px) the conv does 2*9*Cin FLOPs per output element for
// 4 bytes of output, so it is compute bound. This first version is an
// implicit GEMM on the CUDA cores in float32 (no tensor cores yet): each block
// computes an 8x16-pixel by 64-channel output tile, keeps a (BK channels x
// 10x18) halo of the input and the matching 9 x BK x 64 weight slab in shared
// memory so every loaded input value feeds 9 taps x 64 channels, and every
// thread holds an 8-pixel x 4-channel accumulator tile in registers. The
// modulation s is applied while the halo is loaded; d, bias, leaky-ReLU and
// gain are applied to the accumulators before the single store, so the
// pre-activation never goes to device memory. Ragged H, W, Cin and Cout edges
// are masked, so no shape constraint beyond Cin, Cout >= 1.
#include "common.cuh"

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 8;    // input channels per shared-memory stage
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
modconv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ s, const T* __restrict__ d,
                  const T* __restrict__ bias, T* __restrict__ y, int cin,
                  int cout, int h, int wd, int tiles_w, float slope,
                  float gain) {
  __shared__ float xs[BK][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9][BK][BN];

  const int tid = threadIdx.x;
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;

  const int tn = tid % 16;             // channels co0 + 4*tn .. +3
  const int tp = tid / 16;             // pixels: one row, 8 columns
  const int prow = tp >> 1;
  const int pcol = (tp & 1) * 8;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  const size_t plane = (size_t)h * wd;
  const T* xb = x + (size_t)b * cin * plane;

  for (int c0 = 0; c0 < cin; c0 += BK) {
    for (int i = tid; i < BK * (TH + 2) * (TW + 2); i += THREADS) {
      const int c = i / ((TH + 2) * (TW + 2));
      const int r = (i / (TW + 2)) % (TH + 2);
      const int q = i % (TW + 2);
      const int iy = oy0 + r - 1;
      const int ix = ox0 + q - 1;
      float v = 0.f;
      if (c0 + c < cin && iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        v = vt::to_float(xb[(size_t)(c0 + c) * plane + (size_t)iy * wd + ix]);
        if (s != nullptr) v *= vt::to_float(s[(size_t)b * cin + c0 + c]);
      }
      xs[c][r][q] = v;
    }
    for (int i = tid; i < 9 * BK * BN; i += THREADS) {
      const int n = i % BN;
      const int c = (i / BN) % BK;
      const int t = i / (BN * BK);
      float v = 0.f;
      if (c0 + c < cin && co0 + n < cout)
        v = vt::to_float(w[((size_t)t * cin + c0 + c) * cout + co0 + n]);
      ws[t][c][n] = v;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float a[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) a[j] = xs[c][prow + dy][pcol + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][c][tn * 4]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[j][0] = fmaf(a[j + dx], wv.x, acc[j][0]);
            acc[j][1] = fmaf(a[j + dx], wv.y, acc[j][1]);
            acc[j][2] = fmaf(a[j + dx], wv.z, acc[j][2]);
            acc[j][3] = fmaf(a[j + dx], wv.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = oy0 + prow;
  if (oy >= h) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int co = co0 + tn * 4 + k;
    if (co >= cout) continue;
    const float dm = d != nullptr ? vt::to_float(d[(size_t)b * cout + co]) : 1.f;
    const float bv = bias != nullptr ? vt::to_float(bias[co]) : 0.f;
    T* yrow = y + ((size_t)b * cout + co) * plane + (size_t)oy * wd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = ox0 + pcol + j;
      if (ox < wd) {
        float v = acc[j][k] * dm;
        if (bias != nullptr) v = vt::leaky_relu_gain(v + bv, slope, gain);
        yrow[ox] = vt::from_float<T>(v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* s, const void* d,
                   const void* bias, void* y, int b, int cin, int cout, int h,
                   int wd, float slope, float gain, cudaStream_t stream) {
  const int tiles_w = (wd + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (cout + BN - 1) / BN, b);
  modconv3x3_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(s), static_cast<const T*>(d),
      static_cast<const T*>(bias), static_cast<T*>(y), cin, cout, h, wd,
      tiles_w, slope, gain);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vt_modconv3x3(const void* x, const void* w, const void* s,
                             const void* d, const void* bias, void* y, int b,
                             int cin, int cout, int h, int wd, float slope,
                             float gain, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kFloat32)
    return launch<float>(x, w, s, d, bias, y, b, cin, cout, h, wd, slope,
                         gain, st);
  if (dtype == vt::kBFloat16)
    return launch<__nv_bfloat16>(x, w, s, d, bias, y, b, cin, cout, h, wd,
                                 slope, gain, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
