// B1: styled 3x3 convolution with a fused epilogue.
//
//   y[b, o] = act(d[b, o] * sum_{i, dy, dx} x[b, i, h+dy-1, w+dx-1] * s[b, i]
//                                            * w[dy, dx, i, o] + bias[o])
//   act(v)  = leaky_relu(v, slope) * gain      (only when bias is given)
//
// Replaces modconv3x3_fused_pallas / _modconv3x3_kernel
// (vtoonify_tpu/ops/pallas_kernels.py:214 / :152). Stride 1, zero "same"
// padding, NCHW activations, HWIO weights flattened to (9, Cin, Cout). s
// (B, Cin) and d (B, Cout) are optional: without them this is the folded
// shared-style form whose modulation and demodulation already sit in w.
//
// Two kernels, chosen by dtype in vt_modconv3x3 below:
// * bfloat16 -> modconv3x3_mma.cu: an implicit GEMM on the tensor cores
//   (mma.sync m16n8k16, bf16 operands, f32 accumulators). A block owns an
//   8 x 16 px by BN-channel output tile (BN 32/64/128 from Cout), 8 warps as
//   4 (pixel rows) x 2 (channel halves), each warp two m16 fragments (one
//   16-px row each) by BN/16 n8 fragments. K is walked as 32-channel chunks:
//   a (10 x 18 px x 32 ch) halo, channel-minor, and a [tap][k][n] weight
//   slab sit in shared memory, double-buffered (weights by cp.async, the
//   halo through registers), so every tap is an offset into the halo; A
//   fragments come by ldmatrix, B by ldmatrix.trans, both conflict-free by
//   padding. The layout is spelled out in that file's note.
// * float32 -> the CUDA-core kernel in this file: 8 x 16 px by 64 channels
//   per block, a (8 ch x 10 x 18) halo and its 9 x 8 x 64 weight slab in
//   shared memory, an 8-px x 4-channel fmaf accumulator tile per thread.
//   The float32 path stays off the tensor cores on purpose: their float32
//   input is TF32 (10-bit mantissa), and the float32 gates hold this kernel
//   to exact float32 -- 1e-4 of its plain version on the card, the --tiny
//   train step on the card against the CPU, float32 serving within 2 uint8
//   LSB of the CPU. TF32 would break all three.
// Both apply s while the halo is loaded and d, bias, leaky-ReLU and gain to
// the accumulators before the single store, so the pre-activation never goes
// to device memory. Ragged H, W, Cin and Cout edges are masked: no shape
// constraint beyond Cin, Cout >= 1.
//
// What bounds B1 on the H100 (bf16, batch 1): the conv does 2*9*Cin*Cout
// FLOPs per output pixel. At 64 px, 512 -> 512 that is 19.3 GFLOP against
// 12.7 MB of input, weights and output: 19.5 us at 989 TFLOP/s against
// 3.8 us at 3.35 TB/s, bound by operations. At 1024 px, 32 -> 32 it is the
// same 19.3 GFLOP against 128 MB of activations: 40 us of bytes against
// 19.5 us of operations, bound by bytes -- there the halo load and the
// output store, not the mma, set the time.
#include "common.cuh"

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 8;    // input channels per shared-memory stage
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
modconv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ s, const float* __restrict__ d,
                  const float* __restrict__ bias, float* __restrict__ y, int cin,
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
  const float* xb = x + (size_t)b * cin * plane;

  for (int c0 = 0; c0 < cin; c0 += BK) {
    for (int i = tid; i < BK * (TH + 2) * (TW + 2); i += THREADS) {
      const int c = i / ((TH + 2) * (TW + 2));
      const int r = (i / (TW + 2)) % (TH + 2);
      const int q = i % (TW + 2);
      const int iy = oy0 + r - 1;
      const int ix = ox0 + q - 1;
      float v = 0.f;
      if (c0 + c < cin && iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        v = xb[(size_t)(c0 + c) * plane + (size_t)iy * wd + ix];
        if (s != nullptr) v *= s[(size_t)b * cin + c0 + c];
      }
      xs[c][r][q] = v;
    }
    for (int i = tid; i < 9 * BK * BN; i += THREADS) {
      const int n = i % BN;
      const int c = (i / BN) % BK;
      const int t = i / (BN * BK);
      float v = 0.f;
      if (c0 + c < cin && co0 + n < cout)
        v = w[((size_t)t * cin + c0 + c) * cout + co0 + n];
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
    const float dm = d != nullptr ? d[(size_t)b * cout + co] : 1.f;
    const float bv = bias != nullptr ? bias[co] : 0.f;
    float* yrow = y + ((size_t)b * cout + co) * plane + (size_t)oy * wd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = ox0 + pcol + j;
      if (ox < wd) {
        float v = acc[j][k] * dm;
        if (bias != nullptr) v = vt::leaky_relu_gain(v + bv, slope, gain);
        yrow[ox] = v;
      }
    }
  }
}

cudaError_t launch_f32(const void* x, const void* w, const void* s,
                       const void* d, const void* bias, void* y, int b, int cin,
                       int cout, int h, int wd, float slope, float gain,
                       cudaStream_t stream) {
  const int tiles_w = (wd + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (cout + BN - 1) / BN, b);
  modconv3x3_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(s), static_cast<const float*>(d),
      static_cast<const float*>(bias), static_cast<float*>(y), cin, cout, h, wd,
      tiles_w, slope, gain);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vt_modconv3x3_mma(const void* x, const void* w, const void* s,
                                 const void* d, const void* bias, void* y,
                                 int b, int cin, int cout, int h, int wd,
                                 float slope, float gain, void* stream);

extern "C" int vt_modconv3x3(const void* x, const void* w, const void* s,
                             const void* d, const void* bias, void* y, int b,
                             int cin, int cout, int h, int wd, float slope,
                             float gain, int dtype, void* stream) {
  if (dtype == vt::kFloat32)
    return launch_f32(x, w, s, d, bias, y, b, cin, cout, h, wd, slope, gain,
                      static_cast<cudaStream_t>(stream));
  if (dtype == vt::kBFloat16)
    return vt_modconv3x3_mma(x, w, s, d, bias, y, b, cin, cout, h, wd, slope,
                             gain, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
