// B2: fused bias + leaky-ReLU x gain.
//
//   y[n, c, i] = leaky_relu(x[n, c, i] + bias[c], slope) * gain
//
// Replaces fused_leaky_relu_pallas / _fused_lrelu_kernel
// (vtoonify_tpu/ops/pallas_kernels.py). The tensor is viewed as
// (outer, C, inner): inner = H*W for NCHW activations, inner = 1 for the
// (N, C) outputs of the style MLPs. bias may be null (no bias add).
//
// What bounds it on the H100: one read and one write per element and one
// bias value per channel, so it is bound by device-memory bandwidth
// (3.35 TB/s). The design does the whole chain in one pass in registers,
// with consecutive threads on consecutive elements (coalesced loads and
// stores) and a grid-stride loop capped at a few waves of blocks.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                   T* __restrict__ y, size_t total, int c, size_t inner,
                   float slope, float gain) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float v = vt::to_float(x[i]);
    if (bias != nullptr) v += vt::to_float(bias[(i / inner) % c]);
    y[i] = vt::from_float<T>(vt::leaky_relu_gain(v, slope, gain));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* bias, void* y, size_t total,
                   int c, size_t inner, float slope, float gain,
                   cudaStream_t stream) {
  size_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fused_lrelu_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias),
      static_cast<T*>(y), total, c, inner, slope, gain);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vt_fused_lrelu(const void* x, const void* bias, void* y,
                              long long total, int c, long long inner,
                              float slope, float gain, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kFloat32)
    return launch<float>(x, bias, y, (size_t)total, c, (size_t)inner, slope,
                         gain, st);
  if (dtype == vt::kBFloat16)
    return launch<__nv_bfloat16>(x, bias, y, (size_t)total, c, (size_t)inner,
                                 slope, gain, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
