// B4: depth-to-space x2, NCHW: (B, 4C, H, W) -> (B, C, 2H, 2W).
//
//   y[b, o, 2h + a, 2w + e] = x[b, ci, h, w]
//   ci = o*4 + a*2 + e   (phase-minor: the polyphase up conv's packing)
//   ci = (a*2 + e)*C + o (phase-major: depth_to_space2's packing)
//
// Replaces depth_to_space2_pallas / _d2s2_kernel
// (vtoonify_tpu/ops/pallas_kernels.py), which is phase-major only; the main
// path runs the phase-minor order after every polyphase up conv.
//
// What bounds it on the H100: a pure permutation, one read and one write per
// element, so device-memory bandwidth. The design is one thread per output
// element with consecutive threads on consecutive output columns: stores are
// fully coalesced and each pair of neighbouring threads reads from one input
// row, so each input cache line is fetched once per (a, e) phase. It copies
// raw element bits (1, 2 or 4 bytes), so it takes any dtype.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename E>
__global__ void __launch_bounds__(THREADS)
d2s2_kernel(const E* __restrict__ x, E* __restrict__ y, size_t total, int c,
            int h, int w, int phase_minor) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ow = 2 * w;
  const int oh = 2 * h;
  const int ox = (int)(i % ow);
  const int oy = (int)((i / ow) % oh);
  const size_t bo = i / ((size_t)ow * oh);  // b * C + o
  const int o = (int)(bo % c);
  const size_t b = bo / c;
  const int phase = (oy & 1) * 2 + (ox & 1);
  const int ci = phase_minor ? o * 4 + phase : phase * c + o;
  y[i] = x[((b * 4 * c + ci) * h + (oy >> 1)) * (size_t)w + (ox >> 1)];
}

template <typename E>
cudaError_t launch(const void* x, void* y, int b, int c, int h, int w,
                   int phase_minor, cudaStream_t stream) {
  const size_t total = (size_t)b * c * 4 * h * w;
  const size_t blocks = (total + THREADS - 1) / THREADS;
  d2s2_kernel<E><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const E*>(x), static_cast<E*>(y), total, c, h, w,
      phase_minor);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vt_d2s2(const void* x, void* y, int b, int c, int h, int w,
                       int elem_bytes, int phase_minor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(x, y, b, c, h, w, phase_minor, st);
    case 2: return launch<uint16_t>(x, y, b, c, h, w, phase_minor, st);
    case 4: return launch<uint32_t>(x, y, b, c, h, w, phase_minor, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
