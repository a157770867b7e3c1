// B4: depth-to-space x2, NCHW: (B, 4C, H, W) -> (B, C, 2H, 2W).
//
//   y[b, o, 2h + a, 2w + e] = x[b, ci, h, w]
//   ci = o*4 + a*2 + e   (phase-minor: the polyphase up conv's packing)
//   ci = (a*2 + e)*C + o (phase-major: depth_to_space2's packing)
//
// Replaces depth_to_space2_pallas / _d2s2_kernel
// (vtoonify_tpu/ops/pallas_kernels.py:600, :591), which is phase-major only;
// the main path runs the phase-minor order after every polyphase up conv.
//
// What bounds it on the H100: a pure permutation, each element read once and
// written once, so device-memory bandwidth: 2 x the input bytes over
// 3.35 TB/s. The design keeps the instruction count per byte low enough for
// that bound to be reached:
// * Grid: x = chunks of an input row, y = input rows, z = output planes
//   (b * C + o), folded into a loop where there are more than 65535. All
//   in-plane index math is 32-bit and comes from the block and thread
//   indices; the only division is p / C for the phase-major order, once per
//   plane a thread visits.
// * Per thread: one chunk of an input row in each of the four phase planes
//   (a, e), each a 16-byte load where the row pitch allows it (in
//   phase-minor order the four planes are adjacent: channels 4o .. 4o+3);
//   the chunks of (a, 0) and (a, 1) are interleaved in registers into output
//   row 2h + a and leave as two stores of the same width.
// * Widths off the vector: the word is the widest of 16, 8, 4, 2 or 1 bytes
//   that divides the row pitch (W x element bytes) and both base addresses,
//   so every row of the tensor keeps the same alignment (the temporal crop's
//   28 px bf16 planes take 8-byte words, odd widths scalars). A row is a
//   whole number of words: no tail.
// It copies raw element bits (1, 2 or 4 bytes), so it takes any dtype.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned MAX_GRID_Z = 65535;

template <int BYTES> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// E: element bits, W: one load / store word of V elements
template <typename E, typename W>
union Pack {
  W w;
  E e[sizeof(W) / sizeof(E)];
};

template <typename E, typename W>
__global__ void __launch_bounds__(THREADS)
d2s2_kernel(const E* __restrict__ x, E* __restrict__ y, int planes, int c,
            int h, int w, int chunks, int phase_minor) {
  constexpr int V = sizeof(W) / sizeof(E);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;  // chunk of the row
  const int r = blockIdx.y * blockDim.y + threadIdx.y;  // input row
  if (j >= chunks || r >= h) return;
  const size_t in_plane = (size_t)h * w;
  const int col = j * V;
  for (int p = blockIdx.z; p < planes; p += gridDim.z) {
    size_t q0, step;  // input plane of phase 0, planes between phases
    if (phase_minor) {
      q0 = (size_t)p * 4;
      step = 1;
    } else {
      const int b = p / c;
      q0 = (size_t)b * 4 * c + (p - b * c);
      step = c;
    }
    const E* src = x + (q0 * h + r) * w + col;
    Pack<E, W> in[4];
#pragma unroll
    for (int ph = 0; ph < 4; ++ph)
      in[ph].w = *reinterpret_cast<const W*>(src + ph * step * in_plane);
    E* dst = y + ((size_t)p * 2 * h + 2 * r) * (2 * (size_t)w) + 2 * col;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      Pack<E, W> out[2];
#pragma unroll
      for (int i = 0; i < 2 * V; ++i)
        out[i / V].e[i % V] = in[2 * a + (i & 1)].e[i >> 1];
      W* row = reinterpret_cast<W*>(dst + (size_t)a * 2 * w);
      row[0] = out[0].w;
      row[1] = out[1].w;
    }
  }
}

template <typename E, int WB>
cudaError_t launch_w(const void* x, void* y, int planes, int c, int h, int w,
                     int phase_minor, cudaStream_t stream) {
  using W = typename Word<WB>::T;
  constexpr int V = WB / (int)sizeof(E);
  const int chunks = w / V;
  int bx = 1;
  while (bx < chunks && bx < THREADS) bx *= 2;
  const int by = THREADS / bx;
  const dim3 block(bx, by);
  const dim3 grid((chunks + bx - 1) / bx, (h + by - 1) / by,
                  planes < (int)MAX_GRID_Z ? planes : MAX_GRID_Z);
  d2s2_kernel<E, W><<<grid, block, 0, stream>>>(
      static_cast<const E*>(x), static_cast<E*>(y), planes, c, h, w, chunks,
      phase_minor);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch(const void* x, void* y, int b, int c, int h, int w,
                   int phase_minor, cudaStream_t stream) {
  const int planes = b * c;
  // the widest word dividing the row pitch and both base addresses
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y);
  int wb = 16;
  while (wb > (int)sizeof(E) &&
         (((size_t)w * sizeof(E)) % wb != 0 || addr % wb != 0))
    wb /= 2;
  switch (wb) {
    case 16: return launch_w<E, 16>(x, y, planes, c, h, w, phase_minor, stream);
    case 8: return launch_w<E, 8>(x, y, planes, c, h, w, phase_minor, stream);
    case 4:
      if constexpr (sizeof(E) <= 4)
        return launch_w<E, 4>(x, y, planes, c, h, w, phase_minor, stream);
      break;
    case 2:
      if constexpr (sizeof(E) <= 2)
        return launch_w<E, 2>(x, y, planes, c, h, w, phase_minor, stream);
      break;
    case 1:
      if constexpr (sizeof(E) == 1)
        return launch_w<E, 1>(x, y, planes, c, h, w, phase_minor, stream);
      break;
  }
  return cudaErrorInvalidValue;
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
