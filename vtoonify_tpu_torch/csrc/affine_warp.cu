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
// (vtoonify_tpu/ops/pallas_kernels.py:470, :351). The TPU kernel had no
// gather, so it rebuilt the warp as one-hot lerp matrices contracted on the
// MXU over an input box DMA'd per tile, with a static bound on the affine's
// scale and 128-lane alignment; none of that is carried over. On the main
// path it is the training augment's warp: (2, 6, 4120, 4120) ->
// (2, 6, 2060, 2060), bf16 or float32.
//
// What bounds it on the H100: about 8 FLOPs per output value against up to
// 4 gathered input values and one stored value, so device memory: the
// affine's footprint read about once (neighbouring outputs share corners
// through L1/L2) and the output written once. To get near that the kernel
// has to keep many gathers in flight, which the first version (one thread
// per output pixel, a runtime channel loop with branches per corner) did not.
// The design:
// * Grid: column tile x row tile x sample (samples above 65535 fold into a
//   loop); all index math inside a plane is 32-bit and comes from the block
//   and thread indices (no division).
// * Tiles are 2-D: a block of 8 x 32 threads covers 32 output columns x 32
//   rows, a warp 32 columns x 4 rows. The augment rotates by any angle, and
//   a warp along one output row (128 columns) gathers, after a rotation
//   near 90 degrees, from 128 input rows at once: one cache line per thread
//   and load, more lines than L1 keeps for the next channel's and corner's
//   loads. A one-off sweep of block shapes on the card found row strips
//   several times slower than 2-D tiles on the flagship's sampled affine,
//   and a little faster on the identity.
// * Each thread computes V = 4 adjacent output columns of one row. The
//   coordinates, the clamped corner offsets and the four weights of each
//   column are computed once in float32 and reused for every channel.
// * Loads are branch-free: each corner index is clamped into the image and a
//   corner outside it is zeroed by a select (weight and value), so all
//   4 * C * V gathers of a thread can issue before its FMAs. They go through
//   the read-only path (__ldg). Validity is decided in float before any
//   float-to-int conversion (and the conversion's input is clamped), so
//   affines of any scale or non-finite coefficients read nothing out of
//   bounds and give zeros.
// * The channel count is a template parameter for the augment's 6 channels
//   (a thread's 96 gathers unrolled together, none behind a branch or an
//   FMA, so the compiler issues them ahead as its registers allow); other
//   counts take a runtime-count instance, one channel's 16 gathers at a
//   time.
// * Stores: the V values of a channel leave as one 8-byte (bf16) or 16-byte
//   (float32) store where the output row's length is a multiple of V (the
//   flagship's 2060 px is) and the output is aligned; otherwise as scalars
//   with the row's ragged tail masked.
// Reads float32 or bfloat16, computes in float32, writes the input's dtype.
#include "common.cuh"

namespace {

constexpr int BX = 8;      // threads along an output row
constexpr int BY = 32;     // output rows per block
constexpr int V = 4;       // adjacent output columns per thread
constexpr int C_AUG = 6;   // the augment's channels (train/augment.py)
constexpr unsigned MAX_GRID_Z = 65535;

// V output values of one channel as one store: 16 bytes of float32, 8 of bf16
template <typename T> struct Packed;
template <> struct Packed<float> {
  using W = float4;
  static __device__ __forceinline__ W pack(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Packed<__nv_bfloat16> {
  using W = uint2;
  static __device__ __forceinline__ W pack(const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    return make_uint2(*reinterpret_cast<unsigned*>(&lo),
                      *reinterpret_cast<unsigned*>(&hi));
  }
};

// CT > 0: CT channels, all gathered together; CT == 0: c_rt channels, one at
// a time. VEC: rows of a multiple of V outputs, aligned, packed stores.
template <typename T, int CT, bool VEC>
__global__ void __launch_bounds__(BX * BY)
affine_warp_kernel(const T* __restrict__ img, const float* __restrict__ coef,
                   T* __restrict__ y, int n_samples, int c_rt, int h, int w,
                   int ho, int wo) {
  constexpr int CB = CT > 0 ? CT : 1;  // channels gathered together
  const int i0 = (blockIdx.x * BX + threadIdx.x) * V;
  const int j = blockIdx.y * BY + threadIdx.y;
  if (i0 >= wo || j >= ho) return;
  const int C = CT > 0 ? CT : c_rt;
  const int plane = h * w;        // < 2^31 (checked by the wrapper)
  const int oplane = ho * wo;

  for (int n = blockIdx.z; n < n_samples; n += gridDim.z) {
    const float* cf = coef + 6 * (size_t)n;
    const float ax = __ldg(cf + 0), bx = __ldg(cf + 1), cx = __ldg(cf + 2);
    const float ay = __ldg(cf + 3), by = __ldg(cf + 4), cy = __ldg(cf + 5);
    const float fj = (float)j;
    const float rx = fmaf(bx, fj, cx), ry = fmaf(by, fj, cy);

    int off[V][4];      // corner offsets in the plane, clamped into it
    float wt[V][4];     // bilinear weights, 0 for a corner outside
    bool in[V][4];      // corner inside the image
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float fi = (float)(i0 + v);
      const float fx = fmaf(ax, fi, rx), fy = fmaf(ay, fi, ry);
      const float x0f = floorf(fx), y0f = floorf(fy);
      const float wx1 = fx - x0f, wy1 = fy - y0f;
      const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
      // float compares: NaN and inf are outside
      const bool vx0 = x0f >= 0.f && x0f <= (float)(w - 1);
      const bool vx1 = x0f >= -1.f && x0f <= (float)(w - 2);
      const bool vy0 = y0f >= 0.f && y0f <= (float)(h - 1);
      const bool vy1 = y0f >= -1.f && y0f <= (float)(h - 2);
      // clamp before converting (fmaxf takes the non-NaN operand)
      const int x0 = (int)fminf(fmaxf(x0f, -1.f), (float)w);
      const int y0 = (int)fminf(fmaxf(y0f, -1.f), (float)h);
      const int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
      const int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
      off[v][0] = ya * w + xa;
      off[v][1] = ya * w + xb;
      off[v][2] = yb * w + xa;
      off[v][3] = yb * w + xb;
      in[v][0] = vy0 && vx0;
      in[v][1] = vy0 && vx1;
      in[v][2] = vy1 && vx0;
      in[v][3] = vy1 && vx1;
      wt[v][0] = in[v][0] ? wy0 * wx0 : 0.f;
      wt[v][1] = in[v][1] ? wy0 * wx1 : 0.f;
      wt[v][2] = in[v][2] ? wy1 * wx0 : 0.f;
      wt[v][3] = in[v][3] ? wy1 * wx1 : 0.f;
    }

    const T* src = img + (size_t)n * C * plane;
    T* dst = y + ((size_t)n * C * ho + j) * wo + i0;
    for (int c0 = 0; c0 < C; c0 += CB) {
      float val[CB][V][4];
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const T* s = src + (size_t)(c0 + cb) * plane;
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int k = 0; k < 4; ++k) val[cb][v][k] = vt::ldg_float(s + off[v][k]);
      }
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        float out[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc = fmaf(wt[v][k], in[v][k] ? val[cb][v][k] : 0.f, acc);
          out[v] = acc;
        }
        T* d = dst + (size_t)(c0 + cb) * oplane;
        if (VEC) {
          *reinterpret_cast<typename Packed<T>::W*>(d) = Packed<T>::pack(out);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (i0 + v < wo) d[v] = vt::from_float<T>(out[v]);
        }
      }
    }
  }
}

template <typename T, int CT>
cudaError_t launch_c(const T* img, const float* coef, T* y, int n, int c,
                     int h, int w, int ho, int wo, cudaStream_t stream) {
  const dim3 block(BX, BY);
  const dim3 grid((unsigned)((wo + BX * V - 1) / (BX * V)),
                  (unsigned)((ho + BY - 1) / BY),
                  (unsigned)(n < (int)MAX_GRID_Z ? n : MAX_GRID_Z));
  const bool vec = wo % V == 0 &&
                   reinterpret_cast<uintptr_t>(y) % (V * sizeof(T)) == 0;
  if (vec)
    affine_warp_kernel<T, CT, true><<<grid, block, 0, stream>>>(
        img, coef, y, n, c, h, w, ho, wo);
  else
    affine_warp_kernel<T, CT, false><<<grid, block, 0, stream>>>(
        img, coef, y, n, c, h, w, ho, wo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* img, const float* coef, void* y, int n, int c,
                   int h, int w, int ho, int wo, cudaStream_t stream) {
  const T* in = static_cast<const T*>(img);
  T* out = static_cast<T*>(y);
  if (c == C_AUG)
    return launch_c<T, C_AUG>(in, coef, out, n, c, h, w, ho, wo, stream);
  return launch_c<T, 0>(in, coef, out, n, c, h, w, ho, wo, stream);
}

}  // namespace

extern "C" int vt_affine_warp(const void* img, const void* coef, void* y,
                              int n, int c, int h, int w, int ho, int wo,
                              int dtype, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 ||
      (long long)h * w >= (1LL << 31) || (long long)ho * wo >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(coef);
  if (dtype == vt::kFloat32)
    return launch<float>(img, cf, y, n, c, h, w, ho, wo, st);
  if (dtype == vt::kBFloat16)
    return launch<__nv_bfloat16>(img, cf, y, n, c, h, w, ho, wo, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
