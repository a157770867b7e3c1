// B3: upfirdn2d — zero-stuff by `up`, pad (signed), 2-D FIR, keep every
// `down`-th sample, per (batch, channel) plane:
//
//   y[p, oy, ox] = sum_{ty < kh, tx < kw} k[kh-1-ty, kw-1-tx]
//                  * X(p, oy*down_y + ty - pad_y0, ox*down_x + tx - pad_x0)
//   X(p, i, j)   = x[p, i/up_y, j/up_x] if i, j >= 0, i % up_y == 0,
//                  j % up_x == 0 and in range, else 0
//
// Replaces blur_same_pallas / _blur_kernel (vtoonify_tpu/ops/pallas_kernels.py
// :109, :79) and generalises it from up = down = 1 to up, down in {1, 2} and
// taps up to 12 x 12 with signed pads. On the main paths it is ToRGB's x2
// skip upsample (outer([1,3,3,1]) taps, pad (2, 1)), the training data's x2
// downsample and the discriminator's blur (same taps), and the augment's
// 12-tap SYM6 wavelet passes, one axis at a time ((1, 12) / (12, 1) taps, x2
// up with pads (6, 5), x2 down with pads (-1, -1)) on planes up to
// 2060 x 4120.
//
// What bounds it on the H100: at most 36 live taps per output on the main
// path (4 x 4, or 6 of a 12-tap filter at up = 2) against 2 or 4 bytes read
// and written per element, so device-memory bandwidth (input once + output
// once over 3.35 TB/s); FLOPs are far below their bound. The design:
// * Taps by value: the launcher copies the float32 taps from the host into a
//   kernel parameter (`Taps`, 144 floats); no launch copies or reads a tap
//   buffer. Each block puts them in shared memory once.
// * Grid: x = output-column tiles (32 rx wide), y = output-row tiles (8 ry
//   high), z = planes, folded into a loop where there are more than 65535.
//   Index math is 32-bit inside a plane, with no division per element.
// * Shared memory: a block stages its tile's input footprint (tile / up +
//   taps, or tile x down + taps, per axis) as float32, with 16-byte loads
//   where the row pitch is 16-byte aligned (scalar loads otherwise), coalesced
//   along rows; whatever lies outside the image is zero-filled, which is how
//   pads and negative pads (crops) are taken.
// * Per thread: rx outputs of one row, 32 columns apart, so a warp reads
//   consecutive shared words; the tap loop is outermost, each tap read once
//   into a register and applied to the thread's rx outputs. For up = 2 the
//   live taps follow the output's parity, which is the same for all rx
//   outputs of a thread; up and down are template parameters, so the parity
//   and the stride of the shared reads are compile-time.
// * Stores: the tile goes back through shared memory in the output dtype and
//   leaves as 16-byte stores where the output row pitch is 16-byte aligned,
//   scalar stores otherwise. Accumulation is float32, rounded once.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 32;            // threads along x: a warp spans one row
constexpr int TY = THREADS / TX;  // thread rows of a block
constexpr int RX_MAX = 8;         // outputs per thread along x, 32 apart
constexpr int RY_MAX = 8;         // output rows per thread, TY apart
constexpr int MAX_TAPS = 12;
constexpr unsigned MAX_GRID_Z = 65535;
constexpr int SMEM_BUDGET = 48 * 1024;

struct Taps {  // kh x kw, row-major, convolution orientation
  float k[MAX_TAPS * MAX_TAPS];
};

struct Geom {
  int planes, h, w, oh, ow, px0, py0, kh, kw;
  int rx, ry;        // tile = 8 ry rows x 32 rx columns of output
  int vec_in;        // 16-byte staging loads
  int vec_out;       // 16-byte stores
  int taps_floats;   // shared floats before the input tile (16-byte aligned)
  int in_floats;     // shared floats of the input tile (16-byte aligned)
};

template <int F>
__device__ __forceinline__ int floor_div(int v) {  // F in {1, 2}
  return F == 1 ? v : (v >> 1);                    // arithmetic shift: floor
}

template <typename T>
__device__ __forceinline__ void stage_vec(const T* src, float* dst);
template <>
__device__ __forceinline__ void stage_vec<float>(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
template <>
__device__ __forceinline__ void stage_vec<__nv_bfloat16>(
    const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is the high half of a word
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T, int UX, int UY, int DX, int DY>
__global__ void __launch_bounds__(THREADS)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const __grid_constant__ Taps taps, const Geom g) {
  constexpr int V = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int CSTEP = 32 * DX / UX;          // shared words between a
                                               // thread's outputs
  extern __shared__ __align__(16) float smem[];
  float* s_taps = smem;
  float* s_in = smem + g.taps_floats;
  T* s_out = reinterpret_cast<T*>(smem + g.taps_floats + g.in_floats);

  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < g.kh * g.kw; i += THREADS) s_taps[i] = taps.k[i];

  const int tw_full = TX * g.rx, th_full = TY * g.ry;
  const int x0 = blockIdx.x * tw_full, y0 = blockIdx.y * th_full;
  const int tw = min(tw_full, g.ow - x0), th = min(th_full, g.oh - y0);

  // the tile's input footprint: rows sy0 .. sy1, columns sx0 .. sx0 + iw - 1
  const int vin = g.vec_in ? V : 1;
  const int sx0 = floor_div<UX>(x0 * DX - g.px0) & ~(vin - 1);
  const int sx1 = floor_div<UX>((x0 + tw - 1) * DX - g.px0 + g.kw - 1);
  const int sy0 = floor_div<UY>(y0 * DY - g.py0);
  const int sy1 = floor_div<UY>((y0 + th - 1) * DY - g.py0 + g.kh - 1);
  const int iw = (sx1 - sx0 + vin) & ~(vin - 1);
  const int ih = sy1 - sy0 + 1;
  const int cpr = iw / vin;  // staged chunks per row
  const int n_in = ih * cpr;
  const int r_start = tid / cpr, c_start = tid - r_start * cpr;
  const int dr = THREADS / cpr, dc = THREADS - dr * cpr;

  // this thread's outputs: row y0 + ty + TY i, columns x0 + tx + 32 j
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lbx = (x0 + tx) * DX - g.px0 - sx0 * UX;  // stuffed col, >= 0
  const int t0x = UX == 2 ? (lbx & 1) : 0;            // first live x tap
  const int col0 = floor_div<UX>(lbx + t0x);
  const int jn = tx < tw ? min(g.rx, (tw - tx + TX - 1) / TX) : 0;

  // 16-byte stores: chunks of the output tile
  const int vout = g.vec_out ? V : 1;
  const int cpo = tw / vout;
  const int n_out = th * cpo;
  const int ro_start = tid / cpo, co_start = tid - ro_start * cpo;
  const int dro = THREADS / cpo, dco = THREADS - dro * cpo;

  for (int p = blockIdx.z; p < g.planes; p += gridDim.z) {
    const T* xp = x + (size_t)p * g.h * g.w;
    T* yp = y + (size_t)p * g.oh * g.ow;
    __syncthreads();  // the previous plane's tile is out of shared memory

    // stage: 16-byte chunks (vec_in: W % V == 0, so a chunk lies wholly
    // inside or wholly outside the row) or single elements
    for (int i = tid, r = r_start, c = c_start; i < n_in; i += THREADS) {
      const int gy = sy0 + r, gx = sx0 + c * vin;
      float* dst = s_in + r * iw + c * vin;
      const bool inside = gy >= 0 && gy < g.h && gx >= 0 && gx < g.w;
      if (g.vec_in) {
        if (inside) {
          stage_vec<T>(xp + gy * g.w + gx, dst);
        } else {
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        *dst = inside ? vt::to_float(xp[gy * g.w + gx]) : 0.f;
      }
      c += dc;
      r += dr;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
    __syncthreads();

    for (int i = 0; i < g.ry; ++i) {
      const int ly = ty + TY * i;
      if (ly >= th) break;
      const int lby = (y0 + ly) * DY - g.py0 - sy0 * UY;  // stuffed row, >= 0
      const int t0y = UY == 2 ? (lby & 1) : 0;
      int row = floor_div<UY>(lby + t0y);
      float acc[RX_MAX];
#pragma unroll
      for (int j = 0; j < RX_MAX; ++j) acc[j] = 0.f;
      for (int kty = t0y; kty < g.kh; kty += UY, ++row) {
        const float* srow = s_in + row * iw + col0;
        const float* krow = s_taps + (g.kh - 1 - kty) * g.kw + (g.kw - 1);
        int cc = 0;
        for (int ktx = t0x; ktx < g.kw; ktx += UX, ++cc) {
          const float kv = krow[-ktx];
#pragma unroll
          for (int j = 0; j < RX_MAX; ++j)
            if (j < jn) acc[j] = fmaf(kv, srow[cc + j * CSTEP], acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < RX_MAX; ++j)
        if (j < jn) s_out[ly * tw_full + tx + TX * j] = vt::from_float<T>(acc[j]);
    }
    __syncthreads();

    for (int i = tid, r = ro_start, c = co_start; i < n_out; i += THREADS) {
      const int off = (y0 + r) * g.ow + x0 + c * vout;
      if (g.vec_out)
        *reinterpret_cast<uint4*>(yp + off) =
            *reinterpret_cast<const uint4*>(s_out + r * tw_full + c * vout);
      else
        yp[off] = s_out[r * tw_full + c];
      c += dco;
      r += dro;
      if (c >= cpo) {
        c -= cpo;
        ++r;
      }
    }
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename T, int UX, int UY, int DX, int DY>
cudaError_t launch_t(const T* x, T* y, const Taps& taps, Geom g,
                     cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const auto smem_bytes = [&](int rx, int ry, int* in_floats) {
    const int iw = ((TX * rx - 1) * DX + g.kw - 1) / UX + 2 + 2 * V;
    const int ih = ((TY * ry - 1) * DY + g.kh - 1) / UY + 2;
    *in_floats = round_up(iw * ih, 4);
    return 4 * (g.taps_floats + *in_floats) + TY * ry * TX * rx * (int)sizeof(T);
  };
  // the narrowest tiles that cover a small plane, then the largest that fit
  // the shared-memory budget (rows go first: they carry no store width)
  int rx = RX_MAX, ry = RY_MAX;
  while (rx > 1 && TX * (rx / 2) >= g.ow) rx /= 2;
  while (ry > 1 && TY * (ry / 2) >= g.oh) ry /= 2;
  int in_floats = 0;
  while (smem_bytes(rx, ry, &in_floats) > SMEM_BUDGET && (rx > 1 || ry > 1)) {
    if (ry > 1) ry /= 2;
    else rx /= 2;
  }
  const int smem = smem_bytes(rx, ry, &in_floats);
  g.rx = rx;
  g.ry = ry;
  g.in_floats = in_floats;
  const int tw = TX * rx, th = TY * ry;
  const dim3 grid((g.ow + tw - 1) / tw, (g.oh + th - 1) / th,
                  g.planes < (int)MAX_GRID_Z ? g.planes : MAX_GRID_Z);
  upfirdn2d_kernel<T, UX, UY, DX, DY><<<grid, dim3(TX, TY), smem, stream>>>(
      x, y, taps, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, void* yv, const Taps& taps, Geom g,
                   int up_x, int up_y, int down_x, int down_y,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  g.vec_in = g.w % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_out = g.ow % V == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  g.taps_floats = round_up(g.kh * g.kw, 4);
  switch ((up_x - 1) * 8 + (up_y - 1) * 4 + (down_x - 1) * 2 + (down_y - 1)) {
#define VT_CASE(UX, UY, DX, DY)                                       \
  case (UX - 1) * 8 + (UY - 1) * 4 + (DX - 1) * 2 + (DY - 1):          \
    return launch_t<T, UX, UY, DX, DY>(x, y, taps, g, stream);
    VT_CASE(1, 1, 1, 1) VT_CASE(1, 1, 1, 2) VT_CASE(1, 1, 2, 1) VT_CASE(1, 1, 2, 2)
    VT_CASE(1, 2, 1, 1) VT_CASE(1, 2, 1, 2) VT_CASE(1, 2, 2, 1) VT_CASE(1, 2, 2, 2)
    VT_CASE(2, 1, 1, 1) VT_CASE(2, 1, 1, 2) VT_CASE(2, 1, 2, 1) VT_CASE(2, 1, 2, 2)
    VT_CASE(2, 2, 1, 1) VT_CASE(2, 2, 1, 2) VT_CASE(2, 2, 2, 1) VT_CASE(2, 2, 2, 2)
#undef VT_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// taps: kh * kw float32 values in host memory, copied into the launch's
// parameters (the kernel never reads them from device memory)
extern "C" int vt_upfirdn2d(const void* x, const float* taps, void* y,
                            int planes, int h, int w, int oh, int ow, int up_x,
                            int up_y, int down_x, int down_y, int pad_x0,
                            int pad_y0, int kh, int kw, int dtype,
                            void* stream) {
  if (kh < 1 || kw < 1 || kh > MAX_TAPS || kw > MAX_TAPS || up_x < 1 ||
      up_x > 2 || up_y < 1 || up_y > 2 || down_x < 1 || down_x > 2 ||
      down_y < 1 || down_y > 2 || oh < 1 || ow < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t = {};
  for (int i = 0; i < kh * kw; ++i) t.k[i] = taps[i];
  Geom g = {};
  g.planes = planes;
  g.h = h;
  g.w = w;
  g.oh = oh;
  g.ow = ow;
  g.px0 = pad_x0;
  g.py0 = pad_y0;
  g.kh = kh;
  g.kw = kw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kFloat32)
    return launch<float>(x, y, t, g, up_x, up_y, down_x, down_y, st);
  if (dtype == vt::kBFloat16)
    return launch<__nv_bfloat16>(x, y, t, g, up_x, up_y, down_x, down_y, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
