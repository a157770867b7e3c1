// B1, bfloat16 path: the styled 3x3 conv as an implicit GEMM on Hopper's
// tensor cores with warp-level mma.sync (m16n8k16, bf16 in, f32 accumulate).
// modconv3x3.cu dispatches bfloat16 calls here; its note has the function,
// the bounds and why float32 stays on the CUDA cores.
//
// GEMM view, per image b:  Y[pixel, o] = sum_{tap, i} X[pixel + tap, i] * W[tap, i, o]
//   M = output pixels: a block owns an 8 x 16 px tile (128 px);
//   N = output channels: a block owns BN of them, BN in {32, 64, 128} picked
//       from Cout (the 1024 px stage has Cout 32, the up convs up to 2048);
//   K = 9 taps x Cin, walked as chunks of BK = 32 input channels; all 9 taps
//       of a chunk read one shared-memory halo.
//
// Per chunk a block holds, in shared memory, two stages of:
//   * the input halo, (8+2) x (16+2) px x 32 channels, channel-minor: pixel p,
//     channel k at xs[p * 40 + k]. The 40-element (80-byte) pixel stride puts
//     the 8 rows of each ldmatrix phase on 8 distinct 16-byte bank groups.
//     The NCHW global load runs along W (neighbouring threads, neighbouring
//     pixels of one channel pair), is modulated by s in float32 and rounded
//     once to bf16, and is transposed on its way into shared memory.
//   * the weight slab, [tap][k][n] with rows of BN + 8 elements (row stride =
//     16 bytes mod 128: conflict-free ldmatrix.trans), copied with 16-byte
//     cp.async when Cout % 8 == 0 (zero-filled past Cin/Cout), else element
//     by element.
// Pipeline: chunk c+1's weights go out as cp.async and its halo into
// registers before chunk c is multiplied; the halo registers are stored to the
// other stage after the multiply. One __syncthreads per chunk.
//
// Warps: 8 (256 threads) as 4 (M) x 2 (N). Warp (wm, wn) owns output rows
// 2wm, 2wm+1 of the tile (one m16 fragment each: 16 pixels of a row) and
// channels wn*BN/2 .. +BN/2 (BN/16 n8 fragments): 2 x BN/16 mma per k16 step
// and 2 x BN/16 x 4 f32 accumulators a thread (64 at BN = 128).
// Fragments: A (16 px x 16 k) by one ldmatrix.x4 at halo pixel
// (row + dy, lane%16 + dx), k offset 8*(lane/16) -- a tap is an address
// offset into the halo, never a new load; B (16 k x 16 n, two n8 fragments)
// by one ldmatrix.x4.trans at weight row tap*32 + k + lane%16, n offset
// 8*(lane/16).
// Epilogue: d, bias, leaky-ReLU and gain on the f32 accumulators, one bf16
// rounding, the tile staged through shared memory as [n][128 px] so each
// channel's 16-px rows go to the NCHW output as two 16-byte stores (where
// W % 8 == 0; else one element at a time). Ragged H, W, Cin and Cout: masked
// loads give zeros, stores are masked; no shape constraint beyond Cin,
// Cout >= 1.
//
// Occupancy: ptxas gives every BN 226-254 registers a thread, so one block
// (8 warps) runs on an SM; capping at 128 for two blocks spills and is
// slower. Grid (tiles x Cout/BN) at the ten batch-1 serving shapes, against
// 132 SMs: 64 px 512->512: 32 x 4 = 128; 128 px 256->256: 128 x 2 = 256;
// 256 px 128->128: 512; 512 px 64->64 (BN 64): 2048; 1024 px 32->32
// (BN 32): 8192; up convs 32 px 512->2048: 8 x 16 = 128; 64 px 512->1024:
// 32 x 8 = 256; 128 px 256->512: 512; 256 px 128->256: 1024; 512 px
// 64->128: 2048.
#include "common.cuh"

namespace {

constexpr int TH = 8;                      // output rows per block
constexpr int TW = 16;                     // output columns per block (one m16 fragment)
constexpr int BK = 32;                     // input channels per chunk
constexpr int HW = TW + 2;                 // halo columns
constexpr int HALO = (TH + 2) * HW;        // halo pixels (180)
constexpr int XP = BK + 8;                 // halo pixel stride in elements (80 bytes)
constexpr int XS_STAGE = HALO * XP;        // elements of one halo stage
constexpr int X_PAIRS = BK / 2 * HALO;     // channel pairs x halo pixels per chunk
constexpr int THREADS = 256;
constexpr int X_ITEMS = (X_PAIRS + THREADS - 1) / THREADS;  // per thread (12)
constexpr int OP = TH * TW + 8;            // output staging row stride (elements)

template <int BN>
struct Tile {
  static constexpr int WP = BN + 8;             // weight row stride (elements)
  static constexpr int WS_STAGE = 9 * BK * WP;  // elements of one weight stage
  static constexpr int NI = BN / 16;            // n8 fragments per warp
  static constexpr int SMEM = 2 * (XS_STAGE + WS_STAGE) * 2;  // bytes
  static_assert(BN * OP <= 2 * WS_STAGE, "output tile must fit the weight stages");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
modconv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ s,
                      const __nv_bfloat16* __restrict__ d,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, int cin, int cout, int h,
                      int wd, int tiles_w, int vec_w, float slope, float gain) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][HALO][XP]
  __nv_bfloat16* ws = xs + 2 * XS_STAGE;                        // [2][9*BK][WP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 1;  // warp's output rows 2wm, 2wm+1
  const int wn = (tid >> 5) & 1;   // warp's channel half
  const int oy0 = (blockIdx.x / tiles_w) * TH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const size_t plane = (size_t)h * wd;
  const __nv_bfloat16* xb = x + (size_t)b * cin * plane;
  const __nv_bfloat16* sb = s != nullptr ? s + (size_t)b * cin : nullptr;
  const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
  const int nchunks = (cin + BK - 1) / BK;

  // weight slab of chunk c -> stage st (async when vec_w)
  auto load_w = [&](int c, int st) {
    __nv_bfloat16* dst = ws + st * T::WS_STAGE;
    const int c0 = c * BK;
    if (vec_w) {
      constexpr int VPR = BN / 8;  // 16-byte vectors per row
      for (int i = tid; i < 9 * BK * VPR; i += THREADS) {
        const int row = i / VPR, v = i % VPR;
        const int k = c0 + row % BK, n = co0 + v * 8;
        const bool ok = k < cin && n < cout;
        const __nv_bfloat16* src =
            ok ? w + ((size_t)(row / BK) * cin + k) * cout + n : w;
        cp_async16(dst + row * T::WP + v * 8, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < 9 * BK * BN; i += THREADS) {
        const int row = i / BN, n = i % BN;
        const int k = c0 + row % BK;
        dst[row * T::WP + n] =
            k < cin && co0 + n < cout
                ? w[((size_t)(row / BK) * cin + k) * cout + co0 + n]
                : zero;
      }
    }
  };

  // halo of chunk c -> registers (raw bf16, two channels per item)
  __nv_bfloat16 xr[X_ITEMS][2];
  auto load_x = [&](int c) {
    const int c0 = c * BK;
#pragma unroll
    for (int j = 0; j < X_ITEMS; ++j) {
      const int i = tid + j * THREADS;
      const int ch = c0 + 2 * (i / HALO), hp = i % HALO;
      const int iy = oy0 + hp / HW - 1, ix = ox0 + hp % HW - 1;
      xr[j][0] = xr[j][1] = zero;
      if (i < X_PAIRS && iy >= 0 && iy < h && ix >= 0 && ix < wd) {
        const __nv_bfloat16* p = xb + (size_t)ch * plane + (size_t)iy * wd + ix;
        if (ch < cin) xr[j][0] = p[0];
        if (ch + 1 < cin) xr[j][1] = p[plane];
      }
    }
  };
  // registers -> halo stage st, modulated by s and rounded once to bf16
  auto store_x = [&](int c, int st) {
    __nv_bfloat16* dst = xs + st * XS_STAGE;
    const int c0 = c * BK;
#pragma unroll
    for (int j = 0; j < X_ITEMS; ++j) {
      const int i = tid + j * THREADS;
      if (i < X_PAIRS) {
        const int cp = i / HALO, hp = i % HALO;
        __nv_bfloat162 v;
        if (sb != nullptr) {
          const int ch = c0 + 2 * cp;
          const float s0 = ch < cin ? __bfloat162float(sb[ch]) : 0.f;
          const float s1 = ch + 1 < cin ? __bfloat162float(sb[ch + 1]) : 0.f;
          v = __floats2bfloat162_rn(__bfloat162float(xr[j][0]) * s0,
                                    __bfloat162float(xr[j][1]) * s1);
        } else {
          v.x = xr[j][0];
          v.y = xr[j][1];
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + hp * XP + 2 * cp) = v;
      }
    }
  };

  float acc[2][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto multiply = [&](int st) {
    const __nv_bfloat16* xsb = xs + st * XS_STAGE;
    const __nv_bfloat16* wsb = ws + st * T::WS_STAGE;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], xsb + ((wm * 2 + mi + dy) * HW + (lane & 15) + dx) * XP
                                 + kk + (lane >> 4) * 8);
        uint32_t bf[T::NI][2];
#pragma unroll
        for (int nj = 0; nj < T::NI / 2; ++nj)
          ldmatrix_x4_trans(bf[2 * nj][0], bf[2 * nj][1], bf[2 * nj + 1][0],
                            bf[2 * nj + 1][1],
                            wsb + (tap * BK + kk + (lane & 15)) * T::WP
                                + wn * (BN / 2) + nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < T::NI; ++ni)
            mma_bf16(acc[mi][ni], a[mi], bf[ni][0], bf[ni][1]);
      }
    }
  };

  load_w(0, 0);
  load_x(0);
  store_x(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int st = c & 1;
    const bool more = c + 1 < nchunks;
    cp_async_wait_all();
    __syncthreads();  // stage st complete; every warp is done with stage st^1
    if (more) {
      load_w(c + 1, st ^ 1);
      load_x(c + 1);
    }
    multiply(st);
    if (more) store_x(c + 1, st ^ 1);
  }
  __syncthreads();  // every warp is done with the weights: reuse them as the output tile

  // epilogue: accumulator c[2*half + e] is pixel g + 8*half, channel 2*t4 + e
  __nv_bfloat16* os = ws;  // [BN][OP]
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = wn * (BN / 2) + ni * 8 + 2 * t4 + e;
      const int co = co0 + n;
      float dm = 1.f, bv = 0.f;
      if (co < cout) {
        if (d != nullptr) dm = __bfloat162float(d[(size_t)b * cout + co]);
        if (bias != nullptr) bv = __bfloat162float(bias[co]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = acc[mi][ni][2 * half + e] * dm;
          if (bias != nullptr) v = vt::leaky_relu_gain(v + bv, slope, gain);
          os[n * OP + (wm * 2 + mi) * TW + g + 8 * half] = __float2bfloat16_rn(v);
        }
    }
  }
  __syncthreads();
  // 8 px (16 bytes) a thread where W % 8 == 0 keeps them aligned, else 1 px
  const bool vec_y = wd % 8 == 0;
  for (int i = tid; i < BN * TH * TW / 8; i += THREADS) {
    const int n = i / (TH * TW / 8), p = i % (TH * TW / 8) * 8;
    const int oy = oy0 + p / TW, ox = ox0 + p % TW, co = co0 + n;
    if (co >= cout || oy >= h) continue;
    __nv_bfloat16* dst = y + ((size_t)b * cout + co) * plane + (size_t)oy * wd + ox;
    if (vec_y && ox + 8 <= wd) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(os + n * OP + p);
    } else {
      for (int j = 0; j < 8 && ox + j < wd; ++j) dst[j] = os[n * OP + p + j];
    }
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* s, const void* d,
                   const void* bias, void* y, int b, int cin, int cout, int h,
                   int wd, float slope, float gain, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      modconv3x3_mma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_w = (wd + TW - 1) / TW;
  const int tiles_h = (h + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (cout + BN - 1) / BN, b);
  const int vec_w = cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  modconv3x3_mma_kernel<BN><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y),
      cin, cout, h, wd, tiles_w, vec_w, slope, gain);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 x, w, s, d, bias and y; float32 accumulation. Returns cudaError_t.
extern "C" int vt_modconv3x3_mma(const void* x, const void* w, const void* s,
                                 const void* d, const void* bias, void* y,
                                 int b, int cin, int cout, int h, int wd,
                                 float slope, float gain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cout <= 32)
    return launch<32>(x, w, s, d, bias, y, b, cin, cout, h, wd, slope, gain, st);
  if (cout <= 64)
    return launch<64>(x, w, s, d, bias, y, b, cin, cout, h, wd, slope, gain, st);
  return launch<128>(x, w, s, d, bias, y, b, cin, cout, h, wd, slope, gain, st);
}
