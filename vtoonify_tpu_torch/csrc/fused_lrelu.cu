// B2: fused bias + leaky-ReLU x gain.
//
//   y[n, c, i] = leaky_relu(x[n, c, i] + bias[c], slope) * gain
//
// Replaces fused_leaky_relu_pallas / _fused_lrelu_kernel
// (vtoonify_tpu/ops/pallas_kernels.py:44, :37). The tensor is viewed as
// (outer, C, inner): inner = H*W for NCHW activations, inner = 1 for the
// (N, C) outputs of the style MLPs. bias may be null (no bias add).
//
// What bounds it on the H100: one read and one write per element and one
// bias value per channel, so device-memory bandwidth (3.35 TB/s): the train
// step's largest calls, (2, 32, 1024, 1024) and (2, 64, 512, 512) in bf16,
// move 134 MB and 67 MB each way. The first version ran a flat grid-stride
// loop with a 64-bit (i / inner) % C per element and 2-byte accesses, too
// many instructions per byte for that bound. The design:
// * NCHW form (inner > 1): a 2-D grid, chunks of a plane x planes n*C + c
//   (planes above 65535 fold into a loop). Each thread reads bias[c] once
//   per plane into a register; offsets inside a plane are 32-bit.
// * (N, C) form (inner == 1): a flat 1-D grid over the tensor (fewer than
//   2^31 elements), the channel i % C in 32 bits.
// * Accesses are 16 bytes (8 bf16 or 4 float32 values) where a row of the
//   view (inner, or C for the (N, C) form) is a multiple of 16 bytes and the
//   pointers are aligned; the (N, C) form then loads its bias as a vector
//   too. Otherwise each access is one element. Each thread issues UNROLL
//   accesses, all loads before any store.
// Computes in float32, loads and stores the caller's dtype.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 4;
constexpr unsigned MAX_GRID_Y = 65535;

// an element's bits (B) and their float32 value
template <typename T> struct Raw;
template <> struct Raw<float> {
  using B = float;
  static __device__ __forceinline__ float f(B b) { return b; }
  static __device__ __forceinline__ B r(float v) { return v; }
};
template <> struct Raw<__nv_bfloat16> {
  using B = unsigned short;
  static __device__ __forceinline__ float f(B b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  static __device__ __forceinline__ B r(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// E elements of T as one access: 16 bytes, or one element
template <typename T, bool VEC>
struct Access {
  using B = typename Raw<T>::B;
  static constexpr int E = VEC ? 16 / sizeof(T) : 1;
  using W = typename std::conditional<VEC, uint4, B>::type;
  union U {
    W w;
    B e[E];
  };
  static __device__ __forceinline__ U load(const T* p) {
    U u;
    u.w = __ldg(reinterpret_cast<const W*>(p));
    return u;
  }
  static __device__ __forceinline__ void store(T* p, const U& u) {
    *reinterpret_cast<W*>(p) = u.w;
  }
  // leaky_relu(v + b) * gain on element e, in place
  static __device__ __forceinline__ void apply(U& u, int e, float b,
                                               float slope, float gain) {
    u.e[e] = Raw<T>::r(vt::leaky_relu_gain(Raw<T>::f(u.e[e]) + b, slope, gain));
  }
};

// NCHW form: plane p = n*C + c holds `inner` elements (accesses of E)
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
lrelu_planes_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                    T* __restrict__ y, int planes, int c, int inner,
                    float slope, float gain) {
  using A = Access<T, VEC>;
  const int n_acc = inner / A::E;
  const int a0 = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  if (a0 >= n_acc) return;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const float b = bias != nullptr ? vt::ldg_float(bias + p % c) : 0.f;
    const T* xs = x + (size_t)p * inner;
    T* ys = y + (size_t)p * inner;
    typename A::U u[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int a = a0 + k * THREADS;
      if (a < n_acc) u[k] = A::load(xs + a * A::E);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int a = a0 + k * THREADS;
      if (a >= n_acc) break;
#pragma unroll
      for (int e = 0; e < A::E; ++e) A::apply(u[k], e, b, slope, gain);
      A::store(ys + a * A::E, u[k]);
    }
  }
}

// (N, C) form: `total` elements, the channel of element i is i % C
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
lrelu_rows_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                  T* __restrict__ y, int total, int c, float slope,
                  float gain) {
  using A = Access<T, VEC>;
  const int n_acc = total / A::E;
  const int a0 = blockIdx.x * (THREADS * UNROLL) + threadIdx.x;
  typename A::U u[UNROLL], bu[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int a = a0 + k * THREADS;
    if (a < n_acc) {
      u[k] = A::load(x + a * A::E);
      if (bias != nullptr) bu[k] = A::load(bias + (a * A::E) % c);
    }
  }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int a = a0 + k * THREADS;
    if (a >= n_acc) break;
#pragma unroll
    for (int e = 0; e < A::E; ++e)
      A::apply(u[k], e, bias != nullptr ? Raw<T>::f(bu[k].e[e]) : 0.f, slope,
               gain);
    A::store(y + a * A::E, u[k]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* xv, const void* bv, void* yv, long long total,
                   int c, long long inner, float slope, float gain,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* bias = static_cast<const T*>(bv);
  T* y = static_cast<T*>(yv);
  constexpr int E = 16 / sizeof(T);
  constexpr int PER_BLOCK = THREADS * UNROLL;  // accesses per block
  if (inner == 1) {  // (N, C) form: vectors may not straddle a row
    const bool vec = c % E == 0 && aligned16(x) && aligned16(y) &&
                     (bias == nullptr || aligned16(bias));
    const long long n_acc = vec ? total / E : total;
    const unsigned blocks = (unsigned)((n_acc + PER_BLOCK - 1) / PER_BLOCK);
    if (vec)
      lrelu_rows_kernel<T, true><<<blocks, THREADS, 0, stream>>>(
          x, bias, y, (int)total, c, slope, gain);
    else
      lrelu_rows_kernel<T, false><<<blocks, THREADS, 0, stream>>>(
          x, bias, y, (int)total, c, slope, gain);
    return cudaGetLastError();
  }
  const long long planes = total / inner;
  const bool vec = inner % E == 0 && aligned16(x) && aligned16(y);
  const long long n_acc = vec ? inner / E : inner;
  const dim3 grid((unsigned)((n_acc + PER_BLOCK - 1) / PER_BLOCK),
                  (unsigned)(planes < MAX_GRID_Y ? planes : MAX_GRID_Y));
  if (vec)
    lrelu_planes_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        x, bias, y, (int)planes, c, (int)inner, slope, gain);
  else
    lrelu_planes_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        x, bias, y, (int)planes, c, (int)inner, slope, gain);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vt_fused_lrelu(const void* x, const void* bias, void* y,
                              long long total, int c, long long inner,
                              float slope, float gain, int dtype,
                              void* stream) {
  // 32-bit offsets inside a plane ((N, C) form: inside the tensor), 32-bit
  // plane count
  if (total < 1 || c < 1 || inner < 1 || total % inner ||
      (inner == 1 ? total : inner) >= (1LL << 31) ||
      total / inner >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kFloat32)
    return launch<float>(x, bias, y, total, c, inner, slope, gain, st);
  if (dtype == vt::kBFloat16)
    return launch<__nv_bfloat16>(x, bias, y, total, c, inner, slope, gain, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
