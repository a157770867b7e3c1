// Host-side frame I/O for the video engine and the packed output (from
// vtoonify_tpu/native/frameio.cpp). Single passes over the pixels:
//   * rgb<->bgr for the video reader and the writer thread
//   * the depth-to-space finish of the packed output, fused with rgb->bgr
//
// C ABI for ctypes; no OpenMP, vectorizable loops (-O3). Built with g++ by
// vtoonify_tpu_torch/native/__init__.py at first use.

#include <cstdint>
#include <cstring>

extern "C" {

// RGB <-> BGR copy (either way round).
void rgb_to_bgr(const uint8_t* src, uint8_t* dst, int64_t npix) {
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = src + i * 3;
    uint8_t* q = dst + i * 3;
    q[0] = p[2];
    q[1] = p[1];
    q[2] = p[0];
  }
}

// Space-to-depth packed (h, w, 4*c) phase-major uint8 → (2h, 2w, c), the
// final depth-to-space of the packed synthesis tail (nn/layers.py
// depth_to_space2) finished host-side as a pure byte permutation — fused
// with the writer's RGB→BGR swizzle when swap_bgr != 0 (c must be 3 then).
void depth_to_space2_u8(const uint8_t* src, uint8_t* dst, int64_t h,
                        int64_t w, int64_t c, int64_t swap_bgr) {
  const int64_t row_out = 2 * w * c;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* s = src + y * w * 4 * c;
    uint8_t* d0 = dst + (2 * y) * row_out;
    uint8_t* d1 = d0 + row_out;
    if (swap_bgr && c == 3) {
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* p = s + x * 12;
        uint8_t* q0 = d0 + x * 6;
        uint8_t* q1 = d1 + x * 6;
        // phases: (py,px) = (0,0),(0,1),(1,0),(1,1) at channel blocks 0..3
        q0[0] = p[2];  q0[1] = p[1];  q0[2] = p[0];
        q0[3] = p[5];  q0[4] = p[4];  q0[5] = p[3];
        q1[0] = p[8];  q1[1] = p[7];  q1[2] = p[6];
        q1[3] = p[11]; q1[4] = p[10]; q1[5] = p[9];
      }
    } else {
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* p = s + x * 4 * c;
        std::memcpy(d0 + x * 2 * c, p, 2 * c);
        std::memcpy(d1 + x * 2 * c, p + 2 * c, 2 * c);
      }
    }
  }
}

}  // extern "C"
