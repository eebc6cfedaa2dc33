// Shared pieces of the correlation kernels (corr.cu, corr_exp.cu):
// window geometry and the pyramid level table. Included once per
// translation unit; everything is internal to it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {


constexpr int RADIUS = 3;
constexpr int WIN = 2 * RADIUS + 1;   // 7
constexpr int PATCH = WIN + 1;        // 8
constexpr int TAPS = WIN * WIN;       // 49
constexpr int MAX_LEVELS = 4;

struct Levels {
  int n;
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int off[MAX_LEVELS];
};

Levels make_levels(int n, const int* hw) {
  Levels lv;
  lv.n = n;
  int acc = 0;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.h[l] = l < n ? hw[2 * l] : 0;
    lv.w[l] = l < n ? hw[2 * l + 1] : 0;
    lv.off[l] = acc;
    acc += lv.h[l] * lv.w[l];
  }
  return lv;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Window origin and fractions of one pixel at level l. Origins are kept
// in float so NaN or huge coordinates give out-of-range taps instead of
// an overflowing integer conversion; a NaN fraction still propagates to
// the output, as in the plain version.
struct Window {
  float bx, by, fx, fy;
};

__device__ __forceinline__ Window window_at(const float* c, int l) {
  const float s = 1.0f / float(1 << l);
  const float x = c[0] * s, y = c[1] * s;
  const float x0 = floorf(x), y0 = floorf(y);
  return {x0 - RADIUS, y0 - RADIUS, x - x0, y - y0};
}

__device__ __forceinline__ bool tap_ok(float p, int n) {
  return p >= 0.0f && p < float(n);
}

}  // namespace
