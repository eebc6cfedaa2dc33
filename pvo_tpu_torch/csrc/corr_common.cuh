// Shared pieces of the correlation kernels (corr.cu, corr_exp.cu):
// window geometry, the pyramid level table and the loads of a patch row
// from K1's volume. Included once per
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

// Patch row r (8 taps) of a pixel's window wn at one level, read from the
// pixel's row of K1's volume (vol_row, N2 values: the row stride, a
// multiple of 64, so every aligned vector lies inside the row) into v,
// zero outside the level: K2's and P2's loads. The taps are 16
// contiguous bytes at any 2-byte offset: the lane loads the two aligned
// 16-byte vectors that cover them, parks them in its own 32 bytes of
// shared memory (slot) and picks its taps from there. (Every fourth
// lane's slot lies on the same banks; a slot of a word per bank and
// lane, filled by eight 4-byte stores, measured 2% slower in P2 and 8%
// in K2 on an H100.) off, H, W: the level's first column and its shape.
__device__ __forceinline__ void patch_row(float (&v)[PATCH], uint4 (&slot)[2],
                                          const __nv_bfloat16* vol_row,
                                          int N2, const Window& wn, int r,
                                          bool live, int off, int H, int W) {
  bool row_ok = false;
  int shift = 0;
  if (live) {
    const float yy = wn.by + r;
    // the row holds a tap of the level (false for NaN and huge origins)
    row_ok = tap_ok(yy, H) && wn.bx + (PATCH - 1) >= 0.0f &&
             wn.bx < float(W);
    if (row_ok) {
      const int idx = off + (int)yy * W + (int)wn.bx;
      const int a0 = min(max(idx, 0) & ~7, N2 - 16);
      const uint4* src = reinterpret_cast<const uint4*>(vol_row + a0);
      slot[0] = __ldg(src);
      slot[1] = __ldg(src + 1);
      shift = idx - a0;  // a tap inside the level lands in 0..15
    }
  }
  const __nv_bfloat16* wv = reinterpret_cast<const __nv_bfloat16*>(slot);
#pragma unroll
  for (int dx = 0; dx < PATCH; ++dx) {
    const float xx = wn.bx + dx;
    v[dx] = (row_ok && tap_ok(xx, W)) ? __bfloat162float(wv[shift + dx])
                                      : 0.0f;
  }
}

}  // namespace
