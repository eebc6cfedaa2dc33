// Packed-layout correlation kernels, hand-written for Hopper (sm_90a):
// the counterparts of the JAX package's corr experiment harnesses
// (scripts/corr_exp{,2,3,4,5}.py). Plain C interface, loaded with ctypes
// by pvo_tpu_torch/vo/net/cuda_corr_exp.py, which also holds the plain
// PyTorch version of each kernel and the notes on what bounds it.
//
//   P1 pvo_corr_lookup_packed   correlation against the pooled f2
//                               pyramid + 8x8 windowed lookup, no stored
//                               volume (X1).
//   P2 pvo_corr_extract_packed  8x8 windowed lookup from K1's volume
//                               (X2-X5), with X3's diagnostic modes.
//
// Layouts (row-major, contiguous):
//   f1      (E, HW, C)      float or bf16
//   pyr     (E, N2, C)      float; level l holds H_l*W_l rows from row
//                           off_l (cuda_corr.pool_pyramid)
//   vol     (E, HW, N2)     bf16 (K1, pvo_build_volumes)
//   coords  (E, HW, 2)      float, level-0 [x, y]
//   out     (E, HW, L*64)   bf16 packed taps. Tap (dy, dx) of level l,
//                           at (floor(y_l) - 3 + dy, floor(x_l) - 3 + dx),
//                           goes to channel l*64 + dy*8 + dx (level-major)
//                           or dy*(L*8) + l*8 + dx (dy-major, P1 only).
//                           Pad taps (dy == 7 or dx == 7) are 0.
//
// The bilinear blend runs rows first, as the one-hot products of the
// harnesses do: t = wy0*p[dy] + wy1*p[dy+1] per column, then
// out = wx0*t[dx] + wx1*t[dx+1]. Products and sums are rounded
// separately (no fused multiply-add), as the plain versions round them.
// Every entry launches on the given stream, does not synchronise and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "corr_common.cuh"

namespace {

constexpr int PTAPS = PATCH * PATCH;  // 64 packed taps per level
constexpr int LANE = 128;             // the TPU lane width X3's modes use
constexpr int SHIFT = PATCH;          // pallas_corr.SHIFT

// How the bilinear weights (w0, w1) = (1 - f, f) are rounded.
enum WeightMode {
  W_F32 = 0,    // not rounded
  W_ROUND = 1,  // both rounded to bf16 (f32 selectors cast to bf16)
  W_BF16 = 2,   // f rounded to bf16, then 1 - f rounded (bf16 selectors)
};

// X3's modes; the channels a TPU mode leaves unwritten are written as 0.
enum ExtractMode {
  M_FULL = 0,     // the packed extraction
  M_NOSTORE = 1,  // only the dy = 0 row of each level
  M_NOVAB = 2,    // channels 0-127: last level's dx = 0 selector row +
                  // A_y[0, 0] + row 0 of its correlation plane
  M_DMA = 3,      // channels 0-127: last level's per-column sums
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <int WM>
__device__ __forceinline__ void weights(float f, float& w0, float& w1) {
  if (WM == W_BF16) {
    w1 = bf16_round(f);
    w0 = bf16_round(1.0f - w1);
  } else if (WM == W_ROUND) {
    w0 = bf16_round(1.0f - f);
    w1 = bf16_round(f);
  } else {
    w0 = 1.0f - f;
    w1 = f;
  }
}

__device__ __forceinline__ float lerp2(float w0, float a, float w1,
                                       float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// ---------------------------------------------------------------- P1
// One block = 4 query pixels x 64 taps (K3's structure). Per level, each
// thread takes the length-C dot product of its pixel's f1 row (staged in
// shared memory as f32) with the pooled f2 row under its tap (zero out
// of range) into a shared 8x8 patch; then each thread blends and stores
// one packed tap. BF16 rounds the correlation, the weights and the row
// blend to bf16 (X1's seldt="bf16").
constexpr int P1_PIX = 4;
constexpr int P1_THREADS = P1_PIX * PTAPS;  // 256

template <typename T1, bool DYMAJOR, bool BF16>
__global__ void __launch_bounds__(P1_THREADS)
corr_lookup_packed_kernel(const T1* __restrict__ f1,
                          const float* __restrict__ pyr,
                          const float* __restrict__ coords,
                          __nv_bfloat16* __restrict__ out, int HW,
                          int n_pix, int N2, int C, float scale,
                          Levels lv) {
  extern __shared__ __align__(16) float smem[];
  float* f1s = smem;                       // [4][C]
  float* patch = smem + P1_PIX * C;        // [4][64]
  constexpr int WM = BF16 ? W_BF16 : W_F32;

  const int pl = threadIdx.x / PTAPS;
  const int tap = threadIdx.x % PTAPS;
  const int pix = blockIdx.x * P1_PIX + pl;
  const bool live = pix < n_pix;

  for (int i = threadIdx.x; i < P1_PIX * C; i += P1_THREADS) {
    const int p = blockIdx.x * P1_PIX + i / C;
    f1s[i] = p < n_pix ? to_f32(f1[(size_t)p * C + i % C]) : 0.0f;
  }
  __syncthreads();

  const int e = live ? pix / HW : 0;
  const float* a = f1s + pl * C;
  float* pt = patch + pl * PTAPS;
  const int ty = tap / PATCH, tx = tap % PATCH;
  const int n_ch = lv.n * PTAPS;

  for (int l = 0; l < lv.n; ++l) {
    Window wn = {0.f, 0.f, 0.f, 0.f};
    float val = 0.0f;
    if (live) {
      wn = window_at(coords + (size_t)pix * 2, l);
      const float yy = wn.by + ty, xx = wn.bx + tx;
      if (tap_ok(yy, lv.h[l]) && tap_ok(xx, lv.w[l])) {
        const float* b = pyr + ((size_t)e * N2 + lv.off[l] +
                                (int)yy * lv.w[l] + (int)xx) * C;
        float s = 0.0f;
        int c = 0;
        if ((C & 3) == 0) {
          for (; c < C; c += 4) {
            const float4 bv = *reinterpret_cast<const float4*>(b + c);
            const float4 av = *reinterpret_cast<const float4*>(a + c);
            s = fmaf(av.x, bv.x, s);
            s = fmaf(av.y, bv.y, s);
            s = fmaf(av.z, bv.z, s);
            s = fmaf(av.w, bv.w, s);
          }
        }
        for (; c < C; ++c) s = fmaf(a[c], b[c], s);
        val = s * scale;
      }
    }
    pt[tap] = BF16 ? bf16_round(val) : val;
    __syncthreads();
    if (live) {
      float o = 0.0f;
      if (ty < WIN && tx < WIN) {
        float wy0, wy1, wx0, wx1;
        weights<WM>(wn.fy, wy0, wy1);
        weights<WM>(wn.fx, wx0, wx1);
        const int q = ty * PATCH + tx;
        float t0 = lerp2(wy0, pt[q], wy1, pt[q + PATCH]);
        float t1 = lerp2(wy0, pt[q + 1], wy1, pt[q + PATCH + 1]);
        if (BF16) {
          t0 = bf16_round(t0);
          t1 = bf16_round(t1);
        }
        o = lerp2(wx0, t0, wx1, t1);
      }
      const int ch = DYMAJOR ? ty * (lv.n * PATCH) + l * PATCH + tx
                             : l * PTAPS + tap;
      out[(size_t)pix * n_ch + ch] = __float2bfloat16(o);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- P2
// FULL / NOSTORE: one warp per query pixel, lane = level * 8 + patch row
// (K2's structure). Each lane reads its 8 patch values of one row of the
// level's volume slice (zero outside the level), takes the row below
// from the next lane by a shuffle, blends, and stores its 8 packed taps
// (row dy = lane % 8, dy == 7 all zero) as one 16-byte store.
// NOVAB / DMA: the warp's lanes cover columns 0-127 of the last level,
// four columns each, and zero the rest of the pixel's channels.
constexpr int P2_PIX = 4;

template <int MODE, int WM, bool MID>
__global__ void __launch_bounds__(32 * P2_PIX)
corr_extract_packed_kernel(const __nv_bfloat16* __restrict__ vol,
                           const float* __restrict__ coords,
                           __nv_bfloat16* __restrict__ out, int n_pix,
                           int N2, Levels lv) {
  const int pix = blockIdx.x * P2_PIX + threadIdx.x / 32;
  if (pix >= n_pix) return;  // whole warp leaves together
  const int lane = threadIdx.x % 32;
  const int n_ch = lv.n * PTAPS;
  __nv_bfloat16* o_pix = out + (size_t)pix * n_ch;

  if (MODE == M_FULL || MODE == M_NOSTORE) {
    const int l = lane / PATCH, r = lane % PATCH;
    const bool live = l < lv.n;
    const int ll = live ? l : 0;

    const Window wn = window_at(coords + (size_t)pix * 2, ll);
    const int H = lv.h[ll], W = lv.w[ll];
    const float yy = wn.by + r;
    const bool row_ok = live && tap_ok(yy, H);
    const __nv_bfloat16* row =
        vol + (size_t)pix * N2 + lv.off[ll] + (row_ok ? (int)yy * W : 0);

    float v[PATCH];
#pragma unroll
    for (int dx = 0; dx < PATCH; ++dx) {
      const float xx = wn.bx + dx;
      v[dx] = (row_ok && tap_ok(xx, W)) ? __bfloat162float(row[(int)xx])
                                        : 0.0f;
    }
    float vn[PATCH];
#pragma unroll
    for (int dx = 0; dx < PATCH; ++dx)
      vn[dx] = __shfl_down_sync(0xffffffffu, v[dx], 1, PATCH);
    if (!live) return;

    __align__(16) __nv_bfloat16 o[PATCH];
#pragma unroll
    for (int dx = 0; dx < PATCH; ++dx) o[dx] = __float2bfloat16(0.0f);
    if (r < WIN && (MODE == M_FULL || r == 0)) {
      float wy0, wy1, wx0, wx1;
      weights<WM>(wn.fy, wy0, wy1);
      weights<WM>(wn.fx, wx0, wx1);
      float t[PATCH];
#pragma unroll
      for (int j = 0; j < PATCH; ++j) {
        t[j] = lerp2(wy0, v[j], wy1, vn[j]);
        if (MID) t[j] = bf16_round(t[j]);
      }
#pragma unroll
      for (int dx = 0; dx < WIN; ++dx)
        o[dx] = __float2bfloat16(lerp2(wx0, t[dx], wx1, t[dx + 1]));
    }
    *reinterpret_cast<uint4*>(o_pix + l * PTAPS + r * PATCH) =
        *reinterpret_cast<const uint4*>(o);
    return;
  }

  // NOVAB / DMA on the last level
  const int l = lv.n - 1;
  const Window wn = window_at(coords + (size_t)pix * 2, l);
  const int H = lv.h[l], W = lv.w[l];
  const __nv_bfloat16* lev = vol + (size_t)pix * N2 + lv.off[l];
  float wx0, wx1, wy0, wy1;
  weights<WM>(wn.fx, wx0, wx1);
  weights<WM>(wn.fy, wy0, wy1);
  // two-hot lanes of the selectors: p0 = floor(.) - RADIUS + SHIFT
  const float px = wn.bx + SHIFT, py = wn.by + SHIFT;
  const float ay = (py == float(SHIFT) ? wy0 : 0.0f) +
                   (py + 1.0f == float(SHIFT) ? wy1 : 0.0f);
  for (int j = lane; j < n_ch; j += 32) {
    float s = 0.0f;
    if (j < LANE) {
      if (MODE == M_DMA) {
        if (j < W)
          for (int r = 0; r < H; ++r) s += __bfloat162float(lev[r * W + j]);
      } else {
        // B_x[dx = 0, j] = Q[(j + SHIFT) mod LANE]: the shift bank's lane
        // wrap, taken from the TPU selectors as they are
        const float i = float((j + SHIFT) % LANE);
        const float bx = (i == px ? wx0 : 0.0f) + (i == px + 1.0f ? wx1 : 0.0f);
        const float c = (j < W && H > 0) ? __bfloat162float(lev[j]) : 0.0f;
        s = __fadd_rn(__fadd_rn(bx, ay), c);
      }
    }
    o_pix[j] = __float2bfloat16(s);
  }
}

template <int MODE, int WM, bool MID>
int launch_extract(const void* vol, const void* coords, void* out,
                   int n_pix, int N2, const Levels& lv, cudaStream_t s) {
  const int blocks = (n_pix + P2_PIX - 1) / P2_PIX;
  corr_extract_packed_kernel<MODE, WM, MID><<<blocks, 32 * P2_PIX, 0, s>>>(
      static_cast<const __nv_bfloat16*>(vol),
      static_cast<const float*>(coords), static_cast<__nv_bfloat16*>(out),
      n_pix, N2, lv);
  return (int)cudaGetLastError();
}

template <int MODE>
int extract_mode(int wmode, int mid, const void* vol, const void* coords,
                 void* out, int n_pix, int N2, const Levels& lv,
                 cudaStream_t s) {
#define PVO_EXTRACT(WM)                                                   \
  return mid ? launch_extract<MODE, WM, true>(vol, coords, out, n_pix, N2, \
                                              lv, s)                      \
             : launch_extract<MODE, WM, false>(vol, coords, out, n_pix,   \
                                               N2, lv, s)
  switch (wmode) {
    case W_F32: PVO_EXTRACT(W_F32);
    case W_ROUND: PVO_EXTRACT(W_ROUND);
    case W_BF16: PVO_EXTRACT(W_BF16);
  }
#undef PVO_EXTRACT
  return (int)cudaErrorInvalidValue;
}

template <typename T1, bool DYMAJOR, bool BF16>
int launch_lookup(const void* f1, const void* pyr, const void* coords,
                  void* out, int HW, int n_pix, int N2, int C, float scale,
                  const Levels& lv, cudaStream_t s) {
  const int blocks = (n_pix + P1_PIX - 1) / P1_PIX;
  const size_t smem = sizeof(float) * P1_PIX * (size_t)(C + PTAPS);
  corr_lookup_packed_kernel<T1, DYMAJOR, BF16><<<blocks, P1_THREADS, smem,
                                                 s>>>(
      static_cast<const T1*>(f1), static_cast<const float*>(pyr),
      static_cast<const float*>(coords), static_cast<__nv_bfloat16*>(out),
      HW, n_pix, N2, C, scale, lv);
  return (int)cudaGetLastError();
}

template <typename T1>
int lookup_f1(int dymajor, int bf16, const void* f1, const void* pyr,
              const void* coords, void* out, int HW, int n_pix, int N2,
              int C, float scale, const Levels& lv, cudaStream_t s) {
  if (dymajor)
    return bf16 ? launch_lookup<T1, true, true>(f1, pyr, coords, out, HW,
                                                n_pix, N2, C, scale, lv, s)
                : launch_lookup<T1, true, false>(f1, pyr, coords, out, HW,
                                                 n_pix, N2, C, scale, lv, s);
  return bf16 ? launch_lookup<T1, false, true>(f1, pyr, coords, out, HW,
                                               n_pix, N2, C, scale, lv, s)
              : launch_lookup<T1, false, false>(f1, pyr, coords, out, HW,
                                                n_pix, N2, C, scale, lv, s);
}

}  // namespace

extern "C" {

int pvo_corr_lookup_packed(const void* f1, int f1_bf16, const void* pyr,
                           const void* coords, void* out, int HW,
                           int n_pix, int N2, int C, float scale,
                           int n_levels, const int* level_hw, int dymajor,
                           int bf16, void* stream) {
  const Levels lv = make_levels(n_levels, level_hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f1_bf16)
    return lookup_f1<__nv_bfloat16>(dymajor, bf16, f1, pyr, coords, out,
                                    HW, n_pix, N2, C, scale, lv, s);
  return lookup_f1<float>(dymajor, bf16, f1, pyr, coords, out, HW, n_pix,
                          N2, C, scale, lv, s);
}

int pvo_corr_extract_packed(const void* vol, const void* coords, void* out,
                            int n_pix, int N2, int n_levels,
                            const int* level_hw, int mode, int wmode,
                            int mid, void* stream) {
  const Levels lv = make_levels(n_levels, level_hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case M_FULL:
      return extract_mode<M_FULL>(wmode, mid, vol, coords, out, n_pix, N2,
                                  lv, s);
    case M_NOSTORE:
      return extract_mode<M_NOSTORE>(wmode, mid, vol, coords, out, n_pix,
                                     N2, lv, s);
    case M_NOVAB:
      return extract_mode<M_NOVAB>(wmode, mid, vol, coords, out, n_pix, N2,
                                   lv, s);
    case M_DMA:
      return extract_mode<M_DMA>(wmode, mid, vol, coords, out, n_pix, N2,
                                 lv, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
