// Packed-layout correlation kernels, hand-written for Hopper (sm_90a):
// the counterparts of the JAX package's corr experiment harnesses
// (scripts/corr_exp{,2,3,4,5}.py). Plain C interface, loaded with ctypes
// by pvo_tpu_torch/vo/net/cuda_corr_exp.py, which also holds the plain
// PyTorch version of each kernel and the notes on what bounds it.
//
//   P1 pvo_corr_lookup_packed   correlation against the pooled f2
//                               pyramid + 8x8 windowed lookup, no stored
//                               volume (X1), on the tensor cores: K3's
//                               body (corr_tc.cuh) with a packed epilogue.
//   P2 pvo_corr_extract_packed  8x8 windowed lookup from K1's volume
//                               (X2-X5), with X3's diagnostic modes.
//
// Layouts (row-major, contiguous):
//   f1      (E, HW, C)      bf16
//   pyr     (E, N2, C)      bf16; level l holds H_l*W_l rows from row
//                           off_l (cuda_corr.pool_pyramid)
//   vol     (E, HW, N2p)    bf16 (K1, pvo_build_volumes); the row stride
//                           N2p is passed to pvo_corr_extract_packed as
//                           its N2
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

#include "corr_tc.cuh"

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
// bf16 features (C a multiple of 16) on a bf16 pyramid. Bound: memory
// (E=64 at 30x101: 99 MB of features in, 99 MB of packed taps out, 0.06
// ms, against 12.7 GFLOP, 0.013 ms at the bf16 peak). The body is K3's
// (lookup_tc_body, corr_tc.cuh): a block owns 8 x 16 neighbouring
// pixels of one edge, takes per level the bounding box of their 8x8
// patches, streams the box's pooled rows through a cp.async ring into
// wgmma.m64n64k16, and two threads per pixel gather their half patch
// from the f32 product tile. A box over the cap (scattered coordinates:
// at 30x101 the level-0 box of uniform coordinates is the whole level)
// stays on the tensor cores and works its rows out as it goes
// (P1_DENSE; false selects K3's per-pixel dot products, the slower of
// the two here: the times are in cuda_corr_exp.py's notes).
//
// What is P1's own is the epilogue. From the thread's half patch: X1's
// rows-first blend with separately rounded products and sums (lerp2);
// BF16 rounds the correlation, the weights and the row blend to bf16
// (X1's seldt="bf16"); pad taps (dy or dx = 7) are 0. The level's 64
// bf16 per pixel are staged in the product tile's memory (16-byte chunk
// dy of pixel p at chunk dy ^ (p % 8), so neither side conflicts) and
// stored as 16-byte vectors: level-major, 8 lanes write a pixel's 128
// contiguous bytes; dy-major, a level's rows are eight 16-byte pieces
// 16 * L bytes apart.
constexpr bool P1_DENSE = true;
static_assert(K3T_PIX * PTAPS * 2 <= K3T_PIX * K3T_LD * 4,
              "the packed stage fits the product tile");

template <bool DYMAJOR, bool BF16>
struct PackedEpilogue {
  __nv_bfloat16* out;  // (E, HW, L*64)

  __device__ __forceinline__ void operator()(int l, const Window& wn,
                                             float (&pt)[4][PATCH],
                                             float* tile_mem,
                                             const LookupTile& t,
                                             const Levels& lv) const {
    constexpr int WM = BF16 ? W_BF16 : W_F32;
    uint4* stage = reinterpret_cast<uint4*>(tile_mem);  // [pixel][8 rows]
    const int p = t.p;
    if (BF16) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PATCH; ++c) pt[r][c] = bf16_round(pt[r][c]);
    }
    // patch row 4 (the second thread's first row) for the first thread
    float nx[PATCH];
#pragma unroll
    for (int c = 0; c < PATCH; ++c)
      nx[c] = __shfl_down_sync(0xffffffffu, pt[0][c], 1);
    if (t.live) {
      float wy0, wy1, wx0, wx1;
      weights<WM>(wn.fy, wy0, wy1);
      weights<WM>(wn.fx, wx0, wx1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int dy = t.half * 4 + r;
        __align__(16) __nv_bfloat16 o[PATCH];
#pragma unroll
        for (int dx = 0; dx < PATCH; ++dx) o[dx] = __float2bfloat16(0.0f);
        if (dy < WIN) {
          float m[PATCH];
#pragma unroll
          for (int j = 0; j < PATCH; ++j) {
            m[j] = lerp2(wy0, pt[r][j], wy1, r < 3 ? pt[(r + 1) % 4][j]
                                                   : nx[j]);
            if (BF16) m[j] = bf16_round(m[j]);
          }
#pragma unroll
          for (int dx = 0; dx < WIN; ++dx)
            o[dx] = __float2bfloat16(lerp2(wx0, m[dx], wx1, m[dx + 1]));
        }
        stage[p * PATCH + (dy ^ (p & 7))] =
            *reinterpret_cast<const uint4*>(o);
      }
    }
    __syncthreads();
    const int n_ch = lv.n * PTAPS;
    for (int q = threadIdx.x; q < K3T_PIX * PATCH; q += K3T_THREADS) {
      const int qp = q / PATCH, dy = q % PATCH;
      const int qy = t.y0 + qp / K3T_TW, qx = t.x0 + qp % K3T_TW;
      if (qy >= t.H || qx >= t.W) continue;
      __nv_bfloat16* o =
          out + ((size_t)t.e * t.H * t.W + qy * t.W + qx) * n_ch +
          (DYMAJOR ? dy * (lv.n * PATCH) + l * PATCH : l * PTAPS + dy * PATCH);
      *reinterpret_cast<uint4*>(o) = stage[qp * PATCH + (dy ^ (qp & 7))];
    }
  }
};

template <bool DYMAJOR, bool BF16>
__global__ void __launch_bounds__(K3T_THREADS, K3T_BLOCKS_PER_SM)
corr_lookup_packed_kernel(const __nv_bfloat16* __restrict__ f1,
                          const __nv_bfloat16* __restrict__ pyr,
                          const float* __restrict__ coords,
                          __nv_bfloat16* __restrict__ out,
                          unsigned long long* __restrict__ routes, int H,
                          int W, int N2, int C, float scale, Levels lv) {
  lookup_tc_body<P1_DENSE>(f1, pyr, nullptr, nullptr, coords, routes, H, W,
                           N2, C, scale, lv,
                           PackedEpilogue<DYMAJOR, BF16>{out});
}

// ---------------------------------------------------------------- P2
// Bound: memory; a pixel reads 4 x 8x8 bf16 taps (512 B, in 16-byte
// runs at any 2-byte offset: about 30 32-byte sectors at 30x101) and
// writes 512 B; nothing is reused.
// FULL / NOSTORE: one warp per query pixel, 8 pixels per block, lane =
// level * 8 + patch row (K2's structure). Each lane reads its 8 patch
// values of one row of the level's volume slice with K2's loads
// (patch_row, corr_common.cuh: the two aligned 16-byte vectors that
// cover them, zero outside the level), takes the row below from the next
// lane by a shuffle, blends, and stores its 8 packed taps (row dy =
// lane % 8, dy == 7 all zero) as one 16-byte store: a warp writes its
// pixel's 512 contiguous bytes.
// NOVAB / DMA: the warp's lanes cover columns 0-127 of the last level,
// four columns each, and zero the rest of the pixel's channels.
constexpr int P2_PIX = 8;

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

    __shared__ __align__(16) uint4 win[32 * P2_PIX][2];
    const Window wn = window_at(coords + (size_t)pix * 2, ll);
    float v[PATCH];
    patch_row(v, win[threadIdx.x], vol + (size_t)pix * N2, N2, wn, r, live,
              lv.off[ll], lv.h[ll], lv.w[ll]);
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

template <bool DYMAJOR, bool BF16>
int launch_lookup(const void* f1, const void* pyr, const void* coords,
                  void* out, void* routes, int E, int H, int W, int N2,
                  int C, float scale, const Levels& lv, cudaStream_t s) {
  const size_t smem = k3t_smem_bytes(C);
  const cudaError_t err = cudaFuncSetAttribute(
      corr_lookup_packed_kernel<DYMAJOR, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  corr_lookup_packed_kernel<DYMAJOR, BF16>
      <<<dim3((W + K3T_TW - 1) / K3T_TW, (H + K3T_TH - 1) / K3T_TH, E),
         K3T_THREADS, smem, s>>>(
          static_cast<const __nv_bfloat16*>(f1),
          static_cast<const __nv_bfloat16*>(pyr),
          static_cast<const float*>(coords),
          static_cast<__nv_bfloat16*>(out),
          static_cast<unsigned long long*>(routes), H, W, N2, C, scale, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 features (E, H, W, C), C a multiple of 16 up to 256, on the bf16
// pyramid (E, N2, C); routes: two 64-bit counters of (block, level)
// pairs, [box within the cap, box above it]
int pvo_corr_lookup_packed(const void* f1, const void* pyr,
                           const void* coords, void* out, void* routes,
                           int E, int H, int W, int N2, int C, float scale,
                           int n_levels, const int* level_hw, int dymajor,
                           int bf16, void* stream) {
  if (C % 16 || C > 256 || E > 65535) return (int)cudaErrorInvalidValue;
  const Levels lv = make_levels(n_levels, level_hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dymajor)
    return bf16 ? launch_lookup<true, true>(f1, pyr, coords, out, routes, E,
                                            H, W, N2, C, scale, lv, s)
                : launch_lookup<true, false>(f1, pyr, coords, out, routes, E,
                                             H, W, N2, C, scale, lv, s);
  return bf16 ? launch_lookup<false, true>(f1, pyr, coords, out, routes, E, H,
                                           W, N2, C, scale, lv, s)
              : launch_lookup<false, false>(f1, pyr, coords, out, routes, E,
                                            H, W, N2, C, scale, lv, s);
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
