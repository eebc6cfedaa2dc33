// Correlation kernels of the VO tracking path, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// pvo_tpu_torch/vo/net/cuda_corr.py, which also holds the plain PyTorch
// version of each kernel and the notes on what bounds it.
//
//   K1 pvo_build_volumes  all-pairs correlation of f1 (scaled by 1/16)
//                         against the stacked pooled f2 pyramid, f32
//                         accumulation, bf16 volume.
//   K2 pvo_corr_extract   7x7 bilinear window per pixel and level, read
//                         from K1's volume.
//   K3 pvo_corr_lookup    K1+K2 fused: the 8x8 tap patch of dot products
//                         against each pooled f2 level, no stored volume.
//
// Layouts (row-major, contiguous):
//   f1      (E, HW, C)      float or bf16
//   pyr     (E, N2, C)      float; level l holds H_l*W_l rows starting
//                           at row off_l = sum_{k<l} H_k*W_k
//   vol     (E, HW, N2)     bf16
//   coords  (E, HW, 2)      float, level-0 [x, y]
//   out     (E, HW, L*49)   float; channel l*49 + dx*7 + dy (dx-major)
// Every entry launches on the given stream, does not synchronise and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "corr_common.cuh"

namespace {

__device__ __forceinline__ float blend(const Window& wn, float p00,
                                       float p01, float p10, float p11) {
  return (1.0f - wn.fy) * (1.0f - wn.fx) * p00 +
         (1.0f - wn.fy) * wn.fx * p01 + wn.fy * (1.0f - wn.fx) * p10 +
         wn.fy * wn.fx * p11;
}

// ---------------------------------------------------------------- K1
// vol[e] = (f1[e] @ pyr[e]^T) / 16: a batched (HW x C) x (C x N2)
// product. 128x128 output tile per block, K-step 8, 256 threads, each
// owning an 8x8 register tile (rows ty*4+{0..3} and 64+ty*4+{0..3},
// columns likewise) so the shared-memory reads are float4 and free of
// bank conflicts. Operands are staged transposed in shared memory as
// f32 (bf16 f1 is widened on load).
constexpr int K1_BM = 128, K1_BN = 128, K1_BK = 8, K1_THREADS = 256;

template <typename T1>
__global__ void __launch_bounds__(K1_THREADS)
build_volumes_kernel(const T1* __restrict__ f1,
                     const float* __restrict__ pyr,
                     __nv_bfloat16* __restrict__ vol, int HW, int N2,
                     int C, float scale) {
  __shared__ __align__(16) float As[K1_BK][K1_BM];
  __shared__ __align__(16) float Bs[K1_BK][K1_BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * K1_BM;
  const int n0 = blockIdx.x * K1_BN;
  const T1* A = f1 + (size_t)e * HW * C;
  const float* B = pyr + (size_t)e * N2 * C;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  // loader mapping: 128 rows x 8 k = 1024 values, 4 per thread
  const int lrow = tid / 2, lk = (tid % 2) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < C; k0 += K1_BK) {
    const int gm = m0 + lrow, gn = n0 + lrow;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + lk + i;
      As[lk + i][lrow] =
          (gm < HW && gk < C) ? to_f32(A[(size_t)gm * C + gk]) : 0.0f;
      Bs[lk + i][lrow] = (gn < N2 && gk < C) ? B[(size_t)gn * C + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K1_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  __nv_bfloat16* V = vol + (size_t)e * HW * N2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= HW) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N2)
        V[(size_t)row * N2 + col] = __float2bfloat16(acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------- K2
// One warp per query pixel: lane = level * 8 + patch row. Each lane
// reads its 8 patch values of one row of the level's volume slice (zero
// outside the level), fetches the row below from the next lane with a
// shuffle inside the 8-lane group, blends, and writes the 7 taps of
// window row dy = lane % 8 (< 7) in dx-major order.
constexpr int K2_PIX_PER_BLOCK = 4;

__global__ void __launch_bounds__(32 * K2_PIX_PER_BLOCK)
corr_extract_kernel(const __nv_bfloat16* __restrict__ vol,
                    const float* __restrict__ coords,
                    float* __restrict__ out, int n_pix, int N2,
                    Levels lv) {
  const int pix = blockIdx.x * K2_PIX_PER_BLOCK + threadIdx.x / 32;
  if (pix >= n_pix) return;  // whole warp leaves together
  const int lane = threadIdx.x % 32;
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

  if (!live || r >= WIN) return;
  float* o = out + (size_t)pix * (lv.n * TAPS) + l * TAPS;
#pragma unroll
  for (int dx = 0; dx < WIN; ++dx)
    o[dx * WIN + r] = blend(wn, v[dx], v[dx + 1], vn[dx], vn[dx + 1]);
}

// ---------------------------------------------------------------- K3
// One block = 4 query pixels x 64 taps (the 8x8 integer patch). Per
// level, each thread takes the length-C dot product of its pixel's f1
// row (staged in shared memory as f32) with the pooled f2 row under its
// tap (zero out of range), stores it in a shared 8x8 patch, and the
// first 49 threads of each pixel blend the patch into the window.
constexpr int K3_PIX_PER_BLOCK = 4;
constexpr int K3_THREADS = K3_PIX_PER_BLOCK * PATCH * PATCH;  // 256

template <typename T1>
__global__ void __launch_bounds__(K3_THREADS)
corr_lookup_kernel(const T1* __restrict__ f1, const float* __restrict__ pyr,
                   const float* __restrict__ coords,
                   float* __restrict__ out, int HW, int n_pix, int N2,
                   int C, float scale, Levels lv) {
  extern __shared__ __align__(16) float smem[];
  float* f1s = smem;                                   // [4][C]
  float* patch = smem + K3_PIX_PER_BLOCK * C;          // [4][64]

  const int pl = threadIdx.x / (PATCH * PATCH);
  const int tap = threadIdx.x % (PATCH * PATCH);
  const int pix = blockIdx.x * K3_PIX_PER_BLOCK + pl;
  const bool live = pix < n_pix;

  for (int i = threadIdx.x; i < K3_PIX_PER_BLOCK * C; i += K3_THREADS) {
    const int p = blockIdx.x * K3_PIX_PER_BLOCK + i / C;
    f1s[i] = p < n_pix ? to_f32(f1[(size_t)p * C + i % C]) : 0.0f;
  }
  __syncthreads();

  const int e = live ? pix / HW : 0;
  const float* a = f1s + pl * C;
  float* pt = patch + pl * PATCH * PATCH;
  const int ty = tap / PATCH, tx = tap % PATCH;

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
    pt[tap] = val;
    __syncthreads();
    if (live && tap < TAPS) {
      const int dx = tap / WIN, dy = tap % WIN;  // dx-major output tap
      const int q = dy * PATCH + dx;
      out[(size_t)pix * (lv.n * TAPS) + l * TAPS + tap] =
          blend(wn, pt[q], pt[q + 1], pt[q + PATCH], pt[q + PATCH + 1]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int pvo_build_volumes(const void* f1, int f1_bf16, const void* pyr,
                      void* vol, int E, int HW, int N2, int C, float scale,
                      void* stream) {
  const dim3 grid((N2 + K1_BN - 1) / K1_BN, (HW + K1_BM - 1) / K1_BM, E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f1_bf16)
    build_volumes_kernel<__nv_bfloat16><<<grid, K1_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f1),
        static_cast<const float*>(pyr), static_cast<__nv_bfloat16*>(vol),
        HW, N2, C, scale);
  else
    build_volumes_kernel<float><<<grid, K1_THREADS, 0, s>>>(
        static_cast<const float*>(f1), static_cast<const float*>(pyr),
        static_cast<__nv_bfloat16*>(vol), HW, N2, C, scale);
  return (int)cudaGetLastError();
}

int pvo_corr_extract(const void* vol, const void* coords, void* out,
                     int n_pix, int N2, int n_levels, const int* level_hw,
                     void* stream) {
  const Levels lv = make_levels(n_levels, level_hw);
  const int blocks = (n_pix + K2_PIX_PER_BLOCK - 1) / K2_PIX_PER_BLOCK;
  corr_extract_kernel<<<blocks, 32 * K2_PIX_PER_BLOCK, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(vol),
      static_cast<const float*>(coords), static_cast<float*>(out), n_pix,
      N2, lv);
  return (int)cudaGetLastError();
}

int pvo_corr_lookup(const void* f1, int f1_bf16, const void* pyr,
                    const void* coords, void* out, int HW, int n_pix,
                    int N2, int C, float scale, int n_levels,
                    const int* level_hw, void* stream) {
  const Levels lv = make_levels(n_levels, level_hw);
  const int blocks = (n_pix + K3_PIX_PER_BLOCK - 1) / K3_PIX_PER_BLOCK;
  const size_t smem =
      sizeof(float) * K3_PIX_PER_BLOCK * (size_t)(C + PATCH * PATCH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f1_bf16)
    corr_lookup_kernel<__nv_bfloat16><<<blocks, K3_THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(f1),
        static_cast<const float*>(pyr), static_cast<const float*>(coords),
        static_cast<float*>(out), HW, n_pix, N2, C, scale, lv);
  else
    corr_lookup_kernel<float><<<blocks, K3_THREADS, smem, s>>>(
        static_cast<const float*>(f1), static_cast<const float*>(pyr),
        static_cast<const float*>(coords), static_cast<float*>(out), HW,
        n_pix, N2, C, scale, lv);
  return (int)cudaGetLastError();
}

}  // extern "C"
