// Correlation kernels of the VO tracking path, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// pvo_tpu_torch/vo/net/cuda_corr.py, which also holds the plain PyTorch
// version of each kernel and the notes on what bounds it.
//
//   K1 pvo_build_volumes  all-pairs correlation of f1 (scaled by 1/16)
//                         against the stacked pooled f2 pyramid, f32
//                         accumulation, bf16 volume: on the tensor cores
//                         (wgmma) for bf16 features, a SIMT f32 tile
//                         product for f32 features.
//   K2 pvo_corr_extract   7x7 bilinear window per pixel and level, read
//                         from K1's volume.
//   K3 pvo_corr_lookup    K1+K2 fused: the 8x8 tap patch of dot products
//                         against each pooled f2 level, no stored volume.
//
// Layouts (row-major, contiguous):
//   f1      (E, HW, C)      float or bf16
//   pyr     (E, N2, C)      level l holds H_l*W_l rows starting at row
//                           off_l = sum_{k<l} H_k*W_k; bf16 for K1's
//                           tensor-core kernel, else float
//   vol     (E, HW, N2p)    bf16; row stride N2p = N2 rounded up to 64
//                           (128 bytes, so every row starts on a cache
//                           line; K1 needs a multiple of 8), columns
//                           N2..N2p-1 are 0. K2 takes the row stride
//                           N2p as its N2 argument
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

// ---------------------------------------------------------------- K1, bf16
// vol[e] = bf16((f1[e] @ pyr[e]^T) / 16), f32 accumulation, on the tensor
// cores. Bound: the bf16 store (E=48 at 30x101: 1.17 GB against 149
// GFLOP, which take under half the store's time at the bf16 peak).
//
// A block owns one edge's 128-row tile of f1 (two warpgroups of 64 rows),
// loaded once into shared memory, and walks K1_TILES tiles of 128 pyramid
// rows. Each tile is C/16 wgmma.m64n128k16 per warpgroup (bf16 operands
// from shared memory, f32 accumulators in registers). Pyramid tiles
// arrive by cp.async into a 2-stage ring: tile n+1's load is in flight
// during tile n's products and epilogue. The epilogue scales by 1/16,
// rounds to bf16 into the stage just consumed (16-byte chunks XOR-
// swizzled by row, so neither side conflicts), and writes each row as
// 16-byte vectors, a warp two rows of 256 contiguous bytes. Rows past
// HW are zero-filled and not stored; pyramid rows past N2 are
// zero-filled, so the pad columns N2..N2p-1 store 0.
//
// Shared-memory operand layout (the wgmma K-major layout without
// swizzle): 8x8 core matrices of 128 contiguous bytes, (row r, k) at
// ((r/8)*(C/8) + k/8)*128 + (r%8)*16 + (k%8)*2. Core matrices adjacent
// in K are 128 bytes apart (the descriptor's leading byte offset), 8-row
// groups C*16 bytes apart (its stride byte offset).
constexpr int K1_BM = 128, K1_BN = 128, K1_THREADS = 256, K1_TILES = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// rows r0..r0+rows-1 of base (rows x C bf16; rows from `total` on as 0)
// into the core-matrix layout at dst; consecutive threads fill
// consecutive 16-byte chunks: chunk q is row 8g + q%8, columns 8kk..,
// with q/8 = g*(C/8) + kk. A zero-filled chunk reads nothing and is
// given a valid address all the same.
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base, int r0,
                                          int rows, int total, int C) {
  const int kc = C / 8, r = threadIdx.x & 7;
  int g = (threadIdx.x >> 3) / kc, kk = (threadIdx.x >> 3) % kc;
  for (int q = threadIdx.x; q < rows * kc; q += K1_THREADS) {
    const int row = r0 + g * 8 + r;
    const bool ok = row < total;
    cp_async16(dst + q * 16, base + (ok ? (size_t)row * C + kk * 8 : 0),
               ok ? 16 : 0);
    for (kk += K1_THREADS / 8; kk >= kc; kk -= kc) ++g;
  }
}

// shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset 128 (bits 16-29) and stride byte offset sbo (bits 32-45),
// each in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (+)= A(64 x 16) B(128 x 16)^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// keeps the compiler from moving accumulator reads across the wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__host__ __device__ size_t tc_stage_bytes(int C) {
  // a pyramid tile, or the 128x128 bf16 epilogue tile staged in it
  const size_t b = (size_t)K1_BN * C * 2, out = (size_t)K1_BM * K1_BN * 2;
  return b > out ? b : out;
}

__global__ void __launch_bounds__(K1_THREADS, 2)
build_volumes_tc_kernel(const __nv_bfloat16* __restrict__ f1,
                        const __nv_bfloat16* __restrict__ pyr,
                        __nv_bfloat16* __restrict__ vol, int HW, int N2,
                        int N2p, int C, float scale) {
  extern __shared__ __align__(128) unsigned char k1_smem[];
  const size_t stage = tc_stage_bytes(C);
  unsigned char* As = k1_smem;
  unsigned char* Bs = k1_smem + (size_t)K1_BM * C * 2;  // stage s at s*stage

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * K1_BM;
  const int t0 = blockIdx.x * K1_TILES;
  const int nt = min(K1_TILES, (N2p + K1_BN - 1) / K1_BN - t0);
  const __nv_bfloat16* B = pyr + (size_t)e * N2 * C;
  __nv_bfloat16* V = vol + ((size_t)e * HW + m0) * N2p;

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int sbo = C * 16;

  load_tile(smem_u32(As), f1 + (size_t)e * HW * C, m0, K1_BM, HW, C);
  load_tile(smem_u32(Bs), B, t0 * K1_BN, K1_BN, N2, C);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const uint64_t da = wgmma_desc(smem_u32(As) + wg * 64 * C * 2, sbo);
  float d[64] = {};

  for (int n = 0; n < nt; ++n) {
    const int s = n & 1, n0 = (t0 + n) * K1_BN;
    if (n + 1 < nt) {
      load_tile(smem_u32(Bs + (s ^ 1) * stage), B, n0 + K1_BN, K1_BN, N2,
                C);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    // this thread's cp.async writes, visible to the async proxy (wgmma)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    unsigned char* O = Bs + s * stage;
    const uint64_t db = wgmma_desc(smem_u32(O), sbo);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int k = 0; k < C / 16; ++k)  // 16 bf16 = 2 core matrices = 256 B
      wgmma_m64n128k16(d, da + 16 * k, db + 16 * k, k > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    __syncthreads();  // both warpgroups are done reading stage s

    // accumulator (row 16*warp + lane/4 + 8i, column 8j + 2(lane%4) + c)
    // of this warpgroup is d[4j + 2i + c]; stage it as bf16, 16-byte
    // chunk j of row r at chunk j ^ (r % 8)
#pragma unroll
    for (int j = 0; j < K1_BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wg * 64 + warp * 16 + lane / 4 + 8 * i;
        *reinterpret_cast<__nv_bfloat162*>(
            O + r * (K1_BN * 2) + ((j ^ (r & 7)) * 16) + (lane % 4) * 4) =
            __floats2bfloat162_rn(d[4 * j + 2 * i] * scale,
                                  d[4 * j + 2 * i + 1] * scale);
      }
    __syncthreads();
    for (int q = threadIdx.x; q < K1_BM * K1_BN / 8; q += K1_THREADS) {
      const int r = q / (K1_BN / 8), cj = q % (K1_BN / 8);
      const int col = n0 + cj * 8;
      if (m0 + r < HW && col < N2p)
        *reinterpret_cast<uint4*>(V + (size_t)r * N2p + col) =
            *reinterpret_cast<const uint4*>(O + r * (K1_BN * 2) +
                                            ((cj ^ (r & 7)) * 16));
    }
    __syncthreads();  // stage s is free for tile n+2
  }
}

// ---------------------------------------------------------------- K1, f32
// The f32-feature variant, for callers that pass f32 features (the video
// stores bf16 ones): bf16 tensor-core products would round its
// operands. 128x128 output tile per block, K-step 8, 256 threads, each
// owning an 8x8 register tile (rows ty*4+{0..3} and 64+ty*4+{0..3},
// columns likewise) so the shared-memory reads are float4 and free of
// bank conflicts; operands staged transposed in shared memory. Writes
// the same padded layout. The wrapper selects it by f1's dtype and
// pools an f32 pyramid for f32 features, so it never runs on bf16
// features or a bf16 pyramid.
constexpr int K1F_BK = 8;

__global__ void __launch_bounds__(K1_THREADS)
build_volumes_f32_kernel(const float* __restrict__ f1,
                         const float* __restrict__ pyr,
                         __nv_bfloat16* __restrict__ vol, int HW, int N2,
                         int N2p, int C, float scale) {
  __shared__ __align__(16) float As[K1F_BK][K1_BM];
  __shared__ __align__(16) float Bs[K1F_BK][K1_BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * K1_BM;
  const int n0 = blockIdx.x * K1_BN;
  const float* A = f1 + (size_t)e * HW * C;
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

  for (int k0 = 0; k0 < C; k0 += K1F_BK) {
    const int gm = m0 + lrow, gn = n0 + lrow;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + lk + i;
      As[lk + i][lrow] = (gm < HW && gk < C) ? A[(size_t)gm * C + gk] : 0.0f;
      Bs[lk + i][lrow] = (gn < N2 && gk < C) ? B[(size_t)gn * C + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K1F_BK; ++k) {
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

  __nv_bfloat16* V = vol + (size_t)e * HW * N2p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= HW) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N2p)
        V[(size_t)row * N2p + col] = __float2bfloat16(acc[i][j] * scale);
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

int pvo_build_volumes(const void* f1, const void* pyr, void* vol,
                      int bf16, int E, int HW, int N2, int N2p, int C,
                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (HW + K1_BM - 1) / K1_BM;
  const int n_tiles = (N2p + K1_BN - 1) / K1_BN;
  if (!bf16) {
    build_volumes_f32_kernel<<<dim3(n_tiles, m_tiles, E), K1_THREADS, 0,
                               s>>>(
        static_cast<const float*>(f1), static_cast<const float*>(pyr),
        static_cast<__nv_bfloat16*>(vol), HW, N2, N2p, C, scale);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)K1_BM * C * 2 + 2 * tc_stage_bytes(C);
  const cudaError_t err = cudaFuncSetAttribute(
      build_volumes_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  build_volumes_tc_kernel<<<dim3((n_tiles + K1_TILES - 1) / K1_TILES,
                                 m_tiles, E),
                            K1_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(f1),
      static_cast<const __nv_bfloat16*>(pyr),
      static_cast<__nv_bfloat16*>(vol), HW, N2, N2p, C, scale);
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
