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
//                         against each pooled f2 level, no stored volume:
//                         on the tensor cores over the bounding box of a
//                         pixel tile's patches for bf16 features, SIMT
//                         dot products for f32 features; the tensor-core
//                         kernel's edges may index frames of features
//                         and pyramids.
//
// Layouts (row-major, contiguous):
//   f1      (E, HW, C)      float or bf16; for K3 (F, HW, C), edge e
//                           reading frame ii[e] (e where ii is null)
//   pyr     (E, N2, C)      (K3: (F, N2, C), edge e reading frame jj[e])
//                           level l holds H_l*W_l rows starting at row
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
#include <limits.h>
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
// Bound: memory. A pixel reads 4 x 8x8 bf16 taps (512 B) and writes 196
// f32 (784 B); nothing is reused.
//
// One warp per query pixel, 8 pixels per block: lane = level * 8 + patch
// row. A lane's 8 taps are 16 contiguous bytes of the pixel's volume
// row at any 2-byte offset: the lane loads the two aligned 16-byte
// vectors that cover them (one 32-byte sector or two, against eight
// 2-byte loads), parks them in its own 32 bytes of shared memory and
// picks its taps from there (zero outside the level). The row below
// comes from the next lane by a shuffle inside the 8-lane group. The
// 7x7 windows are staged in shared memory in the output's dx-major
// order, and the block writes its 8 pixels' 8 x 784 contiguous bytes as
// 16-byte vectors, a warp on consecutive addresses. N2 is the volume's
// row stride (a multiple of 64, so every aligned vector lies inside
// the pixel's row).
constexpr int K2_PIX_PER_BLOCK = 8;
constexpr int K2_THREADS = 32 * K2_PIX_PER_BLOCK;

__global__ void __launch_bounds__(K2_THREADS)
corr_extract_kernel(const __nv_bfloat16* __restrict__ vol,
                    const float* __restrict__ coords,
                    float* __restrict__ out, int n_pix, int N2,
                    Levels lv) {
  __shared__ __align__(16) uint4 win[K2_THREADS][2];
  __shared__ __align__(16) float stage[K2_PIX_PER_BLOCK * MAX_LEVELS * TAPS];

  const int pix0 = blockIdx.x * K2_PIX_PER_BLOCK;
  const int wp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pix = pix0 + wp;
  const int l = lane / PATCH, r = lane % PATCH;
  const bool live = l < lv.n && pix < n_pix;
  const int ll = live ? l : 0;
  const int W = lv.w[ll];

  Window wn = {0.f, 0.f, 0.f, 0.f};
  bool row_ok = false;
  int shift = 0;
  if (live) {
    wn = window_at(coords + (size_t)pix * 2, ll);
    const float yy = wn.by + r;
    // the row holds a tap of the level (false for NaN and huge origins)
    row_ok = tap_ok(yy, lv.h[ll]) && wn.bx + (PATCH - 1) >= 0.0f &&
             wn.bx < float(W);
    if (row_ok) {
      const int idx = lv.off[ll] + (int)yy * W + (int)wn.bx;
      const int a0 = min(max(idx, 0) & ~7, N2 - 16);
      const uint4* src =
          reinterpret_cast<const uint4*>(vol + (size_t)pix * N2 + a0);
      win[threadIdx.x][0] = __ldg(src);
      win[threadIdx.x][1] = __ldg(src + 1);
      shift = idx - a0;  // a tap inside the level lands in 0..15
    }
  }
  const __nv_bfloat16* wv =
      reinterpret_cast<const __nv_bfloat16*>(win[threadIdx.x]);

  float v[PATCH];
#pragma unroll
  for (int dx = 0; dx < PATCH; ++dx) {
    const float xx = wn.bx + dx;
    v[dx] = (row_ok && tap_ok(xx, W)) ? __bfloat162float(wv[shift + dx])
                                      : 0.0f;
  }
  float vn[PATCH];
#pragma unroll
  for (int dx = 0; dx < PATCH; ++dx)
    vn[dx] = __shfl_down_sync(0xffffffffu, v[dx], 1, PATCH);

  const int per_pix = lv.n * TAPS;
  if (live && r < WIN) {
    float* o = stage + wp * per_pix + l * TAPS;
#pragma unroll
    for (int dx = 0; dx < WIN; ++dx)
      o[dx * WIN + r] = blend(wn, v[dx], v[dx + 1], vn[dx], vn[dx + 1]);
  }
  __syncthreads();

  // 8 pixels x per_pix floats start on a 16-byte boundary of out
  const int total = min(K2_PIX_PER_BLOCK, n_pix - pix0) * per_pix;
  float* o = out + (size_t)pix0 * per_pix;
  for (int q = threadIdx.x; q < total / 4; q += K2_THREADS)
    reinterpret_cast<float4*>(o)[q] =
        reinterpret_cast<const float4*>(stage)[q];
  for (int q = (total & ~3) + threadIdx.x; q < total; q += K2_THREADS)
    o[q] = stage[q];
}

// ---------------------------------------------------------------- K3, SIMT
// The kernel for f32 features (and bf16 ones whose C is no multiple of
// 16), on an f32 pyramid. One block = 4 query pixels x 64 taps (the 8x8
// integer patch). Per level, each thread takes the length-C dot product
// of its pixel's f1 row (staged in shared memory as f32) with the pooled
// f2 row under its tap (zero out of range), stores it in a shared 8x8
// patch, and the first 49 threads of each pixel blend the patch into
// the window. Edges are not indexed here: edge e reads row e of f1 and
// of the pyramid (the wrapper gathers the frames of indexed edges).
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

// ---------------------------------------------------------------- K3, bf16
// The kernel of the main path (bf16 features, C a multiple of 16, a bf16
// pyramid). Bound: memory, mostly the f32 output (E=256 at 30x101: 1.01
// GB moved against 51 GFLOP, 0.30 ms against 0.05 ms at the bf16 peak),
// so the products may be wasteful as long as every pooled row is read
// few times.
//
// A block owns an 8 x 16 tile of neighbouring query pixels of one edge
// and keeps their f1 rows in shared memory in K1's wgmma layout. Per
// level it takes the bounding box of its pixels' 8x8 integer patches,
// clipped to the level: where the coordinates are smooth (reprojected
// pixels) the box is little more than the tile plus the window, 15 x 23
// positions at level 0. The box's pooled rows arrive 64 at a time by
// cp.async into a 2-stage ring (the next tile's load overlaps this
// tile's products and gather); each tile is C/16 wgmma.m64n64k16 per
// warpgroup (bf16 in, f32 accumulators), so a pooled row is read once
// per 128 pixels, not once per tap. The f32 products go to a shared
// 128 x 64 tile (row stride 72 floats: the accumulators' float2 stores
// do not conflict), and two threads per pixel pick the taps of their
// half of the 8x8 patch that fall in this tile into registers. After
// the last tile they blend the 7x7 window (patch row 4 crosses from
// the second thread to the first by a shuffle), stage it in the
// product tile's memory in output order, and the block stores each
// pixel's 49 floats of the level, a warp on consecutive addresses.
// Measured on an H100: two blocks per SM with a 2-stage ring beat one
// block with a ring of 3 to 9 stages by a third: the block's own
// arithmetic and barriers, not the loads' latency, set its time.
//
// A level whose box exceeds K3T_BOX_CAP positions (scattered or wild
// coordinates) takes per-pixel dot products against the bf16 pyramid
// instead: each thread 32 taps of its pixel, f1 from shared memory.
// routes[0] counts the (block, level) pairs on the tensor cores,
// routes[1] those on the per-pixel route.
constexpr int K3T_TH = 8, K3T_TW = 16, K3T_PIX = K3T_TH * K3T_TW;
constexpr int K3T_THREADS = 2 * K3T_PIX;  // two warpgroups
constexpr int K3T_BN = 64;                // box positions per tile
constexpr int K3T_STAGES = 2, K3T_BLOCKS_PER_SM = 2;
constexpr int K3T_LD = 72;                // product tile row stride
constexpr int K3T_BOX_CAP = 1536;
static_assert(K3T_PIX == 128 && K3T_THREADS == 256, "two warpgroups of 64");
static_assert(K3T_PIX * TAPS <= K3T_PIX * K3T_LD, "stage fits the tile");

// d (+)= A(64 x 16) B(64 x 16)^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the f1 rows of the block's pixel tile (row r = pixel (y0 + r / 16,
// x0 + r % 16) of frame A; pixels outside the image as 0) into the
// core-matrix layout at dst, chunk order as load_tile
__device__ __forceinline__ void load_pixel_tile(uint32_t dst,
                                                const __nv_bfloat16* A,
                                                int y0, int x0, int H, int W,
                                                int C) {
  const int kc = C / 8, r = threadIdx.x & 7;
  int g = (threadIdx.x >> 3) / kc, kk = (threadIdx.x >> 3) % kc;
  for (int q = threadIdx.x; q < K3T_PIX * kc; q += K3T_THREADS) {
    const int row = g * 8 + r;
    const int y = y0 + row / K3T_TW, x = x0 + row % K3T_TW;
    const bool ok = y < H && x < W;
    cp_async16(dst + q * 16,
               A + (ok ? ((size_t)y * W + x) * C + kk * 8 : 0), ok ? 16 : 0);
    for (kk += K3T_THREADS / 8; kk >= kc; kk -= kc) ++g;
  }
}

// box positions p0..p0+63 (pyramid rows rows[p]; positions from np on
// as 0) of frame B into the core-matrix layout at dst
__device__ __forceinline__ void load_box_tile(uint32_t dst,
                                              const __nv_bfloat16* B,
                                              const int* rows, int p0,
                                              int np, int C) {
  const int kc = C / 8, r = threadIdx.x & 7;
  int g = (threadIdx.x >> 3) / kc, kk = (threadIdx.x >> 3) % kc;
  for (int q = threadIdx.x; q < K3T_BN * kc; q += K3T_THREADS) {
    const int p = p0 + g * 8 + r;
    const bool ok = p < np;
    cp_async16(dst + q * 16, B + (ok ? (size_t)rows[p] * C + kk * 8 : 0),
               ok ? 16 : 0);
    for (kk += K3T_THREADS / 8; kk >= kc; kk -= kc) ++g;
  }
}

// sum of the 8 products of two 16-byte vectors of bf16, added to s
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float s) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]);
    const float2 fb = __bfloat1622float2(pb[i]);
    s = fmaf(fa.x, fb.x, s);
    s = fmaf(fa.y, fb.y, s);
  }
  return s;
}

__host__ __device__ size_t k3t_smem_bytes(int C) {
  return (size_t)K3T_PIX * C * 2 + K3T_STAGES * (size_t)K3T_BN * C * 2 +
         sizeof(float) * K3T_PIX * K3T_LD + sizeof(int) * K3T_BOX_CAP +
         sizeof(int) * MAX_LEVELS * 4;
}

__global__ void __launch_bounds__(K3T_THREADS, K3T_BLOCKS_PER_SM)
corr_lookup_tc_kernel(const __nv_bfloat16* __restrict__ f1,
                      const __nv_bfloat16* __restrict__ pyr,
                      const int* __restrict__ ii, const int* __restrict__ jj,
                      const float* __restrict__ coords,
                      float* __restrict__ out,
                      unsigned long long* __restrict__ routes, int H, int W,
                      int N2, int C, float scale, Levels lv) {
  extern __shared__ __align__(128) unsigned char k3_smem[];
  const size_t stage_bytes = (size_t)K3T_BN * C * 2;
  unsigned char* As = k3_smem;
  unsigned char* Bs = As + (size_t)K3T_PIX * C * 2;
  float* corr = reinterpret_cast<float*>(Bs + K3T_STAGES * stage_bytes);
  int* rows = reinterpret_cast<int*>(corr + K3T_PIX * K3T_LD);
  int* box = rows + K3T_BOX_CAP;  // per level x0, y0, x1, y1
  float* stage = corr;            // the level's windows, [pixel][49]

  const int e = blockIdx.z, HW = H * W;
  const int y0 = blockIdx.y * K3T_TH, x0 = blockIdx.x * K3T_TW;
  const __nv_bfloat16* A = f1 + (size_t)(ii ? ii[e] : e) * HW * C;
  const __nv_bfloat16* B = pyr + (size_t)(jj ? jj[e] : e) * N2 * C;

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int sbo = C * 16, kc = C / 8;

  load_pixel_tile(smem_u32(As), A, y0, x0, H, W, C);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // this thread's pixel and its half of the pixel's 8x8 patch
  const int p = threadIdx.x / 2, half = threadIdx.x % 2;
  const int py = y0 + p / K3T_TW, px = x0 + p % K3T_TW;
  const bool live = py < H && px < W;
  const size_t pix = (size_t)e * HW + (live ? py * W + px : 0);
  float cxy[2] = {0.f, 0.f};
  if (live) {
    cxy[0] = coords[pix * 2];
    cxy[1] = coords[pix * 2 + 1];
  }

  // bounding boxes of the block's patches, clipped to each level
  if (threadIdx.x < MAX_LEVELS * 4)
    box[threadIdx.x] = threadIdx.x % 4 < 2 ? INT_MAX : INT_MIN;
  __syncthreads();
  for (int l = 0; l < lv.n; ++l) {
    const Window wn = window_at(cxy, l);
    // the patch holds a tap of the level (false for NaN, huge origins)
    const bool v = live && wn.bx + (PATCH - 1) >= 0.0f &&
                   wn.bx < float(lv.w[l]) && wn.by + (PATCH - 1) >= 0.0f &&
                   wn.by < float(lv.h[l]);
    const int bx = v ? (int)wn.bx : 0, by = v ? (int)wn.by : 0;
    const int lo_x = __reduce_min_sync(0xffffffffu, v ? max(bx, 0) : INT_MAX);
    const int lo_y = __reduce_min_sync(0xffffffffu, v ? max(by, 0) : INT_MAX);
    const int hi_x = __reduce_max_sync(
        0xffffffffu, v ? min(bx + PATCH - 1, lv.w[l] - 1) : INT_MIN);
    const int hi_y = __reduce_max_sync(
        0xffffffffu, v ? min(by + PATCH - 1, lv.h[l] - 1) : INT_MIN);
    if (lane == 0) {
      atomicMin(box + 4 * l, lo_x);
      atomicMin(box + 4 * l + 1, lo_y);
      atomicMax(box + 4 * l + 2, hi_x);
      atomicMax(box + 4 * l + 3, hi_y);
    }
  }
  __syncthreads();

  const uint64_t da = wgmma_desc(smem_u32(As) + wg * 64 * C * 2, sbo);
  const int n_out = lv.n * TAPS;
  float d[32] = {};

  for (int l = 0; l < lv.n; ++l) {
    const int Wl = lv.w[l], Hl = lv.h[l];
    const int bx0 = box[4 * l], by0 = box[4 * l + 1];
    const bool any = bx0 <= box[4 * l + 2];
    const int bw = any ? box[4 * l + 2] - bx0 + 1 : 0;
    const int np = any ? bw * (box[4 * l + 3] - by0 + 1) : 0;
    const bool tensor = np <= K3T_BOX_CAP;  // the same for the whole block
    if (threadIdx.x == 0) atomicAdd(routes + (tensor ? 0 : 1), 1ULL);

    Window wn = {0.f, 0.f, 0.f, 0.f};
    int ibx = 0, iby = 0;
    unsigned xm = 0, ym = 0;  // taps (patch rows of this half) in the level
    if (live) {
      wn = window_at(cxy, l);
      if (wn.bx + (PATCH - 1) >= 0.0f && wn.bx < float(Wl) &&
          wn.by + (PATCH - 1) >= 0.0f && wn.by < float(Hl)) {
        ibx = (int)wn.bx;
        iby = (int)wn.by + half * 4;
#pragma unroll
        for (int c = 0; c < PATCH; ++c)
          xm |= (unsigned)(ibx + c >= 0 && ibx + c < Wl) << c;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ym |= (unsigned)(iby + r >= 0 && iby + r < Hl) << r;
        if (ym == 0) xm = 0;
      }
    }

    float pt[4][PATCH];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < PATCH; ++c) pt[r][c] = 0.0f;

    if (tensor) {
      for (int q = threadIdx.x; q < np; q += K3T_THREADS) {
        const int y = q / bw;
        rows[q] = lv.off[l] + (by0 + y) * Wl + bx0 + (q - y * bw);
      }
      __syncthreads();  // rows ready; the last level's stage is stored
      const int nt = (np + K3T_BN - 1) / K3T_BN;
      // box position of this thread's tap (row 0, column 0)
      const int p00 = (iby - by0) * bw + (ibx - bx0);
      // every tile is one cp.async group, empty past the last tile, so
      // that the groups in flight count the same at every step
      for (int t = 0; t < K3T_STAGES - 1; ++t) {
        if (t < nt)
          load_box_tile(smem_u32(Bs + t * stage_bytes), B, rows, t * K3T_BN,
                        np, C);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      for (int n = 0; n < nt; ++n) {
        const int s = n % K3T_STAGES, ahead = n + K3T_STAGES - 1;
        asm volatile("cp.async.wait_group %0;\n" ::"n"(K3T_STAGES - 2)
                     : "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();  // tile n landed; the last tile's gather is over
        // the stage that tile n-1 left takes the tile K3T_STAGES-1 ahead
        if (ahead < nt)
          load_box_tile(smem_u32(Bs + (ahead % K3T_STAGES) * stage_bytes), B,
                        rows, ahead * K3T_BN, np, C);
        asm volatile("cp.async.commit_group;\n" ::: "memory");

        const uint64_t db = wgmma_desc(smem_u32(Bs + s * stage_bytes), sbo);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        for (int k = 0; k < C / 16; ++k)
          wgmma_m64n64k16(d, da + 16 * k, db + 16 * k, k > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(d);
        // accumulator d[4j + 2i + c] is (row 16*warp + lane/4 + 8i,
        // column 8j + 2(lane%4) + c) of this warpgroup's 64 pixels
#pragma unroll
        for (int j = 0; j < K3T_BN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = wg * 64 + warp * 16 + lane / 4 + 8 * i;
            *reinterpret_cast<float2*>(corr + row * K3T_LD + 8 * j +
                                       2 * (lane % 4)) =
                make_float2(d[4 * j + 2 * i] * scale,
                            d[4 * j + 2 * i + 1] * scale);
          }
        __syncthreads();  // products visible; stage s may be refilled

        const float* mine = corr + p * K3T_LD - n * K3T_BN;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int pr = p00 + r * bw;
          // no tap of this row in columns [n*64, n*64 + 64)
          if (!((ym >> r) & 1) || pr + PATCH <= n * K3T_BN ||
              pr >= (n + 1) * K3T_BN)
            continue;
#pragma unroll
          for (int c = 0; c < PATCH; ++c)
            if (((xm >> c) & 1) &&
                (unsigned)(pr + c - n * K3T_BN) < (unsigned)K3T_BN)
              pt[r][c] = mine[pr + c];
        }
      }
      __syncthreads();  // every gather is over: the tile becomes the stage
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // f1 landed; the last level's stage is stored
      // f1 chunk kk of pixel p is 16 bytes at ((p/8)*kc + kk)*128 + (p%8)*16
      const uint4* a4 = reinterpret_cast<const uint4*>(
          As + (size_t)(p / 8) * kc * 128 + (p % 8) * 16);
      float* mine = corr + p * K3T_LD + half * 32;
      for (int t = 0; t < 32; ++t) {
        const int r = t / PATCH, c = t % PATCH;
        float val = 0.0f;
        if (((ym >> r) & 1) && ((xm >> c) & 1)) {
          const uint4* b4 = reinterpret_cast<const uint4*>(
              B + ((size_t)lv.off[l] + (size_t)(iby + r) * Wl + ibx + c) * C);
          float s = 0.0f;
          for (int kk = 0; kk < kc; ++kk)
            s = dot8(a4[kk * 8], __ldg(b4 + kk), s);
          val = s * scale;
        }
        mine[t] = val;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PATCH; ++c) pt[r][c] = mine[r * PATCH + c];
      __syncthreads();  // every patch is read: the tile becomes the stage
    }

    // patch row 4 (the second thread's first row) for the first thread
    float nx[PATCH];
#pragma unroll
    for (int c = 0; c < PATCH; ++c)
      nx[c] = __shfl_down_sync(0xffffffffu, pt[0][c], 1);
    if (live) {
      float* o = stage + p * TAPS + half * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r == 3 && half == 1) continue;  // window rows 0..6 only
        float below[PATCH];
#pragma unroll
        for (int c = 0; c < PATCH; ++c)
          below[c] = r < 3 ? pt[(r + 1) % 4][c] : nx[c];
#pragma unroll
        for (int dx = 0; dx < WIN; ++dx)
          o[dx * WIN + r] = blend(wn, pt[r][dx], pt[r][dx + 1], below[dx],
                                  below[dx + 1]);
      }
    }
    __syncthreads();
    // a warp per pixel: the level's 49 floats are contiguous in out
    for (int qp = threadIdx.x / 32; qp < K3T_PIX; qp += K3T_THREADS / 32) {
      const int qy = y0 + qp / K3T_TW, qx = x0 + qp % K3T_TW;
      if (qy >= H || qx >= W) continue;
      float* o = out + ((size_t)e * HW + qy * W + qx) * n_out + l * TAPS;
      o[lane] = stage[qp * TAPS + lane];
      if (lane + 32 < TAPS) o[lane + 32] = stage[qp * TAPS + lane + 32];
    }
    // the next level's first barrier comes before it touches the stage
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
  corr_extract_kernel<<<blocks, K2_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(vol),
      static_cast<const float*>(coords), static_cast<float*>(out), n_pix,
      N2, lv);
  return (int)cudaGetLastError();
}

// kind 0: f32 features on an f32 pyramid; 1: bf16 features on an f32
// pyramid (both the SIMT kernel, which takes no edge indices: ii and jj
// must be null); 2: bf16 features on a bf16 pyramid, C a multiple of 16
// (the tensor-core kernel; routes: two 64-bit counters)
int pvo_corr_lookup(const void* f1, const void* pyr, const int* ii,
                    const int* jj, const void* coords, void* out,
                    void* routes, int kind, int E, int H, int W, int N2,
                    int C, float scale, int n_levels, const int* level_hw,
                    void* stream) {
  const Levels lv = make_levels(n_levels, level_hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W, n_pix = E * HW;
  if (kind == 2) {
    const size_t smem = k3t_smem_bytes(C);
    const cudaError_t err = cudaFuncSetAttribute(
        corr_lookup_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    corr_lookup_tc_kernel<<<dim3((W + K3T_TW - 1) / K3T_TW,
                                 (H + K3T_TH - 1) / K3T_TH, E),
                            K3T_THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(f1),
        static_cast<const __nv_bfloat16*>(pyr), ii, jj,
        static_cast<const float*>(coords), static_cast<float*>(out),
        static_cast<unsigned long long*>(routes), H, W, N2, C, scale, lv);
    return (int)cudaGetLastError();
  }
  if (ii || jj) return (int)cudaErrorInvalidValue;
  const int blocks = (n_pix + K3_PIX_PER_BLOCK - 1) / K3_PIX_PER_BLOCK;
  const size_t smem =
      sizeof(float) * K3_PIX_PER_BLOCK * (size_t)(C + PATCH * PATCH);
  if (kind == 1)
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
