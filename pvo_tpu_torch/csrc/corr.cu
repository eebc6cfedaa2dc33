// Correlation kernels of the VO tracking path, hand-written for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// pvo_tpu_torch/vo/net/cuda_corr.py, which also holds the plain PyTorch
// version of each kernel and the notes on what bounds it.
//
//   K1 pvo_build_volumes  all-pairs correlation of f1 (scaled by 1/16)
//                         against the stacked pooled f2 pyramid, f32
//                         accumulation, bf16 volume, on the tensor cores
//                         (wgmma): bf16 products for bf16 features,
//                         three TF32 passes over split operands for f32
//                         features.
//   K2 pvo_corr_extract   7x7 bilinear window per pixel and level, read
//                         from K1's volume.
//   K3 pvo_corr_lookup    K1+K2 fused: the 8x8 tap patch of dot products
//                         against each pooled f2 level, no stored volume,
//                         on the tensor cores over the bounding box of a
//                         pixel tile's patches: bf16 products for bf16
//                         features (8x16 pixels, a block walks the
//                         levels; the body is corr_tc.cuh's, shared with
//                         P1), three TF32 passes for f32 features
//                         (8x8 pixels, a block per level). Edges may
//                         index frames of features and pyramids.
//
// Layouts (row-major, contiguous):
//   f1      (E, HW, C)      float or bf16; for K3 (F, HW, C), edge e
//                           reading frame ii[e] (e where ii is null)
//   pyr     (E, N2, C)      (K3: (F, N2, C), edge e reading frame jj[e])
//                           level l holds H_l*W_l rows starting at row
//                           off_l = sum_{k<l} H_k*W_k; bf16 for K1's
//                           bf16 kernel, else float
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

#include "corr_tc.cuh"

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
// Both operands take the wgmma K-major layout of corr_tc.cuh in shared
// memory.
constexpr int K1_BM = 128, K1_BN = 128, K1_THREADS = 256, K1_TILES = 16;

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

// ------------------------------------------------- f32 operands, 3 x TF32
// f32 features go to the tensor cores in two TF32 parts each: hi =
// tf32(x) and lo = tf32(x - hi), split when a tile is staged into shared
// memory, and a product is lo.hi + hi.lo + hi.hi (the small terms first)
// with f32 accumulation. The dropped lo.lo term is 2^-22 of a product,
// a few 1e-7 on a correlation of unit-variance features at C=128; one
// TF32 pass alone would be off by 3.5e-4 there (and flip a fifth of K1's
// bf16 outputs), a SIMT f32 product tops out at a seventh of the TF32
// rate. Both parts take K1's wgmma layout with 4-byte elements: 8-row x
// 16-byte core matrices of 128 contiguous bytes, (row r, k) at
// ((r/8)*(C/4) + k/4)*128 + (r%8)*16 + (k%4)*4, core matrices adjacent
// in K 128 bytes apart, 8-row groups C*32 bytes apart. The split passes
// through registers, so tiles are fetched with plain 16-byte loads,
// SPLIT_CHUNKS per thread in flight at once: a kernel fetches the next
// tile before it multiplies this one and stores it after.
constexpr int SPLIT_CHUNKS = 8;

// x rounded to TF32's 10 mantissa bits (nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_store(unsigned char* hi,
                                            unsigned char* lo,
                                            const float4& v) {
  uint4 h, l;
  h.x = tf32_rna(v.x);
  h.y = tf32_rna(v.y);
  h.z = tf32_rna(v.z);
  h.w = tf32_rna(v.w);
  l.x = tf32_rna(v.x - __uint_as_float(h.x));
  l.y = tf32_rna(v.y - __uint_as_float(h.y));
  l.z = tf32_rna(v.z - __uint_as_float(h.z));
  l.w = tf32_rna(v.w - __uint_as_float(h.w));
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// volatile, so that a tile's loads stay where they are written: ahead
// of the products of the tile before
__device__ __forceinline__ float4 load4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A thread's 16-byte chunks of a (rows x C) tile are q0 + threadIdx.x +
// i*NT (i < SPLIT_CHUNKS, below total); chunk q is row 8g + q%8,
// channels 4kk.., with q/8 = g*kc + kk and kc = C/4, so that consecutive
// threads fill consecutive 16 bytes of the core-matrix layout. The map
// is the same for every tile of a kernel's loop, so it is worked out
// once: rk[i] = row << 16 | first channel (the staging is a serial
// instruction stream on few warps, and the divisions were a tenth of
// K1's time).
template <int NT>
__device__ __forceinline__ void chunk_map(int (&rk)[SPLIT_CHUNKS], int q0,
                                          int kc) {
#pragma unroll
  for (int i = 0; i < SPLIT_CHUNKS; ++i) {
    const int q = q0 + threadIdx.x + i * NT;
    const int g = (q >> 3) / kc, kk = (q >> 3) - g * kc;
    rk[i] = (g * 8 + (q & 7)) << 16 | kk * 4;
  }
}

// the chunks of chunk_map into registers; src(row) is the row's first
// channel, or null for a row of 0
template <int NT, typename Src>
__device__ __forceinline__ void fetch_chunks(float4 (&pf)[SPLIT_CHUNKS],
                                             const int (&rk)[SPLIT_CHUNKS],
                                             int q0, int total,
                                             const Src& src) {
#pragma unroll
  for (int i = 0; i < SPLIT_CHUNKS; ++i) {
    pf[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + threadIdx.x + i * NT < total) {
      const auto* p = src(rk[i] >> 16);
      if (p) pf[i] = load4(p + (rk[i] & 0xffff));
    }
  }
}

// the chunks of fetch_chunks, split, into the two parts' tiles
template <int NT>
__device__ __forceinline__ void store_chunks(
    const float4 (&pf)[SPLIT_CHUNKS], unsigned char* hi, unsigned char* lo,
    int q0, int total) {
#pragma unroll
  for (int i = 0; i < SPLIT_CHUNKS; ++i) {
    const int q = q0 + threadIdx.x + i * NT;
    if (q < total) split_store(hi + (size_t)q * 16, lo + (size_t)q * 16, pf[i]);
  }
}

// rows r0.. of a (total x C) matrix, rows from `total` on as 0
template <typename T>
struct TileRows {
  const T* base;
  int r0, total, C;
  __device__ const T* operator()(int r) const {
    return r0 + r < total ? base + (size_t)(r0 + r) * C : nullptr;
  }
};

// d (+)= A(64 x 8) B(32 x 8)^T, TF32 operands K-major in shared memory
__device__ __forceinline__ void wgmma_k8(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A(64 x 8) B(64 x 8)^T, TF32 operands K-major in shared memory
__device__ __forceinline__ void wgmma_k8(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B^T of f32 operands in two TF32 parts each (descriptors of the
// hi and lo tiles), steps = C / 8 wgmma steps of 2 core matrices (256
// bytes) a pass. The products are issued here and run on; the
// accumulators are complete after wgmma_wait
template <int R>
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[R], uint64_t ahi,
                                             uint64_t alo, uint64_t bhi,
                                             uint64_t blo, int steps) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int k = 0; k < steps; ++k)
    wgmma_k8(d, alo + 16 * k, bhi + 16 * k, k > 0);
  for (int k = 0; k < steps; ++k) wgmma_k8(d, ahi + 16 * k, blo + 16 * k, 1);
  for (int k = 0; k < steps; ++k) wgmma_k8(d, ahi + 16 * k, bhi + 16 * k, 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void wgmma_wait(float (&d)[R]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
}

// ---------------------------------------------------------------- K1, f32
// vol[e] = bf16((f1[e] @ pyr[e]^T) / 16) for f32 features on an f32
// pyramid (the flow/depth export's narrow route). Bound: operations (E=2
// at 30x101: 6.19 GFLOP, 0.092 ms at the f32 SIMT peak, against 0.016 ms
// for the 55 MB moved); three TF32 passes are 18.6 GFLOP at a rate seven
// times higher. The skeleton is the bf16 kernel's: a block owns one
// edge's 128-row tile of f1 (two warpgroups of 64 rows), split once into
// shared memory, and walks K1F_TILES tiles of 64 pyramid rows; each tile
// is 3 x C/8 wgmma.m64n64k8 per warpgroup. Both parts of both operands
// at C=128 are 192 KB, so there is one pyramid stage and the next tile
// waits in registers while this one is multiplied. The epilogue scales
// by 1/16, rounds to bf16 into a tile of its own (16-byte chunks XOR-
// swizzled by row) and writes 16-byte row vectors. Rows past HW are
// zero-filled and not stored; pyramid rows past N2 are zero-filled, so
// the pad columns store 0. The plain version's f32 products differ from
// these by the dropped lo.lo terms and the order of sums: the volume is
// held to one bf16 ulp everywhere and 99.9% bit-equal, not to equality.
constexpr int K1F_BM = 128, K1F_BN = 64, K1F_THREADS = 256;
constexpr int K1F_TILES = 8;

__host__ __device__ size_t k1f_smem_bytes(int C) {
  return (size_t)(K1F_BM + K1F_BN) * C * 8 + (size_t)K1F_BM * K1F_BN * 2;
}

__global__ void __launch_bounds__(K1F_THREADS, 1)
build_volumes_f32_kernel(const float* __restrict__ f1,
                         const float* __restrict__ pyr,
                         __nv_bfloat16* __restrict__ vol, int HW, int N2,
                         int N2p, int C, float scale) {
  extern __shared__ __align__(128) unsigned char k1f_smem[];
  const size_t a_bytes = (size_t)K1F_BM * C * 4;
  const size_t b_bytes = (size_t)K1F_BN * C * 4;
  unsigned char* Ahi = k1f_smem;
  unsigned char* Alo = Ahi + a_bytes;
  unsigned char* Bhi = Alo + a_bytes;
  unsigned char* Blo = Bhi + b_bytes;
  unsigned char* O = Blo + b_bytes;  // the 128 x 64 bf16 epilogue tile

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * K1F_BM;
  const int t0 = blockIdx.x * K1F_TILES;
  const int nt = min(K1F_TILES, N2p / K1F_BN - t0);
  const float* B = pyr + (size_t)e * N2 * C;
  __nv_bfloat16* V = vol + ((size_t)e * HW + m0) * N2p;

  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int kc = C / 4, sbo = C * 32;
  const int a_total = K1F_BM * kc, b_total = K1F_BN * kc;

  float4 pf[SPLIT_CHUNKS];
  int rk[SPLIT_CHUNKS];
  const TileRows<float> a_src{f1 + (size_t)e * HW * C, m0, HW, C};
  for (int q0 = 0; q0 < a_total; q0 += SPLIT_CHUNKS * K1F_THREADS) {
    chunk_map<K1F_THREADS>(rk, q0, kc);
    fetch_chunks<K1F_THREADS>(pf, rk, q0, a_total, a_src);
    store_chunks<K1F_THREADS>(pf, Ahi, Alo, q0, a_total);
  }
  chunk_map<K1F_THREADS>(rk, 0, kc);
  fetch_chunks<K1F_THREADS>(pf, rk, 0, b_total,
                            TileRows<float>{B, t0 * K1F_BN, N2, C});

  const uint64_t dah = wgmma_desc(smem_u32(Ahi) + wg * 64 * C * 4, sbo);
  const uint64_t dal = wgmma_desc(smem_u32(Alo) + wg * 64 * C * 4, sbo);
  const uint64_t dbh = wgmma_desc(smem_u32(Bhi), sbo);
  const uint64_t dbl = wgmma_desc(smem_u32(Blo), sbo);
  float d[32] = {};

  for (int n = 0; n < nt; ++n) {
    const int n0 = (t0 + n) * K1F_BN;
    store_chunks<K1F_THREADS>(pf, Bhi, Blo, 0, b_total);
    // this thread's stores, visible to the async proxy (wgmma)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the tile is whole; the last tile's O is stored

    wgmma_tf32x3(d, dah, dal, dbh, dbl, C / 8);
    // the next tile's loads run under the products
    if (n + 1 < nt)
      fetch_chunks<K1F_THREADS>(pf, rk, 0, b_total,
                                TileRows<float>{B, n0 + K1F_BN, N2, C});
    wgmma_wait(d);

    // accumulator (row 16*warp + lane/4 + 8i, column 8j + 2(lane%4) + c)
    // of this warpgroup is d[4j + 2i + c]; stage it as bf16, 16-byte
    // chunk j of row r at chunk j ^ (r % 8)
#pragma unroll
    for (int j = 0; j < K1F_BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wg * 64 + warp * 16 + lane / 4 + 8 * i;
        *reinterpret_cast<__nv_bfloat162*>(
            O + r * (K1F_BN * 2) + ((j ^ (r & 7)) * 16) + (lane % 4) * 4) =
            __floats2bfloat162_rn(d[4 * j + 2 * i] * scale,
                                  d[4 * j + 2 * i + 1] * scale);
      }
    __syncthreads();  // O is whole; both warpgroups are done with the tile
    for (int q = threadIdx.x; q < K1F_BM * K1F_BN / 8; q += K1F_THREADS) {
      const int r = q / (K1F_BN / 8), cj = q % (K1F_BN / 8);
      if (m0 + r < HW)
        *reinterpret_cast<uint4*>(V + (size_t)r * N2p + n0 + cj * 8) =
            *reinterpret_cast<const uint4*>(O + r * (K1F_BN * 2) +
                                            ((cj ^ (r & 7)) * 16));
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
// picks its taps from there (zero outside the level): patch_row
// (corr_common.cuh), which P2 shares. The row below
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
  if (live) wn = window_at(coords + (size_t)pix * 2, ll);
  float v[PATCH];
  patch_row(v, win[threadIdx.x], vol + (size_t)pix * N2, N2, wn, r, live,
            lv.off[ll], lv.h[ll], W);
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

// ---------------------------------------------------------------- K3, f32
// The kernel for f32 features (the flow/depth export's step, the motion
// filter's probe) and for bf16 features whose C is no multiple of 16, on
// an f32 pyramid. Bound: operations (E=2 at 47x156: 0.96 GFLOP of tap
// products, 0.014 ms at the f32 SIMT peak, 26.6 MB to move), and at one
// or two edges the launch is small: what sets its time is how many
// blocks are in flight and how long the longest one runs.
//
// The design is the bf16 kernel's (below) on split f32 operands: a block
// owns an 8 x 8 tile of neighbouring query pixels of one edge at one
// level, its f1 rows split into two TF32 parts in shared memory; it
// takes the bounding box of its pixels' 8x8 integer patches, clipped to
// the level (15 x 15 positions at level 0 on smooth coordinates), and
// streams the box's pooled rows 32 at a time: fetched into registers
// while the tile before is multiplied, split and stored, then 3 x C/8
// wgmma.m64n32k8 (lo.hi + hi.lo + hi.hi, f32 accumulators), so a pooled
// row is read once per 64 pixels, not once per tap and pixel. The
// products go to a shared 64 x 32 tile (row stride 40 floats); two
// threads per pixel pick the taps of their half of the patch, blend the
// 7x7 window, stage it in output order, and a warp stores each pixel's
// 49 floats on consecutive addresses. Edge e reads frames ii[e] and
// jj[e] (e where they are null).
//
// The level is on the grid, level 0 first (blockIdx.z = l * E + e), and
// the tile is 64 pixels, not 128: E=2 at 47x156 is 960 blocks and the
// probe (E=1 at 30x101) 208, two to an SM (both parts of a 64-pixel
// tile and of a 32-row stage are 96 KB at C=128), where 128-pixel
// blocks that walk the levels would be 120 and 28 for 132 SMs. Measured
// on an H100 at E=2, 47x156 and E=1, 30x101: a block per level 0.082 and
// 0.030 ms; two blocks a tile (level 0, and the levels above it, which
// stage the f1 tile half as often) 0.084 and 0.034 ms; one block to an
// SM (a larger rows table) 0.146 ms at E=2. A block's phases run one
// after the other on four warps (scripts/corr_probe.py f32: without the
// box tiles' loads 0.066 of 0.094 ms, without the products 0.068,
// neither tile work nor store 0.024), so blocks in flight are what
// hides them.
//
// A level whose box exceeds K3F_BOX_CAP positions (scattered or wild
// coordinates) takes per-pixel f32 dot products instead: each thread 32
// taps of its pixel, both rows from global memory. routes[0] counts the
// blocks on the tensor cores, routes[1] those on the per-pixel route.
constexpr int K3F_TH = 8, K3F_TW = 8, K3F_PIX = K3F_TH * K3F_TW;
constexpr int K3F_THREADS = 2 * K3F_PIX;  // one warpgroup
constexpr int K3F_BN = 32;                // box positions per tile
constexpr int K3F_LD = K3F_BN + 8;        // product tile row stride
constexpr int K3F_BOX_CAP = 768, K3F_BLOCKS_PER_SM = 2;
// the product tile, reused as the stage of the level's windows
constexpr int K3F_TILE_FLOATS = K3F_PIX * (K3F_LD > TAPS ? K3F_LD : TAPS);
static_assert(K3F_THREADS == 128, "one warpgroup of 64 rows");

__host__ __device__ size_t k3f_smem_bytes(int C) {
  return (size_t)(K3F_PIX + K3F_BN) * C * 8 +
         sizeof(float) * K3F_TILE_FLOATS + sizeof(int) * (K3F_BOX_CAP + 4);
}

// the f1 rows of the block's pixel tile: row r is pixel (y0 + r / 8,
// x0 + r % 8) of frame A, pixels outside the image as 0
template <typename T>
struct PixelRows {
  const T* A;
  int y0, x0, H, W, C;
  __device__ const T* operator()(int r) const {
    const int y = y0 + r / K3F_TW, x = x0 + r % K3F_TW;
    return y < H && x < W ? A + ((size_t)y * W + x) * C : nullptr;
  }
};

// box positions p0.. (pyramid rows rows[p]; positions from np on as 0)
struct BoxRows {
  const float* B;
  const int* rows;
  int p0, np, C;
  __device__ const float* operator()(int r) const {
    return p0 + r < np ? B + (size_t)rows[p0 + r] * C : nullptr;
  }
};

template <typename T1>
__global__ void __launch_bounds__(K3F_THREADS, K3F_BLOCKS_PER_SM)
corr_lookup_f32_kernel(const T1* __restrict__ f1,
                       const float* __restrict__ pyr,
                       const int* __restrict__ ii, const int* __restrict__ jj,
                       const float* __restrict__ coords,
                       float* __restrict__ out,
                       unsigned long long* __restrict__ routes, int E, int H,
                       int W, int N2, int C, float scale, Levels lv) {
  extern __shared__ __align__(128) unsigned char k3f_smem[];
  const size_t a_bytes = (size_t)K3F_PIX * C * 4;
  const size_t b_bytes = (size_t)K3F_BN * C * 4;
  unsigned char* Ahi = k3f_smem;
  unsigned char* Alo = Ahi + a_bytes;
  unsigned char* Bhi = Alo + a_bytes;
  unsigned char* Blo = Bhi + b_bytes;
  float* corr = reinterpret_cast<float*>(Blo + b_bytes);
  int* rows = reinterpret_cast<int*>(corr + K3F_TILE_FLOATS);
  int* box = rows + K3F_BOX_CAP;  // x0, y0, x1, y1
  float* stage = corr;            // the level's windows, [pixel][49]

  const int l = blockIdx.z / E, e = blockIdx.z % E, HW = H * W;
  const int y0 = blockIdx.y * K3F_TH, x0 = blockIdx.x * K3F_TW;
  const T1* A = f1 + (size_t)(ii ? ii[e] : e) * HW * C;
  const float* B = pyr + (size_t)(jj ? jj[e] : e) * N2 * C;
  const int Wl = lv.w[l], Hl = lv.h[l], off = lv.off[l];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kc = C / 4, sbo = C * 32;
  const int a_total = K3F_PIX * kc, b_total = K3F_BN * kc;

  if (threadIdx.x < 4) box[threadIdx.x] = threadIdx.x < 2 ? INT_MAX : INT_MIN;

  float4 pf[SPLIT_CHUNKS];
  int rk[SPLIT_CHUNKS];
  const PixelRows<T1> a_src{A, y0, x0, H, W, C};
  for (int q0 = 0; q0 < a_total; q0 += SPLIT_CHUNKS * K3F_THREADS) {
    chunk_map<K3F_THREADS>(rk, q0, kc);
    fetch_chunks<K3F_THREADS>(pf, rk, q0, a_total, a_src);
    store_chunks<K3F_THREADS>(pf, Ahi, Alo, q0, a_total);
  }

  // this thread's pixel and its half of the pixel's 8x8 patch
  const int p = threadIdx.x / 2, half = threadIdx.x % 2;
  const int py = y0 + p / K3F_TW, px = x0 + p % K3F_TW;
  const bool live = py < H && px < W;
  const size_t pix = (size_t)e * HW + (live ? py * W + px : 0);
  float cxy[2] = {0.f, 0.f};
  if (live) {
    cxy[0] = coords[pix * 2];
    cxy[1] = coords[pix * 2 + 1];
  }
  const Window wn = window_at(cxy, l);
  // the patch holds a tap of the level (false for NaN, huge origins)
  const bool v = live && wn.bx + (PATCH - 1) >= 0.0f && wn.bx < float(Wl) &&
                 wn.by + (PATCH - 1) >= 0.0f && wn.by < float(Hl);
  const int ibx = v ? (int)wn.bx : 0, iby = v ? (int)wn.by + half * 4 : 0;

  // bounding box of the block's patches, clipped to the level
  __syncthreads();
  {
    const int by = iby - half * 4;
    const int lo_x = __reduce_min_sync(0xffffffffu, v ? max(ibx, 0) : INT_MAX);
    const int lo_y = __reduce_min_sync(0xffffffffu, v ? max(by, 0) : INT_MAX);
    const int hi_x = __reduce_max_sync(
        0xffffffffu, v ? min(ibx + PATCH - 1, Wl - 1) : INT_MIN);
    const int hi_y = __reduce_max_sync(
        0xffffffffu, v ? min(by + PATCH - 1, Hl - 1) : INT_MIN);
    if (lane == 0) {
      atomicMin(box, lo_x);
      atomicMin(box + 1, lo_y);
      atomicMax(box + 2, hi_x);
      atomicMax(box + 3, hi_y);
    }
  }
  __syncthreads();

  const int bx0 = box[0], by0 = box[1];
  const bool any = bx0 <= box[2];
  const int bw = any ? box[2] - bx0 + 1 : 0;
  const int np = any ? bw * (box[3] - by0 + 1) : 0;
  const bool boxed = np <= K3F_BOX_CAP;  // the same for the whole block
  if (threadIdx.x == 0) atomicAdd(routes + (boxed ? 0 : 1), 1ULL);

  unsigned xm = 0, ym = 0;  // taps (patch rows of this half) in the level
  if (v) {
#pragma unroll
    for (int c = 0; c < PATCH; ++c)
      xm |= (unsigned)(ibx + c >= 0 && ibx + c < Wl) << c;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      ym |= (unsigned)(iby + r >= 0 && iby + r < Hl) << r;
    if (ym == 0) xm = 0;
  }

  float pt[4][PATCH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < PATCH; ++c) pt[r][c] = 0.0f;

  if (boxed) {
    for (int q = threadIdx.x; q < np; q += K3F_THREADS) {
      const int y = q / bw;
      rows[q] = off + (by0 + y) * Wl + bx0 + (q - y * bw);
    }
    __syncthreads();  // rows ready
    const int nt = (np + K3F_BN - 1) / K3F_BN;
    // box position of this thread's tap (row 0, column 0)
    const int p00 = (iby - by0) * bw + (ibx - bx0);
    const uint64_t dah = wgmma_desc(smem_u32(Ahi), sbo);
    const uint64_t dal = wgmma_desc(smem_u32(Alo), sbo);
    const uint64_t dbh = wgmma_desc(smem_u32(Bhi), sbo);
    const uint64_t dbl = wgmma_desc(smem_u32(Blo), sbo);
    float d[16] = {};
    chunk_map<K3F_THREADS>(rk, 0, kc);
    if (nt > 0)
      fetch_chunks<K3F_THREADS>(pf, rk, 0, b_total,
                                BoxRows{B, rows, 0, np, C});
    for (int n = 0; n < nt; ++n) {
      store_chunks<K3F_THREADS>(pf, Bhi, Blo, 0, b_total);
      // this thread's stores, visible to the async proxy (wgmma)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // tile n is whole; the last tile's gather is over

      wgmma_tf32x3(d, dah, dal, dbh, dbl, C / 8);
      // the next tile's loads run under the products
      if (n + 1 < nt)
        fetch_chunks<K3F_THREADS>(pf, rk, 0, b_total,
                                  BoxRows{B, rows, (n + 1) * K3F_BN, np, C});
      wgmma_wait(d);
      // accumulator d[4j + 2i + c] is (row 16*warp + lane/4 + 8i,
      // column 8j + 2(lane%4) + c) of the block's 64 pixels
#pragma unroll
      for (int j = 0; j < K3F_BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = warp * 16 + lane / 4 + 8 * i;
          *reinterpret_cast<float2*>(corr + row * K3F_LD + 8 * j +
                                     2 * (lane % 4)) =
              make_float2(d[4 * j + 2 * i] * scale,
                          d[4 * j + 2 * i + 1] * scale);
        }
      __syncthreads();  // products visible; the stage may be refilled

      const float* mine = corr + p * K3F_LD - n * K3F_BN;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pr = p00 + r * bw;
        // no tap of this row in columns [n*32, n*32 + 32)
        if (!((ym >> r) & 1) || pr + PATCH <= n * K3F_BN ||
            pr >= (n + 1) * K3F_BN)
          continue;
#pragma unroll
        for (int c = 0; c < PATCH; ++c)
          if (((xm >> c) & 1) &&
              (unsigned)(pr + c - n * K3F_BN) < (unsigned)K3F_BN)
            pt[r][c] = mine[pr + c];
      }
    }
    __syncthreads();  // every gather is over: the tile becomes the stage
  } else {
    // 8 channels of the pixel's f1 row at a time against all of the
    // thread's taps: 32 independent sums, each in channel order
    const T1* a = A + (live ? (size_t)(py * W + px) * C : 0);
    const float* Bl = B + (size_t)off * C;
    for (int k = 0; k < C; k += 8) {
      const float4 a0 = load4(a + k), a1 = load4(a + k + 4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PATCH; ++c) {
          if (!(((ym >> r) & 1) && ((xm >> c) & 1))) continue;
          const float* b = Bl + ((iby + r) * Wl + ibx + c) * C + k;
          const float4 b0 = load4(b), b1 = load4(b + 4);
          float s = pt[r][c];
          s = fmaf(a0.x, b0.x, s);
          s = fmaf(a0.y, b0.y, s);
          s = fmaf(a0.z, b0.z, s);
          s = fmaf(a0.w, b0.w, s);
          s = fmaf(a1.x, b1.x, s);
          s = fmaf(a1.y, b1.y, s);
          s = fmaf(a1.z, b1.z, s);
          s = fmaf(a1.w, b1.w, s);
          pt[r][c] = s;
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < PATCH; ++c) pt[r][c] *= scale;
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
  const int n_out = lv.n * TAPS;
  for (int qp = warp; qp < K3F_PIX; qp += K3F_THREADS / 32) {
    const int qy = y0 + qp / K3F_TW, qx = x0 + qp % K3F_TW;
    if (qy >= H || qx >= W) continue;
    float* o = out + ((size_t)e * HW + qy * W + qx) * n_out + l * TAPS;
    o[lane] = stage[qp * TAPS + lane];
    if (lane + 32 < TAPS) o[lane + 32] = stage[qp * TAPS + lane + 32];
  }
}

// ---------------------------------------------------------------- K3, bf16
// The kernel of the main path (bf16 features, C a multiple of 16, a bf16
// pyramid). Bound: memory, mostly the f32 output (E=256 at 30x101: 1.01
// GB moved against 51 GFLOP, 0.30 ms against 0.05 ms at the bf16 peak),
// so the products may be wasteful as long as every pooled row is read
// few times. The body is lookup_tc_body (corr_tc.cuh), which P1 shares:
// the bounding-box route on the tensor cores, boxes over the cap per
// pixel. What is K3's own is the epilogue: two threads per pixel blend
// the 7x7 window from their half patches (patch row 4 crosses from the
// second thread to the first by a shuffle), stage it in the product
// tile's memory in output order, and the block stores each pixel's 49
// floats of the level, a warp on consecutive addresses.
struct WindowEpilogue {
  float* out;  // (E, HW, L*49)

  __device__ __forceinline__ void operator()(int l, const Window& wn,
                                             const float (&pt)[4][PATCH],
                                             float* stage,
                                             const LookupTile& t,
                                             const Levels& lv) const {
    const int p = t.p, half = t.half, lane = t.lane;
    // patch row 4 (the second thread's first row) for the first thread
    float nx[PATCH];
#pragma unroll
    for (int c = 0; c < PATCH; ++c)
      nx[c] = __shfl_down_sync(0xffffffffu, pt[0][c], 1);
    if (t.live) {
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
    const int n_out = lv.n * TAPS;
    for (int qp = threadIdx.x / 32; qp < K3T_PIX; qp += K3T_THREADS / 32) {
      const int qy = t.y0 + qp / K3T_TW, qx = t.x0 + qp % K3T_TW;
      if (qy >= t.H || qx >= t.W) continue;
      float* o = out + ((size_t)t.e * t.H * t.W + qy * t.W + qx) * n_out +
                 l * TAPS;
      o[lane] = stage[qp * TAPS + lane];
      if (lane + 32 < TAPS) o[lane + 32] = stage[qp * TAPS + lane + 32];
    }
  }
};

__global__ void __launch_bounds__(K3T_THREADS, K3T_BLOCKS_PER_SM)
corr_lookup_tc_kernel(const __nv_bfloat16* __restrict__ f1,
                      const __nv_bfloat16* __restrict__ pyr,
                      const int* __restrict__ ii, const int* __restrict__ jj,
                      const float* __restrict__ coords,
                      float* __restrict__ out,
                      unsigned long long* __restrict__ routes, int H, int W,
                      int N2, int C, float scale, Levels lv) {
  lookup_tc_body<false>(f1, pyr, ii, jj, coords, routes, H, W, N2, C, scale,
                        lv, WindowEpilogue{out});
}

}  // namespace

// shared memory a block may ask for on sm_90
constexpr size_t MAX_SMEM = 232448;

template <typename T1>
int launch_lookup_f32(const void* f1, const void* pyr, const int* ii,
                      const int* jj, const void* coords, void* out,
                      void* routes, int E, int H, int W, int N2, int C,
                      float scale, const Levels& lv, cudaStream_t s) {
  // C in wgmma k8 steps, a tile's chunks in two rounds of registers
  // (C <= 128), edges x levels on the grid's z axis
  if (C % 8 || C > 128 || E * lv.n > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = k3f_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      corr_lookup_f32_kernel<T1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)  // two blocks of 111 KB to an SM
    err = cudaFuncSetAttribute(corr_lookup_f32_kernel<T1>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  corr_lookup_f32_kernel<T1><<<dim3((W + K3F_TW - 1) / K3F_TW,
                                    (H + K3F_TH - 1) / K3F_TH, E * lv.n),
                               K3F_THREADS, smem, s>>>(
      static_cast<const T1*>(f1), static_cast<const float*>(pyr), ii, jj,
      static_cast<const float*>(coords), static_cast<float*>(out),
      static_cast<unsigned long long*>(routes), E, H, W, N2, C, scale, lv);
  return (int)cudaGetLastError();
}

extern "C" {

int pvo_build_volumes(const void* f1, const void* pyr, void* vol,
                      int bf16, int E, int HW, int N2, int N2p, int C,
                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    // three TF32 passes: C in wgmma k8 steps, both parts of both tiles
    // in shared memory (C <= 128), the row stride in 64-column tiles
    const size_t smem = k1f_smem_bytes(C);
    if (C % 8 || smem > MAX_SMEM || N2p % K1F_BN)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        build_volumes_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = N2p / K1F_BN;
    build_volumes_f32_kernel<<<dim3((n_tiles + K1F_TILES - 1) / K1F_TILES,
                                    (HW + K1F_BM - 1) / K1F_BM, E),
                               K1F_THREADS, smem, s>>>(
        static_cast<const float*>(f1), static_cast<const float*>(pyr),
        static_cast<__nv_bfloat16*>(vol), HW, N2, N2p, C, scale);
    return (int)cudaGetLastError();
  }
  const int m_tiles = (HW + K1_BM - 1) / K1_BM;
  const int n_tiles = (N2p + K1_BN - 1) / K1_BN;
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
// pyramid (both the f32 kernel, C a multiple of 8 up to 128); 2: bf16
// features on a bf16 pyramid, C a multiple of 16 (the bf16 kernel).
// Edge e reads frames ii[e] and jj[e], or frame e where they are null;
// routes: two 64-bit counters
int pvo_corr_lookup(const void* f1, const void* pyr, const int* ii,
                    const int* jj, const void* coords, void* out,
                    void* routes, int kind, int E, int H, int W, int N2,
                    int C, float scale, int n_levels, const int* level_hw,
                    void* stream) {
  const Levels lv = make_levels(n_levels, level_hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  if (kind == 1)
    return launch_lookup_f32<__nv_bfloat16>(f1, pyr, ii, jj, coords, out,
                                            routes, E, H, W, N2, C, scale, lv,
                                            s);
  return launch_lookup_f32<float>(f1, pyr, ii, jj, coords, out, routes, E, H,
                                  W, N2, C, scale, lv, s);
}

}  // extern "C"
