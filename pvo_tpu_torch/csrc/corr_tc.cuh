// Tensor-core pieces that corr.cu and corr_exp.cu share: the wgmma
// operand layout and its loads (K1, K3, P1), and the body of the fused
// bf16 lookup, which K3 (corr.cu) runs with its 49-tap f32 epilogue and
// P1 (corr_exp.cu) with the packed bf16 one. Included once per
// translation unit; everything is internal to it.
//
// Shared-memory operand layout (the wgmma K-major layout without
// swizzle): 8x8 core matrices of 128 contiguous bytes, (row r, k) at
// ((r/8)*(C/8) + k/8)*128 + (r%8)*16 + (k%8)*2. Core matrices adjacent
// in K are 128 bytes apart (the descriptor's leading byte offset), 8-row
// groups C*16 bytes apart (its stride byte offset).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "corr_common.cuh"

namespace {

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

// shared-memory matrix descriptor, no swizzle: start address, leading
// byte offset 128 (bits 16-29) and stride byte offset sbo (bits 32-45),
// each in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// keeps the compiler from moving accumulator reads across the wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ------------------------------------------- the fused bf16 lookup (K3, P1)
// bf16 features, C a multiple of 16, a bf16 pyramid.
//
// A block owns an 8 x 16 tile of neighbouring query pixels of one edge
// and keeps their f1 rows in shared memory in the wgmma layout. Per
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
// the last tile the epilogue takes the patch: it blends, stages the
// level's outputs in the product tile's memory and stores them.
// Measured on an H100: two blocks per SM with a 2-stage ring beat one
// block with a ring of 3 to 9 stages by a third: the block's own
// arithmetic and barriers, not the loads' latency, set its time.
//
// A level whose box exceeds K3T_BOX_CAP positions (scattered or wild
// coordinates) has no table of its rows in shared memory. It takes
// per-pixel dot products against the bf16 pyramid instead: each thread
// 32 taps of its pixel, f1 from shared memory. Or, with DENSE, it stays
// on the tensor cores and works each position's pyramid row out as its
// tile is loaded (under uniform coordinates the box is the whole level:
// 48 tiles at 30x101). routes[0] counts the (block, level) pairs whose
// box is within the cap, routes[1] those above it.
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

// the f1 rows of the block's pixel tile (row r = pixel (y0 + r / 16,
// x0 + r % 16) of frame A; pixels outside the image as 0) into the
// core-matrix layout at dst; consecutive threads fill consecutive
// 16-byte chunks: chunk q is row 8g + q%8, columns 8kk.., with
// q/8 = g*(C/8) + kk. A zero-filled chunk reads nothing and is given a
// valid address all the same.
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

// the pyramid row of box position p: from the block's table, or worked
// out from the box (first = the row of position 0; a box as wide as the
// level is a run of rows)
struct TableRow {
  const int* rows;
  __device__ int operator()(int p) const { return rows[p]; }
};
struct ComputedRow {
  int first, bw, Wl;
  __device__ int operator()(int p) const {
    if (bw == Wl) return first + p;
    const int y = p / bw;
    return first + y * Wl + (p - y * bw);
  }
};

// box positions p0..p0+63 (pyramid rows row(p); positions from np on
// as 0) of frame B into the core-matrix layout at dst
template <typename Row>
__device__ __forceinline__ void load_box_tile(uint32_t dst,
                                              const __nv_bfloat16* B,
                                              const Row& row, int p0,
                                              int np, int C) {
  const int kc = C / 8, r = threadIdx.x & 7;
  int g = (threadIdx.x >> 3) / kc, kk = (threadIdx.x >> 3) % kc;
  for (int q = threadIdx.x; q < K3T_BN * kc; q += K3T_THREADS) {
    const int p = p0 + g * 8 + r;
    const bool ok = p < np;
    cp_async16(dst + q * 16, B + (ok ? (size_t)row(p) * C + kk * 8 : 0),
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

// what an epilogue is told of the block and of the calling thread: the
// edge, the tile's first pixel, the thread's pixel p of the tile (image
// pixel (y0 + p / 16, x0 + p % 16), inside the image if live) and which
// half of its patch (rows 4*half..) the thread holds
struct LookupTile {
  int e, y0, x0, H, W, p, half, lane;
  bool live;
};

// The body of the fused lookup. epi(l, wn, pt, stage, tile, lv) is
// called by every thread once per level, after a block barrier, with
// its pixel's window wn at level l and its half patch pt (products
// times scale; 0 for taps outside the level); stage is the product
// tile's memory (K3T_PIX * K3T_LD floats), free until the epilogue
// returns: the next level's first barrier comes before it is touched.
template <bool DENSE, typename Epilogue>
__device__ __forceinline__ void lookup_tc_body(
    const __nv_bfloat16* __restrict__ f1,
    const __nv_bfloat16* __restrict__ pyr, const int* __restrict__ ii,
    const int* __restrict__ jj, const float* __restrict__ coords,
    unsigned long long* __restrict__ routes, int H, int W, int N2, int C,
    float scale, const Levels& lv, const Epilogue& epi) {
  extern __shared__ __align__(128) unsigned char k3_smem[];
  const size_t stage_bytes = (size_t)K3T_BN * C * 2;
  unsigned char* As = k3_smem;
  unsigned char* Bs = As + (size_t)K3T_PIX * C * 2;
  float* corr = reinterpret_cast<float*>(Bs + K3T_STAGES * stage_bytes);
  int* rows = reinterpret_cast<int*>(corr + K3T_PIX * K3T_LD);
  int* box = rows + K3T_BOX_CAP;  // per level x0, y0, x1, y1

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
  const LookupTile tile = {e, y0, x0, H, W, p, half, lane, live};

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
  float d[32] = {};

  for (int l = 0; l < lv.n; ++l) {
    const int Wl = lv.w[l], Hl = lv.h[l];
    const int bx0 = box[4 * l], by0 = box[4 * l + 1];
    const bool any = bx0 <= box[4 * l + 2];
    const int bw = any ? box[4 * l + 2] - bx0 + 1 : 0;
    const int np = any ? bw * (box[4 * l + 3] - by0 + 1) : 0;
    const bool tabled = np <= K3T_BOX_CAP;  // the same for the whole block
    if (threadIdx.x == 0) atomicAdd(routes + (tabled ? 0 : 1), 1ULL);

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

    if (tabled || DENSE) {
      const int first = lv.off[l] + by0 * Wl + bx0;
      if (tabled)
        for (int q = threadIdx.x; q < np; q += K3T_THREADS) {
          const int y = q / bw;
          rows[q] = first + y * Wl + (q - y * bw);
        }
      __syncthreads();  // rows ready; the last level's stage is stored
      const int nt = (np + K3T_BN - 1) / K3T_BN;
      const auto fetch = [&](int t) {
        const uint32_t dst = smem_u32(Bs + (t % K3T_STAGES) * stage_bytes);
        if (DENSE && !tabled)
          load_box_tile(dst, B, ComputedRow{first, bw, Wl}, t * K3T_BN, np,
                        C);
        else
          load_box_tile(dst, B, TableRow{rows}, t * K3T_BN, np, C);
      };
      // box position of this thread's tap (row 0, column 0)
      const int p00 = (iby - by0) * bw + (ibx - bx0);
      // every tile is one cp.async group, empty past the last tile, so
      // that the groups in flight count the same at every step
      for (int t = 0; t < K3T_STAGES - 1; ++t) {
        if (t < nt)
          fetch(t);
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
          fetch(ahead);
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

    epi(l, wn, pt, corr, tile, lv);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
