// The dense bundle adjustment's f32 contractions for Hopper (sm_90a):
// the linearization of each edge, the Schur terms with the rhs
// correction, and the depth back-substitution
// (pvo_tpu_torch/vo/net/cuda_dba.py, called by vo/dba.py).
//
// No TPU kernel matches these: the JAX package leaves this work to XLA
// (pvo_tpu/geom/ba.py:59-93 _edge_blocks, pvo_tpu/vo/dba.py:117-270). They
// were einsums on the card, which cuBLAS ran as gemv and small f32 GEMMs:
// about 21 ms of a replayed planner frame's 76.3 ms of kernels, in 228
// launches. The work itself is small: at the planner's full regime (E=144
// edges, K=32 depth frames, 2048 pair slots, HW=30x101) an iteration moves
// about 61 MB, some 20 us at 3.35 TB/s. Every sum is f32 with FFMA, in a
// fixed order, with no atomics on a value, so a call repeats itself bit
// for bit and a CUDA-graph replay equals the eager call.
//
// dba_linearize_kernel: a cluster of LIN_CLUSTER blocks an edge, each
//   block a slice of its pixels, LIN_PIX pixels a thread a step (8- and
//   16-byte loads and stores where HW is even). Ji = -Jj Adj(Gij), with
//   Adj constant over the edge, so a thread keeps only Hjj's upper
//   triangle and vj (27 sums, not the 90 of [Ji, Jj]); it writes the
//   per-pixel Ej, Ei = -Adj^T Ej, Ck and wk from registers. The block sums
//   its threads' in a fixed tree (xor butterfly, then the warps in
//   order), the cluster's first block the blocks' through distributed
//   shared memory in rank order, and forms once per edge Hblk = [[Adj^T
//   Hjj Adj, -Adj^T Hjj], [-Hjj Adj, Hjj]] and vblk = [-Adj^T vj; vj].
//   An invalid edge writes zeros and reads nothing. Bound: the bytes of
//   target, weight, disps[ii] read and the 14 planes written (motion
//   only: the operations).
// dba_schur_kernel: one weighted Gram per depth frame. Every Schur item
//   of frame q is a 6x6 block of M_q Q_q M_q^T, M_q = [Ei_m[q]; Ej[e] for
//   the edges e with m[e] == q, in edge order] and Q = 1 / (C + eta) per
//   pixel: (a) self x self, (b) self x edge (and its transpose), (c) edge
//   x edge for every pair slot, whose edges share a depth frame
//   (build_edge_pairs' pairs share the source frame); the rhs correction
//   rc is the self row of blocks against w_m[q]. So each plane is read
//   from device memory once, and a pair of edges is summed once for both
//   of its slots. A cluster of SC_CLUSTER blocks takes a job, each block
//   a slice of the pixels; the kernel launches SC_WAVE clusters (the
//   wave an H100 holds at once) and each takes its jobs in turn. A job
//   is a frame, or a share of a large frame's blocks: a frame whose
//   blocks pass the mean share of a cluster is split, and the jobs,
//   largest first, are dealt over the clusters there and back. The
//   kernel builds each frame's group from m in shared memory (a stable
//   compaction; no index lists come from the host) and marks the edges
//   some valid slot pairs: an edge no slot pairs (an invalid edge) takes
//   only its self x edge block. The rows [self; group] are cut into
//   tiles of SC_TB six-row blocks; for each pair of tiles with a needed
//   block, the rows' pixels are staged in shared memory by 4-byte
//   cp.async (a plane's stride at 30x101, 12120 bytes, is 8- but not
//   16-byte aligned), double-buffered, the first stage in flight while
//   the slots are marked, and Q and Q w formed once a pixel. A thread
//   sums one block (36 sums, and its rc where the left side is self)
//   over a lane of pixels; the lanes are added in order, the cluster's
//   blocks in rank order through distributed shared memory, and the rows
//   written: (a), (b) and rc by the block that adds them, (c) through the
//   slots each block resolved. An invalid slot, or one whose edges'
//   frames differ, gets zeros. Integer atomics only count and mark; no
//   value is summed by one. Bound: its inputs' bytes read once (the
//   operations where the groups are large); at the planner's shape a
//   cluster launch (about 5-10 us empty) and the phases each job runs in
//   turn (group, marks, sums, lanes, cluster sums, slots) are most of it.
// dba_backsub_kernel<EDGES>: a thread a pixel. The edge pass writes each
//   edge's Ej dx[pj] (summed per depth frame by the segment sum); the
//   depth pass forms dz = Q (w - Ei_m dx[pm] - t_edge) and writes the
//   updated disparities of every frame, clamped at 0.001.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LIN_THREADS = 256;
constexpr int LIN_WARPS = LIN_THREADS / 32;
constexpr int LIN_CLUSTER = 2;
constexpr int NLIN = 27;            // Hjj's upper triangle, then vj
constexpr int SC_THREADS = 256;
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int SC_CLUSTER = 6;
constexpr int SC_TB = 16;           // six-row blocks of a row tile
constexpr int SC_ROWS = 12 * SC_TB + 3;  // two tiles, C, eta, w
constexpr int SC_UNITS = SC_TB * SC_TB;  // blocks of a tile pair
constexpr int SC_NU = 42;           // a block's 36 sums and its rc's 6
constexpr int SC_SLOTS = 4;         // pair slots a thread keeps resolved
constexpr int SC_SPLIT = 4;         // jobs a frame at most
constexpr float SC_JOB_MIN = 24.f;  // a split job's blocks at least
// the clusters launched: as many as an H100 SXM holds at once at two
// blocks an SM (cudaOccupancyMaxActiveClusters); a constant, so that the
// jobs, and the order of the sums, depend on the call's shapes alone
constexpr int SC_WAVE = 39;
// a rank's share of a tile pair's block sums
constexpr int SC_FIN = (SC_UNITS + SC_CLUSTER - 1) / SC_CLUSTER * 36;
// the stages' floats: at most SC_STAGE (two blocks an SM), at least two
// stages of 32 pixels of every row, and the lanes' sums
constexpr int SC_STAGE = 24000;
constexpr int SC_STAGE_MIN = 2 * SC_ROWS * 33;
constexpr int SC_SMEM = 232448 - 4096;  // the block's shared memory, less static
constexpr int BACK_THREADS = 256;
constexpr float MIN_DEPTH = 0.2f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(SC_UNITS <= SC_THREADS, "a tile pair's blocks a thread each");
static_assert(SC_THREADS * SC_NU <= SC_STAGE_MIN,
              "the lanes' sums fit the stages");

struct LinParams {
  const float *poses, *disps, *intr, *target, *weight;
  const int64_t *ii, *jj;
  const uint8_t* valid;
  float *Hblk, *vblk, *Ei, *Ej, *Ck, *wk;  // Ei..wk null: motion only
  int H, W;
};

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// p rotated by the unit quaternion q = [x, y, z, w] (lie/so3.quat_rotate)
__device__ void quat_rotate(const float q[4], const float p[3], float o[3]) {
  float uv[3], uuv[3];
  cross3(q, p, uv);
  cross3(q, uv, uuv);
  for (int i = 0; i < 3; ++i) o[i] = p[i] + 2.f * (q[3] * uv[i] + uuv[i]);
}

// Gij = poses[j] * poses[i]^-1 as its rotation R, [t]x R and t, into
// g[0:9], g[9:18], g[18:21] (lie/se3.mul, inv, adj_matrix)
__device__ void relative_pose(const float* gi, const float* gj, float* g) {
  const float qi[4] = {-gi[3], -gi[4], -gi[5], gi[6]};
  float ti[3];
  quat_rotate(qi, gi, ti);
  for (int k = 0; k < 3; ++k) ti[k] = -ti[k];
  const float qj[4] = {gj[3], gj[4], gj[5], gj[6]};
  float q[4], c[3], t[3];
  q[3] = qj[3] * qi[3] - (qj[0] * qi[0] + qj[1] * qi[1] + qj[2] * qi[2]);
  cross3(qj, qi, c);
  for (int k = 0; k < 3; ++k) q[k] = qj[3] * qi[k] + qi[3] * qj[k] + c[k];
  quat_rotate(qj, ti, t);
  for (int k = 0; k < 3; ++k) t[k] += gj[k];
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float R[9] = {
      1.f - 2.f * (y * y + z * z), 2.f * (x * y - w * z), 2.f * (x * z + w * y),
      2.f * (x * y + w * z), 1.f - 2.f * (x * x + z * z), 2.f * (y * z - w * x),
      2.f * (x * z - w * y), 2.f * (y * z + w * x), 1.f - 2.f * (x * x + y * y)};
  const float hat[9] = {0.f, -t[2], t[1], t[2], 0.f, -t[0], -t[1], t[0], 0.f};
  for (int r = 0; r < 3; ++r)
    for (int col = 0; col < 3; ++col) {
      g[r * 3 + col] = R[r * 3 + col];
      g[9 + r * 3 + col] = hat[r * 3] * R[col] + hat[r * 3 + 1] * R[3 + col] +
                           hat[r * 3 + 2] * R[6 + col];
    }
  for (int k = 0; k < 3; ++k) g[18 + k] = t[k];
}

// Adj(Gij)[k][d] from g (relative_pose): [[R, [t]x R], [0, R]], so that
// Ji = -Jj Adj
__device__ __forceinline__ float adj_at(const float* g, int k, int d) {
  if (k < 3) return d < 3 ? g[3 * k + d] : g[9 + 3 * k + d - 3];
  return d < 3 ? 0.f : g[3 * (k - 3) + d - 3];
}

// index of (d, c), d <= c < 6, in a row-major upper triangle
__device__ __forceinline__ int tri6(int d, int c) {
  return d * 6 - d * (d - 1) / 2 + c - d;
}

// one pixel: its sums into acc, and its Ei, Ej, Ck, wk (when `planes`)
template <bool PLANES>
__device__ __forceinline__ void lin_pixel(const float* G, float fx, float fy,
                                          float cx, float cy, int px, int W,
                                          float hc, float t0, float t1,
                                          float wt0, float wt1, float* acc,
                                          float ej[6], float ei[6], float& ck,
                                          float& wk) {
  // iproj, act4, proj (geom/projective.projective_jacobian_planes)
  const float X = ((float)(px % W) - cx) / fx;
  const float Y = ((float)(px / W) - cy) / fy;
  const float Xp = G[0] * X + G[1] * Y + G[2] + G[18] * hc;
  const float Yp = G[3] * X + G[4] * Y + G[5] + G[19] * hc;
  const float Zu = G[6] * X + G[7] * Y + G[8] + G[20] * hc;
  const float a = 1.f / (Zu < 0.5f * MIN_DEPTH ? 1.f : Zu);
  const float Xa = Xp * a, Ya = Yp * a;
  const float r0 = t0 - (fx * Xa + cx);
  const float r1 = t1 - (fy * Ya + cy);
  const bool vis = Zu > MIN_DEPTH;
  const float w0 = vis ? 0.001f * wt0 : 0.f;
  const float w1 = vis ? 0.001f * wt1 : 0.f;
  // Jj of the two channels
  const float aZ = a * Zu;
  const float J0[6] = {fx * a * hc, 0.f, -fx * Xa * a * hc,
                       -fx * Xa * Ya, fx * (aZ + Xa * Xa), -fx * Ya};
  const float J1[6] = {0.f, fy * a * hc, -fy * Ya * a * hc,
                       -fy * (aZ + Ya * Ya), fy * Xa * Ya, fy * Xa};
  const float z0 = fx * a * (G[18] - Xa * G[20]);
  const float z1 = fy * a * (G[19] - Ya * G[20]);
  int k = 0;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const float a0 = w0 * J0[d], a1 = w1 * J1[d];
#pragma unroll
    for (int c = d; c < 6; ++c, ++k)
      acc[k] = fmaf(a1, J1[c], fmaf(a0, J0[c], acc[k]));
    acc[21 + d] = fmaf(a1, r1, fmaf(a0, r0, acc[21 + d]));
    if (PLANES) ej[d] = fmaf(a1, z1, a0 * z0);
  }
  if (PLANES) {
    // Ei = -Adj^T Ej
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ei[d] = -(G[d] * ej[0] + G[3 + d] * ej[1] + G[6 + d] * ej[2]);
      ei[3 + d] = -(G[9 + d] * ej[0] + G[12 + d] * ej[1] +
                    G[15 + d] * ej[2] + G[d] * ej[3] + G[3 + d] * ej[4] +
                    G[6 + d] * ej[5]);
    }
    ck = fmaf(w1 * z1, z1, w0 * z0 * z0);
    wk = fmaf(w1 * r1, z1, w0 * r0 * z0);
  }
}

// LIN_PIX = 2: two neighbouring pixels a step with 8- and 16-byte loads
// and stores (HW even, 16-byte aligned bases); 1 otherwise
template <int LIN_PIX>
__global__ void __cluster_dims__(LIN_CLUSTER, 1, 1)
    __launch_bounds__(LIN_THREADS)
    dba_linearize_kernel(const __grid_constant__ LinParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float G[21];
  __shared__ float part[LIN_WARPS][NLIN];
  __shared__ float red[NLIN];
  __shared__ float T[36];  // Hjj Adj
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int64_t e = blockIdx.y;
  const int HW = p.H * p.W;
  const bool ok = p.valid[e] != 0;
  const int64_t i = ok ? p.ii[e] : 0, j = ok ? p.jj[e] : 0;
  if (tid == 0) {
    if (ok) {
      relative_pose(p.poses + 7 * i, p.poses + 7 * j, G);
    } else {
      for (int k = 0; k < 21; ++k) G[k] = 0.f;
    }
  }
  __syncthreads();
  const float fx = p.intr[0], fy = p.intr[1], cx = p.intr[2], cy = p.intr[3];
  const bool planes = p.Ei != nullptr;

  float acc[NLIN];
#pragma unroll
  for (int k = 0; k < NLIN; ++k) acc[k] = 0.f;
  const int steps = HW / LIN_PIX;
  const int chunk = (steps + LIN_CLUSTER - 1) / LIN_CLUSTER;
  const int end = min(steps, (rank + 1) * chunk);
  const float* disp = p.disps + i * HW;
  const float* tg = p.target + e * HW * 2;
  const float* wt = p.weight + e * HW * 2;
  for (int st = rank * chunk + tid; st < end; st += LIN_THREADS) {
    const int px = st * LIN_PIX;
    float ej[LIN_PIX][6], ei[LIN_PIX][6], ck[LIN_PIX], wk[LIN_PIX];
    if (ok) {
      float hc[LIN_PIX], tv[2 * LIN_PIX], wv[2 * LIN_PIX];
      if constexpr (LIN_PIX == 2) {
        const float2 h2 = __ldg(reinterpret_cast<const float2*>(disp + px));
        const float4 t4 = __ldg(reinterpret_cast<const float4*>(tg + 2 * px));
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wt + 2 * px));
        hc[0] = h2.x, hc[1] = h2.y;
        tv[0] = t4.x, tv[1] = t4.y, tv[2] = t4.z, tv[3] = t4.w;
        wv[0] = w4.x, wv[1] = w4.y, wv[2] = w4.z, wv[3] = w4.w;
      } else {
        hc[0] = __ldg(disp + px);
        tv[0] = __ldg(tg + 2 * px), tv[1] = __ldg(tg + 2 * px + 1);
        wv[0] = __ldg(wt + 2 * px), wv[1] = __ldg(wt + 2 * px + 1);
      }
#pragma unroll
      for (int x = 0; x < LIN_PIX; ++x) {
        if (planes)
          lin_pixel<true>(G, fx, fy, cx, cy, px + x, p.W, hc[x], tv[2 * x],
                          tv[2 * x + 1], wv[2 * x], wv[2 * x + 1], acc,
                          ej[x], ei[x], ck[x], wk[x]);
        else
          lin_pixel<false>(G, fx, fy, cx, cy, px + x, p.W, hc[x], tv[2 * x],
                           tv[2 * x + 1], wv[2 * x], wv[2 * x + 1], acc,
                           ej[x], ei[x], ck[x], wk[x]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < LIN_PIX; ++x) {
#pragma unroll
        for (int d = 0; d < 6; ++d) ej[x][d] = ei[x][d] = 0.f;
        ck[x] = wk[x] = 0.f;
      }
    }
    if (planes) {
      const int64_t o = e * HW + px;
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        float* pi = p.Ei + (e * 6 + d) * HW + px;
        float* pj = p.Ej + (e * 6 + d) * HW + px;
        if constexpr (LIN_PIX == 2) {
          *reinterpret_cast<float2*>(pi) = make_float2(ei[0][d], ei[1][d]);
          *reinterpret_cast<float2*>(pj) = make_float2(ej[0][d], ej[1][d]);
        } else {
          *pi = ei[0][d];
          *pj = ej[0][d];
        }
      }
      if constexpr (LIN_PIX == 2) {
        *reinterpret_cast<float2*>(p.Ck + o) = make_float2(ck[0], ck[1]);
        *reinterpret_cast<float2*>(p.wk + o) = make_float2(wk[0], wk[1]);
      } else {
        p.Ck[o] = ck[0];
        p.wk[o] = wk[0];
      }
    }
  }

  // the block's sums: a butterfly within each warp, then the warps in order
#pragma unroll
  for (int k = 0; k < NLIN; ++k) {
    float v = acc[k];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
    acc[k] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NLIN; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (tid < NLIN) {
    float s = part[0][tid];
#pragma unroll
    for (int w = 1; w < LIN_WARPS; ++w) s += part[w][tid];
    red[tid] = s;
  }
  // the cluster's sums, in rank order, by its first block
  cluster.sync();
  if (rank == 0) {
    if (tid < NLIN) {
      float s = red[tid];
      for (int r = 1; r < LIN_CLUSTER; ++r) s += cluster.map_shared_rank(red, r)[tid];
      part[0][tid] = s;  // Hjj's upper triangle, then vj
    }
    __syncthreads();
    const float* hv = part[0];
    // T = Hjj Adj
    if (tid < 36) {
      const int r = tid / 6, c = tid % 6;
      float s = 0.f;
      for (int l = 0; l < 6; ++l)
        s = fmaf(hv[r <= l ? tri6(r, l) : tri6(l, r)], adj_at(G, l, c), s);
      T[tid] = s;
    }
    __syncthreads();
    // Hblk = [[Adj^T T, -T^T], [-T, Hjj]], symmetric; vblk = [-Adj^T vj; vj]
    for (int x = tid; x < 144; x += LIN_THREADS) {
      const int d = x / 12, c = x % 12;
      float v;
      if (d < 6 && c < 6) {
        const int lo = min(d, c), hi = max(d, c);
        v = 0.f;
        for (int k = 0; k < 6; ++k) v = fmaf(adj_at(G, k, lo), T[k * 6 + hi], v);
      } else if (d < 6) {
        v = -T[(c - 6) * 6 + d];
      } else if (c < 6) {
        v = -T[(d - 6) * 6 + c];
      } else {
        const int lo = min(d, c) - 6, hi = max(d, c) - 6;
        v = hv[tri6(lo, hi)];
      }
      p.Hblk[e * 144 + x] = v;
    }
    if (tid < 12) {
      float v;
      if (tid < 6) {
        v = 0.f;
        for (int k = 0; k < 6; ++k) v = fmaf(adj_at(G, k, tid), hv[21 + k], v);
        v = -v;
      } else {
        v = hv[21 + tid - 6];
      }
      p.vblk[e * 12 + tid] = v;
    }
  }
  cluster.sync();  // the other blocks' shared memory stays until read
}

struct SchurParams {
  const float *Ei_m, *Ej, *C, *eta, *w;
  const int64_t *m, *pa, *pb;
  const uint8_t* pv;
  float *S, *rc;
  int K, E, NP, HW;
  int sb;  // the stages' floats
};

// the dynamic shared memory of dba_schur_kernel at E edges and K frames
// after its stages: the block's share of the sums (the slot marks before
// the tiles), the group's edges (uint16), their paired bits, the jobs in
// order and each frame's count of jobs
__host__ __device__ constexpr size_t schur_fin_bytes(int E) {
  return (size_t)4 * ((E + 31) / 32) > (size_t)SC_FIN * 4
             ? ((size_t)4 * ((E + 31) / 32) + 15) & ~(size_t)15
             : (size_t)SC_FIN * 4;
}
__host__ __device__ constexpr size_t schur_jobs_at(int E) {
  return schur_fin_bytes(E) + (((size_t)2 * E + 7) & ~(size_t)7) +
         (size_t)4 * ((E + 31) / 32);
}
__host__ __device__ constexpr size_t schur_rest_bytes(int E, int K) {
  return schur_jobs_at(E) + (size_t)4 * K * (SC_SPLIT + 1);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// the index of edge e in the sorted group g[0:n] (e is there)
__device__ __forceinline__ int group_rank(const uint16_t* g, int n, int e) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int)g[mid] < e) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ bool bit(const uint32_t* bits, int r) {
  return (bits[r >> 5] >> (r & 31)) & 1u;
}

// `in` threads' ranks among the block's in thread order, and their count
// (every thread calls it; wsum holds SC_WARPS ints)
__device__ __forceinline__ int block_compact(bool in, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(FULL, in);
  if (lane == 0) wsum[warp] = __popc(bal);
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < SC_WARPS; ++w) {
    if (w < warp) before += wsum[w];
    total += wsum[w];
  }
  __syncthreads();
  return before + __popc(bal & ((1u << lane) - 1u));
}

__device__ __forceinline__ void store36(float* dst, const float* v) {
#pragma unroll
  for (int k = 0; k < 36; k += 4)
    *reinterpret_cast<float4*>(dst + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

__device__ __forceinline__ void zero36(float* dst) {
#pragma unroll
  for (int k = 0; k < 36; k += 4)
    *reinterpret_cast<float4*>(dst + k) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// pair slot s of frame q's cluster: its blocks A << 16 | B (A, B = 1 +
// the edges' places in the group g[0:n]), or 0 when it is not valid, not
// of frame q, or its edges' frames differ; with `zero`, the rows of the
// last two that this cluster owns are zeroed
__device__ __forceinline__ uint32_t slot_blocks(const SchurParams& p, int64_t s,
                                           int q, const uint16_t* g, int n,
                                           bool zero) {
  const bool ok = p.pv[s] != 0;
  const int64_t a = p.pa[s], b = p.pb[s];
  float* dst = p.S + ((int64_t)p.K + 2 * (int64_t)p.E + s) * 36;
  if (!ok) {
    if (zero && s % p.K == q) zero36(dst);
    return 0u;
  }
  const int64_t ma = p.m[a], mb = p.m[b];
  if (ma != q) return 0u;
  if (mb != q) {
    if (zero) zero36(dst);
    return 0u;
  }
  return (uint32_t)(group_rank(g, n, (int)a) + 1) << 16 |
         (uint32_t)(group_rank(g, n, (int)b) + 1);
}

// cluster blockIdx.y takes its jobs in turn, its block `rank` the pixels
// [h0, h1) of each; see the note at the top
__global__ void __cluster_dims__(SC_CLUSTER, 1, 1)
    __launch_bounds__(SC_THREADS)
    dba_schur_kernel(const __grid_constant__ SchurParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* part = stage;  // SC_THREADS x SC_NU, after the pixels
  float* fin = stage + p.sb;  // 36 a block of this rank's share
  uint32_t* mine = reinterpret_cast<uint32_t*>(fin);  // before the tiles
  uint16_t* grp = reinterpret_cast<uint16_t*>(
      reinterpret_cast<char*>(fin) + schur_fin_bytes(p.E));
  uint32_t* paired = reinterpret_cast<uint32_t*>(
      reinterpret_cast<char*>(grp) + ((2 * (size_t)p.E + 7) & ~(size_t)7));
  int* order = reinterpret_cast<int*>(reinterpret_cast<char*>(fin) +
                                      schur_jobs_at(p.E));  // the jobs by size
  int* split = order + p.K * SC_SPLIT;                      // a frame's jobs
  __shared__ const float* rowptr[SC_ROWS];
  __shared__ uint16_t units[SC_UNITS];  // (A - a0) * SC_TB + (B - b0)
  __shared__ int16_t umap[SC_UNITS];    // its unit, or -1
  __shared__ int wsum[SC_WARPS];

  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int K = p.K, E = p.E, HW = p.HW;
  const int64_t NP = p.NP;

  // the jobs (q, js, S): frame q's blocks t with t % S == js. A frame of
  // c = (n + 1)(n + 2) / 2 blocks past the mean share of the SC_WAVE
  // clusters (and SC_JOB_MIN) is split in S jobs; the jobs go largest
  // first, job r (in that order) to cluster r % SC_WAVE on even passes
  // over the clusters and SC_WAVE - 1 - r % SC_WAVE on odd ones, so the
  // largest and smallest share a cluster
  const int y = blockIdx.y;
  int J = 0;
  {
    int* cnt = reinterpret_cast<int*>(stage);  // before the pixels
    float* cost = stage + K;
    for (int k = tid; k < K; k += SC_THREADS) cnt[k] = 0;
    __syncthreads();
    for (int e = tid; e < E; e += SC_THREADS) atomicAdd(cnt + p.m[e], 1);
    __syncthreads();
    float total = 0.f;
    for (int k = 0; k < K; ++k)
      total += 0.5f * (float)(cnt[k] + 1) * (float)(cnt[k] + 2);
    const float target = fmaxf(SC_JOB_MIN, ceilf(total / (float)SC_WAVE));
    for (int k = tid; k < K; k += SC_THREADS) {
      const float c = 0.5f * (float)(cnt[k] + 1) * (float)(cnt[k] + 2);
      const int S = min(SC_SPLIT, max(1, (int)ceilf(c / target)));
      split[k] = S;
      for (int js = 0; js < SC_SPLIT; ++js)
        cost[k * SC_SPLIT + js] = js < S ? c / (float)S : -1.f;
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) J += split[k];
    for (int i = tid; i < K * SC_SPLIT; i += SC_THREADS) {
      const float ci = cost[i];
      if (ci < 0.f) continue;
      int before = 0;
      for (int j = 0; j < K * SC_SPLIT; ++j) {
        const float cj = cost[j];
        before += cj > ci || (cj == ci && j < i);
      }
      order[before] = i;
    }
    __syncthreads();
  }

  for (int pass = 0; pass * SC_WAVE < J; ++pass) {
    const int r = pass * SC_WAVE + (pass & 1 ? SC_WAVE - 1 - y : y);
    if (r >= J) continue;  // the same in the whole cluster
    const int q = order[r] / SC_SPLIT, js = order[r] % SC_SPLIT, S = split[q];

    // the group: the edges of frame q in edge order
    int n = 0;
    for (int base = 0; base < E; base += SC_THREADS) {
      const int e = base + tid;
      const bool in = e < E && p.m[e] == q;
      int total;
      const int at = block_compact(in, wsum, total);
      if (in) grp[n + at] = (uint16_t)e;
      n += total;
    }
    const int nwords = (n + 31) / 32;
    for (int k = tid; k < nwords; k += SC_THREADS) mine[k] = 0u;
    __syncthreads();

    const int hch = (((HW + SC_CLUSTER - 1) / SC_CLUSTER) + 1) & ~1;
    const int h0 = min(HW, rank * hch), h1 = min(HW, h0 + hch);
    const int nb = n + 1;  // six-row blocks: self, then the group
    const int nt = (nb + SC_TB - 1) / SC_TB;

    // a tile pair's staged rows (tile ta's, tile tb's unless the same, C,
    // eta, w) and its stages: the pixels a stage, a multiple of 32, the
    // whole slice in one stage where it fits, else as wide as two stages
    // fit. A row's stride RS is 1 mod 32, so the rows of a pixel fall in
    // distinct banks; the copies are 4-byte (a plane's stride at 30x101,
    // 12120 bytes, is not 16-byte aligned, and RS is odd)
    int rB = 0, rQ = 0, nrows = 0, PXW = 0, RS = 1, nst = 0;
    auto rows = [&](int ta, int tb) {
      const int a0 = ta * SC_TB, b0 = tb * SC_TB;
      const int na = min(SC_TB, nb - a0), nbb = min(SC_TB, nb - b0);
      rB = ta == tb ? 0 : 6 * na;
      rQ = rB + 6 * nbb;
      nrows = rQ + 3;
      if (tid < nrows) {
        const float* ptr;
        if (tid < rQ) {
          const int blk = tid < rB ? a0 + tid / 6 : b0 + (tid - rB) / 6;
          const int d = (tid < rB ? tid : tid - rB) % 6;
          ptr = blk == 0 ? p.Ei_m + ((int64_t)q * 6 + d) * HW
                         : p.Ej + ((int64_t)grp[blk - 1] * 6 + d) * HW;
        } else {
          const float* base = tid == rQ ? p.C : tid == rQ + 1 ? p.eta : p.w;
          ptr = base + (int64_t)q * HW;
        }
        rowptr[tid] = ptr;
      }
      const int wide = (h1 - h0 + 31) & ~31;
      PXW = nrows * (wide + 1) <= p.sb ? wide
                                       : ((p.sb / (2 * nrows) - 1) & ~31);
      RS = PXW + 1;
      nst = (h1 - h0 + PXW - 1) / max(PXW, 1);
      __syncthreads();
    };
    auto issue = [&](int k) {
      const int px = h0 + k * PXW, cnt = min(PXW, h1 - px);
      float* buf = stage + (k & 1) * nrows * RS;
      for (int r = tid >> 5; r < nrows; r += SC_WARPS) {
        const float* src = rowptr[r] + px;
        float* dst = buf + r * RS;
        for (int c = tid & 31; c < cnt; c += 32) cp_async(dst + c, src + c);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // the first tile pair's first stage is in flight during the marks
    rows(0, 0);
    if (nst > 0) issue(0);

    // this block's share of the pair slots: mark the edges they pair and
    // keep the first SC_SLOTS slots' blocks (A << 16 | B, or 0) of each
    // thread; zero an invalid slot (by the cluster of frame s % K) and one
    // whose edges' frames differ (by the frame of its first edge)
    const int64_t sch = (NP + SC_CLUSTER - 1) / SC_CLUSTER;
    const int64_t s0 = rank * sch < NP ? rank * sch : NP;
    const int64_t s1 = s0 + sch < NP ? s0 + sch : NP;
    uint32_t kept[SC_SLOTS];
#pragma unroll
    for (int k = 0; k < SC_SLOTS; ++k) kept[k] = 0u;
    for (int64_t s = s0 + tid, k = 0; s < s1; s += SC_THREADS, ++k) {
      const uint32_t ab = slot_blocks(p, s, q, grp, n, js == 0);
#pragma unroll
      for (int j = 0; j < SC_SLOTS; ++j)
        if (k == j) kept[j] = ab;
      if (ab) {
        const int ra = (int)(ab >> 16) - 1, rb = (int)(ab & 0xffff) - 1;
        atomicOr(mine + (ra >> 5), 1u << (ra & 31));
        atomicOr(mine + (rb >> 5), 1u << (rb & 31));
      }
    }
    cluster.sync();
    for (int k = tid; k < nwords; k += SC_THREADS) {
      uint32_t v = 0u;
      for (int r = 0; r < SC_CLUSTER; ++r) v |= cluster.map_shared_rank(mine, r)[k];
      paired[k] = v;
    }
    // the marks are read by the other blocks until the first tile's sync
    __syncthreads();

    for (int ta = 0; ta < nt; ++ta)
      for (int tb = ta; tb < nt; ++tb) {
        const int a0 = ta * SC_TB, b0 = tb * SC_TB;
        const int na = min(SC_TB, nb - a0), nbb = min(SC_TB, nb - b0);
        const bool first = ta == 0 && tb == 0;
        // the needed blocks (A, B), A <= B: self x anything, and the blocks
        // of two paired edges
        int U;
        {
          const int A = a0 + tid / SC_TB, B = b0 + tid % SC_TB;
          const bool need = tid / SC_TB < na && tid % SC_TB < nbb && A <= B &&
                            (A == 0 || (bit(paired, A - 1) && bit(paired, B - 1))) &&
                            tid % S == js;
          int total;
          const int at = block_compact(need, wsum, total);
          if (need) units[at] = (uint16_t)tid;
          umap[tid] = need ? (int16_t)at : (int16_t)-1;
          U = total;
        }
        __syncthreads();
        if (U == 0) {  // the same in every block of the cluster
          if (first) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          continue;
        }
        if (!first) {
          rows(ta, tb);
          if (nst > 0) issue(0);
        }
        // this thread's block and lane of pixels
        const int L = SC_THREADS / U;
        const int u = tid / L, l = tid % L;
        const bool active = u < U;
        int Ar = 0, Br = 0;
        bool self = false;
        if (active) {
          const int t = units[u];
          Ar = 6 * (t / SC_TB);
          Br = rB + 6 * (t % SC_TB);
          self = a0 + t / SC_TB == 0;
        }
        float acc[36], racc[6];
#pragma unroll
        for (int k = 0; k < 36; ++k) acc[k] = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) racc[k] = 0.f;

        for (int k = 0; k < nst; ++k) {
          if (k + 1 < nst) {
            issue(k + 1);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
          } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          }
          __syncthreads();
          float* buf = stage + (k & 1) * nrows * RS;
          const int cnt = min(PXW, h1 - (h0 + k * PXW));
          float* Qr = buf + rQ * RS;         // C, then Q
          float* QWr = buf + (rQ + 1) * RS;  // eta, then Q w
          for (int h = tid; h < cnt; h += SC_THREADS) {
            const float Q = 1.f / (Qr[h] + QWr[h]);
            Qr[h] = Q;
            QWr[h] = Q * buf[(rQ + 2) * RS + h];
          }
          __syncthreads();
          if (active) {
            const float* Ab = buf + Ar * RS;
            const float* Bb = buf + Br * RS;
            auto pixel = [&](int h) {
              const float Q = Qr[h];
              float av[6], bv[6];
#pragma unroll
              for (int d = 0; d < 6; ++d) {
                av[d] = Ab[d * RS + h] * Q;
                bv[d] = Bb[d * RS + h];
              }
#pragma unroll
              for (int d = 0; d < 6; ++d)
#pragma unroll
                for (int c = 0; c < 6; ++c) acc[d * 6 + c] = fmaf(av[d], bv[c], acc[d * 6 + c]);
              if (self) {
                const float qw = QWr[h];
#pragma unroll
                for (int c = 0; c < 6; ++c) racc[c] = fmaf(bv[c], qw, racc[c]);
              }
            };
            int h = l;
            for (; h + L < cnt; h += 2 * L) {
              pixel(h);
              pixel(h + L);
            }
            if (h < cnt) pixel(h);
          }
          __syncthreads();  // the buffer is refilled two stages on
        }

        // the lanes' sums, then each block's lanes in lane order
        if (active) {
#pragma unroll
          for (int k = 0; k < 36; ++k) part[tid * SC_NU + k] = acc[k];
#pragma unroll
          for (int k = 0; k < 6; ++k) part[tid * SC_NU + 36 + k] = racc[k];
        }
        __syncthreads();
        for (int x = tid; x < U * SC_NU; x += SC_THREADS) {
          const int uu = x / SC_NU, k = x % SC_NU;
          float v = part[uu * L * SC_NU + k];
          for (int ll = 1; ll < L; ++ll) v += part[(uu * L + ll) * SC_NU + k];
          part[uu * L * SC_NU + k] = v;
        }
        cluster.sync();
        // the cluster's sums in rank order, block uu by rank uu % SC_CLUSTER:
        // (a), (b) with its transpose, and rc written here
        const int mu = (U - rank + SC_CLUSTER - 1) / SC_CLUSTER;
        for (int x = tid; x < mu * SC_NU; x += SC_THREADS) {
          const int uu = rank + SC_CLUSTER * (x / SC_NU), k = x % SC_NU;
          float v = 0.f;
          for (int r = 0; r < SC_CLUSTER; ++r)
            v += cluster.map_shared_rank(part, r)[uu * L * SC_NU + k];
          const int t = units[uu];
          const int A = a0 + t / SC_TB, B = b0 + t % SC_TB;
          if (k < 36) fin[(uu / SC_CLUSTER) * 36 + k] = v;
          if (A != 0) continue;
          if (B == 0) {
            if (k < 36) p.S[(int64_t)q * 36 + k] = v;
            else p.rc[(int64_t)q * 6 + k - 36] = v;
          } else {
            const int64_t e = grp[B - 1];
            if (k < 36) {
              p.S[(K + e) * 36 + k] = v;
              p.S[(K + E + e) * 36 + (k % 6) * 6 + k / 6] = v;
            } else {
              p.rc[(K + e) * 6 + k - 36] = v;
            }
          }
        }
        cluster.sync();
        // (c): this block's share of the slots whose blocks are here
        for (int64_t s = s0 + tid, ks = 0; s < s1; s += SC_THREADS, ++ks) {
          uint32_t ab = 0u;
#pragma unroll
          for (int k = 0; k < SC_SLOTS; ++k)
            if (ks == k) ab = kept[k];
          if (ks >= SC_SLOTS) ab = slot_blocks(p, s, q, grp, n, false);
          if (!ab) continue;
          const int A = (int)(ab >> 16), B = (int)(ab & 0xffff);
          const int lo = min(A, B), hi = max(A, B);
          if (lo < a0 || lo >= a0 + na || hi < b0 || hi >= b0 + nbb) continue;
          const int uu = umap[(lo - a0) * SC_TB + hi - b0];
          if (uu < 0) continue;  // another job's block
          const float* src = cluster.map_shared_rank(fin, uu % SC_CLUSTER) +
                             (uu / SC_CLUSTER) * 36;
          float v[36];
#pragma unroll
          for (int k = 0; k < 36; ++k) v[k] = A <= B ? src[k] : src[(k % 6) * 6 + k / 6];
          store36(p.S + ((int64_t)K + 2 * (int64_t)E + s) * 36, v);
        }
        cluster.sync();  // the sums are read; the next tile may overwrite
      }
  }
}

struct BackParams {
  const float *planes, *dx;  // Ej (E,6,HW) or Ei_m (K,6,HW); dx (P,6)
  const int64_t* sel;        // (rows,) the row of dx, -1 for none
  // the depth pass: C, eta, w, t_edge (K,HW), disps (F,HW), frame_k (F,)
  const float *C, *eta, *w, *t_edge, *disps;
  const int64_t* frame_k;
  float* out;                // (E,HW) edge terms, or (F,HW) disparities
  int HW;
};

__device__ __forceinline__ float row_dot(const float* planes, int64_t row,
                                         int HW, int h, const float* dxr) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < 6; ++d) s = fmaf(__ldg(planes + (row * 6 + d) * HW + h), dxr[d], s);
  return s;
}

template <bool EDGES>
__global__ void __launch_bounds__(BACK_THREADS)
    dba_backsub_kernel(const __grid_constant__ BackParams p) {
  const int HW = p.HW;
  const int h = blockIdx.x * BACK_THREADS + threadIdx.x;
  const int64_t row = blockIdx.y;
  if (h >= HW) return;
  if (EDGES) {
    const int64_t s = p.sel[row];
    float dxr[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) dxr[d] = s >= 0 ? __ldg(p.dx + s * 6 + d) : 0.f;
    p.out[row * HW + h] = row_dot(p.planes, row, HW, h, dxr);
    return;
  }
  // row is a frame of the video; k its depth frame, -1 outside the window
  const int64_t k = p.frame_k[row];
  float z = __ldg(p.disps + row * HW + h);
  if (k >= 0) {
    const int64_t s = p.sel[k];
    float dxr[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) dxr[d] = s >= 0 ? __ldg(p.dx + s * 6 + d) : 0.f;
    const int64_t o = k * HW + h;
    const float Q = 1.f / (__ldg(p.C + o) + __ldg(p.eta + o));
    const float t_self = row_dot(p.planes, k, HW, h, dxr);
    z += Q * (__ldg(p.w + o) - t_self - __ldg(p.t_edge + o));
  }
  // torch.clamp(min=0.001): NaN stays NaN
  p.out[row * HW + h] = z < 0.001f ? 0.001f : z;
}

}  // namespace

// pvo_tpu_torch/vo/net/cuda_dba.py holds each function's shapes. Each
// launches one kernel on `stream` and returns cudaGetLastError().

extern "C" int pvo_dba_linearize(const float* poses, const float* disps,
                                 const float* intr, const float* target,
                                 const float* weight, const int64_t* ii,
                                 const int64_t* jj, const uint8_t* valid,
                                 int E, int H, int W, float* Hblk,
                                 float* vblk, float* Ei, float* Ej, float* Ck,
                                 float* wk, void* stream) {
  if (E < 1 || E > 65535 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const LinParams p = {poses, disps, intr, target, weight, ii, jj, valid,
                       Hblk, vblk, Ei, Ej, Ck, wk, H, W};
  // two pixels a step where every plane and row starts 16-byte aligned
  uintptr_t bases = (uintptr_t)disps | (uintptr_t)target | (uintptr_t)weight;
  if (Ei) bases |= (uintptr_t)Ei | (uintptr_t)Ej | (uintptr_t)Ck | (uintptr_t)wk;
  const dim3 grid(LIN_CLUSTER, E);
  if ((H * W) % 2 == 0 && bases % 16 == 0)
    dba_linearize_kernel<2><<<grid, LIN_THREADS, 0, (cudaStream_t)stream>>>(p);
  else
    dba_linearize_kernel<1><<<grid, LIN_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int pvo_dba_schur(const float* Ei_m, const float* Ej,
                             const float* C, const float* eta, const float* w,
                             const int64_t* m, const int64_t* pa,
                             const int64_t* pb, const uint8_t* pv, int K,
                             int E, int NP, int HW, float* S, float* rc,
                             void* stream) {
  if (K < 1 || K > 65535 || E < 0 || E > 65535 || NP < 0 || HW < 1)
    return (int)cudaErrorInvalidValue;
  // the stages take what the rest leaves, up to SC_STAGE; the jobs' sizes
  // are ranked in them before the pixels
  const size_t rest = schur_rest_bytes(E, K);
  if (rest + (size_t)SC_STAGE_MIN * 4 > (size_t)SC_SMEM)
    return (int)cudaErrorInvalidValue;
  const int room = (int)(((size_t)SC_SMEM - rest) / 4) & ~3;
  const int sb = room < SC_STAGE ? room : SC_STAGE;
  if ((int64_t)K * (SC_SPLIT + 1) > sb) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)sb * 4 + rest;
  // the kernel's limit, set with every launch (as allowed in a capture)
  const cudaError_t err = cudaFuncSetAttribute(
      dba_schur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const SchurParams p = {Ei_m, Ej, C, eta, w, m, pa, pb, pv, S, rc,
                         K, E, NP, HW, sb};
  dba_schur_kernel<<<dim3(SC_CLUSTER, SC_WAVE), SC_THREADS, smem,
                     (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int pvo_dba_backsub_edges(const float* Ej, const float* dx,
                                     const int64_t* sel, int E, int HW,
                                     float* te, void* stream) {
  if (E < 1 || E > 65535 || HW < 1) return (int)cudaErrorInvalidValue;
  const BackParams p = {Ej, dx, sel, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, te, HW};
  dba_backsub_kernel<true><<<dim3((HW + BACK_THREADS - 1) / BACK_THREADS, E),
                             BACK_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int pvo_dba_backsub(const float* Ei_m, const float* dx,
                               const int64_t* sel, const float* C,
                               const float* eta, const float* w,
                               const float* t_edge, const float* disps,
                               const int64_t* frame_k, int F, int HW,
                               float* out, void* stream) {
  if (F < 1 || F > 65535 || HW < 1) return (int)cudaErrorInvalidValue;
  const BackParams p = {Ei_m, dx, sel, C, eta, w, t_edge, disps, frame_k,
                        out, HW};
  dba_backsub_kernel<false><<<dim3((HW + BACK_THREADS - 1) / BACK_THREADS, F),
                              BACK_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
