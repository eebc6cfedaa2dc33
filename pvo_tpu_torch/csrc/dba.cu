// The dense bundle adjustment's f32 work for Hopper (sm_90a): the
// linearization of each edge, the Schur terms with the rhs correction,
// the damped dense solve of the reduced camera system, and the
// iteration's update after the solve (the depth back-substitution and
// the pose retraction) (pvo_tpu_torch/vo/net/cuda_dba.py, called by
// vo/dba.py).
//
// No TPU kernel matches these: the JAX package leaves this work to XLA
// (pvo_tpu/geom/ba.py:59-93 _edge_blocks, pvo_tpu/vo/dba.py:117-277). They
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
// dba_backsub_kernel<PIX>: everything after the solve in one launch. The
//   first blocks retract the poses, a thread a frame: Exp(dx[row]) * g in
//   f32 with the plain version's closed forms and branches (lie/so3.exp,
//   left_jacobian, lie/se3.mul), a frame without a row copied (a zero
//   tangent retracts exactly). Then a block a (frame, slice of PIX x 256
//   pixels). A frame f of depth frame k = frame_k[f] >= 0 builds k's edge
//   list from m_k, BK_THREADS edges at a time (a stable compaction in
//   shared memory, the edges' dx rows staged beside it), and each thread
//   sums t_edge = the edges' Ej dx[pj] in ascending edge order from
//   +0.0f with __fadd_rn, each term the fmaf chain over d of the earlier
//   edge pass: the order and rounding of the segment sum's zero start, so
//   the disparities equal the earlier three launches' bit for bit. The
//   loads of AHEAD edges' planes are issued together, then added in
//   order. The loads that wait on nothing (frame_k, the first chunk of
//   m_k and pj_sel, dx staged in shared memory, the disparities) are
//   issued first, so the edges' planes are the second load a block
//   waits on. Then dz = Q (w - Ei_m dx[pm] - t_edge), Q = 1 / (C + eta),
//   and z + dz; every frame is clamped at 0.001 (NaN stays NaN). PIX = 4
//   (16-byte loads) where HW % 4 == 0 and the bases allow, 2 where HW is
//   even, else 1. Bound: the bytes of Ej, Ei_m, C, eta, w and the
//   disparities read once and the disparities written; nothing of E x HW
//   is written or read back any more. No atomics, no host read.
// dba_solve_kernel: the damped solve of the reduced camera system,
//   (H - S_sum) damped x = v - corr_v, in one block of 512 threads (it
//   replaces XLA's cholesky and triangular solves,
//   pvo_tpu/geom/chol.py:21-32, called at pvo_tpu/vo/dba.py:247; on the
//   card those were cuSOLVER's potrf and two trsv with some 26 small
//   kernels around them, about 1.2 ms of a replayed planner frame). The
//   system is 6P x 6P, padded to whole 32 x 32 tiles with the identity.
//   The DBA sums the blocks (p, q) and (q, p) apart, so Sd is not quite
//   symmetric; the JAX package's cholesky factors (Sd + Sd^T) / 2
//   (symmetrize_input), and so does this: each entry Sd[R][C] = H - S_sum
//   in f32, the diagonal damped as d + (ep + lm d) with the plain
//   version's roundings, then 0.5 (Sd[R][C] + Sd[C][R]) (sv_sym). Its
//   lower triangle's tiles (row stride 33), b and the pivots' reciprocal
//   square roots live in shared memory (192,384 bytes at P = SV_MAX_P =
//   48). The blocks on and below the diagonal of H and S_sum, each with
//   its mirror above, are staged by cp.async (double-buffered) and
//   scattered to the tiles. The factorization goes by 32-column panels,
//   right-looking: warp 0 factors the diagonal tile, a lane a row, b
//   riding along as an extra row (y = L^-1 b comes out of the same
//   sweep), each step's next pivot formed first so that the chain from
//   pivot to pivot is a shuffle, a reciprocal square root and two
//   roundings; a thread a row solves the panel below and takes its y out
//   of b; a warp a trailing tile updates it, 4 x 8 values a lane, warps
//   1-4 first the next diagonal tile, 8 rows each, which they hand to
//   warp 0 (a named barrier) to factor while the other warps update the
//   rest. The diagonal tile's L and the panel's rows are also kept
//   transposed, so those loops read four values a load. Then L^T x = y
//   by the same tiles from the last, with the same hand-off, and
//   solve_psd's mask: x = 0 where a pivot was <= 0 or not finite, or x
//   is not finite. Every operation is an explicitly rounded f32
//   intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn) in a fixed order, the
//   reciprocal square roots too (sv_rsqrt: a bit-level guess and three
//   Newton steps), no atomics: numpy repeats the order bit for bit
//   (scripts/dba_solve_emul.py), and two calls are bit-equal. Bound:
//   M^3/3 + 3 M^2 operations (M = 6P) against the f32 peak, and H and
//   S_sum read once (bytes bound it up to P = 78); but the factorization
//   is a chain of M dependent column steps on one SM, so against the
//   whole card's bound it reads about 0.2%.
// dba_solve_grid_kernel: the same solve above SV_MAX_P, whose system no
//   longer fits a block, at any P (the backend's P is its keyframes less
//   one, up to the buffer's). One cooperative launch of one block an SM
//   at most (a block a tile column, nb = M / 32 rounded up, up to the
//   card's SMs), on a workspace the wrapper allocates (sg_layout: the
//   padded lower triangle in 32 x 32 tiles, 0.94 MB at P = 99, 19.9 MB
//   at P = 511: both in the 50 MB L2, read through it with __ldcg).
//   The blocks assemble the tiles (the same sv_sym of the same values),
//   then factor right-looking by panels, block b owning the tile columns
//   J = b mod G: at step k each block takes panel k out of its columns,
//   a warp a tile (the panel's two tiles staged in shared memory), and
//   the owner of column k + 1 does that column first and then factors it
//   at once (its diagonal tile by warp 0 with sv_factor_tile, its panel
//   a thread a row, b riding along), so that one grid barrier a step (an
//   atomic count and generation, sg_grid_sync) orders everything. Block
//   0 then solves L^T x = y as dba_solve_kernel does, the tiles read
//   from L2, and applies the mask. Every entry takes the same rounded
//   operations in the same order as in dba_solve_kernel, so one
//   emulation covers both kernels and the card equals it bit for bit at
//   every P. Bound as dba_solve_kernel's; the chain is nb panel steps,
//   each a diagonal factorization, a panel solve on one SM and a grid
//   barrier.

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
constexpr int BK_THREADS = 256;  // dba_backsub's threads a block
constexpr int BK_DX_ROWS = 256;  // dx's rows staged in shared memory at most
constexpr int SV_THREADS = 512;    // dba_solve's threads, its one block
constexpr int SV_WARPS = SV_THREADS / 32;
constexpr int SV_STAGE4 = 2048;    // the assembly's stage, float4s of H (of S)
constexpr int SV_SMEM = 232448;    // a block's shared memory: dba_solve takes all
constexpr int SV_NB = 32;          // a tile's side, the panel width
constexpr int SV_LD = SV_NB + 1;   // a tile row's stride: odd, so a
                                   // column's 32 values lie in 32 banks
constexpr int SV_TILE = SV_NB * SV_LD;
constexpr int SV_MAX_P = 48;       // cuda_dba.SOLVE_MAX_P: the one block's
                                   // largest P, the grid kernel's above
constexpr float MIN_DEPTH = 0.2f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(SC_UNITS <= SC_THREADS, "a tile pair's blocks a thread each");
static_assert(BK_THREADS == SC_THREADS, "block_compact's warps");
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

// the retraction Exp(xi) * g of one pose, each operation rounded as the
// plain version's (lie/so3.exp, left_jacobian, lie/se3.mul): no
// contraction, IEEE division and square root, sinf/cosf
__device__ void retract(const float* g, const float* xi, float* o) {
  const float rho[3] = {xi[0], xi[1], xi[2]};
  const float phi[3] = {xi[3], xi[4], xi[5]};
  const float theta_sq = __fadd_rn(__fadd_rn(__fmul_rn(phi[0], phi[0]),
                                             __fmul_rn(phi[1], phi[1])),
                                   __fmul_rn(phi[2], phi[2]));
  const bool small = theta_sq < 1e-6f;
  const float th = __fsqrt_rn(small ? 1.f : theta_sq);
  const float half = __fmul_rn(0.5f, th);
  // so3.exp: q1 = [imag phi, real]
  const float imag = small ? __fsub_rn(0.5f, __fdiv_rn(theta_sq, 48.f))
                           : __fdiv_rn(sinf(half), th);
  const float real = small ? __fsub_rn(1.f, __fdiv_rn(theta_sq, 8.f))
                           : cosf(half);
  const float v1[3] = {__fmul_rn(imag, phi[0]), __fmul_rn(imag, phi[1]),
                       __fmul_rn(imag, phi[2])};
  const float w1 = real;
  // so3.left_jacobian: J = I + c1 Phi + c2 Phi Phi, t1 = J rho
  const float th2 = __fmul_rn(th, th);
  const float c1 = small ? __fsub_rn(0.5f, __fdiv_rn(theta_sq, 24.f))
                         : __fdiv_rn(__fsub_rn(1.f, cosf(th)), th2);
  const float c2 = small ? __fsub_rn(1.f / 6.f, __fdiv_rn(theta_sq, 120.f))
                         : __fdiv_rn(__fsub_rn(th, sinf(th)), __fmul_rn(th2, th));
  const float Phi[9] = {0.f, -phi[2], phi[1], phi[2], 0.f, -phi[0],
                        -phi[1], phi[0], 0.f};
  float t1[3];
  for (int i = 0; i < 3; ++i) {
    float s = 0.f;
    for (int j = 0; j < 3; ++j) {
      float pp = 0.f;
      for (int l = 0; l < 3; ++l)
        pp = __fadd_rn(pp, __fmul_rn(Phi[3 * i + l], Phi[3 * l + j]));
      const float J = __fadd_rn(__fadd_rn(i == j ? 1.f : 0.f,
                                          __fmul_rn(c1, Phi[3 * i + j])),
                                __fmul_rn(c2, pp));
      s = __fadd_rn(s, __fmul_rn(J, rho[j]));
    }
    t1[i] = s;
  }
  // se3.mul(exp, g): q = q1 q2, t = t1 + q1 t2
  const float t2[3] = {g[0], g[1], g[2]};
  const float v2[3] = {g[3], g[4], g[5]};
  const float w2 = g[6];
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(v1[0], v2[0]),
                                        __fmul_rn(v1[1], v2[1])),
                              __fmul_rn(v1[2], v2[2]));
  o[6] = __fsub_rn(__fmul_rn(w1, w2), dot);
  for (int i = 0; i < 3; ++i) {
    const int a = (i + 1) % 3, b = (i + 2) % 3;
    const float cr = __fsub_rn(__fmul_rn(v1[a], v2[b]), __fmul_rn(v1[b], v2[a]));
    o[3 + i] = __fadd_rn(__fadd_rn(__fmul_rn(w1, v2[i]), __fmul_rn(w2, v1[i])), cr);
  }
  float uv[3], uuv[3];
  for (int i = 0; i < 3; ++i) {
    const int a = (i + 1) % 3, b = (i + 2) % 3;
    uv[i] = __fsub_rn(__fmul_rn(v1[a], t2[b]), __fmul_rn(v1[b], t2[a]));
  }
  for (int i = 0; i < 3; ++i) {
    const int a = (i + 1) % 3, b = (i + 2) % 3;
    uuv[i] = __fsub_rn(__fmul_rn(v1[a], uv[b]), __fmul_rn(v1[b], uv[a]));
  }
  for (int i = 0; i < 3; ++i) {
    const float rot = __fadd_rn(t2[i], __fmul_rn(2.f, __fadd_rn(__fmul_rn(w1, uv[i]), uuv[i])));
    o[i] = __fadd_rn(t1[i], rot);
  }
}

struct BackParams {
  const float *poses, *dx;     // (F,7), (P,6)
  const int64_t* frame_row;    // (F,) the row of dx, -1 for none
  float* poses_out;            // (F,7)
  // the depth update (null for a motion-only call): Ej (E,6,HW), Ei_m
  // (K,6,HW), C, eta, w (K,HW), disps (F,HW); pj_sel (E,), m_k (E,; K
  // where masked), pm_sel (K,), frame_k (F,)
  const float *Ej, *Ei_m, *C, *eta, *w, *disps;
  const int64_t *pj_sel, *m_k, *pm_sel, *frame_k;
  float* out;                  // (F,HW)
  int F, E, HW, P, slices, rblocks;
};

// PIX neighbouring f32 values at src (PIX * 4 bytes aligned)
template <int PIX>
__device__ __forceinline__ void load_pix(const float* src, float* v) {
  if constexpr (PIX == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (PIX == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(src);
  }
}

// a row of six planes against dx's row, as the plain version's einsum
// term: s = 0, then s = fmaf(plane[d], dx[d], s) for d = 0..5
__device__ __forceinline__ float row_dot(float (*v)[4], int x,
                                         const float* dxr) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < 6; ++d) s = fmaf(v[d][x], dxr[d], s);
  return s;
}

// see the note at the top: blocks [0, rblocks) retract the poses, a
// thread a frame; the others take (frame, pixel slice), PIX pixels a
// thread
template <int PIX>
__global__ void __launch_bounds__(BK_THREADS)
    dba_backsub_kernel(const __grid_constant__ BackParams p) {
  // edges whose loads are in flight at once (at one pixel a thread, 8
  // edges' 48 loads were slower than 4's at 47x155 and at the backend's
  // call: fewer blocks fit an SM)
  constexpr int AHEAD = PIX == 1 ? 4 : 8 / PIX;
  __shared__ int grp[BK_THREADS];
  __shared__ float gdx[BK_THREADS][6];
  __shared__ float sdx[BK_DX_ROWS * 6];
  __shared__ int wsum[SC_WARPS];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < p.rblocks) {
    const int f = blockIdx.x * BK_THREADS + tid;
    if (f < p.F) {
      const int64_t r = p.frame_row[f];
      const float* g = p.poses + (int64_t)f * 7;
      float* o = p.poses_out + (int64_t)f * 7;
      if (r >= 0) {
        float xi[6], res[7];
        for (int d = 0; d < 6; ++d) xi[d] = __ldg(p.dx + r * 6 + d);
        retract(g, xi, res);
        for (int d = 0; d < 7; ++d) o[d] = res[d];
      } else {
        // a zero tangent retracts exactly to g
        for (int d = 0; d < 7; ++d) o[d] = g[d];
      }
    }
    return;
  }
  const int HW = p.HW;
  const int64_t blk = blockIdx.x - p.rblocks;
  const int64_t f = blk / p.slices;
  const int h = ((int)(blk % p.slices) * BK_THREADS + tid) * PIX;
  const bool px = h < HW;  // HW % PIX == 0: all PIX pixels or none
  // the loads that wait on nothing, issued together: the frame's depth
  // frame, the first chunk's edges, dx into shared memory (published by
  // the compaction's barriers), the disparities
  const int64_t k = p.frame_k[f];
  int64_t mk = -1, sj = -1;
  if (tid < p.E) mk = p.m_k[tid], sj = p.pj_sel[tid];
  const bool staged = p.P <= BK_DX_ROWS;
  if (staged)
    for (int i = tid; i < p.P * 6; i += BK_THREADS) sdx[i] = __ldg(p.dx + i);
  float z[PIX];
  if (px) load_pix<PIX>(p.disps + f * HW + h, z);
  if (k >= 0) {  // the same in the whole block
    // the self term's operands, loaded before the edges' walk
    float self[6][4], Cv[PIX], Ev[PIX], Wv[PIX], dxs[6];
    const int64_t o = k * HW + h;
    if (px) {
#pragma unroll
      for (int d = 0; d < 6; ++d)
        load_pix<PIX>(p.Ei_m + (k * 6 + d) * HW + h, self[d]);
      load_pix<PIX>(p.C + o, Cv);
      load_pix<PIX>(p.eta + o, Ev);
      load_pix<PIX>(p.w + o, Wv);
    }
    const int64_t sm = p.pm_sel[k];
#pragma unroll
    for (int d = 0; d < 6; ++d) dxs[d] = sm >= 0 ? __ldg(p.dx + sm * 6 + d) : 0.f;

    // t_edge: the edges of depth frame k in ascending e, from +0.0f, a
    // chunk of BK_THREADS edges at a time (a stable compaction of m_k)
    float te[PIX];
#pragma unroll
    for (int x = 0; x < PIX; ++x) te[x] = 0.f;
    for (int base = 0; base < p.E; base += BK_THREADS) {
      const int e = base + tid;
      if (base > 0) {
        mk = sj = -1;
        if (e < p.E) mk = p.m_k[e], sj = p.pj_sel[e];
      }
      const bool in = mk == k;
      int n;
      const int at = block_compact(in, wsum, n);
      if (in) {
        grp[at] = e;
#pragma unroll
        for (int d = 0; d < 6; ++d)
          gdx[at][d] = sj < 0 ? 0.f : staged ? sdx[sj * 6 + d] : __ldg(p.dx + sj * 6 + d);
      }
      __syncthreads();
      if (px) {
        // AHEAD edges' planes loaded together, then added in edge order
        for (int g0 = 0; g0 < n; g0 += AHEAD) {
          float v[AHEAD][6][4];
#pragma unroll
          for (int a = 0; a < AHEAD; ++a)
            if (g0 + a < n) {
              const float* pl = p.Ej + (int64_t)grp[g0 + a] * 6 * HW + h;
#pragma unroll
              for (int d = 0; d < 6; ++d) load_pix<PIX>(pl + (int64_t)d * HW, v[a][d]);
            }
#pragma unroll
          for (int a = 0; a < AHEAD; ++a)
            if (g0 + a < n) {
#pragma unroll
              for (int x = 0; x < PIX; ++x)
                te[x] = __fadd_rn(te[x], row_dot(v[a], x, gdx[g0 + a]));
            }
        }
      }
      __syncthreads();  // the lists are rewritten by the next chunk
    }
    if (px) {
#pragma unroll
      for (int x = 0; x < PIX; ++x) {
        const float Q = 1.f / (Cv[x] + Ev[x]);
        const float t_self = row_dot(self, x, dxs);
        z[x] += Q * (Wv[x] - t_self - te[x]);
      }
    }
  }
  if (px) {
    float* dst = p.out + f * HW + h;
    // torch.clamp(min=0.001): NaN stays NaN
#pragma unroll
    for (int x = 0; x < PIX; ++x) z[x] = z[x] < 0.001f ? 0.001f : z[x];
    if constexpr (PIX == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(z[0], z[1], z[2], z[3]);
    } else if constexpr (PIX == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(z[0], z[1]);
    } else {
      dst[0] = z[0];
    }
  }
}

// ---- dba_solve ----

__host__ __device__ constexpr int sv_tiles(int nb) { return nb * (nb + 1) / 2; }

// the shared memory of the system at P poses: the lower triangle of the
// padded system in nb (nb + 1) / 2 tiles, b and the pivots' reciprocal
// square roots
__host__ __device__ constexpr size_t sv_smem_bytes(int P) {
  return ((size_t)sv_tiles((6 * P + SV_NB - 1) / SV_NB) * SV_TILE +
          2 * (size_t)((6 * P + SV_NB - 1) / SV_NB * SV_NB)) * sizeof(float);
}
static_assert(sv_smem_bytes(SV_MAX_P) <= SV_SMEM &&
                  sv_smem_bytes(SV_MAX_P + 1) > SV_SMEM,
              "SV_MAX_P: the most poses whose system fits a block");
// beside it: the column broadcast, the diagonal tile transposed, and the
// panel transposed (its nb - 1 tiles at most), whose room also holds the
// assembly's stages
static_assert(sv_smem_bytes(SV_MAX_P) +
                      (2 * SV_NB + SV_NB * SV_NB) * 4 +
                      ((6 * SV_MAX_P + SV_NB - 1) / SV_NB - 1) * SV_NB *
                          SV_NB * 4 <= SV_SMEM,
              "the transposed panel fits beside SV_MAX_P's system");
static_assert(SV_NB == 32 && SV_WARPS >= 6, "a lane a row; warps 0, 1-4, rest");

struct SolveParams {
  const float *H, *S, *v, *cv;  // S, cv null: a motion-only iteration
  float* dx;
  float* ws;  // dba_solve_grid_kernel's workspace (sg_layout), else null
  float ep, lm;
  int P;
};

__device__ __forceinline__ float* sv_tile(float* A, int I, int J) {
  return A + (I * (I + 1) / 2 + J) * SV_TILE;
}

// the hand-off of a finished tile from ``warps`` warps to warp 0
// (barrier 1), ordered for shared memory as bar.sync orders it
__device__ __forceinline__ void sv_handoff_wait(int warps) {
  asm volatile("bar.sync 1, %0;" ::"r"(32 * (warps + 1)) : "memory");
}
__device__ __forceinline__ void sv_handoff_arrive(int warps) {
  asm volatile("bar.arrive 1, %0;" ::"r"(32 * (warps + 1)) : "memory");
}

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// the row p of the triangle's entry f: p (p + 1) / 2 <= f < (p + 1) (p + 2) / 2
__device__ __forceinline__ int sv_tri_row(int f) {
  int pp = (int)((sqrtf(fmaf(8.f, (float)f, 1.f)) - 1.f) * 0.5f);
  if ((pp + 1) * (pp + 2) / 2 <= f) ++pp;
  if (pp * (pp + 1) / 2 > f) --pp;
  return pp;
}

// Sd[R][C] of the damped system from the blocks' values h, s there:
// h - s (h on a motion-only iteration), the diagonal damped as
// d + (ep + lm d)
__device__ __forceinline__ float sv_damped(const SolveParams& p, int R,
                                           int C, float h, float s) {
  float x = p.S ? __fsub_rn(h, s) : h;
  if (R == C) x = __fadd_rn(x, __fadd_rn(p.ep, __fmul_rn(p.lm, x)));
  return x;
}

// an entry of (Sd + Sd^T) / 2, lo = Sd[R][C], up = Sd[C][R]: what the
// JAX package's cholesky factors (symmetrize_input), rounded as it
// rounds it (the sum, then the exact halving)
__device__ __forceinline__ float sv_sym(float lo, float up) {
  return __fmul_rn(0.5f, __fadd_rn(lo, up));
}

// 1 / sqrt(d) in f32 operations alone, so that numpy repeats it bit for
// bit: the exponent-halving first guess, then three Newton steps
// r (1.5 - (d / 2) r^2) (the guess is within 3.5%, the steps square the
// error: about 2e-3, 5e-6, then the last step's roundings)
__device__ __forceinline__ float sv_rsqrt(float d) {
  const float h = __fmul_rn(0.5f, d);
  float r = __uint_as_float(0x5f3759dfu - (__float_as_uint(d) >> 1));
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r = __fmul_rn(r, __fmaf_rn(-h, __fmul_rn(r, r), 1.5f));
  return r;
}

// warp 0: factor the diagonal tile Dk = L L^T in place, lane i holding row
// i in registers, and y = L^-1 y with it (y: 32 values of b); rdk takes
// the pivots' reciprocal square roots (the back-solve and the panel scale
// by them; the tile's diagonal is not read again). The chain from pivot
// to pivot is a shuffle, sv_rsqrt, a product and a fused multiply-add:
// each step forms the next pivot from lane j + 1's own row first and
// starts its reciprocal square root before the step's other updates,
// which are issued under that latency. Above the diagonal a lane's
// registers take the same updates unread, so no update is predicated but
// y's; column j reaches the lanes through ``col`` (64 floats, 16-byte
// aligned), four values a load. The tile's L also goes to DkT transposed
// (DkT[j][i] = L[i][j], i > j), for the panel's rows to read four values
// a load. One copy (noinline), so the code is fetched once. Returns whether
// a pivot was <= 0 or not finite.
__device__ __noinline__ bool sv_factor_tile(float* Dk, float* y_s, float* rdk,
                                            float* col, float* DkT, int lane) {
  float a[SV_NB];
#pragma unroll
  for (int c = 0; c < SV_NB; ++c) a[c] = Dk[lane * SV_LD + c];
  float y = y_s[lane], rj = 0.f;
  float d = __shfl_sync(FULL, a[0], 0);
  bool bad = !(d > 0.f) || !isfinite(d);
  float r = sv_rsqrt(d);
#pragma unroll
  for (int j = 0; j < SV_NB; ++j) {
    const float Lj = __fmul_rn(a[j], r);  // L[lane][j] on the lanes > j
    float rn = 0.f;
    if (j + 1 < SV_NB) {
      d = __shfl_sync(FULL, __fmaf_rn(-Lj, Lj, a[j + 1]), j + 1);
      bad |= !(d > 0.f) || !isfinite(d);
      rn = sv_rsqrt(d);
    }
    rj = lane == j ? r : rj;
    const float yj = __fmul_rn(__shfl_sync(FULL, y, j), r);
    y = lane > j ? __fmaf_rn(-Lj, yj, y) : lane == j ? yj : y;
    a[j] = Lj;
    // column j to every lane through shared memory (two buffers by step:
    // one __syncwarp a step keeps a write off the other buffer's reads),
    // four values a load
    float* cb = col + (j & 1) * SV_NB;
    cb[lane] = Lj;
    __syncwarp();
#pragma unroll
    for (int g = (j + 1) / 4; g < SV_NB / 4; ++g) {
      const float4 v = reinterpret_cast<const float4*>(cb)[g];
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (4 * g + m > j) a[4 * g + m] = __fmaf_rn(-Lj, vv[m], a[4 * g + m]);
    }
    r = rn;
  }
#pragma unroll
  for (int c = 0; c < SV_NB; ++c) {
    if (c <= lane) Dk[lane * SV_LD + c] = a[c];
    if (c < lane) DkT[c * SV_NB + lane] = a[c];
  }
  y_s[lane] = y;
  rdk[lane] = rj;
  return bad;
}

// warp 0: L_II^T x = z for the diagonal tile DI, z (32 values of b) in
// place, from the last row
__device__ __forceinline__ void sv_back_tile(const float* DI, float* z_s,
                                             const float* rdI, int lane) {
  float z = z_s[lane];
  const float r = rdI[lane];
#pragma unroll
  for (int j = SV_NB - 1; j >= 0; --j) {
    const float xj = __shfl_sync(FULL, __fmul_rn(z, r), j);
    z = lane == j ? xj
        : lane < j ? __fmaf_rn(-DI[j * SV_LD + lane], xj, z) : z;
  }
  z_s[lane] = z;
}

// one warp: the trailing tile (I, J) less L_Ik L_Jk^T, 4 x 8 values a
// lane, each summed over the panel's 32 columns in order; the panel's
// rows are read transposed (PI, PJ: 32 x 32, column j of L_Ik a row),
// four values a load
__device__ __forceinline__ void sv_update_tile(float* A, const float* PI,
                                               const float* PJ, int I, int J,
                                               int lane) {
  const int r0 = (lane % 8) * 4, c0 = (lane / 8) * 8;
  if (I == J && c0 > r0 + 3) return;  // above the diagonal
  float* T = sv_tile(A, I, J) + r0 * SV_LD + c0;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = T[i * SV_LD + c];
#pragma unroll 4
  for (int kk = 0; kk < SV_NB; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(PI + kk * SV_NB + r0);
    const float4 b4 = *reinterpret_cast<const float4*>(PJ + kk * SV_NB + c0);
    const float4 c4 =
        *reinterpret_cast<const float4*>(PJ + kk * SV_NB + c0 + 4);
    const float li[4] = {a4.x, a4.y, a4.z, a4.w};
    const float lj[8] = {b4.x, b4.y, b4.z, b4.w, c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[i][c] = __fmaf_rn(-li[i], lj[c], acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) T[i * SV_LD + c] = acc[i][c];
}

// one warp: rows [rb, rb + 8) of the diagonal tile (I, I) less L_Ik L_Ik^T,
// a lane a row and 8 columns, each summed over the panel's columns in
// order (the same sums as sv_update_tile's)
__device__ __forceinline__ void sv_update_band(float* A, const float* PI,
                                               int I, int rb, int lane) {
  const int r = rb + lane / 4, c0 = (lane % 4) * 8;
  if (c0 > r) return;  // above the diagonal
  float* T = sv_tile(A, I, I) + r * SV_LD + c0;
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = T[c];
#pragma unroll 4
  for (int kk = 0; kk < SV_NB; ++kk) {
    const float li = PI[kk * SV_NB + r];
    const float4 b4 = *reinterpret_cast<const float4*>(PI + kk * SV_NB + c0);
    const float4 c4 =
        *reinterpret_cast<const float4*>(PI + kk * SV_NB + c0 + 4);
    const float lj[8] = {b4.x, b4.y, b4.z, b4.w, c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = __fmaf_rn(-li, lj[c], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) T[c] = acc[c];
}

// b[t] less L_IJ^T x_I over the column t of tile J = t / 32, summed over
// the tile's 32 rows in order (x_I: 32 values of b)
__device__ __forceinline__ void sv_back_column(float* A, float* b, int I,
                                               int t) {
  const float* L = sv_tile(A, I, t / SV_NB) + t % SV_NB;
  const float* x = b + I * SV_NB;
  float z = b[t];
#pragma unroll 8
  for (int r = 0; r < SV_NB; ++r) z = __fmaf_rn(-L[r * SV_LD], x[r], z);
  b[t] = z;
}

__global__ void __launch_bounds__(SV_THREADS, 1)
    dba_solve_kernel(const SolveParams p) {
  extern __shared__ float4 sv_smem4[];
  const int M = 6 * p.P, nb = (M + SV_NB - 1) / SV_NB, Mp = nb * SV_NB;
  float* A = reinterpret_cast<float*>(sv_smem4);
  float* b = A + sv_tiles(nb) * SV_TILE;
  float* rd = b + Mp;  // the pivots' reciprocal square roots
  float* col = rd + Mp;  // the factor's column broadcast, 2 x 32
  float* DkT = col + 2 * SV_NB;  // the diagonal tile's L transposed
  // the rest: the assembly's stages, then the panel's L transposed
  float* rest = DkT + SV_NB * SV_NB;
  float4* stage = reinterpret_cast<float4*>(rest);
  float* PT = rest;
  const int stg4 = min(SV_STAGE4, (int)((SV_SMEM - (rest - A) * 4) / 128));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // assemble: Sd[6p + a][6q + c] = (H - S)[p P + q][a][c], the diagonal
  // damped as d + (ep + lm d), and the lower triangle of (Sd + Sd^T) / 2
  // from it; rows and columns [M, Mp) the identity's; b = v - cv, zeros
  // past M. The blocks on and below the diagonal (block q <= p of row p:
  // the triangle's block p (p + 1) / 2 + q), each with its mirror (q, p),
  // are staged by cp.async in stages of stg4 / 9 blocks, double-buffered
  // (the next stage in flight while this one is scattered to the tiles),
  // a thread a float4 when staged and a row of a block when scattered
  {
    const int nblk = p.P * (p.P + 1) / 2, sb = stg4 / 9;
    const float4* H4 = reinterpret_cast<const float4*>(p.H);
    const float4* S4 = reinterpret_cast<const float4*>(p.S);
    // a buffer: the blocks of H, of S, then their mirrors of H, of S
    auto issue = [&](int f0, int buf) {
      float4* d = stage + buf * 4 * stg4;
      const int n = min(sb, nblk - f0) * 9;
      for (int i = tid; i < n; i += SV_THREADS) {
        const int fb = f0 + i / 9, pp = sv_tri_row(fb);
        const int q = fb - pp * (pp + 1) / 2;
        const int lo = (pp * p.P + q) * 9 + i % 9;
        const int up = (q * p.P + pp) * 9 + i % 9;
        cp_async16(d + i, H4 + lo);
        cp_async16(d + 2 * stg4 + i, H4 + up);
        if (p.S) {
          cp_async16(d + stg4 + i, S4 + lo);
          cp_async16(d + 3 * stg4 + i, S4 + up);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    issue(0, 0);
    for (int f0 = 0, buf = 0; f0 < nblk; f0 += sb, buf ^= 1) {
      if (f0 + sb < nblk) {
        issue(f0 + sb, buf ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      const float* sH = reinterpret_cast<const float*>(stage + buf * 4 * stg4);
      const float* sS = sH + 4 * stg4;
      const float* mH = sH + 8 * stg4;
      const float* mS = sH + 12 * stg4;
      for (int w = tid; w < min(sb, nblk - f0) * 6; w += SV_THREADS) {
        const int fb = f0 + w / 6, pp = sv_tri_row(fb);
        const int q = fb - pp * (pp + 1) / 2, a = w % 6, R = 6 * pp + a;
        const int blk = (w / 6) * 36;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const int C = 6 * q + c;
          if (C > R) continue;
          // Sd[R][C] from the block, Sd[C][R] from its mirror
          const int lo = blk + a * 6 + c, up = blk + c * 6 + a;
          sv_tile(A, R / SV_NB, C / SV_NB)[(R % SV_NB) * SV_LD + C % SV_NB] =
              sv_sym(sv_damped(p, R, C, sH[lo], p.S ? sS[lo] : 0.f),
                     sv_damped(p, C, R, mH[up], p.S ? mS[up] : 0.f));
        }
      }
      __syncthreads();
    }
  }
  for (int f = tid; f < (Mp - M) * Mp; f += SV_THREADS) {
    const int R = M + f / Mp, C = f % Mp;
    if (C <= R)
      sv_tile(A, R / SV_NB, C / SV_NB)[(R % SV_NB) * SV_LD + C % SV_NB] =
          R == C ? 1.f : 0.f;
  }
  for (int R = tid; R < Mp; R += SV_THREADS)
    b[R] = R >= M ? 0.f : p.cv ? __fsub_rn(p.v[R], p.cv[R]) : p.v[R];
  __syncthreads();

  // L L^T = Sd by 32-column panels, right-looking, y = L^-1 b riding along
  // as the extra row. Warp 0 factors each diagonal tile; a thread a row
  // solves the panel below it and takes its y out of b; a warp a trailing
  // tile updates them, warps 1-4 first the next diagonal tile, which they
  // hand to warp 0 to factor while the others update the rest
  bool bad = false;  // warp 0: a pivot <= 0 or not finite
  if (warp == 0) bad = sv_factor_tile(A, b, rd, col, DkT, lane);
  __syncthreads();
  for (int k = 0; k + 1 < nb; ++k) {
    // the panel's rows also go to PT transposed (PT[I - k - 1][j][r] =
    // L[32 I + r][32 k + j]), for the trailing update to read four a load
    for (int t = tid; t < (nb - 1 - k) * SV_NB; t += SV_THREADS) {
      const int I = k + 1 + t / SV_NB, r = t % SV_NB;
      float* row = sv_tile(A, I, k) + r * SV_LD;
      float* pt = PT + (t / SV_NB) * SV_NB * SV_NB + r;
      float x[SV_NB];
#pragma unroll
      for (int c = 0; c < SV_NB; ++c) x[c] = row[c];
#pragma unroll
      for (int j = 0; j < SV_NB; ++j) {
        x[j] = __fmul_rn(x[j], rd[k * SV_NB + j]);
#pragma unroll
        for (int g = (j + 1) / 4; g < SV_NB / 4; ++g) {
          const float4 v = reinterpret_cast<const float4*>(DkT + j * SV_NB)[g];
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (4 * g + m > j)
              x[4 * g + m] = __fmaf_rn(-x[j], vv[m], x[4 * g + m]);
        }
      }
      float bb = b[I * SV_NB + r];
#pragma unroll
      for (int j = 0; j < SV_NB; ++j) {
        row[j] = x[j];
        pt[j * SV_NB] = x[j];
        bb = __fmaf_rn(-x[j], b[k * SV_NB + j], bb);
      }
      b[I * SV_NB + r] = bb;
    }
    __syncthreads();
    const int m = nb - 1 - k;
    if (warp == 0) {
      sv_handoff_wait(4);
      float* D1 = sv_tile(A, k + 1, k + 1);
      bad |= sv_factor_tile(D1, b + (k + 1) * SV_NB, rd + (k + 1) * SV_NB,
                            col, DkT, lane);
    } else {
      // warps 1..4 first the next diagonal tile, a band of 8 rows each;
      // then every warp the other tiles (tile 0 of the trailing triangle,
      // row-major, is (k + 1, k + 1))
      if (warp <= 4) {
        sv_update_band(A, PT, k + 1, (warp - 1) * 8, lane);
        __syncwarp();
        sv_handoff_arrive(4);
      }
      for (int tile = warp; tile < m * (m + 1) / 2; tile += SV_WARPS - 1) {
        int I = 0;
        while ((I + 1) * (I + 2) / 2 <= tile) ++I;
        const int J = tile - I * (I + 1) / 2;
        sv_update_tile(A, PT + I * SV_NB * SV_NB, PT + J * SV_NB * SV_NB,
                       k + 1 + I, k + 1 + J, lane);
      }
    }
    __syncthreads();
  }

  // L^T x = y by the same tiles from the last: warp 0 solves a diagonal
  // tile; the columns above it take x_I out of b, warp 1 first those of
  // the next diagonal tile, which it hands to warp 0
  if (warp == 0) sv_back_tile(sv_tile(A, nb - 1, nb - 1), b + (nb - 1) * SV_NB,
                              rd + (nb - 1) * SV_NB, lane);
  __syncthreads();
  for (int I = nb - 1; I > 0; --I) {
    if (warp == 0) {
      sv_handoff_wait(1);
      sv_back_tile(sv_tile(A, I - 1, I - 1), b + (I - 1) * SV_NB,
                   rd + (I - 1) * SV_NB, lane);
    } else if (warp == 1) {
      sv_back_column(A, b, I, (I - 1) * SV_NB + lane);
      __syncwarp();
      sv_handoff_arrive(1);
    } else {
      for (int t = tid - 2 * 32; t < (I - 1) * SV_NB;
           t += SV_THREADS - 2 * 32)
        sv_back_column(A, b, I, t);
    }
    __syncthreads();
  }

  // solve_psd's mask: zeros where a pivot failed or x is not finite
  bool ok = !bad;
  for (int R = tid; R < M; R += SV_THREADS) ok = ok && isfinite(b[R]);
  ok = __syncthreads_and(ok);
  for (int R = tid; R < M; R += SV_THREADS) p.dx[R] = ok ? b[R] : 0.f;
}

// ---- dba_solve_grid_kernel: the same solve at any P ----

// a workspace tile: 32 x 32, row stride 32 (a row is one 128-byte line,
// so no line holds two tiles)
constexpr int SG_TILE = SV_NB * SV_NB;
// its shared memory in floats: the diagonal tile (stride 33) and its L
// transposed, the column broadcast, the diagonal tile's y and pivots'
// reciprocals, x of two tiles in the back-solve, the column's panel tile
// and a panel tile a warp
constexpr int SG_SMEM_FLOATS = SV_TILE + SG_TILE + 2 * SV_NB + SV_NB +
                               SV_NB + 2 * SV_NB + SG_TILE +
                               SV_WARPS * SG_TILE;
constexpr int SG_SMEM = SG_SMEM_FLOATS * 4;
static_assert(SG_SMEM <= SV_SMEM && SV_TILE % 4 == 0,
              "the grid kernel's buffers fit a block, 16-byte aligned");

// the workspace of the grid kernel at P poses, offsets in floats (each a
// multiple of 32, so 128-byte aligned on an aligned base): the padded
// lower triangle's tiles, tile (I, J) at I (I + 1) / 2 + J; the panel
// transposed, two buffers (by the step's parity) of nb tiles; b; the
// pivots' reciprocal square roots; a failure flag a diagonal tile; the
// grid barrier's two counters. cuda_dba.solve_workspace mirrors it
struct SgLayout {
  size_t tiles, panel, b, rd, bad, bar, total;
};
__host__ __device__ constexpr SgLayout sg_layout(int P) {
  const size_t nb = (6 * (size_t)P + SV_NB - 1) / SV_NB, Mp = nb * SV_NB;
  const size_t panel = nb * (nb + 1) / 2 * SG_TILE;
  const size_t b = panel + 2 * nb * SG_TILE, rd = b + Mp, bad = rd + Mp;
  const size_t bar = bad + (nb + 31) / 32 * 32;
  return {0, panel, b, rd, bad, bar, bar + 32};
}
static_assert(sg_layout(49).total == 77504 &&
                  sg_layout(99).total == 234752 &&
                  sg_layout(511).total == 4970624,
              "tests/test_torch_port_dba_solve_grid.py holds these");

__device__ __forceinline__ size_t sg_off(int I, int J) {
  return ((size_t)I * (I + 1) / 2 + J) * SG_TILE;
}

// Sd[R][C] from the blocks in device memory
__device__ __forceinline__ float sg_entry(const SolveParams& p, int R,
                                          int C) {
  const size_t i =
      ((size_t)(R / 6) * p.P + C / 6) * 36 + (R % 6) * 6 + C % 6;
  return sv_damped(p, R, C, p.H[i], p.S ? p.S[i] : 0.f);
}

// every block of the grid at one point (the launch is cooperative, so
// all are resident): bar[0] counts the arrivals, bar[1] is the
// generation, which the last block to arrive advances after resetting
// the count; the fences make each block's writes before the barrier
// visible to every block after it (the workspace is read through L2,
// __ldcg, so no block reads a stale line of its L1). bar[0] is zeroed
// before each launch
__device__ __forceinline__ void sg_grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// one warp: the workspace tile Tt less L_Ik L_Jk^T, 4 x 8 values a lane,
// each summed over the panel's 32 columns in order (sv_update_tile's
// order); PI, PJ: the panel's tiles transposed in shared memory; on a
// diagonal tile the lanes above the diagonal do nothing
__device__ __forceinline__ void sg_update_tile(float* Tt, const float* PI,
                                               const float* PJ, bool diag,
                                               int lane) {
  const int r0 = (lane % 8) * 4, c0 = (lane / 8) * 8;
  if (diag && c0 > r0 + 3) return;
  float* T = Tt + r0 * SV_NB + c0;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 u = __ldcg(reinterpret_cast<const float4*>(T + i * SV_NB));
    const float4 w =
        __ldcg(reinterpret_cast<const float4*>(T + i * SV_NB + 4));
    acc[i][0] = u.x, acc[i][1] = u.y, acc[i][2] = u.z, acc[i][3] = u.w;
    acc[i][4] = w.x, acc[i][5] = w.y, acc[i][6] = w.z, acc[i][7] = w.w;
  }
#pragma unroll 4
  for (int kk = 0; kk < SV_NB; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(PI + kk * SV_NB + r0);
    const float4 b4 = *reinterpret_cast<const float4*>(PJ + kk * SV_NB + c0);
    const float4 c4 =
        *reinterpret_cast<const float4*>(PJ + kk * SV_NB + c0 + 4);
    const float li[4] = {a4.x, a4.y, a4.z, a4.w};
    const float lj[8] = {b4.x, b4.y, b4.z, b4.w, c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        acc[i][c] = __fmaf_rn(-li[i], lj[c], acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4* dst = reinterpret_cast<float4*>(T + i * SV_NB);
    dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// b[t] less L_IJ^T x_I over the column t of tile J = t / 32, summed over
// the tile's 32 rows in order (sv_back_column's sums; x_I in shared
// memory)
__device__ __forceinline__ float sg_back_column(const float* T,
                                                const float* b,
                                                const float* xI, int I,
                                                int t) {
  const float* L = T + sg_off(I, t / SV_NB) + t % SV_NB;
  float z = __ldcg(b + t);
#pragma unroll 8
  for (int r = 0; r < SV_NB; ++r)
    z = __fmaf_rn(-__ldcg(L + r * SV_NB), xI[r], z);
  return z;
}

// a workspace tile's row (32 values at src) into dst
__device__ __forceinline__ void sg_load_row(float* dst, const float* src) {
#pragma unroll
  for (int g = 0; g < SV_NB / 4; ++g) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src) + g);
    dst[4 * g] = v.x, dst[4 * g + 1] = v.y, dst[4 * g + 2] = v.z,
    dst[4 * g + 3] = v.w;
  }
}

__global__ void __launch_bounds__(SV_THREADS, 1)
    dba_solve_grid_kernel(const SolveParams p) {
  extern __shared__ float4 sg_smem4[];
  const int M = 6 * p.P, nb = (M + SV_NB - 1) / SV_NB, Mp = nb * SV_NB;
  const SgLayout lay = sg_layout(p.P);
  float* T = p.ws + lay.tiles;
  float* PT = p.ws + lay.panel;
  float* b = p.ws + lay.b;
  float* rd = p.ws + lay.rd;
  unsigned* bad = reinterpret_cast<unsigned*>(p.ws + lay.bad);
  unsigned* bar = reinterpret_cast<unsigned*>(p.ws + lay.bar);
  float* Dk = reinterpret_cast<float*>(sg_smem4);  // the diagonal tile
  float* DkT = Dk + SV_TILE;    // its L transposed
  float* col = DkT + SG_TILE;   // the factor's column broadcast, 2 x 32
  float* yk = col + 2 * SV_NB;  // its 32 values of b
  float* rdk = yk + SV_NB;      // its pivots' reciprocal square roots
  float* xs = rdk + SV_NB;      // the back-solve's x of two tiles
  float* PJ = xs + 2 * SV_NB;   // the column's panel tile, transposed
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* PI = PJ + SG_TILE * (1 + warp);  // the warp's panel tile
  const int G = gridDim.x, blk = blockIdx.x;

  // assemble, the tiles dealt over the blocks: (Sd + Sd^T) / 2 on and
  // below the diagonal (sv_sym of the values dba_solve_kernel takes),
  // zeros above it, the identity's rows and columns [M, Mp); b = v - cv,
  // zeros past M
  for (int f = blk; f < sv_tiles(nb); f += G) {
    const int I = sv_tri_row(f), J = f - I * (I + 1) / 2;
    float* t = T + (size_t)f * SG_TILE;
    for (int e = tid; e < SG_TILE; e += SV_THREADS) {
      const int R = I * SV_NB + e / SV_NB, C = J * SV_NB + e % SV_NB;
      float x;
      if (R >= M || C >= M) x = R == C ? 1.f : 0.f;
      else if (C > R) x = 0.f;
      else x = sv_sym(sg_entry(p, R, C), sg_entry(p, C, R));
      t[e] = x;
    }
  }
  for (int R = blk * SV_THREADS + tid; R < Mp; R += G * SV_THREADS)
    b[R] = R >= M ? 0.f : p.cv ? __fsub_rn(p.v[R], p.cv[R]) : p.v[R];
  sg_grid_sync(bar);

  // column k's owner: its diagonal tile (every update in) factored by
  // warp 0 with y_k riding along (sv_factor_tile), and L_kk, y_k, the
  // pivots' reciprocals and the failure flag written back; then the
  // panel below it, a thread a row (dba_solve_kernel's sums): L_Ik into
  // its tile and, transposed, into the panel buffer of k's parity, and
  // b_I less L_Ik y_k
  auto factor_panel = [&](int k) {
    if (warp == 0) {
      sg_load_row(Dk + lane * SV_LD, T + sg_off(k, k) + lane * SV_NB);
      yk[lane] = __ldcg(b + k * SV_NB + lane);
      __syncwarp();
      const bool failed = sv_factor_tile(Dk, yk, rdk, col, DkT, lane);
      __syncwarp();
      float* row = T + sg_off(k, k) + lane * SV_NB;
      for (int c = 0; c < SV_NB; ++c)
        row[c] = c <= lane ? Dk[lane * SV_LD + c] : 0.f;
      b[k * SV_NB + lane] = yk[lane];
      rd[k * SV_NB + lane] = rdk[lane];
      if (lane == 0) bad[k] = failed;
    }
    __syncthreads();
    float* Pk = PT + (size_t)(k & 1) * nb * SG_TILE;
    for (int t = tid; t < (nb - 1 - k) * SV_NB; t += SV_THREADS) {
      const int I = k + 1 + t / SV_NB, r = t % SV_NB;
      float* row = T + sg_off(I, k) + r * SV_NB;
      float* pt = Pk + (size_t)I * SG_TILE + r;
      float x[SV_NB];
      sg_load_row(x, row);
#pragma unroll
      for (int j = 0; j < SV_NB; ++j) {
        x[j] = __fmul_rn(x[j], rdk[j]);
#pragma unroll
        for (int g = (j + 1) / 4; g < SV_NB / 4; ++g) {
          const float4 v = reinterpret_cast<const float4*>(DkT + j * SV_NB)[g];
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (4 * g + m > j)
              x[4 * g + m] = __fmaf_rn(-x[j], vv[m], x[4 * g + m]);
        }
      }
      float bb = __ldcg(b + I * SV_NB + r);
#pragma unroll
      for (int j = 0; j < SV_NB; ++j) {
        pt[j * SV_NB] = x[j];
        bb = __fmaf_rn(-x[j], yk[j], bb);
      }
#pragma unroll
      for (int g = 0; g < SV_NB / 4; ++g)
        reinterpret_cast<float4*>(row)[g] =
            make_float4(x[4 * g], x[4 * g + 1], x[4 * g + 2], x[4 * g + 3]);
      b[I * SV_NB + r] = bb;
    }
    __syncthreads();
  };

  // the tiles (I, J), I >= J, of column J less L_Ik L_Jk^T (panel k from
  // its buffer), a warp a tile; L_Jk staged for the block, L_Ik for the
  // warp
  auto update_column = [&](int J, int k) {
    const float4* Pk = reinterpret_cast<const float4*>(
        PT + (size_t)(k & 1) * nb * SG_TILE);
    for (int e = tid; e < SG_TILE / 4; e += SV_THREADS)
      reinterpret_cast<float4*>(PJ)[e] =
          __ldcg(Pk + (size_t)J * SG_TILE / 4 + e);
    __syncthreads();
    for (int I = J + warp; I < nb; I += SV_WARPS) {
#pragma unroll
      for (int g = 0; g < SG_TILE / 4 / 32; ++g)
        reinterpret_cast<float4*>(PI)[g * 32 + lane] =
            __ldcg(Pk + (size_t)I * SG_TILE / 4 + g * 32 + lane);
      __syncwarp();
      sg_update_tile(T + sg_off(I, J), PI, PJ, I == J, lane);
      __syncwarp();
    }
    __syncthreads();
  };

  // L L^T = Sd by 32-column panels, right-looking, block b owning the
  // tile columns J = b mod G: at step k each block takes panel k out of
  // its columns right of k, column k + 1 first where it owns it, and
  // factors that column at once, so that panel k + 1 is ready at the
  // step's barrier. Each tile takes the panels in order, each panel's 32
  // columns in order, and b its terms in the same order: the sums of
  // dba_solve_kernel and of dba_solve_emul.emulate
  if (blk == 0) factor_panel(0);
  sg_grid_sync(bar);
  for (int k = 0; k + 1 < nb; ++k) {
    for (int J = k + 1 + ((blk - (k + 1)) % G + G) % G; J < nb; J += G) {
      update_column(J, k);
      if (J == k + 1) factor_panel(k + 1);
    }
    sg_grid_sync(bar);
  }
  if (blk != 0) return;

  // block 0: L^T x = y by the tiles from the last, as dba_solve_kernel:
  // warp 0 solves a diagonal tile; the columns above it take x_I out of
  // b, warp 1 first those of the next diagonal tile, which it hands to
  // warp 0 in yk
  auto stage_diag = [&](int I) {
    sg_load_row(Dk + lane * SV_LD, T + sg_off(I, I) + lane * SV_NB);
    rdk[lane] = __ldcg(rd + I * SV_NB + lane);
  };
  if (warp == 0) {
    stage_diag(nb - 1);
    yk[lane] = __ldcg(b + (nb - 1) * SV_NB + lane);
    __syncwarp();
    sv_back_tile(Dk, yk, rdk, lane);
    __syncwarp();
    xs[((nb - 1) & 1) * SV_NB + lane] = yk[lane];
    b[(nb - 1) * SV_NB + lane] = yk[lane];
  }
  __syncthreads();
  for (int I = nb - 1; I > 0; --I) {
    const float* xI = xs + (I & 1) * SV_NB;
    if (warp == 0) {
      stage_diag(I - 1);
      sv_handoff_wait(1);
      sv_back_tile(Dk, yk, rdk, lane);
      __syncwarp();
      xs[((I - 1) & 1) * SV_NB + lane] = yk[lane];
      b[(I - 1) * SV_NB + lane] = yk[lane];
    } else if (warp == 1) {
      yk[lane] = sg_back_column(T, b, xI, I, (I - 1) * SV_NB + lane);
      __syncwarp();
      sv_handoff_arrive(1);
    } else {
      for (int t = tid - 2 * 32; t < (I - 1) * SV_NB;
           t += SV_THREADS - 2 * 32)
        b[t] = sg_back_column(T, b, xI, I, t);
    }
    __syncthreads();
  }

  // solve_psd's mask: zeros where a pivot failed or x is not finite
  bool ok = true;
  for (int k = tid; k < nb; k += SV_THREADS) ok = ok && !__ldcg(bad + k);
  for (int R = tid; R < M; R += SV_THREADS)
    ok = ok && isfinite(__ldcg(b + R));
  ok = __syncthreads_and(ok);
  for (int R = tid; R < M; R += SV_THREADS)
    p.dx[R] = ok ? __ldcg(b + R) : 0.f;
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

extern "C" int pvo_dba_backsub(const float* poses, const float* dx,
                               const int64_t* frame_row, const float* Ej,
                               const float* Ei_m, const float* C,
                               const float* eta, const float* w,
                               const float* disps, const int64_t* pj_sel,
                               const int64_t* m_k, const int64_t* pm_sel,
                               const int64_t* frame_k, int F, int E, int HW,
                               int P, float* poses_out, float* out,
                               void* stream) {
  if (F < 1 || E < 0 || HW < 1 || P < 0) return (int)cudaErrorInvalidValue;
  const bool depth = disps != nullptr;
  // PIX pixels a thread: 4 (16-byte loads) where HW % 4 == 0 and every
  // plane's base is 16-byte aligned, 2 (8-byte) where HW is even and they
  // are 8-byte aligned (30x101: a plane's stride, 12120 bytes, is 8- but
  // not 16-byte aligned), else 1
  int pix = 1;
  if (depth) {
    const uintptr_t bases = (uintptr_t)Ej | (uintptr_t)Ei_m | (uintptr_t)C |
                            (uintptr_t)eta | (uintptr_t)w | (uintptr_t)disps |
                            (uintptr_t)out;
    if (HW % 4 == 0 && bases % 16 == 0) pix = 4;
    else if (HW % 2 == 0 && bases % 8 == 0) pix = 2;
  }
  const int rblocks = (F + BK_THREADS - 1) / BK_THREADS;
  const int slices = depth ? (HW / pix + BK_THREADS - 1) / BK_THREADS : 0;
  const int64_t blocks = rblocks + (int64_t)F * slices;
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  const BackParams p = {poses, dx, frame_row, poses_out, Ej, Ei_m, C, eta, w,
                        disps, pj_sel, m_k, pm_sel, frame_k, out, F, E, HW,
                        P, slices, rblocks};
  const cudaStream_t st = (cudaStream_t)stream;
  if (pix == 4)
    dba_backsub_kernel<4><<<(unsigned)blocks, BK_THREADS, 0, st>>>(p);
  else if (pix == 2)
    dba_backsub_kernel<2><<<(unsigned)blocks, BK_THREADS, 0, st>>>(p);
  else
    dba_backsub_kernel<1><<<(unsigned)blocks, BK_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" long long pvo_dba_solve_workspace(int P) {
  return P < 1 ? 0 : (long long)sg_layout(P).total;
}

// ws null: dba_solve_kernel (P <= SV_MAX_P); else dba_solve_grid_kernel
// on ws, pvo_dba_solve_workspace(P) floats, 16-byte aligned
extern "C" int pvo_dba_solve(const float* H, const float* S, const float* v,
                             const float* cv, int P, float ep, float lm,
                             float* dx, float* ws, void* stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  const SolveParams p = {H, S, v, cv, dx, ws, ep, lm, P};
  const cudaStream_t st = (cudaStream_t)stream;
  if (ws) {
    if ((uintptr_t)ws % 16 != 0) return (int)cudaErrorMisalignedAddress;
    // a block a tile column at most, one an SM, all resident
    int dev = 0, sms = 0, per = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dba_solve_grid_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SG_SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, dba_solve_grid_kernel, SV_THREADS, SG_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int nb = (6 * P + SV_NB - 1) / SV_NB;
    const int G = nb < sms ? nb : sms;
    if (per < 1 || G < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    err = cudaMemsetAsync(ws + sg_layout(P).bar, 0, 2 * sizeof(unsigned),
                          st);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G, 1, 1);
    cfg.blockDim = dim3(SV_THREADS, 1, 1);
    cfg.dynamicSmemBytes = SG_SMEM;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, dba_solve_grid_kernel, p);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  if (P > SV_MAX_P) return (int)cudaErrorInvalidValue;
  // the blocks are staged by 16-byte copies
  if (((uintptr_t)H | (uintptr_t)S) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = SV_SMEM;
  // the kernel's limit, set with every launch (as allowed in a capture)
  const cudaError_t err = cudaFuncSetAttribute(
      dba_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dba_solve_kernel<<<1, SV_THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}
