// The dense bundle adjustment's f32 contractions for Hopper (sm_90a):
// the linearization of each edge, the Schur terms with the rhs
// correction, and the depth back-substitution
// (pvo_tpu_torch/vo/net/cuda_dba.py, called by vo/dba.py).
//
// No TPU kernel matches these: the JAX package leaves this work to XLA
// (pvo_tpu/geom/ba.py:59-93 _edge_blocks, pvo_tpu/vo/dba.py:117-270). They
// were einsums on the card, which cuBLAS ran as gemv and small f32 GEMMs:
// about 21 ms of a replayed planner frame's 76.3 ms of kernels, in 228
// launches (ROADMAP, "Farthest from the bound", item 1). The work itself
// is small: at the planner's full regime (E=144 edges, K=32 depth frames,
// 2048 pair slots, HW=30x101) an iteration moves about 61 MB, some 20 us
// at 3.35 TB/s. All three are bound by bytes; every sum is f32 with FFMA,
// in a fixed order, with no atomics, so a call repeats itself bit for bit.
//
// dba_linearize_kernel: a cluster of LIN_CLUSTER blocks an edge, each
//   block a slice of its pixels. A thread projects its pixels (the edge's
//   relative pose, its rotation and Adj(Gij) built once a block in shared
//   memory), forms Jj, Ji = -Jj Adj(Gij) and Jz in registers, writes the
//   per-pixel Ei, Ej (6 planes each), Ck and wk, and keeps the upper
//   triangle of Hblk and vblk (90 sums) in registers. The block sums its
//   threads' in a fixed tree (xor butterfly, then the warps in order);
//   the cluster's first block sums the blocks' through distributed shared
//   memory, in rank order, and writes Hblk (E,12,12) and vblk (E,12). An
//   invalid edge writes zeros and reads nothing. Bound: the bytes of
//   target, weight, disps[ii] read and the 14 planes written.
// dba_schur_kernel: one block an item of a list, out[x] = sum_h L[:,h]
//   Q[h] R[:,h]^T (6x6) and, for the first K+E items, rc[x] = sum_h
//   R[:,h] Q[h] w[h], Q = 1/(C + eta) formed on the fly: (a) the K
//   self x self items, (b) self x edge for the E edges, whose transposes
//   it writes too, (c) edge x edge for every pair slot, reading the
//   operands by index (no gathered copies); an invalid pair slot reads
//   nothing and writes zeros. Bound: its inputs' bytes read once; the
//   repeats are L2 hits.
// dba_backsub_kernel<EDGES>: a thread a pixel. The edge pass writes each
//   edge's Ej dx[pj] (summed per depth frame by the segment sum); the
//   depth pass forms dz = Q (w - Ei_m dx[pm] - t_edge) and writes the
//   updated disparities of every frame, clamped at 0.001.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LIN_THREADS = 128;
constexpr int LIN_WARPS = LIN_THREADS / 32;
constexpr int LIN_CLUSTER = 8;
constexpr int NH = 78;              // Hblk's upper triangle, row-major
constexpr int NACC = NH + 12;       // and vblk
constexpr int SCHUR_WARPS = 8;
constexpr int BACK_THREADS = 256;
constexpr float MIN_DEPTH = 0.2f;
constexpr unsigned FULL = 0xffffffffu;

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

__global__ void __cluster_dims__(LIN_CLUSTER, 1, 1)
    __launch_bounds__(LIN_THREADS)
    dba_linearize_kernel(const __grid_constant__ LinParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float G[21];
  __shared__ float part[LIN_WARPS][NACC];
  __shared__ float red[NACC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int64_t e = blockIdx.y;
  const int HW = p.H * p.W;
  const bool ok = p.valid[e] != 0;
  const int64_t i = ok ? p.ii[e] : 0, j = ok ? p.jj[e] : 0;
  if (tid == 0 && ok) relative_pose(p.poses + 7 * i, p.poses + 7 * j, G);
  __syncthreads();
  const float fx = p.intr[0], fy = p.intr[1], cx = p.intr[2], cy = p.intr[3];

  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  const int chunk = (HW + LIN_CLUSTER - 1) / LIN_CLUSTER;
  const int end = min(HW, (rank + 1) * chunk);
  const float* disp = p.disps + i * HW;
  const float* tg = p.target + e * HW * 2;
  const float* wt = p.weight + e * HW * 2;
  for (int px = rank * chunk + tid; px < end; px += LIN_THREADS) {
    const int64_t o = e * HW + px;
    if (!ok) {
      if (p.Ei) {
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          p.Ei[(e * 6 + d) * HW + px] = 0.f;
          p.Ej[(e * 6 + d) * HW + px] = 0.f;
        }
        p.Ck[o] = 0.f;
        p.wk[o] = 0.f;
      }
      continue;
    }
    // iproj, act4, proj (geom/projective.projective_jacobian_planes)
    const float hc = __ldg(disp + px);
    const float X = ((float)(px % p.W) - cx) / fx;
    const float Y = ((float)(px / p.W) - cy) / fy;
    const float Xp = G[0] * X + G[1] * Y + G[2] + G[18] * hc;
    const float Yp = G[3] * X + G[4] * Y + G[5] + G[19] * hc;
    const float Zu = G[6] * X + G[7] * Y + G[8] + G[20] * hc;
    const float a = 1.f / (Zu < 0.5f * MIN_DEPTH ? 1.f : Zu);
    const float Xa = Xp * a, Ya = Yp * a;
    const float r0 = __ldg(tg + 2 * px) - (fx * Xa + cx);
    const float r1 = __ldg(tg + 2 * px + 1) - (fy * Ya + cy);
    const bool vis = Zu > MIN_DEPTH;
    const float w0 = vis ? 0.001f * __ldg(wt + 2 * px) : 0.f;
    const float w1 = vis ? 0.001f * __ldg(wt + 2 * px + 1) : 0.f;
    // J = [Ji, Jj] of the two channels
    float J0[12], J1[12];
    const float aZ = a * Zu;
    J0[6] = fx * a * hc;
    J0[7] = 0.f;
    J0[8] = -fx * Xa * a * hc;
    J0[9] = -fx * Xa * Ya;
    J0[10] = fx * (aZ + Xa * Xa);
    J0[11] = -fx * Ya;
    J1[6] = 0.f;
    J1[7] = fy * a * hc;
    J1[8] = -fy * Ya * a * hc;
    J1[9] = -fy * (aZ + Ya * Ya);
    J1[10] = fy * Xa * Ya;
    J1[11] = fy * Xa;
    // Ji = -Jj Adj(Gij), Adj = [[R, [t]x R], [0, R]]
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      J0[col] = -(J0[6] * G[col] + J0[7] * G[3 + col] + J0[8] * G[6 + col]);
      J1[col] = -(J1[6] * G[col] + J1[7] * G[3 + col] + J1[8] * G[6 + col]);
      J0[3 + col] = -(J0[6] * G[9 + col] + J0[7] * G[12 + col] +
                      J0[8] * G[15 + col] + J0[9] * G[col] +
                      J0[10] * G[3 + col] + J0[11] * G[6 + col]);
      J1[3 + col] = -(J1[6] * G[9 + col] + J1[7] * G[12 + col] +
                      J1[8] * G[15 + col] + J1[9] * G[col] +
                      J1[10] * G[3 + col] + J1[11] * G[6 + col]);
    }
    const float z0 = fx * a * (G[18] - Xa * G[20]);
    const float z1 = fy * a * (G[19] - Ya * G[20]);
    int k = 0;
#pragma unroll
    for (int d = 0; d < 12; ++d) {
      const float a0 = w0 * J0[d], a1 = w1 * J1[d];
#pragma unroll
      for (int c = d; c < 12; ++c, ++k)
        acc[k] = fmaf(a1, J1[c], fmaf(a0, J0[c], acc[k]));
      acc[NH + d] = fmaf(a1, r1, fmaf(a0, r0, acc[NH + d]));
      if (p.Ei) {
        float* out = d < 6 ? p.Ei + (e * 6 + d) * HW : p.Ej + (e * 6 + d - 6) * HW;
        out[px] = fmaf(a1, z1, a0 * z0);
      }
    }
    if (p.Ei) {
      p.Ck[o] = fmaf(w1 * z1, z1, w0 * z0 * z0);
      p.wk[o] = fmaf(w1 * r1, z1, w0 * r0 * z0);
    }
  }

  // the block's sums: a butterfly within each warp, then the warps in order
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float v = acc[k];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
    acc[k] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (tid < NACC) {
    float s = part[0][tid];
#pragma unroll
    for (int w = 1; w < LIN_WARPS; ++w) s += part[w][tid];
    red[tid] = s;
  }
  // the cluster's sums, in rank order, by its first block
  cluster.sync();
  if (rank == 0) {
    for (int k = tid; k < NACC; k += LIN_THREADS) {
      float s = red[k];
      for (int r = 1; r < LIN_CLUSTER; ++r) s += cluster.map_shared_rank(red, r)[k];
      if (k >= NH) {
        p.vblk[e * 12 + k - NH] = s;
      } else {
        int d = 0, first = 0;
        while (k >= first + 12 - d) first += 12 - d++;
        const int c = d + k - first;
        p.Hblk[e * 144 + d * 12 + c] = s;
        p.Hblk[e * 144 + c * 12 + d] = s;
      }
    }
  }
  cluster.sync();  // the other blocks' shared memory stays until read
}

struct SchurParams {
  const float *Ei_m, *Ej, *C, *eta, *w;
  const int64_t *m, *pa, *pb;
  const uint8_t* pv;
  float *S, *rc;
  int K, E, HW;
};

// one block an item: (a) x < K, (b) K <= x < K + E, (c) the pair slots;
// warp k of the block takes the pixels h = 32 n + lane with n % SCHUR_WARPS
// == k, then the warps' sums are added in warp order
__global__ void __launch_bounds__(32 * SCHUR_WARPS)
    dba_schur_kernel(const __grid_constant__ SchurParams p) {
  __shared__ float part[SCHUR_WARPS][42];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t x = blockIdx.x;
  const int K = p.K, E = p.E, HW = p.HW;
  const float *L, *R;
  int64_t q;
  float* out;
  float* outT = nullptr;
  float* rc = nullptr;
  if (x < K) {
    q = x;
    L = R = p.Ei_m + x * 6 * HW;
    out = p.S + x * 36;
    rc = p.rc + x * 6;
  } else if (x < K + E) {
    const int64_t e = x - K;
    q = p.m[e];
    L = p.Ei_m + q * 6 * HW;
    R = p.Ej + e * 6 * HW;
    out = p.S + x * 36;
    outT = p.S + (x + E) * 36;
    rc = p.rc + x * 6;
  } else {
    const int64_t s = x - K - E;
    out = p.S + (K + 2 * (int64_t)E + s) * 36;
    if (!p.pv[s]) {
      if (tid < 36) out[tid] = 0.f;
      return;
    }
    const int64_t a = p.pa[s];
    q = p.m[a];
    L = p.Ej + a * 6 * HW;
    R = p.Ej + p.pb[s] * 6 * HW;
  }
  const float* Cq = p.C + q * HW;
  const float* eq = p.eta + q * HW;
  const float* wq = p.w + q * HW;
  float acc[36], racc[6];
#pragma unroll
  for (int k = 0; k < 36; ++k) acc[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) racc[k] = 0.f;
  for (int h = 32 * warp + lane; h < HW; h += 32 * SCHUR_WARPS) {
    const float Q = 1.f / (__ldg(Cq + h) + __ldg(eq + h));
    float l[6], r[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      l[d] = __ldg(L + d * HW + h) * Q;
      r[d] = __ldg(R + d * HW + h);
    }
#pragma unroll
    for (int d = 0; d < 6; ++d)
#pragma unroll
      for (int c = 0; c < 6; ++c) acc[d * 6 + c] = fmaf(l[d], r[c], acc[d * 6 + c]);
    if (rc) {
      const float wh = __ldg(wq + h);
#pragma unroll
      for (int d = 0; d < 6; ++d) racc[d] = fmaf(r[d] * Q, wh, racc[d]);
    }
  }
#pragma unroll
  for (int k = 0; k < 36; ++k) {
    float v = acc[k];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
    acc[k] = v;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float v = racc[k];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
    racc[k] = v;
  }
  // every lane holds the warp's sums: lane k & 31 stores sum k
#pragma unroll
  for (int k = 0; k < 42; ++k)
    if (lane == (k & 31)) part[warp][k] = k < 36 ? acc[k] : racc[k - 36];
  __syncthreads();
  if (tid < 42) {
    float v = part[0][tid];
#pragma unroll
    for (int w = 1; w < SCHUR_WARPS; ++w) v += part[w][tid];
    if (tid < 36) {
      out[tid] = v;
      if (outT) outT[(tid % 6) * 6 + tid / 6] = v;
    } else if (rc) {
      rc[tid - 36] = v;
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
  dba_linearize_kernel<<<dim3(LIN_CLUSTER, E), LIN_THREADS, 0,
                         (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int pvo_dba_schur(const float* Ei_m, const float* Ej,
                             const float* C, const float* eta, const float* w,
                             const int64_t* m, const int64_t* pa,
                             const int64_t* pb, const uint8_t* pv, int K,
                             int E, int NP, int HW, float* S, float* rc,
                             void* stream) {
  const int64_t items = (int64_t)K + E + NP;
  if (K < 1 || E < 0 || NP < 0 || HW < 1 || items < 1)
    return (int)cudaErrorInvalidValue;
  const SchurParams p = {Ei_m, Ej, C, eta, w, m, pa, pb, pv, S, rc,
                         K, E, HW};
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dba_schur_kernel<<<(unsigned)items, 32 * SCHUR_WARPS, 0,
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
