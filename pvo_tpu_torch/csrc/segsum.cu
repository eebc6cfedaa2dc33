// Fixed-order segment sums for Hopper (sm_90a): for each job of a batch,
// out[o, :] = start + x[n, :] summed over the rows n with idx[n] == o, in
// ascending n, with no atomics, where start is out[o, :] (accumulate) or
// +0.0f (zero start: out is not read). Rows whose index is outside
// [0, n_out) are dropped. Up to MAX_JOBS independent jobs go in one launch.
//
// A job's (n_out, D) output is cut into tiles, one thread block each;
// the blocks of all jobs form one grid. An output unit is a float4 along
// D where D % 4 == 0 and x and out are 16-byte aligned, else one float.
// A row of fewer than THREADS units takes one unit a thread and up to
// MAX_ROWS rows a tile; a longer row is cut into tiles of one row, one
// unit a thread in a launch of up to WAVES waves of such tiles (its time
// is latency), UNITS units a thread in a larger one (more bytes in
// flight, fewer tiles).
//
// A block first builds the stable CSR of the index list over its own
// rows, a window of WINDOW entries at a time: for each row the entries
// that name it, in ascending order, a counting sort in shared memory.
// All the window's indices are loaded at once; each warp then compacts
// the entries of its contiguous slice that fall in the tile (ballots),
// counts their rows, and after one warp has turned the counts into each
// (row, warp)'s first place, places them in order (ranks within 32
// entries from __match_any_sync). A one-row tile needs only the
// compaction. Then each thread walks the lists of its units: one unit
// LOADS entries at a time, several units one entry at a time, the loads
// of a step together. Each sum adds its rows in the order of the CPU's
// Tensor.index_add_ with __fadd_rn (not contracted), so on the same f32
// inputs the two agree bit for bit; 0.0f + x is what index_add_ into
// zeros computes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNITS = 8;           // output units a thread owns at most
constexpr int LOADS = 8;           // loads a thread issues together
constexpr int MAX_ROWS = 64;       // output rows of a tile at most
constexpr int WINDOW = 4096;       // index entries sorted per pass
constexpr int MAX_JOBS = 8;
// the blocks the card holds at once (132 SMs x 4)
constexpr int64_t FILL_BLOCKS = 132 * 4;
constexpr int64_t WAVES = 4;
constexpr unsigned FULL = 0xffffffffu;

// a job's tiling: tiles of `rows` output rows x `cols` units, `chunks`
// tiles along a row, `per` units a thread at most (rows == 1 when
// chunks > 1 or per > 1); its tiles are the blocks [first, first + tiles)
struct Plan {
  const float* x;
  const int64_t* idx;
  float* out;
  int64_t n_rows, n_out, dv, rows, cols, chunks, per, first;
  int32_t vec, zero;
};

struct Params {
  Plan job[MAX_JOBS];
  int n_jobs, window;
};

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The stable CSR of idx[0, len) over the output rows [r0, r0 + nr),
// nr <= MAX_ROWS: off[0, nr] the first place of each row, perm the
// window-local entries, ascending within each row. key (len) and cnt
// (WARPS x MAX_ROWS) are scratch. Called by the whole block; ends
// synchronized.
__device__ void build_csr(const int64_t* __restrict__ idx, int len,
                          int64_t r0, int nr, int* off, int* perm,
                          int* key, int* cnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the window's rows relative to the tile, -1 outside it: all the loads
  // at once
#pragma unroll 4
  for (int i = tid; i < len; i += THREADS) {
    const int64_t v = __ldg(idx + i) - r0;
    key[i] = (v >= 0 && v < nr) ? (int)v : -1;
  }
  // each warp's slice of the window, whole steps of 32 entries
  const int per = ((len + THREADS - 1) / THREADS) * 32;
  const int lo = warp * per, hi = min(len, lo + per);
  if (nr == 1) {
    // one row: a stable compaction, each warp's matches after the
    // earlier warps'
    __syncthreads();
    int n = 0;
    for (int s0 = lo; s0 < hi; s0 += 32) {
      const int s = s0 + lane;
      n += __popc(__ballot_sync(FULL, s < hi && key[s] == 0));
    }
    if (lane == 0) cnt[warp] = n;
    __syncthreads();
    int at = 0, all = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = cnt[w];
      at += w < warp ? c : 0;
      all += c;
    }
    for (int s0 = lo; s0 < hi; s0 += 32) {
      const int s = s0 + lane;
      const bool hit = s < hi && key[s] == 0;
      const unsigned b = __ballot_sync(FULL, hit);
      if (hit) perm[at + __popc(b & ((1u << lane) - 1u))] = s;
      at += __popc(b);
    }
    if (tid == 0) {
      off[0] = 0;
      off[1] = all;
    }
    __syncthreads();
    return;
  }
  // the warp's entries in the tile, in order, compacted in place at the
  // head of its slice of key as (entry << 8) | row; their rows counted
  const unsigned below = (1u << lane) - 1u;
  int* wcnt = cnt + warp * MAX_ROWS;
  for (int q = lane; q < nr; q += 32) wcnt[q] = 0;
  __syncthreads();
  int hits = 0;
  for (int s0 = lo; s0 < hi; s0 += 32) {
    const int s = s0 + lane;
    const int k = s < hi ? key[s] : -1;
    const unsigned b = __ballot_sync(FULL, k >= 0);
    if (k >= 0) key[lo + hits + __popc(b & below)] = (s << 8) | k;
    hits += __popc(b);
  }
  __syncwarp();
  for (int i = lane; i < hits; i += 32) atomicAdd(&wcnt[key[lo + i] & 0xff], 1);
  __syncthreads();
  // warp 0: each (row, warp)'s first place, rows in order, warps in
  // order within a row; rows lane and 32 + lane
  if (warp == 0) {
    int tot[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = lane + 32 * h;
      if (q < nr) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const int c = cnt[w * MAX_ROWS + q];
          cnt[w * MAX_ROWS + q] = tot[h];
          tot[h] += c;
        }
      }
    }
    // inclusive prefixes over the lanes of each half; row 32 + lane
    // comes after the whole first half
    int a = tot[0], b = tot[1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ta = __shfl_up_sync(FULL, a, d);
      const int tb = __shfl_up_sync(FULL, b, d);
      if (lane >= d) {
        a += ta;
        b += tb;
      }
    }
    const int half = __shfl_sync(FULL, a, 31);
    const int first[2] = {a - tot[0], half + b - tot[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = lane + 32 * h;
      if (q < nr) {
        off[q] = first[h];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) cnt[w * MAX_ROWS + q] += first[h];
      }
    }
    if (lane == 31) off[nr] = half + b;
  }
  __syncthreads();
  // place the warp's entries, 32 at a time: each group of equal rows
  // takes the next places of its row in this warp's range, in order
  for (int i0 = 0; i0 < hits; i0 += 32) {
    const int h = i0 + lane < hits ? key[lo + i0 + lane] : -1;
    const int k = h >= 0 ? (h & 0xff) : -1;
    const unsigned peers = __match_any_sync(FULL, k);
    const int first = __ffs(peers) - 1;
    int base = 0;
    if (k >= 0 && lane == first) {
      base = wcnt[k];
      wcnt[k] = base + __popc(peers);
    }
    base = __shfl_sync(FULL, base, first);
    if (k >= 0) perm[base + __popc(peers & below)] = h >> 8;
  }
  __syncthreads();
}

// x's unit (row n, column c) as a float4 (only .x for scalar units)
__device__ __forceinline__ float4 load_unit(const Plan& J, int64_t n,
                                            int64_t c) {
  if (J.vec) return __ldg(reinterpret_cast<const float4*>(J.x) + n * J.dv + c);
  return make_float4(__ldg(J.x + n * J.dv + c), 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 add_unit(const Plan& J, float4 a,
                                           float4 b) {
  if (J.vec) return add4(a, b);
  a.x = __fadd_rn(a.x, b.x);
  return a;
}

// One tile. A tile of one unit a thread (J.per == 1; any number of
// rows) walks the unit's list LOADS entries at a time, their loads
// together; a tile of several units a thread (one row; the columns
// c0 + tid + k THREADS) walks the row's list once, the units' loads
// together.
__global__ void __launch_bounds__(THREADS, 4)
segsum_kernel(const __grid_constant__ Params p) {
  __shared__ int off[MAX_ROWS + 1];
  __shared__ int cnt[WARPS * MAX_ROWS];
  extern __shared__ int scratch[];
  int* perm = scratch;              // window
  int* key = scratch + p.window;    // window
  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  int j = 0;
  while (j + 1 < p.n_jobs && tile >= p.job[j + 1].first) ++j;
  const Plan& J = p.job[j];
  const int64_t t = tile - J.first;
  const int64_t r0 = (t / J.chunks) * J.rows;
  const int64_t c0 = (t % J.chunks) * J.cols;
  const int nr = (int)imin(J.rows, J.n_out - r0);
  const int nc = (int)imin(J.cols, J.dv - c0);
  float4* out4 = reinterpret_cast<float4*>(J.out);

  if (J.per == 1) {
    const bool live = tid < nr * nc;
    const int row = live ? tid / nc : 0;
    const int64_t at = (r0 + row) * J.dv;  // the row's first unit
    const int64_t col = c0 + (live ? tid % nc : 0);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && !J.zero)
      acc = J.vec ? out4[at + col] : make_float4(J.out[at + col], 0.f, 0.f, 0.f);
    for (int64_t base = 0; base < J.n_rows; base += p.window) {
      const int len = (int)imin(p.window, J.n_rows - base);
      build_csr(J.idx + base, len, r0, nr, off, perm, key, cnt);
      const int e = live ? off[row + 1] : 0;
      for (int i = live ? off[row] : 0; i < e; i += LOADS) {
        float4 v[LOADS];
#pragma unroll
        for (int q = 0; q < LOADS; ++q)
          if (i + q < e) v[q] = load_unit(J, base + perm[i + q], col);
#pragma unroll
        for (int q = 0; q < LOADS; ++q)
          if (i + q < e) acc = add_unit(J, acc, v[q]);
      }
      __syncthreads();  // the next window's CSR overwrites this one
    }
    if (live) {
      if (J.vec) out4[at + col] = acc;
      else J.out[at + col] = acc.x;
    }
    return;
  }

  float4 acc[UNITS];
  const int64_t o0 = r0 * J.dv + c0 + tid;
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid + k * THREADS < nc && !J.zero) {
      const int64_t o = o0 + k * THREADS;
      acc[k] = J.vec ? out4[o] : make_float4(J.out[o], 0.f, 0.f, 0.f);
    }
  }
  for (int64_t base = 0; base < J.n_rows; base += p.window) {
    const int len = (int)imin(p.window, J.n_rows - base);
    build_csr(J.idx + base, len, r0, nr, off, perm, key, cnt);
    const int e = off[1];
    for (int i = off[0]; i < e; ++i) {
      const int64_t n = base + perm[i];
#pragma unroll
      for (int k = 0; k < UNITS; ++k)
        if (tid + k * THREADS < nc)
          acc[k] = add_unit(J, acc[k], load_unit(J, n, c0 + tid + k * THREADS));
    }
    __syncthreads();  // the next window's CSR overwrites this one
  }
#pragma unroll
  for (int k = 0; k < UNITS; ++k) {
    if (tid + k * THREADS < nc) {
      const int64_t o = o0 + k * THREADS;
      if (J.vec) out4[o] = acc[k];
      else J.out[o] = acc[k].x;
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// one job as the caller gives it (pvo_tpu_torch/vo/net/cuda_segsum.py)
struct SegsumJob {
  const float* x;
  const int64_t* idx;
  float* out;
  int64_t n_rows, n_out, D;
  int32_t zero, pad;
};

// Launch the segment sums of jobs[0, n_jobs) as one kernel on `stream`.
// The jobs are independent: no job's out may overlap another's out or x.
extern "C" int pvo_segsum(const void* job_table, int n_jobs, void* stream) {
  if (n_jobs < 1 || n_jobs > MAX_JOBS) return (int)cudaErrorInvalidValue;
  const SegsumJob* jobs = static_cast<const SegsumJob*>(job_table);
  Params p = {};
  int64_t total = 0;  // the launch's output units
  for (int j = 0; j < n_jobs; ++j) {
    const SegsumJob& a = jobs[j];
    Plan& q = p.job[j];
    q.x = a.x;
    q.idx = a.idx;
    q.out = a.out;
    q.n_rows = a.n_rows;
    q.n_out = a.n_out;
    q.zero = a.zero;
    q.vec = a.D % 4 == 0 && (uintptr_t)a.x % 16 == 0 &&
            (uintptr_t)a.out % 16 == 0;
    q.dv = q.vec ? a.D / 4 : a.D;
    q.rows = q.cols = q.chunks = q.per = 1;
    // nothing to write: no output, or no rows to add to out
    if (a.n_out <= 0 || a.D <= 0 || (!a.zero && a.n_rows <= 0)) q.dv = 0;
    total += a.n_out * q.dv;
  }
  // units a thread along a row: one while the launch's tiles of one unit
  // a thread take at most WAVES waves of the card's blocks (its time is
  // latency; each unit then loads LOADS rows of its list together), else
  // UNITS (more bytes in flight a thread, fewer CSRs built)
  const int64_t wide = total <= WAVES * THREADS * FILL_BLOCKS ? 1 : UNITS;
  int64_t tiles = 0, window = 1;
  for (int j = 0; j < n_jobs; ++j) {
    Plan& q = p.job[j];
    q.first = tiles;
    if (q.dv == 0) continue;
    if (q.dv >= THREADS) {
      // tiles of one row
      q.per = std::min(wide, ceil_div(q.dv, THREADS));
      q.chunks = ceil_div(q.dv, THREADS * q.per);
      q.cols = ceil_div(q.dv, q.chunks);
    } else {
      // one unit a thread, several rows a tile
      const int64_t most = std::min<int64_t>(MAX_ROWS, THREADS / q.dv);
      q.rows = ceil_div(q.n_out, ceil_div(q.n_out, most));
      q.cols = q.dv;
    }
    tiles += ceil_div(q.n_out, q.rows) * q.chunks;
    window = std::max(window, std::min<int64_t>(WINDOW, q.n_rows));
  }
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.n_jobs = n_jobs;
  p.window = (int)window;
  segsum_kernel<<<(unsigned)tiles, THREADS, 2 * sizeof(int) * window,
                  (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
