// Fixed-order segment sum for Hopper (sm_90a): out[o, :] += x[n, :] over
// the rows n with idx[n] == o, in ascending n, in one launch and with no
// atomics. Rows whose index is outside [0, n_out) are dropped.
//
// One thread owns one output element (o, d) of the flattened (n_out, D)
// output; a block's 256 elements span the output rows [o_lo, o_hi]. The
// block builds, a tile of the index list at a time, the list of the rows
// n whose idx[n] falls in its range, in ascending n (a stable compaction:
// ballots and a prefix over the warps, in shared memory), and each thread
// then walks only that list, reading x[n, d] where idx[n] == o. So every
// input element is read once, the list is read once per block, and each
// sum starts from out[o, d] and adds its rows in the order the list gives
// them: the order of the CPU's Tensor.index_add_. On the same f32 inputs
// the two agree bit for bit (the adds are __fadd_rn, which the compiler
// does not contract).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;  // index entries compacted per pass

__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float* __restrict__ x, const int64_t* __restrict__ idx,
              float* __restrict__ out, int64_t n_rows, int64_t n_out,
              int64_t D) {
  __shared__ int s_row[TILE];   // the matching rows n (minus the tile base)
  __shared__ int s_seg[TILE];   // and their output rows
  __shared__ int s_warp[WARPS];
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t total = n_out * D;
  const int64_t t0 = (int64_t)blockIdx.x * THREADS;
  const int64_t t = t0 + tid;
  const bool live = t < total;
  const int64_t o = live ? t / D : -1;
  const int64_t d = live ? t - o * D : 0;
  // the block's output rows
  const int64_t o_lo = t0 / D;
  const int64_t o_hi = (min(t0 + THREADS, total) - 1) / D;
  float acc = live ? out[t] : 0.0f;
  for (int64_t base = 0; base < n_rows; base += TILE) {
    const int len = (int)min((int64_t)TILE, n_rows - base);
    if (tid == 0) s_count = 0;
    __syncthreads();
    for (int r = 0; r < len; r += THREADS) {
      const int k = r + tid;
      const int64_t v = k < len ? idx[base + k] : -1;
      const bool hit = v >= o_lo && v <= o_hi;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp] = __popc(ballot);
      __syncthreads();
      int pos = s_count;
      for (int w = 0; w < warp; ++w) pos += s_warp[w];
      pos += __popc(ballot & ((1u << lane) - 1u));
      if (hit) {
        s_row[pos] = k;
        s_seg[pos] = (int)v;
      }
      __syncthreads();
      if (tid == 0) {
        int n = 0;
        for (int w = 0; w < WARPS; ++w) n += s_warp[w];
        s_count += n;
      }
      __syncthreads();
    }
    if (live) {
      const int n = s_count;
      for (int j = 0; j < n; ++j) {
        if (s_seg[j] == o)
          acc = __fadd_rn(acc, x[(base + s_row[j]) * D + d]);
      }
    }
    __syncthreads();
  }
  if (live) out[t] = acc;
}

}  // namespace

extern "C" int pvo_segsum(const void* x, const void* idx, void* out,
                          int64_t n_rows, int64_t n_out, int64_t D,
                          void* stream) {
  const int64_t total = n_out * D;
  if (total == 0) return 0;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segsum_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int64_t*)idx, (float*)out, n_rows, n_out, D);
  return (int)cudaGetLastError();
}
