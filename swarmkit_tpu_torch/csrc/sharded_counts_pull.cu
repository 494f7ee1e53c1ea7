// K24 sharded_counts_pull: the real [G, N] window of a resident tick's
// counts when the counts are node-sharded (k shard arrays int32[Gc, n] on
// one card, global column s * n + j), as one contiguous array or as the
// sparse pack of its nonzeros.
//
// Replaces: swarmkit_tpu/ops/resident.py `_slice_counts` (:162) with the
// compact downcast of `_resident_tick_impl` (:102-103), and
// `_sparse_counts` (:170), as `_mesh_ticks` (:126-147) leaves the counts
// sharded on the node axis:
//   dense:  out[g, c] = (int16 or int32) counts_{c / n}[g, c % n]
//           for g < G, c < N;
//   sparse: the first kk flat indices e = g * N + c (ascending) of the
//           window's nonzero cells and their values; padded slots hold
//           index 0 and the value of cell 0, as jnp.nonzero(..., size=kk,
//           fill_value=0) gives them. This equals the one-device K7 on the
//           joined counts, element for element.
// The host takes the int16 form only when max(n_tasks) < 2^15, so no
// count is cut, and refuses windows of 2^31 cells or more (flat indices
// are int32).
//
// Bound on this card: memory. The dense form reads 4 bytes and writes 2
// (or 4) per window cell; the sparse form reads the window and writes kk
// pairs (here the window is read twice: count, then write).
//
// Design: the k shard pointers ride the launch by value (no table to
// upload: a tick's counts are new tensors each time). Dense: a 2-D grid of
// 256-thread blocks over (columns, groups), each thread one cell.
// Sparse: a (g, shard) segment is the contiguous run of window cells
// [g * N + s * n, g * N + min((s + 1) * n, N)), and segments in (g, s)
// order are in ascending flat order. Launch 1, one block a segment, counts
// its nonzeros; the last block to finish (a ticket counter after a fence)
// turns the counts into exclusive offsets with the total after them.
// Launch 2, one block a segment, scans its cells again in order, block-wide
// in chunks of 1024, and writes its pairs at its offset; every block then
// writes a share of the padding.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace skt {

constexpr int PULL_MAX_SHARDS = 256;
constexpr int PULL_THREADS = 1024;

struct ShardCounts {
  const int32_t* p[PULL_MAX_SHARDS];  // shard s: int32[Gc, n], row stride n
};

template <typename T>
__global__ void sharded_dense_kernel(ShardCounts c, T* out, int G, int N,
                                     int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  const int s = col / n, j = col - s * n;
  const int32_t* src = c.p[s];
  for (int g = blockIdx.y; g < G; g += gridDim.y)
    out[(int64_t)g * N + col] = (T)src[(int64_t)g * n + j];
}

// the segment of block (s = blockIdx.x, g = blockIdx.y): its cells are
// columns [0, len) of row g of shard s
__device__ __forceinline__ int segment_len(int s, int N, int n) {
  const int64_t left = (int64_t)N - (int64_t)s * n;
  return left <= 0 ? 0 : (left < n ? (int)left : n);
}

// seg: int32[G * k + 2]: per-segment counts, then the ticket (zeroed by the
// host), then (after the scan) the total nonzero count; the counts become
// exclusive offsets
__global__ void sharded_count_kernel(ShardCounts c, int32_t* seg, int G,
                                     int N, int n, int k) {
  __shared__ int32_t red[32];
  __shared__ bool last;
  const int s = blockIdx.x, g = blockIdx.y;
  const int len = segment_len(s, N, n);
  const int32_t* row = c.p[s] + (int64_t)g * n;
  int32_t cnt = 0;
  for (int j = threadIdx.x; j < len; j += blockDim.x) cnt += row[j] != 0;
  cnt = block_sum(cnt, red);
  const int n_seg = G * k;
  if (threadIdx.x == 0) {
    seg[g * k + s] = cnt;
    __threadfence();
    const int ticket = atomicAdd(&seg[n_seg], 1);
    last = ticket == n_seg - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int32_t carry = 0;
  for (int base = 0; base < n_seg; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int32_t v = t < n_seg ? __ldcg(&seg[t]) : 0;
    int32_t chunk;
    const int32_t ex = block_excl_scan(v, red, &chunk);
    if (t < n_seg) seg[t] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) seg[n_seg + 1] = carry;
}

template <typename T>
__global__ void sharded_write_kernel(ShardCounts c, const int32_t* seg,
                                     int32_t* idx, T* vals, int G, int N,
                                     int n, int k, int kk) {
  __shared__ int32_t sh[32];
  const int s = blockIdx.x, g = blockIdx.y;
  const int len = segment_len(s, N, n);
  const int32_t* row = c.p[s] + (int64_t)g * n;
  // the segment's first flat index (below 2^31 where len > 0)
  const int64_t e0 = (int64_t)g * N + (int64_t)s * n;
  int32_t off = seg[g * k + s];
  for (int base = 0; base < len; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const int32_t v = j < len ? row[j] : 0;
    int32_t chunk;
    const int32_t ex = block_excl_scan(v != 0 ? 1 : 0, sh, &chunk);
    const int32_t pos = off + ex;
    if (v != 0 && pos < kk) {
      idx[pos] = (int32_t)(e0 + j);
      vals[pos] = (T)v;
    }
    off += chunk;
  }
  const int32_t nnz = seg[G * k + 1];
  const T v0 = (T)c.p[0][0];
  const int64_t blocks = (int64_t)gridDim.x * gridDim.y;
  const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int64_t p = (int64_t)(nnz < kk ? nnz : kk) + b * blockDim.x +
                   threadIdx.x;
       p < kk; p += blocks * blockDim.x) {
    idx[p] = 0;
    vals[p] = v0;
  }
}

static bool load_shards(ShardCounts* c, const void* ptrs, int k) {
  if (k < 1 || k > PULL_MAX_SHARDS) return false;
  const int32_t* const* src = (const int32_t* const*)ptrs;
  for (int s = 0; s < k; ++s) c->p[s] = src[s];
  return true;
}

}  // namespace skt

// ptrs: a HOST array of k device pointers, shard s's counts int32[Gc, n]
extern "C" int skt_sharded_counts_dense(const void* ptrs, void* out, int G,
                                        int N, int n, int k, int compact,
                                        void* stream) {
  skt::ShardCounts c;
  if (!skt::load_shards(&c, ptrs, k)) return (int)cudaErrorInvalidValue;
  if ((int64_t)G * N == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((N + threads - 1) / threads),
                  (unsigned)(G < 65535 ? G : 65535));
  cudaStream_t st = (cudaStream_t)stream;
  if (compact)
    skt::sharded_dense_kernel<int16_t><<<grid, threads, 0, st>>>(
        c, (int16_t*)out, G, N, n);
  else
    skt::sharded_dense_kernel<int32_t><<<grid, threads, 0, st>>>(
        c, (int32_t*)out, G, N, n);
  return (int)cudaGetLastError();
}

// scratch: int32[G * k + 2]; G <= 65535 (one grid row a group)
extern "C" int skt_sharded_counts_sparse(const void* ptrs, void* idx,
                                         void* vals, void* scratch, int G,
                                         int N, int n, int k, int kk,
                                         int compact, void* stream) {
  skt::ShardCounts c;
  if (!skt::load_shards(&c, ptrs, k) || G < 1 || G > 65535 || kk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* seg = (int32_t*)scratch;
  cudaError_t err =
      cudaMemsetAsync(seg + (int64_t)G * k, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)k, (unsigned)G);
  skt::sharded_count_kernel<<<grid, skt::PULL_THREADS, 0, st>>>(c, seg, G,
                                                                N, n, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (compact)
    skt::sharded_write_kernel<int16_t><<<grid, skt::PULL_THREADS, 0, st>>>(
        c, seg, (int32_t*)idx, (int16_t*)vals, G, N, n, k, kk);
  else
    skt::sharded_write_kernel<int32_t><<<grid, skt::PULL_THREADS, 0, st>>>(
        c, seg, (int32_t*)idx, (int32_t*)vals, G, N, n, k, kk);
  return (int)cudaGetLastError();
}
