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
// Bound on this card: memory in principle. The dense form reads 4 bytes
// and writes 2 (or 4) per window cell: 1.2 MB and 0.00036 ms at the grid
// tick's 20 x 10,000 int16 of 8 x [20, 2,048]; at that size a launch costs
// more than the bytes. The sparse form reads the window and writes kk
// pairs (here the window is read twice: count, then write).
//
// Design: the shard pointers ride the launch by value (no table to upload:
// a tick's counts are new tensors each time), in a parameter sized to k:
// ShardCounts<8>, <32> or <256> (64 bytes at the mesh tick's k = 8, not
// 2 KB). The parameter is __grid_constant__: a thread indexes it in place
// (constant bank), where a plain by-value struct of 8 pointers was copied
// into every thread's local memory for the dynamic index.
// Dense: a segment is row g of shard s, the window's cells [g * N + s * n,
// g * N + min((s + 1) * n, N)); only the shards that hold window columns
// count. A segment is cut into tiles of kThreads units, a unit one cell or
// (vector path) 4 cells: one 16-byte load (int4) and one 8-byte (4 int16)
// or 16-byte (4 int32) store. One 1-D grid of at most kBlocksPerSm blocks
// on each SM walks the tiles; a thread finds its tile's segment with two
// 32-bit divisions and then moves one unit, so no cell pays a division.
// The host takes the vector path only when n % 4 == 0, N % 4 == 0 and
// every shard pointer and the output are 16-byte aligned, so every
// segment starts aligned in both arrays and holds whole units.
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
constexpr int kThreads = 256;       // the dense form's block
constexpr int kBlocksPerSm = 4;

template <int KMAX>
struct ShardCounts {
  const int32_t* p[KMAX];  // shard s: int32[Gc, n], row stride n
};

__device__ __forceinline__ void store(int32_t* out, int32_t v) { *out = v; }

__device__ __forceinline__ void store(int16_t* out, int32_t v) {
  *out = (int16_t)v;
}

__device__ __forceinline__ void store(int4* out, int4 v) { *out = v; }

__device__ __forceinline__ void store(short4* out, int4 v) {
  *out = make_short4((short)v.x, (short)v.y, (short)v.z, (short)v.w);
}

// N and n counted in units of In (int32_t, or int4: 4 cells); `used`
// shards hold window columns; `tiles` tiles of kThreads units a segment;
// G * used * tiles < 2^31 (the host checks).
template <int KMAX, typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
    sharded_dense_kernel(const __grid_constant__ ShardCounts<KMAX> c,
                         Out* __restrict__ out, unsigned G, unsigned N,
                         unsigned n, unsigned used, unsigned tiles) {
  const unsigned total = G * used * tiles;
  for (unsigned t = blockIdx.x; t < total; t += gridDim.x) {
    const unsigned seg = t / tiles;
    const unsigned g = seg / used, s = seg - g * used;
    const unsigned j = (t - seg * tiles) * kThreads + threadIdx.x;
    const unsigned c0 = s * n;
    const unsigned len = N - c0 < n ? N - c0 : n;
    if (j < len)
      store(out + (size_t)g * N + c0 + j,
            reinterpret_cast<const In*>(c.p[s])[(size_t)g * n + j]);
  }
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
template <int KMAX>
__global__ void sharded_count_kernel(
    const __grid_constant__ ShardCounts<KMAX> c, int32_t* seg, int G, int N,
    int n, int k) {
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

template <int KMAX, typename T>
__global__ void sharded_write_kernel(
    const __grid_constant__ ShardCounts<KMAX> c, const int32_t* seg,
    int32_t* idx, T* vals, int G, int N, int n, int k, int kk) {
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

template <int KMAX>
ShardCounts<KMAX> load_shards(const void* ptrs, int k) {
  ShardCounts<KMAX> c;
  const int32_t* const* src = (const int32_t* const*)ptrs;
  for (int s = 0; s < k; ++s) c.p[s] = src[s];
  return c;
}

int sm_count() {
  static int sms = 0;   // the card's SM count, read once
  if (sms == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
    sms = n;
  }
  return sms;
}

// N, n in units of In; `dense` has checked 1 <= k <= PULL_MAX_SHARDS,
// G * N > 0 and N <= k * n
template <int KMAX, typename In, typename Out>
int dense_launch(const void* ptrs, void* out, int G, int N, int n,
                 cudaStream_t st) {
  // the shards holding window columns
  const int used = (int)(((long long)N + n - 1) / n);
  const long long tiles = (n + kThreads - 1) / kThreads;
  const long long total = (long long)G * used * tiles;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long most = (long long)kBlocksPerSm * sm_count();
  const unsigned grid = (unsigned)(total < most ? total : most);
  sharded_dense_kernel<KMAX, In, Out><<<grid, kThreads, 0, st>>>(
      load_shards<KMAX>(ptrs, used), (Out*)out, (unsigned)G, (unsigned)N,
      (unsigned)n, (unsigned)used, (unsigned)tiles);
  return (int)cudaGetLastError();
}

template <typename In, typename Out>
int dense(const void* ptrs, void* out, int G, int N, int n, int k,
          void* stream) {
  if (k < 1 || k > PULL_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  if ((int64_t)G * N == 0) return (int)cudaSuccess;
  if (G < 0 || N < 0 || n < 1 || N > (int64_t)k * n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 8) return dense_launch<8, In, Out>(ptrs, out, G, N, n, st);
  if (k <= 32) return dense_launch<32, In, Out>(ptrs, out, G, N, n, st);
  return dense_launch<PULL_MAX_SHARDS, In, Out>(ptrs, out, G, N, n, st);
}

template <int KMAX>
int sparse_launch(const void* ptrs, void* idx, void* vals, int32_t* seg,
                  int G, int N, int n, int k, int kk, int compact,
                  cudaStream_t st) {
  const ShardCounts<KMAX> c = load_shards<KMAX>(ptrs, k);
  const dim3 grid((unsigned)k, (unsigned)G);
  sharded_count_kernel<KMAX><<<grid, PULL_THREADS, 0, st>>>(c, seg, G, N, n,
                                                            k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (compact)
    sharded_write_kernel<KMAX, int16_t><<<grid, PULL_THREADS, 0, st>>>(
        c, seg, (int32_t*)idx, (int16_t*)vals, G, N, n, k, kk);
  else
    sharded_write_kernel<KMAX, int32_t><<<grid, PULL_THREADS, 0, st>>>(
        c, seg, (int32_t*)idx, (int32_t*)vals, G, N, n, k, kk);
  return (int)cudaGetLastError();
}

}  // namespace skt

// ptrs: a HOST array of k device pointers, shard s's counts int32[Gc, n];
// one cell a thread, any window
extern "C" int skt_sharded_counts_dense(const void* ptrs, void* out, int G,
                                        int N, int n, int k, int compact,
                                        void* stream) {
  return compact ? skt::dense<int32_t, int16_t>(ptrs, out, G, N, n, k, stream)
                 : skt::dense<int32_t, int32_t>(ptrs, out, G, N, n, k,
                                                stream);
}

// Four cells a thread; only for n % 4 == 0, N % 4 == 0 and every pointer
// 16-byte aligned (the host checks).
extern "C" int skt_sharded_counts_dense_vec4(const void* ptrs, void* out,
                                             int G, int N, int n, int k,
                                             int compact, void* stream) {
  return compact
             ? skt::dense<int4, short4>(ptrs, out, G, N / 4, n / 4, k, stream)
             : skt::dense<int4, int4>(ptrs, out, G, N / 4, n / 4, k, stream);
}

// scratch: int32[G * k + 2]; G <= 65535 (one grid row a group)
extern "C" int skt_sharded_counts_sparse(const void* ptrs, void* idx,
                                         void* vals, void* scratch, int G,
                                         int N, int n, int k, int kk,
                                         int compact, void* stream) {
  if (k < 1 || k > skt::PULL_MAX_SHARDS || G < 1 || G > 65535 || kk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* seg = (int32_t*)scratch;
  const cudaError_t err =
      cudaMemsetAsync(seg + (int64_t)G * k, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (k <= 8)
    return skt::sparse_launch<8>(ptrs, idx, vals, seg, G, N, n, k, kk,
                                 compact, st);
  if (k <= 32)
    return skt::sparse_launch<32>(ptrs, idx, vals, seg, G, N, n, k, kk,
                                  compact, st);
  return skt::sparse_launch<skt::PULL_MAX_SHARDS>(ptrs, idx, vals, seg, G, N,
                                                  n, k, kk, compact, st);
}
