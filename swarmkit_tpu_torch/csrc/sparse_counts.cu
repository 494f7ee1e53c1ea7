// K7 sparse_counts: the nonzero cells of a resident tick's counts window,
// as (flat index, value) pairs in ascending index order, padded to k.
//
// Replaces: swarmkit_tpu/ops/resident.py `_sparse_counts` (:170):
//   flat = counts[:G, :N].reshape(-1)
//   idx  = nonzero(flat != 0, size=k, fill_value=0)     (ascending)
//   vals = flat[idx]                                    (int16 when compact)
// so a padded slot holds index 0 and the value of cell 0. k bounds the
// nonzero count (it is at least the tick's task count), so nothing is cut;
// a slot past k is never written all the same.
//
// Bound on this card: memory. It must read the 4-byte window once and
// write k index/value pairs; the window is read twice here (count, write).
//
// Design: an order-preserving compaction in three launches. Tiles of 4096
// cells (4 sub-tiles of 1024, neighbouring threads on neighbouring cells):
// (1) each tile counts its nonzeros; (2) one block turns the tile counts
// into exclusive offsets, in place, with the total after them; (3) each
// tile scans its flags again, block-wide and in order, and writes its
// pairs at its offset; every block then writes a share of the padding.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace skt {

constexpr int SC_THREADS = 1024;
constexpr int SC_SUB = 4;
constexpr int SC_TILE = SC_THREADS * SC_SUB;

__device__ __forceinline__ int32_t window_at(const int32_t* counts,
                                             int64_t e, int N, int Np) {
  const int64_t g = e / N;
  return counts[g * Np + (e - g * N)];
}

__global__ void tile_count_kernel(const int32_t* counts, int32_t* tile_nnz,
                                  int64_t cells, int N, int Np) {
  __shared__ int32_t red[32];
  const int64_t base = (int64_t)blockIdx.x * SC_TILE;
  int32_t c = 0;
  for (int i = 0; i < SC_SUB; ++i) {
    const int64_t e = base + i * SC_THREADS + threadIdx.x;
    if (e < cells && window_at(counts, e, N, Np) != 0) ++c;
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) tile_nnz[blockIdx.x] = c;
}

// One block: tile_nnz[t] becomes the exclusive offset of tile t, and
// tile_nnz[n_tiles] the total.
__global__ void tile_scan_kernel(int32_t* tile_nnz, int n_tiles) {
  __shared__ int32_t sh[32];
  int32_t carry = 0;
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int32_t v = t < n_tiles ? tile_nnz[t] : 0;
    int32_t chunk;
    const int32_t ex = block_excl_scan(v, sh, &chunk);
    if (t < n_tiles) tile_nnz[t] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) tile_nnz[n_tiles] = carry;
}

template <typename T>
__global__ void tile_write_kernel(const int32_t* counts,
                                  const int32_t* tile_off, int32_t* idx,
                                  T* vals, int64_t cells, int N, int Np,
                                  int k) {
  __shared__ int32_t sh[32];
  const int64_t base = (int64_t)blockIdx.x * SC_TILE;
  int32_t off = tile_off[blockIdx.x];
  for (int i = 0; i < SC_SUB; ++i) {
    const int64_t e = base + i * SC_THREADS + threadIdx.x;
    const int32_t v = e < cells ? window_at(counts, e, N, Np) : 0;
    int32_t chunk;
    const int32_t ex = block_excl_scan(v != 0 ? 1 : 0, sh, &chunk);
    const int32_t pos = off + ex;
    if (v != 0 && pos < k) {
      idx[pos] = (int32_t)e;
      vals[pos] = (T)v;
    }
    off += chunk;
  }
  const int32_t nnz = tile_off[gridDim.x];
  const T v0 = (T)counts[0];
  for (int64_t p = (int64_t)(nnz < k ? nnz : k) +
                   (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       p < k; p += (int64_t)gridDim.x * blockDim.x) {
    idx[p] = 0;
    vals[p] = v0;
  }
}

}  // namespace skt

extern "C" int skt_sparse_counts_tile() { return skt::SC_TILE; }

// scratch: int32[n_tiles + 1], n_tiles = ceil(G * N / SC_TILE)
extern "C" int skt_sparse_counts(const void* counts, void* idx, void* vals,
                                 void* scratch, int G, int N, int Np, int k,
                                 int compact, void* stream) {
  const int64_t cells = (int64_t)G * N;
  const int n_tiles = (int)((cells + skt::SC_TILE - 1) / skt::SC_TILE);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)counts;
  int32_t* tiles = (int32_t*)scratch;
  skt::tile_count_kernel<<<n_tiles, skt::SC_THREADS, 0, st>>>(c, tiles, cells,
                                                             N, Np);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skt::tile_scan_kernel<<<1, skt::SC_THREADS, 0, st>>>(tiles, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (compact)
    skt::tile_write_kernel<int16_t><<<n_tiles, skt::SC_THREADS, 0, st>>>(
        c, tiles, (int32_t*)idx, (int16_t*)vals, cells, N, Np, k);
  else
    skt::tile_write_kernel<int32_t><<<n_tiles, skt::SC_THREADS, 0, st>>>(
        c, tiles, (int32_t*)idx, (int32_t*)vals, cells, N, Np, k);
  return (int)cudaGetLastError();
}
