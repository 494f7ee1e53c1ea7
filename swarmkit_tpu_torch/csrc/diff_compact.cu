// K15 diff_compact: a decision matrix of the global diff as row-major index
// lists, cut at `cap`, plus the full count.
//
// Replaces: the compaction of swarmkit_tpu/ops/reconcile.py
// `global_diff_update_compact` (:58, its `compact` at :70-73):
//   s_idx, n_idx = nonzero(m, size=cap, fill_value=-1)
//   idx   = stack([s_idx, n_idx], axis=1)                 int32[cap, 2]
//   count = sum(m)                                        int32
// for m bool[S, N]: the first cap set cells in row-major order, rows past
// the count (-1, -1); the count may exceed cap (the caller then pulls the
// dense matrix). The host refuses S * N >= 2^31, where the reference's
// int32 count would wrap.
//
// Bound on this card: memory. It must read S * N bytes and write 8 * cap
// + 4 (at 200 x 50,000 cells: about 10 MB, 3 us at 3.35 TB/s); the mask is
// read twice here (count, write).
//
// Design: an order-preserving compaction in three launches (the pattern of
// K7, csrc/sparse_counts.cu). Tiles of 4096 cells (4 sub-tiles of 1024,
// neighbouring threads on neighbouring cells): (1) each tile counts its set
// cells; (2) one block turns the tile counts into exclusive offsets, in
// place, with the total after them, and writes the count; (3) each tile
// scans its flags again, block-wide and in order, and writes the (s, n)
// pairs that fall below cap at its offset; every block then writes a share
// of the (-1, -1) fill.
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace skt {

constexpr int DC_THREADS = 1024;
constexpr int DC_SUB = 4;
constexpr int DC_TILE = DC_THREADS * DC_SUB;

__global__ void dc_count_kernel(const uint8_t* __restrict__ mask,
                                int32_t* tile_nnz, int64_t cells) {
  __shared__ int32_t red[32];
  const int64_t base = (int64_t)blockIdx.x * DC_TILE;
  int32_t c = 0;
  for (int i = 0; i < DC_SUB; ++i) {
    const int64_t e = base + i * DC_THREADS + threadIdx.x;
    if (e < cells && mask[e]) ++c;
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) tile_nnz[blockIdx.x] = c;
}

// One block: tile_nnz[t] becomes the exclusive offset of tile t, and
// tile_nnz[n_tiles] and *count the total.
__global__ void dc_scan_kernel(int32_t* tile_nnz, int n_tiles,
                               int32_t* count) {
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
  if (threadIdx.x == 0) {
    tile_nnz[n_tiles] = carry;
    *count = carry;
  }
}

__global__ void dc_write_kernel(const uint8_t* __restrict__ mask,
                                const int32_t* tile_off, int32_t* idx,
                                int64_t cells, int N, int cap) {
  __shared__ int32_t sh[32];
  const int64_t base = (int64_t)blockIdx.x * DC_TILE;
  int32_t off = tile_off[blockIdx.x];
  for (int i = 0; i < DC_SUB; ++i) {
    if (off >= cap) break;                   // block-uniform
    const int64_t e = base + i * DC_THREADS + threadIdx.x;
    const int32_t f = (e < cells && mask[e]) ? 1 : 0;
    int32_t chunk;
    const int32_t pos = off + block_excl_scan(f, sh, &chunk);
    if (f && pos < cap) {
      idx[2 * (int64_t)pos] = (int32_t)(e / N);
      idx[2 * (int64_t)pos + 1] = (int32_t)(e % N);
    }
    off += chunk;
  }
  const int32_t total = tile_off[gridDim.x];
  for (int64_t p = (int64_t)(total < cap ? total : cap) +
                   (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       p < cap; p += (int64_t)gridDim.x * blockDim.x) {
    idx[2 * p] = -1;
    idx[2 * p + 1] = -1;
  }
}

}  // namespace skt

extern "C" int skt_diff_compact_tile() { return skt::DC_TILE; }

// idx: int32[cap, 2]; count: int32[1]; scratch: int32[n_tiles + 1],
// n_tiles = ceil(S * N / DC_TILE).
extern "C" int skt_diff_compact(const void* mask, void* idx, void* count,
                                void* scratch, int S, int N, int cap,
                                void* stream) {
  const int64_t cells = (int64_t)S * N;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* tiles = (int32_t*)scratch;
  if (cells == 0) {
    cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int32_t), st);
    if (err != cudaSuccess || cap == 0) return (int)err;
    return (int)cudaMemsetAsync(idx, 0xff, (size_t)cap * 8, st);   // -1s
  }
  const int n_tiles = (int)((cells + skt::DC_TILE - 1) / skt::DC_TILE);
  const uint8_t* m = (const uint8_t*)mask;
  skt::dc_count_kernel<<<n_tiles, skt::DC_THREADS, 0, st>>>(m, tiles, cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  skt::dc_scan_kernel<<<1, skt::DC_THREADS, 0, st>>>(tiles, n_tiles,
                                                     (int32_t*)count);
  err = cudaGetLastError();
  if (err != cudaSuccess || cap == 0) return (int)err;
  skt::dc_write_kernel<<<n_tiles, skt::DC_THREADS, 0, st>>>(
      m, tiles, (int32_t*)idx, cells, N, cap);
  return (int)cudaGetLastError();
}
